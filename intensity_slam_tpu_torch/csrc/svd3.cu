// Batched 3x3 singular value decomposition with the reflection fixed, for
// Hopper (sm_90a): the rotation of the ICP's closed-form (Umeyama) update.
//
// Replaces XLA's `jnp.linalg.svd` and the reflection rule after it, as the
// JAX package's `_umeyama_step` calls them (intensity_slam_tpu/ops/icp.py:58-61:
// R = U diag(1, 1, sign det(U V^T)) V^T); there is no Pallas source.  On the
// card `torch.linalg.svd` reads a status back to the host after every call,
// so it stalls the host and cannot be captured into a CUDA graph; this
// kernel reads nothing back and has no status.
//
// svd3_kernel<T>: one thread a matrix, everything in registers.  The matrix
// is scaled by its largest |entry| (the rotations do not depend on scale;
// every threshold below is then relative), then `sweeps` cyclic one-sided
// (Hestenes) Jacobi sweeps orthogonalize its columns: B = A V with V a
// product of plane rotations, each pair (p, q) rotated by the smaller angle
// that makes b_p . b_q vanish, skipped where b_p . b_q is already below the
// working precision of |b_p| |b_q| (a zero column included, so an all-zero
// matrix is never divided by).  The singular values are the column norms,
// sorted in descending order with their columns.  Then
//   u0 = b0 / |b0| (e_x for the all-zero matrix),
//   u1 = b1 with its u0 part removed, normalized (for a rank-1 matrix, where
//        that leaves nothing, the unit vector orthogonal to u0 nearest the
//        axis u0 leans on least),
//   u2 = u0 x u1, and v2 = v0 x v1,
// so det U = det V = +1 and R = U V^T is a rotation.  For a matrix of rank 2
// or 3 it is the reference's U diag(1, 1, sign det(U V^T)) V^T, whatever the
// signs of the singular vectors: u0 x u1 = det(U) u2 and v0 x v1 = det(V)
// v2 for any orthonormal U, V, so (u0 x u1)(v0 x v1)^T = det(U) det(V) u2 v2^T
// is the reference's third term.  This holds without u2 or v2 from the
// smallest singular value, whose vectors a rank-2 (planar) covariance leaves
// to rounding.  A rank-1 matrix's rotation is not unique (any turn about its
// axis fits); the kernel's is a rotation, as LAPACK's is, not the same one.
// The returned S keeps U diag(S) V^T = A: its last value carries the sign
// u2 . (A v2), the reflection.
//
// What bounds it on an H100: neither bytes (36 B in, 84 B out a float32
// matrix) nor operations (about 600 a matrix), but the latency of one
// thread's chain of dependent rotations (a division and two square roots
// each, 3 a sweep), on top of a launch's own device time of about a
// microsecond.  The ICP calls it on one matrix an iteration, 32 a
// verification, so the design is the shortest chain: one thread, no shared
// memory, unrolled loops, a fixed number of sweeps with per-rotation skips
// (a 3x3 meets float32 precision in 3-5 sweeps; a skipped rotation costs
// its three dot products).  The same input gives the same bits on every
// launch, alone or anywhere in a batch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

template <typename T> struct Eps;
template <> struct Eps<float> { static constexpr float value = 1.1920929e-07f; };
template <> struct Eps<double> { static constexpr double value = 2.220446049250313e-16; };

template <typename T>
__device__ __forceinline__ T absval(T x) { return x < T(0) ? -x : x; }

template <typename T>
__device__ __forceinline__ T dot3(const T* a, const T* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

template <typename T>
__device__ __forceinline__ void cross3(const T* a, const T* b, T* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// b[j] is column j of B, v[j] column j of V
template <typename T>
__device__ __forceinline__ void swap_cols(T (&s)[3], T (&b)[3][3], T (&v)[3][3], int p, int q) {
  if (s[p] < s[q]) {
    const T st = s[p]; s[p] = s[q]; s[q] = st;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const T bt = b[p][r]; b[p][r] = b[q][r]; b[q][r] = bt;
      const T vt = v[p][r]; v[p][r] = v[q][r]; v[q][r] = vt;
    }
  }
}

template <typename T>
__device__ void svd3(const T* __restrict__ m, T* __restrict__ u_out, T* __restrict__ s_out,
                     T* __restrict__ vt_out, int sweeps) {
  T a[3][3];            // a[i][j] = A(i, j)
  T mx = T(0);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      a[i][j] = m[i * 3 + j];
      mx = absval(a[i][j]) > mx ? absval(a[i][j]) : mx;
    }
  }
  const T inv = mx > T(0) ? T(1) / mx : T(1);
  T b[3][3];            // b[j] = column j of A V, scaled
  T v[3][3];            // v[j] = column j of V
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      b[j][r] = a[r][j] * inv;
      v[j][r] = r == j ? T(1) : T(0);
    }
  }
  for (int s = 0; s < sweeps; ++s) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
#pragma unroll
      for (int q = p + 1; q < 3; ++q) {
        const T alpha = dot3(b[p], b[p]);
        const T beta = dot3(b[q], b[q]);
        const T gamma = dot3(b[p], b[q]);
        if (!(absval(gamma) > Eps<T>::value * sqrt(alpha * beta))) continue;
        const T zeta = (beta - alpha) / (T(2) * gamma);
        const T t = (zeta < T(0) ? T(-1) : T(1)) / (absval(zeta) + sqrt(T(1) + zeta * zeta));
        const T c = T(1) / sqrt(T(1) + t * t);
        const T sn = c * t;
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const T bp = b[p][r], bq = b[q][r];
          b[p][r] = c * bp - sn * bq;
          b[q][r] = sn * bp + c * bq;
          const T vp = v[p][r], vq = v[q][r];
          v[p][r] = c * vp - sn * vq;
          v[q][r] = sn * vp + c * vq;
        }
      }
    }
  }
  T sv[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) sv[j] = sqrt(dot3(b[j], b[j]));
  swap_cols(sv, b, v, 0, 1);
  swap_cols(sv, b, v, 1, 2);
  swap_cols(sv, b, v, 0, 1);

  T u[3][3];            // u[j] = column j of U
  const T tiny = T(1e-20);
  if (sv[0] > tiny) {
#pragma unroll
    for (int r = 0; r < 3; ++r) u[0][r] = b[0][r] / sv[0];
  } else {
    u[0][0] = T(1); u[0][1] = T(0); u[0][2] = T(0);
  }
  const T proj = dot3(u[0], b[1]);
  T rest[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) rest[r] = b[1][r] - proj * u[0][r];
  T n1 = sqrt(dot3(rest, rest));
  if (!(n1 > tiny)) {
    // rank 1 (or 0): the axis u0 leans on least, its u0 part removed
    int k = 0;
#pragma unroll
    for (int r = 1; r < 3; ++r) k = absval(u[0][r]) < absval(u[0][k]) ? r : k;
#pragma unroll
    for (int r = 0; r < 3; ++r) rest[r] = (r == k ? T(1) : T(0)) - u[0][k] * u[0][r];
    n1 = sqrt(dot3(rest, rest));
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) u[1][r] = rest[r] / n1;
  cross3(u[0], u[1], u[2]);
  cross3(v[0], v[1], v[2]);

  // the signed third value: u2 . (A v2)
  T av[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) av[i] = a[i][0] * v[2][0] + a[i][1] * v[2][1] + a[i][2] * v[2][2];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      u_out[i * 3 + j] = u[j][i];
      vt_out[i * 3 + j] = v[i][j];
    }
  }
  s_out[0] = sv[0] * mx;
  s_out[1] = sv[1] * mx;
  s_out[2] = dot3(u[2], av);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
svd3_kernel(const T* __restrict__ a, T* __restrict__ u, T* __restrict__ s,
            T* __restrict__ vt, int batch, int sweeps) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= batch) return;
  const size_t o = static_cast<size_t>(b);
  svd3<T>(a + o * 9, u + o * 9, s + o * 3, vt + o * 9, sweeps);
}

template <typename T>
int launch(const void* a, void* u, void* s, void* vt, int batch, int sweeps, void* stream) {
  const int blocks = (batch + kThreads - 1) / kThreads;
  svd3_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<T*>(u), static_cast<T*>(s), static_cast<T*>(vt),
      batch, sweeps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: (batch, 3, 3) contiguous, row-major; u, vt (batch, 3, 3) and s
// (batch, 3) written, U diag(s) Vt = a with det U = det Vt = +1; is_double
// selects float64 over float32; sweeps is the fixed number of Jacobi sweeps.
extern "C" int isl_svd3_launch(const void* a, void* u, void* s, void* vt, int batch,
                               int is_double, int sweeps, void* stream) {
  if (batch <= 0) return 0;
  return is_double ? launch<double>(a, u, s, vt, batch, sweeps, stream)
                   : launch<float>(a, u, s, vt, batch, sweeps, stream);
}

extern "C" const char* isl_svd3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
