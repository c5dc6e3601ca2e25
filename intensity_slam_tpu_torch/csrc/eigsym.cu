// Batched symmetric eigendecomposition of small matrices, for Hopper (sm_90a).
//
// Replaces XLA's `jnp.linalg.eigh` / `jnp.linalg.eigvalsh`, which the JAX
// package calls at intensity_slam_tpu/ops/ground.py:56 (the RANSAC plane
// refit, 3x3 with vectors), pipeline/mapping.py:167 (`fit_lines`, 3x3 with
// vectors) and ops/solver.py:185 (the smallest eigenvalue of the 6x6
// Gauss-Newton Hessian, values only).  No Pallas source: on a TPU XLA lowers
// these to a Jacobi eigensolver that reports nothing to the host.  PyTorch's
// `torch.linalg.eigh` on the card checks a status on the host after every
// call, so it cannot be captured into a CUDA graph; this kernel reads nothing
// back and has no status.
//
// Design: one thread per matrix, cyclic Jacobi with a fixed number of sweeps
// (no convergence test, so no data-dependent trip count), the matrix and the
// accumulated rotations in registers (N is a compile-time constant and every
// loop over rows is unrolled).  The rotation is the classical one
// (Rutishauser's form: t = sgn(theta) / (|theta| + sqrt(1 + theta^2)), with
// the tau update), an off-diagonal element that is negligible against both
// diagonal elements is set to zero after the fourth sweep.  The lower
// triangle is read, as `torch.linalg.eigh` reads it.  Eigenvalues come out
// ascending, eigenvectors as columns (vecs[b][r][i] is component r of
// eigenvector i): the layout of `torch.linalg.eigh`.  The sign of an
// eigenvector is free, as it is for LAPACK's.
//
// What bounds it on an H100: bytes, about 84 B for a 3x3 float32 matrix with
// vectors (36 in, 12 + 36 out) and 168 B for a 6x6 with values only, which at
// these batch sizes (1 to a few thousand matrices) is far below the launch
// floor of a few microseconds: the kernel is launch bound, and one launch
// replaces `eigh`'s several kernels and its host read.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <typename T>
__device__ __forceinline__ T absval(T x) { return x < T(0) ? -x : x; }

template <typename T, int N, bool VECS>
__global__ void __launch_bounds__(kThreads)
jacobi_kernel(const T* __restrict__ a, T* __restrict__ vals, T* __restrict__ vecs,
              int batch, int sweeps) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const T* m = a + static_cast<size_t>(b) * N * N;
  T A[N][N];
  T V[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      A[i][j] = i >= j ? m[i * N + j] : m[j * N + i];
      if (VECS) V[i][j] = i == j ? T(1) : T(0);
    }
  }
  for (int s = 0; s < sweeps; ++s) {
#pragma unroll
    for (int p = 0; p < N - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < N; ++q) {
        const T apq = A[p][q];
        const T app = A[p][p];
        const T aqq = A[q][q];
        const T g = T(100) * absval(apq);
        if (s > 3 && absval(app) + g == absval(app) && absval(aqq) + g == absval(aqq)) {
          A[p][q] = A[q][p] = T(0);
          continue;
        }
        if (apq == T(0)) continue;
        const T h = aqq - app;
        T t;
        if (absval(h) + g == absval(h)) {
          t = apq / h;
        } else {
          const T theta = T(0.5) * h / apq;
          t = T(1) / (absval(theta) + sqrt(T(1) + theta * theta));
          if (theta < T(0)) t = -t;
        }
        const T c = T(1) / sqrt(T(1) + t * t);
        const T sn = t * c;
        const T tau = sn / (T(1) + c);
        A[p][p] = app - t * apq;
        A[q][q] = aqq + t * apq;
        A[p][q] = A[q][p] = T(0);
#pragma unroll
        for (int r = 0; r < N; ++r) {
          if (r == p || r == q) continue;
          const T arp = A[r][p];
          const T arq = A[r][q];
          A[r][p] = A[p][r] = arp - sn * (arq + tau * arp);
          A[r][q] = A[q][r] = arq + sn * (arp - tau * arq);
        }
        if (VECS) {
#pragma unroll
          for (int r = 0; r < N; ++r) {
            const T vrp = V[r][p];
            const T vrq = V[r][q];
            V[r][p] = vrp - sn * (vrq + tau * vrp);
            V[r][q] = vrq + sn * (vrp - tau * vrq);
          }
        }
      }
    }
  }
  // ascending order (a stable insertion sort of N values and their columns)
  T d[N];
  int col[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    d[i] = A[i][i];
    col[i] = i;
  }
#pragma unroll
  for (int i = 1; i < N; ++i) {
#pragma unroll
    for (int j = i; j > 0; --j) {
      if (d[j] < d[j - 1]) {
        const T dt = d[j]; d[j] = d[j - 1]; d[j - 1] = dt;
        const int ct = col[j]; col[j] = col[j - 1]; col[j - 1] = ct;
      }
    }
  }
  T* w = vals + static_cast<size_t>(b) * N;
#pragma unroll
  for (int i = 0; i < N; ++i) w[i] = d[i];
  if (VECS) {
    T* out = vecs + static_cast<size_t>(b) * N * N;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      // column i is the eigenvector of d[i]; col[i] is a runtime index, so
      // select it with unrolled compares to keep V in registers
#pragma unroll
      for (int r = 0; r < N; ++r) {
        T v = V[r][0];
#pragma unroll
        for (int k = 1; k < N; ++k) v = col[i] == k ? V[r][k] : v;
        out[r * N + i] = v;
      }
    }
  }
}

template <typename T, int N, bool VECS>
int launch(const void* a, void* vals, void* vecs, int batch, int sweeps, void* stream) {
  const int blocks = (batch + kThreads - 1) / kThreads;
  jacobi_kernel<T, N, VECS><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<T*>(vals), static_cast<T*>(vecs), batch,
      sweeps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* a, void* vals, void* vecs, int batch, int n, int sweeps,
             void* stream) {
  if (n == 3) {
    return vecs ? launch<T, 3, true>(a, vals, vecs, batch, sweeps, stream)
                : launch<T, 3, false>(a, vals, vecs, batch, sweeps, stream);
  }
  if (n == 6) {
    return vecs ? launch<T, 6, true>(a, vals, vecs, batch, sweeps, stream)
                : launch<T, 6, false>(a, vals, vecs, batch, sweeps, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// a: (batch, n, n) contiguous, n = 3 or 6; vals (batch, n); vecs (batch, n, n)
// or null for values only; is_double selects float64 over float32.
extern "C" int isl_eigsym_launch(const void* a, void* vals, void* vecs, int batch,
                                 int n, int is_double, int sweeps, void* stream) {
  if (batch <= 0) return 0;
  return is_double ? dispatch<double>(a, vals, vecs, batch, n, sweeps, stream)
                   : dispatch<float>(a, vals, vecs, batch, n, sweeps, stream);
}

extern "C" const char* isl_eigsym_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
