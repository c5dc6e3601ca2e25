// Batched symmetric eigendecomposition of small matrices, for Hopper (sm_90a).
//
// Replaces XLA's `jnp.linalg.eigh` / `jnp.linalg.eigvalsh`, which the JAX
// package calls at intensity_slam_tpu/ops/ground.py:56 (the RANSAC plane
// refit, 3x3 with vectors), pipeline/mapping.py:167 (`fit_lines`, 3x3 with
// vectors) and ops/solver.py:185 (the smallest eigenvalue of the 6x6
// Gauss-Newton Hessian, values only).  No Pallas source: on a TPU XLA lowers
// these to a Jacobi eigensolver that reports nothing to the host.  PyTorch's
// `torch.linalg.eigh` on the card checks a status on the host after every
// call, so it cannot be captured into a CUDA graph; these kernels read
// nothing back and have no status.  The lower triangle is read, as
// `torch.linalg.eigh` reads it.  Eigenvalues come out ascending,
// eigenvectors as columns (vecs[b][r][i] is component r of eigenvector i):
// the layout of `torch.linalg.eigh`.  The sign of an eigenvector is free, as
// it is for LAPACK's.  An all-zero matrix gives zeros.
//
// What bounds them on an H100: neither bytes (84 B for a 3x3 float32 matrix
// with vectors, 168 B for a 6x6 with values, at 1 to a few thousand
// matrices) nor operations (a few thousand a matrix).  Both are bound by
// the latency of a chain of dependent rotations, each a division, a square
// root and their updates, on top of a launch's own device time of about a
// microsecond.  The first version (one thread a matrix, a fixed 12 cyclic
// sweeps) took 28.57 us device-side for one 6x6 and 8.66 us for the line
// fit's (1024, 3, 3) batch: 12 sweeps x 15 rotations in one chain for the
// 6x6.  So each design below shortens the chain.  On an H100 at 700 W
// these take 5.3 us for one float32 6x6, 5.2 us for (1024, 3, 3) and 3.4 us
// for one 3x3, where a one-element fill takes 1.0 us (chip_smoke.py).
//
// jacobi_kernel<T, 6, false> (values only): one warp a matrix, lane l < 21
// holding the lower-triangle element (i, j), l = i (i + 1) / 2 + j.  A sweep
// is 5 rounds of 3 disjoint pairs in the round-robin (circle-method) order:
// round k pairs 5 with k and k + d with k - d (mod 5), d = 1, 2, so every
// pair comes once a sweep.  The three pivot lanes compute their rotations
// from the same matrix at once (t from one division with `hypot`, which
// cannot overflow or underflow, c = rsqrt(1 + t^2), s = t c), and every lane
// then updates its element from the four at (i or its partner, j or its
// partner), fetched with `__shfl_sync` before the round, in c/s form; the
// diagonal takes the classical a_pp - t a_pq, a_qq + t a_pq and the pivot 0.
// Only the lower triangle exists, so the matrix stays symmetric bit for bit.
// An off-diagonal element negligible against both its diagonal elements
// (below 1 % of their last bit) is set to zero on every sweep.  The warp
// stops after a sweep that met only zero pivots, which leaves every later
// sweep with nothing to do; all 32 lanes belong to the one matrix, so the
// warp vote on it reads no other matrix.  The chain is 5 rounds a sweep
// instead of 15 rotations, each shorter (one division, no tau).
//
// jacobi_kernel<T, 3, VECS>: one thread a matrix, the matrix and the
// accumulated rotations in registers (every loop unrolled), the classical
// cyclic Jacobi (Rutishauser's form: t = sgn(theta) / (|theta| + sqrt(1 +
// theta^2)), with the tau update; an off-diagonal element negligible against
// both diagonal elements is set to zero from the fifth sweep on).  Each
// matrix stops after a sweep that met only zero off-diagonal elements, at
// the latest after `sweeps`.  Such a sweep changes nothing, so every later
// one would change nothing either: the exit gives the same bits as running
// all `sweeps` (tests/test_torch_eigsym_model.py holds this on a model of
// the same arithmetic).  Each thread exits on its own matrix's test alone.
// A warp runs every rotation any of its matrices needs: 32 matrices a warp
// took the (1024, 3, 3) batch 7.4 us, against 4.1 us for 1024 copies of
// one matrix and 3.4 us for one matrix.  So a batch is spread over at least
// kSpreadWarps warps (one a block of 32 threads; two on each of the H100's
// 528 warp schedulers) with as few matrices a warp as that allows: one a
// warp up to 1056 matrices (the line fit's 1024: 5.15 us), 8 for the
// batched sessions' 8 x 1024 (8.2 us; one a warp took 16.2 us there, where
// the schedulers' issue slots bound it), at most 32 (tools/torch_eig_tune.py
// sweeps the spread).
//
// Both: a matrix's output depends on that matrix alone (not its batch, its
// position or its neighbours' convergence: no vote across matrices, no
// atomics), and the same input gives the same bits on every launch.  The
// loop's trip count depends on the data inside the kernel, which a CUDA
// graph captures as it is.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
#ifndef ISL_EIG_SPREAD_WARPS
#define ISL_EIG_SPREAD_WARPS (8 * 132)
#endif
constexpr int kSpreadWarps = ISL_EIG_SPREAD_WARPS;
constexpr unsigned kFullMask = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T absval(T x) { return x < T(0) ? -x : x; }

__device__ __forceinline__ float hypot_(float x, float y) { return hypotf(x, y); }
__device__ __forceinline__ double hypot_(double x, double y) { return hypot(x, y); }
__device__ __forceinline__ float rsqrt_(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_(double x) { return rsqrt(x); }

// the lane of element (i, j) of the lower triangle
__device__ __forceinline__ int tri(int i, int j) {
  return i >= j ? i * (i + 1) / 2 + j : j * (j + 1) / 2 + i;
}

// the index paired with x in round k of a 6x6 sweep
__device__ __forceinline__ int partner6(int k, int x) {
  return x == 5 ? k : (x == k ? 5 : (2 * k - x + 5) % 5);
}

template <typename T>
__device__ void jacobi6(const T* __restrict__ m, T* __restrict__ w, int sweeps) {
  const int lane = threadIdx.x;
  // lanes 21..31 shadow lane 20's element; they vote no and write nothing
  const bool live = lane < 21;
  int i = 0;
  int j = live ? lane : 20;
  while (j > i) {
    ++i;
    j -= i;
  }
  T a = m[i * 6 + j];
  for (int s = 0; s < sweeps; ++s) {
    bool changed = false;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const int pi = partner6(k, i);
      const int pj = partner6(k, j);
      // the round's inputs, all from the matrix before it
      const T a_i_pj = __shfl_sync(kFullMask, a, tri(i, pj));
      const T a_pi_j = __shfl_sync(kFullMask, a, tri(pi, j));
      const T a_pi_pj = __shfl_sync(kFullMask, a, tri(pi, pj));
      const T app = __shfl_sync(kFullMask, a, tri(j, j));
      const T aqq = __shfl_sync(kFullMask, a, tri(i, i));
      // on a pivot lane (i, j) = (q, p), q > p: the rotation of its pair
      const bool pivot = pi == j && i != j;
      const T g = T(100) * absval(a);
      const bool negligible = absval(app) + g == absval(app) && absval(aqq) + g == absval(aqq);
      const bool rot = pivot && !negligible && a != T(0);
      changed |= pivot && a != T(0);          // zeroed or rotated
      const T h = aqq - app;
      const T t = rot ? T(2) * a * (h < T(0) ? T(-1) : T(1))
                            / (absval(h) + hypot_(h, T(2) * a))
                      : T(0);
      const T c = rot ? rsqrt_(T(1) + t * t) : T(1);
      const T sn = t * c;
      const T delta = t * a;
      // every lane: the rotations of its row's pair and its column's pair
      const T ci = __shfl_sync(kFullMask, c, tri(i, pi));
      const T si = __shfl_sync(kFullMask, sn, tri(i, pi));
      const T cj = __shfl_sync(kFullMask, c, tri(j, pj));
      const T sj = __shfl_sync(kFullMask, sn, tri(j, pj));
      const T di = __shfl_sync(kFullMask, delta, tri(i, pi));
      // column j of A J, then row i of J^T (A J): (i, p) takes c x_p - s x_q,
      // (i, q) takes c x_q + s x_p
      const T sgj = j > pj ? sj : -sj;
      const T sgi = i > pi ? si : -si;
      const T x1 = cj * a + sgj * a_i_pj;
      const T x2 = cj * a_pi_j + sgj * a_pi_pj;
      const T off = ci * x1 + sgi * x2;
      a = i == j ? (i < pi ? a - di : a + di) : (pivot ? T(0) : off);
    }
    if (!__any_sync(kFullMask, live && changed)) break;
  }
  // ascending order (a stable insertion sort, the same in every lane)
  T d[6];
#pragma unroll
  for (int x = 0; x < 6; ++x) d[x] = __shfl_sync(kFullMask, a, tri(x, x));
#pragma unroll
  for (int x = 1; x < 6; ++x) {
#pragma unroll
    for (int y = x; y > 0; --y) {
      if (d[y] < d[y - 1]) {
        const T dt = d[y]; d[y] = d[y - 1]; d[y - 1] = dt;
      }
    }
  }
  if (lane < 6) {
    T v = d[0];
#pragma unroll
    for (int x = 1; x < 6; ++x) v = lane == x ? d[x] : v;
    w[lane] = v;
  }
}

template <typename T, bool VECS>
__device__ void jacobi3(const T* __restrict__ m, T* __restrict__ w, T* __restrict__ out,
                        int sweeps) {
  constexpr int N = 3;
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
    bool changed = false;
#pragma unroll
    for (int p = 0; p < N - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < N; ++q) {
        const T apq = A[p][q];
        const T app = A[p][p];
        const T aqq = A[q][q];
        changed |= apq != T(0);               // zeroed or rotated
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
    if (!changed) break;
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
#pragma unroll
  for (int i = 0; i < N; ++i) w[i] = d[i];
  if (VECS) {
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
__global__ void __launch_bounds__(kThreads)
jacobi_kernel(const T* __restrict__ a, T* __restrict__ vals, T* __restrict__ vecs,
              int batch, int sweeps, int per_warp) {
  static_assert(N == 3 || (N == 6 && !VECS), "3x3 with or without vectors, 6x6 values");
  if constexpr (N == 6) {
    // one warp (one block) a matrix
    const size_t b = blockIdx.x;
    jacobi6<T>(a + b * 36, vals + b * 6, sweeps);
  } else {
    // one warp (one block) holds per_warp matrices, a thread each
    const int b = blockIdx.x * per_warp + threadIdx.x;
    if (static_cast<int>(threadIdx.x) >= per_warp || b >= batch) return;
    jacobi3<T, VECS>(a + static_cast<size_t>(b) * 9, vals + static_cast<size_t>(b) * 3,
                     VECS ? vecs + static_cast<size_t>(b) * 9 : nullptr, sweeps);
  }
}

template <typename T, int N, bool VECS>
int launch(const void* a, void* vals, void* vecs, int batch, int sweeps, void* stream) {
  const int spread = (batch + kSpreadWarps - 1) / kSpreadWarps;
  const int per_warp = N == 6 ? 1 : (spread < kThreads ? spread : kThreads);
  const int blocks = (batch + per_warp - 1) / per_warp;
  jacobi_kernel<T, N, VECS><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<T*>(vals), static_cast<T*>(vecs), batch,
      sweeps, per_warp);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* a, void* vals, void* vecs, int batch, int n, int sweeps,
             void* stream) {
  if (n == 3) {
    return vecs ? launch<T, 3, true>(a, vals, vecs, batch, sweeps, stream)
                : launch<T, 3, false>(a, vals, vecs, batch, sweeps, stream);
  }
  if (n == 6 && !vecs) return launch<T, 6, false>(a, vals, vecs, batch, sweeps, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// a: (batch, n, n) contiguous, n = 3 or 6; vals (batch, n); vecs (batch, n, n)
// or null for values only (always for n = 6); is_double selects float64 over
// float32; sweeps caps the sweeps a matrix may take.
extern "C" int isl_eigsym_launch(const void* a, void* vals, void* vecs, int batch,
                                 int n, int is_double, int sweeps, void* stream) {
  if (batch <= 0) return 0;
  return is_double ? dispatch<double>(a, vals, vecs, batch, n, sweeps, stream)
                   : dispatch<float>(a, vals, vecs, batch, n, sweeps, stream);
}

extern "C" const char* isl_eigsym_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
