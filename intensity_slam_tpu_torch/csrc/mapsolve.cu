// The scan-to-map pose solve for Hopper (sm_90a): the robust Gauss-Newton /
// Levenberg-Marquardt solve of `pipeline/mapping.py::mapping_step` over its
// point-to-plane rows, its 6-dim pose-prior block, its point-to-line rows
// and (with the sliding window) its point-to-point rows.
//
// Replaces the composition that `ops/mapsolve.py::solve_plain` keeps:
// `solver.solve_pose` over `concat_residuals(point_to_plane_nd, pose_prior,
// point_to_line[, point_to_point])`, huber 0.2, which the JAX package runs
// as one `lax.while_loop` (intensity_slam_tpu/ops/solver.py:177, called from
// pipeline/mapping.py); there is no Pallas source.  In PyTorch every
// iteration of that loop is some 730 small kernels (the rotation, the skew
// matrices, three residual sets with their Jacobians, the Huber weights, the
// prior's float64 central difference over 12 poses, the einsums, the damped
// 6x6 solve, the trial cost), whose launches, not their work, set its time.
//
// Two kernels, launched by `isl_mapsolve_eval` and `isl_mapsolve_step`:
//
// mapsolve_eval_kernel: grid (blocks, B sessions), 128 threads.  Every
//   thread takes residual rows (planes, then lines, then points) at the
//   session's evaluated pose (R from q once a block, in shared memory):
//   residual, IRLS Huber weight on the block's squared norm times the row's
//   weight, Jacobian row from the closed forms of `ops/solver.py`
//   (J_pw = [-R [p]x, R]; n^T J_pw for a plane, [b - a]x J_pw / |a - b|
//   for a line, J_pw for a point), and adds w_rob J^T J (21 upper-triangle
//   entries), w_rob J^T r (6) and rho(|r|^2) w (1) to its 28 sums.  The
//   block reduces them (warp shuffles, then the warps in order) into its
//   row of the partial sums.  A session that has stopped iterating returns
//   at once.
// mapsolve_step_kernel: one block, one warp a session.  Lanes 0-27 sum the
//   session's partial rows in block order; lanes 0-11 evaluate the prior's
//   twelve moved poses in float64 (the central difference of
//   `ops/mapsolve.py::pose_prior`, step 1e-6); lane 0 adds the prior block
//   and does what an iteration of `solve_pose` does: on the first call
//   (`init`) the initial cost and the loop state, after a trial evaluation
//   accept or reject (pose, cost, damping, relative decrease, rejections,
//   gradient norm, iterations, frozen where the session had stopped), then
//   the loop's test, and where it holds the next candidate: the damping
//   lambda * max(diag, 1e-8) + 1e-6 max(max diag, 1), the 6x6 solve
//   (Gaussian elimination with partial pivoting, as LAPACK's getrf), the
//   trust-region clip and the retraction.  Thread 0 then writes whether any
//   session iterates on: the test the next conditional node reads.
//
// The trial evaluation at the candidate is also the next linearization: its
// H and b are adopted where the step is accepted (a rejected step keeps the
// pose, hence its H and b), the same numbers the plain loop recomputes.
//
// No float atomics: every sum runs in a fixed order, so a replay repeats
// bit for bit.  Float32 throughout, float64 only in the prior's central
// difference, as in the plain version.
//
// Bound: about 3 000 rows of ~150 flops and ~50 B each, microseconds of
// work at most; the latency of the two launches and of lane 0's serial
// chain (the prior, the 6x6 solve) sets the time.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 28;          // 21 H (upper triangle, row-major), 6 b, 1 cost
constexpr int kMaxBlocks = 256;
constexpr int kMaxSessions = 32;   // one warp a session in the step kernel
constexpr double kPriorStep = 1e-6;
constexpr float kFtol = 1e-6f;     // Ceres' function_tolerance default
constexpr int kMaxReject = 3;

// a session's state row (float32), shared with ops/mapsolve.py
enum : int {
  kQ = 0, kT = 4, kCost = 7, kCost0 = 8, kLam = 9, kRel = 10, kGnorm = 11, kTol = 12,
  kH = 16, kB = 37, kCandQ = 44, kCandT = 48, kStateSize = 64,
};

template <typename T> struct C;
template <> struct C<float> {
  static __device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
  static __device__ __forceinline__ float sin_(float x) { return sinf(x); }
  static __device__ __forceinline__ float cos_(float x) { return cosf(x); }
  static __device__ __forceinline__ float atan2_(float y, float x) { return atan2f(y, x); }
};
template <> struct C<double> {
  static __device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
  static __device__ __forceinline__ double sin_(double x) { return sin(x); }
  static __device__ __forceinline__ double cos_(double x) { return cos(x); }
  static __device__ __forceinline__ double atan2_(double y, double x) { return atan2(y, x); }
};

template <typename T>
__device__ __forceinline__ T max_(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T min_(T a, T b) { return a < b ? a : b; }

template <typename T>
__device__ __forceinline__ void cross3(const T* a, const T* b, T* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// ---- SE(3) on wxyz quaternions: utils/se3.py's formulas ---------------------

template <typename T>
__device__ void quat_rotate(const T* q, const T* v, T* out) {
  T uv[3], uuv[3];
  cross3(q + 1, v, uv);
  cross3(q + 1, uv, uuv);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = v[i] + T(2) * (q[0] * uv[i] + uuv[i]);
}

template <typename T>
__device__ void quat_normalize(T* q) {
  const T n = max_(C<T>::sqrt_(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]),
                   T(1e-9));
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = q[i] / n;
}

template <typename T>
__device__ void quat_mul(const T* a, const T* b, T* out) {
  out[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  out[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  out[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  out[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

template <typename T>
__device__ void quat_to_mat(const T* q, T (&R)[3][3]) {
  const T w = q[0], x = q[1], y = q[2], z = q[3];
  const T xx = x * x, yy = y * y, zz = z * z;
  const T wx = w * x, wy = w * y, wz = w * z;
  const T xy = x * y, xz = x * z, yz = y * z;
  R[0][0] = 1 - 2 * (yy + zz); R[0][1] = 2 * (xy - wz);     R[0][2] = 2 * (xz + wy);
  R[1][0] = 2 * (xy + wz);     R[1][1] = 1 - 2 * (xx + zz); R[1][2] = 2 * (yz - wx);
  R[2][0] = 2 * (xz - wy);     R[2][1] = 2 * (yz + wx);     R[2][2] = 1 - 2 * (xx + yy);
}

// a o b (b first): q normalized, t = R_a t_b + t_a
template <typename T>
__device__ void compose(const T* aq, const T* at, const T* bq, const T* bt, T* q, T* t) {
  quat_mul(aq, bq, q);
  quat_normalize(q);
  quat_rotate(aq, bt, t);
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] += at[i];
}

template <typename T>
__device__ void inverse(const T* q, const T* t, T* iq, T* it) {
  iq[0] = q[0]; iq[1] = -q[1]; iq[2] = -q[2]; iq[3] = -q[3];
  quat_rotate(iq, t, it);
#pragma unroll
  for (int i = 0; i < 3; ++i) it[i] = -it[i];
}

template <typename T>
__device__ void skew_sq(const T* p, T (&K)[3][3], T (&KK)[3][3]) {
  K[0][0] = 0;     K[0][1] = -p[2]; K[0][2] = p[1];
  K[1][0] = p[2];  K[1][1] = 0;     K[1][2] = -p[0];
  K[2][0] = -p[1]; K[2][1] = p[0];  K[2][2] = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) KK[i][j] = K[i][0] * K[0][j] + K[i][1] * K[1][j] + K[i][2] * K[2][j];
}

// p o exp(xi), xi = (phi, rho): so3_exp and the exact left Jacobian V
template <typename T>
__device__ void retract(const T* pq, const T* pt, const T* xi, T* q, T* t) {
  const T* phi = xi;
  const T theta2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const T theta = C<T>::sqrt_(max_(theta2, T(1e-18)));
  const bool small = theta2 < T(1e-12);
  const T half = T(0.5) * theta;
  T eq[4];
  eq[0] = small ? T(1) - theta2 / T(8) : C<T>::cos_(half);
  const T k = small ? T(0.5) - theta2 / T(48) : C<T>::sin_(half) / theta;
  eq[1] = k * phi[0]; eq[2] = k * phi[1]; eq[3] = k * phi[2];
  quat_normalize(eq);
  T K[3][3], KK[3][3];
  skew_sq(phi, K, KK);
  const T A = small ? T(0.5) - theta2 / T(24)
                    : (T(1) - C<T>::cos_(theta)) / max_(theta2, T(1e-9));
  const T Bc = small ? T(1) / T(6) - theta2 / T(120)
                     : (theta - C<T>::sin_(theta)) / max_(theta2 * theta, T(1e-9));
  T et[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    T acc = 0;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      acc += (T(i == j) + A * K[i][j] + Bc * KK[i][j]) * xi[3 + j];
    et[i] = acc;
  }
  compose(pq, pt, eq, et, q, t);
}

// se3_log of (q, t): (phi, rho)
template <typename T>
__device__ void se3_log(const T* qin, const T* t, T* xi) {
  const T s = qin[0] < T(0) ? T(-1) : T(1);
  const T q1 = s * qin[1], q2 = s * qin[2], q3 = s * qin[3];
  const T w = min_(max_(s * qin[0], T(-1)), T(1));
  const T sq = q1 * q1 + q2 * q2 + q3 * q3;
  const bool tiny = sq < T(1e-12);
  const T vn = C<T>::sqrt_(tiny ? T(1) : sq);
  const T ang = T(2) * C<T>::atan2_(vn, w);
  const T scale = tiny ? T(2) / max_(w, T(1e-9)) : ang / vn;
  T phi[3] = {scale * q1, scale * q2, scale * q3};
  const T theta2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const T theta = C<T>::sqrt_(max_(theta2, T(1e-18)));
  const bool small = theta2 < T(1e-12);
  const T half = theta / T(2);
  const T cot_term = half * C<T>::cos_(half) / max_(C<T>::sin_(half), T(1e-9));
  const T Cc = small ? T(1) / T(12) + theta2 / T(720)
                     : (T(1) - cot_term) / max_(theta2, T(1e-9));
  T K[3][3], KK[3][3];
  skew_sq(phi, K, KK);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    xi[i] = phi[i];
    T acc = 0;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      acc += (T(i == j) - T(0.5) * K[i][j] + Cc * KK[i][j]) * t[j];
    xi[3 + i] = acc;
  }
}

// ---- residual rows -----------------------------------------------------------

struct Rows {
  const float* plane_p; const float* plane_n; const float* plane_d; const float* plane_w;
  const float* line_p; const float* line_a; const float* line_b; const float* line_w;
  const float* pt_src; const float* pt_dst; const float* pt_w;
  int gp, gl, gw;
};

// rho and the IRLS weight of a block's squared norm (solver.robust_cost,
// solver.huber_weight)
__device__ __forceinline__ void huber(float sq, float delta, float* rho, float* rw) {
  const float norm = sqrtf(max_(sq, 1e-18f));
  *rw = norm <= delta ? 1.0f : delta / norm;
  const float d2 = delta * delta;
  *rho = sq <= d2 ? sq : 2.0f * delta * norm - d2;
}

// adds w_rob J^T J, w_rob J^T r and rho w of one D-dim block to the sums
template <int D>
__device__ __forceinline__ void accumulate(const float (&J)[D][6], const float (&r)[D], float w,
                                           float delta, float* s) {
  float sq = 0;
#pragma unroll
  for (int d = 0; d < D; ++d) sq += r[d] * r[d];
  float rho, rw;
  huber(sq, delta, &rho, &rw);
  const float wt = w * rw;
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) {
      float acc = 0;
#pragma unroll
      for (int d = 0; d < D; ++d) acc += J[d][i] * J[d][j];
      s[k++] += wt * acc;
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float acc = 0;
#pragma unroll
    for (int d = 0; d < D; ++d) acc += J[d][i] * r[d];
    s[21 + i] += wt * acc;
  }
  s[27] += rho * w;
}

// J_pw = [-R [p]x, R] (3 x 6) and p' = R p + t (quat_rotate's form)
__device__ __forceinline__ void point_jacobian(const float (&R)[3][3], const float* q,
                                               const float* t, const float* p, float (&Jp)[3][6],
                                               float* pw) {
  quat_rotate(q, p, pw);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    pw[i] += t[i];
    // row i of R [p]x: (R_i0, R_i1, R_i2) [p]x = p x R_i (as a row)
    Jp[i][0] = -(R[i][1] * p[2] - R[i][2] * p[1]);
    Jp[i][1] = -(R[i][2] * p[0] - R[i][0] * p[2]);
    Jp[i][2] = -(R[i][0] * p[1] - R[i][1] * p[0]);
    Jp[i][3] = R[i][0]; Jp[i][4] = R[i][1]; Jp[i][5] = R[i][2];
  }
}

// the pose a call evaluates: the prior on the first call, else the state
// row's candidate
__device__ __forceinline__ const float* eval_q(const float* prior_q, const float* state,
                                               int init, int b) {
  return init ? prior_q + 4 * b : state + (long)b * kStateSize + kCandQ;
}
__device__ __forceinline__ const float* eval_t(const float* prior_t, const float* state,
                                               int init, int b) {
  return init ? prior_t + 3 * b : state + (long)b * kStateSize + kCandT;
}

__global__ void __launch_bounds__(kThreads)
mapsolve_eval_kernel(Rows rows, const float* prior_q, const float* prior_t, const float* state,
                     const bool* active, int init, float delta, float* partials) {
  const int b = blockIdx.y;
  if (!init && !active[b]) return;
  __shared__ float sh_pose[7 + 9];
  __shared__ float sh_sum[kWarps][kSums];
  if (threadIdx.x == 0) {
    const float* pq = eval_q(prior_q, state, init, b);
    const float* pt = eval_t(prior_t, state, init, b);
    float q[4], R[3][3];
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = pq[i];
    quat_to_mat(q, R);
#pragma unroll
    for (int i = 0; i < 4; ++i) sh_pose[i] = q[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) sh_pose[4 + i] = pt[i];
#pragma unroll
    for (int i = 0; i < 9; ++i) sh_pose[7 + i] = R[i / 3][i % 3];
  }
  __syncthreads();
  float q[4], t[3], R[3][3];
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = sh_pose[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = sh_pose[4 + i];
#pragma unroll
  for (int i = 0; i < 9; ++i) R[i / 3][i % 3] = sh_pose[7 + i];

  float s[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) s[k] = 0;
  const int G = rows.gp + rows.gl + rows.gw;
  for (int g = blockIdx.x * kThreads + threadIdx.x; g < G; g += gridDim.x * kThreads) {
    float Jp[3][6], pw[3];
    if (g < rows.gp) {
      const long o = (long)b * rows.gp + g;
      const float* p = rows.plane_p + 3 * o;
      const float* n = rows.plane_n + 3 * o;
      point_jacobian(R, q, t, p, Jp, pw);
      float J[1][6], r[1];
      r[0] = pw[0] * n[0] + pw[1] * n[1] + pw[2] * n[2] + rows.plane_d[o];
#pragma unroll
      for (int j = 0; j < 6; ++j) J[0][j] = n[0] * Jp[0][j] + n[1] * Jp[1][j] + n[2] * Jp[2][j];
      accumulate<1>(J, r, rows.plane_w[o], delta, s);
    } else if (g < rows.gp + rows.gl) {
      const long o = (long)b * rows.gl + (g - rows.gp);
      const float* a = rows.line_a + 3 * o;
      const float* bb = rows.line_b + 3 * o;
      point_jacobian(R, q, t, rows.line_p + 3 * o, Jp, pw);
      const float dx = a[0] - bb[0], dy = a[1] - bb[1], dz = a[2] - bb[2];
      const float denom = max_(sqrtf(dx * dx + dy * dy + dz * dz), 1e-9f);
      float pa[3], pb[3], c[3], r[3], J[3][6];
#pragma unroll
      for (int i = 0; i < 3; ++i) { pa[i] = pw[i] - a[i]; pb[i] = pw[i] - bb[i]; }
      cross3(pa, pb, c);
#pragma unroll
      for (int i = 0; i < 3; ++i) r[i] = c[i] / denom;
      // [b - a]x J_pw / denom, row by row: (b - a) x (column of J_pw)
      const float e[3] = {bb[0] - a[0], bb[1] - a[1], bb[2] - a[2]};
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        J[0][j] = (e[1] * Jp[2][j] - e[2] * Jp[1][j]) / denom;
        J[1][j] = (e[2] * Jp[0][j] - e[0] * Jp[2][j]) / denom;
        J[2][j] = (e[0] * Jp[1][j] - e[1] * Jp[0][j]) / denom;
      }
      accumulate<3>(J, r, rows.line_w[o], delta, s);
    } else {
      const long o = (long)b * rows.gw + (g - rows.gp - rows.gl);
      const float* dst = rows.pt_dst + 3 * o;
      point_jacobian(R, q, t, rows.pt_src + 3 * o, Jp, pw);
      float r[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) r[i] = pw[i] - dst[i];
      accumulate<3>(Jp, r, rows.pt_w[o], delta, s);
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    float v = s[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) sh_sum[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    float v = sh_sum[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += sh_sum[w][threadIdx.x];
    partials[((long)b * gridDim.x + blockIdx.x) * kSums + threadIdx.x] = v;
  }
}

// ---- the step ----------------------------------------------------------------

// x = A^-1 y for a 6x6 A (row-major, overwritten), Gaussian elimination with
// partial pivoting (the first largest |pivot|), as getrf/getrs
__device__ void solve6(float (&A)[6][6], float (&y)[6]) {
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    int p = c;
    float best = fabsf(A[c][c]);
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      if (fabsf(A[r][c]) > best) { best = fabsf(A[r][c]); p = r; }
    }
    if (p != c) {
#pragma unroll
      for (int j = 0; j < 6; ++j) { const float tmp = A[c][j]; A[c][j] = A[p][j]; A[p][j] = tmp; }
      const float tmp = y[c]; y[c] = y[p]; y[p] = tmp;
    }
    const float inv = 1.0f / A[c][c];
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      const float f = A[r][c] * inv;
#pragma unroll
      for (int j = c + 1; j < 6; ++j) A[r][j] -= f * A[c][j];
      y[r] -= f * y[c];
    }
  }
#pragma unroll
  for (int c = 5; c >= 0; --c) {
    float acc = y[c];
#pragma unroll
    for (int j = c + 1; j < 6; ++j) acc -= A[c][j] * y[j];
    y[c] = acc / A[c][c];
  }
}

__device__ __forceinline__ bool iterating(const float* st, int rej) {
  return st[kGnorm] > st[kTol] && fabsf(st[kRel]) > kFtol && rej < kMaxReject;
}

__global__ void mapsolve_step_kernel(const float* partials, int blocks, const float* prior_q,
                                     const float* prior_t, const float* sqrt_info, float* state,
                                     float* hfull, int* its, int* rej, bool* active,
                                     bool* converged, bool* any_active, int sessions, int init,
                                     float delta, float lam0, float grad_tol) {
  __shared__ float sh_sum[kMaxSessions][kSums];
  __shared__ double sh_log[kMaxSessions][12][6];
  const int b = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* st = state + (long)b * kStateSize;
  const bool live = b < sessions && (init || active[b]);
  const float* pose_q = live ? eval_q(prior_q, state, init, b) : nullptr;
  const float* pose_t = live ? eval_t(prior_t, state, init, b) : nullptr;
  if (live) {
    if (lane < kSums) {
      float v = 0;
      for (int k = 0; k < blocks; ++k) v += partials[((long)b * blocks + k) * kSums + lane];
      sh_sum[b][lane] = v;
    }
    if (lane < 12) {
      // the prior's central difference: log(prior^-1 o p o exp(+-h e_i)) in float64
      double pq[4], pt[3], cq[4], ct[3], iq[4], it[3], mq[4], mt[3], xi[6] = {0, 0, 0, 0, 0, 0};
#pragma unroll
      for (int i = 0; i < 4; ++i) { pq[i] = pose_q[i]; cq[i] = prior_q[b * 4 + i]; }
#pragma unroll
      for (int i = 0; i < 3; ++i) { pt[i] = pose_t[i]; ct[i] = prior_t[b * 3 + i]; }
      inverse(cq, ct, iq, it);
      xi[lane % 6] = lane < 6 ? kPriorStep : -kPriorStep;
      retract(pq, pt, xi, mq, mt);
      double rq[4], rt[3];
      compose(iq, it, mq, mt, rq, rt);
      se3_log(rq, rt, sh_log[b][lane]);
    }
  }
  __syncwarp();
  if (live && lane == 0) {
    float s[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) s[k] = sh_sum[b][k];
    // the prior block at the evaluated pose: r = sqrt_info * log(prior^-1 o p)
    float pq[4], pt[3], cq[4], ct[3], iq[4], it[3], rq[4], rt[3], xi[6];
#pragma unroll
    for (int i = 0; i < 4; ++i) { pq[i] = pose_q[i]; cq[i] = prior_q[b * 4 + i]; }
#pragma unroll
    for (int i = 0; i < 3; ++i) { pt[i] = pose_t[i]; ct[i] = prior_t[b * 3 + i]; }
    inverse(cq, ct, iq, it);
    compose(iq, it, pq, pt, rq, rt);
    se3_log(rq, rt, xi);
    float r[6], J[6][6];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const float si = sqrt_info[b * 6 + j];
      r[j] = si * xi[j];
#pragma unroll
      for (int i = 0; i < 6; ++i)
        J[j][i] = si * (float)((sh_log[b][i][j] - sh_log[b][6 + i][j]) / (2.0 * kPriorStep));
    }
    accumulate<6>(J, r, 1.0f, delta, s);
    const float cost = 0.5f * s[27];
    const float* H = s;
    const float* g = s + 21;

    bool adopt;
    if (init) {
      st[kQ + 0] = pq[0]; st[kQ + 1] = pq[1]; st[kQ + 2] = pq[2]; st[kQ + 3] = pq[3];
      st[kT + 0] = pt[0]; st[kT + 1] = pt[1]; st[kT + 2] = pt[2];
      st[kCost] = cost;
      st[kCost0] = cost;
      st[kLam] = lam0;
      st[kRel] = __int_as_float(0x7f800000);      // +inf
      st[kGnorm] = __int_as_float(0x7f800000);
      st[kTol] = grad_tol * max_(cost, 1.0f);
      its[b] = 0;
      rej[b] = 0;
      adopt = true;
    } else {
      // the trial: accept or reject the candidate just evaluated
      const float old = st[kCost], lam = st[kLam];
      float gn = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i) gn += st[kB + i] * st[kB + i];
      st[kGnorm] = sqrtf(gn);
      adopt = cost < old;
      if (adopt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) st[kQ + i] = pq[i];
#pragma unroll
        for (int i = 0; i < 3; ++i) st[kT + i] = pt[i];
        st[kCost] = cost;
        st[kLam] = max_(lam * 0.33f, 1e-9f);
        st[kRel] = (old - cost) / max_(old, 1e-12f);
        rej[b] = 0;
      } else {
        st[kLam] = min_(lam * 4.0f, 1e6f);
        st[kRel] = __int_as_float(0x7f800000);
        rej[b] = rej[b] + 1;
      }
      its[b] = its[b] + 1;
    }
    if (adopt) {
#pragma unroll
      for (int k = 0; k < 21; ++k) st[kH + k] = H[k];
#pragma unroll
      for (int i = 0; i < 6; ++i) st[kB + i] = g[i];
      int k = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = i; j < 6; ++j, ++k) {
          hfull[(long)b * 36 + i * 6 + j] = H[k];
          hfull[(long)b * 36 + j * 6 + i] = H[k];
        }
    }
    const bool go = iterating(st, rej[b]);
    active[b] = go;
    converged[b] = st[kGnorm] < st[kTol];
    if (go) {
      // the next candidate from the loop's state
      float A[6][6], y[6], dmax = -__int_as_float(0x7f800000);
      int k = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = i; j < 6; ++j, ++k) { A[i][j] = st[kH + k]; A[j][i] = st[kH + k]; }
#pragma unroll
      for (int i = 0; i < 6; ++i) dmax = max_(dmax, A[i][i]);
      const float floor = 1e-6f * max_(dmax, 1.0f), lam = st[kLam];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        A[i][i] = A[i][i] + (lam * max_(A[i][i], 1e-8f) + floor);
        y[i] = st[kB + i];
      }
      solve6(A, y);
      float dn = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i) { y[i] = -y[i]; dn += y[i] * y[i]; }
      const float clip = min_(1.0f / max_(sqrtf(dn), 1e-12f), 1.0f);
#pragma unroll
      for (int i = 0; i < 6; ++i) y[i] = y[i] * clip;
      retract(st + kQ, st + kT, y, st + kCandQ, st + kCandT);
    }
  } else if (lane == 0 && b < sessions) {
    converged[b] = st[kGnorm] < st[kTol];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bool any = false;
    for (int k = 0; k < sessions; ++k) any = any || active[k];
    *any_active = any;
  }
}

}  // namespace

extern "C" {

// The residual rows' points and weights, each (B, G, .) contiguous float32.
// Launches mapsolve_eval_kernel on `stream` into partials (B, blocks, 28),
// at the prior where `init` is 1, else at the state rows' candidates.
// Returns a cudaError_t.
int isl_mapsolve_eval(const float* plane_p, const float* plane_n, const float* plane_d,
                      const float* plane_w, int gp, const float* line_p, const float* line_a,
                      const float* line_b, const float* line_w, int gl, const float* pt_src,
                      const float* pt_dst, const float* pt_w, int gw, const float* prior_q,
                      const float* prior_t, const float* state, const bool* active, int init,
                      float delta, float* partials, int blocks, int sessions, void* stream) {
  if (blocks < 1 || blocks > kMaxBlocks || sessions < 1 || sessions > kMaxSessions)
    return cudaErrorInvalidValue;
  Rows rows{plane_p, plane_n, plane_d, plane_w, line_p, line_a, line_b, line_w,
            pt_src, pt_dst, pt_w, gp, gl, gw};
  mapsolve_eval_kernel<<<dim3(blocks, sessions), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      rows, prior_q, prior_t, state, active, init, delta, partials);
  return cudaGetLastError();
}

// Launches mapsolve_step_kernel (one block, a warp a session) on `stream`:
// `init` 1 on the first call, 0 after a trial evaluation.  Returns a
// cudaError_t.
int isl_mapsolve_step(const float* partials, int blocks, const float* prior_q,
                      const float* prior_t, const float* sqrt_info, float* state, float* hfull,
                      int* its, int* rej, bool* active, bool* converged, bool* any_active,
                      int sessions, int init, float delta, float lam0, float grad_tol,
                      void* stream) {
  if (sessions < 1 || sessions > kMaxSessions || blocks < 1 || blocks > kMaxBlocks)
    return cudaErrorInvalidValue;
  mapsolve_step_kernel<<<1, 32 * sessions, 0, static_cast<cudaStream_t>(stream)>>>(
      partials, blocks, prior_q, prior_t, sqrt_info, state, hfull, its, rej, active, converged,
      any_active, sessions, init, delta, lam0, grad_tol);
  return cudaGetLastError();
}

int isl_mapsolve_state_size() { return kStateSize; }

const char* isl_mapsolve_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
