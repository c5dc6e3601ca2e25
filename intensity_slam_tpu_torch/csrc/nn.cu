// Brute-force nearest neighbour over a masked target cloud, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_nn_kernel` of intensity_slam_tpu/ops/pallas_nn.py
// (launched by `nearest_neighbor`, pl.pallas_call at :103).  For every source
// point it returns the index and squared distance of the nearest VALID target:
//   - exact per-coordinate differences, dx*dx + dy*dy + dz*dz summed left to
//     right; build with --fmad=false so every product and sum rounds as the
//     plain PyTorch version's separate elementwise ops do, and the two agree
//     bit for bit;
//   - masked targets count as 1e30; a running (min, argmin) over the targets
//     in ascending order with strict `<`, so ties go to the lowest index, as
//     in the TPU kernel (argmin within a tile, strict `<` across tiles);
//   - no valid target: index 0, distance 1e30; distances clamped at >= 0.
//
// Design.  One block owns kSrc source points and kSlices threads per source
// point; slice s visits the targets j = s, s + kSlices, ... of each tile in
// ascending order.  Target tiles of kTile points (xyz + mask as float4, 16 KB)
// are staged through shared memory by the whole block.  The kSlices partial
// (min, argmin) pairs of a source point are then merged by (distance, index)
// order, which keeps the lowest index among equal minima.
//
// Bound on an H100 at the ICP shapes (P = 2048 sources, M = 6144 targets):
// 12.6 M pairs x 8 FP32 operations = 101 MFLOP, about 1.5 us at 67 TFLOP/s;
// the bytes (about 120 KB in and out) take well under 0.1 us at 3.35 TB/s.
// So it is bound by operations, and at this size launch latency dominates.
// kSlices spreads the 2048 points over 128 blocks so most SMs get work.

#include <cuda_runtime.h>

namespace {

constexpr int kSrc = 16;      // source points per block
constexpr int kSlices = 16;   // threads per source point
constexpr int kTile = 1024;   // targets staged per shared-memory tile
constexpr float kBig = 1e30f;

__global__ void __launch_bounds__(kSrc * kSlices)
nn_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
          const unsigned char* __restrict__ mask, int P, int M,
          int* __restrict__ out_idx, float* __restrict__ out_dist) {
  __shared__ float4 tile[kTile];
  __shared__ float part_d[kSlices][kSrc];
  __shared__ int part_i[kSlices][kSrc];

  const int lane = threadIdx.x % kSrc;     // source point within the block
  const int slice = threadIdx.x / kSrc;    // target slice of this thread
  const int p = blockIdx.x * kSrc + lane;
  float sx = 0.f, sy = 0.f, sz = 0.f;
  if (p < P) {
    sx = src[3 * p + 0];
    sy = src[3 * p + 1];
    sz = src[3 * p + 2];
  }
  float best_d = kBig;
  int best_i = 0;
  for (int base = 0; base < M; base += kTile) {
    const int n = min(kTile, M - base);
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const int g = base + j;
      tile[j] = make_float4(tgt[3 * g + 0], tgt[3 * g + 1], tgt[3 * g + 2],
                            mask[g] ? 1.f : 0.f);
    }
    __syncthreads();
    for (int j = slice; j < n; j += kSlices) {
      const float4 t = tile[j];
      const float dx = sx - t.x;
      const float dy = sy - t.y;
      const float dz = sz - t.z;
      float d = dx * dx + dy * dy + dz * dz;
      d = t.w > 0.5f ? d : kBig;
      if (d < best_d) {
        best_d = d;
        best_i = base + j;
      }
    }
    __syncthreads();
  }
  part_d[slice][lane] = best_d;
  part_i[slice][lane] = best_i;
  __syncthreads();
  if (slice == 0 && p < P) {
    float d = part_d[0][lane];
    int i = part_i[0][lane];
    for (int s = 1; s < kSlices; ++s) {
      const float ds = part_d[s][lane];
      const int is = part_i[s][lane];
      // a slice that saw no target smaller than the sentinel still holds
      // index 0, which must not win a tie against a real index
      if (ds < d || (ds == d && ds < kBig && is < i)) {
        d = ds;
        i = is;
      }
    }
    out_idx[p] = i;
    out_dist[p] = fmaxf(d, 0.f);
  }
}

}  // namespace

extern "C" int isl_nn_launch(const void* src, const void* tgt,
                             const void* mask, int P, int M, void* out_idx,
                             void* out_dist, void* stream) {
  const int threads = kSrc * kSlices;
  const int blocks = (P + kSrc - 1) / kSrc;
  nn_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const float*>(tgt),
      static_cast<const unsigned char*>(mask), P, M,
      static_cast<int*>(out_idx), static_cast<float*>(out_dist));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* isl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
