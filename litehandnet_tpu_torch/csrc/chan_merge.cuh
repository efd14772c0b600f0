// Chan's parallel merge of per-tile (count, mean, M2) partials into
// per-channel mean and biased variance, shared by moments.cu and
// dw_conv3x3_stats.cu.
//
// The first pass of each kernel writes, for tile t and channel c,
// part_mean[t * C + c] and part_m2[t * C + c] (the tile's exact two-pass
// statistics) and part_count[t]. This pass merges them in a fixed order, so
// a given input gives the same bits on every run: one block takes
// kMergeLanes channels, thread (lane, group) merges the tiles
// group, group + kMergeGroups, ... in turn, then thread (lane, 0) merges the
// kMergeGroups results in group order.

#pragma once

#include <cuda_runtime.h>

namespace lhn {

constexpr int kMergeLanes = 32;
constexpr int kMergeGroups = 32;

// (n, mean, m2) <- merge with (nb, mean_b, m2b); a tile with no rows is
// skipped. Counts are doubles so that counts above 2^24 stay exact.
__device__ __forceinline__ void chan_merge(double& n, float& mean, float& m2,
                                           double nb, float mean_b,
                                           float m2b) {
  if (nb == 0.0) return;
  const double tot = n + nb;
  const float delta = mean_b - mean;
  mean += delta * static_cast<float>(nb / tot);
  m2 += m2b + delta * delta * static_cast<float>(n * nb / tot);
  n = tot;
}

__global__ void __launch_bounds__(kMergeLanes * kMergeGroups)
chan_merge_kernel(const float* __restrict__ part_count,
                  const float* __restrict__ part_mean,
                  const float* __restrict__ part_m2, long long tiles, int C,
                  float* __restrict__ mean_out, float* __restrict__ var_out) {
  __shared__ double s_n[kMergeGroups][kMergeLanes];
  __shared__ float s_mean[kMergeGroups][kMergeLanes];
  __shared__ float s_m2[kMergeGroups][kMergeLanes];
  const int lane = threadIdx.x;
  const int group = threadIdx.y;
  const int c = blockIdx.x * kMergeLanes + lane;
  double n = 0.0;
  float mean = 0.f, m2 = 0.f;
  if (c < C) {
#pragma unroll 4
    for (long long t = group; t < tiles; t += kMergeGroups) {
      chan_merge(n, mean, m2, part_count[t], part_mean[t * C + c],
                 part_m2[t * C + c]);
    }
  }
  s_n[group][lane] = n;
  s_mean[group][lane] = mean;
  s_m2[group][lane] = m2;
  __syncthreads();
  if (group == 0 && c < C) {
    for (int g = 1; g < kMergeGroups; ++g) {
      chan_merge(n, mean, m2, s_n[g][lane], s_mean[g][lane], s_m2[g][lane]);
    }
    mean_out[c] = mean;
    var_out[c] = static_cast<float>(m2 / n);
  }
}

// Launches the merge on `stream`; returns cudaGetLastError().
inline cudaError_t launch_chan_merge(const float* part_count,
                                     const float* part_mean,
                                     const float* part_m2, long long tiles,
                                     int C, float* mean, float* var,
                                     cudaStream_t stream) {
  const dim3 block(kMergeLanes, kMergeGroups);
  const dim3 grid((C + kMergeLanes - 1) / kMergeLanes);
  chan_merge_kernel<<<grid, block, 0, stream>>>(part_count, part_mean,
                                                part_m2, tiles, C, mean, var);
  return cudaGetLastError();
}

}  // namespace lhn
