// Per-channel batch statistics for BatchNorm, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel litehandnet_tpu/ops/fused_bn.py::moments
// (:129, _pallas_moments :82, body _moments_kernel :53). For an [N, C, H, W]
// tensor (float32 or bfloat16, any strides) it gives, per channel, the mean
// and the biased variance over N, H and W in float32.
//
// Numerics: never E[x^2] - E[x]^2, which cancels at |mean| >> std. Each
// block holds a tile of kTileRows rows x 32 channels in registers and takes
// the tile's exact two-pass mean and M2 = sum((x - mean)^2); a second kernel
// (chan_merge.cuh) merges the tiles by Chan's parallel update in a fixed
// order.
//
// Bound: memory. Each element is read once (4 or 2 bytes) for about 4 FP32
// operations. Design: row (n, h, w) offsets are computed once per tile into
// shared memory, so the loads need no division; a warp reads 32 neighbouring
// channels of one row, which is one 128-byte line for a channels_last float32
// tensor, and each thread keeps kRowsPerThread independent loads in flight.
// Other strides (an NCHW-contiguous tensor) are read correctly but
// uncoalesced. The partials are 2 floats per (tile, channel), under 2% of the
// input at C = 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "chan_merge.cuh"

namespace {

constexpr int kLanes = 32;          // channels per block (threadIdx.x)
constexpr int kGroups = 8;          // row groups per block (threadIdx.y)
constexpr int kRowsPerThread = 16;
constexpr int kTileRows = kGroups * kRowsPerThread;  // 128

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Tile t = blockIdx.x covers rows [t * kTileRows, ...) of the M = N*H*W rows;
// blockIdx.y picks 32 channels.
template <typename T>
__global__ void __launch_bounds__(kLanes * kGroups)
moments_tiles_kernel(const T* __restrict__ x, long long M, int C, int H, int W,
                     long long sn, long long sc, long long sh, long long sw,
                     float* __restrict__ part_count,
                     float* __restrict__ part_mean,
                     float* __restrict__ part_m2) {
  __shared__ long long s_off[kTileRows];
  __shared__ float s_red[kGroups][kLanes];
  const int lane = threadIdx.x;
  const int group = threadIdx.y;
  const int tid = group * kLanes + lane;
  const long long t = blockIdx.x;
  const long long row0 = t * kTileRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kTileRows),
                                        M - row0));
  const long long HW = static_cast<long long>(H) * W;
  for (int r = tid; r < rows; r += kLanes * kGroups) {
    const long long m = row0 + r;
    const long long n = m / HW;
    const long long rem = m - n * HW;
    const long long h = rem / W;
    const long long w = rem - h * W;
    s_off[r] = n * sn + h * sh + w * sw;
  }
  __syncthreads();

  const int c = blockIdx.y * kLanes + lane;
  const bool active = c < C;
  const long long coff = active ? c * sc : 0;
  float v[kRowsPerThread];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int r = group + k * kGroups;
    v[k] = (active && r < rows) ? to_f32(x[s_off[r] + coff]) : 0.f;
    sum += v[k];
  }
  s_red[group][lane] = sum;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) total += s_red[g][lane];
  const float mean = total / static_cast<float>(rows);
  __syncthreads();  // every thread has read s_red before it is reused

  float m2 = 0.f;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int r = group + k * kGroups;
    const float d = v[k] - mean;
    if (r < rows) m2 = fmaf(d, d, m2);
  }
  s_red[group][lane] = m2;
  __syncthreads();
  if (group == 0 && active) {
    float tile_m2 = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) tile_m2 += s_red[g][lane];
    part_mean[t * C + c] = mean;
    part_m2[t * C + c] = tile_m2;
  }
  if (tid == 0 && blockIdx.y == 0) part_count[t] = static_cast<float>(rows);
}

}  // namespace

// Rows per tile; kernels/moments.py sizes the partial buffers with it.
extern "C" int lhn_moments_tile_rows() { return kTileRows; }

// x: [N, C, H, W] with element strides sn, sc, sh, sw; dtype 0 = float32,
// 1 = bfloat16. part_count [tiles], part_mean and part_m2 [tiles, C] are
// scratch, tiles = ceil(N*H*W / kTileRows). Writes mean[C] and var[C].
// Launches both passes on `stream`; returns the first CUDA error (0 if none).
extern "C" int lhn_moments(const void* x, int dtype, int N, int C, int H,
                           int W, long long sn, long long sc, long long sh,
                           long long sw, float* part_count, float* part_mean,
                           float* part_m2, float* mean, float* var,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = static_cast<long long>(N) * H * W;
  const long long tiles = (M + kTileRows - 1) / kTileRows;
  const dim3 block(kLanes, kGroups);
  const dim3 grid(static_cast<unsigned>(tiles), (C + kLanes - 1) / kLanes);
  if (dtype == 0) {
    moments_tiles_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), M, C, H, W, sn, sc, sh, sw, part_count,
        part_mean, part_m2);
  } else if (dtype == 1) {
    moments_tiles_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), M, C, H, W, sn, sc, sh, sw,
        part_count, part_mean, part_m2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(lhn::launch_chan_merge(part_count, part_mean,
                                                 part_m2, tiles, C, mean, var,
                                                 s));
}
