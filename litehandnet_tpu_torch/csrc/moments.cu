// Per-channel batch statistics for BatchNorm, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel litehandnet_tpu/ops/fused_bn.py::moments
// (:129, _pallas_moments :82, body _moments_kernel :53). For an [N, C, H, W]
// tensor (float32 or bfloat16, any strides) it gives, per channel, the mean
// and the biased variance over the M = N*H*W rows, in float32, in ONE
// launch.
//
// Bound: memory. Each element is read once for about 4 FP32 operations; at
// [32, 128, 64, 64] float32 that is 67.1 MB, 20.0 us at 3.35 TB/s. Most of
// the train step's sites are small (28 of LiteHandNet's 33 read <= 4.2 MB),
// where latency and launches cost more than bytes.
//
// Design (the launch plan comes from kernels/moments.py::plan):
// - A thread owns V = 16 / sizeof(T) channels ("lane": 4 float32 or 8
//   bfloat16) and one of `slots` row slots; lanes * slots = 256. A tile is
//   slots * kRowsPerThread rows; at step k the slots read consecutive rows,
//   so a warp reads whole rows (a float32 row of 128 channels is 512 B).
// - Vector path (rows at a uniform stride that is a multiple of V, channels
//   contiguous, 16-byte aligned: channels_last): one 16-byte load per row and
//   thread, kRowsPerThread of them in flight, no integer division. Scalar
//   path (NCHW memory, C % V != 0, unaligned): the same partition and the same
//   arithmetic with one load per element, so the bits are the same.
// - grid.x blocks, sized by the plan to the SM count (about one per SM, no
//   more than the tiles), walk tiles blockIdx.x, + gridDim.x, ...; grid.y
//   covers channel groups of 32 lanes.
// - A thread takes the exact two-pass mean and M2 of its kRowsPerThread
//   values of a tile in registers and folds them into its running
//   (count, mean, M2) by Chan's update; the block merges its slots by a fixed
//   tree, and the last block of each channel group merges the blocks'
//   partials in a fixed order (stats_merge.cuh). Never E[x^2] - E[x]^2.
//
// Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700 W; float32,
// channels_last, B = 32, device time per call, bound in brackets):
//   [32,128,64,64] 33.3 us (20.0), [32,128,32,32] 12.7 us (5.0),
//   [32,128,16,16] 10.3 us (1.3), [32,128,8,8] 7.1 us, [32,128,1,1] 5.6 us.
// The sites up to 16^2 are latency-bound: a launch, then the load, the
// partial, the ticket, the partials and the result in turn.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "stats_merge.cuh"

namespace {

constexpr int kRowsPerThread = 8;

// V floats from 16 bytes of T.
__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[4]) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct Shape {
  long long M;       // rows N*H*W
  int C, H, W;
  long long sn, sc, sh, sw;  // element strides
  long long row;     // vector path: element stride between rows
};

// Rows first, first + slots, ... below M: how many of kRowsPerThread.
__device__ __forceinline__ int rows_in(long long M, long long first,
                                       int slots) {
  const long long left = M - first;
  if (left <= 0) return 0;
  return static_cast<int>(min(static_cast<long long>(kRowsPerThread),
                              (left + slots - 1) / slots));
}

// Vector path: 16 bytes of each of the thread's rows of `tile`, zero where
// the row is past M or the lane past C.
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ x,
                                          const Shape& sh, long long tile,
                                          long long tile_rows, int slot,
                                          int slots, int c0, bool active,
                                          uint4 (&raw)[kRowsPerThread]) {
  const long long first = tile * tile_rows + slot;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const long long m = first + static_cast<long long>(k) * slots;
    raw[k] = (active && m < sh.M)
                 ? __ldg(reinterpret_cast<const uint4*>(x + m * sh.row + c0))
                 : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(lhn::kThreads, 2)
moments_kernel(const T* __restrict__ x, Shape sh, int lanes_log2,
               long long tiles, lhn::Partials parts,
               float* __restrict__ mean_out, float* __restrict__ var_out) {
  constexpr int V = 16 / sizeof(T);
  __shared__ lhn::MergeSmem<V> sm;
  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x & (lanes - 1);
  const int slot = threadIdx.x >> lanes_log2;
  const int slots = lhn::kThreads >> lanes_log2;
  const int c0 = (blockIdx.y * lanes + lane) * V;  // this thread's channels
  const bool active = c0 < sh.C;
  const long long tile_rows = static_cast<long long>(slots) * kRowsPerThread;
  const long long HW = static_cast<long long>(sh.H) * sh.W;

  lhn::Stats<V> s;
  lhn::zero(s);
  float v[kRowsPerThread][V];
  if (kVec) {
    // the next tile's loads are in flight while this one is folded
    uint4 raw[kRowsPerThread];
    load_rows(x, sh, blockIdx.x, tile_rows, slot, slots, c0, active, raw);
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) unpack(raw[k], v[k]);
      if (tile + gridDim.x < tiles) {
        load_rows(x, sh, tile + gridDim.x, tile_rows, slot, slots, c0, active,
                  raw);
      }
      lhn::fold_values(s, v, rows_in(sh.M, tile * tile_rows + slot, slots));
    }
  } else {
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const long long first = tile * tile_rows + slot;
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) {
        const long long m = first + static_cast<long long>(k) * slots;
        const long long n = m / HW;
        const long long rem = m - n * HW;
        const long long h = rem / sh.W;
        const long long off = n * sh.sn + h * sh.sh + (rem - h * sh.W) * sh.sw;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          v[k][e] = (m < sh.M && c0 + e < sh.C)
                        ? to_f32(x[off + (c0 + e) * sh.sc]) : 0.f;
        }
      }
      lhn::fold_values(s, v, rows_in(sh.M, first, slots));
    }
  }
  lhn::block_merge(s, lane, slot, lanes, slots, sm);
  lhn::finish(s, lane, slot, lanes, slots, blockIdx.y, blockIdx.x, gridDim.x,
              lanes * V, blockIdx.y * lanes * V, sh.C, parts, sm, mean_out,
              var_out);
}

template <typename T, bool kVec>
cudaError_t launch(const void* x, const Shape& sh, int lanes_log2,
                   long long tiles, int grid_x, int groups,
                   const lhn::Partials& parts, float* mean, float* var,
                   cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(grid_x), static_cast<unsigned>(groups));
  moments_kernel<T, kVec><<<grid, lhn::kThreads, 0, s>>>(
      static_cast<const T*>(x), sh, lanes_log2, tiles, parts, mean, var);
  return cudaGetLastError();
}

}  // namespace

// Rows each thread reads per tile; kernels/moments.py checks its copy.
extern "C" int lhn_moments_rows_per_thread() { return kRowsPerThread; }

// The launch plan of kernels/moments.py::plan, one int64 each, in this
// order (kernels/moments.py PLAN_FIELDS).
enum Plan {
  kDtype, kN, kC, kH, kW, kSn, kSc, kSh, kSw, kRowStride, kLanesLog2, kTiles,
  kGridX, kGroups, kOffN, kOffMean, kOffM2, kPlanFields
};

extern "C" int lhn_moments_plan_fields() { return kPlanFields; }

// x: [N, C, H, W] with element strides sn, sc, sh, sw; dtype 0 = float32,
// 1 = bfloat16. row_stride > 0 takes the vector path (row m at
// x + m * row_stride, channels contiguous, 16-byte aligned), 0 the scalar
// path; lanes = 2^lanes_log2 channel vectors per group, grid (grid_x,
// groups), `tiles` row tiles of (256 / lanes) * rows_per_thread rows.
// scratch: tickets [groups] (zero) at 0, part_n [groups * grid_x] doubles,
// part_mean and part_m2 [groups * grid_x * lanes * V] floats at the plan's
// offsets. stats: mean [C] then var [C]. One launch on `stream`; returns its
// CUDA error (0 if none).
extern "C" int lhn_moments(const void* x, const long long* plan,
                           void* scratch, float* stats, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int lanes_log2 = static_cast<int>(plan[kLanesLog2]);
  const int grid_x = static_cast<int>(plan[kGridX]);
  const int groups = static_cast<int>(plan[kGroups]);
  if (lanes_log2 < 0 || lanes_log2 > 5 || grid_x < 1 || groups < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int C = static_cast<int>(plan[kC]);
  const int H = static_cast<int>(plan[kH]);
  const int W = static_cast<int>(plan[kW]);
  const Shape shape{plan[kN] * H * W, C, H, W, plan[kSn], plan[kSc],
                    plan[kSh], plan[kSw], plan[kRowStride]};
  char* base = static_cast<char*>(scratch);
  const lhn::Partials parts{reinterpret_cast<unsigned*>(base),
                            reinterpret_cast<double*>(base + plan[kOffN]),
                            reinterpret_cast<float*>(base + plan[kOffMean]),
                            reinterpret_cast<float*>(base + plan[kOffM2])};
  const long long tiles = plan[kTiles];
  float* mean = stats;
  float* var = stats + C;
  const bool vec = shape.row > 0;
  cudaError_t err;
  if (plan[kDtype] == 0) {
    err = vec ? launch<float, true>(x, shape, lanes_log2, tiles, grid_x,
                                    groups, parts, mean, var, s)
              : launch<float, false>(x, shape, lanes_log2, tiles, grid_x,
                                     groups, parts, mean, var, s);
  } else if (plan[kDtype] == 1) {
    err = vec ? launch<__nv_bfloat16, true>(x, shape, lanes_log2, tiles,
                                            grid_x, groups, parts, mean, var,
                                            s)
              : launch<__nv_bfloat16, false>(x, shape, lanes_log2, tiles,
                                             grid_x, groups, parts, mean,
                                             var, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
