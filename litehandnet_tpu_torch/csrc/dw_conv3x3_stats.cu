// Depthwise 3x3 convolution with its BatchNorm statistics, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel litehandnet_tpu/ops/fused_bn.py::
// dw_conv3x3_stats (:296, _pallas_dw_stats :256, body _dw_stats_kernel :210).
// For x [N, C, H, W] (float32 or bfloat16, any strides) and an OIHW weight
// [C, 1, 3, 3] (float32) it computes the 'SAME' stride-1 depthwise conv with
// dilation d (padding d), y in x's dtype (channels_last), and the
// per-channel mean and biased variance of the float32 accumulators, so that
// BatchNorm never reads y back. One launch.
//
// Bound: memory. Each input element is read once and each output written
// once, for 9 FMAs per output; at [32, 64, 64, 64] float32 that is 67.1 MB,
// 20.0 us at 3.35 TB/s.
//
// Design (the launch plan comes from kernels/dw_conv3x3_stats.py::plan):
// - Work items are kTileH x kTileW (16 x 32) output tiles of one image;
//   grid.y is the channel group (kGroup = 16 channels: 64 contiguous bytes
//   of a float32 pixel), grid.x blocks, sized to the SM count, walk the
//   items blockIdx.x, + gridDim.x. With its +-d halo a tile reads
//   (16 + 2d)(32 + 2d) / 512 = 1.33x (d = 1) and 1.41x (d = 2) of its
//   input from L2; HBM sees the halo rows again only where L2 has dropped
//   them.
// - Vector path (channels contiguous, C % (16 / sizeof(T)) == 0, 16-byte
//   aligned): the tile and its halo arrive in shared memory by 16-byte
//   cp.async, with src-size 0 (zero fill) outside the image, into a ring of
//   `stages` buffers (2 where they fit): the next item's copy is in flight
//   while the current one is computed. The copy walks (row, chunk) by adds,
//   with no division per element. Scalar path (NCHW memory and the rest):
//   the same tiles and arithmetic, the tile loaded element by element.
// - Thread (quad q of 4, column of 32, segment of 2): 4 channels of one
//   output column, 8 rows. For d = 1 and 2 it walks the input rows of its
//   segment once and adds each row's 3 taps into the up to 3 outputs that
//   use it, so an output costs 3 shared-memory reads (4 channels each)
//   instead of 9; other dilations read the 9 taps of each output. The accumulation order per
//   output is that of the 9-tap loop either way (ky, then kx).
// - y leaves as one 16-byte store per float32 output (8 bytes for bfloat16).
// - A thread folds the exact two-pass statistics of its 8 outputs into its
//   running (count, mean, M2) by Chan's update; the block tree and the
//   single-launch, fixed-order merge across blocks are stats_merge.cuh's,
//   as in moments.cu.
//
// Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700 W; float32,
// channels_last, B = 32, device time per call, bound in brackets):
//   [32,64,64,64] d=1 35.1 us, d=2 35.5 us (20.0); [32,32,64,64] d=1
//   18.6 us (10.0); [32,64,32,32] d=1 11.9 us, d=2 12.5 us (5.0);
//   [32,32,32,32] d=1 9.9 us (2.5). At 64^2 it streams at 1.9 TB/s: the
//   first item's copy of each block is exposed, and the halo is read again.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "stats_merge.cuh"

namespace {

constexpr int kTileH = 16;         // output rows of an item
constexpr int kTileW = 32;         // output columns of an item
constexpr int kSegRows = 8;        // output rows per thread
constexpr int kQuads = 4;          // 4-channel quads per group
constexpr int kGroup = 4 * kQuads; // channels per group
constexpr int kMaxBlockSmem = 232448;  // 227 KB, Hopper
constexpr int kMaxDevices = 64;
static_assert(kQuads * kTileW * (kTileH / kSegRows) == lhn::kThreads,
              "one thread per (quad, column, segment)");

struct Geometry {
  int N, C, H, W, d;
  int tiles_x, tiles_y, items;  // items = N * tiles_y * tiles_x
  long long xn, xc, xh, xw;     // element strides of x
  long long yn, yc, yh, yw;     // element strides of y
  int stage_bytes;              // one ring buffer: the tile and its halo
  int stages;                   // 1 or 2
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 4 channels of one pixel from shared memory.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(r.x << 16);
  v[1] = __uint_as_float(r.x & 0xffff0000u);
  v[2] = __uint_as_float(r.y << 16);
  v[3] = __uint_as_float(r.y & 0xffff0000u);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 r;
  r.x = *reinterpret_cast<const uint32_t*>(&lo);
  r.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = r;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

struct Item {
  long long n;
  int y0, x0;  // first output row and column
};

__device__ __forceinline__ Item item_of(const Geometry& g, int item) {
  const int per_image = g.tiles_x * g.tiles_y;
  const int n = item / per_image;
  const int rem = item - n * per_image;
  const int ty = rem / g.tiles_x;
  return {n, ty * kTileH, (rem - ty * g.tiles_x) * kTileW};
}

// Brings item `it`'s input tile and halo, channels c0 .. c0 + kGroup, into
// the shared buffer `buf` as [kTileH + 2d][kTileW + 2d][kGroup] of T, zero
// outside the image and at channels >= C.
template <typename T, bool kVec>
__device__ __forceinline__ void issue(const T* __restrict__ x,
                                      const Geometry& g, int it, int c0,
                                      T* buf) {
  const Item at = item_of(g, it);
  const int rows = kTileH + 2 * g.d;
  const int side = kTileW + 2 * g.d;
  const T* xb = x + at.n * g.xn;
  if (kVec) {
    constexpr int kChunk = 16 / sizeof(T);             // elements per copy
    constexpr int kPerPixel = kGroup / kChunk;         // copies per pixel
    const int per_row = side * kPerPixel;
    // thread t copies chunk t, t + 256, ...; (r, j) advance by adds
    int r = threadIdx.x / per_row;
    int j = threadIdx.x - r * per_row;
    const int dr = lhn::kThreads / per_row;
    const int dj = lhn::kThreads - dr * per_row;
    for (; r < rows;) {
      const int col = j / kPerPixel;  // kPerPixel is 2 or 4: a shift
      const int c = c0 + (j - col * kPerPixel) * kChunk;
      const int gy = at.y0 + r - g.d;
      const int gx = at.x0 + col - g.d;
      const bool valid = gy >= 0 && gy < g.H && gx >= 0 && gx < g.W && c < g.C;
      const T* src = valid ? xb + gy * g.xh + gx * g.xw + c : x;
      cp_async16(buf + (r * side + col) * kGroup + (c - c0), src, valid);
      r += dr;
      j += dj;
      if (j >= per_row) {
        j -= per_row;
        ++r;
      }
    }
  } else {
    const int count = rows * side * kGroup;
    for (int i = threadIdx.x; i < count; i += lhn::kThreads) {
      const int col = i % side;  // neighbouring threads on neighbouring x
      const int rest = i / side;
      const int r = rest % rows;
      const int ch = rest / rows;
      const int gy = at.y0 + r - g.d;
      const int gx = at.x0 + col - g.d;
      const int c = c0 + ch;
      float v = 0.f;
      if (gy >= 0 && gy < g.H && gx >= 0 && gx < g.W && c < g.C) {
        v = to_f32(xb[c * g.xc + gy * g.xh + gx * g.xw]);
      }
      store1(buf + (r * side + col) * kGroup + ch, v);
    }
  }
}

// acc[m][e] of output row seg*8 + m, 4 channels, from the tile in `buf`.
// kD > 0: compile-time dilation, each input row read once and added into
// the outputs that use it; kD == 0: runtime dilation, 9 reads per output.
template <int kD, typename T>
__device__ __forceinline__ void convolve(const T* buf, int side, int d,
                                         int seg, int col, int q,
                                         const float (&tap)[9][4],
                                         float (&acc)[kSegRows][4]) {
#pragma unroll
  for (int m = 0; m < kSegRows; ++m) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] = 0.f;
  }
  const T* base = buf + (seg * kSegRows * side + col) * kGroup + q * 4;
  if (kD > 0) {
#pragma unroll
    for (int s = 0; s < kSegRows + 2 * kD; ++s) {
      float v[3][4];
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        load4(base + (s * side + kx * kD) * kGroup, v[kx]);
      }
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const int m = s - ky * kD;
        if (m < 0 || m >= kSegRows) continue;
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[m][e] = __fmaf_rn(tap[ky * 3 + kx][e], v[kx][e], acc[m][e]);
          }
        }
      }
    }
  } else {
#pragma unroll
    for (int m = 0; m < kSegRows; ++m) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          float v[4];
          load4(base + ((m + ky * d) * side + kx * d) * kGroup, v);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[m][e] = __fmaf_rn(tap[ky * 3 + kx][e], v[e], acc[m][e]);
          }
        }
      }
    }
  }
}

template <typename T, bool kVec, int kD>
__global__ void __launch_bounds__(lhn::kThreads, 2)
dw_kernel(const T* __restrict__ x, const float* __restrict__ w,
          T* __restrict__ y, Geometry g, lhn::Partials parts,
          float* __restrict__ mean_out, float* __restrict__ var_out) {
  extern __shared__ __align__(16) unsigned char s_ring[];
  __shared__ lhn::MergeSmem<4> sm;
  const int q = threadIdx.x % kQuads;
  const int col = (threadIdx.x / kQuads) % kTileW;
  const int seg = threadIdx.x / (kQuads * kTileW);
  const int group = blockIdx.y;
  const int c0 = group * kGroup;
  const int c = c0 + q * 4;  // this thread's first channel
  const int d = kD > 0 ? kD : g.d;
  const int side = kTileW + 2 * d;

  float tap[9][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      tap[k][e] = c + e < g.C ? w[(c + e) * 9 + k] : 0.f;
    }
  }

  lhn::Stats<4> s;
  lhn::zero(s);
  auto buffer = [&](int i) {
    return reinterpret_cast<T*>(s_ring + i * g.stage_bytes);
  };
  int item = blockIdx.x;
  if (item < g.items) issue<T, kVec>(x, g, item, c0, buffer(0));
  cp_async_commit();
  for (int it = 0; item < g.items; item += gridDim.x, ++it) {
    const int next = item + gridDim.x;
    int cur = 0;
    if (g.stages == 2) {
      cur = it & 1;
      if (next < g.items) issue<T, kVec>(x, g, next, c0, buffer(cur ^ 1));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const Item at = item_of(g, item);
    float acc[kSegRows][4];
    convolve<kD>(buffer(cur), side, d, seg, col, q, tap, acc);
    const int ox = at.x0 + col;
    const int oy0 = at.y0 + seg * kSegRows;
    const int rows = ox < g.W ? min(kSegRows, max(0, g.H - oy0)) : 0;
    T* yb = y + at.n * g.yn + ox * g.yw;
#pragma unroll
    for (int m = 0; m < kSegRows; ++m) {
      if (m >= rows) continue;
      T* p = yb + (oy0 + m) * g.yh;
      if (kVec) {
        if (c < g.C) store4(p + c, acc[m]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (c + e < g.C) store1(p + (c + e) * g.yc, acc[m][e]);
        }
      }
    }
    lhn::fold_values(s, acc, rows);
    __syncthreads();  // every thread is done with buffer(cur)
    if (g.stages == 1 && next < g.items) {
      issue<T, kVec>(x, g, next, c0, buffer(0));
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

  // slots are the 64 (column, segment) pairs; lanes the four quads
  lhn::block_merge(s, q, threadIdx.x / kQuads, kQuads,
                   lhn::kThreads / kQuads, sm);
  lhn::finish(s, q, threadIdx.x / kQuads, kQuads, lhn::kThreads / kQuads,
              group, blockIdx.x, gridDim.x, kGroup, c0, g.C, parts, sm,
              mean_out, var_out);
}

template <typename T, bool kVec, int kD>
cudaError_t launch_one(const void* x, const float* w, void* y,
                       const Geometry& g, int grid_x, int groups,
                       const lhn::Partials& parts, float* mean, float* var,
                       cudaStream_t s) {
  auto kernel = dw_kernel<T, kVec, kD>;
  // once per device and instantiation: allow all the dynamic shared memory
  // the block's 227 KB leave beside its static part
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    cudaFuncAttributes a;
    err = cudaFuncGetAttributes(&a, kernel);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxBlockSmem - static_cast<int>(a.sharedSizeBytes));
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  const dim3 grid(static_cast<unsigned>(grid_x), static_cast<unsigned>(groups));
  const size_t smem = static_cast<size_t>(g.stages) * g.stage_bytes;
  kernel<<<grid, lhn::kThreads, smem, s>>>(
      static_cast<const T*>(x), w, static_cast<T*>(y), g, parts, mean, var);
  return cudaGetLastError();
}

template <typename T, bool kVec>
cudaError_t launch(const void* x, const float* w, void* y, const Geometry& g,
                   int grid_x, int groups, const lhn::Partials& parts,
                   float* mean, float* var, cudaStream_t s) {
  switch (g.d) {
    case 1:
      return launch_one<T, kVec, 1>(x, w, y, g, grid_x, groups, parts, mean,
                                    var, s);
    case 2:
      return launch_one<T, kVec, 2>(x, w, y, g, grid_x, groups, parts, mean,
                                    var, s);
    default:
      return launch_one<T, kVec, 0>(x, w, y, g, grid_x, groups, parts, mean,
                                    var, s);
  }
}

}  // namespace

// Bytes of one ring buffer at dilation d for elements of `elem_bytes`;
// kernels/dw_conv3x3_stats.py checks its plan against it.
extern "C" int lhn_dw_stage_bytes(int d, int elem_bytes) {
  return (kTileH + 2 * d) * (kTileW + 2 * d) * kGroup * elem_bytes;
}

// The launch plan of kernels/dw_conv3x3_stats.py::plan, one int64 each, in
// this order (kernels/dw_conv3x3_stats.py PLAN_FIELDS).
enum Plan {
  kDtype, kVector, kN, kC, kH, kW, kD, kXn, kXc, kXh, kXw, kYn, kYc, kYh, kYw,
  kGridX, kGroups, kStages, kStageBytes, kOffN, kOffMean, kOffM2, kPlanFields
};

extern "C" int lhn_dw_plan_fields() { return kPlanFields; }

// x: [N, C, H, W] with element strides xn, xc, xh, xw; y: the same shape in
// x's dtype with strides yn, yc, yh, yw; dtype 0 = float32, 1 = bfloat16;
// w: [C, 1, 3, 3] float32 contiguous. vector 1 takes the cp.async path
// (xc == yc == 1, the other strides and C multiples of 16 / sizeof(T), x
// and y 16-byte aligned), 0 the scalar path; grid (grid_x, groups =
// ceil(C / 8)); `stages` ring buffers of stage_bytes. scratch: tickets
// [groups] (zero) at 0, part_n [groups * grid_x] doubles, part_mean and
// part_m2 [groups * grid_x * 8] floats at the plan's offsets. stats: mean
// [C] then var [C]. Writes y and stats. One launch on `stream`; returns its
// CUDA error (0 if none).
extern "C" int lhn_dw_conv3x3_stats(const void* x, const float* w, void* y,
                                    const long long* plan, void* scratch,
                                    float* stats, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dtype = static_cast<int>(plan[kDtype]);
  const int C = static_cast<int>(plan[kC]);
  const int H = static_cast<int>(plan[kH]);
  const int W = static_cast<int>(plan[kW]);
  const int N = static_cast<int>(plan[kN]);
  const int d = static_cast<int>(plan[kD]);
  const int grid_x = static_cast<int>(plan[kGridX]);
  const int groups = static_cast<int>(plan[kGroups]);
  const int stages = static_cast<int>(plan[kStages]);
  const int stage_bytes = static_cast<int>(plan[kStageBytes]);
  const int elem = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) || d < 1 || grid_x < 1 ||
      groups != (C + kGroup - 1) / kGroup || (stages != 1 && stages != 2) ||
      stage_bytes < lhn_dw_stage_bytes(d, elem) || stage_bytes % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tiles_y = (H + kTileH - 1) / kTileH;
  const Geometry g{N, C, H, W, d, tiles_x, tiles_y, N * tiles_y * tiles_x,
                   plan[kXn], plan[kXc], plan[kXh], plan[kXw], plan[kYn],
                   plan[kYc], plan[kYh], plan[kYw], stage_bytes, stages};
  char* base = static_cast<char*>(scratch);
  const lhn::Partials parts{reinterpret_cast<unsigned*>(base),
                            reinterpret_cast<double*>(base + plan[kOffN]),
                            reinterpret_cast<float*>(base + plan[kOffMean]),
                            reinterpret_cast<float*>(base + plan[kOffM2])};
  float* mean = stats;
  float* var = stats + C;
  const bool vec = plan[kVector] != 0;
  cudaError_t err;
  if (dtype == 0) {
    err = vec ? launch<float, true>(x, w, y, g, grid_x, groups, parts, mean,
                                    var, s)
              : launch<float, false>(x, w, y, g, grid_x, groups, parts, mean,
                                     var, s);
  } else {
    err = vec ? launch<__nv_bfloat16, true>(x, w, y, g, grid_x, groups, parts,
                                            mean, var, s)
              : launch<__nv_bfloat16, false>(x, w, y, g, grid_x, groups,
                                             parts, mean, var, s);
  }
  return static_cast<int>(err);
}
