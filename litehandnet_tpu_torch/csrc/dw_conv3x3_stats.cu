// Depthwise 3x3 convolution with its BatchNorm statistics, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel litehandnet_tpu/ops/fused_bn.py::
// dw_conv3x3_stats (:296, _pallas_dw_stats :256, body _dw_stats_kernel :210).
// For x [N, C, H, W] (float32 or bfloat16, any strides) and an OIHW weight
// [C, 1, 3, 3] (float32) it computes the 'SAME' stride-1 depthwise conv with
// dilation d (padding d), y in x's dtype, and the per-channel mean and biased
// variance of the float32 accumulators, so that BatchNorm never reads y back.
//
// Bound: memory. Each input element is read once and each output written
// once, for 9 FMAs per output. Design: a block takes a kTileH x kTileW
// spatial tile of one image and 32 neighbouring channels (one 128-byte line
// of a channels_last float32 row), loads the tile and its +-d halo into
// shared memory (zero outside the image), keeps the channel's 9 taps in
// registers, and writes y. The tile's exact two-pass statistics come from
// the accumulators it still holds in registers; chan_merge.cuh merges the
// tiles by Chan's update in a fixed order, as in moments.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "chan_merge.cuh"

namespace {

constexpr int kLanes = 32;              // channels per block (threadIdx.x)
constexpr int kTileH = 8;               // one output row per threadIdx.y
constexpr int kTileW = 16;              // outputs per thread, along the row
constexpr int kThreads = kLanes * kTileH;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Shared memory of one block: the tile and its halo, 32 channels deep.
long long halo_bytes(int d) {
  return static_cast<long long>(kTileH + 2 * d) * (kTileW + 2 * d) * kLanes *
         static_cast<long long>(sizeof(float));
}

// blockIdx.x = (n * tiles_y + ty) * tiles_x + tx; blockIdx.y picks 32
// channels. Partials are indexed by blockIdx.x.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dw_conv3x3_stats_kernel(const T* __restrict__ x, const float* __restrict__ w,
                        T* __restrict__ y, int C, int H, int W, int d,
                        int tiles_y, int tiles_x, long long xn, long long xc,
                        long long xh, long long xw, long long yn, long long yc,
                        long long yh, long long yw,
                        float* __restrict__ part_count,
                        float* __restrict__ part_mean,
                        float* __restrict__ part_m2) {
  extern __shared__ float s_x[];  // [kTileH + 2d][kTileW + 2d][kLanes]
  __shared__ float s_red[kTileH][kLanes];
  const int lane = threadIdx.x;
  const int row = threadIdx.y;
  const int tid = row * kLanes + lane;
  const long long t = blockIdx.x;
  const int tx = static_cast<int>(t % tiles_x);
  const int ty = static_cast<int>((t / tiles_x) % tiles_y);
  const long long n = t / (static_cast<long long>(tiles_x) * tiles_y);
  const int y0 = ty * kTileH;
  const int x0 = tx * kTileW;
  const int c0 = blockIdx.y * kLanes;
  const int hh = kTileH + 2 * d;
  const int hw = kTileW + 2 * d;

  const T* xb = x + n * xn;
  for (int i = tid; i < hh * hw * kLanes; i += kThreads) {
    const int cl = i % kLanes;
    const int pix = i / kLanes;
    const int gy = y0 + pix / hw - d;
    const int gx = x0 + pix % hw - d;
    const int c = c0 + cl;
    float v = 0.f;
    if (c < C && gy >= 0 && gy < H && gx >= 0 && gx < W) {
      v = to_f32(xb[c * xc + gy * xh + gx * xw]);
    }
    s_x[i] = v;
  }

  const int c = c0 + lane;
  const bool active = c < C;
  float tap[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) tap[k] = active ? w[c * 9 + k] : 0.f;
  __syncthreads();

  const int oy = y0 + row;
  const int valid_w = min(kTileW, W - x0);
  const bool row_ok = active && oy < H;
  float acc[kTileW];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kTileW; ++j) {
    float a = 0.f;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int sy = row + ky * d;
        const int sx = j + kx * d;
        a = fmaf(tap[ky * 3 + kx], s_x[(sy * hw + sx) * kLanes + lane], a);
      }
    }
    acc[j] = a;
    if (row_ok && j < valid_w) {
      store(y + n * yn + c * yc + oy * yh + (x0 + j) * yw, a);
      sum += a;
    }
  }

  const int rows = min(kTileH, H - y0);
  const float count = static_cast<float>(rows * valid_w);
  s_red[row][lane] = sum;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int r = 0; r < kTileH; ++r) total += s_red[r][lane];
  const float mean = total / count;
  __syncthreads();  // every thread has read s_red before it is reused

  float m2 = 0.f;
#pragma unroll
  for (int j = 0; j < kTileW; ++j) {
    const float dv = acc[j] - mean;
    if (row_ok && j < valid_w) m2 = fmaf(dv, dv, m2);
  }
  s_red[row][lane] = m2;
  __syncthreads();
  if (row == 0 && active) {
    float tile_m2 = 0.f;
#pragma unroll
    for (int r = 0; r < kTileH; ++r) tile_m2 += s_red[r][lane];
    part_mean[t * C + c] = mean;
    part_m2[t * C + c] = tile_m2;
  }
  if (tid == 0 && blockIdx.y == 0) part_count[t] = count;
}

template <typename T>
cudaError_t launch(const void* x, const float* w, void* y, int N, int C,
                   int H, int W, int d, const long long* xs,
                   const long long* ys, float* part_count, float* part_mean,
                   float* part_m2, cudaStream_t s) {
  const int tiles_y = (H + kTileH - 1) / kTileH;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const long long smem = halo_bytes(d);
  auto kernel = dw_conv3x3_stats_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(static_cast<long long>(N) * tiles_y *
                                        tiles_x),
                  (C + kLanes - 1) / kLanes);
  const dim3 block(kLanes, kTileH);
  kernel<<<grid, block, static_cast<size_t>(smem), s>>>(
      static_cast<const T*>(x), w, static_cast<T*>(y), C, H, W, d, tiles_y,
      tiles_x, xs[0], xs[1], xs[2], xs[3], ys[0], ys[1], ys[2], ys[3],
      part_count, part_mean, part_m2);
  return cudaGetLastError();
}

}  // namespace

// kernels/dw_conv3x3_stats.py sizes the partial buffers with its own copy of
// kTileH, kTileW and kLanes, and checks that copy against this.
extern "C" long long lhn_dw_smem_bytes(int d) { return halo_bytes(d); }

// x: [N, C, H, W] with element strides xn, xc, xh, xw; y: the same shape in
// x's dtype with strides yn, yc, yh, yw; dtype 0 = float32, 1 = bfloat16;
// w: [C, 1, 3, 3] float32 contiguous. part_count [tiles], part_mean and
// part_m2 [tiles, C] are scratch, tiles = N * ceil(H / kTileH) *
// ceil(W / kTileW). Writes y, mean[C] and var[C]. Launches both passes on
// `stream`; returns the first CUDA error (0 if none).
extern "C" int lhn_dw_conv3x3_stats(
    const void* x, int dtype, const float* w, void* y, int N, int C, int H,
    int W, int d, long long xn, long long xc, long long xh, long long xw,
    long long yn, long long yc, long long yh, long long yw,
    float* part_count, float* part_mean, float* part_m2, float* mean,
    float* var, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long xs[4] = {xn, xc, xh, xw};
  const long long ys[4] = {yn, yc, yh, yw};
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(x, w, y, N, C, H, W, d, xs, ys, part_count, part_mean,
                        part_m2, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(x, w, y, N, C, H, W, d, xs, ys, part_count,
                                part_mean, part_m2, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>(N) *
                          ((H + kTileH - 1) / kTileH) *
                          ((W + kTileW - 1) / kTileW);
  return static_cast<int>(lhn::launch_chan_merge(part_count, part_mean,
                                                 part_m2, tiles, C, mean, var,
                                                 s));
}
