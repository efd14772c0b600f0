// SoftPool (exp-weighted average pooling) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel litehandnet_tpu/ops/pallas_kernels.py::
// softpool_2x2 (:62, body _softpool_kernel :48). For an [B, C, H, W] tensor
// (float32 or bfloat16, any strides) and each VALID k x k window with stride
// s it writes
//   sum(exp(x) * x) / sum(exp(x))
// with the exp unshifted, as the JAX function does: a window holding a value
// above ~88.7 gives inf / inf = NaN, and one whose values all lie below
// ~-104 gives 0 / 0 = NaN, in the same places as JAX. The 2 x 2 stride-2
// window is the TPU kernel's; other k and s are JAX soft_pool's
// (models/attention.py:23-35, odd sizes floor).
//
// Numerics: both sums in float32 in row-major window order, one IEEE divide,
// one rounding to the output type; bfloat16 input is widened, not computed
// in bfloat16 as the TPU kernel does.
//
// Bound: memory. Each input element is read once (k = s) and each output
// written once, for about 4 FP32 operations and one exp per input element.
// Design: one thread per output element, its window read straight from
// device memory. For channels_last memory neighbouring threads take
// neighbouring channels of one output pixel, so every window tap and every
// store is one coalesced line per warp; for other strides neighbouring
// threads take neighbouring output columns. Index arithmetic is 32-bit
// unless the output has about 2^31 elements or more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 32;  // 32 blocks per SM, grid-stride

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// I is the index type (int or long long); the output has `total` elements.
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
softpool_kernel(const T* __restrict__ x, T* __restrict__ y, I total, int C,
                int Ho, int Wo, int k, int s, int channels_fastest,
                long long xb, long long xc, long long xh, long long xw,
                long long yb, long long yc, long long yh, long long yw) {
  const I step = static_cast<I>(gridDim.x) * kThreads;
  for (I i = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x; i < total;
       i += step) {
    I r = i;
    I b, c, ho, wo;
    if (channels_fastest) {
      c = r % C;  r /= C;
      wo = r % Wo; r /= Wo;
      ho = r % Ho; b = r / Ho;
    } else {
      wo = r % Wo; r /= Wo;
      ho = r % Ho; r /= Ho;
      c = r % C;  b = r / C;
    }
    const T* xp = x + b * xb + c * xc + ho * s * xh + wo * s * xw;
    float num = 0.f;
    float den = 0.f;
    for (int dy = 0; dy < k; ++dy) {
      for (int dx = 0; dx < k; ++dx) {
        const float v = to_f32(xp[dy * xh + dx * xw]);
        const float e = expf(v);
        num += e * v;
        den += e;
      }
    }
    y[b * yb + c * yc + ho * yh + wo * yw] = from_f32<T>(num / den);
  }
}

template <typename T>
int launch(const void* x, void* y, int B, int C, int H, int W, int k, int s,
           int channels_fastest, long long xb, long long xc, long long xh,
           long long xw, long long yb, long long yc, long long yh,
           long long yw, cudaStream_t stream) {
  const int Ho = (H - k) / s + 1;
  const int Wo = (W - k) / s + 1;
  const long long total = static_cast<long long>(B) * C * Ho * Wo;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  // 32-bit indices while the grid-stride loop's last step stays below 2^31
  if (total + blocks * kThreads < (1LL << 31)) {
    softpool_kernel<T, int><<<static_cast<unsigned>(blocks), kThreads, 0,
                              stream>>>(
        xt, yt, static_cast<int>(total), C, Ho, Wo, k, s, channels_fastest,
        xb, xc, xh, xw, yb, yc, yh, yw);
  } else {
    softpool_kernel<T, long long><<<static_cast<unsigned>(blocks), kThreads,
                                    0, stream>>>(
        xt, yt, total, C, Ho, Wo, k, s, channels_fastest, xb, xc, xh, xw, yb,
        yc, yh, yw);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [B, C, H, W] with element strides xb, xc, xh, xw; y: [B, C, Ho, Wo],
// Ho = (H - k) / s + 1, Wo = (W - k) / s + 1, with strides yb, yc, yh, yw;
// the caller checks k <= H, k <= W, k >= 1 and s >= 1. dtype 0 = float32,
// 1 = bfloat16 (x and y alike). channels_fastest picks the thread order:
// channels innermost (channels_last memory) or output columns innermost.
// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int lhn_softpool(const void* x, void* y, int dtype, int B, int C,
                            int H, int W, int k, int s, int channels_fastest,
                            long long xb, long long xc, long long xh,
                            long long xw, long long yb, long long yc,
                            long long yh, long long yw, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(x, y, B, C, H, W, k, s, channels_fastest, xb, xc, xh,
                         xw, yb, yc, yh, yw, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, y, B, C, H, W, k, s, channels_fastest, xb,
                                 xc, xh, xw, yb, yc, yh, yw, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
