// DARK modulation of heatmaps for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel litehandnet_tpu/ops/pallas_kernels.py::
// blur_log (:106, body _blur_log_kernel :82). For each (b, k) map of a
// [B, H, W, K] float32 tensor:
//   1. blur with the separable cv2 Gaussian (taps given), zero border;
//   2. rescale so the map's max equals its pre-blur max, the blurred max
//      floored at 1e-20;
//   3. log(max(., 1e-10)).
//
// Bound: memory. Each pixel is read once and written once (8 bytes) for
// about 2 * 2 * ksize + 4 FP32 operations (48 at ksize 11), far below the
// card's ~20 FLOP/byte ridge for FP32. Design: one thread block per map; the
// map and the horizontal-pass intermediate stay in shared memory (2 * H * W
// floats, 32 KB at 64x64), so only the input read and the output write reach
// device memory. Offsets come from the strides given, so the [B, H, W, K]
// view of a channels_last NCHW head output is read without a transpose; the
// reads across K are strided (uncoalesced), left for a later change.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

// Max of `v` over the block, returned to every thread. `red` holds kWarps
// floats; the trailing barrier lets the caller reuse it.
__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_max(lane < kWarps ? red[lane] : -INFINITY);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float out = red[0];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(kThreads)
blur_log_kernel(const float* __restrict__ x, float* __restrict__ y,
                const float* __restrict__ taps, int ksize, int H, int W,
                int K, long long xb, long long xh, long long xw, long long xk,
                long long yb, long long yh, long long yw, long long yk) {
  extern __shared__ float smem[];
  const int HW = H * W;
  float* s_map = smem;              // the map, later the blurred map
  float* s_row = smem + HW;         // horizontal pass
  float* s_taps = s_row + HW;       // ksize taps
  float* s_red = s_taps + ksize;    // kWarps partial maxima

  const int b = blockIdx.x / K;
  const int k = blockIdx.x - b * K;
  const float* xm = x + b * xb + k * xk;
  float* ym = y + b * yb + k * yk;
  const int pad = ksize / 2;

  for (int t = threadIdx.x; t < ksize; t += kThreads) s_taps[t] = taps[t];
  float m = -INFINITY;
  for (int i = threadIdx.x; i < HW; i += kThreads) {
    const int r = i / W;
    const int c = i - r * W;
    const float v = xm[r * xh + c * xw];
    s_map[i] = v;
    m = fmaxf(m, v);
  }
  const float orig_max = block_max(m, s_red);  // also publishes s_map

  // Taps that fall outside the map read the zero border and are skipped:
  // tap t of pixel (r, c) reads column c + t - pad, then row r + t - pad.
  for (int i = threadIdx.x; i < HW; i += kThreads) {
    const int r = i / W;
    const int c = i - r * W;
    const int t0 = max(0, pad - c);
    const int t1 = min(ksize, W + pad - c);
    const int base = r * W + c - pad;
    float acc = 0.f;
    for (int t = t0; t < t1; ++t) acc = fmaf(s_taps[t], s_map[base + t], acc);
    s_row[i] = acc;
  }
  __syncthreads();

  float bm = -INFINITY;
  for (int i = threadIdx.x; i < HW; i += kThreads) {
    const int r = i / W;
    const int c = i - r * W;
    const int t0 = max(0, pad - r);
    const int t1 = min(ksize, H + pad - r);
    const int base = (r - pad) * W + c;
    float acc = 0.f;
    for (int t = t0; t < t1; ++t) acc = fmaf(s_taps[t], s_row[base + t * W], acc);
    s_map[i] = acc;
    bm = fmaxf(bm, acc);
  }
  const float scale = orig_max / fmaxf(block_max(bm, s_red), 1e-20f);

  for (int i = threadIdx.x; i < HW; i += kThreads) {
    const int r = i / W;
    const int c = i - r * W;
    ym[r * yh + c * yw] = logf(fmaxf(s_map[i] * scale, 1e-10f));
  }
}

// Shared memory one block needs; kernels/blur_log.py::smem_bytes checks the
// same sum against the card's limit before launching.
long long smem_bytes(int H, int W, int ksize) {
  return (2LL * H * W + ksize + kWarps) * static_cast<long long>(sizeof(float));
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int lhn_blur_log_f32(const float* x, float* y, const float* taps,
                                int ksize, int B, int H, int W, int K,
                                long long xb, long long xh, long long xw,
                                long long xk, long long yb, long long yh,
                                long long yw, long long yk, void* stream) {
  const long long smem = smem_bytes(H, W, ksize);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        blur_log_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  blur_log_kernel<<<B * K, kThreads, static_cast<size_t>(smem),
                    static_cast<cudaStream_t>(stream)>>>(
      x, y, taps, ksize, H, W, K, xb, xh, xw, xk, yb, yh, yw, yk);
  return static_cast<int>(cudaGetLastError());
}
