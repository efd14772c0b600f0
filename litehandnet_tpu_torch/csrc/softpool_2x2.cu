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
// Numerics, the same on both paths: bfloat16 is widened to float32; per
// window tap in row-major order num = __fmaf_rn(e, x, num) and
// den = __fadd_rn(den, e) with e = expf(x); one IEEE divide and one rounding
// to the output type. No sum is left to the compiler's contraction, so the
// two paths give the same bits.
//
// Bound: memory. Each input element is read once (k = s) and each output
// written once, for 4 FP32 operations and one expf per input element; at
// [128, 128, 64, 64] float32 that is 335.5 MB, 100.2 us at 3.35 TB/s.
//
// Fast path (kernels/softpool_2x2.py::plan, path 1): k = s = 2, channels
// innermost (channels_last memory), C * sizeof(T) a multiple of 16 bytes,
// every stride a multiple of 16 / sizeof(T) elements and x 16-byte aligned.
// - A thread owns 16 bytes of channels (4 float32 or 8 bfloat16) of two
//   output pixels `slots` apart; it issues the 8 tap loads of both (16 bytes
//   each) before the first expf and stores each result as 16 bytes. lanes
//   threads cover the channel vectors of a pixel, so a warp reads whole
//   pixel rows (512 contiguous bytes for 128 float32 channels).
// - Blocks walk output rows (b, ho) with a grid stride; the plan sizes the
//   grid to whole rounds of rows at 4 blocks per SM. Indexing is 2-D
//   (output row, then pixel and channel vector): one division per output
//   row, none per element.
// General path (path 0): any k and s, NCHW or other strides, ragged C, an
// unaligned start. One thread per output element, the same 2-D walk with
// scalar taps: for channels-innermost memory threads cover (channel, pixel)
// of one output row, otherwise (column, output row).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

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

// One output from its window's values in row-major tap order.
struct Pool {
  float num = 0.f;
  float den = 0.f;
  __device__ __forceinline__ void add(float v) {
    const float e = expf(v);
    num = __fmaf_rn(e, v, num);
    den = __fadd_rn(den, e);
  }
  __device__ __forceinline__ float value() const { return __fdiv_rn(num, den); }
};

// 16 bytes as V floats, and back (bfloat16: element 2i in the low half of
// word i).
__device__ __forceinline__ void unpack(const uint4& r, float (&v)[4]) {
  v[0] = __uint_as_float(r.x);
  v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z);
  v[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&v)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat16 lo = __float2bfloat16(v[2 * i]);
    const __nv_bfloat16 hi = __float2bfloat16(v[2 * i + 1]);
    w[i] = static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The 2 x 2 window of V channels from its four taps (00, 01, 10, 11).
template <int V>
__device__ __forceinline__ uint4 pool4(const uint4 (&tap)[4]) {
  float v[4][V];
#pragma unroll
  for (int i = 0; i < 4; ++i) unpack(tap[i], v[i]);
  float out[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    Pool p;
#pragma unroll
    for (int i = 0; i < 4; ++i) p.add(v[i][e]);
    out[e] = p.value();
  }
  return pack(out);
}

struct Geometry {
  int C, Ho, Wo, k, s;
  int lanes, slots;         // threads = lanes * slots
  int channels_fastest;     // general path: the walk's order
  long long units;          // output rows a block iteration takes
  long long xb, xc, xh, xw;
  long long yb, yc, yh, yw;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
softpool_fast(const T* __restrict__ x, T* __restrict__ y, Geometry g) {
  constexpr int V = 16 / sizeof(T);
  const int cvs = g.C / V;                  // channel vectors of a pixel
  const int tx = threadIdx.x % g.lanes;     // channel vector
  const int ty = threadIdx.x / g.lanes;     // pixel slot
  for (long long u = blockIdx.x; u < g.units; u += gridDim.x) {
    const long long b = u / g.Ho;
    const int ho = static_cast<int>(u - b * g.Ho);
    const T* x0 = x + b * g.xb + 2LL * ho * g.xh;
    const T* x1 = x0 + g.xh;
    T* yr = y + b * g.yb + ho * g.yh;
    for (int wo = ty; wo < g.Wo; wo += 2 * g.slots) {
      const int wo2 = wo + g.slots;
      const bool two = wo2 < g.Wo;
      for (int cv = tx; cv < cvs; cv += g.lanes) {
        const long long o1 = 2LL * wo * g.xw + cv * V;
        const long long o2 = 2LL * wo2 * g.xw + cv * V;
        uint4 a[4], c[4];
        a[0] = __ldg(reinterpret_cast<const uint4*>(x0 + o1));
        a[1] = __ldg(reinterpret_cast<const uint4*>(x0 + o1 + g.xw));
        a[2] = __ldg(reinterpret_cast<const uint4*>(x1 + o1));
        a[3] = __ldg(reinterpret_cast<const uint4*>(x1 + o1 + g.xw));
        if (two) {
          c[0] = __ldg(reinterpret_cast<const uint4*>(x0 + o2));
          c[1] = __ldg(reinterpret_cast<const uint4*>(x0 + o2 + g.xw));
          c[2] = __ldg(reinterpret_cast<const uint4*>(x1 + o2));
          c[3] = __ldg(reinterpret_cast<const uint4*>(x1 + o2 + g.xw));
        }
        *reinterpret_cast<uint4*>(yr + wo * g.yw + cv * V) = pool4<V>(a);
        if (two) {
          *reinterpret_cast<uint4*>(yr + wo2 * g.yw + cv * V) = pool4<V>(c);
        }
      }
    }
  }
}

// One output; kK > 0: a window of kK x kK known at compile time, so its
// loads are all issued before the first expf; kK == 0: g.k.
template <int kK, typename T>
__device__ __forceinline__ void pool_one(const Geometry& g, const T* xp,
                                         T* yp) {
  const int k = kK > 0 ? kK : g.k;
  Pool p;
#pragma unroll
  for (int dy = 0; dy < k; ++dy) {
#pragma unroll
    for (int dx = 0; dx < k; ++dx) p.add(to_f32(xp[dy * g.xh + dx * g.xw]));
  }
  *yp = from_f32<T>(p.value());
}

template <int kK, typename T>
__device__ __forceinline__ void general_walk(const T* __restrict__ x,
                                             T* __restrict__ y,
                                             const Geometry& g) {
  const int tx = threadIdx.x % g.lanes;
  const int ty = threadIdx.x / g.lanes;
  if (g.channels_fastest) {
    // unit = output row (b, ho); threads cover (channel, pixel)
    for (long long u = blockIdx.x; u < g.units; u += gridDim.x) {
      const long long b = u / g.Ho;
      const int ho = static_cast<int>(u - b * g.Ho);
      const T* xu = x + b * g.xb + 1LL * ho * g.s * g.xh;
      T* yu = y + b * g.yb + ho * g.yh;
      for (int wo = ty; wo < g.Wo; wo += g.slots) {
        for (int c = tx; c < g.C; c += g.lanes) {
          pool_one<kK>(g, xu + c * g.xc + 1LL * wo * g.s * g.xw,
                       yu + c * g.yc + wo * g.yw);
        }
      }
    }
  } else {
    // unit = output row (b, c, ho); slots units at a time, threads cover
    // their columns
    const long long step = static_cast<long long>(gridDim.x) * g.slots;
    for (long long u = blockIdx.x * static_cast<long long>(g.slots) + ty;
         u < g.units; u += step) {
      const long long bc = u / g.Ho;
      const int ho = static_cast<int>(u - bc * g.Ho);
      const long long b = bc / g.C;
      const int c = static_cast<int>(bc - b * g.C);
      const T* xu = x + b * g.xb + c * g.xc + 1LL * ho * g.s * g.xh;
      T* yu = y + b * g.yb + c * g.yc + ho * g.yh;
      for (int wo = tx; wo < g.Wo; wo += g.lanes) {
        pool_one<kK>(g, xu + 1LL * wo * g.s * g.xw, yu + wo * g.yw);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
softpool_general(const T* __restrict__ x, T* __restrict__ y, Geometry g) {
  if (g.k == 2) {
    general_walk<2>(x, y, g);
  } else {
    general_walk<0>(x, y, g);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, int fast, const Geometry& g,
                   int grid, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const int threads = g.lanes * g.slots;
  if (fast) {
    softpool_fast<T><<<grid, threads, 0, stream>>>(xt, yt, g);
  } else {
    softpool_general<T><<<grid, threads, 0, stream>>>(xt, yt, g);
  }
  return cudaGetLastError();
}

}  // namespace

// The launch plan of kernels/softpool_2x2.py::plan, one int64 each, in this
// order (kernels/softpool_2x2.py PLAN_FIELDS).
enum Plan {
  kDtype, kPath, kC, kHo, kWo, kK, kS, kXb, kXc, kXh, kXw, kYb, kYc, kYh,
  kYw, kUnits, kLanes, kSlots, kGrid, kChannelsFastest, kPlanFields
};

extern "C" int lhn_softpool_plan_fields() { return kPlanFields; }

// x: [B, C, H, W] with element strides xb, xc, xh, xw; y: [B, C, Ho, Wo]
// with strides yb, yc, yh, yw, Ho = (H - k) / s + 1, Wo = (W - k) / s + 1;
// dtype 0 = float32, 1 = bfloat16 (x and y alike). path 1 (fast): k = s =
// 2, xc == yc == 1, C and the other strides multiples of 16 / sizeof(T), x
// and y 16-byte aligned; units = B * Ho. path 0: units = B * Ho for
// channels-innermost memory (channels_fastest 1), else B * C * Ho. Blocks
// of lanes * slots <= 256 threads, `grid` of them. One launch on `stream`;
// returns its CUDA error (0 if none).
extern "C" int lhn_softpool(const void* x, void* y, const long long* plan,
                            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geometry g{static_cast<int>(plan[kC]), static_cast<int>(plan[kHo]),
                   static_cast<int>(plan[kWo]), static_cast<int>(plan[kK]),
                   static_cast<int>(plan[kS]), static_cast<int>(plan[kLanes]),
                   static_cast<int>(plan[kSlots]),
                   static_cast<int>(plan[kChannelsFastest]), plan[kUnits],
                   plan[kXb], plan[kXc], plan[kXh], plan[kXw], plan[kYb],
                   plan[kYc], plan[kYh], plan[kYw]};
  const int dtype = static_cast<int>(plan[kDtype]);
  const int fast = static_cast<int>(plan[kPath]);
  const long long grid = plan[kGrid];
  const int vec = dtype == 0 ? 4 : 8;
  if ((dtype != 0 && dtype != 1) || (fast != 0 && fast != 1) ||
      g.lanes < 1 || g.slots < 1 || g.lanes * g.slots > kThreads ||
      grid < 1 || grid > 0x7fffffffLL || g.k < 1 || g.s < 1 ||
      (fast && (g.k != 2 || g.s != 2 || g.xc != 1 || g.yc != 1 ||
                g.C % vec != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = static_cast<int>(grid);
  const cudaError_t err =
      dtype == 0 ? launch<float>(x, y, fast, g, blocks, st)
                 : launch<__nv_bfloat16>(x, y, fast, g, blocks, st);
  return static_cast<int>(err);
}
