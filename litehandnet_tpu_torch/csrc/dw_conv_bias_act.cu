// Depthwise "same" convolution with its bias and activation in the epilogue,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's deploy graph leaves its
// depthwise convolutions to XLA. It was added because cuDNN's grouped
// direct kernel (conv2d_grouped_direct_kernel) runs the deploy graph's
// depthwise convolutions at about 10% of their memory bound on the H100,
// and PyTorch adds the bias and the activation afterwards as two more
// passes over the output.
//
// For x [N, C, H, W] (bfloat16 or float32, channels innermost), taps
// [C, 1, k, k] (float32), k in {3, 5, 7}, dilation d in 1..4, padding
// d * (k / 2), stride 1, and a float32 bias [C], it computes
//   y = act(depthwise_conv(x, w) + b)
// with act none, ReLU or leaky ReLU (slope given), taps, bias and sums in
// float32, rounded once at the store to x's dtype (channels_last).
//
// Bound: memory for k = 3 (each input element read once, each output
// written once: 1.44 GB a LiteHandNet batch of 128 in bfloat16, 0.43 ms at
// 3.35 TB/s) and the FP32 pipes for k = 7 in bfloat16 (98 operations for 4
// bytes of an output element: the stem's [128, 32, 128, 128] takes 0.100 ms
// at 67 TFLOP/s against 0.080 ms of bytes).
//
// Design (the launch plan comes from kernels/dw_conv_bias_act.py::plan):
// - A work item is a 16d x 32 output tile of one image and one channel
//   group; grid.y is the group (64 bytes of a pixel for k = 3, 32 bytes for
//   k = 5 and 7), grid.x blocks, one per SM, walk the items blockIdx.x,
//   + gridDim.x.
// - The tile and its halo arrive in shared memory by 16-byte cp.async,
//   zero-filled outside the image, into a ring of up to 3 buffers: the
//   next items' copies are in flight while the current one is computed.
// - A thread owns kV channels (16 bytes for k = 3, 4 bytes for k = 5 and
//   7, so the taps fit in registers) of one output column and kRows output
//   rows spaced d apart; it walks its input rows once and adds each row's k
//   taps into the k outputs that use it, so a loaded row is reused k times
//   from registers. Dilation only scales the shared-memory offsets: rows
//   of one residue mod d form a dilation-1 problem. The sum of an output
//   runs over ky, then kx.
// - The bias and the activation are applied in registers before the one
//   store of 16 (k = 3) or 4 bytes a thread and row.
// No host synchronisation, no allocation, the caller's stream: the launch
// may be captured in a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTileW = 32;             // output columns of an item
constexpr int kMaxStages = 3;
constexpr int kMaxBlockSmem = 232448;  // 227 KB, Hopper
constexpr int kMaxDevices = 64;

// What depends on the kernel size k and the element type T.
template <typename T, int K>
struct Cfg {
  static constexpr int kBytes = K == 3 ? 16 : 4;   // a thread's bytes a pixel
  static constexpr int kV = kBytes / static_cast<int>(sizeof(T));  // channels
  static constexpr int kLanes = K == 3 ? 4 : 8;    // threads across a group
  static constexpr int kGroup = kLanes * kV;       // channels of a group
  static constexpr int kSegs = kThreads / (kLanes * kTileW);
  static constexpr int kRows = K == 3 ? 8 : 16;    // output rows a thread
  static constexpr int kChunk = 16 / static_cast<int>(sizeof(T));
  static constexpr int kChunks = kGroup / kChunk;  // copies a pixel
  static_assert(kV >= 1 && kChunks >= 1, "a group is whole 16-byte copies");
  static_assert(kSegs * kRows == 16, "a tile is 16 d rows");
};

struct Geometry {
  int N, C, H, W, d, pad;
  int tile_h, rows_in, cols_in;  // output rows of an item; its input tile
  int tiles_x, tiles_y, items;   // items = N * tiles_y * tiles_x
  long long xn, xh, xw;          // element strides of x (channels: 1)
  int stage_bytes, stages;
};

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = *p;
  } else if constexpr (V == 2) {
    const float2 r = *reinterpret_cast<const float2*>(p);
    v[0] = r.x; v[1] = r.y;
  } else {
    static_assert(V % 4 == 0, "float vectors of 1, 2 or 4k");
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 r = *reinterpret_cast<const float4*>(p + i);
      v[i] = r.x; v[i + 1] = r.y; v[i + 2] = r.z; v[i + 3] = r.w;
    }
  }
}

__device__ __forceinline__ void unpack2(uint32_t w, float* v) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}

template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[V]) {
  if constexpr (V == 2) {
    unpack2(*reinterpret_cast<const uint32_t*>(p), v);
  } else if constexpr (V == 4) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    unpack2(r.x, v); unpack2(r.y, v + 2);
  } else {
    static_assert(V == 8, "bfloat16 vectors of 2, 4 or 8");
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    unpack2(r.x, v); unpack2(r.y, v + 2); unpack2(r.z, v + 4);
    unpack2(r.w, v + 6);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    *p = v[0];
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    }
  }
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[V]) {
  if constexpr (V == 2) {
    *reinterpret_cast<uint32_t*>(p) = pack2(v[0], v[1]);
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack2(v[0], v[1]),
                                              pack2(v[2], v[3]));
  } else {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                   pack2(v[6], v[7]));
  }
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
// Waits until at most stages - 1 groups are pending: the oldest is in.
__device__ __forceinline__ void cp_async_wait_oldest(int stages) {
  if (stages >= 3) {
    cp_async_wait<2>();
  } else if (stages == 2) {
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
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
  return {n, ty * g.tile_h, (rem - ty * g.tiles_x) * kTileW};
}

// Brings item `it`'s input tile, channels c0 .. c0 + kGroup, into `buf` as
// [rows_in][cols_in][kGroup] of T: zero outside the image and at
// channels >= C.
template <typename T, int K>
__device__ __forceinline__ void issue(const T* __restrict__ x,
                                      const Geometry& g, int it, int c0,
                                      T* buf) {
  using Q = Cfg<T, K>;
  const Item at = item_of(g, it);
  const T* xb = x + at.n * g.xn;
  const int per_row = g.cols_in * Q::kChunks;
  // thread t copies chunk t, t + kThreads, ...; (r, j) advance by adds
  int r = threadIdx.x / per_row;
  int j = threadIdx.x - r * per_row;
  const int dr = kThreads / per_row;
  const int dj = kThreads - dr * per_row;
  while (r < g.rows_in) {
    const int col = j / Q::kChunks;  // kChunks is 2 or 4: a shift
    const int ch = (j - col * Q::kChunks) * Q::kChunk;
    const int gy = at.y0 + r - g.pad;
    const int gx = at.x0 + col - g.pad;
    const bool valid =
        gy >= 0 && gy < g.H && gx >= 0 && gx < g.W && c0 + ch < g.C;
    const T* src = valid ? xb + gy * g.xh + gx * g.xw + c0 + ch : x;
    cp_async16(buf + (r * g.cols_in + col) * Q::kGroup + ch, src, valid);
    r += dr;
    j += dj;
    if (j >= per_row) {
      j -= per_row;
      ++r;
    }
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads, 1)
dw_conv_bias_act_kernel(const T* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ b, T* __restrict__ y,
                        Geometry g, int act, float slope) {
  using Q = Cfg<T, K>;
  constexpr int V = Q::kV;
  constexpr int R = Q::kRows;
  extern __shared__ __align__(16) unsigned char s_ring[];
  const int lane = threadIdx.x % Q::kLanes;
  const int col = (threadIdx.x / Q::kLanes) % kTileW;
  const int seg = threadIdx.x / (Q::kLanes * kTileW);
  const int c0 = blockIdx.y * Q::kGroup;
  const int c = c0 + lane * V;  // this thread's first channel
  // C % 8 == 0 and V divides 8: a thread's channels are all below C or
  // none is
  const bool live = c < g.C;
  const int d = g.d;

  float tap[K * K][V];
  float bias[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
#pragma unroll
    for (int k = 0; k < K * K; ++k) {
      tap[k][e] = live ? w[(c + e) * (K * K) + k] : 0.f;
    }
    bias[e] = live ? b[c + e] : 0.f;
  }

  auto buffer = [&](int i) {
    return reinterpret_cast<T*>(s_ring + i * g.stage_bytes);
  };
  const long long yw = g.C;
  const long long yh = yw * g.W;
  const long long yn = yh * g.H;
  // a step of one input row, and of d rows, in the tile
  const int row_step = g.cols_in * Q::kGroup;
  const int tap_step = d * Q::kGroup;  // d columns

  // prologue: the first stages - 1 items of this block
  for (int s = 0; s + 1 < g.stages; ++s) {
    const int it = blockIdx.x + s * gridDim.x;
    if (it < g.items) issue<T, K>(x, g, it, c0, buffer(s));
    cp_async_commit();
  }
  int k = 0;
  for (int item = blockIdx.x; item < g.items; item += gridDim.x, ++k) {
    const int ahead = item + (g.stages - 1) * gridDim.x;
    if (ahead < g.items) {
      issue<T, K>(x, g, ahead, c0, buffer((k + g.stages - 1) % g.stages));
    }
    cp_async_commit();
    cp_async_wait_oldest(g.stages);
    __syncthreads();

    const Item at = item_of(g, item);
    const T* tile = buffer(k % g.stages) + col * Q::kGroup + lane * V;
    const int ox = at.x0 + col;
    T* yb = y + at.n * yn + ox * yw + c;
#pragma unroll 1
    for (int rho = 0; rho < d; ++rho) {
      float acc[R][V];
#pragma unroll
      for (int m = 0; m < R; ++m) {
#pragma unroll
        for (int e = 0; e < V; ++e) acc[m][e] = 0.f;
      }
      // input row t of this thread's progression: tile row
      // rho + d (seg R + t); output m takes rows m .. m + K - 1
      const T* rows = tile + (rho + d * seg * R) * row_step;
#pragma unroll
      for (int t = 0; t < R + K - 1; ++t) {
        float v[K][V];
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          load_vec<V>(rows + t * d * row_step + kx * tap_step, v[kx]);
        }
#pragma unroll
        for (int ky = 0; ky < K; ++ky) {
          const int m = t - ky;
          if (m < 0 || m >= R) continue;
#pragma unroll
          for (int kx = 0; kx < K; ++kx) {
#pragma unroll
            for (int e = 0; e < V; ++e) {
              acc[m][e] = __fmaf_rn(tap[ky * K + kx][e], v[kx][e], acc[m][e]);
            }
          }
        }
      }
      if (!live || ox >= g.W) continue;
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const int oy = at.y0 + rho + d * (seg * R + m);
        if (oy >= g.H) break;  // rows rise with m
        float o[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float s = acc[m][e] + bias[e];
          o[e] = act == 0 ? s : s < 0.f ? (act == 1 ? 0.f : s * slope) : s;
        }
        store_vec<V>(yb + oy * yh, o);
      }
    }
    __syncthreads();  // every thread is done with this buffer
  }
  cp_async_wait<0>();
}

template <typename T, int K>
cudaError_t launch(const void* x, const float* w, const float* b, void* y,
                   const Geometry& g, int grid_x, int groups, int act,
                   float slope, cudaStream_t s) {
  auto kernel = dw_conv_bias_act_kernel<T, K>;
  // once per device and instantiation: allow all of a block's 227 KB
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxBlockSmem);
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  const dim3 grid(static_cast<unsigned>(grid_x), static_cast<unsigned>(groups));
  const size_t smem = static_cast<size_t>(g.stages) * g.stage_bytes;
  kernel<<<grid, kThreads, smem, s>>>(static_cast<const T*>(x), w, b,
                                      static_cast<T*>(y), g, act, slope);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k(int k, const void* x, const float* w, const float* b,
                     void* y, const Geometry& g, int grid_x, int groups,
                     int act, float slope, cudaStream_t s) {
  switch (k) {
    case 3:
      return launch<T, 3>(x, w, b, y, g, grid_x, groups, act, slope, s);
    case 5:
      return launch<T, 5>(x, w, b, y, g, grid_x, groups, act, slope, s);
    default:
      return launch<T, 7>(x, w, b, y, g, grid_x, groups, act, slope, s);
  }
}

// Bytes of a pixel's channel group for kernel size k (the same for both
// element types).
int group_bytes(int k) { return k == 3 ? 64 : 32; }

}  // namespace

// Bytes of one ring buffer for kernel size k at dilation d: the 16d x 32
// tile and its halo, one channel group; kernels/dw_conv_bias_act.py checks
// its plan against it.
extern "C" int lhn_dwba_stage_bytes(int k, int d) {
  const int pad = d * (k / 2);
  return (16 * d + 2 * pad) * (kTileW + 2 * pad) * group_bytes(k);
}

// The launch plan of kernels/dw_conv_bias_act.py::plan, one int64 each, in
// this order (kernels/dw_conv_bias_act.py PLAN_FIELDS).
enum Plan {
  kDtype, kK, kD, kN, kC, kH, kW, kXn, kXh, kXw, kGridX, kGroups, kStages,
  kStageBytes, kPlanFields
};

extern "C" int lhn_dwba_plan_fields() { return kPlanFields; }

// x: [N, C, H, W] with element strides xn, 1, xh, xw (channels innermost,
// 16-byte aligned, strides multiples of 16 bytes, C % 8 == 0); dtype 0 =
// float32, 1 = bfloat16; w: [C, 1, k, k] float32 contiguous; b: [C]
// float32; y: [N, C, H, W] channels_last contiguous in x's dtype. act 0 =
// none, 1 = ReLU, 2 = leaky ReLU with `slope`. Grid (grid_x, groups =
// ceil(C / group)), `stages` ring buffers of stage_bytes. One launch on
// `stream`; returns its CUDA error (0 if none).
extern "C" int lhn_dw_conv_bias_act(const void* x, const float* w,
                                    const float* b, void* y,
                                    const long long* plan, int act,
                                    float slope, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dtype = static_cast<int>(plan[kDtype]);
  const int k = static_cast<int>(plan[kK]);
  const int d = static_cast<int>(plan[kD]);
  const int N = static_cast<int>(plan[kN]);
  const int C = static_cast<int>(plan[kC]);
  const int H = static_cast<int>(plan[kH]);
  const int W = static_cast<int>(plan[kW]);
  const int grid_x = static_cast<int>(plan[kGridX]);
  const int groups = static_cast<int>(plan[kGroups]);
  const int stages = static_cast<int>(plan[kStages]);
  const int stage_bytes = static_cast<int>(plan[kStageBytes]);
  if ((dtype != 0 && dtype != 1) || (k != 3 && k != 5 && k != 7) || d < 1 ||
      d > 4 || C % 8 != 0 || N < 1 || H < 1 || W < 1 || grid_x < 1 ||
      act < 0 || act > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int elem = dtype == 0 ? 4 : 2;
  const int group = group_bytes(k) / elem;
  if (groups != (C + group - 1) / group ||
      stage_bytes != lhn_dwba_stage_bytes(k, d) || stages < 1 ||
      stages > kMaxStages || stages * stage_bytes > kMaxBlockSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int pad = d * (k / 2);
  const int tile_h = 16 * d;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tiles_y = (H + tile_h - 1) / tile_h;
  const Geometry g{N, C, H, W, d, pad, tile_h, tile_h + 2 * pad,
                   kTileW + 2 * pad, tiles_x, tiles_y, N * tiles_y * tiles_x,
                   plan[kXn], plan[kXh], plan[kXw], stage_bytes, stages};
  cudaError_t err;
  if (dtype == 0) {
    err = launch_k<float>(k, x, w, b, y, g, grid_x, groups, act, slope, s);
  } else {
    err = launch_k<__nv_bfloat16>(k, x, w, b, y, g, grid_x, groups, act,
                                  slope, s);
  }
  return static_cast<int>(err);
}
