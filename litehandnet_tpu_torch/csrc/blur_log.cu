// DARK modulation of heatmaps for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel litehandnet_tpu/ops/pallas_kernels.py::
// blur_log (:106, body _blur_log_kernel :82). For each (b, k) map of a
// [B, H, W, K] float32 tensor:
//   1. blur with the separable cv2 Gaussian (taps given), zero border: a
//      horizontal pass, then a vertical pass over its rows;
//   2. rescale so the map's max equals its pre-blur max, the blurred max
//      floored at 1e-20;
//   3. log(max(., 1e-10)).
//
// Bound: memory. Each pixel is read once and written once (8 bytes) for
// 2 * 2 * ksize + 2 FP32 operations and a logf; at the serve shape
// [128, 64, 64, 21] that is 88.1 MB, 26.3 us at 3.35 TB/s. The operations
// are not free either: two 11-tap passes and a logf come to about 50
// instructions a pixel, on an H100 about as long as the copy itself. The
// CTAs of a wave load, pass and store in step, so the two add up rather
// than overlap. A persistent grid that loads an image's rows while it
// passes the last one (two row buffers, or one refilled after the maxima
// exchange) was slower still: it holds fewer CTAs an SM (PERF.md §6).
//
// Fast path (kernels/blur_log.py::plan, path 1): the serve layout, K
// innermost and each W * K row contiguous and 16-byte aligned (at the serve
// shape a row of one image is 64 * 21 * 4 = 5,376 bytes), ksize 11, H <= 64
// and W * K <= 1,536.
// - A CTA owns rows = ceil(H / 8) output rows of one image, for all W
//   columns and all K maps; the ceil(H / rows) CTAs of an image form one
//   thread block cluster (at most 8, the portable size). Its rows arrive by
//   16-byte cp.async (rows below the image zero-filled); they are all the
//   shared memory it holds (43 KB at the serve shape), so three CTAs share
//   an SM (ptxas: at most 56 registers a thread).
// - Horizontal pass, in place: a thread owns a run of kRun = 32 columns of
//   one map of one row. It reads the 5 columns on either side of its run
//   into registers, waits at a barrier for every thread to have done so,
//   then slides along its run, reading each column once, 5 columns before
//   it overwrites it with its output. The input maxima come from the same
//   registers.
// - Vertical pass: a thread owns 4 consecutive floats of a row (16 bytes,
//   up to 4 maps) and the CTA's rows; it reads each of the rows + 10 source
//   rows as one float4 and adds it into the outputs that use it. The 10
//   halo rows are the neighbouring CTAs' horizontal-pass rows, read over
//   distributed shared memory, so no CTA loads or passes a row twice. The
//   outputs stay in registers.
// - Maxima: each CTA folds its K input and K blurred maxima in shared
//   memory (atomicMax on an order-preserving unsigned image of the float;
//   max is exact, so the order does not matter), then reads those of every
//   CTA of its cluster over distributed shared memory; every CTA derives
//   the same scale.
// - Epilogue: scale, logf and 16-byte coalesced stores from the registers.
// - The taps are a kernel parameter: the FMAs read them from the constant
//   bank.
// General path (path 0): any strides, any odd ksize, rows that are not
// 16-byte aligned, and tiles too large for one CTA. One 256-thread block
// per (b, k) map holds the map and its horizontal pass in shared memory
// (2 * H * W floats); threads walk (row, column) in 2-D, 8 rows by 32
// columns a step.
//
// Both paths compute the same bits: the taps in ascending order with
// __fmaf_rn, a zero for every tap outside the map (an FMA with zero leaves
// the sum as the old kernel's skipped tap did), one IEEE divide for the
// scale, __fmul_rn, the 1e-20 and 1e-10 clamps and logf.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kTaps = 11;          // the fast path's kernel size
constexpr int kPad = kTaps / 2;
constexpr int kRun = 32;           // columns per horizontal-pass task
constexpr int kRowChunk = 8;       // output rows per vertical-pass step
constexpr int kFastMaxThreads = 384;
constexpr int kThreads = 256;      // general path
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlockSmem = 232448;  // 227 KB, Hopper
constexpr int kMaxCluster = 8;
constexpr int kMaxDevices = 64;

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

// ---------------------------------------------------------------------------
// general path
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
blur_log_general(const float* __restrict__ x, float* __restrict__ y,
                 const float* __restrict__ taps, int ksize, int H, int W,
                 int K, long long xb, long long xh, long long xw, long long xk,
                 long long yb, long long yh, long long yw, long long yk) {
  extern __shared__ __align__(16) float smem[];
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
  // a step covers 8 rows of 32 columns
  const int r0 = threadIdx.x >> 5;
  const int c0 = threadIdx.x & 31;

  for (int t = threadIdx.x; t < ksize; t += kThreads) s_taps[t] = taps[t];
  float m = -INFINITY;
  for (int r = r0; r < H; r += kWarps) {
    for (int c = c0; c < W; c += 32) {
      const float v = xm[r * xh + c * xw];
      s_map[r * W + c] = v;
      m = fmaxf(m, v);
    }
  }
  const float orig_max = block_max(m, s_red);  // also publishes s_map

  // tap t of pixel (r, c) reads column c + t - pad, then row r + t - pad
  for (int r = r0; r < H; r += kWarps) {
    for (int c = c0; c < W; c += 32) {
      const float* src = s_map + r * W;
      float acc = 0.f;
      for (int t = 0; t < ksize; ++t) {
        const int cc = c + t - pad;
        const float v = cc >= 0 && cc < W ? src[cc] : 0.f;
        acc = __fmaf_rn(s_taps[t], v, acc);
      }
      s_row[r * W + c] = acc;
    }
  }
  __syncthreads();

  float bm = -INFINITY;
  for (int r = r0; r < H; r += kWarps) {
    for (int c = c0; c < W; c += 32) {
      float acc = 0.f;
      for (int t = 0; t < ksize; ++t) {
        const int rr = r + t - pad;
        const float v = rr >= 0 && rr < H ? s_row[rr * W + c] : 0.f;
        acc = __fmaf_rn(s_taps[t], v, acc);
      }
      s_map[r * W + c] = acc;
      bm = fmaxf(bm, acc);
    }
  }
  const float scale = __fdiv_rn(orig_max, fmaxf(block_max(bm, s_red), 1e-20f));

  for (int r = r0; r < H; r += kWarps) {
    for (int c = c0; c < W; c += 32) {
      ym[r * yh + c * yw] =
          logf(fmaxf(__fmul_rn(s_map[r * W + c], scale), 1e-10f));
    }
  }
}

// ---------------------------------------------------------------------------
// fast path
// ---------------------------------------------------------------------------

// An unsigned image of a float whose order is the floats' order, for
// atomicMax; kOrderedNegInf is that of -INFINITY.
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float unordered(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}
constexpr unsigned kOrderedNegInf = 0x007fffffu;

// fmaxf ignores NaN; so does the fold, which then matches the general path
__device__ __forceinline__ void fold_max(unsigned* slot, float v) {
  if (!(v != v)) atomicMax(slot, ordered(v));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void fma4(float t, const float4& v, float4& a) {
  a.x = __fmaf_rn(t, v.x, a.x);
  a.y = __fmaf_rn(t, v.y, a.y);
  a.z = __fmaf_rn(t, v.z, a.z);
  a.w = __fmaf_rn(t, v.w, a.w);
}

// The taps as a kernel parameter: the FMAs read them from the constant
// bank, in no register.
struct Taps {
  float t[kTaps];
};

struct Fast {
  int H, W, K, WK;         // WK = W * K floats per row, a multiple of 4
  long long xb, xh;        // element strides of x's images and rows
  long long yb, yh;        // and of y's
  int rows;                // output rows per CTA, at most kRowChunk
  int cluster;             // CTAs per image
};

// Shared memory of one CTA: its rows (raw, then their horizontal pass),
// the K input and K blurred maxima and the K scales.
__host__ __device__ __forceinline__ long long fast_smem_floats(int rows,
                                                               int WK, int K) {
  return static_cast<long long>(rows) * WK + 3LL * K;
}

__global__ void __launch_bounds__(kFastMaxThreads, 3)
blur_log_fast(const float* __restrict__ x, float* __restrict__ y, Taps tp,
              Fast g) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / g.cluster;
  const int R = g.rows;
  const int r0 = rank * R;                 // first output row
  const int WK = g.WK;
  const int K = g.K;
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  float* s_buf = smem;                     // R rows: raw, then passed
  unsigned* s_max = reinterpret_cast<unsigned*>(smem + R * WK);
  float* s_scale = reinterpret_cast<float*>(s_max + 2 * K);

  // the CTA's rows, 16 bytes a copy, rows below the image zero-filled;
  // (row, chunk) advance by adds
  {
    const float* xb = x + b * g.xb;
    const int per_row = WK / 4;
    int r = tid / per_row;
    int j = tid - r * per_row;
    const int dr = T / per_row;
    const int dj = T - dr * per_row;
    while (r < R) {
      const int gy = r0 + r;
      const bool valid = gy < g.H;
      cp_async16(s_buf + r * WK + 4 * j, valid ? xb + gy * g.xh + 4 * j : x,
                 valid);
      r += dr;
      j += dj;
      if (j >= per_row) {
        j -= per_row;
        ++r;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int i = tid; i < 2 * K; i += T) s_max[i] = kOrderedNegInf;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // horizontal pass, in place: task = (row, run of kRun columns, map), one
  // per thread. Each task first reads the kPad columns on either side of
  // its run, which its neighbours' runs overwrite; then, after a barrier,
  // it slides along its run, reading each of its own columns before it
  // writes it.
  {
    const int runs = (g.W + kRun - 1) / kRun;
    const bool has_task = tid < R * runs * K;
    const int k = tid % K;
    const int rest = tid / K;
    const int c0 = rest % runs * kRun;
    const int r = rest / runs;
    float* row = s_buf + r * WK + k;     // column c at row[c * K]
    float left[kPad], right[kPad];
#pragma unroll
    for (int i = 0; i < kPad; ++i) {
      const int cl = c0 - kPad + i;
      const int cr = c0 + kRun + i;
      left[i] = has_task && cl >= 0 ? row[cl * K] : 0.f;
      right[i] = has_task && cr < g.W ? row[cr * K] : 0.f;
    }
    __syncthreads();
    if (has_task) {
      float mid[kRun];
#pragma unroll
      for (int i = 0; i < kPad; ++i) {
        mid[i] = c0 + i < g.W ? row[(c0 + i) * K] : 0.f;
      }
      float m = -INFINITY;
#pragma unroll
      for (int l = 0; l < kRun; ++l) {
        const int ahead = l + kPad;      // read before column l is written
        if (ahead < kRun) {
          mid[ahead] = c0 + ahead < g.W ? row[(c0 + ahead) * K] : 0.f;
        }
        float acc = 0.f;
#pragma unroll
        for (int t = 0; t < kTaps; ++t) {
          const int j = l + t - kPad;
          const float v = j < 0 ? left[j + kPad]
                                : (j >= kRun ? right[j - kRun] : mid[j]);
          acc = __fmaf_rn(tp.t[t], v, acc);
        }
        if (c0 + l < g.W) {
          m = fmaxf(m, mid[l]);
          row[(c0 + l) * K] = acc;
        }
      }
      if (r0 + r < g.H) fold_max(s_max + k, m);
    }
  }
  cluster.sync();  // every CTA's horizontal-pass rows are complete

  // vertical pass: thread = 4 floats of a row (up to 4 maps), its R <=
  // kRowChunk output rows in registers. Source row s is image row
  // r0 + s - kPad, row `local` of CTA `owner` (this one or a neighbour).
  const int quads = WK / 4;
  const bool has_quad = tid < quads;
  const int n_rows = min(R, g.H - r0);
  float4 acc[kRowChunk];
#pragma unroll
  for (int o = 0; o < kRowChunk; ++o) acc[o] = make_float4(0.f, 0.f, 0.f, 0.f);
  {
    const int gs0 = r0 - kPad;
    int owner = gs0 >= 0 ? gs0 / R : -1 - (-gs0 - 1) / R;
    int local = gs0 - owner * R;
#pragma unroll
    for (int s = 0; s < kRowChunk + 2 * kPad; ++s) {
      const int gs = gs0 + s;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (has_quad && gs >= 0 && gs < g.H && s < R + 2 * kPad) {
        const float* src = cluster.map_shared_rank(s_buf, owner);
        v = *reinterpret_cast<const float4*>(src + local * WK + 4 * tid);
      }
      if (++local == R) {
        local = 0;
        ++owner;
      }
#pragma unroll
      for (int o = 0; o < kRowChunk; ++o) {
        const int t = s - o;
        if (t >= 0 && t < kTaps) fma4(tp.t[t], v, acc[o]);
      }
    }
  }
  if (has_quad) {
    float4 bm = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
#pragma unroll
    for (int o = 0; o < kRowChunk; ++o) {
      if (o < n_rows) {
        bm.x = fmaxf(bm.x, acc[o].x);
        bm.y = fmaxf(bm.y, acc[o].y);
        bm.z = fmaxf(bm.z, acc[o].z);
        bm.w = fmaxf(bm.w, acc[o].w);
      }
    }
    int k = (4 * tid) % K;
    const float m[4] = {bm.x, bm.y, bm.z, bm.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      fold_max(s_max + K + k, m[e]);
      if (++k == K) k = 0;
    }
  }
  __syncthreads();
  // every CTA's maxima are complete, and no CTA reads another's rows again
  cluster.sync();

  for (int k = tid; k < K; k += T) {
    float orig = -INFINITY;
    float blurred = -INFINITY;
    for (int c = 0; c < g.cluster; ++c) {
      const unsigned* other = cluster.map_shared_rank(s_max, c);
      orig = fmaxf(orig, unordered(other[k]));
      blurred = fmaxf(blurred, unordered(other[K + k]));
    }
    s_scale[k] = __fdiv_rn(orig, fmaxf(blurred, 1e-20f));
  }
  __syncthreads();
  // this CTA reads no other CTA's shared memory from here on; the others
  // may still read its maxima until the wait below
  cluster_arrive();

  if (has_quad) {
    float sc[4];
    int k = (4 * tid) % K;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[e] = s_scale[k];
      if (++k == K) k = 0;
    }
    float* yq = y + b * g.yb + static_cast<long long>(r0) * g.yh + 4 * tid;
#pragma unroll
    for (int o = 0; o < kRowChunk; ++o) {
      if (o < n_rows) {
        const float4 v = acc[o];
        *reinterpret_cast<float4*>(yq + o * g.yh) = make_float4(
            logf(fmaxf(__fmul_rn(v.x, sc[0]), 1e-10f)),
            logf(fmaxf(__fmul_rn(v.y, sc[1]), 1e-10f)),
            logf(fmaxf(__fmul_rn(v.z, sc[2]), 1e-10f)),
            logf(fmaxf(__fmul_rn(v.w, sc[3]), 1e-10f)));
      }
    }
  }
  cluster_wait();
}

// Once per device and kernel: allow all of a block's 227 KB as dynamic
// shared memory (no kernel here has static shared memory).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool (&allowed)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxBlockSmem);
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  return cudaSuccess;
}

cudaError_t launch_fast(const float* x, float* y, const Taps& tp,
                        const Fast& g, int B, int threads, long long smem,
                        cudaStream_t stream) {
  static bool allowed[kMaxDevices] = {};
  cudaError_t err = allow_smem(blur_log_fast, allowed);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(g.cluster) * B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, blur_log_fast, x, y, tp, g);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// The launch plan of kernels/blur_log.py::plan, one int64 each, in this
// order (kernels/blur_log.py PLAN_FIELDS).
enum Plan {
  kPath, kKsize, kB, kH, kW, kK, kXb, kXh, kXw, kXk, kYb, kYh, kYw, kYk,
  kRows, kCluster, kFastThreads, kSmem, kPlanFields
};

extern "C" int lhn_blur_log_plan_fields() { return kPlanFields; }

// Shared bytes of one fast-path CTA; kernels/blur_log.py checks its plan
// against it.
extern "C" long long lhn_blur_log_fast_smem(int rows, int W, int K) {
  return fast_smem_floats(rows, W * K, K) * 4;
}

// Bytes of one general-path block.
extern "C" long long lhn_blur_log_general_smem(int H, int W, int ksize) {
  return (2LL * H * W + ksize + kWarps) * 4;
}

// x: [B, H, W, K] float32 with element strides xb, xh, xw, xk; y: the same
// shape with strides yb, yh, yw, yk; taps: ksize floats on the device, and
// the same on the host (host_taps, read by the fast path). path 1 (fast):
// ksize 11, xk == yk == 1, xw == yw == K, W * K and the image and row
// strides multiples of 4, x and y 16-byte aligned, `cluster` CTAs of
// `rows` <= 8 rows per image (rows * cluster >= H > rows * (cluster - 1),
// cluster <= 8) of `threads` threads, a multiple of 32 up to 384 and at
// least W * K / 4 and rows * ceil(W / 32) * K, and `smem` shared bytes.
// path 0: general. One launch on `stream`; returns its CUDA error (0 if
// none).
extern "C" int lhn_blur_log(const float* x, float* y, const float* taps,
                            const float* host_taps, const long long* plan,
                            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ksize = static_cast<int>(plan[kKsize]);
  const int B = static_cast<int>(plan[kB]);
  const int H = static_cast<int>(plan[kH]);
  const int W = static_cast<int>(plan[kW]);
  const int K = static_cast<int>(plan[kK]);
  if (plan[kPath] == 0) {
    static bool allowed[kMaxDevices] = {};
    cudaError_t err = allow_smem(blur_log_general, allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long smem = lhn_blur_log_general_smem(H, W, ksize);
    if (ksize < 1 || ksize % 2 == 0 || smem > kMaxBlockSmem) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    blur_log_general<<<B * K, kThreads, static_cast<size_t>(smem), st>>>(
        x, y, taps, ksize, H, W, K, plan[kXb], plan[kXh], plan[kXw],
        plan[kXk], plan[kYb], plan[kYh], plan[kYw], plan[kYk]);
    return static_cast<int>(cudaGetLastError());
  }
  const int rows = static_cast<int>(plan[kRows]);
  const int cluster = static_cast<int>(plan[kCluster]);
  const int threads = static_cast<int>(plan[kFastThreads]);
  const long long smem = plan[kSmem];
  const int WK = W * K;
  const int tasks = rows * ((W + kRun - 1) / kRun) * K;
  if (plan[kPath] != 1 || ksize != kTaps || WK % 4 != 0 || plan[kXk] != 1 ||
      plan[kYk] != 1 || plan[kXw] != K || plan[kYw] != K || rows < 1 ||
      rows > kRowChunk || cluster < 1 || cluster > kMaxCluster ||
      rows * cluster < H || rows * (cluster - 1) >= H ||
      threads % 32 != 0 || threads > kFastMaxThreads || threads < WK / 4 ||
      threads < tasks || smem < lhn_blur_log_fast_smem(rows, W, K) ||
      smem > kMaxBlockSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps tp;
  for (int t = 0; t < kTaps; ++t) tp.t[t] = host_taps[t];
  const Fast g{H, W, K, WK, plan[kXb], plan[kXh], plan[kYb], plan[kYh],
               rows, cluster};
  return static_cast<int>(launch_fast(x, y, tp, g, B, threads, smem, st));
}
