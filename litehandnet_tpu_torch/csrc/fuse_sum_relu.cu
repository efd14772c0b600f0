// One output row of Lite-HRNet's cross-resolution fuse in one pass, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the fuse to XLA, which
// fuses it. In PyTorch the eager fuse (models/litehrnet.py StageModule) is a
// doubling, one nearest upsample and one add per coarser branch, one add per
// finer branch and a ReLU, each a full-resolution pass over device memory;
// under CUDA autocast every upsample is float32, so most of those passes are
// float32 too.
//
// For output branch i of an n-branch module, terms t_0 .. t_{n-1} (n <= 4)
// of C channels at the output's resolution (H, W) or at 1 / 2^s of it, it
// computes
//   s = ((2 t_0 + up(t_1)) + up(t_2)) + ... + up(t_{n-1}),  out = relu(s)
// with up(t)[h, w] = t[h >> s, w >> s] (nearest-exact upsampling by 2^s), and
// writes out and, where asked, s. It gives PyTorch's eager ops bit for bit:
// the partial sum is kept in float32 registers and, after the doubling and
// after each add, rounded to the dtype PyTorch's type promotion gives that
// op (bfloat16 while every term so far enters as bfloat16, round to nearest
// even, as ATen's bfloat16 add rounds its float32 sum; float32 once any term
// enters as float32). A term stored as bfloat16 may enter as float32, as an
// upsample under CUDA autocast hands it on; the wrapper says which
// (kernels/fuse_sum_relu.py).
//
// Bound: memory. Each term is read once at its own resolution, each output
// written once: Lite-HRNet-30's 42 rows of a batch of 512 move 22.6 GB,
// 6.74 ms at 3.35 TB/s.
//
// Design (the launch plan comes from kernels/fuse_sum_relu.py::plan):
// - Each tensor has one of two layouts, seen from its strides: channels
//   innermost (channels_last memory: the convolutions' outputs) or w
//   innermost (NCHW memory: the module's own inputs, which the channel
//   shuffle leaves contiguous, and row 0's outputs, which follow them). The
//   outputs take t_0's layout, as PyTorch's elementwise ops give them.
// - A work item is Q (4, 2 or 1) neighbouring pixels of one row times 8
//   channels: a thread reads a channels-innermost term as Q vectors of 8
//   channels (16 bytes of bfloat16, 32 of float32) and a w-innermost one as
//   8 vectors of Q pixels, and adds as it loads, so every access is a vector
//   and every thread keeps 8 Q partial sums.
// - Items run w fastest for a w-innermost output (row 0: its input and its
//   two outputs are 95% of its bytes) and channels fastest otherwise, so the
//   largest tensors are read and written in whole sectors. A coarse term's
//   vector is shared by the 2^s items of a tile and comes from L1 or L2
//   after its first read.
// - Blocks are persistent, two per SM, walking the items with a grid stride,
//   so the items in flight at any time are one contiguous stretch.
// No shared memory, no host synchronisation, no allocation, the caller's
// stream: the launch may be captured in a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 2;
constexpr int kMaxTerms = 4;
constexpr int kVec = 8;        // channels of an item
constexpr int kMaxShift = 7;   // coarsest term: 1 / 128 of the output

struct Term {
  const void* ptr;
  long long sn, sc, sh, sw;  // element strides
  int shift;                 // at 1 / 2^shift of the output's H and W
  int bf16;                  // stored as bfloat16, else float32
  int w_inner;               // w innermost (sw == 1), else channels (sc == 1)
};

struct Row {
  Term t[kMaxTerms];
  int nterms, N, C, H, W;
  int out_bf16;    // the outputs' dtype
  int bf16_steps;  // bit j: the sum after term j is bfloat16
  int items;       // N * H * (W / Q) * (C / kVec)
  void* out;       // relu(s)
  void* sum;       // s, or null
};

__device__ __forceinline__ void unpack2(uint32_t w, float* v) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  // a and b are bfloat16 values already: the upper halves are exact
  return (__float_as_uint(a) >> 16) | (__float_as_uint(b) & 0xffff0000u);
}

// 8 channels of one pixel of a channels-innermost tensor
__device__ __forceinline__ void load_c8(const void* base, long long off,
                                        int bf16, float (&v)[kVec]) {
  if (bf16) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(base) + off));
    unpack2(r.x, v); unpack2(r.y, v + 2); unpack2(r.z, v + 4);
    unpack2(r.w, v + 6);
  } else {
    const float4* p = reinterpret_cast<const float4*>(
        static_cast<const float*>(base) + off);
    const float4 a = __ldg(p), b = __ldg(p + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
}

// Q neighbouring pixels of one channel of a w-innermost tensor
template <int Q>
__device__ __forceinline__ void load_wq(const void* base, long long off,
                                        int bf16, float (&v)[Q]) {
  if (bf16) {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(base) + off;
    if constexpr (Q == 4) {
      const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
      unpack2(r.x, v); unpack2(r.y, v + 2);
    } else if constexpr (Q == 2) {
      unpack2(__ldg(reinterpret_cast<const unsigned int*>(p)), v);
    } else {
      v[0] = __uint_as_float(static_cast<uint32_t>(
          __ldg(reinterpret_cast<const unsigned short*>(p))) << 16);
    }
  } else {
    const float* p = static_cast<const float*>(base) + off;
    if constexpr (Q == 4) {
      const float4 r = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
    } else if constexpr (Q == 2) {
      const float2 r = __ldg(reinterpret_cast<const float2*>(p));
      v[0] = r.x; v[1] = r.y;
    } else {
      v[0] = __ldg(p);
    }
  }
}

// acc[q][k] = (first ? 2 x : acc + x), rounded to bfloat16 where asked, for
// term t at output pixels (n, h, w0 + q) and channels c0 + k
template <int Q>
__device__ __forceinline__ void add_term(const Term& t, int n, int h, int w0,
                                         int c0, bool first, bool bf16_sum,
                                         float (&acc)[Q][kVec]) {
  if (t.w_inner) {  // at the output's resolution
    const long long base = n * t.sn + h * t.sh + w0 * t.sw;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      float v[Q];
      load_wq<Q>(t.ptr, base + (c0 + k) * t.sc, t.bf16, v);
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float s = first ? 2.0f * v[q] : acc[q][k] + v[q];
        acc[q][k] = bf16_sum ? round_bf16(s) : s;
      }
    }
  } else {
    const long long base = n * t.sn + (h >> t.shift) * t.sh + c0;
    float v[kVec];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      // pixels of one coarse pixel share its vector
      if (q == 0 || !(q & ((1 << t.shift) - 1))) {
        load_c8(t.ptr, base + ((w0 + q) >> t.shift) * t.sw, t.bf16, v);
      }
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float s = first ? 2.0f * v[k] : acc[q][k] + v[k];
        acc[q][k] = bf16_sum ? round_bf16(s) : s;
      }
    }
  }
}

// out[q][k] at output pixels (n, h, w0 + q), channels c0 + k, in the
// output's dtype and layout (dense); relu first where asked
template <int Q, bool W_INNER>
__device__ __forceinline__ void store(void* dst, int bf16, const Row& r,
                                      int n, int h, int w0, int c0, bool relu,
                                      const float (&acc)[Q][kVec]) {
  float v[Q][kVec];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float a = acc[q][k];
      // ATen's ReLU is clamp_min(x, 0): NaN stays NaN
      v[q][k] = relu ? (a > 0.0f || a != a ? a : 0.0f) : a;
    }
  }
  if constexpr (W_INNER) {
    const long long plane = static_cast<long long>(r.H) * r.W;
    const long long base = (static_cast<long long>(n) * r.C + c0) * plane +
                           static_cast<long long>(h) * r.W + w0;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const long long off = base + k * plane;
      if (bf16) {
        __nv_bfloat16* p = static_cast<__nv_bfloat16*>(dst) + off;
        if constexpr (Q == 4) {
          *reinterpret_cast<uint2*>(p) = make_uint2(
              pack2(v[0][k], v[1][k]), pack2(v[2][k], v[3][k]));
        } else if constexpr (Q == 2) {
          *reinterpret_cast<uint32_t*>(p) = pack2(v[0][k], v[1][k]);
        } else {
          *reinterpret_cast<unsigned short*>(p) =
              static_cast<unsigned short>(__float_as_uint(v[0][k]) >> 16);
        }
      } else {
        float* p = static_cast<float*>(dst) + off;
        if constexpr (Q == 4) {
          *reinterpret_cast<float4*>(p) =
              make_float4(v[0][k], v[1][k], v[2][k], v[3][k]);
        } else if constexpr (Q == 2) {
          *reinterpret_cast<float2*>(p) = make_float2(v[0][k], v[1][k]);
        } else {
          *p = v[0][k];
        }
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const long long off =
          ((static_cast<long long>(n) * r.H + h) * r.W + w0 + q) * r.C + c0;
      if (bf16) {
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(dst) + off) =
            make_uint4(pack2(v[q][0], v[q][1]), pack2(v[q][2], v[q][3]),
                       pack2(v[q][4], v[q][5]), pack2(v[q][6], v[q][7]));
      } else {
        float4* p = reinterpret_cast<float4*>(static_cast<float*>(dst) + off);
        p[0] = make_float4(v[q][0], v[q][1], v[q][2], v[q][3]);
        p[1] = make_float4(v[q][4], v[q][5], v[q][6], v[q][7]);
      }
    }
  }
}

template <int Q, bool W_INNER>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    fuse_sum_relu_kernel(const Row r) {
  const int cvs = r.C / kVec, wqs = r.W / Q;
  for (int item = blockIdx.x * kThreads + threadIdx.x; item < r.items;
       item += gridDim.x * kThreads) {
    int cv, wq, h, n;
    if constexpr (W_INNER) {  // w, h, channels, image
      wq = item % wqs;
      int rest = item / wqs;
      h = rest % r.H;
      rest /= r.H;
      cv = rest % cvs;
      n = rest / cvs;
    } else {                  // channels, w, h, image
      cv = item % cvs;
      int rest = item / cvs;
      wq = rest % wqs;
      rest /= wqs;
      h = rest % r.H;
      n = rest / r.H;
    }
    const int w0 = wq * Q, c0 = cv * kVec;
    float acc[Q][kVec];
    add_term<Q>(r.t[0], n, h, w0, c0, true, r.bf16_steps & 1, acc);
#pragma unroll
    for (int j = 1; j < kMaxTerms; ++j) {
      if (j < r.nterms) {
        add_term<Q>(r.t[j], n, h, w0, c0, false, (r.bf16_steps >> j) & 1,
                    acc);
      }
    }
    if (r.sum != nullptr) {
      store<Q, W_INNER>(r.sum, r.out_bf16, r, n, h, w0, c0, false, acc);
    }
    store<Q, W_INNER>(r.out, r.out_bf16, r, n, h, w0, c0, true, acc);
  }
}

template <int Q>
cudaError_t launch(const Row& r, bool w_inner, int grid, cudaStream_t s) {
  if (w_inner) {
    fuse_sum_relu_kernel<Q, true><<<grid, kThreads, 0, s>>>(r);
  } else {
    fuse_sum_relu_kernel<Q, false><<<grid, kThreads, 0, s>>>(r);
  }
  return cudaGetLastError();
}

}  // namespace

// The launch plan of kernels/fuse_sum_relu.py::plan, one int64 each, in this
// order (kernels/fuse_sum_relu.py PLAN_FIELDS): the row, then kTermFields
// for each of kMaxTerms terms.
enum Plan {
  kN, kC, kH, kW, kQ, kTerms, kOutBf16, kOutWInner, kBf16Steps, kGridX,
  kTermsAt
};
enum TermPlan { kBf16, kWInner, kShift, kSn, kSc, kSh, kSw, kTermFields };
constexpr int kPlanFields = kTermsAt + kMaxTerms * kTermFields;

extern "C" int lhn_fsr_plan_fields() { return kPlanFields; }

extern "C" int lhn_fsr_threads() { return kThreads; }

// terms: nterms pointers (the rest null), each [N, C, H >> shift,
// W >> shift] with the element strides and layout the plan gives (16-byte
// aligned); out and sum (null: not written): [N, C, H, W], dense, in the
// plan's dtype (0 float32, 1 bfloat16) and layout (1 NCHW, 0 NHWC). One
// launch on `stream`; returns its CUDA error (0 if none).
extern "C" int lhn_fuse_sum_relu(const void* t0, const void* t1,
                                 const void* t2, const void* t3, void* out,
                                 void* sum, const long long* plan,
                                 void* stream) {
  const void* ptrs[kMaxTerms] = {t0, t1, t2, t3};
  Row r{};
  r.N = static_cast<int>(plan[kN]);
  r.C = static_cast<int>(plan[kC]);
  r.H = static_cast<int>(plan[kH]);
  r.W = static_cast<int>(plan[kW]);
  r.nterms = static_cast<int>(plan[kTerms]);
  r.out_bf16 = static_cast<int>(plan[kOutBf16]);
  r.bf16_steps = static_cast<int>(plan[kBf16Steps]);
  r.out = out;
  r.sum = sum;
  const int q = static_cast<int>(plan[kQ]);
  const int grid = static_cast<int>(plan[kGridX]);
  if (r.N < 1 || r.C < kVec || r.C % kVec != 0 || r.H < 1 || r.W < 1 ||
      (q != 1 && q != 2 && q != 4) || r.W % q != 0 || r.nterms < 1 ||
      r.nterms > kMaxTerms || grid < 1 || out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long items = static_cast<long long>(r.N) * r.H * (r.W / q) *
                          (r.C / kVec);
  if (items >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  r.items = static_cast<int>(items);
  for (int j = 0; j < kMaxTerms; ++j) {
    const long long* f = plan + kTermsAt + j * kTermFields;
    Term& t = r.t[j];
    if (j >= r.nterms) continue;
    t.ptr = ptrs[j];
    t.bf16 = static_cast<int>(f[kBf16]);
    t.w_inner = static_cast<int>(f[kWInner]);
    t.shift = static_cast<int>(f[kShift]);
    t.sn = f[kSn]; t.sc = f[kSc]; t.sh = f[kSh]; t.sw = f[kSw];
    if (t.ptr == nullptr || t.shift < 0 || t.shift > kMaxShift ||
        (t.w_inner && t.shift != 0) ||
        r.H % (1 << t.shift) != 0 || r.W % (1 << t.shift) != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool w_inner = plan[kOutWInner] != 0;
  cudaError_t err;
  switch (q) {
    case 4: err = launch<4>(r, w_inner, grid, s); break;
    case 2: err = launch<2>(r, w_inner, grid, s); break;
    default: err = launch<1>(r, w_inner, grid, s); break;
  }
  return static_cast<int>(err);
}
