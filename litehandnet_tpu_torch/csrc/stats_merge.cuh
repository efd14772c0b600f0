// Per-channel batch statistics (count, mean, M2) merged by Chan's parallel
// update in a fixed order, inside one launch. Shared by moments.cu and
// dw_conv3x3_stats.cu.
//
// Each thread of a 256-thread block owns V channels ("lane") of one "slot"
// (a set of rows or pixels). It folds its values into running statistics
// (fold_values), the block merges its slots by a fixed tree in shared memory
// (block_merge), and finish() writes the block's partial to scratch. The
// last block of a channel group to take the group's ticket merges all
// partials in a fixed order and writes mean and biased variance. No float
// atomics: the same input gives the same bits on every run.
//
// Chan's update, as the JAX kernel (litehandnet_tpu/ops/fused_bn.py:53-79):
//   tot = na + nb, delta = mean_b - mean_a,
//   mean = mean_a + delta * nb / tot, M2 = M2a + M2b + delta^2 * na nb / tot.
// Counts are doubles, exact far above 2^24. Every float operation is an
// explicit round-to-nearest intrinsic, so no contraction choice of the
// compiler can make two instantiations of the same arithmetic differ.

#pragma once

#include <cuda_runtime.h>

namespace lhn {

constexpr int kThreads = 256;

template <int V>
struct Stats {
  double n;
  float mean[V];
  float m2[V];
};

template <int V>
__device__ __forceinline__ void zero(Stats<V>& s) {
  s.n = 0.0;
#pragma unroll
  for (int e = 0; e < V; ++e) s.mean[e] = s.m2[e] = 0.f;
}

// s <- s merged with (nb, mean_b, m2b); a part with no values is skipped.
template <int V>
__device__ __forceinline__ void chan_merge(Stats<V>& s, double nb,
                                           const float (&mean_b)[V],
                                           const float (&m2b)[V]) {
  if (nb == 0.0) return;
  const double tot = s.n + nb;
  const double rb = nb / tot;
  const float fb = static_cast<float>(rb);
  const float fab = static_cast<float>(s.n * rb);
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float delta = __fsub_rn(mean_b[e], s.mean[e]);
    s.mean[e] = __fmaf_rn(delta, fb, s.mean[e]);
    s.m2[e] = __fmaf_rn(__fmul_rn(delta, delta), fab,
                        __fadd_rn(s.m2[e], m2b[e]));
  }
  s.n = tot;
}

// Folds v[0..cnt) (cnt <= U values per channel) into s: their exact
// two-pass mean and M2, then Chan's update. Never E[x^2] - E[x]^2.
template <int U, int V>
__device__ __forceinline__ void fold_values(Stats<V>& s,
                                            const float (&v)[U][V], int cnt) {
  if (cnt <= 0) return;
  const float inv = __frcp_rn(static_cast<float>(cnt));
  float mean[V], m2[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if (k < cnt) sum = __fadd_rn(sum, v[k][e]);
    }
    mean[e] = __fmul_rn(sum, inv);
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const float d = __fsub_rn(v[k][e], mean[e]);
      if (k < cnt) acc = __fmaf_rn(d, d, acc);
    }
    m2[e] = acc;
  }
  chan_merge(s, static_cast<double>(cnt), mean, m2);
}

// Shared memory of block_merge: kThreads x V floats twice, kThreads doubles.
template <int V>
struct MergeSmem {
  double n[kThreads];
  float mean[kThreads * V];
  float m2[kThreads * V];
};

template <int V>
__device__ __forceinline__ void put(MergeSmem<V>& sm, int t,
                                    const Stats<V>& s) {
  sm.n[t] = s.n;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    sm.mean[t * V + e] = s.mean[e];
    sm.m2[t * V + e] = s.m2[e];
  }
}

// Merges the block's slots into slot 0 by a fixed tree: at each level slot
// i < half takes slot i + half. Thread t = slot * lanes + lane; slots is a
// power of two and slots * lanes == kThreads. Every thread calls it; on
// return the threads of slot 0 hold the block's statistics.
template <int V>
__device__ void block_merge(Stats<V>& s, int lane, int slot, int lanes,
                            int slots, MergeSmem<V>& sm) {
  const int t = slot * lanes + lane;
  put(sm, t, s);
  __syncthreads();
  for (int half = slots >> 1; half >= 1; half >>= 1) {
    if (slot < half) {
      const int o = t + half * lanes;
      float mean_b[V], m2b[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        mean_b[e] = sm.mean[o * V + e];
        m2b[e] = sm.m2[o * V + e];
      }
      chan_merge(s, sm.n[o], mean_b, m2b);
      put(sm, t, s);
    }
    __syncthreads();
  }
}

// Where a block's partial goes: group g (a set of `width` channels starting
// at channel c0 of the group) has `parts` blocks; block b's partial is
// n[g * parts + b] and mean / m2[(g * parts + b) * width + channel].
struct Partials {
  unsigned* tickets;  // one per group, 0 between launches
  double* n;
  float* mean;
  float* m2;
};

// After block_merge: slot 0 writes the block's partial; the last block of
// the group to take its ticket merges all `parts` partials in a fixed
// order (slot i takes partials i, i + slots, ... in turn, then the tree),
// writes mean[c] and var[c] = M2 / n for the group's channels below C, and
// resets the ticket. Every thread calls it.
template <int V>
__device__ void finish(Stats<V>& s, int lane, int slot, int lanes, int slots,
                       int group, int block, int parts, int width, int c0,
                       int C, const Partials& p, MergeSmem<V>& sm,
                       float* __restrict__ mean_out,
                       float* __restrict__ var_out) {
  __shared__ bool s_last;
  const long long base = static_cast<long long>(group) * parts;
  if (slot == 0) {
    float* pm = p.mean + (base + block) * width + lane * V;
    float* pv = p.m2 + (base + block) * width + lane * V;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      pm[e] = s.mean[e];
      pv[e] = s.m2[e];
    }
    if (lane == 0) p.n[base + block] = s.n;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(&p.tickets[group], 1u) == static_cast<unsigned>(parts - 1);
  }
  __syncthreads();
  if (!s_last) return;

  // partials slot, slot + slots, ... in that order, kBatch loads in flight
  constexpr int kBatch = 32 / V;
  Stats<V> r;
  zero(r);
  for (int q0 = slot; q0 < parts; q0 += kBatch * slots) {
    double nb[kBatch];
    float mean_b[kBatch][V], m2b[kBatch][V];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int q = q0 + b * slots;
      const bool ok = q < parts;
      const float* pm = p.mean + (base + q) * width + lane * V;
      const float* pv = p.m2 + (base + q) * width + lane * V;
      nb[b] = ok ? __ldcg(p.n + base + q) : 0.0;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        mean_b[b][e] = ok ? __ldcg(pm + e) : 0.f;
        m2b[b][e] = ok ? __ldcg(pv + e) : 0.f;
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) chan_merge(r, nb[b], mean_b[b], m2b[b]);
  }
  block_merge(r, lane, slot, lanes, slots, sm);
  if (slot == 0) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int c = c0 + lane * V + e;
      if (c < C) {
        mean_out[c] = r.mean[e];
        var_out[c] = static_cast<float>(r.m2[e] / r.n);
      }
    }
  }
  if (threadIdx.x == 0) p.tickets[group] = 0u;
}

}  // namespace lhn
