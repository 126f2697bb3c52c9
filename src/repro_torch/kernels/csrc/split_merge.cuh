// The epilogue of the decode-attention kernels that split a row's keys
// across CTAs and merge the splits in the same launch (paged decode,
// paged_decode_attention.cu, and dense decode, decode_attention.cu).
//
// A unit is one (slot, KV head, head part): n_splits CTAs along the row's
// keys. Only the first n_live splits hold keys of the slot; each kernel
// places them (kernel 1 at fixed edges of split_keys keys, kernel 3 from
// the slot's length), the same in every CTA of the unit. A CTA past them
// returns at once, before touching the scratch or the ticket. Each CTA's
// result for a head gi and a head_dim index d is its running max m, its sum
// l and its unnormalised float32 accumulator. The epilogue:
//   * n_live <= 1: split 0 alone holds the unit's keys (or none: it writes 0)
//     and writes acc / max(l, 1e-30) straight to the output;
//   * otherwise every live CTA writes its partial to the scratch, fences
//     (after a block barrier, so thread 0's release fence publishes every
//     thread's writes) and takes a ticket from the unit's int32 counter;
//     the CTA that takes ticket n_live - 1 merges the partials in split
//     order (an online merge per element, so two calls give the same bits)
//     and resets the counter to 0. No second kernel and no allocation per
//     call.
//
// Scratch layout (float32): acc [units][n_splits][GC][D], then (m, l)
// [units][n_splits][GC][2]; counters [units] int32, 0 between launches.
#pragma once

#include "common.cuh"

namespace repro_torch {

struct SplitScratch {
  float* part;
  int* counters;
};

// What a CTA's result is for one (head, dim) element.
struct SplitResult {
  float m, l, acc;
};

// Called by every thread of a CTA with split < max(n_live, 1), after the
// CTA's own result is readable through cta(gi, d) -> SplitResult for every
// gi < n_heads and d < D. GC (n_heads <= GC <= MAXH) is the heads a unit's
// partial holds in the scratch; `out` points at the unit's first head.
template <int THREADS, int MAXH, int D, typename T, typename CtaResult>
__device__ __forceinline__ void split_epilogue(const SplitScratch& sc, int unit, int n_units,
                                               int split, int n_splits, int n_live, int GC,
                                               int n_heads, T* out, long long o_sh,
                                               CtaResult cta) {
  static_assert(D % 4 == 0, "the merge reads float4 vectors");
  const int tid = threadIdx.x;
  if (n_live <= 1) {
    for (int i = tid; i < n_heads * D; i += THREADS) {
      const int gi = i / D, d = i % D;
      const SplitResult r = cta(gi, d);
      store_f(out + gi * o_sh + d, r.acc / fmaxf(r.l, 1e-30f));
    }
    return;
  }
  float* acc_part = sc.part + (long long)unit * n_splits * GC * D;
  float* ml_part = sc.part + (long long)n_units * n_splits * GC * D +
                   (long long)unit * n_splits * GC * 2;
  for (int i = tid; i < n_heads * D; i += THREADS) {
    const int gi = i / D, d = i % D;
    const SplitResult r = cta(gi, d);
    acc_part[(split * GC + gi) * D + d] = r.acc;
    if (d == 0) {
      ml_part[(split * GC + gi) * 2] = r.m;
      ml_part[(split * GC + gi) * 2 + 1] = r.l;
    }
  }

  // ticket: the CTA that finishes last merges every live split of the unit.
  // The barrier orders every thread's partial before thread 0's release
  // fence, which publishes them with the ticket; thread 0's acquire fence
  // after the ticket orders the last CTA's reads (after the barrier) behind
  // every other CTA's partial (as CUTLASS's inter-CTA barrier does).
  __shared__ int last_s;
  __syncthreads();
  if (tid == 0) {
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    const bool last = atomicAdd(sc.counters + unit, 1) == n_live - 1;
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    last_s = last;
  }
  __syncthreads();
  if (!last_s) return;
  // each thread merges up to E float4 elements of (head, dim), SB splits at
  // a time: the loads of a batch (E x SB float4 and (m, l) pairs, clamped
  // to the last live split) are all issued before any is used, so the merge
  // takes ceil(n_live / SB) round trips to L2. E x SB is 4096 / THREADS
  // loads, registers the kernel's key loop no longer holds.
  constexpr int D4 = D / 4;
  constexpr int E = (MAXH * D4 + THREADS - 1) / THREADS;
  constexpr int SB = 4096 / THREADS > E ? 4096 / THREADS / E : 1;
  const int n_el = n_heads * D4;
  const float4* acc4 = reinterpret_cast<const float4*>(acc_part);
  const float2* ml2 = reinterpret_cast<const float2*>(ml_part);
  float m[E], l[E];
  float4 a[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    m[e] = -CUDART_INF_F;
    l[e] = 0.f;
    a[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int s0 = 0; s0 < n_live; s0 += SB) {
    float2 ms[SB][E];
    float4 x[SB][E];
#pragma unroll
    for (int u = 0; u < SB; ++u) {
      const int s = min(s0 + u, n_live - 1);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int i = min(tid + e * THREADS, n_el - 1);   // past the last: a valid address, unused
        ms[u][e] = __ldcg(ml2 + s * GC + i / D4);
        x[u][e] = __ldcg(acc4 + (s * GC + i / D4) * D4 + i % D4);
      }
    }
#pragma unroll
    for (int u = 0; u < SB; ++u)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        // a split with no valid key (m = -inf: every key of it masked) adds nothing
        if (s0 + u < n_live && ms[u][e].x != -CUDART_INF_F) {
          const float mn = fmaxf(m[e], ms[u][e].x);
          const float c = expf(m[e] - mn);          // 0 while m was -inf
          const float w = expf(ms[u][e].x - mn);
          l[e] = l[e] * c + ms[u][e].y * w;
          a[e].x = a[e].x * c + x[u][e].x * w;
          a[e].y = a[e].y * c + x[u][e].y * w;
          a[e].z = a[e].z * c + x[u][e].z * w;
          a[e].w = a[e].w * c + x[u][e].w * w;
          m[e] = mn;
        }
      }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = tid + e * THREADS;
    if (i >= n_el) break;
    const float lt = fmaxf(l[e], 1e-30f);
    T* o = out + (i / D4) * o_sh + (i % D4) * 4;
    store_f(o, a[e].x / lt);
    store_f(o + 1, a[e].y / lt);
    store_f(o + 2, a[e].z / lt);
    store_f(o + 3, a[e].w / lt);
  }
  if (tid == 0) sc.counters[unit] = 0;
}

}  // namespace repro_torch
