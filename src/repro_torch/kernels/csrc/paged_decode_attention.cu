// Paged decode attention for Hopper (sm_90a), CUDA C++.
//
// Replaces: the Pallas TPU kernel
//   src/repro/kernels/paged_decode_attention.py :: paged_decode_attention
//   (body _paged_decode_kernel), whose oracle is
//   src/repro/kernels/ref.py :: paged_decode_attention_ref.
//
// What it computes: one query token per slot against that slot's pages of a
// (KV, P, page_size, D) pool, addressed through a (B, MB) int32 block table
// (-1 = unallocated). GQA: the g = H / KV query heads of one KV head share
// each K/V load. float32 online softmax; tokens at or past lengths[b] and
// tokens on -1 pages are masked and never loaded; a slot with no valid key
// (an idle decode lane) writes 0, as the Pallas kernel does (max(l, 1e-30)).
//
// What bounds it on an H100: bytes. Each slot's live K and V are read once
// (len x D x 2 bytes per head in bf16) and there are only 2 x g x D flops
// per loaded K/V element pair, far below the ~295 flops/byte where the
// tensor cores would become the limit (and g = 4 query rows are too few to
// feed them). At the serving shapes (8 slots x 8 KV heads, up to 640 keys)
// the whole read is ~7 MB, about 2 microseconds at full bandwidth, so what
// decides the time is how many bytes are in flight at once and how many
// SMs carry them. The design:
//   * flash-decoding: the grid is (split, KV head x head part, slot); the
//     split count and the keys a split covers come from shapes alone (the
//     wrapper's decode_plan: about one and a half CTAs an SM, never more
//     splits than 32-key tiles), so lengths are never read on the host. A
//     split past its slot's live keys (the length, cut at the table's end)
//     returns at once;
//   * merge in the same launch (split_merge.cuh, shared with kernel 3): each
//     live CTA writes its partial (m, l and the unnormalised float32
//     accumulator) to a scratch buffer the wrapper allocates once per
//     device and size, fences, and takes a ticket from an int32 counter per
//     (slot, KV head, head part); the CTA that takes the last ticket merges
//     the partials in split order (bit-identical from call to call) and
//     resets the counter to 0. A slot whose keys fit one split writes its
//     output directly. No second kernel, no allocation per call;
//   * inside a CTA, the CUDA-core key loop of kernel 3 (decode_attention.cu):
//     each of 16 warps takes every 16th warp step of the split's keys, each
//     key group of LPK lanes one key, each lane a DPL-wide slice of
//     head_dim; every key group keeps its own online-softmax state for the
//     CTA's heads in registers, and the groups and warps merge once at the
//     end, so the key loop has no block barrier;
//   * K/V arrive through a cp.async ring per lane, kept in their own dtype
//     in shared memory (each lane reads back only the bytes it copied, so
//     the ring needs no barrier either): with 16 warps and 4 stages at the
//     serving shape (one 16-byte K and V vector a lane a step), 128 keys
//     are in flight at once, over half of a split of 3 (224 keys), without
//     the registers that loads straight into registers would hold;
//   * a group of more than 8 query heads is split into head parts of at
//     most 8 (a grid axis reading the same keys), the register shape of
//     g = 8.
#include "common.cuh"
#include "split_merge.cuh"

namespace repro_torch {

constexpr int kPdWarps = 16;
constexpr int kPdThreads = 32 * kPdWarps;

struct DecodeArgs {
  const void* q;        // (B, 1, H, D) bshk
  const void* k;        // (KV, P, bs, D) one layer's pool (any KV / page strides)
  const void* v;
  const int* tables;    // (B, MB) int32, contiguous
  const int* lengths;   // (B,) int32
  void* out;            // (B, 1, H, D)
  float* part;          // split partials: acc [U][S][GC][D], then (m, l) [U][S][GC]
  int* counters;        // [U] tickets, 0 between launches
  int g, page_size, mb, n_splits, split_keys, parts;
  long long q_sb, q_sh, o_sb, o_sh;
  long long k_skv, k_sp, v_skv, v_sp;
  float scale;
};

// How one warp covers the keys for element type T, head_dim D and GC query
// heads a CTA (as kernel 3): DPL dims per lane (at least one 16-byte
// vector, at least D / 32, and GC x DPL <= 32 floats of accumulator and at
// most 16 dims where D allows), LPK lanes per key, KPW keys per warp step,
// NVEC 16-byte vectors per lane per row.
template <typename T, int D, int GC>
struct PdShape {
  static constexpr int VEC = Vec<T>::kElems;
  static constexpr int CAP = 32 / GC < 16 ? 32 / GC : 16;
  static constexpr int WANT = CAP < D ? CAP : D;
  static constexpr int FIT = D / 32 > VEC ? D / 32 : VEC;
  static constexpr int DPL = WANT > FIT ? WANT : FIT;
  static constexpr int LPK = D / DPL;
  static constexpr int KPW = 32 / LPK;
  static constexpr int NVEC = DPL / VEC;
  // ring stages: 4 warp steps in flight where a lane's step is one 16-byte
  // vector of K and of V, fewer for wider slices (at least 2; at most
  // 64 KB of ring for the CTA's 16 warps)
  static constexpr int STAGES = 4 / NVEC > 2 ? 4 / NVEC : 2;
  static_assert(D % DPL == 0 && 32 % LPK == 0, "lane layout must tile the warp");
};

template <typename T, int D, int GC>
constexpr size_t pd_smem_bytes() {
  using Sh = PdShape<T, D, GC>;
  return sizeof(uint4) * Sh::STAGES * 2 * Sh::NVEC * kPdThreads +
         sizeof(float) * kPdWarps * GC * (D + 2);
}

template <typename T, int D, int GC>
__global__ void __launch_bounds__(kPdThreads)
paged_decode_kernel(DecodeArgs a) {
  using Sh = PdShape<T, D, GC>;
  constexpr int VEC = Sh::VEC, DPL = Sh::DPL, LPK = Sh::LPK, KPW = Sh::KPW, NVEC = Sh::NVEC;
  constexpr int NS = Sh::STAGES;
  constexpr unsigned kFull = 0xffffffffu;
  extern __shared__ uint4 pd_smem[];
  uint4* ring = pd_smem;                                        // [NS][2 NVEC][threads]
  float* m_s = reinterpret_cast<float*>(ring + NS * 2 * NVEC * kPdThreads);  // [warps][GC]
  float* l_s = m_s + kPdWarps * GC;                             // [warps][GC]
  float* acc_s = l_s + kPdWarps * GC;                           // [warps][GC][D]
  int* table_s = reinterpret_cast<int*>(acc_s + kPdWarps * GC * D);   // the split's pages

  const int split = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / a.parts, part = blockIdx.y % a.parts;
  const int unit = b * gridDim.y + blockIdx.y;
  const int head0 = part * GC;                 // first head of the group in this CTA
  const int n_heads = min(GC, a.g - head0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kg = lane / LPK, d0 = (lane % LPK) * DPL;
  const int S = a.n_splits;
  const int k0 = split * a.split_keys;

  // the slot's length, this split's block-table entries and the query are
  // independent reads: all are issued before any is waited on
  const int len = a.lengths[b];
  const int blk0 = k0 / a.page_size;
  const int n_blk = min(a.mb, (k0 + a.split_keys + a.page_size - 1) / a.page_size) - blk0;
  const int* trow = a.tables + (long long)b * a.mb + blk0;
  for (int i = tid; i < n_blk; i += kPdThreads) table_s[i] = trow[i];
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + (long long)(kvh * a.g + head0) * a.q_sh;
  float qr[GC][DPL];
#pragma unroll
  for (int gi = 0; gi < GC; ++gi)
#pragma unroll
    for (int d = 0; d < DPL; ++d)
      qr[gi][d] = gi < n_heads ? load_f(q + gi * a.q_sh + d0 + d) * a.scale : 0.f;
  // keys past the block table's last page are masked, whatever the length;
  // a split past the slot's live keys has nothing to add to the merge
  const int live = max(0, min(len, a.mb * a.page_size));
  const int n_live = (live + a.split_keys - 1) / a.split_keys;
  if (split >= max(n_live, 1)) return;
  const int k1 = min(live, k0 + a.split_keys);

  float m[GC], l[GC], acc[GC][DPL];
#pragma unroll
  for (int gi = 0; gi < GC; ++gi) {
    m[gi] = -CUDART_INF_F;
    l[gi] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[gi][d] = 0.f;
  }

  if (k0 < k1) {
    const T* kb = static_cast<const T*>(a.k) + kvh * a.k_skv + d0;
    const T* vb = static_cast<const T*>(a.v) + kvh * a.v_skv + d0;
    __syncthreads();   // table_s

    // element offset of token t in the pool (-1: masked, never loaded)
    auto offset = [&](int t, long long page_stride) -> long long {
      if (t >= k1) return -1;
      const int page = table_s[t / a.page_size - blk0];
      return page >= 0 ? page * page_stride + (long long)(t % a.page_size) * D : -1;
    };
    // warp step s of this warp covers keys k0 + (s * warps + warp) * KPW + [0, KPW)
    const int n_steps = (k1 - k0 + kPdWarps * KPW - 1) / (kPdWarps * KPW);
    auto issue = [&](int s) {
      const int t = k0 + (s * kPdWarps + warp) * KPW + kg;
      const long long ko = offset(t, a.k_sp), vo = offset(t, a.v_sp);
      uint4* st = ring + (s % NS) * 2 * NVEC * kPdThreads + tid;
#pragma unroll
      for (int e = 0; e < NVEC; ++e) {
        cp_async16(smem_addr(st + e * kPdThreads), ko >= 0 ? kb + ko + e * VEC : kb, ko >= 0);
        cp_async16(smem_addr(st + (NVEC + e) * kPdThreads), vo >= 0 ? vb + vo + e * VEC : vb, vo >= 0);
      }
    };
#pragma unroll
    for (int s = 0; s < NS - 1; ++s) {
      if (s < n_steps) issue(s);
      cp_async_commit();
    }
    // t is the same for the LPK lanes of a key group, and the step count the
    // same for every lane of the warp, so the shuffles below run converged
    for (int s = 0; s < n_steps; ++s) {
      cp_async_wait<NS - 2>();               // step s has landed (this lane's copies)
      const int t = k0 + (s * kPdWarps + warp) * KPW + kg;
      const bool valid = offset(t, a.k_sp) >= 0;
      const uint4* st = ring + (s % NS) * 2 * NVEC * kPdThreads + tid;
      float kf[DPL], vf[DPL];
#pragma unroll
      for (int e = 0; e < NVEC; ++e) {
        unpack_vec<T>(st[e * kPdThreads], kf + e * VEC);
        unpack_vec<T>(st[(NVEC + e) * kPdThreads], vf + e * VEC);
      }
      // the stage read above was consumed into registers; refill the oldest
      if (s + NS - 1 < n_steps) issue(s + NS - 1);
      cp_async_commit();
      float sc[GC];
#pragma unroll
      for (int gi = 0; gi < GC; ++gi) {
        float x = 0.f;
#pragma unroll
        for (int d = 0; d < DPL; ++d) x = fmaf(qr[gi][d], kf[d], x);
        sc[gi] = x;
      }
#pragma unroll
      for (int o = LPK / 2; o > 0; o >>= 1)
#pragma unroll
        for (int gi = 0; gi < GC; ++gi) sc[gi] += __shfl_xor_sync(kFull, sc[gi], o);
      if (valid) {
#pragma unroll
        for (int gi = 0; gi < GC; ++gi) {
          const float m_new = fmaxf(m[gi], sc[gi]);
          const float corr = expf(m[gi] - m_new);   // 0 while m was -inf
          const float p = expf(sc[gi] - m_new);
          l[gi] = l[gi] * corr + p;
          m[gi] = m_new;
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[gi][d] = fmaf(p, vf[d], acc[gi][d] * corr);
        }
      }
    }
    cp_async_wait<0>();
  }

  // merge the warp's key groups (lanes LPK, 2 LPK, ... apart), then the warps
#pragma unroll
  for (int gi = 0; gi < GC; ++gi) {
    float mw = m[gi];
#pragma unroll
    for (int o = LPK; o < 32; o <<= 1) mw = fmaxf(mw, __shfl_xor_sync(kFull, mw, o));
    const float sc = mw == -CUDART_INF_F ? 0.f : expf(m[gi] - mw);
    float lw = l[gi] * sc;
#pragma unroll
    for (int o = LPK; o < 32; o <<= 1) lw += __shfl_xor_sync(kFull, lw, o);
#pragma unroll
    for (int d = 0; d < DPL; ++d) {
      float x = acc[gi][d] * sc;
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1) x += __shfl_xor_sync(kFull, x, o);
      acc[gi][d] = x;
    }
    m[gi] = mw;
    l[gi] = lw;
  }
  if (kg == 0) {
#pragma unroll
    for (int gi = 0; gi < GC; ++gi) {
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc_s[(warp * GC + gi) * D + d0 + d] = acc[gi][d];
      if (lane == 0) {
        m_s[warp * GC + gi] = m[gi];
        l_s[warp * GC + gi] = l[gi];
      }
    }
  }
  __syncthreads();

  T* out = static_cast<T*>(a.out) + b * a.o_sb + (long long)(kvh * a.g + head0) * a.o_sh;
  split_epilogue<kPdThreads, GC, D>(
      SplitScratch{a.part, a.counters}, unit, gridDim.z * gridDim.y, split, S, n_live, GC, n_heads,
      out, a.o_sh, [&](int gi, int d) {
        // merge the CTA's warps
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int w = 0; w < kPdWarps; ++w) mx = fmaxf(mx, m_s[w * GC + gi]);
        float lt = 0.f, at = 0.f;
#pragma unroll
        for (int w = 0; w < kPdWarps; ++w) {
          const float sc = mx == -CUDART_INF_F ? 0.f : expf(m_s[w * GC + gi] - mx);
          lt += l_s[w * GC + gi] * sc;
          at += acc_s[(w * GC + gi) * D + d] * sc;
        }
        return SplitResult{mx, lt, at};
      });
}

template <typename T, int D, int GC>
static int launch(const DecodeArgs& a, int B, int KV, cudaStream_t stream) {
  const size_t smem = pd_smem_bytes<T, D, GC>() + sizeof(int) * (a.split_keys / a.page_size + 2);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, D, GC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  paged_decode_kernel<T, D, GC><<<dim3(a.n_splits, KV * a.parts, B), kPdThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
static int dispatch_gc(const DecodeArgs& a, int B, int KV, int GC, cudaStream_t s) {
  switch (GC) {
    case 1: return launch<T, D, 1>(a, B, KV, s);
    case 2: return launch<T, D, 2>(a, B, KV, s);
    case 4: return launch<T, D, 4>(a, B, KV, s);
    case 8: return launch<T, D, 8>(a, B, KV, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int dispatch_d(const DecodeArgs& a, int B, int KV, int D, int GC, cudaStream_t s) {
  switch (D) {
    case 16: return dispatch_gc<T, 16>(a, B, KV, GC, s);
    case 32: return dispatch_gc<T, 32>(a, B, KV, GC, s);
    case 64: return dispatch_gc<T, 64>(a, B, KV, GC, s);
    case 128: return dispatch_gc<T, 128>(a, B, KV, GC, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro_torch

using namespace repro_torch;

// Returns cudaGetLastError() after the launch (0 = launched). The caller
// checks shapes, dtypes and contiguity and plans the launch
// (paged_decode_attention.py :: decode_plan): n_splits CTAs per (slot, KV
// head, head part), each over split_keys keys (together at least the
// table's mb x page_size), gc query heads a CTA (1, 2, 4 or 8,
// gc >= min(g, 8)), and, for n_splits > 1, a scratch of
// B x KV x parts x n_splits x gc x (D + 2) floats and B x KV x parts int32
// counters that are 0. g = H / KV must be at most 16.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k, const void* v, const void* tables,
    const void* lengths, void* out, void* part, void* counters, int B, int H,
    int KV, int D, int page_size, int mb, int n_splits, int split_keys, int gc,
    long long q_sb, long long q_sh, long long o_sb, long long o_sh,
    long long k_skv, long long k_sp, long long v_skv, long long v_sp,
    float scale, int dtype, void* stream) {
  if (KV <= 0 || H % KV != 0 || H / KV > 16 || n_splits < 1 || page_size < 1 ||
      split_keys < 1 || (long long)split_keys * n_splits < (long long)mb * page_size)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int g = H / KV;
  if (gc < (g < 8 ? g : 8) || (n_splits > 1 && (part == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  DecodeArgs a{q, k, v, static_cast<const int*>(tables),
               static_cast<const int*>(lengths), out, static_cast<float*>(part),
               static_cast<int*>(counters), g, page_size, mb, n_splits, split_keys,
               (g + gc - 1) / gc, q_sb, q_sh, o_sb, o_sh, k_skv, k_sp, v_skv, v_sp, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_d<float>(a, B, KV, D, gc, s);
  if (dtype == kBF16) return dispatch_d<__nv_bfloat16>(a, B, KV, D, gc, s);
  return (int)cudaErrorInvalidValue;
}
