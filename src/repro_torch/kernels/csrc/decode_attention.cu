// Decode attention over a dense KV cache for Hopper (sm_90a), CUDA C++.
//
// Replaces: the Pallas TPU kernel
//   src/repro/kernels/decode_attention.py :: decode_attention
//   (body _decode_kernel), whose oracle is
//   src/repro/kernels/ref.py :: decode_attention_ref.
// The serving path runs it on every decode round of the dense KV layout
// (full and ring caches), where the reference model calls
// models/attention.py :: attention over the whole cache row, and in every
// attention layer of RecurrentGemma's decode step (MQA: 16 query heads on
// one KV head, head_dim 256).
//
// What it computes: one query token per slot against that slot's cache row,
// q (B, H, D), k / v (B, KV, S, D) with any batch / head / token strides
// (the model passes its (B, S, KV, D) layer slice transposed, so the cache is
// never copied), GQA with the g = H / KV query heads of a KV head sharing
// every K/V load. Keys at positions >= lengths[b] are masked and never read;
// float32 online softmax; a slot with no valid key writes 0, as the Pallas
// kernel does (output divided by max(l, 1e-30)).
//
// What bounds it on an H100: bytes, and at the serving shapes the latency of
// reading them. Each live K and V element is read once and feeds 2 x g
// flops, far below the ~295 flops/byte where the tensor cores would become
// the limit; the whole read is 0.5-7 MB, one to two microseconds at full
// bandwidth, so what decides the time is how many SMs carry the keys, how
// many keys are in flight at once, and the chain of dependent steps around
// them. The design:
//   * split keys (split_merge.cuh, shared with kernel 1): the grid is
//     (split, KV head x head part, slot); the wrapper's plan picks the body,
//     the split count and the keys a split takes at the full row from
//     shapes alone. Each slot's split edges follow its length on the device
//     (split_range): about length / split_keys splits of equal whole
//     32-key tiles, so a row shorter than 1.5 x split_keys runs unsplit and
//     pays no merge. A split past them returns at once; the live splits
//     merge in the same launch (partials, ticket, the last CTA merges in
//     split order); a slot held by one split writes its output directly;
//   * the tensor-core body (dense_decode_tc; bf16 at head_dim 64/128/256,
//     both serving paths): the whole group of up to 16 query heads is one
//     CTA, the 16 rows of mma.sync.m16n8k16 (rows past g are zero; wgmma
//     needs 64 rows, which one decode token does not have), so every key is
//     read once. 32-key K/V tiles arrive through a cp.async ring in shared
//     memory, every stage in flight from the start, so a split of up to 256
//     keys (128 at D 256) is one round trip to memory; 16-byte chunks are
//     swizzled by row, so ldmatrix reads them without bank conflicts. Two
//     groups of 4 warps take every other tile; in a group each warp
//     computes S = Q K^T over a quarter of head_dim, the quarters are
//     summed through shared memory, and each warp then keeps the float32
//     online softmax of the 16 rows in registers, turns P into the A
//     fragment in registers and accumulates O += P V over its own quarter
//     of head_dim; the two groups merge once, at the end;
//   * the CUDA-core body (dense_decode_kernel; float32, and bf16 at head_dim
//     16): one CTA of 8 warps per (split, slot, KV head, part of the group
//     of at most 8 query heads); the warps split the split's keys between
//     them, each group of LPK lanes holds one key and each lane a DPL-wide
//     slice of head_dim, read straight into registers with 16-byte vector
//     loads, U warp steps issued before any is used; every key group keeps
//     its own online softmax, merged over lanes and warps once, at the end.
// The TPU kernel's pad of the whole cache to a multiple of its block
// (decode_attention.py:95-104) and its DMA of blocks past the length have
// no counterpart here: tiles past the length are not read.
#include "common.cuh"
#include "split_merge.cuh"

namespace repro_torch {

struct DenseDecodeArgs {
  const void* q;        // (B, H, D)
  const void* k;        // (B, KV, S, D), head_dim contiguous
  const void* v;
  const int* lengths;   // (B,) int32
  void* out;            // (B, H, D)
  SplitScratch scratch;
  int s, g;             // cache length, query heads per KV head
  int n_splits, split_keys, gc, parts;   // the plan (split_keys: at the full row)
  long long q_sb, q_sh;
  long long k_sb, k_skv, k_ss, v_sb, v_skv, v_ss;
  long long o_sb, o_sh;
  float scale;
};

constexpr int kKeyTile = 32;     // splits cover whole tiles of this many keys

// This CTA's keys [k0, k1) of slot b and the slot's live split count n: the
// row's len keys take round(len / split_keys) splits (at least 1, at most
// n_splits and its tiles), split s covering tiles [s x tiles / n,
// (s + 1) x tiles / n) of the row's ceil(len / kKeyTile). So each split of
// a split row holds about 3/4 of split_keys keys or more, and a row under
// 1.5 x split_keys is one split that writes directly. Every CTA of the unit
// computes the same edges.
struct SplitRange {
  int k0, k1, n_live;
};
__device__ __forceinline__ SplitRange split_range(const DenseDecodeArgs& a, int b, int split) {
  const int len = max(0, min(a.lengths[b], a.s));
  if (len == 0) return {0, 0, 0};
  const int tiles = (len + kKeyTile - 1) / kKeyTile;
  const int n = min(min(a.n_splits, tiles), max(1, (2 * len + a.split_keys) / (2 * a.split_keys)));
  return {split * tiles / n * kKeyTile, min(len, (split + 1) * tiles / n * kKeyTile), n};
}

// --------------------------------------------------------------------------
// CUDA-core body
// --------------------------------------------------------------------------
constexpr int kDecWarps = 8;
constexpr int kDecThreads = 32 * kDecWarps;

// How one warp covers the keys for element type T, head_dim D and G query
// heads a CTA: DPL dims per lane (at least one 16-byte vector, at least D / 32
// so that a key fits in a warp, and G x DPL <= 64 floats of accumulator per
// lane where D allows), LPK lanes per key, KPW keys per warp step, NVEC
// vector loads per lane per row, U steps loaded together.
template <typename T, int D, int G>
struct DecodeShape {
  static constexpr int VEC = Vec<T>::kElems;
  static constexpr int WANT = (32 / G < D) ? 32 / G : D;
  static constexpr int FIT = D / 32 > VEC ? D / 32 : VEC;
  static constexpr int DPL = WANT > FIT ? WANT : FIT;
  static constexpr int LPK = D / DPL;
  static constexpr int KPW = 32 / LPK;
  static constexpr int NVEC = DPL / VEC;
  static constexpr int U = NVEC >= 4 ? 1 : 4 / NVEC;
  static_assert(D % DPL == 0 && 32 % LPK == 0, "lane layout must tile the warp");
};

template <typename T, int D, int G>
__global__ void __launch_bounds__(kDecThreads)
dense_decode_kernel(DenseDecodeArgs a) {
  using Sh = DecodeShape<T, D, G>;
  constexpr int VEC = Sh::VEC, DPL = Sh::DPL, LPK = Sh::LPK, KPW = Sh::KPW;
  constexpr int NVEC = Sh::NVEC, U = Sh::U;
  constexpr unsigned kFull = 0xffffffffu;
  extern __shared__ float dec_smem[];
  float* m_s = dec_smem;                     // [kDecWarps][G]
  float* l_s = m_s + kDecWarps * G;          // [kDecWarps][G]
  float* acc_s = l_s + kDecWarps * G;        // [kDecWarps][G][D]

  const int split = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / a.parts, part = blockIdx.y % a.parts;
  const int unit = b * gridDim.y + blockIdx.y;
  const int head0 = kvh * a.g + part * G;    // first query head of this CTA
  const int n_heads = min(G, a.g - part * G);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kg = lane / LPK;                 // key group of this lane
  const int d0 = (lane % LPK) * DPL;         // first head_dim index of its slice
  const SplitRange r = split_range(a, b, split);
  if (split >= max(r.n_live, 1)) return;     // no key of the slot in this split
  const int k1 = r.k1;

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + (long long)head0 * a.q_sh;
  float qr[G][DPL];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int d = 0; d < DPL; ++d)
      qr[gi][d] = gi < n_heads ? load_f(q + gi * a.q_sh + d0 + d) * a.scale : 0.f;

  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_skv + d0;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_skv + d0;

  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = -CUDART_INF_F;
    l[gi] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[gi][d] = 0.f;
  }

  // t0 is the same for every lane of the warp, so the shuffles below run
  // converged; only keys past k1 are skipped, per key group
  for (int t0 = r.k0 + warp * KPW * U; t0 < k1; t0 += kDecWarps * KPW * U) {
    uint4 kr[U][NVEC], vr[U][NVEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * KPW + kg;
#pragma unroll
      for (int e = 0; e < NVEC; ++e) {
        kr[u][e] = vr[u][e] = make_uint4(0u, 0u, 0u, 0u);
        if (t < k1) {
          kr[u][e] = load_vec(kb + t * a.k_ss + e * VEC);
          vr[u][e] = load_vec(vb + t * a.v_ss + e * VEC);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * KPW + kg;
      float kf[DPL];
#pragma unroll
      for (int e = 0; e < NVEC; ++e) unpack_vec<T>(kr[u][e], kf + e * VEC);
      float s[G];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float x = 0.f;
#pragma unroll
        for (int d = 0; d < DPL; ++d) x = fmaf(qr[gi][d], kf[d], x);
        s[gi] = x;
      }
#pragma unroll
      for (int o = LPK / 2; o > 0; o >>= 1)
#pragma unroll
        for (int gi = 0; gi < G; ++gi) s[gi] += __shfl_xor_sync(kFull, s[gi], o);
      if (t < k1) {
        float vf[DPL];
#pragma unroll
        for (int e = 0; e < NVEC; ++e) unpack_vec<T>(vr[u][e], vf + e * VEC);
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          const float m_new = fmaxf(m[gi], s[gi]);
          const float corr = expf(m[gi] - m_new);   // 0 while m was -inf
          const float p = expf(s[gi] - m_new);
          l[gi] = l[gi] * corr + p;
          m[gi] = m_new;
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[gi][d] = fmaf(p, vf[d], acc[gi][d] * corr);
        }
      }
    }
  }

  // merge the warp's key groups (lanes LPK, 2 LPK, ... apart)
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
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
    for (int gi = 0; gi < G; ++gi) {
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc_s[(warp * G + gi) * D + d0 + d] = acc[gi][d];
      if (lane == 0) {
        m_s[warp * G + gi] = m[gi];
        l_s[warp * G + gi] = l[gi];
      }
    }
  }
  __syncthreads();

  T* out = static_cast<T*>(a.out) + b * a.o_sb + (long long)head0 * a.o_sh;
  split_epilogue<kDecThreads, G, D>(
      a.scratch, unit, gridDim.z * gridDim.y, split, a.n_splits, r.n_live, G, n_heads, out,
      a.o_sh, [&](int gi, int d) {
        // merge the CTA's warps
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, m_s[w * G + gi]);
        float lt = 0.f, at = 0.f;
#pragma unroll
        for (int w = 0; w < kDecWarps; ++w) {
          const float sc = mx == -CUDART_INF_F ? 0.f : expf(m_s[w * G + gi] - mx);
          lt += l_s[w * G + gi] * sc;
          at += acc_s[(w * G + gi) * D + d] * sc;
        }
        return SplitResult{mx, lt, at};
      });
}

// --------------------------------------------------------------------------
// Tensor-core body (bf16)
// --------------------------------------------------------------------------
constexpr int kTcGroups = 2;     // warp groups, each on every other tile
constexpr int kTcGroupWarps = 4; // warps a group, each on a quarter of head_dim
constexpr int kTcThreads = 32 * kTcGroups * kTcGroupWarps;
constexpr int kTcKeys = kKeyTile; // keys a K/V tile
constexpr int kTcRows = 16;      // query heads a CTA: the M of m16n8k16

template <int D>
struct TcShape {
  static constexpr int ROW_BYTES = D * 2;                      // one bf16 key row
  static constexpr int TILE_BYTES = kTcKeys * ROW_BYTES;       // K or V tile
  // ring stages, all in flight at once: 8 (256 keys) up to D 128, 4 (128
  // keys) at D 256; 128 KB at D 128 and 256, one CTA an SM
  static constexpr int STAGES = D == 256 ? 4 : 8;
  static constexpr int RING_BYTES = STAGES * 2 * TILE_BYTES;
  // each warp's quarter of S = Q K^T for a tile (kTcKeys / 8 float4 a lane)
  static constexpr int RED_BYTES = kTcGroups * kTcGroupWarps * (kTcKeys / 8) * 32 * 16;
  static constexpr int SMEM_BYTES = RING_BYTES + RED_BYTES;
  static constexpr int DW = D / kTcGroupWarps;                 // output dims a warp
  static_assert(DW % 16 == 0 && (D / 16) % kTcGroupWarps == 0 && STAGES % kTcGroups == 0,
                "tile shape");
  // the groups' (acc, m, l) reuse the ring once it is drained
  static_assert(kTcGroups * kTcRows * (D + 2) * 4 <= RING_BYTES, "ring holds the groups' results");
};

// byte offset of 16-byte chunk `ch` of key row `r` in a swizzled tile: the
// chunk index is XORed with r % 8, so the 8 rows of an ldmatrix matrix fall
// in 8 different bank groups
template <int D>
__device__ __forceinline__ uint32_t tile_offset(int r, int ch) {
  return (uint32_t)(r * D * 2 + ((ch ^ (r & 7)) << 4));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// d (16 x 8, float32) += a (16 x 16, bf16, row-major) * b (16 x 8, bf16, col-major)
__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
dense_decode_tc_kernel(DenseDecodeArgs a) {
  using Sh = TcShape<D>;
  using bf16 = __nv_bfloat16;
  constexpr int NS = Sh::STAGES, TB = Sh::TILE_BYTES, CH = D / 8;
  constexpr int KQ = D / 16 / kTcGroupWarps; // k-steps of S = Q K^T a warp computes
  constexpr int NT = Sh::DW / 8;             // n-tiles of this warp's O slice
  constexpr int SN = kTcKeys / 8;            // n-tiles of S
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t ring = smem_addr(tc_smem);  // [NS][K, V][kTcKeys][D] bf16, swizzled
  // after the key loop, the ring holds each group's results
  float* acc_s = reinterpret_cast<float*>(tc_smem);                 // [groups][16][D]
  float* m_s = acc_s + kTcGroups * kTcRows * D;                     // [groups][16]
  float* l_s = m_s + kTcGroups * kTcRows;                           // [groups][16]
  // [groups][warps][SN][32 lanes] float4: the warps' quarters of S
  float4* red = reinterpret_cast<float4*>(tc_smem + Sh::RING_BYTES);

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int unit = b * gridDim.y + kvh;
  const int tid = threadIdx.x, lane = tid & 31;
  const int group = tid / (32 * kTcGroupWarps), warp = (tid >> 5) % kTcGroupWarps;
  const int g4 = lane >> 2, t4 = lane & 3;   // fragment row group, column pair
  const SplitRange r = split_range(a, b, split);
  if (split >= max(r.n_live, 1)) return;     // no key of the slot in this split
  const int k0 = r.k0, k1 = r.k1;
  const int n_tiles = k1 > k0 ? (k1 - k0 + kTcKeys - 1) / kTcKeys : 0;
  const int n_heads = a.g;

  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_skv;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_skv;
  // tile j: keys k0 + j * kTcKeys + [0, kTcKeys) into stage j % NS; rows at
  // or past k1 are zero-filled, never read. All NS stages are in flight
  // from the start: a split of up to NS tiles is one round trip to memory.
  auto issue = [&](int j) {
    const int key0 = k0 + j * kTcKeys;
    const uint32_t st = ring + (j % NS) * 2 * TB;
    for (int c = tid; c < 2 * kTcKeys * CH; c += kTcThreads) {
      const int w = c / (kTcKeys * CH), row = (c / CH) % kTcKeys, ch = c % CH;
      const int t = key0 + row;
      const bool ok = t < k1;
      const bf16* base = w ? vb : kb;
      const bf16* src = ok ? base + (long long)t * (w ? a.v_ss : a.k_ss) + ch * 8 : base;
      cp_async16(st + w * TB + tile_offset<D>(row, ch), src, ok);
    }
  };
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    if (j < n_tiles) issue(j);
    cp_async_commit();
  }

  // Q as the A fragments of this warp's k-steps: rows g4 and g4 + 8 (heads
  // past the group are zero), columns 2 t4 (+1) and 8 + 2 t4 (+1)
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb + (long long)kvh * a.g * a.q_sh;
  uint32_t qa[KQ][4];
#pragma unroll
  for (int kq = 0; kq < KQ; ++kq)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = g4 + (i & 1) * 8, col = (warp * KQ + kq) * 16 + (i >> 1) * 8 + 2 * t4;
      __nv_bfloat162 x = __floats2bfloat162_rn(0.f, 0.f);
      if (row < n_heads) x = __halves2bfloat162(qb[row * a.q_sh + col], qb[row * a.q_sh + col + 1]);
      qa[kq][i] = *reinterpret_cast<const uint32_t*>(&x);
    }

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // rows g4, g4 + 8; m in base 2 (scores times log2 e)
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  const float scale2 = a.scale * 1.4426950408889634f;
  const int mi = lane >> 3, mr = lane & 7;   // ldmatrix: matrix and row this lane addresses
  const int dcol0 = warp * Sh::DW / 8;       // first 16-byte chunk of this warp's O slice

  // group h takes tiles h, h + 2, ...: two tiles are in work at once
  for (int j0 = 0; j0 < n_tiles; j0 += kTcGroups) {
    cp_async_wait<NS - kTcGroups>();         // tiles j0, j0 + 1 have landed (this thread's copies)
    __syncthreads();                         // ... every thread's
    const int j = j0 + group;
    if (j < n_tiles) {
      const uint32_t kt = ring + (j % NS) * 2 * TB, vt = kt + TB;

      // S = Q K^T over the tile, K rows the B operand read as stored: each
      // warp of the group takes a quarter of head_dim, and the quarters are
      // summed through shared memory in warp order (every warp of the group
      // then holds the same S)
      float s[SN][4];
#pragma unroll
      for (int n = 0; n < SN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kq = 0; kq < KQ; ++kq)
#pragma unroll
        for (int np = 0; np < SN / 2; ++np) {
          uint32_t bf[4];
          const int row = np * 16 + (mi >> 1) * 8 + mr;
          ldmatrix_x4(kt + tile_offset<D>(row, (warp * KQ + kq) * 2 + (mi & 1)), bf);
          mma_bf16_16816(s[2 * np], qa[kq], bf[0], bf[1]);
          mma_bf16_16816(s[2 * np + 1], qa[kq], bf[2], bf[3]);
        }
      float4* red_g = red + group * kTcGroupWarps * SN * 32;
#pragma unroll
      for (int n = 0; n < SN; ++n)
        red_g[(warp * SN + n) * 32 + lane] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
      // the group's 4 warps only (barrier 0 is __syncthreads)
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "r"(32 * kTcGroupWarps) : "memory");
#pragma unroll
      for (int n = 0; n < SN; ++n) {
        float4 x = red_g[n * 32 + lane];
#pragma unroll
        for (int w = 1; w < kTcGroupWarps; ++w) {
          const float4 y = red_g[(w * SN + n) * 32 + lane];
          x.x += y.x;
          x.y += y.y;
          x.z += y.z;
          x.w += y.w;
        }
        s[n][0] = x.x;
        s[n][1] = x.y;
        s[n][2] = x.z;
        s[n][3] = x.w;
      }

      // scale, mask keys at or past k1, online softmax of rows g4 and g4 + 8
      // in base 2 (the tile's first key is valid, so each row's max is
      // finite)
      const int key0 = k0 + j * kTcKeys;
      float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
      for (int n = 0; n < SN; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int t = key0 + n * 8 + 2 * t4 + (c & 1);
          s[n][c] = t < k1 ? s[n][c] * scale2 : -CUDART_INF_F;
          if (c < 2) mx0 = fmaxf(mx0, s[n][c]);
          else mx1 = fmaxf(mx1, s[n][c]);
        }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);   // 0 while m was -inf
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int n = 0; n < SN; ++n) {
        s[n][0] = exp2f(s[n][0] - mn0);
        s[n][1] = exp2f(s[n][1] - mn0);
        s[n][2] = exp2f(s[n][2] - mn1);
        s[n][3] = exp2f(s[n][3] - mn1);
        ps0 += s[n][0] + s[n][1];
        ps1 += s[n][2] + s[n][3];
      }
      l0 = l0 * c0 + ps0;                      // this lane's columns; summed over the quad at the end
      l1 = l1 * c1 + ps1;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][0] *= c0;
        o[n][1] *= c0;
        o[n][2] *= c1;
        o[n][3] *= c1;
      }

      // O += P V over this warp's slice of head_dim: P's accumulator is the
      // A fragment, V rows are the B operand read transposed
#pragma unroll
      for (int kk = 0; kk < kTcKeys / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bf[4];
          const int row = kk * 16 + (mi & 1) * 8 + mr;
          ldmatrix_x4_trans(vt + tile_offset<D>(row, dcol0 + np * 2 + (mi >> 1)), bf);
          mma_bf16_16816(o[2 * np], pa, bf[0], bf[1]);
          mma_bf16_16816(o[2 * np + 1], pa, bf[2], bf[3]);
        }
      }
    }
    const bool refill = j0 + NS < n_tiles;   // the same in every thread
    if (refill) __syncthreads();             // every warp is done with stages j0, j0 + 1
#pragma unroll
    for (int h = 0; h < kTcGroups; ++h) {    // one group of copies a tile
      if (refill && j0 + NS + h < n_tiles) issue(j0 + NS + h);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
  __syncthreads();                           // the ring is free for the results

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  float* acc_g = acc_s + group * kTcRows * D;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int d = warp * Sh::DW + n * 8 + 2 * t4;
    acc_g[g4 * D + d] = o[n][0];
    acc_g[g4 * D + d + 1] = o[n][1];
    acc_g[(g4 + 8) * D + d] = o[n][2];
    acc_g[(g4 + 8) * D + d + 1] = o[n][3];
  }
  if (warp == 0 && t4 == 0) {             // m back to natural units for the merges
    m_s[group * kTcRows + g4] = m0 * 0.6931471805599453f;
    m_s[group * kTcRows + g4 + 8] = m1 * 0.6931471805599453f;
    l_s[group * kTcRows + g4] = l0;
    l_s[group * kTcRows + g4 + 8] = l1;
  }
  __syncthreads();

  bf16* out = static_cast<bf16*>(a.out) + b * a.o_sb + (long long)kvh * a.g * a.o_sh;
  split_epilogue<kTcThreads, kTcRows, D>(
      a.scratch, unit, gridDim.z * gridDim.y, split, a.n_splits, r.n_live, a.gc, n_heads, out,
      a.o_sh, [&](int gi, int d) {
        // merge the two groups (a group with no tile has m = -inf)
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int h = 0; h < kTcGroups; ++h) mx = fmaxf(mx, m_s[h * kTcRows + gi]);
        float lt = 0.f, at = 0.f;
#pragma unroll
        for (int h = 0; h < kTcGroups; ++h) {
          const float m = m_s[h * kTcRows + gi];
          const float sc = m == -CUDART_INF_F ? 0.f : expf(m - mx);
          lt += l_s[h * kTcRows + gi] * sc;
          at += acc_s[(h * kTcRows + gi) * D + d] * sc;
        }
        return SplitResult{mx, lt, at};
      });
}

// --------------------------------------------------------------------------
// Launch
// --------------------------------------------------------------------------
static int set_smem(const void* fn, size_t smem) {
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int D, int G>
static int launch_cuda_cores(const DenseDecodeArgs& a, int B, int KV, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kDecWarps * G * (D + 2);
  if (int err = set_smem((const void*)dense_decode_kernel<T, D, G>, smem)) return err;
  dense_decode_kernel<T, D, G><<<dim3(a.n_splits, KV * a.parts, B), kDecThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
static int launch_tensor_cores(const DenseDecodeArgs& a, int B, int KV, cudaStream_t stream) {
  const size_t smem = TcShape<D>::SMEM_BYTES;
  if (int err = set_smem((const void*)dense_decode_tc_kernel<D>, smem)) return err;
  dense_decode_tc_kernel<D><<<dim3(a.n_splits, KV, B), kTcThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
static int dispatch_gc(const DenseDecodeArgs& a, int B, int KV, cudaStream_t s) {
  switch (a.gc) {
    case 1: return launch_cuda_cores<T, D, 1>(a, B, KV, s);
    case 2: return launch_cuda_cores<T, D, 2>(a, B, KV, s);
    case 4: return launch_cuda_cores<T, D, 4>(a, B, KV, s);
    case 8: return launch_cuda_cores<T, D, 8>(a, B, KV, s);
  }
  return (int)cudaErrorInvalidValue;
}

// float32 at every head_dim; bf16 only at head_dim 16, where the tensor-core
// body has no variant
static int dispatch_cuda_cores(const DenseDecodeArgs& a, int B, int KV, int D, int dtype,
                               cudaStream_t s) {
  if (dtype == kBF16 && D == 16) return dispatch_gc<__nv_bfloat16, 16>(a, B, KV, s);
  if (dtype != kF32) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: return dispatch_gc<float, 16>(a, B, KV, s);
    case 64: return dispatch_gc<float, 64>(a, B, KV, s);
    case 128: return dispatch_gc<float, 128>(a, B, KV, s);
    case 256: return dispatch_gc<float, 256>(a, B, KV, s);
  }
  return (int)cudaErrorInvalidValue;
}

static int dispatch_tensor_cores(const DenseDecodeArgs& a, int B, int KV, int D, cudaStream_t s) {
  switch (D) {
    case 64: return launch_tensor_cores<64>(a, B, KV, s);
    case 128: return launch_tensor_cores<128>(a, B, KV, s);
    case 256: return launch_tensor_cores<256>(a, B, KV, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro_torch

using namespace repro_torch;

// Returns cudaGetLastError() after the launch (0 = launched, or nothing to
// launch at B = 0). The caller checks shapes, dtypes, strides and alignment
// and plans the launch (decode_attention.py :: plan): body 1 = tensor cores
// (bf16, D 64, 128 or 256, the whole group of g <= 16 heads a CTA: gc = g),
// 0 = CUDA cores (float32 at D 16, 64, 128 or 256, bf16 at D 16; gc = 1, 2,
// 4 or 8 heads a CTA, gc >= min(g, 8)); n_splits CTAs per (slot, KV head,
// head part), placed on each slot's keys by split_range from split_keys,
// and, for n_splits > 1, a scratch of B x KV x parts x n_splits x gc x
// (D + 2) floats and B x KV x parts int32 counters that are 0.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* lengths, void* out, void* part,
    void* counters, int B, int H, int KV, int S, int D, int body, int n_splits, int split_keys,
    int gc, long long q_sb, long long q_sh, long long k_sb, long long k_skv, long long k_ss,
    long long v_sb, long long v_skv, long long v_ss, long long o_sb, long long o_sh,
    float scale, int dtype, void* stream) {
  if (KV <= 0 || H % KV != 0 || H / KV > kTcRows || n_splits < 1 || split_keys < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  if (n_splits > 1 && (part == nullptr || counters == nullptr)) return (int)cudaErrorInvalidValue;
  const int g = H / KV;
  if (body == 1 ? (dtype != kBF16 || gc != g) : (body != 0 || gc < (g < 8 ? g : 8)))
    return (int)cudaErrorInvalidValue;
  DenseDecodeArgs a{q, k, v, static_cast<const int*>(lengths), out,
                    SplitScratch{static_cast<float*>(part), static_cast<int*>(counters)},
                    S, g, n_splits, split_keys, gc, (g + gc - 1) / gc,
                    q_sb, q_sh, k_sb, k_skv, k_ss, v_sb, v_skv, v_ss, o_sb, o_sh, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return body == 1 ? dispatch_tensor_cores(a, B, KV, D, s) : dispatch_cuda_cores(a, B, KV, D, dtype, s);
}
