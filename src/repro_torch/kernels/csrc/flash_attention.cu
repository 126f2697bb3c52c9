// Flash attention for Hopper (sm_90a), CUDA C++: a dense entry and a paged
// chunked-prefill entry, each served by one of two device bodies.
//
// Replaces: the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py :: flash_attention
//   (body _flash_kernel), whose oracle is
//   src/repro/kernels/ref.py :: flash_attention_ref.
// The paged entry is where the serving path uses it: the chunk rows of
// prefill_chunk / mixed_step, whose queries sit at starts[r] + arange(C) and
// whose keys (positions < valid_len[r]) live in the slot's pages of the
// (KV, P, page_size, D) pool, read through the block table. The reference
// model runs models/attention.py :: attention_paged there (gather + einsum).
//
// What it computes: an online float32 softmax over key tiles; GQA maps head
// h to KV head h / g. Masks by position: causal k_pos <= q_pos, k_pos <
// valid_len (dense: Sk), k on an allocated page (paged), q_pos - k_pos <
// window (window > 0). Key tiles that are fully masked for the whole query
// tile (above the diagonal, left of the window, past valid_len) are skipped,
// as flash_attention.py:60-66 skips its blocks. A row without any valid key
// (a pad row, chunk_lens == 0) writes 0.
//
// What bounds it on an H100: at the serving shapes (8 x 128 prompts, or
// chunks of 32 queries over up to 640 keys) the work is 4 x Sq x Sk x D
// flops per head against (Sq + 2 Sk) x D x 2 bytes per KV head, tens to a
// hundred flops per byte: below the ~295 at which the bf16 tensor cores
// become the limit, so on the tensor cores it is bounded by bytes and by
// latency (a few tiles per CTA). The bf16 body at head_dim 64 / 128 / 256
// (flash_tc_kernel, what every serving path runs) is built for that:
//   * both products run on wgmma: S = Q K^T with Q and K in shared memory,
//     O += P V with P converted to bf16 in registers as wgmma's A fragment
//     (FlashAttention-3's layout identity) and V read MN-major from shared
//     memory; float32 accumulators and the online softmax stay in registers;
//   * Q, K and V stay bf16 in 128-byte-swizzled shared memory (wgmma.cuh),
//     so key tiles are 64 tokens even at head_dim 256;
//   * a CTA's rows are the (query, head) pairs of the g query heads of one
//     KV head, row f = query f / g, head f % g: each K/V tile is read once
//     per KV head, not once per query head. The host picks the CTA tile
//     from shapes: 64 rows on one warpgroup, 128 rows on two sharing each
//     key tile, or 64 rows on two warpgroups that split every 128-key tile
//     and merge once at the end (a long key range, as the paged chunks');
//   * K/V tiles come through a two-stage cp.async ring (16-byte copies,
//     through the block-table row in shared memory for the paged entry), the
//     next tile in flight while this one is computed on; the dense entry
//     takes the caller's strided bshk views as they are.
// float32 at any head_dim, and bf16 at head_dim 16 / 32, run the CUDA-core
// body (flash_kernel): float32 FMAs on tiles widened to float32 in shared
// memory. Tensor cores would compute float32 as TF32, which misses the
// float32 tolerance. The host's plan (flash_attention.py :: variant, plan)
// picks the body and tile; a launch this build cannot serve is refused.
#include "common.cuh"
#include "wgmma.cuh"

namespace repro_torch {

constexpr int kBK = 32;  // key tokens per tile of the CUDA-core body

struct FlashArgs {
  const void* q;   // paged: (R, C, H, D) bshk; dense: (B, H, Sq, D)
  const void* k;   // paged: (KV, P, bs, D) pool; dense: (B, KV, Sk, D)
  const void* v;
  void* out;       // same layout as q
  const int* tables;     // paged: (R, MB) int32; dense: null
  const int* q_start;    // paged: (R,) first query position; dense: null (0)
  const int* kv_len;     // paged: (R,) valid keys; dense: null (Sk)
  int sq, g, sk, page_size, mb, causal, window;
  long long q_sb, q_ss, q_sh, o_sb, o_ss, o_sh;
  long long k_sb, k_skv, k_ss, v_sb, v_skv, v_ss;  // paged: k_ss / v_ss = page stride
  float scale;
  float* lse;      // dense only, may be null: (B, H, Sq) float32 log-sum-exp
};

// element offset of key token t in its K (or V) tensor, -1 when masked:
// past kv_len, or (paged) on an unallocated page. ``stride`` is the page
// stride (paged) or the token stride (dense).
template <bool PAGED>
__device__ __forceinline__ long long key_offset(
    int t, int kvl, const int* table_s, const FlashArgs& a, long long stride, int D) {
  if (t >= kvl) return -1;
  if (!PAGED) return t * stride;
  const int blk = t / a.page_size;
  const int page = blk < a.mb ? table_s[blk] : -1;
  return page >= 0 ? page * stride + (long long)(t % a.page_size) * D : -1;
}

// --------------------------------------------------------------------------
// CUDA-core body (float32 at any head_dim, bf16 at 16 / 32): one CTA per
// (row, query head, query tile of BQ); q, K/V tiles and P staged in shared
// memory as float32, a 4 x 4 score block and a 4 x D/8 accumulator block
// per thread, row reductions over the 8 lanes of a row group
// --------------------------------------------------------------------------
template <typename T, int D, int BQ, bool PAGED>
__global__ void __launch_bounds__(2 * BQ)
flash_kernel(FlashArgs a) {
  constexpr int NT = 2 * BQ;          // BQ / 4 row groups x 8 lanes
  constexpr int DC = D / 8;           // accumulator columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                        // [BQ][D+1]
  float* k_s = q_s + BQ * (D + 1);          // [BK][D+1]
  float* v_s = k_s + kBK * (D + 1);         // [BK][D]
  float* p_s = v_s + kBK * D;               // [BQ][BK+1]
  int* table_s = reinterpret_cast<int*>(p_s + BQ * (kBK + 1));   // paged: [MB]
  __shared__ bool valid_s[kBK];
  constexpr int VEC = Vec<T>::kElems;

  const int row = blockIdx.x, h = blockIdx.y, qt = blockIdx.z;
  const int tid = threadIdx.x, rg = tid >> 3, cg = tid & 7;
  const int kvh = h / a.g;
  const T* q = static_cast<const T*>(a.q) + row * a.q_sb + h * a.q_sh;
  const T* kbase = static_cast<const T*>(a.k) + kvh * a.k_skv + (PAGED ? 0 : row * a.k_sb);
  const T* vbase = static_cast<const T*>(a.v) + kvh * a.v_skv + (PAGED ? 0 : row * a.v_sb);
  const int q0 = PAGED ? a.q_start[row] : 0;
  const int kvl = PAGED ? a.kv_len[row] : a.sk;
  const int qi0 = qt * BQ;
  const int qi_last = min(a.sq, qi0 + BQ) - 1;

  // keys any query of this tile may see: [lo, hi)
  int hi = kvl;
  if (a.causal) hi = min(hi, q0 + qi_last + 1);
  int lo = 0;
  if (a.window > 0) lo = max(0, q0 + qi0 - a.window + 1);
  lo = (lo / kBK) * kBK;

  const int* trow = PAGED ? a.tables + (long long)row * a.mb : nullptr;
  if (PAGED) {
    const int n_blk = min(a.mb, (kvl + a.page_size - 1) / a.page_size);
    for (int i = tid; i < n_blk; i += NT) table_s[i] = trow[i];
  }
  {
    // q tile: 16-byte vector loads, all in flight before the first store
    constexpr int NV = BQ * D / VEC, PER = (NV + NT - 1) / NT;
    uint4 regs[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid + u * NT, r = i * VEC / D, d = i * VEC % D;
      regs[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < NV && qi0 + r < a.sq) regs[u] = load_vec(q + (qi0 + r) * a.q_ss + d);
    }
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid + u * NT, r = i * VEC / D, d = i * VEC % D;
      if (i < NV) {
        float* dst = q_s + r * (D + 1) + d;
        unpack_vec<T>(regs[u], dst);
#pragma unroll
        for (int e = 0; e < VEC; ++e) dst[e] *= a.scale;
      }
    }
  }

  float acc[4][DC];
  float m_run[4], l_run[4];
  int q_pos[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_run[r] = -CUDART_INF_F;
    l_run[r] = 0.f;
    q_pos[r] = q0 + qi0 + rg * 4 + r;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }
  __syncthreads();  // table row and q tile are in shared memory

  for (int kt = lo; kt < hi; kt += kBK) {
    // K/V tile: per-token element offsets (page walk for the paged entry),
    // 16-byte vector loads all issued before the shared-memory stores
    constexpr int NV = kBK * D / VEC, PER = (NV + NT - 1) / NT;
    uint4 kreg[PER], vreg[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid + u * NT, j = i * VEC / D, d = i * VEC % D;
      kreg[u] = vreg[u] = make_uint4(0u, 0u, 0u, 0u);
      const long long ko = key_offset<PAGED>(kt + j, kvl, table_s, a, a.k_ss, D);
      const long long vo = key_offset<PAGED>(kt + j, kvl, table_s, a, a.v_ss, D);
      if (i < NV && ko >= 0) kreg[u] = load_vec(kbase + ko + d);
      if (i < NV && vo >= 0) vreg[u] = load_vec(vbase + vo + d);
    }
    __syncthreads();  // the previous tile is done with k_s / v_s
    for (int j = tid; j < kBK; j += NT)
      valid_s[j] = key_offset<PAGED>(kt + j, kvl, table_s, a, a.k_ss, D) >= 0;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid + u * NT, j = i * VEC / D, d = i * VEC % D;
      if (i < NV) {
        unpack_vec<T>(kreg[u], k_s + j * (D + 1) + d);
        unpack_vec<T>(vreg[u], v_s + j * D + d);
      }
    }
    __syncthreads();

    // scores: rows rg*4 + r, keys cg*4 + c
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    const float* qr = q_s + (rg * 4) * (D + 1);
    const float* kr = k_s + (cg * 4) * (D + 1);
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qa[r] = qr[r * (D + 1) + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kb[c] = kr[c * (D + 1) + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qa[r], kb[c], s[r][c]);
    }

    // mask, online softmax per row (8 lanes of the row group), stage P
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      bool ok[4];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = cg * 4 + c, t = kt + j;
        ok[c] = valid_s[j] && (!a.causal || t <= q_pos[r]) &&
                (a.window <= 0 || q_pos[r] - t < a.window);
        if (ok[c]) mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m_run[r], group8_max(mx));
      const float corr = m_new == -CUDART_INF_F ? 1.f : expf(m_run[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? expf(s[r][c] - m_new) : 0.f;
        sum += p;
        p_s[(rg * 4 + r) * (kBK + 1) + cg * 4 + c] = p;
      }
      l_run[r] = l_run[r] * corr + group8_sum(sum);
      m_run[r] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= corr;
    }
    __syncwarp();  // a row group's P is read only by its own warp

    // acc[r][c] += P[row r, :] . V[:, cg + 8c]
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) pr[r] = p_s[(rg * 4 + r) * (kBK + 1) + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = v_s[j * D + cg + 8 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(pr[r], vv, acc[r][c]);
      }
    }
    __syncwarp();  // P is consumed before the next tile overwrites it
  }

  T* out = static_cast<T*>(a.out) + row * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = qi0 + rg * 4 + r;
    if (qi >= a.sq) continue;
    const float inv = 1.f / fmaxf(l_run[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) store_f(out + qi * a.o_ss + cg + 8 * c, acc[r][c] * inv);
    // the row's log-sum-exp of the scaled scores (-inf for a row without keys)
    if (a.lse != nullptr && cg == 0)
      a.lse[((long long)row * gridDim.y + h) * a.sq + qi] = m_run[r] + logf(l_run[r]);
  }
}

template <typename T, int D, int BQ, bool PAGED>
static int launch(const FlashArgs& a, int rows, int H, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (BQ * (D + 1) + kBK * (D + 1) + kBK * D + BQ * (kBK + 1)) +
      (PAGED ? sizeof(int) * a.mb : 0);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D, BQ, PAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(rows, H, (a.sq + BQ - 1) / BQ);
  flash_kernel<T, D, BQ, PAGED><<<grid, 2 * BQ, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------------------
// Tensor-core body (bf16, head_dim 64 / 128 / 256)
// --------------------------------------------------------------------------
constexpr int kTcBK = 64;      // key tokens a warpgroup takes per tile

template <int D>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* p, uint64_t desc_v) {
  if constexpr (D == 64) wgmma_rs_m64n64k16(o, p, desc_v);
  if constexpr (D == 128) wgmma_rs_m64n128k16(o, p, desc_v);
  if constexpr (D == 256) wgmma_rs_m64n256k16(o, p, desc_v);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The CTA shape: NWG consumer warpgroups. KSPLIT = 1: each warpgroup owns
// 64 of the CTA's M = 64 NWG rows and all warpgroups share every key tile.
// KSPLIT = 2 (two warpgroups): both own the same M = 64 rows and each takes
// its half of every 2 x 64-key tile, and the two halves merge once at the
// end; a long key range then takes half the sequential tiles.
template <int D, int NWG, int KSPLIT>
struct TcShape {
  static constexpr int M = 64 * NWG / KSPLIT;
  static constexpr int NT = 128 * NWG;
  static constexpr int SBK = kTcBK * KSPLIT;                  // keys a stage holds
  static constexpr size_t Q_BYTES = size_t(M) * D * 2;
  static constexpr size_t SUB_BYTES = size_t(kTcBK) * D * 2;  // one warpgroup's K (or V) tile
  static constexpr size_t STAGE_BYTES = 2 * KSPLIT * SUB_BYTES;
  static constexpr int STAGES = 2;   // the next tile in flight while this one is used
  static constexpr size_t SMEM = 1024 + Q_BYTES + STAGES * (STAGE_BYTES + SBK * 4);
  static_assert(KSPLIT == 1 || NWG == KSPLIT, "a key split has one warpgroup a part");
};

// One CTA per (row, KV head, tile of M flattened rows). Row f of the
// (query, head) pairs of one KV head is query f / g, head f % g, so the g
// query heads of a KV head share every K/V tile the CTA loads.
template <int D, int NWG, int KSPLIT, bool PAGED>
__global__ void __launch_bounds__(128 * NWG)
flash_tc_kernel(FlashArgs a) {
  using T = __nv_bfloat16;
  using Sh = TcShape<D, NWG, KSPLIT>;
  constexpr int M = Sh::M, NT = Sh::NT, BK = kTcBK, SBK = Sh::SBK, CPR = D / 8;
  constexpr int STAGES = Sh::STAGES;
  constexpr uint32_t SUB = Sh::SUB_BYTES, STAGE = Sh::STAGE_BYTES;
  extern __shared__ uint8_t tc_smem[];
  const uint32_t raw = smem_addr(tc_smem);
  const uint32_t q_sm = (raw + 1023u) & ~1023u;          // swizzled tiles start 1024-aligned
  // stage s at kv_sm + s STAGE: the K tiles of its KSPLIT parts, then their V
  const uint32_t kv_sm = q_sm + Sh::Q_BYTES;
  // per stage, whether key j of its tile was loaded (not past kv_len, not
  // on a -1 page); then (paged) the block-table row
  int* valid_s = reinterpret_cast<int*>(tc_smem + (kv_sm - raw) + STAGES * STAGE);
  int* table_s = valid_s + STAGES * SBK;

  const int row = blockIdx.x, kvh = blockIdx.y, g = a.g;
  const int tid = threadIdx.x;
  const int n_rows = a.sq * g;
  const int f0 = blockIdx.z * M;
  const int qi_lo = f0 / g, qi_hi = (min(n_rows, f0 + M) - 1) / g;

  // the Q tile (rows past the last query are zero), the row's positions
  // and (paged) its whole block-table row are independent reads: all are
  // issued before any is waited on
  const T* q = static_cast<const T*>(a.q) + row * a.q_sb;
  for (int i = tid; i < M * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * 8, f = f0 + r;
    const bool ok = f < n_rows;
    const T* src = ok ? q + (kvh * g + f % g) * a.q_sh + (f / g) * a.q_ss + c : q;
    cp_async16(q_sm + swz_offset(r, c, M), src, ok);
  }
  const int q0 = PAGED ? a.q_start[row] : 0;
  const int kvl = PAGED ? a.kv_len[row] : a.sk;
  if (PAGED) {
    const int* trow = a.tables + (long long)row * a.mb;
    for (int i = tid; i < a.mb; i += NT) table_s[i] = trow[i];
    __syncthreads();
  }

  // keys any row of this tile may see: [lo, hi)
  int hi = kvl;
  if (a.causal) hi = min(hi, q0 + qi_hi + 1);
  int lo = 0;
  if (a.window > 0) lo = max(0, q0 + qi_lo - a.window + 1);
  lo = (lo / BK) * BK;
  const int n_tiles = hi > lo ? (hi - lo + SBK - 1) / SBK : 0;

  const T* kbase = static_cast<const T*>(a.k) + kvh * a.k_skv + (PAGED ? 0 : row * a.k_sb);
  const T* vbase = static_cast<const T*>(a.v) + kvh * a.v_skv + (PAGED ? 0 : row * a.v_sb);

  // one page lookup a key row serves its K and V copies and its flag
  auto load_tile = [&](int kt, int st) {
    const uint32_t k_dst = kv_sm + st * STAGE, v_dst = k_dst + KSPLIT * SUB;
    for (int i = tid; i < SBK * CPR; i += NT) {
      const int j = i / CPR, c = (i % CPR) * 8, t = kt + j;
      long long ko = -1, vo = -1;
      if (t < kvl) {
        if (PAGED) {
          const int blk = t / a.page_size;
          const int page = blk < a.mb ? table_s[blk] : -1;
          if (page >= 0) {
            const long long in_page = (long long)(t - blk * a.page_size) * D;
            ko = page * a.k_ss + in_page;
            vo = page * a.v_ss + in_page;
          }
        } else {
          ko = t * a.k_ss;
          vo = t * a.v_ss;
        }
      }
      if (c == 0) valid_s[st * SBK + j] = ko >= 0;
      const uint32_t off = (j / BK) * SUB + swz_offset(j % BK, c, BK);
      cp_async16(k_dst + off, ko >= 0 ? kbase + ko + c : kbase, ko >= 0);
      cp_async16(v_dst + off, vo >= 0 ? vbase + vo + c : vbase, vo >= 0);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load_tile(lo + s * SBK, s);
    cp_async_commit();
  }

  // this thread's two rows of its warpgroup's 64 (wgmma's accumulator
  // layout: warp w holds rows 16w .. 16w + 15, lane l rows l/4 and l/4 + 8,
  // columns 8j + 2(l%4) + {0, 1})
  const int wg = tid / 128, lane = tid & 31, warp = (tid % 128) / 32;
  const int quad = lane & 3;
  const int row_grp = KSPLIT == 1 ? wg : 0;     // which 64 rows
  const int key_part = KSPLIT == 1 ? 0 : wg;    // which 64 keys of a stage
  int f_row[2], q_pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    f_row[h] = f0 + row_grp * 64 + warp * 16 + (lane >> 2) + 8 * h;
    q_pos[h] = q0 + f_row[h] / g;
  }
  const float scale_log2 = a.scale * 1.4426950408889634f;
  float o[D / 2], s[BK / 2];
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  const bool rows_full = f0 + M <= n_rows;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % STAGES;
    // the stage loaded here was released by the barrier that ended the
    // previous tile; STAGES - 1 tiles stay in flight
    if (it + STAGES - 1 < n_tiles) load_tile(lo + (it + STAGES - 1) * SBK, (it + STAGES - 1) % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();   // this tile (and Q) have landed
    fence_proxy_async();
    __syncthreads();

    const int kt = lo + it * SBK + key_part * BK;     // this warpgroup's keys
    const int* valid = valid_s + st * SBK + key_part * BK;
    const uint32_t k_sm = kv_sm + st * STAGE + key_part * SUB;
    const uint32_t v_sm = k_sm + KSPLIT * SUB;
    // S = Q K^T over head_dim in steps of 16 (32 bytes inside a 128-byte row)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      const uint64_t da = make_desc(q_sm + (kk / 4) * M * 128 + row_grp * 64 * 128 + off, 16, 1024);
      const uint64_t db = make_desc(k_sm + (kk / 4) * BK * 128 + off, 16, 1024);
      wgmma_ss_m64n64k16(s, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<BK / 2>(s);

    // mask by position, online softmax in float32 (base 2) per row; each
    // row's max is shared by its 4 lanes, its sum stays per lane until the
    // end. A tile that every row of the CTA sees whole skips the mask.
    bool interior = rows_full && kt + BK <= kvl && (!a.causal || kt + BK - 1 <= q0 + qi_lo) &&
                    (a.window <= 0 || q0 + qi_hi - kt < a.window);
    if (PAGED)
      for (int j = 0; interior && j < BK; j += 32) interior = valid[j + lane] != 0;
    interior = __all_sync(0xffffffffu, interior);
    if (interior) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] *= scale_log2;
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool row_ok = f_row[h] < n_rows;
#pragma unroll
        for (int c = 0; c < BK / 4; ++c) {
          const int i = 4 * (c / 2) + 2 * h + (c % 2);
          const int j = 8 * (c / 2) + 2 * quad + (c % 2), t = kt + j;
          const bool ok = row_ok && valid[j] && (!a.causal || t <= q_pos[h]) &&
                          (a.window <= 0 || q_pos[h] - t < a.window);
          s[i] = ok ? s[i] * scale_log2 : -CUDART_INF_F;
        }
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < BK / 4; ++c) mx = fmaxf(mx, s[4 * (c / 2) + 2 * h + (c % 2)]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[h], mx);
      corr[h] = m_new == -CUDART_INF_F ? 1.f : exp2f(m_run[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < BK / 4; ++c) {
        const int i = 4 * (c / 2) + 2 * h + (c % 2);
        s[i] = s[i] == -CUDART_INF_F ? 0.f : exp2f(s[i] - m_new);
        sum += s[i];
      }
      l_run[h] = l_run[h] * corr[h] + sum;
      m_run[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= corr[0];
      o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1];
      o[4 * j + 3] *= corr[1];
    }
    // P to bf16 in registers: the accumulator of 16 keys is wgmma's A fragment
    uint32_t p[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);

    // O += P V, V read MN-major: 16 keys (two 8-row groups) a step
    fence_regs<D / 2>(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_pv<D>(o, p[kk], make_desc(v_sm + kk * 16 * 128, BK * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<D / 2>(o);
    __syncthreads();        // every warpgroup is done with this stage
  }
  cp_async_wait<0>();

  if (KSPLIT == 2) {
    // the second key half hands its state to the first through shared
    // memory (free now), laid out [value][thread] so the accesses are
    // conflict-free; the first merges and writes
    float* xs = reinterpret_cast<float*>(tc_smem + (kv_sm - raw));
    const int t = tid % 128;
    __syncthreads();
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) xs[i * 128 + t] = o[i];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        xs[(D / 2 + h) * 128 + t] = m_run[h];
        xs[(D / 2 + 2 + h) * 128 + t] = l_run[h];
      }
    }
    __syncthreads();
    if (wg == 1) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m1 = xs[(D / 2 + h) * 128 + t];
      const float mx = fmaxf(m_run[h], m1);
      const float c0 = mx == -CUDART_INF_F ? 0.f : exp2f(m_run[h] - mx);
      const float c1 = mx == -CUDART_INF_F ? 0.f : exp2f(m1 - mx);
      l_run[h] = l_run[h] * c0 + xs[(D / 2 + 2 + h) * 128 + t] * c1;
      m_run[h] = mx;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 2 * h] = o[4 * j + 2 * h] * c0 + xs[(4 * j + 2 * h) * 128 + t] * c1;
        o[4 * j + 2 * h + 1] = o[4 * j + 2 * h + 1] * c0 + xs[(4 * j + 2 * h + 1) * 128 + t] * c1;
      }
    }
  }

  T* out = static_cast<T*>(a.out) + row * a.o_sb;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (f_row[h] >= n_rows) continue;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    // the row's log-sum-exp, from the base-2 running max and sum
    if (a.lse != nullptr && quad == 0)
      a.lse[((long long)row * gridDim.y * g + kvh * g + f_row[h] % g) * a.sq + f_row[h] / g] =
          (m_run[h] + log2f(l)) * 0.6931471805599453f;
    T* dst = out + (kvh * g + f_row[h] % g) * a.o_sh + (f_row[h] / g) * a.o_ss + 2 * quad;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
  }
}

template <int D, int NWG, int KSPLIT, bool PAGED>
static int launch_tc(const FlashArgs& a, int rows, int KV, cudaStream_t stream) {
  using Sh = TcShape<D, NWG, KSPLIT>;
  const size_t smem = Sh::SMEM + (PAGED ? sizeof(int) * a.mb : 0);
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<D, NWG, KSPLIT, PAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(rows, KV, (a.sq * a.g + Sh::M - 1) / Sh::M);
  flash_tc_kernel<D, NWG, KSPLIT, PAGED><<<grid, Sh::NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool PAGED>
static int launch_core(const FlashArgs& a, int rows, int H, cudaStream_t s) {
  return a.sq <= 32 ? launch<T, D, 32, PAGED>(a, rows, H, s) : launch<T, D, 64, PAGED>(a, rows, H, s);
}

// The tensor-core body's CTA tiles, by the host's plan: 0 = 64 rows, one
// warpgroup; 1 = 128 rows, two warpgroups sharing each key tile; 2 = 64
// rows, two warpgroups each taking half of every key tile (head_dim <= 128)
template <int D, bool PAGED>
static int launch_tc_tile(const FlashArgs& a, int rows, int KV, int tile, cudaStream_t s) {
  if (tile == 0) return launch_tc<D, 1, 1, PAGED>(a, rows, KV, s);
  if (tile == 1) return launch_tc<D, 2, 1, PAGED>(a, rows, KV, s);
  if constexpr (D <= 128)
    if (tile == 2) return launch_tc<D, 2, 2, PAGED>(a, rows, KV, s);
  return (int)cudaErrorInvalidValue;
}

// tile: the body the host planned, -1 for the CUDA-core body, else the
// tensor-core body's CTA tile (launch_tc_tile; bf16 at head_dim 64 / 128 /
// 256 only). The CUDA-core body serves float32 and bf16 at head_dim 16 / 32.
template <bool PAGED>
static int dispatch(const FlashArgs& a, int rows, int H, int KV, int D, int dtype,
                    int tile, cudaStream_t s) {
  if (dtype != kF32 && dtype != kBF16) return (int)cudaErrorInvalidValue;
  if (tile >= 0 && dtype != kBF16) return (int)cudaErrorInvalidValue;
  if (rows == 0 || a.sq == 0) return 0;
  if (tile >= 0) {
    switch (D) {
      case 64: return launch_tc_tile<64, PAGED>(a, rows, KV, tile, s);
      case 128: return launch_tc_tile<128, PAGED>(a, rows, KV, tile, s);
      case 256: return launch_tc_tile<256, PAGED>(a, rows, KV, tile, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == kBF16) {
    switch (D) {
      case 16: return launch_core<__nv_bfloat16, 16, PAGED>(a, rows, H, s);
      case 32: return launch_core<__nv_bfloat16, 32, PAGED>(a, rows, H, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (D) {
    case 16: return launch_core<float, 16, PAGED>(a, rows, H, s);
    case 32: return launch_core<float, 32, PAGED>(a, rows, H, s);
    case 64: return launch_core<float, 64, PAGED>(a, rows, H, s);
    case 128: return launch_core<float, 128, PAGED>(a, rows, H, s);
    case 256: return launch_core<float, 256, PAGED>(a, rows, H, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro_torch

using namespace repro_torch;

// Dense entry: q (B, H, Sq, D), k / v (B, KV, Sk, D), out like q. Query i and
// key j sit at positions i and j. lse, where not null, receives each row's
// float32 log-sum-exp (B, H, Sq) contiguous: what the backward recomputes
// the softmax from (flash_attention_bwd.cu). Returns cudaGetLastError()
// after the launch.
extern "C" int flash_attention_dense_launch(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int KV, int Sq, int Sk, int D, int causal, int window, long long q_sb,
    long long q_sh, long long q_ss, long long o_sb, long long o_sh,
    long long o_ss, long long k_sb, long long k_skv, long long k_ss,
    long long v_sb, long long v_skv, long long v_ss, float scale, int dtype,
    int tile, void* lse, void* stream) {
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  FlashArgs a{q, k, v, out, nullptr, nullptr, nullptr, Sq, H / KV, Sk, 1, 0,
              causal, window, q_sb, q_ss, q_sh, o_sb, o_ss, o_sh,
              k_sb, k_skv, k_ss, v_sb, v_skv, v_ss, scale, static_cast<float*>(lse)};
  return dispatch<false>(a, B, H, KV, D, dtype, tile, static_cast<cudaStream_t>(stream));
}

// Paged chunk entry: q (R, C, H, D) bshk with query c of row r at position
// q_start[r] + c; keys at positions < kv_len[r] read from the (KV, P, bs, D)
// pool through tables (R, MB); causal. Returns cudaGetLastError().
extern "C" int flash_attention_paged_launch(
    const void* q, const void* k, const void* v, const void* tables,
    const void* q_start, const void* kv_len, void* out, int R, int C, int H,
    int KV, int D, int page_size, int mb, long long q_sb, long long q_ss,
    long long q_sh, long long o_sb, long long o_ss, long long o_sh,
    long long k_skv, long long k_sp, long long v_skv, long long v_sp,
    float scale, int dtype, int tile, void* stream) {
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  FlashArgs a{q, k, v, out, static_cast<const int*>(tables),
              static_cast<const int*>(q_start), static_cast<const int*>(kv_len),
              C, H / KV, 0, page_size, mb, 1, 0,
              q_sb, q_ss, q_sh, o_sb, o_ss, o_sh,
              0, k_skv, k_sp, 0, v_skv, v_sp, scale};
  return dispatch<true>(a, R, H, KV, D, dtype, tile, static_cast<cudaStream_t>(stream));
}
