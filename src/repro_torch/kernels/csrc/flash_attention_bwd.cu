// Backward of flash attention's dense entry for Hopper (sm_90a), CUDA C++.
//
// Replaces: the gradient that jax.grad derives for
//   src/repro/models/attention.py :: attention
// on the reference's training path (TransformerLM.loss through
// attention_any, dense causal or windowed self-attention with GQA). There is
// no Pallas kernel for it: the TPU kernel of the forward
// (src/repro/kernels/flash_attention.py :: flash_attention) has no
// custom_vjp, and the reference differentiates the einsum attention. The
// forward here is kernel 2's dense entry (flash_attention.cu), which saves
// each row's float32 log-sum-exp for this backward.
//
// What it computes, for q (B, H, Sq, D), k / v (B, KV, Sk, D), the forward's
// output o and lse (B, H, Sq), and the output's gradient dO:
//   P  = exp(scale q k^T - lse)            (masked: causal k <= q, window)
//   dV = sum over the g query heads of a KV head of P^T dO
//   dP = dO v^T,  Delta = rowsum(dO o),  dS = P (dP - Delta)
//   dQ = scale dS k,  dK = scale sum over the group of dS^T q
// all in float32, the outputs cast to the inputs' type. Inputs are read
// through their strides (the model's bshk tensors seen as (B, H, S, D)).
//
// What bounds it on an H100: five products of the visible (query, key)
// pairs, 10 D flops a pair and head, far above the bytes it moves: it is
// bounded by operations (Qwen3-8B's attention at B 2 x 2048: 0.174 ms at
// 989 TFLOP/s). Runs must give the same bits, so no sum may depend on the
// order in which CTAs run: no float atomics. That is why dQ keeps a pass
// of its own, which computes S and dP again: 7 products where 5 would do,
// so the design's own floor is 14 D flops a pair (0.243 ms there). A
// single pass summing dQ across key tiles in a fixed order under
// semaphores is a later design.
//
// The bf16 body at head_dim 64 / 128 (what the training path runs; the
// host's plan, flash_attention_bwd.py :: backward_plan, picks body and grid):
//   * every product on wgmma, one consumer warpgroup a CTA owning 64 rows
//     with float32 accumulators in registers. Pass 1 (dQ): S = Q K^T and
//     dP = dO V^T with both operands in shared memory, then dQ += dS K with
//     dS rounded to bf16 in registers as the A fragment (the accumulator's
//     N axis is the next product's reduction axis, the forward's layout
//     identity) and K read MN-major. Pass 2 (dK, dV): S^T = K Q^T and
//     dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q the same way;
//   * each Q, K, V and dO tile is loaded once, bf16 in the 128-byte
//     swizzle of wgmma.cuh, and read both K-major and MN-major;
//   * the streamed tiles (K/V in pass 1; Q/dO with their lse and Delta in
//     pass 2) come through a two-stage cp.async ring, the next tile in
//     flight while this one is used, the forward's ring. This is the
//     build's design, not a fallback. A TMA producer warpgroup feeding two
//     consumer warpgroups through mbarriers was built and measured
//     slower: ptxas holds the consumers to the 240 registers setmaxnreg
//     gives them, the dK/dV pass needs 255, and its wgmmas serialize and
//     spill (PERF.md, Findings). Here two CTAs an SM overlap one's softmax
//     with the other's products;
//   * balance: the grids run the heaviest tiles first under a causal mask
//     (pass 1 the last query tiles, pass 2 the first key tiles). Pass 2
//     either keeps a KV head's g query heads inside the CTA, or splits the
//     group over CTAs, each writing its head's float32 dK / dV share to a
//     scratch that flash_bwd_dkv_sum_kernel adds up in head order (fixed,
//     so deterministic); the plan splits where the unsplit grid's heaviest
//     CTA would be the pass's tail (the train step's batch of 1);
//   * fully masked tiles are skipped; only tiles on the diagonal, the
//     window's edge or the ragged ends test the mask element by element.
// The bf16 body at head_dim 256 (RecurrentGemma-9B's attention: 16 query
// heads on one KV head, window 2048) runs the same two passes on wgmma
// with two consumer warpgroups a CTA (flash_bwd_*_wgmma_d256_kernel):
//   * registers: a 64 x 256 float32 accumulator is 128 registers a thread
//     in one warpgroup, so dK and dV of 64 keys would take 256. Each
//     warpgroup owns 128 of the 256 accumulator columns (64 registers per
//     accumulator, the budget of the 128 body);
//   * the products over the whole head_dim run once, not in both
//     warpgroups: warpgroup 0 computes the scores and P, warpgroup 1 the
//     product with dO (dP or dP^T), and the two trade these float32
//     64 x 64 tiles through shared memory (32 KB); both then form dS from
//     the same values in the same order. Seven products a pair, as at
//     64 / 128. In the dQ pass warpgroup 1 subtracts Delta before the
//     trade, and a streamed tile takes one barrier besides the trade's
//     (the next tile's copy starts right after it, into the stage the
//     previous tile used). The dK/dV pass, at 255 registers, does neither:
//     there the early subtraction cost the unsplit variant 24 bytes of
//     spills, and the one-barrier loop alone timed no faster;
//   * shared memory: resident tiles 64 KB, a two-stage ring of 64-row tiles
//     128 KB, lse / Delta and the trade: 226 KB, one CTA (8 warps) an SM;
//   * the grid: at batch 1 and one KV head the dK/dV pass has only
//     Sk / 64 key tiles (64 at 4096 tokens) for 132 SMs, so the plan splits
//     the group of g query heads into n sub-groups of CTAs (any divisor of
//     g; split_group picks n), each running g / n heads in turn and writing
//     float32 partials (B, KV x n, Sk, D) that flash_bwd_dkv_sum_kernel
//     adds in sub-group order.
// float32 at head_dim 16 / 32 / 64 / 128 / 256, and bf16 at 16 / 32, run
// the CUDA-core body: the same two passes in float32 FMAs on tiles widened
// to float32 in shared memory (rows padded by one against bank conflicts),
// each thread a 4 x 4 block of a tile's scores (and of dP) and 4 rows x
// DA/8 columns of its accumulators, the group's heads inside the CTA. At
// head_dim 256 a CTA owns DA = 128 of the 256 accumulator columns and two
// CTAs split each row tile's columns (blockIdx.x = batch x 2 + half): dK
// and dV of 64 rows at 256 columns alone would take 256 registers a
// thread. Each CTA still computes S and dP over the full head_dim, so
// those products run twice; the tiles take 206 KB (dQ pass) and 215 KB
// (dK/dV pass) of shared memory, one CTA an SM.
// Float32 must not run as TF32, which misses the float32 tolerance.
#include "common.cuh"
#include "wgmma.cuh"

namespace repro_torch {

constexpr int kBwdNT = 128;   // threads a CTA, both passes
constexpr int kDqRows = 64;   // pass 1: query rows a CTA
constexpr int kDqKeys = 32;   // pass 1: keys a tile
constexpr int kKvRows = 64;   // pass 2: key rows a CTA
constexpr int kKvQs = 32;     // pass 2: queries a tile

// element strides of one (B, heads, S, D) tensor, head_dim contiguous
struct Strides {
  long long b, h, s;
};

struct BwdArgs {
  const void *q, *k, *v, *o, *d_o;
  const float* lse;   // (B, H, Sq) contiguous
  float* delta;       // (B, H, Sq) contiguous, written by pass 1
  void *dq, *dk, *dv;
  int h, g, sq, sk, causal, window;
  Strides q_st, o_st, do_st, dq_st, k_st, v_st, dk_st, dv_st;
  float scale;
  float *dk_part, *dv_part;   // (B, KV x n_sub, Sk, D) float32: the split group's partials
  int n_sub;                  // sub-groups a KV head's group is split into (1: not split)
};

// rows [row0, row0 + ROWS) of a strided (S, D) slice into shared memory as
// float32 with leading dimension LD; rows at or past n are zero. 16-byte
// vector loads, all issued before the first store.
// At most 16 vectors a thread are in flight (the 256-wide tiles issue two
// batches).
template <typename T, int D, int ROWS, int LD>
__device__ __forceinline__ void load_rows(float* dst, const T* src, long long stride, int row0,
                                          int n, int tid) {
  constexpr int VEC = Vec<T>::kElems, NV = ROWS * D / VEC, PER = (NV + kBwdNT - 1) / kBwdNT;
  constexpr int BATCH = PER < 16 ? PER : 16;
#pragma unroll
  for (int u0 = 0; u0 < PER; u0 += BATCH) {
    uint4 regs[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = tid + (u0 + u) * kBwdNT, r = i * VEC / D, d = i * VEC % D;
      regs[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < NV && row0 + r < n) regs[u] = load_vec(src + (row0 + r) * stride + d);
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = tid + (u0 + u) * kBwdNT, r = i * VEC / D, d = i * VEC % D;
      if (i < NV) unpack_vec<T>(regs[u], dst + r * LD + d);
    }
  }
}

// accumulator columns a CTA of the CUDA-core body owns, and the CTAs that
// split a row tile's head_dim
template <int D>
struct AccCols {
  static constexpr int DA = D > 128 ? 128 : D, NCH = D / DA;
};

// the forward's mask: key t is seen by query i
__device__ __forceinline__ bool visible(const BwdArgs& a, int i, int t) {
  return i < a.sq && t < a.sk && (!a.causal || t <= i) && (a.window <= 0 || i - t < a.window);
}

// --------------------------------------------------------------------------
// Pass 1: Delta and dQ. One CTA per (b, column half, head, 64 query rows);
// thread (rg, cg) = (tid / 8, tid % 8) owns query rows 4 rg .. 4 rg + 3, the
// tile's keys 4 cg .. 4 cg + 3 and dQ columns c0 + cg + 8 c.
// --------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kBwdNT) flash_bwd_dq_kernel(BwdArgs a) {
  constexpr int BQ = kDqRows, BK = kDqKeys, LD = D + 1, DC = AccCols<D>::DA / 8;
  static_assert(kBwdNT == 2 * BQ && BK == 32, "16 row groups of 4 rows, 8 key groups of 4 keys");
  extern __shared__ float smem[];
  float* q_s = smem;                    // [BQ][LD]
  float* do_s = q_s + BQ * LD;          // [BQ][LD]
  float* k_s = do_s + BQ * LD;          // [BK][LD]
  float* v_s = k_s + BK * LD;           // [BK][LD]
  float* ds_s = v_s + BK * LD;          // [BQ][BK + 1]
  float* lse_s = ds_s + BQ * (BK + 1);  // [BQ]
  float* delta_s = lse_s + BQ;          // [BQ]

  const int b = blockIdx.x / AccCols<D>::NCH, h = blockIdx.y, i0 = blockIdx.z * BQ;
  const int c0 = (blockIdx.x % AccCols<D>::NCH) * AccCols<D>::DA;
  const int tid = threadIdx.x, rg = tid >> 3, cg = tid & 7;
  const int kvh = h / a.g;
  const T* q = static_cast<const T*>(a.q) + b * a.q_st.b + h * a.q_st.h;
  const T* o = static_cast<const T*>(a.o) + b * a.o_st.b + h * a.o_st.h;
  const T* d_o = static_cast<const T*>(a.d_o) + b * a.do_st.b + h * a.do_st.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_st.b + kvh * a.k_st.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_st.b + kvh * a.v_st.h;
  const long long lrow = ((long long)b * a.h + h) * a.sq;

  load_rows<T, D, BQ, LD>(q_s, q, a.q_st.s, i0, a.sq, tid);
  load_rows<T, D, BQ, LD>(do_s, d_o, a.do_st.s, i0, a.sq, tid);
  __syncthreads();
  {
    // Delta = rowsum(dO o): two threads a row, each half of head_dim
    const int r = tid >> 1, half = tid & 1, qi = i0 + r;
    float acc = 0.f;
    if (qi < a.sq) {
      const T* orow = o + qi * a.o_st.s + half * (D / 2);
      const float* drow = do_s + r * LD + half * (D / 2);
#pragma unroll 8
      for (int d = 0; d < D / 2; ++d) acc = fmaf(load_f(orow + d), drow[d], acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      delta_s[r] = acc;
      lse_s[r] = qi < a.sq ? a.lse[lrow + qi] : 0.f;
      if (qi < a.sq && c0 == 0) a.delta[lrow + qi] = acc;
    }
  }
  __syncthreads();

  int q_pos[4];
  float lse_r[4], delta_r[4], acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    q_pos[r] = i0 + rg * 4 + r;
    lse_r[r] = lse_s[rg * 4 + r];
    delta_r[r] = delta_s[rg * 4 + r];
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }
  // keys any row of this tile may see: [lo, hi)
  const int qi_last = min(a.sq, i0 + BQ) - 1;
  int hi = a.sk;
  if (a.causal) hi = min(hi, qi_last + 1);
  int lo = 0;
  if (a.window > 0) lo = max(0, i0 - a.window + 1);
  lo = (lo / BK) * BK;

  for (int kt = lo; kt < hi; kt += BK) {
    __syncthreads();  // the previous tile is done with k_s / v_s
    load_rows<T, D, BK, LD>(k_s, kb, a.k_st.s, kt, a.sk, tid);
    load_rows<T, D, BK, LD>(v_s, vb, a.v_st.s, kt, a.sk, tid);
    __syncthreads();

    // S = q k^T and dP = dO v^T: rows 4 rg + r, keys 4 cg + c
    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
    const float* qr = q_s + (rg * 4) * LD;
    const float* dor = do_s + (rg * 4) * LD;
    const float* kr = k_s + (cg * 4) * LD;
    const float* vr = v_s + (cg * 4) * LD;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], oa[4], kk[4], vv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        qa[r] = qr[r * LD + d];
        oa[r] = dor[r * LD + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kk[c] = kr[c * LD + d];
        vv[c] = vr[c * LD + d];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(qa[r], kk[c], s[r][c]);
          dp[r][c] = fmaf(oa[r], vv[c], dp[r][c]);
        }
    }
    // dS = P (dP - Delta), P recomputed from the forward's lse
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = cg * 4 + c;
        const float p = visible(a, q_pos[r], kt + j) ? expf(s[r][c] * a.scale - lse_r[r]) : 0.f;
        ds_s[(rg * 4 + r) * (BK + 1) + j] = p * (dp[r][c] - delta_r[r]);
      }
    __syncwarp();  // a row group's dS is read only by its own warp

    // dQ[row r, c0 + cg + 8 c] += dS[row r, :] . k[:, c0 + cg + 8 c]
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float dsr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) dsr[r] = ds_s[(rg * 4 + r) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kv = k_s[j * LD + c0 + cg + 8 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(dsr[r], kv, acc[r][c]);
      }
    }
    __syncwarp();  // dS is consumed before the next tile overwrites it
  }

  T* dq = static_cast<T*>(a.dq) + b * a.dq_st.b + h * a.dq_st.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (q_pos[r] >= a.sq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      store_f(dq + q_pos[r] * a.dq_st.s + c0 + cg + 8 * c, acc[r][c] * a.scale);
  }
}

// --------------------------------------------------------------------------
// Pass 2: dK and dV. One CTA per (b, column half, KV head, 64 key rows);
// thread (rg, cg) = (tid / 8, tid % 8) owns key rows 4 rg .. 4 rg + 3, the
// tile's queries 4 cg .. 4 cg + 3 and dK / dV columns c0 + cg + 8 c. The g
// query heads of the KV head run one after the other inside the CTA.
// --------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kBwdNT) flash_bwd_dkv_kernel(BwdArgs a) {
  constexpr int BR = kKvRows, BQ = kKvQs, LD = D + 1, DC = AccCols<D>::DA / 8, PL = BQ + 1;
  static_assert(kBwdNT == 2 * BR && BQ == 32, "16 row groups of 4 keys, 8 query groups of 4");
  extern __shared__ float smem[];
  float* k_s = smem;                 // [BR][LD]
  float* v_s = k_s + BR * LD;        // [BR][LD]
  float* q_s = v_s + BR * LD;        // [BQ][LD]
  float* do_s = q_s + BQ * LD;       // [BQ][LD]
  float* p_s = do_s + BQ * LD;       // [BR][PL]: P^T
  float* ds_s = p_s + BR * PL;       // [BR][PL]: dS^T
  float* lse_s = ds_s + BR * PL;     // [BQ]
  float* delta_s = lse_s + BQ;       // [BQ]

  const int b = blockIdx.x / AccCols<D>::NCH, kvh = blockIdx.y, t0 = blockIdx.z * BR;
  const int c0 = (blockIdx.x % AccCols<D>::NCH) * AccCols<D>::DA;
  const int tid = threadIdx.x, rg = tid >> 3, cg = tid & 7;
  load_rows<T, D, BR, LD>(k_s, static_cast<const T*>(a.k) + b * a.k_st.b + kvh * a.k_st.h,
                          a.k_st.s, t0, a.sk, tid);
  load_rows<T, D, BR, LD>(v_s, static_cast<const T*>(a.v) + b * a.v_st.b + kvh * a.v_st.h,
                          a.v_st.s, t0, a.sk, tid);

  int k_pos[4];
  float dk[4][DC], dv[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    k_pos[r] = t0 + rg * 4 + r;
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[r][c] = dv[r][c] = 0.f;
  }
  // queries that may see any key of this tile: [qlo, qhi)
  const int t_last = min(a.sk, t0 + BR) - 1;
  const int qlo = a.causal ? (t0 / BQ) * BQ : 0;
  int qhi = a.sq;
  if (a.window > 0) qhi = min(qhi, t_last + a.window);

  for (int hh = 0; hh < a.g; ++hh) {
    const int h = kvh * a.g + hh;
    const T* q = static_cast<const T*>(a.q) + b * a.q_st.b + h * a.q_st.h;
    const T* d_o = static_cast<const T*>(a.d_o) + b * a.do_st.b + h * a.do_st.h;
    const long long lrow = ((long long)b * a.h + h) * a.sq;
    for (int it = qlo; it < qhi; it += BQ) {
      __syncthreads();  // the previous tile is done with q_s / do_s / lse_s
      load_rows<T, D, BQ, LD>(q_s, q, a.q_st.s, it, a.sq, tid);
      load_rows<T, D, BQ, LD>(do_s, d_o, a.do_st.s, it, a.sq, tid);
      if (tid < BQ) {
        const bool ok = it + tid < a.sq;
        lse_s[tid] = ok ? a.lse[lrow + it + tid] : 0.f;
        delta_s[tid] = ok ? a.delta[lrow + it + tid] : 0.f;
      }
      __syncthreads();

      // S^T = k q^T and dP^T = v dO^T: keys 4 rg + r, queries 4 cg + c
      float s[4][4], dp[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
      const float* kr = k_s + (rg * 4) * LD;
      const float* vr = v_s + (rg * 4) * LD;
      const float* qr = q_s + (cg * 4) * LD;
      const float* dor = do_s + (cg * 4) * LD;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float ka[4], va[4], qb[4], ob[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ka[r] = kr[r * LD + d];
          va[r] = vr[r * LD + d];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          qb[c] = qr[c * LD + d];
          ob[c] = dor[c * LD + d];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[r][c] = fmaf(ka[r], qb[c], s[r][c]);
            dp[r][c] = fmaf(va[r], ob[c], dp[r][c]);
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = cg * 4 + c;
          const float p =
              visible(a, it + j, k_pos[r]) ? expf(s[r][c] * a.scale - lse_s[j]) : 0.f;
          p_s[(rg * 4 + r) * PL + j] = p;
          ds_s[(rg * 4 + r) * PL + j] = p * (dp[r][c] - delta_s[j]);
        }
      __syncwarp();  // a row group's P^T / dS^T rows are read only by its own warp

      // dV[key r, :] += P^T[r, :] dO;  dK[key r, :] += dS^T[r, :] q
#pragma unroll 4
      for (int j = 0; j < BQ; ++j) {
        float pr[4], dsr[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pr[r] = p_s[(rg * 4 + r) * PL + j];
          dsr[r] = ds_s[(rg * 4 + r) * PL + j];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float qv = q_s[j * LD + c0 + cg + 8 * c];
          const float ov = do_s[j * LD + c0 + cg + 8 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            dv[r][c] = fmaf(pr[r], ov, dv[r][c]);
            dk[r][c] = fmaf(dsr[r], qv, dk[r][c]);
          }
        }
      }
      __syncwarp();
    }
  }

  T* dkp = static_cast<T*>(a.dk) + b * a.dk_st.b + kvh * a.dk_st.h;
  T* dvp = static_cast<T*>(a.dv) + b * a.dv_st.b + kvh * a.dv_st.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (k_pos[r] >= a.sk) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      store_f(dkp + k_pos[r] * a.dk_st.s + c0 + cg + 8 * c, dk[r][c] * a.scale);
      store_f(dvp + k_pos[r] * a.dv_st.s + c0 + cg + 8 * c, dv[r][c]);
    }
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// --------------------------------------------------------------------------
// wgmma body (bf16, head_dim 64 / 128): one consumer warpgroup a CTA,
// owning 64 rows (queries in pass 1, keys in pass 2) in wgmma's accumulator
// layout (warp w rows 16 w .. 16 w + 15, lane l rows l / 4 and l / 4 + 8,
// columns 8 j + 2 (l % 4) + {0, 1}); the streamed tiles are 64 rows too.
// Every tile sits once in shared memory in the 128-byte swizzle of
// wgmma.cuh and is read K-major (the A or B of S, dP) and MN-major (the B
// of dQ, dK, dV). Two CTAs share an SM at head_dim 128 (shared memory and
// registers), so one's softmax runs beside the other's products.
// --------------------------------------------------------------------------
constexpr int kWgRows = 64;     // rows a CTA owns, and rows of a streamed tile
constexpr int kWgStages = 2;    // the ring: the next tile in flight while this one is used
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct WgShape {
  static constexpr uint32_t TILE = kWgRows * D * 2;     // one swizzled 64-row bf16 tile
  // two resident tiles (Q and dO, or K and V), then kWgStages stages of two
  // streamed tiles and 2 x 64 floats (pass 2's lse and Delta of a tile;
  // pass 1 keeps its rows' lse and Delta there)
  static constexpr size_t SMEM = 1024 + 2 * TILE + kWgStages * (2 * TILE + 2 * kWgRows * 4);
};

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// rows [row0, row0 + 64) of a strided (S, D) bf16 slice into a swizzled
// tile with cp.async; rows at or past n are zero. Not waited on.
template <int D, int NT = 128>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src, long long stride,
                                          int row0, int n, int tid) {
  constexpr int CPR = D / 8;
#pragma unroll
  for (int u = 0; u < kWgRows * CPR / NT; ++u) {
    const int i = tid + u * NT, r = i / CPR, c = (i % CPR) * 8;
    const bool ok = row0 + r < n;
    cp_async16(dst + swz_offset(r, c, kWgRows), ok ? src + (row0 + r) * stride + c : src, ok);
  }
}

// acc (64 x 64) = A (64 x D) * B^T, A and B 64-row tiles read K-major
template <int D>
__device__ __forceinline__ void wgmma_rows_rows(float* acc, uint32_t a_sm, uint32_t b_sm) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kWgRows * 128 + (kk % 4) * 32;
    wgmma_ss_m64n64k16(acc, make_desc(a_sm + off, 16, 1024), make_desc(b_sm + off, 16, 1024), kk > 0);
  }
}

// acc (64 x D) += A (64 x 64, bf16 A fragments in registers) * tile (64 x D,
// read MN-major: the tile's rows are the reduction axis)
template <int D>
__device__ __forceinline__ void wgmma_regs_tile(float* acc, const uint32_t (*a)[4], uint32_t b_sm) {
#pragma unroll
  for (int kk = 0; kk < kWgRows / 16; ++kk) {
    const uint64_t desc = make_desc(b_sm + kk * 16 * 128, kWgRows * 128, 1024);
    if constexpr (D == 64) wgmma_rs_m64n64k16(acc, a[kk], desc);
    else wgmma_rs_m64n128k16(acc, a[kk], desc);
  }
}

// a 64 x 64 float32 accumulator rounded to bf16 as the A fragments of the
// next product: its N axis is that product's reduction axis
__device__ __forceinline__ void to_a_fragments(const float* acc, uint32_t (*a)[4]) {
#pragma unroll
  for (int kk = 0; kk < kWgRows / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[kk][e] = pack2(acc[8 * kk + 2 * e], acc[8 * kk + 2 * e + 1]);
}

// 2^x on the SFU, denormal results flushed to zero (a probability that
// small rounds away in bf16 anyway)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// accumulator element i of a 64 x 64 tile: which of the thread's two rows
// (0, 1) and which column
__device__ __forceinline__ int acc_half(int i) { return (i >> 1) & 1; }
__device__ __forceinline__ int acc_col(int i, int quad) { return 8 * (i >> 2) + 2 * quad + (i & 1); }

// Pass 1: Delta and dQ. One CTA per (head, b, 64 query rows); the grid's
// z runs the query tiles last first under a causal mask (the last rows see
// the most keys, so the longest CTAs start first). K/V tiles of 64 keys
// stream through the ring.
template <int D>
__global__ void __launch_bounds__(128) flash_bwd_dq_wgmma_kernel(BwdArgs a) {
  using T = __nv_bfloat16;
  constexpr int BQ = kWgRows, BK = kWgRows, STAGES = kWgStages;
  constexpr uint32_t TILE = WgShape<D>::TILE;
  extern __shared__ uint8_t wg_smem[];
  const uint32_t raw = smem_addr(wg_smem);
  const uint32_t q_sm = (raw + 1023u) & ~1023u;     // swizzled tiles start 1024-aligned
  const uint32_t do_sm = q_sm + TILE;
  const uint32_t kv_sm = do_sm + TILE;               // stage s: K at kv_sm + 2 s TILE, then V
  uint8_t* base = wg_smem + (q_sm - raw);
  float* row_s = reinterpret_cast<float*>(base + 2 * TILE + STAGES * 2 * TILE);   // lse[64], Delta[64]

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = a.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int i0 = qt * BQ, tid = threadIdx.x, kvh = h / a.g;
  const T* q = static_cast<const T*>(a.q) + b * a.q_st.b + h * a.q_st.h;
  const T* o = static_cast<const T*>(a.o) + b * a.o_st.b + h * a.o_st.h;
  const T* d_o = static_cast<const T*>(a.d_o) + b * a.do_st.b + h * a.do_st.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_st.b + kvh * a.k_st.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_st.b + kvh * a.v_st.h;
  const long long lrow = ((long long)b * a.h + h) * a.sq;

  load_tile<D>(q_sm, q, a.q_st.s, i0, a.sq, tid);
  load_tile<D>(do_sm, d_o, a.do_st.s, i0, a.sq, tid);
  cp_async_commit();

  // keys any row of this tile may see: [lo, hi)
  const int qi_last = min(a.sq, i0 + BQ) - 1;
  int hi = a.sk;
  if (a.causal) hi = min(hi, qi_last + 1);
  int lo = 0;
  if (a.window > 0) lo = max(0, i0 - a.window + 1);
  lo = (lo / BK) * BK;
  const int n_tiles = hi > lo ? (hi - lo + BK - 1) / BK : 0;
  auto load_kv = [&](int it, int st) {
    const uint32_t k_dst = kv_sm + st * 2 * TILE;
    load_tile<D>(k_dst, kb, a.k_st.s, lo + it * BK, a.sk, tid);
    load_tile<D>(k_dst + TILE, vb, a.v_st.s, lo + it * BK, a.sk, tid);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load_kv(s, s);
    cp_async_commit();
  }

  // Delta = rowsum(dO o): two threads a row, 16-byte loads of o from device
  // memory and of dO from its tile
  cp_async_wait<STAGES - 1>();     // Q and dO have landed
  __syncthreads();
  {
    const int r = tid >> 1, half = tid & 1, qi = i0 + r;
    float acc = 0.f;
    if (qi < a.sq) {
#pragma unroll
      for (int c = half * D / 2; c < (half + 1) * D / 2; c += 8) {
        float of[8], df[8];
        unpack_vec<T>(load_vec(o + qi * a.o_st.s + c), of);
        unpack_vec<T>(*reinterpret_cast<const uint4*>(base + TILE + swz_offset(r, c, BQ)), df);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc = fmaf(of[e], df[e], acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      row_s[r] = qi < a.sq ? a.lse[lrow + qi] : 0.f;
      row_s[BQ + r] = acc;
      if (qi < a.sq) a.delta[lrow + qi] = acc;
    }
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5, quad = lane & 3;
  int q_pos[2];
  float lse2[2], delta_r[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = warp * 16 + (lane >> 2) + 8 * hf;
    q_pos[hf] = i0 + r;
    lse2[hf] = row_s[r] * kLog2e;
    delta_r[hf] = row_s[BQ + r];
  }
  const float scale_log2 = a.scale * kLog2e;
  const bool rows_full = i0 + BQ <= a.sq;
  float dq[D / 2], s[BK / 2], dp[BK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % STAGES;
    // the stage loaded here was released by the barrier that ended the
    // previous tile; STAGES - 1 tiles stay in flight
    if (it + STAGES - 1 < n_tiles) load_kv(it + STAGES - 1, (it + STAGES - 1) % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    fence_proxy_async();
    __syncthreads();

    const int kt = lo + it * BK;
    const uint32_t k_sm = kv_sm + st * 2 * TILE, v_sm = k_sm + TILE;
    // S and dP as two groups: P is computed while dP is still running
    wgmma_fence();
    wgmma_rows_rows<D>(s, q_sm, k_sm);       // S = Q K^T
    wgmma_commit();
    wgmma_rows_rows<D>(dp, do_sm, v_sm);     // dP = dO V^T
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs<BK / 2>(s);

    // P recomputed from the forward's lse; only tiles on the diagonal, the
    // window's edge or the ragged ends test the mask
    const bool interior = rows_full && kt + BK <= a.sk && (!a.causal || kt + BK - 1 <= i0) &&
                          (a.window <= 0 || i0 + BQ - 1 - kt < a.window);
    if (interior) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = exp2_ftz(fmaf(s[i], scale_log2, -lse2[acc_half(i)]));
    } else {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int hf = acc_half(i);
        s[i] = visible(a, q_pos[hf], kt + acc_col(i, quad)) ? exp2_ftz(fmaf(s[i], scale_log2, -lse2[hf])) : 0.f;
      }
    }
    wgmma_wait<0>();
    fence_regs<BK / 2>(dp);
    // dS = P (dP - Delta)
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] *= dp[i] - delta_r[acc_half(i)];
    uint32_t ds[BK / 16][4];
    to_a_fragments(s, ds);
    fence_regs<D / 2>(dq);
    wgmma_fence();
    wgmma_regs_tile<D>(dq, ds, k_sm);        // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<D / 2>(dq);
    __syncthreads();                         // every warp is done with this stage
  }
  cp_async_wait<0>();

  T* dqp = static_cast<T*>(a.dq) + b * a.dq_st.b + h * a.dq_st.h;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (q_pos[hf] >= a.sq) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dqp + q_pos[hf] * a.dq_st.s + 8 * j + 2 * quad) =
          pack2(dq[4 * j + 2 * hf] * a.scale, dq[4 * j + 2 * hf + 1] * a.scale);
  }
}

// Pass 2: dK and dV. One CTA per (x, b, 64 keys), the grid's z running the
// key tiles first to last (under a causal mask the first keys are seen by
// the most queries). SPLIT: x is a query head, and the CTA writes that
// head's float32 share of dK and dV to the partials (B, H, Sk, D), which
// flash_bwd_dkv_sum_kernel adds up over the group in a fixed head order.
// Otherwise x is a KV head and the CTA runs the g heads of its group in
// turn, writing dK and dV itself. Q/dO tiles of 64 queries, with their lse
// and Delta, stream through the ring.
template <int D, bool SPLIT>
__global__ void __launch_bounds__(128) flash_bwd_dkv_wgmma_kernel(BwdArgs a) {
  using T = __nv_bfloat16;
  constexpr int BR = kWgRows, BQ = kWgRows, STAGES = kWgStages;
  constexpr uint32_t TILE = WgShape<D>::TILE;
  extern __shared__ uint8_t wg_smem[];
  const uint32_t raw = smem_addr(wg_smem);
  const uint32_t k_sm = (raw + 1023u) & ~1023u;
  const uint32_t v_sm = k_sm + TILE;
  const uint32_t qd_sm = v_sm + TILE;                // stage s: Q at qd_sm + 2 s TILE, then dO
  const uint32_t col_sm = qd_sm + STAGES * 2 * TILE; // stage s: lse[64], Delta[64] at col_sm + 512 s
  const float* col_s = reinterpret_cast<const float*>(wg_smem + (col_sm - raw));

  const int x = blockIdx.x, b = blockIdx.y, t0 = blockIdx.z * BR, tid = threadIdx.x;
  const int kvh = SPLIT ? x / a.g : x;
  const int h0 = SPLIT ? x : kvh * a.g, n_heads = SPLIT ? 1 : a.g;
  load_tile<D>(k_sm, static_cast<const T*>(a.k) + b * a.k_st.b + kvh * a.k_st.h, a.k_st.s, t0, a.sk, tid);
  load_tile<D>(v_sm, static_cast<const T*>(a.v) + b * a.v_st.b + kvh * a.v_st.h, a.v_st.s, t0, a.sk, tid);
  cp_async_commit();

  // queries that may see any key of this tile: [qlo, qhi)
  const int t_last = min(a.sk, t0 + BR) - 1;
  const int qlo = a.causal ? t0 : 0;
  int qhi = a.sq;
  if (a.window > 0) qhi = min(qhi, t_last + a.window);
  const int n_qt = qhi > qlo ? (qhi - qlo + BQ - 1) / BQ : 0;
  const int n_tiles = n_heads * n_qt;
  auto load_q = [&](int it, int st) {
    const int h = h0 + it / n_qt, i0 = qlo + (it % n_qt) * BQ;
    const uint32_t q_dst = qd_sm + st * 2 * TILE;
    load_tile<D>(q_dst, static_cast<const T*>(a.q) + b * a.q_st.b + h * a.q_st.h, a.q_st.s, i0, a.sq, tid);
    load_tile<D>(q_dst + TILE, static_cast<const T*>(a.d_o) + b * a.do_st.b + h * a.do_st.h, a.do_st.s, i0,
                 a.sq, tid);
    // lse (threads 0-63) and Delta (64-127) of the tile's queries, 0 past Sq
    const int c = tid & (BQ - 1), qi = i0 + c;
    const float* src = (tid < BQ ? a.lse : a.delta) + ((long long)b * a.h + h) * a.sq;
    cp_async4(col_sm + st * 2 * BQ * 4 + tid * 4, qi < a.sq ? src + qi : src, qi < a.sq);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load_q(s, s);
    cp_async_commit();
  }

  const int lane = tid & 31, warp = tid >> 5, quad = lane & 3;
  int t_pos[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) t_pos[hf] = t0 + warp * 16 + (lane >> 2) + 8 * hf;
  const float scale_log2 = a.scale * kLog2e;
  float dk[D / 2], dv[D / 2], s[BQ / 2], dp[BQ / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % STAGES;
    if (it + STAGES - 1 < n_tiles) load_q(it + STAGES - 1, (it + STAGES - 1) % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    fence_proxy_async();
    __syncthreads();

    const int i0 = qlo + (it % n_qt) * BQ;
    const uint32_t q_sm = qd_sm + st * 2 * TILE, do_sm = q_sm + TILE;
    const float* lse_c = col_s + st * 2 * BQ;
    const float* delta_c = lse_c + BQ;
    // one group: split in two (P^T beside dP^T's product, as pass 1 does)
    // it needs registers the accumulators of dK and dV leave no room for
    wgmma_fence();
    wgmma_rows_rows<D>(s, k_sm, q_sm);       // S^T = K Q^T
    wgmma_rows_rows<D>(dp, v_sm, do_sm);     // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<BQ / 2>(s);
    fence_regs<BQ / 2>(dp);

    // P^T and dS^T = P^T (dP^T - Delta); lse and Delta belong to the columns
    const bool interior = t0 + BR <= a.sk && i0 + BQ <= a.sq && (!a.causal || t0 + BR - 1 <= i0) &&
                          (a.window <= 0 || i0 + BQ - 1 - t0 < a.window);
    if (interior) {
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int c = acc_col(i, quad);
        const float p = exp2_ftz(fmaf(s[i], scale_log2, -lse_c[c] * kLog2e));
        s[i] = p;
        dp[i] = p * (dp[i] - delta_c[c]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int c = acc_col(i, quad);
        const float p = visible(a, i0 + c, t_pos[acc_half(i)])
                            ? exp2_ftz(fmaf(s[i], scale_log2, -lse_c[c] * kLog2e)) : 0.f;
        s[i] = p;
        dp[i] = p * (dp[i] - delta_c[c]);
      }
    }
    uint32_t pt[BQ / 16][4], dst[BQ / 16][4];
    to_a_fragments(s, pt);
    to_a_fragments(dp, dst);
    fence_regs<D / 2>(dv);
    fence_regs<D / 2>(dk);
    wgmma_fence();
    wgmma_regs_tile<D>(dv, pt, do_sm);       // dV += P^T dO
    wgmma_regs_tile<D>(dk, dst, q_sm);       // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<D / 2>(dv);
    fence_regs<D / 2>(dk);
    __syncthreads();
  }
  cp_async_wait<0>();   // a CTA with no query tile still drains its K/V copies

  if constexpr (SPLIT) {
    const long long row = ((long long)b * a.h + h0) * a.sk;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (t_pos[hf] >= a.sk) continue;
      float* kp = a.dk_part + (row + t_pos[hf]) * D + 2 * quad;
      float* vp = a.dv_part + (row + t_pos[hf]) * D + 2 * quad;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<float2*>(kp + 8 * j) =
            make_float2(dk[4 * j + 2 * hf] * a.scale, dk[4 * j + 2 * hf + 1] * a.scale);
        *reinterpret_cast<float2*>(vp + 8 * j) = make_float2(dv[4 * j + 2 * hf], dv[4 * j + 2 * hf + 1]);
      }
    }
  } else {
    T* dkp = static_cast<T*>(a.dk) + b * a.dk_st.b + kvh * a.dk_st.h;
    T* dvp = static_cast<T*>(a.dv) + b * a.dv_st.b + kvh * a.dv_st.h;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (t_pos[hf] >= a.sk) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dkp + t_pos[hf] * a.dk_st.s + 8 * j + 2 * quad) =
            pack2(dk[4 * j + 2 * hf] * a.scale, dk[4 * j + 2 * hf + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(dvp + t_pos[hf] * a.dv_st.s + 8 * j + 2 * quad) =
            pack2(dv[4 * j + 2 * hf], dv[4 * j + 2 * hf + 1]);
      }
    }
  }
}

// dK and dV of each KV head: the n_sub float32 partials of its sub-groups
// (at head_dim 64 / 128 one a query head) added in order (a fixed order, so
// two runs give the same bits) and cast to bf16. One thread a (b, KV head,
// key, 8 values of head_dim).
template <int D>
__global__ void __launch_bounds__(256) flash_bwd_dkv_sum_kernel(BwdArgs a, int B, int KV) {
  using T = __nv_bfloat16;
  constexpr int CH = D / 8;
  const long long n = (long long)B * KV * a.sk * CH;
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n; i += (long long)gridDim.x * 256) {
    const int c = (int)(i % CH) * 8;
    long long r = i / CH;
    const int t = (int)(r % a.sk);
    r /= a.sk;
    const int kvh = (int)(r % KV), b = (int)(r / KV);
    float k8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, v8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int hh = 0; hh < a.n_sub; ++hh) {
      const long long off = (((long long)b * KV * a.n_sub + kvh * a.n_sub + hh) * a.sk + t) * D + c;
      const float4 k0 = *reinterpret_cast<const float4*>(a.dk_part + off);
      const float4 k1 = *reinterpret_cast<const float4*>(a.dk_part + off + 4);
      const float4 v0 = *reinterpret_cast<const float4*>(a.dv_part + off);
      const float4 v1 = *reinterpret_cast<const float4*>(a.dv_part + off + 4);
      k8[0] += k0.x; k8[1] += k0.y; k8[2] += k0.z; k8[3] += k0.w;
      k8[4] += k1.x; k8[5] += k1.y; k8[6] += k1.z; k8[7] += k1.w;
      v8[0] += v0.x; v8[1] += v0.y; v8[2] += v0.z; v8[3] += v0.w;
      v8[4] += v1.x; v8[5] += v1.y; v8[6] += v1.z; v8[7] += v1.w;
    }
    const uint4 kw = make_uint4(pack2(k8[0], k8[1]), pack2(k8[2], k8[3]), pack2(k8[4], k8[5]), pack2(k8[6], k8[7]));
    const uint4 vw = make_uint4(pack2(v8[0], v8[1]), pack2(v8[2], v8[3]), pack2(v8[4], v8[5]), pack2(v8[6], v8[7]));
    *reinterpret_cast<uint4*>(static_cast<T*>(a.dk) + b * a.dk_st.b + kvh * a.dk_st.h + t * a.dk_st.s + c) = kw;
    *reinterpret_cast<uint4*>(static_cast<T*>(a.dv) + b * a.dv_st.b + kvh * a.dv_st.h + t * a.dv_st.s + c) = vw;
  }
}

// --------------------------------------------------------------------------
// wgmma body at head_dim 256 (bf16; RecurrentGemma-9B's attention): two
// consumer warpgroups a CTA (256 threads) over the same 64 rows, each owning
// 128 of the 256 accumulator columns (dQ in pass 1, dK and dV in pass 2:
// 64 float32 registers a thread each, the head_dim 128 body's budget). The
// products that reduce over the whole head_dim are not computed twice:
// warpgroup 0 computes the scores (S, or S^T = K Q^T) and the
// probabilities, warpgroup 1 the products with dO (dP, or dP^T = V dO^T),
// both over all 256 columns, and they trade the two float32 accumulators
// through shared memory (16 KB each). Both then form dS = P (dP - Delta)
// from the same values and run their half of the accumulating products.
// Seven products a (query, key) pair, as at 64 / 128.
// The tiles (64 rows, 32 KB each in the 128-byte swizzle), the two-stage
// cp.async ring and the two traded accumulators take 226 KB of shared
// memory: one CTA (8 warps) an SM.
// --------------------------------------------------------------------------
constexpr int kPairThreads = 256;

struct PairShape {
  static constexpr int D = 256;
  static constexpr uint32_t TILE = kWgRows * D * 2;                // one swizzled 64-row tile
  static constexpr uint32_t ROWS = kWgStages * 2 * kWgRows * 4;    // lse and Delta (a stage each in pass 2)
  static constexpr uint32_t XCH = 2 * kWgRows * kWgRows * 4;       // the two traded 64 x 64 accumulators
  // two resident tiles, kWgStages stages of two streamed tiles, lse / Delta, the trade
  static constexpr size_t SMEM = 1024 + 2 * TILE + kWgStages * 2 * TILE + ROWS + XCH;
};
static_assert(PairShape::SMEM <= 232448, "one CTA's shared memory on an H100");

// a 64 x 64 accumulator (32 floats a thread) written to this warpgroup's
// half of the trade and the other warpgroup's read back: element i of
// thread t at [i][t], so a warp's accesses are 32 consecutive words
__device__ __forceinline__ void trade_put(float* xch, int wg, int wtid, const float* acc) {
  float* mine = xch + wg * (kWgRows / 2) * 128 + wtid;
#pragma unroll
  for (int i = 0; i < kWgRows / 2; ++i) mine[i * 128] = acc[i];
}
__device__ __forceinline__ void trade_get(const float* xch, int wg, int wtid, float* acc) {
  const float* theirs = xch + (1 - wg) * (kWgRows / 2) * 128 + wtid;
#pragma unroll
  for (int i = 0; i < kWgRows / 2; ++i) acc[i] = theirs[i * 128];
}

// Pass 1 at head_dim 256: Delta and dQ. One CTA per (head, b, 64 query
// rows), the query tiles last first under a causal mask; K/V tiles of 64
// keys stream through the ring. Warpgroup 0: S = Q K^T and P; warpgroup 1:
// dP = dO V^T; each: dQ[:, 128 wg ..] += dS K[:, 128 wg ..].
__global__ void __launch_bounds__(kPairThreads, 1) flash_bwd_dq_wgmma_d256_kernel(BwdArgs a) {
  using T = __nv_bfloat16;
  constexpr int D = PairShape::D, BQ = kWgRows, BK = kWgRows, STAGES = kWgStages, NT = kPairThreads;
  constexpr uint32_t TILE = PairShape::TILE;
  extern __shared__ uint8_t wg_smem[];
  const uint32_t raw = smem_addr(wg_smem);
  const uint32_t q_sm = (raw + 1023u) & ~1023u;
  const uint32_t do_sm = q_sm + TILE;
  const uint32_t kv_sm = do_sm + TILE;               // stage s: K at kv_sm + 2 s TILE, then V
  uint8_t* base = wg_smem + (q_sm - raw);
  float* row_s = reinterpret_cast<float*>(base + 2 * TILE + STAGES * 2 * TILE);   // lse[64], Delta[64]
  float* xch = reinterpret_cast<float*>(base + 2 * TILE + STAGES * 2 * TILE + PairShape::ROWS);

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = a.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int i0 = qt * BQ, tid = threadIdx.x, kvh = h / a.g;
  const int wg = tid >> 7, wtid = tid & 127;
  const T* q = static_cast<const T*>(a.q) + b * a.q_st.b + h * a.q_st.h;
  const T* o = static_cast<const T*>(a.o) + b * a.o_st.b + h * a.o_st.h;
  const T* d_o = static_cast<const T*>(a.d_o) + b * a.do_st.b + h * a.do_st.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_st.b + kvh * a.k_st.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_st.b + kvh * a.v_st.h;
  const long long lrow = ((long long)b * a.h + h) * a.sq;

  load_tile<D, NT>(q_sm, q, a.q_st.s, i0, a.sq, tid);
  load_tile<D, NT>(do_sm, d_o, a.do_st.s, i0, a.sq, tid);
  cp_async_commit();

  // keys any row of this tile may see: [lo, hi)
  const int qi_last = min(a.sq, i0 + BQ) - 1;
  int hi = a.sk;
  if (a.causal) hi = min(hi, qi_last + 1);
  int lo = 0;
  if (a.window > 0) lo = max(0, i0 - a.window + 1);
  lo = (lo / BK) * BK;
  const int n_tiles = hi > lo ? (hi - lo + BK - 1) / BK : 0;
  auto load_kv = [&](int it, int st) {
    const uint32_t k_dst = kv_sm + st * 2 * TILE;
    load_tile<D, NT>(k_dst, kb, a.k_st.s, lo + it * BK, a.sk, tid);
    load_tile<D, NT>(k_dst + TILE, vb, a.v_st.s, lo + it * BK, a.sk, tid);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load_kv(s, s);
    cp_async_commit();
  }

  // Delta = rowsum(dO o): four threads a row, each 64 columns, then the
  // four partial sums in a fixed order
  cp_async_wait<STAGES - 1>();
  __syncthreads();
  {
    const int r = tid >> 2, part = tid & 3, qi = i0 + r;
    float acc = 0.f;
    if (qi < a.sq) {
#pragma unroll
      for (int c = part * D / 4; c < (part + 1) * D / 4; c += 8) {
        float of[8], df[8];
        unpack_vec<T>(load_vec(o + qi * a.o_st.s + c), of);
        unpack_vec<T>(*reinterpret_cast<const uint4*>(base + TILE + swz_offset(r, c, BQ)), df);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc = fmaf(of[e], df[e], acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      row_s[r] = qi < a.sq ? a.lse[lrow + qi] : 0.f;
      row_s[BQ + r] = acc;
      if (qi < a.sq) a.delta[lrow + qi] = acc;
    }
  }
  __syncthreads();

  const int lane = tid & 31, warp = wtid >> 5, quad = lane & 3;
  int q_pos[2];
  float lse2[2], delta_r[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = warp * 16 + (lane >> 2) + 8 * hf;
    q_pos[hf] = i0 + r;
    lse2[hf] = row_s[r] * kLog2e;
    delta_r[hf] = row_s[BQ + r];
  }
  const float scale_log2 = a.scale * kLog2e;
  const bool rows_full = i0 + BQ <= a.sq;
  // warpgroup 0 multiplies Q by K, warpgroup 1 dO by V
  const uint32_t a_sm = wg ? do_sm : q_sm;
  float dq[D / 4], mine[BK / 2], theirs[BK / 2];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) mine[i] = 0.f;

  static_assert(STAGES == 2, "the next tile goes to the stage the previous one used");
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % STAGES;
    // one barrier: tile it has landed, and every warp is done with tile
    // it - 1 (its stage, which the next load takes, and the trade)
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (it + 1 < n_tiles) load_kv(it + 1, (it + 1) % STAGES);
    cp_async_commit();

    const int kt = lo + it * BK;
    const uint32_t k_sm = kv_sm + st * 2 * TILE, v_sm = k_sm + TILE;
    wgmma_fence();
    wgmma_rows_rows<D>(mine, a_sm, wg ? v_sm : k_sm);   // S = Q K^T, or dP = dO V^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<BK / 2>(mine);
    if (wg == 0) {
      // P recomputed from the forward's lse; only tiles on the diagonal,
      // the window's edge or the ragged ends test the mask
      const bool interior = rows_full && kt + BK <= a.sk && (!a.causal || kt + BK - 1 <= i0) &&
                            (a.window <= 0 || i0 + BQ - 1 - kt < a.window);
      if (interior) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) mine[i] = exp2_ftz(fmaf(mine[i], scale_log2, -lse2[acc_half(i)]));
      } else {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int hf = acc_half(i);
          mine[i] = visible(a, q_pos[hf], kt + acc_col(i, quad))
                        ? exp2_ftz(fmaf(mine[i], scale_log2, -lse2[hf])) : 0.f;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) mine[i] -= delta_r[acc_half(i)];   // dP - Delta
    }
    trade_put(xch, wg, wtid, mine);
    __syncthreads();
    trade_get(xch, wg, wtid, theirs);
    // dS = P (dP - Delta), the same product in both warpgroups
    float ds[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) ds[i] = mine[i] * theirs[i];
    uint32_t dsf[BK / 16][4];
    to_a_fragments(ds, dsf);
    fence_regs<D / 4>(dq);
    wgmma_fence();
    wgmma_regs_tile<128>(dq, dsf, k_sm + wg * 2 * kWgRows * 128);   // dQ[:, 128 wg ..] += dS K[:, 128 wg ..]
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<D / 4>(dq);
  }
  cp_async_wait<0>();

  T* dqp = static_cast<T*>(a.dq) + b * a.dq_st.b + h * a.dq_st.h + wg * (D / 2);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (q_pos[hf] >= a.sq) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      *reinterpret_cast<uint32_t*>(dqp + q_pos[hf] * a.dq_st.s + 8 * j + 2 * quad) =
          pack2(dq[4 * j + 2 * hf] * a.scale, dq[4 * j + 2 * hf + 1] * a.scale);
  }
}

// Pass 2 at head_dim 256: dK and dV. One CTA per (x, b, 64 keys), the key
// tiles first to last. SPLIT: x = KV head x n_sub + sub-group, the CTA runs
// the g / n_sub query heads of its sub-group in turn and writes their
// float32 share of dK and dV to the partials (B, KV x n_sub, Sk, D), which
// flash_bwd_dkv_sum_kernel adds up in sub-group order. Otherwise x is a KV
// head, the CTA runs its g heads and writes dK and dV itself. Warpgroup 0:
// S^T = K Q^T and P^T; warpgroup 1: dP^T = V dO^T; each: dV[:, 128 wg ..]
// += P^T dO[:, 128 wg ..] and dK[:, 128 wg ..] += dS^T Q[:, 128 wg ..].
template <bool SPLIT>
__global__ void __launch_bounds__(kPairThreads, 1) flash_bwd_dkv_wgmma_d256_kernel(BwdArgs a) {
  using T = __nv_bfloat16;
  constexpr int D = PairShape::D, BR = kWgRows, BQ = kWgRows, STAGES = kWgStages, NT = kPairThreads;
  constexpr uint32_t TILE = PairShape::TILE;
  extern __shared__ uint8_t wg_smem[];
  const uint32_t raw = smem_addr(wg_smem);
  const uint32_t k_sm = (raw + 1023u) & ~1023u;
  const uint32_t v_sm = k_sm + TILE;
  const uint32_t qd_sm = v_sm + TILE;                // stage s: Q at qd_sm + 2 s TILE, then dO
  const uint32_t col_sm = qd_sm + STAGES * 2 * TILE; // stage s: lse[64], Delta[64] at col_sm + 512 s
  const float* col_s = reinterpret_cast<const float*>(wg_smem + (col_sm - raw));
  float* xch = reinterpret_cast<float*>(wg_smem + (col_sm - raw) + PairShape::ROWS);

  const int x = blockIdx.x, b = blockIdx.y, t0 = blockIdx.z * BR, tid = threadIdx.x;
  const int wg = tid >> 7, wtid = tid & 127;
  const int n_heads = SPLIT ? a.g / a.n_sub : a.g;
  const int kvh = SPLIT ? x / a.n_sub : x;
  const int h0 = kvh * a.g + (SPLIT ? (x % a.n_sub) * n_heads : 0);
  load_tile<D, NT>(k_sm, static_cast<const T*>(a.k) + b * a.k_st.b + kvh * a.k_st.h, a.k_st.s, t0, a.sk, tid);
  load_tile<D, NT>(v_sm, static_cast<const T*>(a.v) + b * a.v_st.b + kvh * a.v_st.h, a.v_st.s, t0, a.sk, tid);
  cp_async_commit();

  // queries that may see any key of this tile: [qlo, qhi)
  const int t_last = min(a.sk, t0 + BR) - 1;
  const int qlo = a.causal ? t0 : 0;
  int qhi = a.sq;
  if (a.window > 0) qhi = min(qhi, t_last + a.window);
  const int n_qt = qhi > qlo ? (qhi - qlo + BQ - 1) / BQ : 0;
  const int n_tiles = n_heads * n_qt;
  auto load_q = [&](int it, int st) {
    const int h = h0 + it / n_qt, i0 = qlo + (it % n_qt) * BQ;
    const uint32_t q_dst = qd_sm + st * 2 * TILE;
    load_tile<D, NT>(q_dst, static_cast<const T*>(a.q) + b * a.q_st.b + h * a.q_st.h, a.q_st.s, i0, a.sq, tid);
    load_tile<D, NT>(q_dst + TILE, static_cast<const T*>(a.d_o) + b * a.do_st.b + h * a.do_st.h, a.do_st.s,
                     i0, a.sq, tid);
    // lse (threads 0-63) and Delta (64-127) of the tile's queries, 0 past Sq
    if (tid < 2 * BQ) {
      const int c = tid & (BQ - 1), qi = i0 + c;
      const float* src = (tid < BQ ? a.lse : a.delta) + ((long long)b * a.h + h) * a.sq;
      cp_async4(col_sm + st * 2 * BQ * 4 + tid * 4, qi < a.sq ? src + qi : src, qi < a.sq);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load_q(s, s);
    cp_async_commit();
  }

  const int lane = tid & 31, warp = wtid >> 5, quad = lane & 3;
  int t_pos[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) t_pos[hf] = t0 + warp * 16 + (lane >> 2) + 8 * hf;
  const float scale_log2 = a.scale * kLog2e;
  // warpgroup 0 multiplies K by Q, warpgroup 1 V by dO
  const uint32_t a_sm = wg ? v_sm : k_sm;
  float dk[D / 4], dv[D / 4], mine[BQ / 2], theirs[BQ / 2];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) mine[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % STAGES;
    if (it + STAGES - 1 < n_tiles) load_q(it + STAGES - 1, (it + STAGES - 1) % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    fence_proxy_async();
    __syncthreads();

    const int i0 = qlo + (it % n_qt) * BQ;
    const uint32_t q_sm = qd_sm + st * 2 * TILE, do_sm = q_sm + TILE;
    const float* lse_c = col_s + st * 2 * BQ;
    const float* delta_c = lse_c + BQ;
    wgmma_fence();
    wgmma_rows_rows<D>(mine, a_sm, wg ? do_sm : q_sm);   // S^T = K Q^T, or dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<BQ / 2>(mine);
    if (wg == 0) {
      // P^T; lse belongs to the columns
      const bool interior = t0 + BR <= a.sk && i0 + BQ <= a.sq && (!a.causal || t0 + BR - 1 <= i0) &&
                            (a.window <= 0 || i0 + BQ - 1 - t0 < a.window);
      if (interior) {
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i)
          mine[i] = exp2_ftz(fmaf(mine[i], scale_log2, -lse_c[acc_col(i, quad)] * kLog2e));
      } else {
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) {
          const int c = acc_col(i, quad);
          mine[i] = visible(a, i0 + c, t_pos[acc_half(i)])
                        ? exp2_ftz(fmaf(mine[i], scale_log2, -lse_c[c] * kLog2e)) : 0.f;
        }
      }
    }
    trade_put(xch, wg, wtid, mine);
    __syncthreads();
    trade_get(xch, wg, wtid, theirs);
    // dS^T = P^T (dP^T - Delta), the same operands in both warpgroups
    float p[BQ / 2], ds[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      p[i] = wg ? theirs[i] : mine[i];
      ds[i] = p[i] * ((wg ? mine[i] : theirs[i]) - delta_c[acc_col(i, quad)]);
    }
    uint32_t pt[BQ / 16][4], dst[BQ / 16][4];
    to_a_fragments(p, pt);
    to_a_fragments(ds, dst);
    fence_regs<D / 4>(dv);
    fence_regs<D / 4>(dk);
    wgmma_fence();
    wgmma_regs_tile<128>(dv, pt, do_sm + wg * 2 * kWgRows * 128);   // dV[:, 128 wg ..] += P^T dO
    wgmma_regs_tile<128>(dk, dst, q_sm + wg * 2 * kWgRows * 128);   // dK[:, 128 wg ..] += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<D / 4>(dv);
    fence_regs<D / 4>(dk);
    __syncthreads();   // every warp is done with this stage and with the trade
  }
  cp_async_wait<0>();   // a CTA with no query tile still drains its K/V copies

  const int c0 = wg * (D / 2) + 2 * quad;
  if constexpr (SPLIT) {
    const long long row = ((long long)b * gridDim.x + x) * a.sk;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (t_pos[hf] >= a.sk) continue;
      float* kp = a.dk_part + (row + t_pos[hf]) * D + c0;
      float* vp = a.dv_part + (row + t_pos[hf]) * D + c0;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        *reinterpret_cast<float2*>(kp + 8 * j) =
            make_float2(dk[4 * j + 2 * hf] * a.scale, dk[4 * j + 2 * hf + 1] * a.scale);
        *reinterpret_cast<float2*>(vp + 8 * j) = make_float2(dv[4 * j + 2 * hf], dv[4 * j + 2 * hf + 1]);
      }
    }
  } else {
    T* dkp = static_cast<T*>(a.dk) + b * a.dk_st.b + kvh * a.dk_st.h + c0;
    T* dvp = static_cast<T*>(a.dv) + b * a.dv_st.b + kvh * a.dv_st.h + c0;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (t_pos[hf] >= a.sk) continue;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        *reinterpret_cast<uint32_t*>(dkp + t_pos[hf] * a.dk_st.s + 8 * j) =
            pack2(dk[4 * j + 2 * hf] * a.scale, dk[4 * j + 2 * hf + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(dvp + t_pos[hf] * a.dv_st.s + 8 * j) =
            pack2(dv[4 * j + 2 * hf], dv[4 * j + 2 * hf + 1]);
      }
    }
  }
}

template <int D>
static void launch_dkv_sum(const BwdArgs& a, int B, int KV, cudaStream_t stream) {
  const long long n = (long long)B * KV * a.sk * (D / 8);
  const int blocks = (int)((n + 255) / 256 < (1 << 20) ? (n + 255) / 256 : (1 << 20));
  flash_bwd_dkv_sum_kernel<D><<<blocks, 256, 0, stream>>>(a, B, KV);
}

template <int D>
static int launch_bwd_wgmma(const BwdArgs& a, int B, int KV, bool split, cudaStream_t stream) {
  const size_t smem = WgShape<D>::SMEM;
  auto dkv = split ? flash_bwd_dkv_wgmma_kernel<D, true> : flash_bwd_dkv_wgmma_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // pass 1 writes Delta, which pass 2 reads: the same stream orders them
  if (a.sq > 0) {
    flash_bwd_dq_wgmma_kernel<D><<<dim3(a.h, B, (a.sq + kWgRows - 1) / kWgRows), 128, smem, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (a.sk > 0) {
    dkv<<<dim3(split ? a.h : KV, B, (a.sk + kWgRows - 1) / kWgRows), 128, smem, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess || !split) return (int)err;
    launch_dkv_sum<D>(a, B, KV, stream);
  }
  return (int)cudaGetLastError();
}

// the two-warpgroup body at head_dim 256; split: the group over a.n_sub
// sub-groups of CTAs and their partials summed
static int launch_bwd_wgmma_d256(const BwdArgs& a, int B, int KV, bool split, cudaStream_t stream) {
  const size_t smem = PairShape::SMEM;
  auto dkv = split ? flash_bwd_dkv_wgmma_d256_kernel<true> : flash_bwd_dkv_wgmma_d256_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_d256_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // pass 1 writes Delta, which pass 2 reads: the same stream orders them
  if (a.sq > 0) {
    flash_bwd_dq_wgmma_d256_kernel<<<dim3(a.h, B, (a.sq + kWgRows - 1) / kWgRows), kPairThreads, smem,
                                     stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (a.sk > 0) {
    dkv<<<dim3(KV * a.n_sub, B, (a.sk + kWgRows - 1) / kWgRows), kPairThreads, smem, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess || !split) return (int)err;
    launch_dkv_sum<PairShape::D>(a, B, KV, stream);
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
static int launch_bwd(const BwdArgs& a, int B, int KV, cudaStream_t stream) {
  constexpr int LD = D + 1;
  const size_t smem_dq = sizeof(float) *
      (2 * kDqRows * LD + 2 * kDqKeys * LD + kDqRows * (kDqKeys + 1) + 2 * kDqRows);
  const size_t smem_dkv = sizeof(float) *
      (2 * kKvRows * LD + 2 * kKvQs * LD + 2 * kKvRows * (kKvQs + 1) + 2 * kKvQs);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkv);
  if (err != cudaSuccess) return (int)err;
  // pass 1 writes Delta, which pass 2 reads: the same stream orders them
  if (a.sq > 0) {
    const dim3 grid(B * AccCols<D>::NCH, a.h, (a.sq + kDqRows - 1) / kDqRows);
    flash_bwd_dq_kernel<T, D><<<grid, kBwdNT, smem_dq, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (a.sk > 0) {
    const dim3 grid(B * AccCols<D>::NCH, KV, (a.sk + kKvRows - 1) / kKvRows);
    flash_bwd_dkv_kernel<T, D><<<grid, kBwdNT, smem_dkv, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// the CUDA-core body: float32 at head_dim 16 / 32 / 64 / 128 / 256, bf16 at
// 16 / 32 (bf16 at 64 / 128 / 256 runs on the tensor cores)
template <typename T>
static int dispatch_bwd(const BwdArgs& a, int B, int KV, int D, cudaStream_t s) {
  switch (D) {
    case 16: return launch_bwd<T, 16>(a, B, KV, s);
    case 32: return launch_bwd<T, 32>(a, B, KV, s);
  }
  if constexpr (sizeof(T) == 4) {
    switch (D) {
      case 64: return launch_bwd<T, 64>(a, B, KV, s);
      case 128: return launch_bwd<T, 128>(a, B, KV, s);
      case 256: return launch_bwd<T, 256>(a, B, KV, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro_torch

using namespace repro_torch;

// q, o, d_o, dq (B, H, Sq, D); k, v, dk, dv (B, KV, Sk, D), each through its
// (batch, head, token) element strides, head_dim contiguous; strides is a
// host array of 24: q, o, d_o, dq, k, v, dk, dv, three each. lse (B, H, Sq)
// float32 from the forward; delta (B, H, Sq) float32 scratch. Query i and
// key j sit at positions i and j. body, as the host planned it
// (flash_attention_bwd.py :: backward_plan): 0 the CUDA-core body, 1 the
// wgmma body with a KV head's group inside the CTA, 2 the wgmma body with
// the group split over CTAs into `subgroups` sub-groups (dk_part / dv_part:
// float32 (B, KV x subgroups, Sk, D) scratch, fully written; at head_dim
// 64 / 128 a sub-group is one query head, subgroups = H / KV). Launches the
// plan's kernels in order on ``stream``; returns cudaGetLastError() after
// the launches.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o, const void* d_o,
    const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int H, int KV,
    int Sq, int Sk, int D, int causal, int window, const long long* strides, float scale,
    int dtype, int body, int subgroups, void* dk_part, void* dv_part, void* stream) {
  if (KV <= 0 || H % KV != 0 || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int g = H / KV;
  auto st = [&](int i) { return Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]}; };
  BwdArgs a{q, k, v, o, d_o, static_cast<const float*>(lse), static_cast<float*>(delta),
            dq, dk, dv, H, g, Sq, Sk, causal, window,
            st(0), st(1), st(2), st(3), st(4), st(5), st(6), st(7), scale,
            static_cast<float*>(dk_part), static_cast<float*>(dv_part), subgroups};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 0) {
    if (subgroups != 1) return (int)cudaErrorInvalidValue;
    if (dtype == kF32) return dispatch_bwd<float>(a, B, KV, D, s);
    if (dtype == kBF16) return dispatch_bwd<__nv_bfloat16>(a, B, KV, D, s);
    return (int)cudaErrorInvalidValue;
  }
  // the tensor-core bodies: bf16 at head_dim 64 / 128 / 256
  if (dtype != kBF16 || (D != 64 && D != 128 && D != 256) || body > 2) return (int)cudaErrorInvalidValue;
  if (body == 1 && subgroups != 1) return (int)cudaErrorInvalidValue;
  if (body == 2) {
    if (dk_part == nullptr || dv_part == nullptr) return (int)cudaErrorInvalidValue;
    // 64 / 128: one query head a CTA; 256: any divisor of the group
    if (subgroups < 1 || g % subgroups != 0 || (D != 256 && subgroups != g)) return (int)cudaErrorInvalidValue;
  }
  if (D == 256) return launch_bwd_wgmma_d256(a, B, KV, body == 2, s);
  return D == 64 ? launch_bwd_wgmma<64>(a, B, KV, body == 2, s) : launch_bwd_wgmma<128>(a, B, KV, body == 2, s);
}
