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
// all in float32, the outputs cast to the inputs' type.
//
// Design: two passes, no atomics, so two runs give the same bits.
//   * Pass 1, dQ (flash_bwd_dq_kernel): one CTA owns 64 query rows of one
//     head. It first computes Delta for its rows (written to a float32
//     scratch for pass 2), then loops over the 32-key tiles the rows can
//     see, recomputing P from the saved lse, and keeps dQ in registers.
//   * Pass 2, dK / dV (flash_bwd_dkv_kernel): one CTA owns 64 keys of one KV
//     head. It loops over the g query heads of the group and, for each, over
//     the 32-query tiles that can see its keys, keeping dK and dV in
//     registers: the group's sum needs no atomics.
//   * Fully masked tiles are skipped as the forward skips them: key tiles
//     above the diagonal and left of the window in pass 1, query tiles
//     before the diagonal and past the window in pass 2.
// Inputs are read through their strides (the model's bshk tensors seen as
// (B, H, S, D)).
//
// What bounds it on an H100: the work is 5 matrix products of the visible
// (query, key) pairs x D per head, far above the bytes it moves, so it is
// bounded by operations. Two device bodies, chosen by the host
// (flash_attention_bwd.py :: variant):
//   * bf16 at head_dim 64 / 128 (the training path at full width): the
//     tensor-core body, every product on mma.sync.m16n8k16 with float32
//     accumulators, tiles bf16 in swizzled shared memory, P and dS rounded
//     to bf16 as the next product's A operand (as the forward rounds P);
//   * float32 at head_dim 16 / 32 / 64 / 128, and bf16 at 16 / 32: the
//     CUDA-core body, float32 FMAs on tiles widened to float32 in shared
//     memory (rows padded by one against bank conflicts), each thread a
//     4 x 4 block of a tile's scores (and of dP) and 4 rows x D/8 columns
//     of its accumulators. Float32 must not run as TF32, which misses the
//     float32 tolerance.
#include "common.cuh"

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
};

// rows [row0, row0 + ROWS) of a strided (S, D) slice into shared memory as
// float32 with leading dimension LD; rows at or past n are zero. 16-byte
// vector loads, all issued before the first store.
template <typename T, int D, int ROWS, int LD>
__device__ __forceinline__ void load_rows(float* dst, const T* src, long long stride, int row0,
                                          int n, int tid) {
  constexpr int VEC = Vec<T>::kElems, NV = ROWS * D / VEC, PER = (NV + kBwdNT - 1) / kBwdNT;
  uint4 regs[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = tid + u * kBwdNT, r = i * VEC / D, d = i * VEC % D;
    regs[u] = make_uint4(0u, 0u, 0u, 0u);
    if (i < NV && row0 + r < n) regs[u] = load_vec(src + (row0 + r) * stride + d);
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = tid + u * kBwdNT, r = i * VEC / D, d = i * VEC % D;
    if (i < NV) unpack_vec<T>(regs[u], dst + r * LD + d);
  }
}

// the forward's mask: key t is seen by query i
__device__ __forceinline__ bool visible(const BwdArgs& a, int i, int t) {
  return i < a.sq && t < a.sk && (!a.causal || t <= i) && (a.window <= 0 || i - t < a.window);
}

// --------------------------------------------------------------------------
// Pass 1: Delta and dQ. One CTA per (b, head, 64 query rows); thread
// (rg, cg) = (tid / 8, tid % 8) owns query rows 4 rg .. 4 rg + 3, the
// tile's keys 4 cg .. 4 cg + 3 and dQ columns cg + 8 c.
// --------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kBwdNT) flash_bwd_dq_kernel(BwdArgs a) {
  constexpr int BQ = kDqRows, BK = kDqKeys, LD = D + 1, DC = D / 8;
  static_assert(kBwdNT == 2 * BQ && BK == 32, "16 row groups of 4 rows, 8 key groups of 4 keys");
  extern __shared__ float smem[];
  float* q_s = smem;                    // [BQ][LD]
  float* do_s = q_s + BQ * LD;          // [BQ][LD]
  float* k_s = do_s + BQ * LD;          // [BK][LD]
  float* v_s = k_s + BK * LD;           // [BK][LD]
  float* ds_s = v_s + BK * LD;          // [BQ][BK + 1]
  float* lse_s = ds_s + BQ * (BK + 1);  // [BQ]
  float* delta_s = lse_s + BQ;          // [BQ]

  const int b = blockIdx.x, h = blockIdx.y, i0 = blockIdx.z * BQ;
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
      if (qi < a.sq) a.delta[lrow + qi] = acc;
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

    // dQ[row r, cg + 8 c] += dS[row r, :] . k[:, cg + 8 c]
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float dsr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) dsr[r] = ds_s[(rg * 4 + r) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kv = k_s[j * LD + cg + 8 * c];
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
    for (int c = 0; c < DC; ++c) store_f(dq + q_pos[r] * a.dq_st.s + cg + 8 * c, acc[r][c] * a.scale);
  }
}

// --------------------------------------------------------------------------
// Pass 2: dK and dV. One CTA per (b, KV head, 64 key rows); thread
// (rg, cg) = (tid / 8, tid % 8) owns key rows 4 rg .. 4 rg + 3, the tile's
// queries 4 cg .. 4 cg + 3 and dK / dV columns cg + 8 c. The g query heads
// of the KV head run one after the other inside the CTA.
// --------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kBwdNT) flash_bwd_dkv_kernel(BwdArgs a) {
  constexpr int BR = kKvRows, BQ = kKvQs, LD = D + 1, DC = D / 8, PL = BQ + 1;
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

  const int b = blockIdx.x, kvh = blockIdx.y, t0 = blockIdx.z * BR;
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
          const float qv = q_s[j * LD + cg + 8 * c];
          const float ov = do_s[j * LD + cg + 8 * c];
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
      store_f(dkp + k_pos[r] * a.dk_st.s + cg + 8 * c, dk[r][c] * a.scale);
      store_f(dvp + k_pos[r] * a.dv_st.s + cg + 8 * c, dv[r][c]);
    }
  }
}

// --------------------------------------------------------------------------
// Tensor-core body (bf16, head_dim 64 / 128): the same two passes on
// mma.sync.m16n8k16 (bf16 in, float32 accumulators). Tiles stay bf16 in
// shared memory, 16-byte chunks XOR-swizzled by row so ldmatrix reads them
// without bank conflicts; each warp owns 16 rows of the CTA (queries in
// pass 1, keys in pass 2). The scores and dP stay in registers; P and dS
// are rounded to bf16 in registers as the A operand of the next product
// (the accumulator layout of two n8 tiles is the A fragment of one k16
// step), as the forward's tensor-core body rounds P.
// --------------------------------------------------------------------------
constexpr int kTcRows = 64;   // rows a CTA (4 warps x 16), both passes
constexpr int kTcCols = 32;   // the inner loop's tile: keys (pass 1), queries (pass 2)

// byte offset of 16-byte chunk `ch` of row `r` in a swizzled tile of rows of
// D bf16: the chunk index is XORed with r % 8 (D >= 64: at least 8 chunks)
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int ch) {
  return (uint32_t)(r * D * 2 + ((ch ^ (r & 7)) << 4));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// d (16 x 8, float32) += a (16 x 16, bf16, row-major) * b (16 x 8, bf16, col-major)
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// rows [row0, row0 + ROWS) of a strided (S, D) bf16 slice into a swizzled
// shared tile with cp.async; rows at or past n are zero. Not waited on.
template <int D, int ROWS>
__device__ __forceinline__ void copy_rows(uint32_t dst, const __nv_bfloat16* src, long long stride,
                                          int row0, int n, int tid) {
  constexpr int CPR = D / 8;
  for (int i = tid; i < ROWS * CPR; i += kBwdNT) {
    const int r = i / CPR, ch = i % CPR;
    const bool ok = row0 + r < n;
    cp_async16(dst + swz<D>(r, ch), ok ? src + (row0 + r) * stride + ch * 8 : src, ok);
  }
}

// acc (16 x N, this warp's rows) += A (16 x K) * B, where A is this warp's
// 16 rows of a swizzled [row][K] tile at a_sm and B is read from a swizzled
// [n][K] tile at b_sm (B = tile^T: the product of rows with rows)
template <int K, int N>
__device__ __forceinline__ void mma_rows_rows(float (*acc)[4], uint32_t a_sm, int a_row0,
                                              uint32_t b_sm, int lane) {
  const int i = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a_sm + swz<K>(a_row0 + (lane & 7) + 8 * (i & 1), kk * 2 + (i >> 1)), a);
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t b[4];
      ldsm_x4(b_sm + swz<K>(np * 16 + (lane & 7) + 8 * (i >> 1), kk * 2 + (i & 1)), b);
      mma16816(acc[2 * np], a, b[0], b[1]);
      mma16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x D) += P (16 x KN, in registers: the accumulators of KN / 8 n8
// tiles, rounded to bf16) * tile (KN x D, a swizzled [k][D] tile at b_sm)
template <int KN, int D>
__device__ __forceinline__ void mma_regs_tile(float (*acc)[4], const float (*p)[4], uint32_t b_sm,
                                              int lane) {
  const int i = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < KN / 16; ++kk) {
    const uint32_t a[4] = {pack2(p[2 * kk][0], p[2 * kk][1]), pack2(p[2 * kk][2], p[2 * kk][3]),
                           pack2(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack2(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b_sm + swz<D>(kk * 16 + (lane & 7) + 8 * (i & 1), np * 2 + (i >> 1)), b);
      mma16816(acc[2 * np], a, b[0], b[1]);
      mma16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// Pass 1 on the tensor cores: one CTA per (b, head, 64 query rows), warp w
// owning rows 16 w .. 16 w + 15; key tiles of 32.
template <int D>
__global__ void __launch_bounds__(kBwdNT) flash_bwd_dq_tc_kernel(BwdArgs a) {
  using T = __nv_bfloat16;
  constexpr int BQ = kTcRows, BK = kTcCols, NJ = BK / 8, ND = D / 8;
  extern __shared__ __align__(128) uint8_t tc_smem[];
  const uint32_t q_sm = smem_addr(tc_smem);
  const uint32_t do_sm = q_sm + BQ * D * 2;
  const uint32_t k_sm = do_sm + BQ * D * 2;
  const uint32_t v_sm = k_sm + BK * D * 2;
  float* lse_s = reinterpret_cast<float*>(tc_smem + 2 * BQ * D * 2 + 2 * BK * D * 2);
  float* delta_s = lse_s + BQ;

  const int b = blockIdx.x, h = blockIdx.y, i0 = blockIdx.z * BQ;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int kvh = h / a.g;
  const T* q = static_cast<const T*>(a.q) + b * a.q_st.b + h * a.q_st.h;
  const T* o = static_cast<const T*>(a.o) + b * a.o_st.b + h * a.o_st.h;
  const T* d_o = static_cast<const T*>(a.d_o) + b * a.do_st.b + h * a.do_st.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_st.b + kvh * a.k_st.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_st.b + kvh * a.v_st.h;
  const long long lrow = ((long long)b * a.h + h) * a.sq;

  copy_rows<D, BQ>(q_sm, q, a.q_st.s, i0, a.sq, tid);
  copy_rows<D, BQ>(do_sm, d_o, a.do_st.s, i0, a.sq, tid);
  cp_async_commit();
  {
    // Delta = rowsum(dO o) from device memory: two threads a row
    const int r = tid >> 1, half = tid & 1, qi = i0 + r;
    float acc = 0.f;
    if (qi < a.sq) {
      const T* orow = o + qi * a.o_st.s + half * (D / 2);
      const T* drow = d_o + qi * a.do_st.s + half * (D / 2);
#pragma unroll 8
      for (int d = 0; d < D / 2; ++d) acc = fmaf(load_f(orow + d), load_f(drow + d), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      delta_s[r] = acc;
      lse_s[r] = qi < a.sq ? a.lse[lrow + qi] : 0.f;
      if (qi < a.sq) a.delta[lrow + qi] = acc;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  const int g8 = lane >> 2, tig = lane & 3;
  int q_pos[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = w * 16 + g8 + 8 * hf;
    q_pos[hf] = i0 + r;
    lse_r[hf] = lse_s[r];
    delta_r[hf] = delta_s[r];
  }
  float dq[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  const int qi_last = min(a.sq, i0 + BQ) - 1;
  int hi = a.sk;
  if (a.causal) hi = min(hi, qi_last + 1);
  int lo = 0;
  if (a.window > 0) lo = max(0, i0 - a.window + 1);
  lo = (lo / BK) * BK;

  for (int kt = lo; kt < hi; kt += BK) {
    __syncthreads();  // the previous tile is done with k_sm / v_sm
    copy_rows<D, BK>(k_sm, kb, a.k_st.s, kt, a.sk, tid);
    copy_rows<D, BK>(v_sm, vb, a.v_st.s, kt, a.sk, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_rows_rows<D, BK>(s, q_sm, w * 16, k_sm, lane);      // S = q k^T
    mma_rows_rows<D, BK>(dp, do_sm, w * 16, v_sm, lane);    // dP = dO v^T
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1, t = kt + j * 8 + 2 * tig + (e & 1);
        const float p = visible(a, q_pos[hf], t) ? expf(s[j][e] * a.scale - lse_r[hf]) : 0.f;
        s[j][e] = p * (dp[j][e] - delta_r[hf]);            // dS
      }
    mma_regs_tile<BK, D>(dq, s, k_sm, lane);                // dQ += dS k
  }

  T* dqp = static_cast<T*>(a.dq) + b * a.dq_st.b + h * a.dq_st.h;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (q_pos[hf] >= a.sq) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(dqp + q_pos[hf] * a.dq_st.s + j * 8 + 2 * tig) =
          pack2(dq[j][2 * hf] * a.scale, dq[j][2 * hf + 1] * a.scale);
  }
}

// Pass 2 on the tensor cores: one CTA per (b, KV head, 64 key rows), warp w
// owning keys 16 w .. 16 w + 15; the group's heads in turn, query tiles of 32.
template <int D>
__global__ void __launch_bounds__(kBwdNT) flash_bwd_dkv_tc_kernel(BwdArgs a) {
  using T = __nv_bfloat16;
  constexpr int BR = kTcRows, BQ = kTcCols, NJ = BQ / 8, ND = D / 8;
  extern __shared__ __align__(128) uint8_t tc_smem[];
  const uint32_t k_sm = smem_addr(tc_smem);
  const uint32_t v_sm = k_sm + BR * D * 2;
  const uint32_t q_sm = v_sm + BR * D * 2;
  const uint32_t do_sm = q_sm + BQ * D * 2;
  float* lse_s = reinterpret_cast<float*>(tc_smem + 2 * BR * D * 2 + 2 * BQ * D * 2);
  float* delta_s = lse_s + BQ;

  const int b = blockIdx.x, kvh = blockIdx.y, t0 = blockIdx.z * BR;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g8 = lane >> 2, tig = lane & 3;
  copy_rows<D, BR>(k_sm, static_cast<const T*>(a.k) + b * a.k_st.b + kvh * a.k_st.h, a.k_st.s, t0,
                   a.sk, tid);
  copy_rows<D, BR>(v_sm, static_cast<const T*>(a.v) + b * a.v_st.b + kvh * a.v_st.h, a.v_st.s, t0,
                   a.sk, tid);
  cp_async_commit();

  int k_pos[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) k_pos[hf] = t0 + w * 16 + g8 + 8 * hf;
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

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
      __syncthreads();  // the previous tile is done with q_sm / do_sm / lse_s
      copy_rows<D, BQ>(q_sm, q, a.q_st.s, it, a.sq, tid);
      copy_rows<D, BQ>(do_sm, d_o, a.do_st.s, it, a.sq, tid);
      cp_async_commit();
      if (tid < BQ) {
        const bool ok = it + tid < a.sq;
        lse_s[tid] = ok ? a.lse[lrow + it + tid] : 0.f;
        delta_s[tid] = ok ? a.delta[lrow + it + tid] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();

      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      mma_rows_rows<D, BQ>(s, k_sm, w * 16, q_sm, lane);    // S^T = k q^T
      mma_rows_rows<D, BQ>(dp, v_sm, w * 16, do_sm, lane);  // dP^T = v dO^T
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * tig + (e & 1);
          const float p = visible(a, it + c, k_pos[e >> 1]) ? expf(s[j][e] * a.scale - lse_s[c]) : 0.f;
          s[j][e] = p;                                      // P^T
          dp[j][e] = p * (dp[j][e] - delta_s[c]);           // dS^T
        }
      mma_regs_tile<BQ, D>(dv, s, do_sm, lane);             // dV += P^T dO
      mma_regs_tile<BQ, D>(dk, dp, q_sm, lane);             // dK += dS^T q
    }
  }
  cp_async_wait<0>();   // a CTA with no query tile still drains its K/V copies

  T* dkp = static_cast<T*>(a.dk) + b * a.dk_st.b + kvh * a.dk_st.h;
  T* dvp = static_cast<T*>(a.dv) + b * a.dv_st.b + kvh * a.dv_st.h;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (k_pos[hf] >= a.sk) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      *reinterpret_cast<uint32_t*>(dkp + k_pos[hf] * a.dk_st.s + j * 8 + 2 * tig) =
          pack2(dk[j][2 * hf] * a.scale, dk[j][2 * hf + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(dvp + k_pos[hf] * a.dv_st.s + j * 8 + 2 * tig) =
          pack2(dv[j][2 * hf], dv[j][2 * hf + 1]);
    }
  }
}

template <int D>
static int launch_bwd_tc(const BwdArgs& a, int B, int KV, cudaStream_t stream) {
  const size_t smem_dq = 2 * kTcRows * D * 2 + 2 * kTcCols * D * 2 + 2 * kTcRows * sizeof(float);
  const size_t smem_dkv = 2 * kTcRows * D * 2 + 2 * kTcCols * D * 2 + 2 * kTcCols * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_tc_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkv);
  if (err != cudaSuccess) return (int)err;
  if (a.sq > 0) {
    const dim3 grid(B, a.h, (a.sq + kTcRows - 1) / kTcRows);
    flash_bwd_dq_tc_kernel<D><<<grid, kBwdNT, smem_dq, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (a.sk > 0) {
    const dim3 grid(B, KV, (a.sk + kTcRows - 1) / kTcRows);
    flash_bwd_dkv_tc_kernel<D><<<grid, kBwdNT, smem_dkv, stream>>>(a);
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
    const dim3 grid(B, a.h, (a.sq + kDqRows - 1) / kDqRows);
    flash_bwd_dq_kernel<T, D><<<grid, kBwdNT, smem_dq, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (a.sk > 0) {
    const dim3 grid(B, KV, (a.sk + kKvRows - 1) / kKvRows);
    flash_bwd_dkv_kernel<T, D><<<grid, kBwdNT, smem_dkv, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// the CUDA-core body: float32 at head_dim 16 / 32 / 64 / 128, bf16 at 16 / 32
// (bf16 at 64 / 128 runs on the tensor cores)
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
// key j sit at positions i and j. Launches pass 1 then pass 2 on ``stream``;
// returns cudaGetLastError() after the launches.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o, const void* d_o,
    const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int H, int KV,
    int Sq, int Sk, int D, int causal, int window, const long long* strides, float scale,
    int dtype, int tensor_cores, void* stream) {
  if (KV <= 0 || H % KV != 0 || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  auto st = [&](int i) { return Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]}; };
  BwdArgs a{q, k, v, o, d_o, static_cast<const float*>(lse), static_cast<float*>(delta),
            dq, dk, dv, H, H / KV, Sq, Sk, causal, window,
            st(0), st(1), st(2), st(3), st(4), st(5), st(6), st(7), scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_cores) {
    // the host's plan (flash_attention_bwd.py :: variant): bf16 at 64 / 128
    if (dtype != kBF16) return (int)cudaErrorInvalidValue;
    if (D == 64) return launch_bwd_tc<64>(a, B, KV, s);
    if (D == 128) return launch_bwd_tc<128>(a, B, KV, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == kF32) return dispatch_bwd<float>(a, B, KV, D, s);
  if (dtype == kBF16) return dispatch_bwd<__nv_bfloat16>(a, B, KV, D, s);
  return (int)cudaErrorInvalidValue;
}
