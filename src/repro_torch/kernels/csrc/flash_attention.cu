// Flash attention for Hopper (sm_90a), CUDA C++: one device body with a
// dense entry and a paged chunked-prefill entry.
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
// What it computes: per (row, query head, query tile of BQ) an online
// float32 softmax over key tiles of BK = 32 tokens; GQA maps head h to KV
// head h / g. Masks by position: causal k_pos <= q_pos, k_pos < valid_len
// (dense: Sk), k on an allocated page (paged), q_pos - k_pos < window
// (window > 0). Key tiles that are fully masked for the whole query tile
// (above the diagonal, left of the window, past valid_len) are skipped, as
// flash_attention.py:60-66 skips its blocks. A row without any valid key
// (a pad row, chunk_lens == 0) writes 0.
//
// What bounds it on an H100: at the serving shapes (chunks of 32 queries
// over up to a few hundred keys) the work is 4 x Sq x Sk x D flops per head
// against (Sq + 2 Sk) x D x 2 bytes, i.e. tens of flops per byte: on the
// tensor cores this would be bytes-bound, but this first kernel computes on
// the CUDA cores in float32 (no wgmma yet), so its own limit is float32
// FMA throughput and shared-memory bandwidth. The design keeps both down:
//   * q (pre-scaled), each K/V tile and the probabilities are staged once in
//     shared memory as float32; K/V tiles are read from the pool once per
//     (row, head, query tile) with 16-byte vector loads, all of a tile's
//     loads in flight at once, through the block-table row held in shared
//     memory;
//   * each thread owns a 4 x 4 block of the score tile and a 4 x D/8 block
//     of the accumulator in registers, so every shared-memory load feeds
//     two (scores) or four (P.V) FMAs; rows of padding with stride D + 1
//     keep the loads free of bank conflicts;
//   * the eight lanes of a row group reduce the running max and sum with
//     shuffles, so the softmax never touches shared memory.
// Moving the two products onto wgmma with TMA-fed tiles is the next step.
#include "common.cuh"

namespace repro_torch {

constexpr int kBK = 32;  // key tokens per tile

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

template <typename T, bool PAGED>
static int dispatch(const FlashArgs& a, int rows, int H, int D, cudaStream_t s) {
  const bool small = a.sq <= 32;
#define REPRO_FLASH_D(DD)                                               \
  case DD:                                                              \
    return small ? launch<T, DD, 32, PAGED>(a, rows, H, s)              \
                 : launch<T, DD, 64, PAGED>(a, rows, H, s);
  switch (D) {
    REPRO_FLASH_D(16)
    REPRO_FLASH_D(32)
    REPRO_FLASH_D(64)
    REPRO_FLASH_D(128)
  }
#undef REPRO_FLASH_D
  return (int)cudaErrorInvalidValue;
}

template <bool PAGED>
static int dispatch_dtype(const FlashArgs& a, int rows, int H, int D, int dtype,
                          cudaStream_t s) {
  if (rows == 0 || a.sq == 0) return 0;
  if (dtype == kF32) return dispatch<float, PAGED>(a, rows, H, D, s);
  if (dtype == kBF16) return dispatch<__nv_bfloat16, PAGED>(a, rows, H, D, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro_torch

using namespace repro_torch;

// Dense entry: q (B, H, Sq, D), k / v (B, KV, Sk, D), out like q. Query i and
// key j sit at positions i and j. Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_dense_launch(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int KV, int Sq, int Sk, int D, int causal, int window, long long q_sb,
    long long q_sh, long long q_ss, long long o_sb, long long o_sh,
    long long o_ss, long long k_sb, long long k_skv, long long k_ss,
    long long v_sb, long long v_skv, long long v_ss, float scale, int dtype,
    void* stream) {
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  FlashArgs a{q, k, v, out, nullptr, nullptr, nullptr, Sq, H / KV, Sk, 1, 0,
              causal, window, q_sb, q_ss, q_sh, o_sb, o_ss, o_sh,
              k_sb, k_skv, k_ss, v_sb, v_skv, v_ss, scale};
  return dispatch_dtype<false>(a, B, H, D, dtype, static_cast<cudaStream_t>(stream));
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
    float scale, int dtype, void* stream) {
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  FlashArgs a{q, k, v, out, static_cast<const int*>(tables),
              static_cast<const int*>(q_start), static_cast<const int*>(kv_len),
              C, H / KV, 0, page_size, mb, 1, 0,
              q_sb, q_ss, q_sh, o_sb, o_ss, o_sh,
              0, k_skv, k_sp, 0, v_skv, v_sp, scale};
  return dispatch_dtype<true>(a, R, H, D, dtype, static_cast<cudaStream_t>(stream));
}
