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
// each K/V tile. float32 online softmax; tokens at or past lengths[b] and
// tokens on -1 pages are masked and never loaded; a slot with no valid key
// (an idle decode lane) writes 0, as the Pallas kernel does (max(l, 1e-30)).
//
// What bounds it on an H100: bytes. Each slot's live K and V are read once
// (len x D x 2 bytes per head in bf16) and there are only 2 x g x D flops
// per loaded K/V element pair, far below the ~295 flops/byte where the
// tensor cores would become the limit. So the design is about reading the
// pages once and keeping everything else on chip:
//   * one CTA per (slot, KV head) loads its block-table row itself and walks
//     the slot's pages in key tiles of KT tokens (KT / page_size pages);
//   * each K/V tile is staged once in shared memory as float32 and serves
//     all g query heads of the group (no re-read per head);
//   * scores, the running max / sum and the P.V accumulator never leave the
//     SM (one warp per query head does the softmax step with shuffles).
//   * tiles are read with 16-byte vector loads into registers, and the next
//     tile's loads are issued before the current tile is computed on, so
//     the loop is not a chain of load latencies.
// The page loop is sequential inside a CTA and B x KV CTAs (64 on the main
// path) fill half the card, so splitting a slot's pages across CTAs
// (flash-decoding) is the next step for speed.
#include "common.cuh"

namespace repro_torch {

constexpr int kDecodeThreads = 128;
constexpr int kDecodeKT = 32;  // key tokens per tile

struct DecodeArgs {
  const void* q;        // (B, 1, H, D) bshk
  const void* k;        // (KV, P, bs, D) one layer's pool (any KV / page strides)
  const void* v;
  const int* tables;    // (B, MB) int32, contiguous
  const int* lengths;   // (B,) int32
  void* out;            // (B, 1, H, D)
  int g, page_size, mb;
  long long q_sb, q_sh, o_sb, o_sh;
  long long k_skv, k_sp, v_skv, v_sp;
  float scale;
};

// Per-thread slice of one K/V tile: NV 16-byte vectors per tensor, spread
// over the block; each thread keeps its share in registers so the next
// tile's loads are in flight while the current tile is computed on.
template <typename T, int D>
struct DecodeTile {
  static constexpr int VEC = Vec<T>::kElems;
  static constexpr int NV = kDecodeKT * D / VEC;
  static constexpr int PER = (NV + kDecodeThreads - 1) / kDecodeThreads;
  uint4 k[PER], v[PER];
};

// element offset of token t in the layer's pool (page walk through the
// block-table row held in shared memory), -1 when the token is masked
__device__ __forceinline__ long long token_offset(
    int t, int len, const int* table_s, int page_size, int mb, long long page_stride, int D) {
  if (t >= len) return -1;
  const int blk = t / page_size;
  const int page = blk < mb ? table_s[blk] : -1;
  return page >= 0 ? page * page_stride + (long long)(t % page_size) * D : -1;
}

template <typename T, int D>
__device__ __forceinline__ void load_decode_tile(
    DecodeTile<T, D>& r, const T* kb, const T* vb, int t0, int len,
    const int* table_s, const DecodeArgs& a) {
  using Tile = DecodeTile<T, D>;
#pragma unroll
  for (int u = 0; u < Tile::PER; ++u) {
    const int i = threadIdx.x + u * kDecodeThreads;
    r.k[u] = r.v[u] = make_uint4(0u, 0u, 0u, 0u);
    if (i < Tile::NV) {
      const int j = i * Tile::VEC / D, d = i * Tile::VEC % D;
      const long long ko = token_offset(t0 + j, len, table_s, a.page_size, a.mb, a.k_sp, D);
      const long long vo = token_offset(t0 + j, len, table_s, a.page_size, a.mb, a.v_sp, D);
      if (ko >= 0) r.k[u] = load_vec(kb + ko + d);
      if (vo >= 0) r.v[u] = load_vec(vb + vo + d);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kDecodeThreads)
paged_decode_kernel(DecodeArgs a) {
  constexpr int KT = kDecodeKT;
  using Tile = DecodeTile<T, D>;
  extern __shared__ float smem[];
  const int G = a.g;
  float* q_s = smem;                    // [G][D]   query, pre-scaled
  float* k_s = q_s + G * D;             // [KT][D+1]
  float* v_s = k_s + KT * (D + 1);      // [KT][D]
  float* p_s = v_s + KT * D;            // [G][KT]  scores, then probabilities
  float* acc_s = p_s + G * KT;          // [G][D]
  float* corr_s = acc_s + G * D;        // [G]
  int* table_s = reinterpret_cast<int*>(corr_s + G);   // [MB] block-table row
  __shared__ bool valid_s[KT];

  const int b = blockIdx.x, kvh = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const T* q = static_cast<const T*>(a.q);
  const T* kb = static_cast<const T*>(a.k) + kvh * a.k_skv;
  const T* vb = static_cast<const T*>(a.v) + kvh * a.v_skv;
  const int len = a.lengths[b];
  const int* trow = a.tables + (long long)b * a.mb;
  const int n_tiles = (len + KT - 1) / KT;
  // only the pages below len are ever read
  const int n_blk = min(a.mb, (len + a.page_size - 1) / a.page_size);

  for (int i = tid; i < n_blk; i += kDecodeThreads) table_s[i] = trow[i];
  for (int i = tid; i < G * D; i += kDecodeThreads) {
    const int gi = i / D, d = i % D;
    q_s[i] = load_f(q + b * a.q_sb + (long long)(kvh * G + gi) * a.q_sh + d) * a.scale;
    acc_s[i] = 0.f;
  }
  // running max / sum of head gi live in the registers of warp gi % 4
  float m_run[4], l_run[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) { m_run[r] = -CUDART_INF_F; l_run[r] = 0.f; }
  __syncthreads();

  Tile regs;
  if (n_tiles > 0) load_decode_tile<T, D>(regs, kb, vb, 0, len, table_s, a);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * KT;
    __syncthreads();  // the previous tile is done with k_s / v_s / p_s
#pragma unroll
    for (int u = 0; u < Tile::PER; ++u) {
      const int i = tid + u * kDecodeThreads;
      if (i < Tile::NV) {
        const int j = i * Tile::VEC / D, d = i * Tile::VEC % D;
        unpack_vec<T>(regs.k[u], k_s + j * (D + 1) + d);
        unpack_vec<T>(regs.v[u], v_s + j * D + d);
      }
    }
    for (int j = tid; j < KT; j += kDecodeThreads)
      valid_s[j] = token_offset(t0 + j, len, table_s, a.page_size, a.mb, a.k_sp, D) >= 0;
    __syncthreads();
    // the next tile's loads fly while this one is computed on
    if (tile + 1 < n_tiles) load_decode_tile<T, D>(regs, kb, vb, t0 + KT, len, table_s, a);

    for (int i = tid; i < G * KT; i += kDecodeThreads) {
      const int gi = i / KT, j = i % KT;
      float s = 0.f;
      const float* qr = q_s + gi * D;
      const float* kr = k_s + j * (D + 1);
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      p_s[i] = s;
    }
    __syncthreads();
    // online softmax: warp w owns heads w, w + 4, ...; lane j owns key j
    for (int gi = warp, r = 0; gi < G; gi += kDecodeThreads / 32, ++r) {
      const bool valid = valid_s[lane];
      const float s = valid ? p_s[gi * KT + lane] : -CUDART_INF_F;
      const float m_new = fmaxf(m_run[r], warp_max(s));
      const float corr = m_new == -CUDART_INF_F ? 1.f : expf(m_run[r] - m_new);
      const float p = valid ? expf(s - m_new) : 0.f;
      l_run[r] = l_run[r] * corr + warp_sum(p);
      m_run[r] = m_new;
      p_s[gi * KT + lane] = p;
      if (lane == 0) corr_s[gi] = corr;
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += kDecodeThreads) {
      const int gi = i / D, d = i % D;
      float acc = acc_s[i] * corr_s[gi];
      const float* pr = p_s + gi * KT;
#pragma unroll 8
      for (int j = 0; j < KT; ++j) acc = fmaf(pr[j], v_s[j * D + d], acc);
      acc_s[i] = acc;
    }
  }
  __syncthreads();
  for (int gi = warp, r = 0; gi < G; gi += kDecodeThreads / 32, ++r) {
    if (lane == 0) corr_s[gi] = 1.f / fmaxf(l_run[r], 1e-30f);
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out);
  for (int i = tid; i < G * D; i += kDecodeThreads) {
    const int gi = i / D, d = i % D;
    store_f(out + b * a.o_sb + (long long)(kvh * G + gi) * a.o_sh + d,
            acc_s[i] * corr_s[gi]);
  }
}

template <typename T, int D>
static int launch(const DecodeArgs& a, int B, int KV, cudaStream_t stream) {
  const int G = a.g;
  const size_t smem =
      sizeof(float) * (G * D + kDecodeKT * (D + 1) + kDecodeKT * D + G * kDecodeKT + G * D + G) +
      sizeof(int) * a.mb;
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  paged_decode_kernel<T, D><<<dim3(B, KV), kDecodeThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_d(const DecodeArgs& a, int B, int KV, int D, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(a, B, KV, s);
    case 32: return launch<T, 32>(a, B, KV, s);
    case 64: return launch<T, 64>(a, B, KV, s);
    case 128: return launch<T, 128>(a, B, KV, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro_torch

using namespace repro_torch;

// Returns cudaGetLastError() after the launch (0 = launched). The caller
// checks shapes, dtypes and contiguity; g = H / KV must be at most 16
// (the per-warp softmax state holds 4 heads per warp).
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k, const void* v, const void* tables,
    const void* lengths, void* out, int B, int H, int KV, int D,
    int page_size, int mb, long long q_sb, long long q_sh, long long o_sb,
    long long o_sh, long long k_skv, long long k_sp, long long v_skv,
    long long v_sp, float scale, int dtype, void* stream) {
  if (KV <= 0 || H % KV != 0 || H / KV > 16) return (int)cudaErrorInvalidValue;
  DecodeArgs a{q, k, v, static_cast<const int*>(tables),
               static_cast<const int*>(lengths), out, H / KV, page_size, mb,
               q_sb, q_sh, o_sb, o_sh, k_skv, k_sp, v_skv, v_sp, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (dtype == kF32) return dispatch_d<float>(a, B, KV, D, s);
  if (dtype == kBF16) return dispatch_d<__nv_bfloat16>(a, B, KV, D, s);
  return (int)cudaErrorInvalidValue;
}
