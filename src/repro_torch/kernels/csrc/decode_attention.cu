// Decode attention over a dense KV cache for Hopper (sm_90a), CUDA C++.
//
// Replaces: the Pallas TPU kernel
//   src/repro/kernels/decode_attention.py :: decode_attention
//   (body _decode_kernel), whose oracle is
//   src/repro/kernels/ref.py :: decode_attention_ref.
// The serving path runs it on every decode round of the dense KV layout
// (full and ring caches), where the reference model calls
// models/attention.py :: attention over the whole cache row.
//
// What it computes: one query token per slot against that slot's cache row,
// q (B, H, D), k / v (B, KV, S, D) with any batch / head / token strides
// (the model passes its (B, S, KV, D) layer slice transposed, so the cache is
// never copied), GQA with the g = H / KV query heads of a KV head sharing
// every K/V load (up to 8 heads a CTA; a larger group, as MQA's g = 16, is
// split across CTAs that read the same keys). Keys at positions >= lengths[b]
// are masked and never read;
// float32 online softmax; a slot with no valid key writes 0, as the Pallas
// kernel does (running max stays -inf, output divided by max(l, 1e-30)).
//
// What bounds it on an H100: bytes. Each live K and V element is read once
// and feeds 2 x g flops, far below the ~295 flops/byte where the tensor cores
// would become the limit. With only B x KV CTAs (64 at the serving shapes)
// the risk is latency: too few bytes in flight per SM. So the design is:
//   * one CTA of 8 warps per (slot, KV head, part of the group of at most 8
//     query heads); the warps split the slot's keys
//     between them (warp w takes steps w, w + 8, ...), and inside a warp
//     each group of LPK lanes holds one key, each lane a DPL-wide slice of
//     head_dim. A warp step covers KPW = 32 / LPK keys;
//   * every K and V row is read straight into registers with 16-byte vector
//     loads, U warp steps of loads issued before any is used, and no
//     barrier inside the key loop: the loads of 8 warps x U steps fly
//     together;
//   * q (pre-scaled) and the accumulators for all g heads live in the
//     lanes' registers; a score is the dot product of a lane's slice,
//     reduced over its LPK lanes with shuffles;
//   * each key group keeps its own running max / sum / accumulator (its own
//     split of the keys), so the loop needs no cross-lane softmax; the
//     groups are merged with shuffles and the warps through (dynamic) shared
//     memory once, at the end: 8 warps x heads x D floats, 66 KB at 8 heads
//     of head_dim 256.
// The TPU kernel's pad of the whole cache to a multiple of its block
// (decode_attention.py:95-104) and its DMA of blocks past the length have
// no counterpart here: tiles past the length are not read.
#include "common.cuh"

namespace repro_torch {

constexpr int kDecWarps = 8;
constexpr int kDecThreads = 32 * kDecWarps;

struct DenseDecodeArgs {
  const void* q;        // (B, H, D)
  const void* k;        // (B, KV, S, D), head_dim contiguous
  const void* v;
  const int* lengths;   // (B,) int32
  void* out;            // (B, H, D)
  int s, g;             // cache length, query heads per KV head
  long long q_sb, q_sh;
  long long k_sb, k_skv, k_ss, v_sb, v_skv, v_ss;
  long long o_sb, o_sh;
  float scale;
};

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

  const int b = blockIdx.x, kvh = blockIdx.y;
  const int head0 = kvh * a.g + blockIdx.z * G;   // first query head of this CTA
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kg = lane / LPK;                 // key group of this lane
  const int d0 = (lane % LPK) * DPL;         // first head_dim index of its slice
  const int len = max(0, min(a.lengths[b], a.s));

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + (long long)head0 * a.q_sh;
  float qr[G][DPL];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int d = 0; d < DPL; ++d) qr[gi][d] = load_f(q + gi * a.q_sh + d0 + d) * a.scale;

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
  // converged; only keys past len are skipped, per key group
  for (int t0 = warp * KPW * U; t0 < len; t0 += kDecWarps * KPW * U) {
    uint4 kr[U][NVEC], vr[U][NVEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * KPW + kg;
#pragma unroll
      for (int e = 0; e < NVEC; ++e) {
        kr[u][e] = vr[u][e] = make_uint4(0u, 0u, 0u, 0u);
        if (t < len) {
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
      if (t < len) {
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

  // merge the warps and write the (G, D) output tile of this CTA's heads
  T* out = static_cast<T*>(a.out) + b * a.o_sb + (long long)head0 * a.o_sh;
  for (int i = threadIdx.x; i < G * D; i += kDecThreads) {
    const int gi = i / D, d = i % D;
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
    store_f(out + gi * a.o_sh + d, at / fmaxf(lt, 1e-30f));
  }
}

// G query heads a CTA, ``parts`` CTAs per (slot, KV head)
template <typename T, int D, int G>
static int launch(const DenseDecodeArgs& a, int B, int KV, int parts, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kDecWarps * G * (D + 2);
  cudaError_t err = cudaFuncSetAttribute(
      dense_decode_kernel<T, D, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dense_decode_kernel<T, D, G><<<dim3(B, KV, parts), kDecThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
static int dispatch_g(const DenseDecodeArgs& a, int B, int KV, int G, cudaStream_t s) {
  switch (G) {
    case 1: return launch<T, D, 1>(a, B, KV, 1, s);
    case 2: return launch<T, D, 2>(a, B, KV, 1, s);
    case 4: return launch<T, D, 4>(a, B, KV, 1, s);
    case 8: return launch<T, D, 8>(a, B, KV, 1, s);
    case 16: return launch<T, D, 8>(a, B, KV, 2, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int dispatch_d(const DenseDecodeArgs& a, int B, int KV, int G, int D, cudaStream_t s) {
  switch (D) {
    case 16: return dispatch_g<T, 16>(a, B, KV, G, s);
    case 64: return dispatch_g<T, 64>(a, B, KV, G, s);
    case 128: return dispatch_g<T, 128>(a, B, KV, G, s);
    case 256: return dispatch_g<T, 256>(a, B, KV, G, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro_torch

using namespace repro_torch;

// Returns cudaGetLastError() after the launch (0 = launched). The caller
// checks shapes, dtypes, strides and alignment; G = H / KV must be 1, 2, 4,
// 8 or 16 and D 16, 64, 128 or 256.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* lengths, void* out,
    int B, int H, int KV, int S, int D, long long q_sb, long long q_sh,
    long long k_sb, long long k_skv, long long k_ss, long long v_sb,
    long long v_skv, long long v_ss, long long o_sb, long long o_sh,
    float scale, int dtype, void* stream) {
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  DenseDecodeArgs a{q, k, v, static_cast<const int*>(lengths), out, S, H / KV,
                    q_sb, q_sh, k_sb, k_skv, k_ss, v_sb, v_skv, v_ss,
                    o_sb, o_sh, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_d<float>(a, B, KV, H / KV, D, s);
  if (dtype == kBF16) return dispatch_d<__nv_bfloat16>(a, B, KV, H / KV, D, s);
  return (int)cudaErrorInvalidValue;
}
