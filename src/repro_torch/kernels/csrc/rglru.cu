// RG-LRU linear recurrence for Hopper (sm_90a), CUDA C++.
//
// Replaces: the Pallas TPU kernel
//   src/repro/kernels/rglru.py :: rglru_scan (body _rglru_kernel), whose
//   oracle is src/repro/kernels/ref.py :: rglru_scan_ref.
// The serving path runs it in every recurrent layer of RecurrentGemma, on
// the whole prompt in a prefill (B, S, R) and on one token in a decode step
// (B, 1, R); the training path runs it at (B, S, R) twice a layer (forward
// and remat). The reference model runs a lax.scan there
// (models/recurrentgemma.py:179).
//
// What it computes: h_t = a_t * h_{t-1} + x_t per (batch, channel), over
// time, from h0; writes every h_t (B, S, R) and the final state (B, R), all
// float32, one fused multiply-add a step (as XLA compiles the reference's
// scan on the CPU; the plain version rounds the product and the sum apart,
// which differs by an ulp a step in a recurrence that contracts).
//
// What bounds it on an H100: bytes. Each element of a and x is read once and
// each h_t written once, for one multiply and one add: far below the
// operations a byte the card can do. The channels are independent and time
// is strictly sequential. One thread a (batch, channel) walking all of time
// leaves the card short of loads in flight wherever B x R is small: at
// RecurrentGemma-9B's training shape (1, 4096, 4096) that is 4,096 threads,
// 32 CTAs on 132 SMs. The host's plan (rglru.py :: scan_plan) therefore
// picks one of two kernels from the shapes alone:
//   * rglru_kernel, one chunk: where B x R alone fills the card or S is
//     short (every decode step). One thread a (batch, channel) carries its
//     state in a register and walks time with the loads of the next kU steps
//     in flight; a warp's loads and stores are coalesced 128-byte rows.
//   * rglru_chunked_kernel, one pass over chunks of L steps. The map a chunk
//     applies to the state it receives is affine, h_out = X_c + A_c h_in (X_c
//     the state at its end from a zero carry, A_c the product of its a), and
//     maps compose. One CTA a (batch, 64 channels, chunk) takes its chunk
//     from an atomic ticket, chunk-major, so every earlier chunk of its row
//     was handed to a running CTA before it. It copies its a and x tile (L x
//     64 float32 each) into shared memory (cp.async: each element read once
//     from HBM) and computes (X_c, A_c) from the tile. Chunk c = q G + i
//     (groups of G = kGroup chunks) publishes its map for the later chunks
//     of its group; the group's last chunk instead composes the group's map
//     from its chunks' maps in order and publishes that, for every later
//     group. Then the CTA folds carry = X + A carry from h0 over the maps of
//     groups 0 .. q-1 and then of chunks q G .. c-1, in that order (at most
//     C / G + G - 2 maps, read from L2 at once), walks its tile again from
//     that carry, writing h_t, and the last chunk writes h_final. HBM sees
//     a, x and h once; the maps add 16 x (C + C / G) x B x R bytes written
//     and about 16 x C x (C / G + G) / 2 x B x R read from L2. Six CTAs
//     share an SM at L = 64 (32 KB of tiles each), so one's copy overlaps
//     the others' folds and walks.
//     A map is published as two 64-bit words, X's and A's bits each under
//     the call's tag in the high half. A 64-bit access is single-copy
//     atomic, so a reader that finds the tag in both words holds the map:
//     no flag, no fence and no barrier between a map and its reader, which
//     reloads a word until its tag appears.
// No deadlock: a CTA waits only on lower tickets, and those publish their
// maps before they wait on anything (a group's last chunk waits on its
// group's chunks only). Deterministic: no chunk takes its carry from a
// neighbour's finished state; every chunk folds the same maps in the same
// order, so two calls give the same bits (the float order differs from the
// sequential plain version's).
// The ticket and the tags need no memset between calls: one 64-bit atomic
// gives a CTA its ticket (low word) and the call's epoch (high word), the
// tag is the epoch + 1, and the CTA that takes the last ticket, when every
// other one is taken, resets the ticket and opens the next epoch in one
// more atomic. A CUDA graph that replays the kernel therefore replays it
// whole.
// The TPU kernel's blocking of S and R (rglru.py:76-77, a VMEM tile per grid
// step with the carry in scratch, the grid run in order) has no counterpart:
// the chunks run in parallel and the carry crosses them through the maps.
#include <cuda_runtime.h>

namespace repro_torch {

// kernels/rglru.py's plan repeats kRgThreads, kChunkThreads, kGroup and
// kMaxSmem (_THREADS, _CHUNK_THREADS, GROUP, _MAX_SMEM): it sizes the buffer
// that ctl points at from kGroup
constexpr int kRgThreads = 128;   // rglru_kernel: channels a CTA
constexpr int kU = 8;             // rglru_kernel: time steps loaded ahead
constexpr int kChunkThreads = 64; // rglru_chunked_kernel: channels a CTA
constexpr int kGroup = 8;         // chunks a group map composes
constexpr int kFoldU = 8;         // maps loaded at once in the fold
// dynamic shared memory a CTA may take (227 KB, less the static words)
constexpr int kMaxSmem = 232448 - 1024;
static_assert(kGroup - 1 <= kFoldU, "a group's maps are loaded at once");

__global__ void __launch_bounds__(kRgThreads)
rglru_kernel(const float* __restrict__ a, const float* __restrict__ x,
             const float* __restrict__ h0, float* __restrict__ out,
             float* __restrict__ h_final, int S, int R) {
  const int r = blockIdx.x * kRgThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (r >= R) return;
  const long long base = (long long)b * S * R + r;
  const float* ab = a + base;
  const float* xb = x + base;
  float* ob = out + base;
  float h = h0[(long long)b * R + r];

  float an[kU], xn[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    an[u] = u < S ? ab[(long long)u * R] : 1.f;
    xn[u] = u < S ? xb[(long long)u * R] : 0.f;
  }
  for (int t0 = 0; t0 < S; t0 += kU) {
    float ac[kU], xc[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      ac[u] = an[u];
      xc[u] = xn[u];
    }
    const int t1 = t0 + kU;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (t1 + u < S) {
        an[u] = ab[(long long)(t1 + u) * R];
        xn[u] = xb[(long long)(t1 + u) * R];
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (t0 + u < S) {
        h = fmaf(ac[u], h, xc[u]);
        ob[(long long)(t0 + u) * R] = h;
      }
    }
  }
  h_final[(long long)b * R + r] = h;
}

// A map (X, A) as two 64-bit words, each a float's bits (low half) under the
// call's tag (high half): a 64-bit access is single-copy atomic, so a reader
// that finds the tag in both words has the map, with no flag and no fence.
__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void put_map(unsigned long long* m, float X, float A, unsigned tag) {
  st_relaxed(m, (unsigned long long)tag << 32 | __float_as_uint(X));
  st_relaxed(m + 1, (unsigned long long)tag << 32 | __float_as_uint(A));
}

// The n <= kFoldU maps at m, m + stride, ..: all loads issued at once, then
// each reloaded until both its words carry ``tag``; (X, A) into xs / as.
__device__ __forceinline__ void get_maps(const unsigned long long* m, long long stride, int n,
                                         unsigned tag, float* xs, float* as) {
  unsigned long long xw[kFoldU], aw[kFoldU];
#pragma unroll
  for (int u = 0; u < kFoldU; ++u) {
    if (u < n) {
      xw[u] = ld_relaxed(m + u * stride);
      aw[u] = ld_relaxed(m + u * stride + 1);
    }
  }
#pragma unroll
  for (int u = 0; u < kFoldU; ++u) {
    if (u < n) {
      while ((unsigned)(xw[u] >> 32) != tag || (unsigned)(aw[u] >> 32) != tag) {
        __nanosleep(32);
        xw[u] = ld_relaxed(m + u * stride);
        aw[u] = ld_relaxed(m + u * stride + 1);
      }
      xs[u] = __uint_as_float((unsigned)xw[u]);
      as[u] = __uint_as_float((unsigned)aw[u]);
    }
  }
}

// carry = X_j + A_j carry for the n maps at m, m + stride, .., in that order
__device__ __forceinline__ float fold(float carry, const unsigned long long* m, long long stride,
                                      int n, unsigned tag) {
  for (int j = 0; j < n; j += kFoldU) {
    float xs[kFoldU], as[kFoldU];
    const int k = min(kFoldU, n - j);
    get_maps(m + j * stride, stride, k, tag, xs, as);
#pragma unroll
    for (int u = 0; u < kFoldU; ++u)
      if (u < k) carry = fmaf(as[u], carry, xs[u]);
  }
  return carry;
}

template <int BYTES>
__device__ __forceinline__ void cp_async(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(gmem) : "memory");
  }
}

// One CTA a (batch, 64 channels, chunk): chunk c of batch b's channel block
// from ticket = (c * B + b) * blocks + block. Shared memory: the a tile then
// the x tile, [L][kChunkThreads] float32 each. ctl: a 64-bit word (ticket low,
// epoch high), 8 bytes of padding, then the tagged chunk maps (C, B, R) and
// group maps (Q, B, R), Q = ceil(C / kGroup), two 64-bit words each. kVec:
// R % 4 == 0 and 16-byte aligned rows, copied 16 bytes a cp.async; else 4
// bytes a thread a step.
template <bool kVec>
__global__ void __launch_bounds__(kChunkThreads)
rglru_chunked_kernel(const float* __restrict__ a, const float* __restrict__ x,
                     const float* __restrict__ h0, float* __restrict__ out,
                     float* __restrict__ h_final, unsigned long long* __restrict__ ctl, int B,
                     int S, int R, int L, int n_chunks, int blocks) {
  extern __shared__ float tile[];
  float* ta = tile;
  float* tx = tile + L * kChunkThreads;
  __shared__ unsigned ticket_s, tag_s;
  const int tid = threadIdx.x;
  if (tid == 0) {
    // one atomic gives the ticket and the call's epoch; the CTA that takes
    // the last ticket (every other one taken) resets the ticket and opens
    // the next epoch
    const unsigned long long got = atomicAdd(ctl, 1ull);
    ticket_s = (unsigned)got;
    tag_s = (unsigned)(got >> 32) + 1u;
    if ((unsigned)got == gridDim.x - 1) atomicAdd(ctl, (1ull << 32) - gridDim.x);
  }
  __syncthreads();
  const unsigned ticket = ticket_s, tag = tag_s;
  const int rows = B * blocks;
  const int c = (int)(ticket / rows), row = (int)(ticket % rows);
  const int b = row / blocks, r0 = (row % blocks) * kChunkThreads, r = r0 + tid;
  const bool live = r < R;
  const int t_lo = c * L, n_t = min(S - t_lo, L);
  const long long base = ((long long)b * S + t_lo) * R;

  if constexpr (kVec) {
    const int pieces = min(kChunkThreads, R - r0) / 4;   // 16-byte pieces of a row of this block
    for (int i = tid; i < n_t * (kChunkThreads / 4); i += kChunkThreads) {
      const int t = i / (kChunkThreads / 4), q = i % (kChunkThreads / 4);
      if (q < pieces) {
        const long long g = base + (long long)t * R + r0 + 4 * q;
        cp_async<16>(ta + t * kChunkThreads + 4 * q, a + g);
        cp_async<16>(tx + t * kChunkThreads + 4 * q, x + g);
      }
    }
  } else if (live) {
    for (int t = 0; t < n_t; ++t) {
      const long long g = base + (long long)t * R + r;
      cp_async<4>(ta + t * kChunkThreads + tid, a + g);
      cp_async<4>(tx + t * kChunkThreads + tid, x + g);
    }
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  if (!live) return;

  // chunk c = q G + i. Its map is read by chunks c+1 .. of its group; the
  // group's last chunk composes the group's map, read by every later group
  const int q = c / kGroup, i = c % kGroup;
  const long long step = 2LL * B * R;                     // words from one chunk's map to the next
  unsigned long long* chunk_maps = ctl + 2 + 2LL * ((long long)b * R + r);
  unsigned long long* group_maps = chunk_maps + (long long)n_chunks * step;
  const bool later = c < n_chunks - 1;
  if (later) {
    float X = 0.f, A = 1.f;
#pragma unroll 8
    for (int t = 0; t < n_t; ++t) {
      const float at = ta[t * kChunkThreads + tid];
      X = fmaf(at, X, tx[t * kChunkThreads + tid]);
      A *= at;
    }
    if (i < kGroup - 1) {
      put_map(chunk_maps + c * step, X, A, tag);
    } else {
      // the group's map: its chunks' maps composed in order, this one last
      float xs[kFoldU], as[kFoldU];
      get_maps(chunk_maps + q * kGroup * step, step, kGroup - 1, tag, xs, as);
      float Xg = 0.f, Ag = 1.f;
#pragma unroll
      for (int u = 0; u < kGroup - 1; ++u) {
        Xg = fmaf(as[u], Xg, xs[u]);
        Ag *= as[u];
      }
      put_map(group_maps + q * step, fmaf(A, Xg, X), Ag * A, tag);
    }
  }
  // the carry into this chunk: the earlier groups' maps, then the earlier
  // chunks' of its own group, folded from h0 in that order
  float carry = fold(h0[(long long)b * R + r], group_maps, step, q, tag);
  carry = fold(carry, chunk_maps + q * kGroup * step, step, i, tag);

  float h = carry;
  float* ob = out + base + r;
#pragma unroll 8
  for (int t = 0; t < n_t; ++t) {
    h = fmaf(ta[t * kChunkThreads + tid], h, tx[t * kChunkThreads + tid]);
    ob[(long long)t * R] = h;
  }
  if (c == n_chunks - 1) h_final[(long long)b * R + r] = h;
}

// each variant's shared-memory attributes set (file scope: one flag a library)
static bool g_configured[2] = {false, false};

template <bool kVec>
cudaError_t launch_chunked(const float* a, const float* x, const float* h0, float* out,
                           float* h_final, unsigned long long* ctl, int B, int S, int R, int L,
                           int n_chunks, cudaStream_t s) {
  bool& configured = g_configured[kVec];
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(rglru_chunked_kernel<kVec>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(rglru_chunked_kernel<kVec>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int smem = 2 * L * kChunkThreads * (int)sizeof(float);
  const int blocks = (R + kChunkThreads - 1) / kChunkThreads;
  const long long grid = (long long)n_chunks * B * blocks;
  rglru_chunked_kernel<kVec><<<(unsigned)grid, kChunkThreads, smem, s>>>(a, x, h0, out, h_final, ctl,
                                                                       B, S, R, L, n_chunks, blocks);
  return cudaGetLastError();
}

}  // namespace repro_torch

using namespace repro_torch;

// a, x, out (B, S, R) and h0, h_final (B, R): contiguous float32. L: time
// steps a chunk (the host's plan; L >= S runs rglru_kernel, one chunk).
// Chunked (L < S, C = ceil(S / L) chunks): ctl, 16 + 16 x (C + ceil(C /
// kGroup)) x B x R bytes, 8-byte aligned, zero when first allocated and left
// ready for the next call by every launch. Returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int rglru_scan_launch(const void* a, const void* x, const void* h0, void* out,
                                 void* h_final, void* ctl, int B, int S, int R, int L,
                                 void* stream) {
  if (B < 0 || S < 0 || R < 0 || B > 65535 || L < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || R == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fa = static_cast<const float*>(a);
  const float* fx = static_cast<const float*>(x);
  const float* fh0 = static_cast<const float*>(h0);
  float* fo = static_cast<float*>(out);
  float* fh = static_cast<float*>(h_final);
  if (L >= S) {
    const dim3 grid((R + kRgThreads - 1) / kRgThreads, B);
    rglru_kernel<<<grid, kRgThreads, 0, s>>>(fa, fx, fh0, fo, fh, S, R);
    return (int)cudaGetLastError();
  }
  const long long n_chunks = ((long long)S + L - 1) / L;
  const long long blocks = (R + kChunkThreads - 1) / kChunkThreads;
  if (2LL * L * kChunkThreads * sizeof(float) > kMaxSmem || n_chunks * B * blocks > 0x7fffffffLL ||
      ctl == nullptr || (reinterpret_cast<unsigned long long>(ctl) & 7) != 0)
    return (int)cudaErrorInvalidValue;
  const bool vec = R % 4 == 0 && ((reinterpret_cast<unsigned long long>(a) |
                                   reinterpret_cast<unsigned long long>(x)) & 15) == 0;
  unsigned long long* c = static_cast<unsigned long long*>(ctl);
  const cudaError_t err =
      vec ? launch_chunked<true>(fa, fx, fh0, fo, fh, c, B, S, R, L, (int)n_chunks, s)
          : launch_chunked<false>(fa, fx, fh0, fo, fh, c, B, S, R, L, (int)n_chunks, s);
  return (int)err;
}
