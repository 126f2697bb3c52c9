// Backward of the RG-LRU linear recurrence for Hopper (sm_90a), CUDA C++.
//
// Replaces: the gradient that jax.grad derives for the reference's
// recurrence on its training path, the lax.scan of
//   src/repro/models/recurrentgemma.py :: RecurrentGemma._rec_block_seq
// (whose kernel form is src/repro/kernels/rglru.py :: rglru_scan, oracle
// src/repro/kernels/ref.py :: rglru_scan_ref). There is no Pallas kernel for
// it: the TPU kernel has no custom_vjp. The forward here is rglru.cu; the
// training path (kernels/rglru.py :: RGLRUScanFn) saves a and the forward's
// h and runs this kernel in its backward.
//
// What it computes: for h_t = a_t * h_{t-1} + x_t over t = 1..S from h0,
// the incoming gradient g_t of every h_t and g_fin of the final state
// (added to g_S), the reverse scan
//   dh_t = g_t + a_{t+1} * dh_{t+1}     (dh_S = g_S + g_fin)
//   da_t = dh_t * h_{t-1}               (h_0 = h0)
//   dx_t = dh_t
//   dh0  = a_1 * dh_1
// per (batch, channel), all float32.
//
// What bounds it on an H100: bytes. Each element of a, h and g is read once
// and each of da and dx written once (20 bytes) for one multiply-add and one
// multiply: far below the operations a byte the card can do. The channels
// are independent and each is a sequential chain in time, so one thread a
// (batch, channel) leaves the card short of loads in flight at a training
// shape (4096 threads at B 1 x R 4096). The scan is therefore chunked over
// time (the host's plan, rglru_bwd.py :: scan_plan, picks the chunk length
// L from the shapes; a single chunk where B x R alone fills the card):
//   * the map a chunk applies to the carry it receives from the chunk after
//     it (carry = a_{t+1} dh_{t+1}) is affine: carry_out = X_c + A_c carry_in,
//     with X_c the chunk's carry out from a zero carry in and A_c the
//     product of its a. rglru_bwd_chunk_kernel computes X_c and A_c of every
//     chunk but the first (reads a and g);
//   * rglru_bwd_kernel, one thread a (batch, channel, chunk), first folds
//     the later chunks' maps into its carry in, last chunk first, from g_fin
//     (a few hundred bytes a thread from L2), then walks its chunk backwards
//     writing da and dx, and the first chunk writes dh0 (reads a, h and g,
//     writes da and dx). The carry of every chunk is computed in the same
//     order whatever the order the CTAs run in, so two runs give the same
//     bits; the float order differs from the sequential plain version's;
//   * neighbouring threads hold neighbouring channels, so every load and
//     store of a warp is one coalesced 128-byte segment; the loads of the
//     next kU steps back start before the current kU steps' dependent
//     arithmetic runs;
//   * h_{t-1} is read from the forward's h shifted by one step, so x is
//     never kept for the backward.
// Seven arrays move where the bound counts five (a and g are read twice):
// the design's floor is 1.4x the bound.
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kRgBwdThreads = 128;
constexpr int kRgBwdU = 8;  // time steps loaded ahead

// X_c and A_c of chunk c = blockIdx.y + 1 (the first chunk's map is never
// applied), at (c, b, r) of xs and as (C, B, R)
__global__ void __launch_bounds__(kRgBwdThreads)
rglru_bwd_chunk_kernel(const float* __restrict__ a, const float* __restrict__ g,
                       float* __restrict__ xs, float* __restrict__ as, int B, int S, int R, int L) {
  constexpr int U = kRgBwdU;
  const int r = blockIdx.x * kRgBwdThreads + threadIdx.x;
  const int c = blockIdx.y + 1, b = blockIdx.z;
  if (r >= R) return;
  const long long base = (long long)b * S * R + r;
  const float* ab = a + base;
  const float* gb = g + base;
  const int t_lo = c * L, t_hi = min(S, t_lo + L);
  float carry = 0.f, prod = 1.f;
  for (int t0 = t_hi - 1; t0 >= t_lo; t0 -= U) {
    float an[U], gn[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 - u;
      an[u] = t >= t_lo ? ab[(long long)t * R] : 1.f;
      gn[u] = t >= t_lo ? gb[(long long)t * R] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 - u >= t_lo) {
        carry = an[u] * (gn[u] + carry);
        prod *= an[u];
      }
    }
  }
  const long long at = ((long long)c * B + b) * R + r;
  xs[at] = carry;
  as[at] = prod;
}

// one thread a (channel r, chunk blockIdx.y, batch blockIdx.z)
__global__ void __launch_bounds__(kRgBwdThreads)
rglru_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                 const float* __restrict__ h0, const float* __restrict__ g,
                 const float* __restrict__ g_fin, const float* __restrict__ xs,
                 const float* __restrict__ as, float* __restrict__ da,
                 float* __restrict__ dx, float* __restrict__ dh0, int B, int S, int R, int L) {
  constexpr int U = kRgBwdU;
  const int r = blockIdx.x * kRgBwdThreads + threadIdx.x;
  const int c = blockIdx.y, n_chunks = gridDim.y, b = blockIdx.z;
  if (r >= R) return;
  // a_{t+1} * dh_{t+1}: what step t receives from the step after it; into
  // this chunk, the later chunks' maps applied to g_fin, last first
  float carry = g_fin[(long long)b * R + r];
#pragma unroll 8
  for (int j = n_chunks - 1; j > c; --j) {
    const long long at = ((long long)j * B + b) * R + r;
    carry = fmaf(as[at], carry, xs[at]);
  }
  const long long base = (long long)b * S * R + r;
  const float* ab = a + base;
  const float* hb = h + base;
  const float* gb = g + base;
  float* dab = da + base;
  float* dxb = dx + base;
  const float h_init = c == 0 ? h0[(long long)b * R + r] : 0.f;
  const int t_lo = c * L, t_hi = min(S, t_lo + L);

  // step t reads a_t, g_t and h_{t-1} (h0 at t = 0); slot u of a block
  // holds step t0 - u
  float an[U], gn[U], hn[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = t_hi - 1 - u;
    an[u] = t >= t_lo ? ab[(long long)t * R] : 0.f;
    gn[u] = t >= t_lo ? gb[(long long)t * R] : 0.f;
    hn[u] = t >= t_lo && t > 0 ? hb[(long long)(t - 1) * R] : h_init;
  }
  for (int t0 = t_hi - 1; t0 >= t_lo; t0 -= U) {
    float ac[U], gc[U], hc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ac[u] = an[u];
      gc[u] = gn[u];
      hc[u] = hn[u];
    }
    const int t1 = t0 - U;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t1 - u;
      if (t >= t_lo) {
        an[u] = ab[(long long)t * R];
        gn[u] = gb[(long long)t * R];
        hn[u] = t > 0 ? hb[(long long)(t - 1) * R] : h_init;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 - u;
      if (t >= t_lo) {
        const float dh = gc[u] + carry;
        dab[(long long)t * R] = dh * hc[u];
        dxb[(long long)t * R] = dh;
        carry = ac[u] * dh;
      }
    }
  }
  if (c == 0) dh0[(long long)b * R + r] = carry;
}

}  // namespace repro_torch

using namespace repro_torch;

// a, h, g, da, dx (B, S, R) and h0, g_fin, dh0 (B, R): contiguous float32.
// L: time steps a chunk (the host's plan; L >= S is one chunk). xs / as:
// float32 scratch of (C, B, R) each, C = ceil(S / L) chunks (unused with one
// chunk). Launches the chunk maps (C > 1) and the scan on ``stream``;
// returns cudaGetLastError() after the launches (0 = launched).
extern "C" int rglru_scan_bwd_launch(const void* a, const void* h, const void* h0,
                                     const void* g, const void* g_fin, void* da, void* dx,
                                     void* dh0, void* xs, void* as, int B, int S, int R, int L,
                                     void* stream) {
  if (B < 0 || S < 0 || R < 0 || B > 65535 || L < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || R == 0) return 0;
  const long long n_chunks = S > L ? ((long long)S + L - 1) / L : 1;
  if (n_chunks > 65535 || (n_chunks > 1 && (xs == nullptr || as == nullptr))) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (R + kRgBwdThreads - 1) / kRgBwdThreads;
  if (n_chunks > 1) {
    rglru_bwd_chunk_kernel<<<dim3(blocks, (int)n_chunks - 1, B), kRgBwdThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(g), static_cast<float*>(xs),
        static_cast<float*>(as), B, S, R, L);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  rglru_bwd_kernel<<<dim3(blocks, (int)n_chunks, B), kRgBwdThreads, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(h),
      static_cast<const float*>(h0), static_cast<const float*>(g),
      static_cast<const float*>(g_fin), static_cast<const float*>(xs), static_cast<const float*>(as),
      static_cast<float*>(da), static_cast<float*>(dx), static_cast<float*>(dh0), B, S, R, L);
  return (int)cudaGetLastError();
}
