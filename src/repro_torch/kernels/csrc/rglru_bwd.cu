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
// multiply: far below the operations a byte the card can do. As in the
// forward, the channels are independent and time is strictly sequential:
//   * one thread per (batch, channel) carries dh in a register and walks
//     time backwards; neighbouring threads hold neighbouring channels, so
//     every load and store of a warp is one coalesced 128-byte segment;
//   * the loads of the next kU steps back start before the current kU
//     steps' dependent arithmetic runs (3 x kU loads in flight a thread);
//   * h_{t-1} is read from the forward's h shifted by one step, so x is
//     never kept for the backward;
//   * a CTA is one warp: a training shape has few (batch, channel) pairs
//     for the card (4096 at B 1 x R 4096), and one-warp CTAs spread them
//     over 128 SMs where 128-thread CTAs would occupy 32, so more SMs keep
//     loads in flight at once.
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kRgBwdThreads = 32;
constexpr int kRgBwdU = 8;  // time steps loaded ahead

__global__ void __launch_bounds__(kRgBwdThreads)
rglru_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                 const float* __restrict__ h0, const float* __restrict__ g,
                 const float* __restrict__ g_fin, float* __restrict__ da,
                 float* __restrict__ dx, float* __restrict__ dh0, int S, int R) {
  constexpr int U = kRgBwdU;
  const int r = blockIdx.x * kRgBwdThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (r >= R) return;
  const long long base = (long long)b * S * R + r;
  const float* ab = a + base;
  const float* hb = h + base;
  const float* gb = g + base;
  float* dab = da + base;
  float* dxb = dx + base;
  const float h_init = h0[(long long)b * R + r];
  // a_{t+1} * dh_{t+1}: what step t receives from the step after it
  float carry = g_fin[(long long)b * R + r];

  // step t reads a_t, g_t and h_{t-1} (h0 at t = 0); slot u of a block
  // holds step t0 - u
  float an[U], gn[U], hn[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = S - 1 - u;
    an[u] = t >= 0 ? ab[(long long)t * R] : 0.f;
    gn[u] = t >= 0 ? gb[(long long)t * R] : 0.f;
    hn[u] = t > 0 ? hb[(long long)(t - 1) * R] : h_init;
  }
  for (int t0 = S - 1; t0 >= 0; t0 -= U) {
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
      if (t >= 0) {
        an[u] = ab[(long long)t * R];
        gn[u] = gb[(long long)t * R];
        hn[u] = t > 0 ? hb[(long long)(t - 1) * R] : h_init;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 - u;
      if (t >= 0) {
        const float dh = gc[u] + carry;
        dab[(long long)t * R] = dh * hc[u];
        dxb[(long long)t * R] = dh;
        carry = ac[u] * dh;
      }
    }
  }
  dh0[(long long)b * R + r] = carry;
}

}  // namespace repro_torch

using namespace repro_torch;

// a, h, g, da, dx (B, S, R) and h0, g_fin, dh0 (B, R): contiguous float32.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int rglru_scan_bwd_launch(const void* a, const void* h, const void* h0,
                                     const void* g, const void* g_fin, void* da, void* dx,
                                     void* dh0, int B, int S, int R, void* stream) {
  if (B < 0 || S < 0 || R < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0 || R == 0) return 0;
  const dim3 grid((R + kRgBwdThreads - 1) / kRgBwdThreads, B);
  rglru_bwd_kernel<<<grid, kRgBwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(h),
      static_cast<const float*>(h0), static_cast<const float*>(g),
      static_cast<const float*>(g_fin), static_cast<float*>(da), static_cast<float*>(dx),
      static_cast<float*>(dh0), S, R);
  return (int)cudaGetLastError();
}
