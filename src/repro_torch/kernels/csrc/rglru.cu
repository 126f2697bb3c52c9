// RG-LRU linear recurrence for Hopper (sm_90a), CUDA C++.
//
// Replaces: the Pallas TPU kernel
//   src/repro/kernels/rglru.py :: rglru_scan (body _rglru_kernel), whose
//   oracle is src/repro/kernels/ref.py :: rglru_scan_ref.
// The serving path runs it in every recurrent layer of RecurrentGemma, on
// the whole prompt in a prefill (B, S, R) and on one token in a decode step
// (B, 1, R); the reference model runs a lax.scan there
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
// is strictly sequential, so:
//   * one thread per (batch, channel) carries its state in a register and
//     walks time; neighbouring threads hold neighbouring channels, so every
//     load and store of a warp is one coalesced 128-byte row segment;
//   * the loads of the next kU time steps start before the current kU
//     steps' dependent multiply-adds run, so a thread has 2 x kU loads in
//     flight while it computes, which hides the memory latency that a
//     load-then-use loop would pay on every step.
// The TPU kernel's blocking of S and R (rglru.py:76-77, a VMEM tile per grid
// step with the carry in scratch) has no counterpart: time is a loop inside
// the thread and any S and R are taken.
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kRgThreads = 128;
constexpr int kU = 8;  // time steps loaded ahead

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

}  // namespace repro_torch

using namespace repro_torch;

// a, x, out (B, S, R) and h0, h_final (B, R): contiguous float32. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int rglru_scan_launch(const void* a, const void* x, const void* h0,
                                 void* out, void* h_final, int B, int S, int R,
                                 void* stream) {
  if (B < 0 || S < 0 || R < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0 || R == 0) return 0;
  const dim3 grid((R + kRgThreads - 1) / kRgThreads, B);
  rglru_kernel<<<grid, kRgThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(x),
      static_cast<const float*>(h0), static_cast<float*>(out),
      static_cast<float*>(h_final), S, R);
  return (int)cudaGetLastError();
}
