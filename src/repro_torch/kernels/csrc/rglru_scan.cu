// RG-LRU sequence scan, h_t = exp(log_a_t) * h_{t-1} + b_t, for NVIDIA Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// repro_torch/kernels/rglru_scan.py.
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py::rglru_scan_pallas
// (body _rglru_kernel, wrapper repro/kernels/ops.py::rglru_scan).
//
// What it computes: log_a and b [B, S, R] float32 and h0 [B, R] float32 (or
// none: zeros) give h [B, S, R] float32 with h_{-1} = h0.  a = exp(log_a) is
// taken here (the TPU wrapper took it in XLA, a pass over [B, S, R] more).
// Every step rounds as the reference's a * h + b does: one product, then one
// sum, never fused.  So a pad step of a masked prefill (log_a = 0, b = 0:
// a = expf(0) = 1 exactly) leaves h bit for bit as it was.
//
// Bound: device memory.  The function must read log_a and b and write h,
// 3 * B*S*R * 4 bytes (plus h0), and does a handful of operations per
// element.  Design: the TPU grid (B, R/128) kept a [S, 128] slab in VMEM;
// here one thread owns one (b, r) channel and carries h in a register over
// t = 0 .. S-1, and consecutive threads take consecutive r, so every warp
// reads and writes whole 128-byte rows at every step.  log_a and b do not
// depend on h: each thread keeps the next kAhead steps' loads in flight
// while it runs the current kAhead steps (double-buffered registers), so
// the serial chain waits on memory once per kAhead steps at most.  Any R
// (the ragged last block is masked, nothing is padded) and any S >= 1.
//
// Known limit, for a later PR: at the serve's B = 4, R = 2560 there are only
// 10240 channels, a few warps per SM, and S serial steps each; the loads in
// flight (10240 threads x 2 x kAhead x 4 bytes) do not cover the card's
// memory latency.  A chunked two-pass scan (per-chunk (prod a, partial h),
// then a fix-up) would put S/chunk times more threads to work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 64;   // channels per block: 2 warps
constexpr int kAhead = 16;     // steps loaded ahead of the serial chain

__device__ __forceinline__ void load_steps(const float* __restrict__ la,
                                           const float* __restrict__ bb,
                                           int t0, int S, size_t R,
                                           float (&a)[kAhead],
                                           float (&b)[kAhead]) {
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    const int t = t0 + u;
    a[u] = t < S ? __ldcs(la + (size_t)t * R) : 0.f;   // read once: stream
    b[u] = t < S ? __ldcs(bb + (size_t)t * R) : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ log_a,
                  const float* __restrict__ bx,
                  const float* __restrict__ h0, float* __restrict__ out,
                  int S, int R) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;                       // ragged last block
  const size_t row = (size_t)blockIdx.y * S * R + r;
  const float* la = log_a + row;
  const float* bb = bx + row;
  float* o = out + row;
  float h = h0 != nullptr ? h0[(size_t)blockIdx.y * R + r] : 0.f;

  float ca[kAhead], cb[kAhead], na[kAhead], nb[kAhead];
  load_steps(la, bb, 0, S, R, ca, cb);
  for (int t0 = 0; t0 < S; t0 += kAhead) {
    // the next chunk's loads go out before this chunk's serial chain
    load_steps(la, bb, t0 + kAhead, S, R, na, nb);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (t0 + u < S) {
        h = __fadd_rn(__fmul_rn(expf(ca[u]), h), cb[u]);   // no FMA
        __stcs(o + (size_t)(t0 + u) * R, h);
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      ca[u] = na[u];
      cb[u] = nb[u];
    }
  }
}

}  // namespace

extern "C" int rglru_scan_launch(const void* log_a, const void* b,
                                 const void* h0, void* out, int B, int S,
                                 int R, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || R <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((R + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(out), S, R);
  return (int)cudaGetLastError();
}
