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
// sum, never fused, in t order per channel.  So a pad step of a masked
// prefill (log_a = 0, b = 0: a = expf(0) = 1 exactly) leaves h bit for bit
// as it was, and a left-padded row ends bit for bit as its unpadded scan
// does -- the scheduler's bucketing (serving/scheduler.py) relies on it.
// That is why the chain is never cut into time chunks: a chunked scan,
// h_t = A_t * carry + H_t, rounds in another order.
//
// Bound: device memory.  The function must read log_a and b and write h,
// 3 * B*S*R * 4 bytes (plus h0), with a handful of operations per element:
// 503 MB at the serve's 4 x 4096 x 2560, 0.150 ms at 3.35 TB/s.  By
// Little's law the card holds 3.0 TB/s only with about 2.4 MB of loads in
// flight at all times (0.78 us of loaded latency).  The first version kept
// each thread's next 16 steps in registers: at B = 4, R = 2560 that is at
// most 1.3 MB in flight, and it ran at half the bound (0.2995 ms).
//
// Design: a block owns one slot and a strip of kStrip = 32 channels, whose
// step rows are 128 bytes each in device memory.  Warp 0 walks the chain:
// lane c carries h of channel r0 + c in a register over t = 0 .. S-1, two
// shared loads, one product, one sum and one streaming store a step.  The
// copy warps keep a ring of `stages` shared-memory stages full: each stage
// holds `steps` rows of log_a and of b, copied with cp.async (16 bytes a
// copy, or 4 where R % 4 != 0 or a base is not 16-byte aligned).  A copy
// thread waits for its own copies, takes a = expf(log_a) in place on
// exactly the elements it copied (off the chain's path), and arrives on
// the stage's `full` barrier; the chain warp arrives on its `empty`
// barrier when it has read the stage.  Up to stages - 1 stages are in
// flight a block: at the serve's B = 4 (320 blocks of 4 stages of 32
// steps) 7.9 MB.  Any R (the ragged last strip is masked, nothing is
// padded) and any S >= 1.  The wrapper's scan_plan (shapes, alignment and
// the SM count only) chooses steps, stages, copy width and copy warps:
// with more than one block an SM, short stages and few copy warps; with
// one or fewer, long stages and many.
//
// Measured (scripts/ab_rglru_scan.py, in turns with the first version;
// NVIDIA H100 80GB HBM3, 700 W): 4 x 4096 x 2560 0.178-0.179 ms against
// 0.298 (84% of the bound), the score's 2 x 4096 x 2560 0.091 against
// 0.287 (82%), 4 x 256 x 2560 0.0120 against 0.0200 (78%); outputs bit
// for bit the first version's.  PERF.md §6, row 5.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kStrip = 32;          // channels a block: the chain warp's lanes
constexpr int kMaxCopyWarps = 7;    // warps that copy and take exp, at most
constexpr int kMaxThreads = 32 * (1 + kMaxCopyWarps);
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 232448;  // shared memory a block may have: 227 KB
constexpr int kSmemDefault = 48 * 1024;   // above it, only after opting in
// the static barriers, and the dynamic shared memory left beside them
constexpr int kBarrierBytes = 2 * kMaxStages * (int)sizeof(uint64_t);
constexpr int kMaxRing = kSmemLimit - kBarrierBytes;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// release: this thread's shared-memory writes and reads come before it
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// acquire: wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

template <int VEC>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  if constexpr (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src));
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most `pending` of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void copies_wait_n() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void copies_wait(int pending) {
  switch (pending) {
    case 0: copies_wait_n<0>(); break;
    case 1: copies_wait_n<1>(); break;
    case 2: copies_wait_n<2>(); break;
    case 3: copies_wait_n<3>(); break;
    case 4: copies_wait_n<4>(); break;
    case 5: copies_wait_n<5>(); break;
    default: copies_wait_n<6>(); break;   // pending < kMaxStages - 1
  }
}

// The ring: `stages` stages of [2][steps][kStrip] floats, log_a (then a)
// rows first, b rows after.  The block is the chain warp and the copy
// warps; copy thread i owns the pieces i, i + copy threads, ... of every
// stage: VEC floats of one row each.
template <int VEC>
__global__ void __launch_bounds__(kMaxThreads)
rglru_scan_kernel(const float* __restrict__ log_a,
                  const float* __restrict__ bx,
                  const float* __restrict__ h0, float* __restrict__ out,
                  int S, int R, int steps, int stages) {
  extern __shared__ __align__(16) float ring[];
  __shared__ uint64_t full[kMaxStages], empty[kMaxStages];
  const int r0 = blockIdx.x * kStrip;
  const int width = min(kStrip, R - r0);       // the ragged last strip
  const size_t first = (size_t)blockIdx.y * S;  // the slot's row 0 of [B*S, R]
  const int tiles = (S + steps - 1) / steps;
  const int tile = steps * kStrip;              // floats of one array a stage
  const int copiers = blockDim.x - 32;          // the copy warps' threads

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      bar_init(&full[s], copiers);
      bar_init(&empty[s], 32);
    }
  }
  __syncthreads();

  if (threadIdx.x < 32) {                       // the chain
    const int lane = threadIdx.x;
    const bool live = lane < width;
    float h = h0 != nullptr && live ? h0[(size_t)blockIdx.y * R + r0 + lane]
                                    : 0.f;
    float* o = out + first * R + r0 + lane;
    for (int k = 0; k < tiles; ++k) {
      const int st = k % stages;
      bar_wait(&full[st], (k / stages) & 1);
      const float* a = ring + (size_t)st * 2 * tile + lane;
      const float* b = a + tile;
      const int rows = min(steps, S - k * steps);
#pragma unroll 8
      for (int t = 0; t < rows; ++t) {
        h = __fadd_rn(__fmul_rn(a[t * kStrip], h), b[t * kStrip]);  // no FMA
        if (live) __stcs(o, h);
        o += R;
      }
      bar_arrive(&empty[st]);
    }
    return;
  }

  // the copy warps: tile k goes into stage k % stages once the chain has
  // released the stage; the exp of tile k - lag follows each issue.  lag <=
  // stages - 1 keeps the ring from deadlocking (the chain can finish tile
  // k - stages), lag <= stages - 2 has the next tile's exp done before the
  // chain asks for it.
  constexpr int per_row = kStrip / VEC;
  const int i = threadIdx.x - 32;
  const int pieces = steps * per_row;
  const int lag = stages >= 3 ? stages - 2 : stages - 1;
  for (int k = 0; k < tiles + lag; ++k) {
    if (k < tiles) {
      const int st = k % stages;
      if (k >= stages) bar_wait(&empty[st], (k / stages - 1) & 1);
      float* sa = ring + (size_t)st * 2 * tile;
      const int rows = min(steps, S - k * steps);
      for (int p = i; p < pieces; p += copiers) {
        const int t = p / per_row, c = (p % per_row) * VEC;
        if (t < rows && c < width) {
          const size_t g = (first + (size_t)k * steps + t) * R + r0 + c;
          copy_async<VEC>(sa + t * kStrip + c, log_a + g);
          copy_async<VEC>(sa + tile + t * kStrip + c, bx + g);
        }
      }
      copies_commit();                          // one group a tile, even empty
    }
    const int j = k - lag;
    if (j >= 0) {
      copies_wait(min(k + 1, tiles) - 1 - j);   // tile j's copies have landed
      float* sa = ring + (size_t)(j % stages) * 2 * tile;
      const int rows = min(steps, S - j * steps);
      for (int p = i; p < pieces; p += copiers) {
        const int t = p / per_row, c = (p % per_row) * VEC;
        if (t < rows && c < width) {
          float* e = sa + t * kStrip + c;
          if constexpr (VEC == 4) {
            float4 v = *reinterpret_cast<float4*>(e);
            v.x = expf(v.x);
            v.y = expf(v.y);
            v.z = expf(v.z);
            v.w = expf(v.w);
            *reinterpret_cast<float4*>(e) = v;
          } else {
            *e = expf(*e);
          }
        }
      }
      bar_arrive(&full[j % stages]);
    }
  }
}

}  // namespace

// The plan (strip, steps, stages, vec, copy_warps) is rglru_scan.scan_plan's:
// the entry checks it and launches it as given.
extern "C" int rglru_scan_launch(const void* log_a, const void* b,
                                 const void* h0, void* out, int B, int S,
                                 int R, int strip, int steps, int stages,
                                 int vec, int copy_warps, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || R <= 0 || strip != kStrip ||
      steps <= 0 || stages <= 0 || stages > kMaxStages ||
      (vec != 1 && vec != 4) || copy_warps < 1 ||
      copy_warps > kMaxCopyWarps)
    return (int)cudaErrorInvalidValue;
  if (vec == 4 && (R % 4 != 0 || (uintptr_t)log_a % 16 != 0 ||
                   (uintptr_t)b % 16 != 0))
    return (int)cudaErrorInvalidValue;          // 16-byte copies of rows
  const size_t smem = (size_t)stages * 2 * steps * kStrip * sizeof(float);
  if (smem > (size_t)kMaxRing) return (int)cudaErrorInvalidValue;
  auto kernel = vec == 4 ? rglru_scan_kernel<4> : rglru_scan_kernel<1>;
  if (smem + kBarrierBytes > (size_t)kSmemDefault) {   // static counts too
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((R + kStrip - 1) / kStrip, B);
  kernel<<<grid, 32 * (1 + copy_warps), smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(out), S, R, steps,
      stages);
  return (int)cudaGetLastError();
}
