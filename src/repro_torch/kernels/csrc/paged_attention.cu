// Paged GQA attention for one decode (or speculative-verify) step, for
// NVIDIA Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// repro_torch/kernels/paged_attention.py.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// paged_decode_attention_bhd (body _decode_kernel via _paged_decode_kernel,
// wrapper repro/kernels/ops.py::paged_decode_attention).  KQ, the number of
// query tokens per slot, is a parameter, so the same kernel also computes
// paged_verify_attention_bhd (KQ > 1); with KQ = 1 it is the decode kernel.
//
// What it computes, for slot b, kv head j and each of the KQ*g query rows
// (row r = i*g + gi is query token i at position pos[b] + i, head j*g + gi):
//   s_t = (q . k_t) / sqrt(D), optionally softcap * tanh(s_t / softcap),
// over the slot's blocks bt[b, ib], with the mask computed here from
// key_pos[b, ib*bs + t]: >= 0, <= pos[b] + i, and > pos[b] + i - window when
// a window is given.  Softmax is online, in float32; the output is
// acc / max(l, 1e-30), so a fully masked row gives exact zeros.  A table
// entry of -1 (or out of the pool) is skipped: its keys count as masked.
// The TPU wrapper built the mask in XLA as a separate pass and bool tensor;
// here it costs one int read per key.
//
// Bound: device memory.  Per layer the kernel must read every valid key and
// value once, bytes = sum over slots of ctx * KH * D * 2 * itemsize, and does
// only ~4*D flops per key and query row.  The design keeps the TPU kernel's
// point: one thread block per (slot, kv head) walks the slot's table, loads
// each K/V tile into shared memory once (16-byte loads) and serves all KQ*g
// query rows of the GQA group from it, so each cache block is read from
// device memory once per step.  A tile holds several cache blocks (about 64
// keys) to amortise the load latency of a step.
//
// Known limits, for a later PR: the grid is B*KH blocks, so the card is
// under-filled when B*KH < 132 (Llama2-70B has KH = 8: B = 4 gives 32
// blocks); split-K (flash-decoding) over the context fixes that.  Loads are
// not double-buffered (cp.async / TMA), so each tile waits for its load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDPerLane = 8;          // head_dim <= 256, head_dim % 32 == 0
constexpr int kTileKeys = 64;            // keys per tile (whole cache blocks)
constexpr float kNegInit = -1e30f;       // running-max start, as on the TPU
constexpr size_t kMaxSmem = 232448;      // 227 KB a block may opt into

enum DType { kFloat32 = 0, kBFloat16 = 1 };

struct Params {
  const void* q;          // [B, KQ, H, D]
  const void* k_pool;     // [n_pool_blocks, bs, KH, D]
  const void* v_pool;
  const int* bt;          // [B, bt_stride] physical block ids, -1 = unmapped
  const int* key_pos;     // [B, nbs * bs] absolute position per ring slot
  const int* pos;         // [B] position of query token 0
  void* out;              // [B, KQ, H, D], dtype of q
  int B, KQ, H, KH, D, bs, nbs, bt_stride, n_pool_blocks;
  int blocks_per_tile;
  float scale;
  float softcap;          // <= 0: none
  int window;             // <= 0: none
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int table_entry(const Params& p, int b, int ib) {
  if (ib >= p.nbs) return -1;
  const int blk = p.bt[(size_t)b * p.bt_stride + ib];
  return (blk >= 0 && blk < p.n_pool_blocks) ? blk : -1;
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const Params p) {
  const int j = blockIdx.x;                 // kv head
  const int b = blockIdx.y;                 // slot
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int D = p.D;
  const int g = p.H / p.KH;
  const int R = p.KQ * g;                   // query rows served per block
  const int KT = p.blocks_per_tile * p.bs;  // keys per tile
  const int nd = D / 32;                    // head_dim elements per lane

  extern __shared__ __align__(16) unsigned char smem[];
  TKV* ks = reinterpret_cast<TKV*>(smem);                      // [KT][D]
  TKV* vs = ks + (size_t)KT * D;                               // [KT][D]
  float* qs = reinterpret_cast<float*>(vs + (size_t)KT * D);   // [R][D]
  float* acc = qs + (size_t)R * D;                             // [R][D]
  float* sc = acc + (size_t)R * D;                             // [R][KT]
  float* m = sc + (size_t)R * KT;                              // [R]
  float* l = m + R;                                            // [R]
  float* alpha = l + R;                                        // [R]
  int* kp = reinterpret_cast<int*>(alpha + R);                 // [KT]

  const TQ* q = static_cast<const TQ*>(p.q);
  const TKV* kpool = static_cast<const TKV*>(p.k_pool);
  const TKV* vpool = static_cast<const TKV*>(p.v_pool);
  const int pos0 = p.pos[b];

  for (int idx = tid; idx < R * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const int i = r / g, gi = r - i * g;
    qs[idx] = to_f32(
        q[(((size_t)b * p.KQ + i) * p.H + (size_t)j * g + gi) * D + d]);
    acc[idx] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m[r] = kNegInit;
    l[r] = 0.f;
  }

  const size_t row_stride = (size_t)p.KH * D;       // token to token
  const size_t blk_stride = (size_t)p.bs * row_stride;
  constexpr int kVec = 16 / sizeof(TKV);            // elements per 16 bytes
  const int chunks_per_row = D / kVec;

  for (int ib0 = 0; ib0 < p.nbs; ib0 += p.blocks_per_tile) {
    // a tile with no mapped block changes nothing: skip it (the test is
    // uniform over the thread block, so no thread waits at a barrier alone)
    bool any = false;
    for (int u = 0; u < p.blocks_per_tile; ++u)
      any |= table_entry(p, b, ib0 + u) >= 0;
    if (!any) continue;
    __syncthreads();        // the previous tile's readers are done

    for (int t = tid; t < KT; t += kThreads) {
      const int ib = ib0 + t / p.bs;
      kp[t] = table_entry(p, b, ib) >= 0
                  ? p.key_pos[(size_t)b * p.nbs * p.bs + (size_t)ib * p.bs +
                              t % p.bs]
                  : -1;
    }
    for (int c = tid; c < KT * chunks_per_row; c += kThreads) {
      const int t = c / chunks_per_row;
      const int cc = c - t * chunks_per_row;
      const int blk = table_entry(p, b, ib0 + t / p.bs);
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;   // unmapped: zeros
      if (blk >= 0) {
        const size_t off = (size_t)blk * blk_stride +
                           (size_t)(t % p.bs) * row_stride + (size_t)j * D +
                           (size_t)cc * kVec;
        kv = *reinterpret_cast<const uint4*>(kpool + off);
        vv = *reinterpret_cast<const uint4*>(vpool + off);
      }
      reinterpret_cast<uint4*>(ks)[c] = kv;
      reinterpret_cast<uint4*>(vs)[c] = vv;
    }
    __syncthreads();

    // scores: one warp per key, lanes split head_dim, one reduction per row
    for (int t = warp; t < KT; t += kWarps) {
      const int kpos = kp[t];
      float kr[kMaxDPerLane];
#pragma unroll
      for (int u = 0; u < kMaxDPerLane; ++u)
        kr[u] = u < nd ? to_f32(ks[(size_t)t * D + u * 32 + lane]) : 0.f;
      for (int r = 0; r < R; ++r) {
        const int qpos = pos0 + r / g;
        const bool ok = kpos >= 0 && kpos <= qpos &&
                        (p.window <= 0 || kpos > qpos - p.window);
        float s = -CUDART_INF_F;
        if (ok) {                           // uniform over the warp
          float part = 0.f;
#pragma unroll
          for (int u = 0; u < kMaxDPerLane; ++u)
            if (u < nd) part += qs[(size_t)r * D + u * 32 + lane] * kr[u];
          s = warp_sum(part) * p.scale;
          if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
        }
        if (lane == 0) sc[(size_t)r * KT + t] = s;
      }
    }
    __syncthreads();

    // online softmax over the tile: one warp per query row
    for (int r = warp; r < R; r += kWarps) {
      float* row = sc + (size_t)r * KT;
      float mt = kNegInit;
      for (int t = lane; t < KT; t += 32) mt = fmaxf(mt, row[t]);
      mt = warp_max(mt);
      const float m_old = m[r];
      const float m_new = fmaxf(m_old, mt);
      float sum = 0.f;
      for (int t = lane; t < KT; t += 32) {
        const float s = row[t];
        const float pr = s == -CUDART_INF_F ? 0.f : expf(s - m_new);
        row[t] = pr;
        sum += pr;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        alpha[r] = a;
        l[r] = a * l[r] + sum;
        m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = alpha * acc + P V, one (row, d) element per thread and step
    for (int idx = tid; idx < R * D; idx += kThreads) {
      const int r = idx / D, d = idx - r * D;
      const float* pr = sc + (size_t)r * KT;
      float a = acc[idx] * alpha[r];
      for (int t = 0; t < KT; ++t) a += pr[t] * to_f32(vs[(size_t)t * D + d]);
      acc[idx] = a;
    }
  }
  __syncthreads();

  TQ* out = static_cast<TQ*>(p.out);
  for (int idx = tid; idx < R * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const int i = r / g, gi = r - i * g;
    out[(((size_t)b * p.KQ + i) * p.H + (size_t)j * g + gi) * D + d] =
        from_f32<TQ>(acc[idx] / fmaxf(l[r], 1e-30f));
  }
}

size_t smem_bytes(const Params& p, size_t kv_size) {
  const size_t kt = (size_t)p.blocks_per_tile * p.bs;
  const size_t r = (size_t)p.KQ * (p.H / p.KH);
  return 2 * kt * p.D * kv_size + (2 * r * p.D + r * kt + 3 * r) * 4 + kt * 4;
}

template <typename TQ, typename TKV>
cudaError_t launch(Params p, cudaStream_t stream) {
  p.blocks_per_tile = kTileKeys / p.bs > 1 ? kTileKeys / p.bs : 1;
  if (p.blocks_per_tile > p.nbs) p.blocks_per_tile = p.nbs;
  size_t smem = smem_bytes(p, sizeof(TKV));
  while (smem > kMaxSmem && p.blocks_per_tile > 1) {
    p.blocks_per_tile /= 2;
    smem = smem_bytes(p, sizeof(TKV));
  }
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<TQ, TKV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(p.KH, p.B);
  paged_attention_kernel<TQ, TKV><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* bt,
    const void* key_pos, const void* pos, void* out, int B, int KQ, int H,
    int KH, int D, int bs, int nbs, int bt_stride, int n_pool_blocks,
    float scale, float softcap, int window, int q_dtype, int kv_dtype,
    void* stream) {
  if (B <= 0 || KQ <= 0 || KH <= 0 || H % KH != 0 || D % 32 != 0 ||
      D > 32 * kMaxDPerLane || bs <= 0 || nbs <= 0 || bt_stride < nbs ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  Params p{q, k_pool, v_pool, static_cast<const int*>(bt),
           static_cast<const int*>(key_pos), static_cast<const int*>(pos),
           out, B, KQ, H, KH, D, bs, nbs, bt_stride, n_pool_blocks, 1,
           scale, softcap, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (q_dtype == kFloat32 && kv_dtype == kFloat32)
    e = launch<float, float>(p, s);
  else if (q_dtype == kBFloat16 && kv_dtype == kBFloat16)
    e = launch<__nv_bfloat16, __nv_bfloat16>(p, s);
  else if (q_dtype == kBFloat16 && kv_dtype == kFloat32)
    e = launch<__nv_bfloat16, float>(p, s);
  else if (q_dtype == kFloat32 && kv_dtype == kBFloat16)
    e = launch<float, __nv_bfloat16>(p, s);
  return (int)e;
}
