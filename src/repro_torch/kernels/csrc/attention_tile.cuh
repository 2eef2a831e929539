// Online-softmax GQA attention over shared-memory tiles of keys, for NVIDIA
// Hopper (sm_90a): the stages that the paged kernel (paged_attention.cu) and
// the contiguous-ring kernel (decode_attention.cu) share.
//
// One thread block serves the R query rows that read one kv head (the GQA
// group of a slot, times its query tokens).  It walks the slot's keys in
// tiles of KT keys; for each tile the caller fills kp[t] (the key's
// position, or -1 for a key that no row may see) and calls load_tile and
// attend_tile.  Softmax is online, in float32: m (running max), l (running
// sum) and acc (running P V) stay in shared memory across tiles, and
// store_rows writes acc / max(l, 1e-30), so a row that saw no key is exact
// zeros.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

namespace attn_tile {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDPerLane = 8;          // head_dim <= 256, head_dim % 32 == 0
constexpr int kTileKeys = 64;            // keys per tile
constexpr int kLoadBatch = 4;            // 16-byte loads in flight per thread
constexpr float kNegInit = -1e30f;       // running-max start, as on the TPU
constexpr size_t kMaxSmem = 232448;      // 227 KB a block may opt into

enum DType { kFloat32 = 0, kBFloat16 = 1 };

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

// The block's shared memory, carved from one dynamic allocation.
template <typename TKV>
struct Tile {
  TKV* ks;       // [KT][D] keys of the tile
  TKV* vs;       // [KT][D] values of the tile
  float* qs;     // [R][D] query rows, float32
  float* acc;    // [R][D] running P V
  float* sc;     // [R][KT] scores, then probabilities
  float* m;      // [R] running max
  float* l;      // [R] running sum
  float* alpha;  // [R] rescale of the previous tiles
  int* kp;       // [KT] key positions, -1 = masked for every row
};

template <typename TKV>
__device__ __forceinline__ Tile<TKV> carve(unsigned char* smem, int KT, int R,
                                           int D) {
  Tile<TKV> s;
  s.ks = reinterpret_cast<TKV*>(smem);
  s.vs = s.ks + (size_t)KT * D;
  s.qs = reinterpret_cast<float*>(s.vs + (size_t)KT * D);
  s.acc = s.qs + (size_t)R * D;
  s.sc = s.acc + (size_t)R * D;
  s.m = s.sc + (size_t)R * KT;
  s.l = s.m + R;
  s.alpha = s.l + R;
  s.kp = reinterpret_cast<int*>(s.alpha + R);
  return s;
}

inline size_t smem_bytes(int KT, int R, int D, size_t kv_size) {
  const size_t kt = KT, r = R, d = D;
  return 2 * kt * d * kv_size + (2 * r * d + r * kt + 3 * r) * 4 + kt * 4;
}

// q rows into shared memory as float32 (q_at(r, d) reads element d of row
// r), and the softmax state reset.
template <typename TKV, typename QAt>
__device__ __forceinline__ void init_rows(const Tile<TKV>& s, int R, int D,
                                          QAt q_at) {
  for (int idx = threadIdx.x; idx < R * D; idx += kThreads) {
    const int r = idx / D;
    s.qs[idx] = q_at(r, idx - r * D);
    s.acc[idx] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += kThreads) {
    s.m[r] = kNegInit;
    s.l[r] = 0.f;
  }
}

// K and V rows of the tile into shared memory with 16-byte loads, kLoadBatch
// of them in flight per thread.  row_off(t) is the element offset of key
// t's row for this kv head in k and v, or -1: that row is not read and
// stays zeros.
template <typename TKV, typename RowOff>
__device__ __forceinline__ void load_tile(const Tile<TKV>& s, const TKV* k,
                                          const TKV* v, int KT, int D,
                                          RowOff row_off) {
  constexpr int kVec = 16 / sizeof(TKV);            // elements per 16 bytes
  const int per_row = D / kVec;
  const int total = KT * per_row;
  for (int c0 = threadIdx.x; c0 < total; c0 += kThreads * kLoadBatch) {
    uint4 kr[kLoadBatch], vr[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int c = c0 + u * kThreads;
      kr[u] = make_uint4(0u, 0u, 0u, 0u);
      vr[u] = kr[u];
      if (c < total) {
        const int t = c / per_row;
        const long long off = row_off(t);
        if (off >= 0) {
          const size_t e = (size_t)off + (size_t)(c - t * per_row) * kVec;
          kr[u] = *reinterpret_cast<const uint4*>(k + e);
          vr[u] = *reinterpret_cast<const uint4*>(v + e);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int c = c0 + u * kThreads;
      if (c < total) {
        reinterpret_cast<uint4*>(s.ks)[c] = kr[u];
        reinterpret_cast<uint4*>(s.vs)[c] = vr[u];
      }
    }
  }
}

// One tile of online softmax, after load_tile and a barrier.  ok(r, kpos)
// says whether row r sees the key at position kpos (kpos < 0 is never
// seen).  Ends without a barrier: the caller's next tile starts with one.
template <typename TKV, typename Ok>
__device__ __forceinline__ void attend_tile(const Tile<TKV>& s, int R, int KT,
                                            int D, float scale, float softcap,
                                            Ok ok) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nd = D / 32;                    // head_dim elements per lane

  // scores: one warp per key, lanes split head_dim, one reduction per row
  for (int t = warp; t < KT; t += kWarps) {
    const int kpos = s.kp[t];
    float kr[kMaxDPerLane];
#pragma unroll
    for (int u = 0; u < kMaxDPerLane; ++u)
      kr[u] = u < nd ? to_f32(s.ks[(size_t)t * D + u * 32 + lane]) : 0.f;
    for (int r = 0; r < R; ++r) {
      float sv = -CUDART_INF_F;
      if (kpos >= 0 && ok(r, kpos)) {       // uniform over the warp
        float part = 0.f;
#pragma unroll
        for (int u = 0; u < kMaxDPerLane; ++u)
          if (u < nd) part += s.qs[(size_t)r * D + u * 32 + lane] * kr[u];
        sv = warp_sum(part) * scale;
        if (softcap > 0.f) sv = softcap * tanhf(sv / softcap);
      }
      if (lane == 0) s.sc[(size_t)r * KT + t] = sv;
    }
  }
  __syncthreads();

  // online softmax over the tile: one warp per query row
  for (int r = warp; r < R; r += kWarps) {
    float* row = s.sc + (size_t)r * KT;
    float mt = kNegInit;
    for (int t = lane; t < KT; t += 32) mt = fmaxf(mt, row[t]);
    mt = warp_max(mt);
    const float m_old = s.m[r];
    const float m_new = fmaxf(m_old, mt);
    float sum = 0.f;
    for (int t = lane; t < KT; t += 32) {
      const float sv = row[t];
      const float pr = sv == -CUDART_INF_F ? 0.f : expf(sv - m_new);
      row[t] = pr;
      sum += pr;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float a = expf(m_old - m_new);
      s.alpha[r] = a;
      s.l[r] = a * s.l[r] + sum;
      s.m[r] = m_new;
    }
  }
  __syncthreads();

  // acc = alpha * acc + P V, one (row, d) element per thread and step
  for (int idx = tid; idx < R * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const float* pr = s.sc + (size_t)r * KT;
    float a = s.acc[idx] * s.alpha[r];
    for (int t = 0; t < KT; ++t) a += pr[t] * to_f32(s.vs[(size_t)t * D + d]);
    s.acc[idx] = a;
  }
}

// acc / max(l, 1e-30) to the output; out_at(r, d) is the output element of
// row r, head element d.  Call after a barrier.
template <typename TQ, typename TKV, typename OutAt>
__device__ __forceinline__ void store_rows(const Tile<TKV>& s, int R, int D,
                                           OutAt out_at) {
  for (int idx = threadIdx.x; idx < R * D; idx += kThreads) {
    const int r = idx / D;
    *out_at(r, idx - r * D) = from_f32<TQ>(s.acc[idx] / fmaxf(s.l[r], 1e-30f));
  }
}

// Opt the kernel into the shared memory it needs above 48 KB and launch.
template <typename Kernel, typename P>
cudaError_t launch_with_smem(Kernel kernel, dim3 grid, size_t smem,
                             cudaStream_t stream, const P& p) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace attn_tile
