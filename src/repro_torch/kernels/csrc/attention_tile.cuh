// What the port's attention kernels for NVIDIA Hopper (sm_90a) share: dtype
// codes and conversions, warp reductions, the launch with its shared-memory
// opt-in, and the pieces of the split (flash-decoding) design that the
// contiguous-ring kernel (decode_attention.cu) and the paged kernel
// (paged_attention.cu) both use.
//
// The split design.  A block serves at most kRowsPerBlock query rows of one
// kv head of one slot and walks one split of the slot's keys in tiles of
// kTileKeys keys; the split count comes from
// repro_torch/kernels/decode_attention.py::split_plan, whose TILE_KEYS,
// ROWS_PER_BLOCK and MAX_SPLITS are the constants below.  A tile's K/V rows
// go to shared memory with cp.async (rows padded by 16 bytes: row_stride),
// and each split writes its unnormalised softmax state (m, l, acc) to a
// float32 workspace, which merge_splits combines in index order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

namespace attn_tile {

constexpr int kThreads = 128;
constexpr float kNegInit = -1e30f;       // running-max start, as on the TPU
constexpr size_t kMaxSmem = 232448;      // 227 KB a block may opt into

constexpr int kTileKeys = 64;            // keys per tile; split_plan's TILE_KEYS
constexpr int kRowsPerBlock = 16;        // split_plan's ROWS_PER_BLOCK
constexpr int kMaxSplits = 64;           // split_plan's MAX_SPLITS
constexpr int kPairs = 128;              // head-element pairs, D <= 256

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

// threads of a split block serving at most kRows query rows: the more rows,
// the more arithmetic per tile, and the more warps share it
template <int kRows>
__host__ __device__ constexpr int block_threads() {
  return kRows > 8 ? 4 * kThreads : kRows > 2 ? 2 * kThreads : kThreads;
}

// elements of a 16-byte vector as float32
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[4],
                                       const float*) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[8],
                                       const __nv_bfloat16*) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    f[2 * u] = __uint_as_float(w[u] << 16);
    f[2 * u + 1] = __uint_as_float(w[u] & 0xffff0000u);
  }
}

// two neighbouring head elements of a V row as float32
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  const unsigned w = *reinterpret_cast<const unsigned*>(p);
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}

// elements from one K/V row of a tile in shared memory to the next
template <typename TKV>
__host__ __device__ constexpr int row_stride(int D) {
  return D + 16 / (int)sizeof(TKV);      // padded by 16 bytes
}

// 16 bytes from device to shared memory, asynchronously; src_bytes = 0
// reads nothing and fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The splits' partial softmax state and the output: rows of H query heads,
// row = blockIdx.y * H + blockIdx.x (blockIdx.y is the slot, or the slot's
// query token with several a slot).
struct MergeParams {
  const float* part_ml;   // [rows, S, 2]: m, l of each split
  const float* part_acc;  // [rows, S, D]: acc of each split
  void* out;              // [rows, D]
  int H, D, S;
};

// The body of a merge kernel of kThreads threads, one block per row: the S
// partials in index order, out = sum_s w_s acc_s / max(sum_s w_s l_s,
// 1e-30), w_s = exp(m_s - max_s m_s).  Thread t < D/2 owns head elements
// 2t, 2t+1 and has kMergeBatch splits' loads in flight at a time.  No
// atomics: the same partials give the same bits; a row whose every split
// saw no key (m_s = -1e30, l_s = 0) comes out as exact zeros.
constexpr int kMergeBatch = 16;

template <typename TQ>
__device__ __forceinline__ void merge_splits(const MergeParams& p) {
  __shared__ float ml[2 * kMaxSplits];      // m_s, l_s
  __shared__ float w[kMaxSplits];
  const int tid = threadIdx.x;
  const size_t row = (size_t)blockIdx.y * p.H + blockIdx.x;
  for (int i = tid; i < 2 * p.S; i += kThreads)
    ml[i] = p.part_ml[row * p.S * 2 + i];
  __syncthreads();
  if (tid < 32) {           // the max is exact in any order
    float mx = kNegInit;
    for (int s = tid; s < p.S; s += 32) mx = fmaxf(mx, ml[2 * s]);
    mx = warp_max(mx);
    for (int s = tid; s < p.S; s += 32) w[s] = expf(ml[2 * s] - mx);
  }
  __syncthreads();
  float l = 0.f;
#pragma unroll 8
  for (int s = 0; s < p.S; ++s) l += w[s] * ml[2 * s + 1];
  const float den = fmaxf(l, 1e-30f);
  if (2 * tid >= p.D) return;
  const float* acc = p.part_acc + row * p.S * p.D + 2 * tid;
  float2 a = make_float2(0.f, 0.f);
  for (int s0 = 0; s0 < p.S; s0 += kMergeBatch) {
    float2 v[kMergeBatch];
#pragma unroll
    for (int u = 0; u < kMergeBatch; ++u)
      if (s0 + u < p.S)
        v[u] = *reinterpret_cast<const float2*>(acc + (size_t)(s0 + u) * p.D);
#pragma unroll
    for (int u = 0; u < kMergeBatch; ++u) {
      if (s0 + u < p.S) {
        a.x += w[s0 + u] * v[u].x;
        a.y += w[s0 + u] * v[u].y;
      }
    }
  }
  TQ* out = static_cast<TQ*>(p.out) + row * p.D + 2 * tid;
  out[0] = from_f32<TQ>(a.x / den);
  out[1] = from_f32<TQ>(a.y / den);
}

// Opt the kernel into the shared memory it needs above 48 KB and launch.
template <typename Kernel, typename P>
cudaError_t launch_with_smem(Kernel kernel, dim3 grid, int threads,
                             size_t smem, cudaStream_t stream, const P& p) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace attn_tile
