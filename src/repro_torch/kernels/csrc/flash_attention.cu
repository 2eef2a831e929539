// Causal flash attention over a whole sequence (the train-mode forward), for
// NVIDIA Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// repro_torch/kernels/flash_attention.py.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_bhsd (body _flash_kernel, wrapper
// repro/kernels/ops.py::flash_attention).
//
// What it computes, in the model layout q [B, S, H, D], k/v [B, S, KH, D]
// (float32 or bfloat16, one dtype) -> out [B, S, H, D] in q's dtype: for
// query row i of head h, over the keys j of kv head h / (H / KH),
//   s_ij = (q_i . k_j) * scale, optionally softcap * tanh(s_ij / softcap),
// visible when j <= i, j < S and, with a window, j > i - window.  Softmax is
// online in float32 (running max m, sum l, and P V in acc); P V is taken in
// float32, and the output is acc / max(l, 1e-30), so a row that sees no key
// is exact zeros.  The TPU wrapper padded S to a multiple of 128 and masked
// keys past the real length; here the ragged last tile masks j >= S itself,
// which is the same function without the padding.
//
// Bound: operations.  The function reads q, k, v and writes out once, but
// does 4 * D flops per visible (query, key) pair and head: at S = 4096 that
// is ~1000 flops per byte, far above the card's ~300.  Design: one thread
// block of 256 threads per (batch, head, tile of 64 query rows), the heavy
// tiles near the diagonal launched first.  The block keeps its query tile
// in shared memory and walks key tiles of 64 from the first tile the window
// reaches to the diagonal tile, so whole tiles are skipped exactly where
// the TPU kernel skips them (entirely above the diagonal, or entirely older
// than the window): both ends of the walk are computed, not tested tile by
// tile.  Inside a tile every element is masked.  Each thread owns a 4 x 4
// block of scores (rows ty + 16i, keys tx + 16j) and a 4 x D/16 block of
// the output, all in registers; P goes through shared memory to the P V
// product.  Shared rows are padded by 4 floats, so the 16-byte reads of a
// warp spread over all banks.  float32 on the CUDA cores, with the accurate
// expf and tanhf (no --use_fast_math).
//
// Known limits, for a later PR: the products run on the CUDA cores (a
// CUDA-core kernel tops out near 67 TFLOP/s float32, against 989 TFLOP/s
// bf16 on the tensor cores: mma.sync, then wgmma); K/V tiles are converted
// to float32 in shared memory and are not double-buffered (cp.async or
// TMA), so at D = 128 and 256 one block fills an SM.

#include "attention_tile.cuh"

#include <limits.h>
#include <type_traits>

namespace {

using attn_tile::from_f32;
using attn_tile::kBFloat16;
using attn_tile::kFloat32;
using attn_tile::kMaxSmem;

constexpr int kThreads = 256;
constexpr int kRows = 64;                // query rows per block
constexpr int kKeys = 64;                // keys per tile
constexpr int kPad = 4;                  // floats of padding per shared row
constexpr int kLoadBatch = 4;            // 16-byte loads in flight per thread
constexpr float kNegInit = -1e30f;       // running-max start, as on the TPU

struct Params {
  const void* q;          // [B, S, H, D]
  const void* k;          // [B, S, KH, D]
  const void* v;
  void* out;              // [B, S, H, D], dtype of q
  int B, S, H, KH;
  float scale;
  float softcap;          // <= 0: none
  int window;             // <= 0: none
};

template <int D>
constexpr size_t smem_floats() {
  return (size_t)(kRows + 2 * kKeys) * (D + kPad) +
         (size_t)kRows * (kKeys + kPad);
}

// 16 bytes of T as float32 into shared memory (4 floats or 8 bf16 values).
template <typename T>
__device__ __forceinline__ void store_f32(float* dst, uint4 r) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(dst) =
        make_float4(__uint_as_float(r.x), __uint_as_float(r.y),
                    __uint_as_float(r.z), __uint_as_float(r.w));
  } else {                  // bf16: the high 16 bits of a float32, exactly
    *reinterpret_cast<float4*>(dst) = make_float4(
        __uint_as_float(r.x << 16), __uint_as_float(r.x & 0xffff0000u),
        __uint_as_float(r.y << 16), __uint_as_float(r.y & 0xffff0000u));
    *reinterpret_cast<float4*>(dst + 4) = make_float4(
        __uint_as_float(r.z << 16), __uint_as_float(r.z & 0xffff0000u),
        __uint_as_float(r.w << 16), __uint_as_float(r.w & 0xffff0000u));
  }
}

// Rows row0 .. row0 + n - 1 of one head of src (row t at src + t * stride)
// into shared rows of D + kPad floats, for up to two tensors at once
// (src1 may be null); rows at or past S are zeros.  kLoadBatch 16-byte
// loads of each tensor are in flight per thread before the stores.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst0, const T* src0,
                                          float* dst1, const T* src1,
                                          size_t stride, int row0, int n,
                                          int S) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  const int total = n * kPerRow;
  for (int c0 = threadIdx.x; c0 < total; c0 += kThreads * kLoadBatch) {
    uint4 r0[kLoadBatch], r1[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int c = c0 + u * kThreads;
      const int t = c / kPerRow;
      r0[u] = make_uint4(0u, 0u, 0u, 0u);
      r1[u] = r0[u];
      if (c < total && row0 + t < S) {
        const size_t e = (size_t)(row0 + t) * stride + (c - t * kPerRow) * kVec;
        r0[u] = *reinterpret_cast<const uint4*>(src0 + e);
        if (src1 != nullptr) r1[u] = *reinterpret_cast<const uint4*>(src1 + e);
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int c = c0 + u * kThreads;
      if (c < total) {
        const int t = c / kPerRow;
        const int off = t * (D + kPad) + (c - t * kPerRow) * kVec;
        store_f32<T>(dst0 + off, r0[u]);
        if (src1 != nullptr) store_f32<T>(dst1 + off, r1[u]);
      }
    }
  }
}

// max and sum over the 16 lanes of a half warp (the threads of one row
// group)
__device__ __forceinline__ float group_max(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Params p) {
  constexpr int kStride = D + kPad;          // shared q/k/v row, floats
  constexpr int kPStride = kKeys + kPad;     // shared P row, floats
  constexpr int kVW = D >= 64 ? 4 : 2;       // output columns per vector
  constexpr int kNU = D / (16 * kVW);        // vectors per thread and row
  constexpr int kCols = kNU * kVW;           // output columns per thread

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                          // [kRows][kStride]
  float* ks = qs + kRows * kStride;          // [kKeys][kStride]
  float* vs = ks + kKeys * kStride;          // [kKeys][kStride]
  float* ps = vs + kKeys * kStride;          // [kRows][kPStride]

  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x - b * p.H;
  const int kvh = h / (p.H / p.KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heaviest first
  const int tx = threadIdx.x & 15;           // key / column group
  const int ty = threadIdx.x >> 4;           // row group: rows ty + 16 i

  const T* q = static_cast<const T*>(p.q) + ((size_t)b * p.S * p.H + h) * D;
  const T* k = static_cast<const T*>(p.k) + ((size_t)b * p.S * p.KH + kvh) * D;
  const T* v = static_cast<const T*>(p.v) + ((size_t)b * p.S * p.KH + kvh) * D;
  load_rows<T, D>(qs, q, nullptr, nullptr, (size_t)p.H * D, q0, kRows, p.S);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInit;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < kCols; ++n) acc[i][n] = 0.f;
  }

  // the walk: from the tile of the first key the window shows row q0 to the
  // tile of the block's last row (the diagonal)
  const int kt_hi = (min(q0 + kRows, p.S) - 1) / kKeys;
  const int kt_lo = p.window > 0 ? max(0, q0 - p.window + 1) / kKeys : 0;
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kKeys;
    __syncthreads();        // the previous tile's readers are done
    load_rows<T, D>(ks, k, vs, v, (size_t)p.KH * D, k0, kKeys, p.S);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * kStride + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * kStride + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += qv[i].x * kv[j].x;
          s[i][j] += qv[i].y * kv[j].y;
          s[i][j] += qv[i].z * kv[j].z;
          s[i][j] += qv[i].w * kv[j].w;
        }
    }

    // scale, softcap, mask; online softmax per row over its 16 threads
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qp = q0 + r;
      float mt = kNegInit;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool ok = kp <= qp && kp < p.S &&
                        (p.window <= 0 || kp > qp - p.window);
        float sv = s[i][j] * p.scale;
        if (p.softcap > 0.f) sv = p.softcap * tanhf(sv / p.softcap);
        s[i][j] = ok ? sv : -CUDART_INF_F;
        mt = fmaxf(mt, s[i][j]);
      }
      mt = group_max(mt);
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pr = s[i][j] == -CUDART_INF_F ? 0.f : expf(s[i][j] - m_new);
        ps[r * kPStride + tx + 16 * j] = pr;
        sum += pr;
      }
      l[i] = alpha * l[i] + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < kCols; ++n) acc[i][n] *= alpha;
    }
    __syncthreads();

    // acc += P V: row ty + 16 i, columns kVW * tx + 16 * kVW * u + e
#pragma unroll 4
    for (int c = 0; c < kKeys; ++c) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = ps[(ty + 16 * i) * kPStride + c];
      const float* vrow = vs + c * kStride + kVW * tx;
#pragma unroll
      for (int u = 0; u < kNU; ++u) {
        float vv[kVW];
        if constexpr (kVW == 4) {
          const float4 t = *reinterpret_cast<const float4*>(vrow + 16 * kVW * u);
          vv[0] = t.x; vv[1] = t.y; vv[2] = t.z; vv[3] = t.w;
        } else {
          const float2 t = *reinterpret_cast<const float2*>(vrow + 16 * kVW * u);
          vv[0] = t.x; vv[1] = t.y;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < kVW; ++e) acc[i][u * kVW + e] += pr[i] * vv[e];
      }
    }
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= p.S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    T* orow = out + ((size_t)(b * (size_t)p.S + qp) * p.H + h) * D + kVW * tx;
#pragma unroll
    for (int u = 0; u < kNU; ++u)
#pragma unroll
      for (int e = 0; e < kVW; ++e)
        orow[16 * kVW * u + e] = from_f32<T>(acc[i][u * kVW + e] / lc);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = flash_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(p.B * p.H, (p.S + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    case 256: return launch<T, 256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int KH, int D, float scale,
                                      float softcap, int window, int q_dtype,
                                      int kv_dtype, void* stream) {
  if (B <= 0 || S <= 0 || KH <= 0 || H % KH != 0 ||
      (long long)B * H > INT_MAX || (S + kRows - 1) / kRows > 65535 ||
      q_dtype != kv_dtype)
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, out, B, S, H, KH, scale, softcap, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kFloat32) return (int)launch_d<float>(p, D, s);
  if (q_dtype == kBFloat16) return (int)launch_d<__nv_bfloat16>(p, D, s);
  return (int)cudaErrorInvalidValue;
}
