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
// is ~1000 flops per byte, far above the card's ~300.
//
// The walk, both dtypes: one thread block per (batch, head, tile of kRows
// query rows), the heavy tiles near the diagonal launched first.  The block
// walks key tiles of kKeys from the tile of the first key the window shows
// its first row, (q0 - window + 1) / kKeys, to the tile of its last real row,
// (min(q0 + kRows, S) - 1) / kKeys, so whole tiles are skipped exactly where
// the TPU kernel skips them (entirely above the diagonal, or entirely older
// than the window): both ends of the walk are computed, not tested tile by
// tile.  A tile is fully visible to every real row of the block when
// k0 + kKeys - 1 <= q0 and, with a window, k0 >= q_hi - window + 1 (q_hi the
// last real row); tile_plan() in flash_attention.py uses the same formulas.
//
// bfloat16: the tensor cores, FlashAttention-2's structure.  Q, K and V
// tiles stay bf16 in shared memory, rows padded by 16 bytes so that the
// eight row addresses of an ldmatrix fall in distinct banks.  Each warp owns
// 16 query rows: 8 warps, 128 rows a block and tiles of 64 keys at D <= 128;
// 4 warps, 64 rows and tiles of 32 keys at D = 256, where the float32 output
// fragment alone is 128 registers a thread.  Two blocks share an SM (at
// D <= 128 that caps a thread at 128 registers).  K/V tiles arrive by
// 16-byte cp.async, rows past S zero-filled, in a ring of two stages: tile
// t + 1 loads while tile t runs its products.  S = Q K^T runs on
// mma.sync.m16n8k16 (bf16 in, float32 sums): A fragments from Q and B
// fragments from K, both row-major, by ldmatrix.  Products of bf16 values
// are exact in float32, so only the order of the sum differs from the plain
// version.  Scale, softcap and the online softmax act on the accumulator
// fragment in registers: a row lives in the four lanes of a quad, so its max
// and sum take two shuffles.  Only a tile that is not fully visible takes a
// per-element mask, and a warp skips a tile that none of its rows sees (bit
// for bit the same: such a tile adds p = 0 and rescales by exp(0) = 1).
// O += P V reuses the accumulator fragment of S as the A fragment of the
// next product, with B fragments from V by ldmatrix.trans; P never leaves
// registers.  P enters that product as kPParts = 3 bf16 terms, p_0 =
// bf16(p) and each next one bf16 of what the terms before it missed, all
// into the same float32 accumulator, so P V stays a float32 product to about
// 2^-27 of p.  With a single bf16 P (2^-9 of p) many outputs land more
// than a bf16 step from the exact result, and with two terms (2^-18) still
// a few near zero, where a row's few keys cancel (PERF.md); three cost
// twice the tensor-core issue of one.  l sums the float32 p.
//
// float32: the CUDA cores, unchanged since the kernel was first ported.
// 256 threads a block of 64 query rows, key tiles of 64; the block keeps its
// query tile in shared memory; every element of a tile is masked.  Each
// thread owns a 4 x 4 block of scores (rows ty + 16i, keys tx + 16j) and a
// 4 x D/16 block of the output, all in registers; P goes through shared
// memory to the P V product.  Shared rows are padded by 4 floats, so the
// 16-byte reads of a warp spread over all banks.  TF32 would miss the
// float32 tolerance.  Both dtypes use the accurate expf and tanhf (no
// --use_fast_math).
//
// Known limits, for a later PR: mma.sync reaches only part of the tensor
// cores' rate on Hopper, and each warp reads the whole K and V tile from
// shared memory for its 16 rows (wgmma, fed by TMA, with warpgroups of 64
// rows, reaches the rest); the query heads of one GQA/MQA group each load
// the same K/V tiles; the float32 instances run on the CUDA cores (a
// CUDA-core kernel tops out near 67 TFLOP/s float32).

#include "attention_tile.cuh"

#include <limits.h>
#include <stdint.h>
#include <type_traits>

namespace {

using attn_tile::kBFloat16;
using attn_tile::kFloat32;
using attn_tile::kMaxSmem;
using bf16 = __nv_bfloat16;

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

// The block of each instance: threads, query rows, keys per tile, padded
// shared row and shared bytes.
template <typename T, int D>
struct Shape;

template <int D>
struct Shape<float, D> {
  static constexpr int kThreads = 256;
  static constexpr int kRows = 64;
  static constexpr int kKeys = 64;
  static constexpr int kPad = 4;         // floats of padding per shared row
  static constexpr int kStride = D + kPad;
  static constexpr int kPStride = kKeys + kPad;
  static constexpr size_t kSmem =
      ((size_t)(kRows + 2 * kKeys) * kStride + (size_t)kRows * kPStride) *
      sizeof(float);
};

template <int D>
struct Shape<bf16, D> {
  static constexpr int kWarps = D <= 128 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  // two blocks an SM: at D <= 128 that caps a thread at 128 registers
  static constexpr int kMinBlocks = 2;
  static constexpr int kRows = 16 * kWarps;
  static constexpr int kKeys = D <= 128 ? 64 : 32;
  static constexpr int kStride = D + 8;  // bf16 per shared row: 16 bytes pad
  // q, then two stages of a K tile and a V tile
  static constexpr size_t kSmem =
      (size_t)(kRows + 4 * kKeys) * kStride * sizeof(bf16);
};

// ---------------------------------------------------------------------------
// float32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kLoadBatch = 4;            // 16-byte loads in flight per thread

__device__ __forceinline__ void store_f32(float* dst, uint4 r) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(__uint_as_float(r.x), __uint_as_float(r.y),
                  __uint_as_float(r.z), __uint_as_float(r.w));
}

// Rows row0 .. row0 + n - 1 of one head of src (row t at src + t * stride)
// into shared rows of D + kPad floats, for up to two tensors at once
// (src1 may be null); rows at or past S are zeros.  kLoadBatch 16-byte
// loads of each tensor are in flight per thread before the stores.
template <int D>
__device__ __forceinline__ void load_rows(float* dst0, const float* src0,
                                          float* dst1, const float* src1,
                                          size_t stride, int row0, int n,
                                          int S) {
  using Sh = Shape<float, D>;
  constexpr int kVec = 4;
  constexpr int kPerRow = D / kVec;
  const int total = n * kPerRow;
  for (int c0 = threadIdx.x; c0 < total; c0 += Sh::kThreads * kLoadBatch) {
    uint4 r0[kLoadBatch], r1[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int c = c0 + u * Sh::kThreads;
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
      const int c = c0 + u * Sh::kThreads;
      if (c < total) {
        const int t = c / kPerRow;
        const int off = t * Sh::kStride + (c - t * kPerRow) * kVec;
        store_f32(dst0 + off, r0[u]);
        if (src1 != nullptr) store_f32(dst1 + off, r1[u]);
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

template <typename T, int D,
          std::enable_if_t<std::is_same<T, float>::value, int> = 0>
__global__ void __launch_bounds__(Shape<float, D>::kThreads)
flash_attention_kernel(const Params p) {
  using Sh = Shape<float, D>;
  constexpr int kRows = Sh::kRows, kKeys = Sh::kKeys;
  constexpr int kStride = Sh::kStride;       // shared q/k/v row, floats
  constexpr int kPStride = Sh::kPStride;     // shared P row, floats
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

  const float* q = static_cast<const float*>(p.q) + ((size_t)b * p.S * p.H + h) * D;
  const float* k = static_cast<const float*>(p.k) + ((size_t)b * p.S * p.KH + kvh) * D;
  const float* v = static_cast<const float*>(p.v) + ((size_t)b * p.S * p.KH + kvh) * D;
  load_rows<D>(qs, q, nullptr, nullptr, (size_t)p.H * D, q0, kRows, p.S);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInit;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < kCols; ++n) acc[i][n] = 0.f;
  }

  const int kt_hi = (min(q0 + kRows, p.S) - 1) / kKeys;
  const int kt_lo = p.window > 0 ? max(0, q0 - p.window + 1) / kKeys : 0;
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kKeys;
    __syncthreads();        // the previous tile's readers are done
    load_rows<D>(ks, k, vs, v, (size_t)p.KH * D, k0, kKeys, p.S);
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

  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= p.S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    float* orow = out + ((size_t)(b * (size_t)p.S + qp) * p.H + h) * D + kVW * tx;
#pragma unroll
    for (int u = 0; u < kNU; ++u)
#pragma unroll
      for (int e = 0; e < kVW; ++e)
        orow[16 * kVW * u + e] = acc[i][u * kVW + e] / lc;
  }
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores
// ---------------------------------------------------------------------------

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

// wait until at most N groups of this thread's copies are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows row0 .. row0 + N - 1 of one head (row t at src + t * stride) into
// shared rows of D + 8 bf16, 16 bytes a cp.async; rows at or past S are
// zero-filled, so no NaN of unwritten memory reaches a product.
template <int D, int N, int kThreads>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           size_t stride, int row0, int S) {
  constexpr int kPerRow = D / 8;
  static_assert(N * kPerRow % kThreads == 0, "whole 16-byte loads a thread");
#pragma unroll
  for (int u = 0; u < N * kPerRow / kThreads; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int t = i / kPerRow, col = (i - t * kPerRow) * 8;
    const bool ok = row0 + t < S;
    cp_async16(dst + t * (D + 8) + col,
               src + (ok ? (size_t)(row0 + t) * stride + col : 0),
               ok ? 16 : 0);
  }
}

// four 8 x 8 matrices of b16 from shared memory: lanes 8i .. 8i + 7 give the
// row addresses of matrix i, and register i holds each lane's two values of
// it (transposed with .trans)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a b on the tensor cores: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col),
// c 16 x 8 float32.  Lane l holds c[l / 4 + 8 (i / 2)][2 (l % 4) + i % 2].
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// P enters P V as the sum of kPParts bf16 terms: p_0 = bf16(p), then each
// p_i = bf16 of what the terms before it missed
constexpr int kPParts = 3;

// (x, y) as kPParts bf16 pairs, one register each
__device__ __forceinline__ void split_bf16(float x, float y,
                                           uint32_t (&part)[kPParts][4],
                                           int at) {
#pragma unroll
  for (int i = 0; i < kPParts; ++i) {
    const __nv_bfloat162 t = __floats2bfloat162_rn(x, y);
    part[i][at] = *reinterpret_cast<const uint32_t*>(&t);
    x -= __low2float(t);
    y -= __high2float(t);
  }
}

template <int D>
__device__ __forceinline__ void attend_mma(const Params& p, bf16* smem) {
  using Sh = Shape<bf16, D>;
  constexpr int kR = Sh::kRows, kK = Sh::kKeys, kS = Sh::kStride;
  bf16* qs = smem;                           // [kR][kS]
  bf16* kvs = qs + kR * kS;                  // stage i: K, V [kK][kS] each

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;     // fragment row, column pair
  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x - b * p.H;
  const int kvh = h / (p.H / p.KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kR;     // heaviest first
  const int q_hi = min(q0 + kR, p.S) - 1;    // the block's last real row
  const int qw = q0 + 16 * warp;             // the warp's first row

  const bf16* q = static_cast<const bf16*>(p.q) + ((size_t)b * p.S * p.H + h) * D;
  const bf16* k = static_cast<const bf16*>(p.k) + ((size_t)b * p.S * p.KH + kvh) * D;
  const bf16* v = static_cast<const bf16*>(p.v) + ((size_t)b * p.S * p.KH + kvh) * D;
  const size_t kv_stride = (size_t)p.KH * D;
  // K/V tile kt into stage st: one group of cp.async per tile
  auto stage_kv = [&](int kt, int st) {
    bf16* ks = kvs + 2 * st * kK * kS;
    stage_rows<D, kK, Sh::kThreads>(ks, k, kv_stride, kt * kK, p.S);
    stage_rows<D, kK, Sh::kThreads>(ks + kK * kS, v, kv_stride, kt * kK,
                                    p.S);
    cp_async_commit();
  };
  stage_rows<D, kR, Sh::kThreads>(qs, q, (size_t)p.H * D, q0, p.S);

  // the output fragment: d tile n (columns 8n .. 8n + 7) of rows g, g + 8
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInit, kNegInit}, l[2] = {0.f, 0.f};

  const int kt_hi = q_hi / kK;
  const int kt_lo = p.window > 0 ? max(0, q0 - p.window + 1) / kK : 0;
  stage_kv(kt_lo, 0);       // with q, the first group
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kK;
    const int st = (kt - kt_lo) & 1;
    __syncthreads();        // the readers of stage st ^ 1 (tile kt - 1) are done
    if (kt < kt_hi) {       // tile kt + 1 loads while tile kt runs
      stage_kv(kt + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();        // tile kt has landed for every thread
    const bf16* ks = kvs + 2 * st * kK * kS;
    const bf16* vs = ks + kK * kS;

    const bool masked = !(k0 + kK - 1 <= q0 &&
                          (p.window <= 0 || k0 >= q_hi - p.window + 1));
    const bool seen = qw < p.S && k0 <= qw + 15 &&
                      (p.window <= 0 || k0 + kK - 1 > qw - p.window);
    if (!seen) continue;

    // S = Q K^T: n8 tile j holds keys k0 + 8j .. k0 + 8j + 7
    float s[kK / 8][4];
#pragma unroll
    for (int j = 0; j < kK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, qs + (16 * warp + (lane & 15)) * kS + 16 * kk + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < kK / 16; ++jp) {
        uint32_t bk[4];
        ldsm_x4(bk, ks + (16 * jp + (lane & 7) + (lane >> 4) * 8) * kS +
                        16 * kk + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jp], a, bk[0], bk[1]);
        mma_bf16(s[2 * jp + 1], a, bk[2], bk[3]);
      }
    }

    // scale, softcap, the mask where the tile needs one; online softmax of
    // rows g (r = 0) and g + 8 (r = 1) over the quad's four lanes
    float mt[2] = {kNegInit, kNegInit};
#pragma unroll
    for (int j = 0; j < kK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sv = s[j][e] * p.scale;
        if (p.softcap > 0.f) sv = p.softcap * tanhf(sv / p.softcap);
        if (masked) {
          const int kp = k0 + 8 * j + 2 * c + (e & 1);
          const int qp = qw + g + 8 * (e >> 1);
          const bool ok = kp <= qp && kp < p.S &&
                          (p.window <= 0 || kp > qp - p.window);
          sv = ok ? sv : -CUDART_INF_F;
        }
        s[j][e] = sv;
        mt[e >> 1] = fmaxf(mt[e >> 1], sv);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m[r], mt[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {     // a masked score gives expf(-inf) = 0
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = alpha[r] * l[r] + sum[r];
    }
    // once a row's max has settled, alpha is 1 and the rescale a no-op
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
    }

    // O += P V: n8 tiles 2kk and 2kk + 1 of P are the A fragment of keys
    // k0 + 16kk .. k0 + 16kk + 15, in kPParts bf16 parts
#pragma unroll
    for (int kk = 0; kk < kK / 16; ++kk) {
      uint32_t pa[kPParts][4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], pa, 0);
      split_bf16(s[2 * kk][2], s[2 * kk][3], pa, 1);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], pa, 2);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], pa, 3);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, vs + (16 * kk + (lane & 15)) * kS + 16 * dp +
                              (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < kPParts; ++i) {
          mma_bf16(o[2 * dp], pa[i], bv[0], bv[1]);
          mma_bf16(o[2 * dp + 1], pa[i], bv[2], bv[3]);
        }
      }
    }
  }

  bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = qw + g + 8 * r;
    if (qp >= p.S) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    bf16* orow = out + ((size_t)(b * (size_t)p.S + qp) * p.H + h) * D + 2 * c;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
          __floats2bfloat162_rn(o[n][2 * r] / lc, o[n][2 * r + 1] / lc);
  }
}

template <typename T, int D,
          std::enable_if_t<std::is_same<T, bf16>::value, int> = 0>
__global__ void __launch_bounds__(Shape<bf16, D>::kThreads,
                                  Shape<bf16, D>::kMinBlocks)
flash_attention_kernel(const Params p) {
  extern __shared__ __align__(16) bf16 smem_bf16[];
  attend_mma<D>(p, smem_bf16);
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using Sh = Shape<T, D>;
  const size_t smem = Sh::kSmem;
  if (smem > kMaxSmem || (p.S + Sh::kRows - 1) / Sh::kRows > 65535)
    return cudaErrorInvalidValue;
  void (*kernel)(Params) = flash_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(p.B * p.H, (p.S + Sh::kRows - 1) / Sh::kRows);
  kernel<<<grid, Sh::kThreads, smem, stream>>>(p);
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
      (long long)B * H > INT_MAX || q_dtype != kv_dtype)
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, out, B, S, H, KH, scale, softcap, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kFloat32) return (int)launch_d<float>(p, D, s);
  if (q_dtype == kBFloat16) return (int)launch_d<bf16>(p, D, s);
  return (int)cudaErrorInvalidValue;
}
