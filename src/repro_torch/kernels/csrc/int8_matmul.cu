// Weight-only int8 matmul, y = (x @ w_q) * scale, for NVIDIA Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// repro_torch/kernels/int8_matmul.py.
//
// Replaces the TPU kernel src/repro/kernels/int8_matmul.py::
// int8_matmul_pallas (body _int8_kernel, wrapper
// repro/kernels/ops.py::int8_matmul).
//
// What it computes: x [M, K] float32 or bfloat16 times w_q [K, N] int8, both
// taken to the accumulator's type, summed over K, then rounded to float32,
// multiplied once by the per-column scale [1, N] float32 and cast to x's
// dtype -- the TPU kernel's order (scale after the K-reduction).  Any M, K
// and N: the ragged edges are masked here, nothing is padded.
//
// Accumulation.  bfloat16 x accumulates in float32, as the TPU kernel did.
// float32 x accumulates in float64: a float32 sum over K = 11008 (llama2-7b's
// down projection) carries rounding errors that depend on the summation
// order and exceed the JAX kernel test's 3e-5 on some outputs (chip_smoke.py
// counts them for a float32 cuBLAS product).  In float64 every product of a
// float32 and an int8 is exact and the sum's error is far below a float32
// step, so the result is the float32 product correctly rounded, whatever
// order the card sums in.
//
// Bound.  At decode shapes (M of a few rows) the call reads the int8 weight
// once, K*N bytes, and does 2*M*K*N operations: bytes-bound (llama2-7b's
// 4096 x 4096 at M = 4: 16.8 MB, 5.0 us at 3.35 TB/s).  At prefill shapes
// (M in the thousands) it is bound by operations (M = 8192: 275 GFLOP, 0.28
// ms at bf16's 989 TFLOP/s).
//
// bfloat16 x: the tensor cores, fed by a cp.async ring.
// - Every int8 value is exact in bf16 (|w_q| <= 127 needs 7 significant
//   bits, bf16 has 8) and a bf16 x bf16 product is exact in float32, so
//   mma.sync.m16n8k16 with float32 sums keeps the reference's semantics: a
//   float32 sum of exact products, in another order.
// - A block of 256 threads (8 warps) owns a BM x 128 output tile and walks
//   K in stages of 32.  BM = 16 rows for M <= 16 (each warp 16 x 16, a ring
//   of 6 stages) and 128 above (each warp 64 x 32, its 64 float32 sums in
//   registers, a ring of 3 stages).
// - The ring: each stage is the x tile (BM x 32 bf16, rows swizzled by
//   16-byte chunk so ldmatrix reads no bank twice) and the raw int8 w_q tile
//   (32 x 128 bytes, half the bytes of a bf16 weight), copied by 16-byte
//   cp.async; rows past M and K past the split are zero-filled with a
//   source size of 0, which reads nothing.  At decode the ring is what
//   matters: 5 stages of w_q in flight per block instead of one 16-byte load
//   a thread.
// - When a stage lands, each thread turns its 16 int8 bytes into bf16 in a
//   [32][128 + 8] tile, exactly and without I2F (2^23 + 128 + v built by
//   byte_perm, 2^23 + 128 subtracted, the float's high half kept); A
//   fragments come from x by ldmatrix.x4, B fragments from that tile by
//   ldmatrix.x4.trans.
// - Shapes whose rows are not 16-byte vectors (K % 8, N % 16, or a pointer
//   off 16 bytes) take the same kernel with element loads into the same
//   tiles (the kVec = false instances).
// - At decode shapes the output tiles alone give a few dozen blocks for 132
//   SMs, so K is split across blocks (grid z): each split writes its partial
//   sums to a workspace the wrapper allocates, and a second pass adds the
//   splits in a fixed order, scales and casts.  Deterministic, no atomics.
// - Left for later: wgmma on 64-row warpgroups with TMA-fed tiles and a
//   producer warp (the whole tensor-core rate; mma.sync reaches a part of
//   it), and the convert step out of the main loop's critical path.
//
// float32 x: a simple tiled kernel on the CUDA cores, summing in float64.
// - One block of 256 threads (16 x 16) owns a BM x 128 output tile, BM = 16
//   rows for M <= 16 and 64 above; each thread owns TM rows x 8 columns (two
//   groups of 4, 64 columns apart, so a quarter warp reads 128 contiguous
//   bytes of shared memory);
// - per K tile each thread issues one 16-byte load of w_q (16 int8 along N:
//   neighbouring threads read neighbouring columns of the row-major weight)
//   and at most one of x (along K), converts them to the accumulator type
//   (int8 by the exact magic-number trick, no I2F) into shared memory, and
//   loads the next tile into registers while it computes on this one;
// - warps whose rows all lie past M skip the products (M = 4 runs 2 of 8);
// - split-K as for bfloat16 x, with float64 partial sums.
// - Left for later: mma.sync.m8n8k4.f64 on the FP64 tensor cores (67
//   TFLOP/s against 34 for float64 FMAs; a float32 x int8 product is exact
//   in float64), larger tiles and a cp.async ring.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kFloat32 = 0, kBFloat16 = 1;
constexpr int kThreads = 256;   // 16 (along N) x 16 (along M)
constexpr int kBN = 128;        // output columns per block

// 16 bytes of a row, held in registers between the load and the store to
// shared memory
struct Vec16 {
  uint32_t u[4];
};

template <typename X> struct XTraits;
template <> struct XTraits<float> {
  static constexpr int kPerVec = 4;
  __device__ static uint32_t bits(const float* p) {
    return __float_as_uint(*p);
  }
  // element j of a 16-byte vector
  __device__ static float get(const Vec16& v, int j) {
    return __uint_as_float(v.u[j]);
  }
  __device__ static float store(float y) { return y; }
};
template <> struct XTraits<__nv_bfloat16> {
  __device__ static __nv_bfloat16 store(float y) {
    return __float2bfloat16_rn(y);
  }
};

// int8 value v (sign-extended in an int) to the accumulator type, exactly:
// 2^23 + 128 + v (or 2^52 + 128 + v) is built from its bits and the offset
// subtracted, two full-rate instructions instead of one I2F, which runs at
// an eighth of the FMA rate on sm_90
__device__ __forceinline__ float from_int8(int v, float) {
  return __int_as_float(0x4B000080 + v) - 8388736.0f;
}
__device__ __forceinline__ double from_int8(int v, double) {
  return __hiloint2double(0x43300000, 0x80 + v) - 4503599627370624.0;
}
__device__ __forceinline__ float mad(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double mad(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ int byte_of(const Vec16& v, int j) {
  return static_cast<int>(static_cast<int8_t>(v.u[j >> 2] >> (8 * (j & 3))));
}

// the accumulated sum to the output: rounded to float32 (the reference's
// float32 product), times the column's scale, cast to x's dtype
template <typename X, typename Acc>
__device__ __forceinline__ X finish(Acc acc, float s) {
  return XTraits<X>::store(static_cast<float>(acc) * s);
}

template <typename X, typename Acc, int TM>
struct Tiles {
  static constexpr int kBM = 16 * TM;
  static constexpr int kBK = sizeof(Acc) == 8 ? 16 : 32;
  static constexpr int kPad = 16 / sizeof(Acc);   // keeps rows 16B-aligned
  static constexpr int kVX = XTraits<X>::kPerVec;
  static constexpr int kXVecs = kBM * kBK / kVX;   // <= kThreads
  static constexpr int kWVecs = kBK * kBN / 16;    // <= kThreads
  static_assert(kXVecs <= kThreads && kWVecs <= kThreads, "one load each");
  Acc x[kBK][kBM + kPad];    // x tile, transposed: [k][m]
  Acc w[kBK][kBN + kPad];    // w tile: [k][n]
};

template <typename X, typename Acc, int TM>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const X* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, X* __restrict__ out,
                   Acc* __restrict__ part, int M, int K, int N, int k_chunk,
                   bool vec_x, bool vec_w) {
  using T = Tiles<X, Acc, TM>;
  constexpr int BM = T::kBM, BK = T::kBK, VX = T::kVX;
  __shared__ __align__(16) T sm;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * k_chunk;
  const int kend = min(K, kbeg + k_chunk);

  // this thread's 16-byte share of each tile
  const bool has_x = tid < T::kXVecs, has_w = tid < T::kWVecs;
  const int xm = tid / (BK / VX), xk = (tid % (BK / VX)) * VX;
  const int wk = tid / (kBN / 16), wn = (tid % (kBN / 16)) * 16;
  const int gm = m0 + xm, gn = n0 + wn;
  Vec16 xv{}, wv{};

  auto load = [&](int k0) {
    if (has_x) {
      const int k = k0 + xk;
      if (vec_x) {   // K % VX == 0: a vector is wholly in or out
        const uint4 r = gm < M && k < kend
            ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)gm * K + k))
            : make_uint4(0, 0, 0, 0);
        xv = Vec16{{r.x, r.y, r.z, r.w}};
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) xv.u[r] = 0;
#pragma unroll
        for (int j = 0; j < VX; ++j) {
          if (gm < M && k + j < kend) {
            const uint32_t b = XTraits<X>::bits(x + (size_t)gm * K + k + j);
            xv.u[j * 4 / VX] |= b << (VX == 4 ? 0 : 16 * (j & 1));
          }
        }
      }
    }
    if (has_w) {
      const int k = k0 + wk;
      if (vec_w) {   // N % 16 == 0: a vector is wholly in or out
        const uint4 r = k < kend && gn < N
            ? __ldcs(reinterpret_cast<const uint4*>(w + (size_t)k * N + gn))
            : make_uint4(0, 0, 0, 0);
        wv = Vec16{{r.x, r.y, r.z, r.w}};
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) wv.u[r] = 0;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (k < kend && gn + j < N) {
            const uint32_t b = static_cast<uint8_t>(w[(size_t)k * N + gn + j]);
            wv.u[j >> 2] |= b << (8 * (j & 3));
          }
        }
      }
    }
  };

  Acc acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = Acc(0);
  const bool rows_live = m0 + ty * TM < M;   // else this thread only loads

  load(kbeg);
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    if (has_x) {
#pragma unroll
      for (int j = 0; j < VX; ++j)
        sm.x[xk + j][xm] = static_cast<Acc>(XTraits<X>::get(xv, j));
    }
    if (has_w) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        sm.w[wk][wn + j] = from_int8(byte_of(wv, j), Acc());
    }
    __syncthreads();
    if (k0 + BK < kend) load(k0 + BK);   // in flight while this tile computes
    if (rows_live) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        Acc a[TM], b[8];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = sm.x[kk][ty * TM + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b[j] = sm.w[kk][tx * 4 + j];
          b[4 + j] = sm.w[kk][64 + tx * 4 + j];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = mad(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  const size_t mn = (size_t)M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n >= N) continue;
      const size_t o = (size_t)m * N + n;
      if (part != nullptr)
        part[blockIdx.z * mn + o] = acc[i][j];
      else
        out[o] = finish<X, Acc>(acc[i][j], scale[n]);
    }
  }
}

// split-K second pass: the splits' partial sums added in order 0 .. S-1
template <typename X, typename Acc>
__global__ void int8_matmul_reduce(const Acc* __restrict__ part,
                                   const float* __restrict__ scale,
                                   X* __restrict__ out, int M, int N,
                                   int splits) {
  const size_t mn = (size_t)M * N;
  for (size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x; o < mn;
       o += (size_t)gridDim.x * blockDim.x) {
    Acc s = part[o];
    for (int z = 1; z < splits; ++z) s += part[z * mn + o];
    out[o] = finish<X, Acc>(s, scale[o % N]);
  }
}

// ---------------------------------------------------------------------------
// bfloat16 x on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMmaBK = 32;     // K per ring stage: two k16 steps of the mma
constexpr int kWStride = kBN + 8;   // bf16 w tile rows, padded by 16 bytes

// The tiles each x dtype's plan assumes -- rows per block for M <= kSmallM,
// rows per block above, K per stage -- stated again in
// repro_torch/kernels/int8_matmul.py (TILES), which a test holds to these.
constexpr int kSmallM = 16;
constexpr int kF32Tiles[3] = {16, 64, 16};
constexpr int kBf16Tiles[3] = {16, 128, kMmaBK};
static_assert(Tiles<float, double, 1>::kBM == kF32Tiles[0] &&
                  Tiles<float, double, 4>::kBM == kF32Tiles[1] &&
                  Tiles<float, double, 1>::kBK == kF32Tiles[2],
              "the float32 kernel's tiles");

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

// four int8 (one word, byte i = value i) to four bf16 (two words, value 2j
// in the low half of word j), exactly: byte i + 128 becomes the float
// 2^23 + 128 + v, 2^23 + 128 is subtracted (exact), and the float's high
// half is v in bf16 (exact: |v| <= 127 needs 8 significant bits)
__device__ __forceinline__ void int8x4_to_bf16(uint32_t w, uint32_t& lo,
                                               uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) -
           8388736.0f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// BM rows per block: 16 (one m16 tile, each warp 16 x 16) or 128 (each warp
// 64 x 32); kStages stages in the ring
template <int BM>
struct MmaTiles {
  static constexpr int kStages = BM == 16 ? 6 : 3;
  static constexpr int kWM = BM == 16 ? 16 : 64;        // a warp's rows
  static constexpr int kWarpsM = BM / kWM;
  static constexpr int kWN = kBN / (kThreads / 32 / kWarpsM);  // its columns
  static constexpr int kMI = kWM / 16, kNJ = kWN / 16;  // m16 tiles, n16 pairs
  bf16 x[kStages][BM * kMmaBK];        // rows of 4 swizzled 16-byte chunks
  int8_t w[kStages][kMmaBK * kBN];     // raw rows of 128 bytes
  bf16 wb[kMmaBK][kWStride];           // the converted w tile: [k][n]
};
static_assert(sizeof(MmaTiles<16>) <= 48 * 1024 &&
                  sizeof(MmaTiles<128>) <= 48 * 1024,
              "static shared memory");

// x tile index of row r, column k: chunk k / 8 of the row XOR-ed with
// (r / 2) % 4, so the 8 rows of an ldmatrix matrix hit 8 distinct chunks of
// two 128-byte lines
__device__ __forceinline__ int x_at(int r, int k) {
  return r * kMmaBK + (((k >> 3) ^ ((r >> 1) & 3)) << 3) + (k & 7);
}

template <int BM, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
int8_matmul_mma_kernel(const bf16* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ scale, bf16* __restrict__ out,
                       float* __restrict__ part, int M, int K, int N,
                       int k_chunk) {
  using T = MmaTiles<BM>;
  constexpr int S = T::kStages;
  __shared__ __align__(128) T sm;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;          // fragment row, column pair
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * k_chunk;
  const int kend = min(K, kbeg + k_chunk);
  const int n_tiles = (kend - kbeg + kMmaBK - 1) / kMmaBK;
  const int wm0 = (warp % T::kWarpsM) * T::kWM;   // the warp's sub-tile
  const int wn0 = (warp / T::kWarpsM) * T::kWN;
  // this thread's row of the w tile and 16-byte chunk of it
  const int wr = tid >> 3, wc = (tid & 7) * 16;

  // K tile t into ring stage st: one group of copies
  auto stage = [&](int t, int st) {
    const int k0 = kbeg + t * kMmaBK;
    for (int i = tid; i < BM * 4; i += kThreads) {
      const int r = i >> 2, col = (i & 3) * 8;
      const int m = m0 + r, k = k0 + col;
      bf16* dst = &sm.x[st][x_at(r, col)];
      if constexpr (kVec) {     // K % 8 == 0: a chunk is wholly in or out
        const bool ok = m < M && k < kend;
        cp_async16(dst, ok ? x + (size_t)m * K + k : x, ok ? 16 : 0);
      } else {
        uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (m < M && k + j < kend) {
            const uint32_t b = *reinterpret_cast<const unsigned short*>(
                x + (size_t)m * K + k + j);
            v[j >> 1] |= b << (16 * (j & 1));
          }
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    const int k = k0 + wr, n = n0 + wc;
    int8_t* dst = &sm.w[st][wr * kBN + wc];
    if constexpr (kVec) {       // N % 16 == 0: a chunk is wholly in or out
      const bool ok = k < kend && n < N;
      cp_async16(dst, ok ? w + (size_t)k * N + n : w, ok ? 16 : 0);
    } else {
      uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (k < kend && n + j < N) {
          const uint32_t b = static_cast<uint8_t>(w[(size_t)k * N + n + j]);
          v[j >> 2] |= b << (8 * (j & 3));
        }
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    }
    cp_async_commit();
  };

  float acc[T::kMI][2 * T::kNJ][4];
#pragma unroll
  for (int i = 0; i < T::kMI; ++i)
#pragma unroll
    for (int j = 0; j < 2 * T::kNJ; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  const bool rows_live = m0 + wm0 < M;   // else this warp only loads

#pragma unroll
  for (int t = 0; t < S - 1; ++t) {
    if (t < n_tiles) stage(t, t);
    else cp_async_commit();             // keep one group per tile
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % S;
    cp_async_wait<S - 2>();
    __syncthreads();   // tile t landed for every thread; tile t - 1 is done
    if (t + S - 1 < n_tiles) stage(t + S - 1, (t + S - 1) % S);
    else cp_async_commit();

    // this thread's 16 bytes of w_q to bf16
    {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          &sm.w[st][wr * kBN + wc]);
      uint32_t b[8];
      int8x4_to_bf16(raw.x, b[0], b[1]);
      int8x4_to_bf16(raw.y, b[2], b[3]);
      int8x4_to_bf16(raw.z, b[4], b[5]);
      int8x4_to_bf16(raw.w, b[6], b[7]);
      uint4* dst = reinterpret_cast<uint4*>(&sm.wb[wr][wc]);
      dst[0] = make_uint4(b[0], b[1], b[2], b[3]);
      dst[1] = make_uint4(b[4], b[5], b[6], b[7]);
    }
    __syncthreads();   // the bf16 tile is whole
    if (!rows_live) continue;

    const bf16* xs = sm.x[st];
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      uint32_t a[T::kMI][4], b[T::kNJ][4];
#pragma unroll
      for (int i = 0; i < T::kMI; ++i)
        ldsm_x4(a[i], xs + x_at(wm0 + 16 * i + (lane & 15),
                                16 * kk + (lane >> 4) * 8));
#pragma unroll
      for (int j = 0; j < T::kNJ; ++j)
        ldsm_x4_trans(b[j], &sm.wb[16 * kk + (lane & 15)]
                                  [wn0 + 16 * j + (lane >> 4) * 8]);
#pragma unroll
      for (int i = 0; i < T::kMI; ++i)
#pragma unroll
        for (int j = 0; j < T::kNJ; ++j) {
          mma_bf16(acc[i][2 * j], a[i], b[j][0], b[j][1]);
          mma_bf16(acc[i][2 * j + 1], a[i], b[j][2], b[j][3]);
        }
    }
  }
  cp_async_wait<0>();

  // the sums of rows g and g + 8, columns 2c and 2c + 1 of each n8 tile:
  // the partial sums, or times the scale and cast (the reference's order)
  const size_t mn = (size_t)M * N;
  const bool pairs = N % 2 == 0;   // then a column pair is 8-byte aligned
#pragma unroll
  for (int i = 0; i < T::kMI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm0 + 16 * i + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 2 * T::kNJ; ++j) {
        const int n = n0 + wn0 + 8 * j + 2 * c;
        if (n >= N) continue;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        const size_t o = (size_t)m * N + n;
        if (part != nullptr) {
          float* dst = part + blockIdx.z * mn + o;
          if (pairs) {
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            dst[0] = v0;
            if (n + 1 < N) dst[1] = v1;
          }
        } else if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(out + o) =
              __floats2bfloat162_rn(v0 * scale[n], v1 * scale[n + 1]);
        } else {
          out[o] = __float2bfloat16_rn(v0 * scale[n]);
          if (n + 1 < N) out[o + 1] = __float2bfloat16_rn(v1 * scale[n + 1]);
        }
      }
    }
}

// K split over at most ``splits`` blocks of k_chunk (a whole number of BK
// tiles); ``main(grid, k_chunk, part)`` launches the main kernel, then a
// second pass adds the splits that remain non-empty, if more than one
template <typename X, typename Acc, typename Main>
cudaError_t launch_split(Main main, int BM, int BK, const void* scale,
                         void* out, void* part, int M, int K, int N,
                         int splits, cudaStream_t stream) {
  int k_chunk = (K + splits - 1) / splits;
  k_chunk = (k_chunk + BK - 1) / BK * BK;
  const int used = (K + k_chunk - 1) / k_chunk;
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, used);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  Acc* p = used > 1 ? static_cast<Acc*>(part) : nullptr;
  if (used > 1 && p == nullptr) return cudaErrorInvalidValue;
  main(grid, k_chunk, p);
  if (used > 1) {
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const size_t mn = (size_t)M * N;
    const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256
                                                      : 4096);
    int8_matmul_reduce<X, Acc><<<blocks, 256, 0, stream>>>(
        p, static_cast<const float*>(scale), static_cast<X*>(out), M, N,
        used);
  }
  return cudaGetLastError();
}

template <int TM>
cudaError_t launch_f32(const void* x, const void* w, const void* scale,
                       void* out, void* part, int M, int K, int N, int splits,
                       cudaStream_t stream) {
  using T = Tiles<float, double, TM>;
  const bool vec_x = K % T::kVX == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_w = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  return launch_split<float, double>(
      [&](dim3 grid, int k_chunk, double* p) {
        int8_matmul_kernel<float, double, TM><<<grid, kThreads, 0, stream>>>(
            static_cast<const float*>(x), static_cast<const int8_t*>(w),
            static_cast<const float*>(scale), static_cast<float*>(out), p, M,
            K, N, k_chunk, vec_x, vec_w);
      },
      T::kBM, T::kBK, scale, out, part, M, K, N, splits, stream);
}

template <int BM, bool kVec>
cudaError_t launch_bf16(const void* x, const void* w, const void* scale,
                        void* out, void* part, int M, int K, int N,
                        int splits, cudaStream_t stream) {
  return launch_split<bf16, float>(
      [&](dim3 grid, int k_chunk, float* p) {
        int8_matmul_mma_kernel<BM, kVec><<<grid, kThreads, 0, stream>>>(
            static_cast<const bf16*>(x), static_cast<const int8_t*>(w),
            static_cast<const float*>(scale), static_cast<bf16*>(out), p, M,
            K, N, k_chunk);
      },
      BM, kMmaBK, scale, out, part, M, K, N, splits, stream);
}

template <int BM>
cudaError_t launch_bf16_rows(const void* x, const void* w, const void* scale,
                             void* out, void* part, int M, int K, int N,
                             int splits, cudaStream_t s) {
  const bool vec = K % 8 == 0 && N % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  return vec ? launch_bf16<BM, true>(x, w, scale, out, part, M, K, N, splits,
                                     s)
             : launch_bf16<BM, false>(x, w, scale, out, part, M, K, N,
                                      splits, s);
}

}  // namespace

// x [M, K] (x_dtype: 0 float32, 1 bfloat16), w_q [K, N] int8, scale [N]
// float32 -> out [M, N] in x's dtype.  K is split over at most ``splits``
// blocks, as int8_matmul.py's tile_plan computes; where more than one split
// is non-empty, ``part`` is a workspace of that many M * N accumulators
// (float64 for float32 x, float32 for bfloat16 x).
extern "C" int int8_matmul_launch(const void* x, const void* w_q,
                                  const void* scale, void* out, void* part,
                                  int M, int K, int N, int splits,
                                  int x_dtype, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  const bool small = M <= kSmallM;
  if (x_dtype == kFloat32)
    e = small ? launch_f32<1>(x, w_q, scale, out, part, M, K, N, splits, s)
              : launch_f32<4>(x, w_q, scale, out, part, M, K, N, splits, s);
  else if (x_dtype == kBFloat16)
    e = small ? launch_bf16_rows<kBf16Tiles[0]>(x, w_q, scale, out, part, M,
                                                K, N, splits, s)
              : launch_bf16_rows<kBf16Tiles[1]>(x, w_q, scale, out, part, M,
                                                K, N, splits, s);
  return (int)e;
}
