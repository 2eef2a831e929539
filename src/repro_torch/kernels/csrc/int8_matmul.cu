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
// once, K*N bytes, and does 2*M*K*N operations: bytes-bound.  At prefill
// shapes (M in the thousands) it is bound by operations.  Design, a simple
// tiled kernel on the CUDA cores:
// - one block of 256 threads (16 x 16) owns a BM x 128 output tile, BM = 16
//   rows for M <= 16 and 64 above; each thread owns TM rows x 8 columns (two
//   groups of 4, 64 columns apart, so a quarter warp reads 128 contiguous
//   bytes of shared memory);
// - per K tile each thread issues one 16-byte load of w_q (16 int8 along N:
//   neighbouring threads read neighbouring columns of the row-major weight)
//   and at most one of x (along K), converts them to the accumulator type
//   (int8 by the exact magic-number trick, no I2F) into shared memory, and
//   loads the next tile into registers while it computes on this one;
// - warps whose rows all lie past M skip the products (M = 4 runs 2 of 8);
// - at decode shapes a plain tiling gives a few dozen blocks for 132 SMs, so
//   K is split across blocks (grid z): each split writes its partial sums to
//   a workspace the wrapper allocates, and a second pass adds the splits in
//   a fixed order, rounds, scales and casts.  Deterministic, no atomics.
//
// Known limits, for a later PR: the tensor cores are not used.  bf16 x times
// int8 is exact in a float32 accumulator (|w_q| <= 127 fits bf16's 8-bit
// mantissa exactly), so mma.sync / wgmma with float32 accumulation keep these
// semantics for bfloat16 x; float32 x stays here.  Loads are not pipelined
// beyond one tile in registers (no cp.async / TMA).

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
  static constexpr int kPerVec = 8;
  __device__ static uint32_t bits(const __nv_bfloat16* p) {
    return *reinterpret_cast<const unsigned short*>(p);
  }
  __device__ static float get(const Vec16& v, int j) {   // bf16 -> f32: exact
    const uint32_t w = v.u[j >> 1];
    return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
  }
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

template <typename X, typename Acc, int TM>
cudaError_t launch(const void* x, const void* w, const void* scale, void* out,
                   void* part, int M, int K, int N, int splits,
                   cudaStream_t stream) {
  using T = Tiles<X, Acc, TM>;
  // K per split, a whole number of tiles; the splits that remain non-empty
  int k_chunk = (K + splits - 1) / splits;
  k_chunk = (k_chunk + T::kBK - 1) / T::kBK * T::kBK;
  const int used = (K + k_chunk - 1) / k_chunk;
  const dim3 grid((N + kBN - 1) / kBN, (M + T::kBM - 1) / T::kBM, used);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  const bool vec_x = K % T::kVX == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_w = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  Acc* p = used > 1 ? static_cast<Acc*>(part) : nullptr;
  if (used > 1 && p == nullptr) return cudaErrorInvalidValue;
  int8_matmul_kernel<X, Acc, TM><<<grid, kThreads, 0, stream>>>(
      static_cast<const X*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<X*>(out), p, M, K, N,
      k_chunk, vec_x, vec_w);
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

template <typename X, typename Acc>
cudaError_t launch_rows(const void* x, const void* w, const void* scale,
                        void* out, void* part, int M, int K, int N,
                        int splits, cudaStream_t s) {
  return M <= 16 ? launch<X, Acc, 1>(x, w, scale, out, part, M, K, N, splits,
                                     s)
                 : launch<X, Acc, 4>(x, w, scale, out, part, M, K, N, splits,
                                     s);
}

}  // namespace

// x [M, K] (x_dtype: 0 float32, 1 bfloat16), w_q [K, N] int8, scale [N]
// float32 -> out [M, N] in x's dtype.  K is split over at most ``splits``
// blocks; with more than one, ``part`` is a workspace of splits * M * N
// accumulators (float64 for float32 x, float32 for bfloat16 x).
extern "C" int int8_matmul_launch(const void* x, const void* w_q,
                                  const void* scale, void* out, void* part,
                                  int M, int K, int N, int splits,
                                  int x_dtype, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (x_dtype == kFloat32)
    e = launch_rows<float, double>(x, w_q, scale, out, part, M, K, N, splits,
                                   s);
  else if (x_dtype == kBFloat16)
    e = launch_rows<__nv_bfloat16, float>(x, w_q, scale, out, part, M, K, N,
                                          splits, s);
  return (int)e;
}
