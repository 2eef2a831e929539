// GQA attention for one decode step over contiguous ring caches, for NVIDIA
// Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// repro_torch/kernels/decode_attention.py.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention_bhd (body _decode_kernel, wrapper
// repro/kernels/ops.py::decode_attention).
//
// What it computes, for slot b, kv head j and the g = H/KH query heads
// j*g .. j*g+g-1 of its GQA group:
//   s_c = (q . k_c) / sqrt(D), optionally softcap * tanh(s_c / softcap),
// over the slot's ring k[b, c, j, :], c < C, attending key c when
// key_pos[c] >= 0, key_pos[c] <= pos and, with a window,
// key_pos[c] > pos - window.  key_pos is [C] shared by the slots or [B, C]
// per slot; pos is one scalar or [B].  Softmax is online, in float32; the
// output is acc / max(l, 1e-30), so a row with no valid key gives exact
// zeros.  The TPU wrapper built a [B, C] bool mask in XLA and padded C to
// block_c = 512; here the mask costs one int read per key and C is any
// length (a windowed ring is min(max_len, window) long).
//
// Bound: device memory.  The kernel must read every valid key and value
// once, bytes = sum over slots of valid keys * KH * D * 2 * itemsize, and
// does only ~4*D flops per key and query head.  The card reads at its rate
// only with many loads in flight on every SM, so the design is about
// parallelism and about keeping each SM's instructions (shared-memory
// reads above all) below its share of the memory rate.
//
// Design (flash-decoding).  The grid is (KH, B, S * chunks): the ring is
// split into S splits of L keys, L a multiple of the 64-key tile, and each
// block walks the tiles of one split, [s*L, min((s+1)*L, C)), for at most
// kRowsPerBlock query rows of one GQA group (chunks = ceil(g / 16); every
// model in the repo has g <= 10, one chunk).  Inside a split a block reads
// the tile's key_pos first and loads the K/V rows of valid keys only; a
// tile with no valid key is skipped whole.  That is exact, and it matters:
// the ring is allocated at max_len and is mostly empty early in a request.
// Validity is not monotonic in the ring index (a wrapped window ring holds
// positions out of order), so the walk never stops early.  A split with no
// valid key reads no K/V row and leaves m = -1e30, l = 0, acc = 0.
//   A tile's K/V rows go to shared memory with cp.async, the whole tile in
// flight at once, a masked row zero-filled without being read.  Where a
// split has more than one tile, two stages alternate: tile t+1 loads while
// tile t is attended.  Each tile serves the whole GQA group from shared
// memory (rows padded by 16 bytes, so the per-key row reads are free of
// bank conflicts): each cache row is read from device memory once per
// step.  Scores: each thread owns one key and some of the rows and forms
// the whole dot product itself, q broadcast from shared memory -- no warp
// reduction per key and row.  Softmax: one warp per row, two reductions
// per row and tile.  P V: each thread owns a pair of head elements of some
// rows and keeps acc in registers; each V element is read from shared
// memory once per tile by each thread that owns it and serves all of that
// thread's rows.  The row loops are unrolled to a compile-time row count
// (kRows); blocks of more than 2 rows run 8 warps, of more than 8 rows 16,
// so that the group's arithmetic is spread over more threads.
//   With S > 1 each split writes its unnormalised (m, l, acc) to a float32
// workspace ([B, H, S, 2] and [B, H, S, D], allocated by the wrapper) and
// decode_attention_merge_kernel, one block per query head, combines the S
// partials in index order: M = max m_s, l = sum exp(m_s - M) l_s,
// acc = sum exp(m_s - M) acc_s, out = acc / max(l, 1e-30).  No atomics, so
// the same inputs give the same bits on every call; a row with no valid key
// keeps M = -1e30 and l = 0 and comes out as exact zeros.  With S = 1 the
// split writes the output itself and nothing is merged.
//
// The split count (repro_torch/kernels/decode_attention.py::split_plan)
// depends on shapes only -- B*KH*chunks, C and the SM count -- never on pos
// or key_pos, so a call needs no host sync and can be captured in a CUDA
// graph: S aims at four blocks per SM and at splits of at most 256 keys,
// and is at most 64 splits and one per tile; S = 1 when B*KH already
// fills the card four times over and C <= 256.
//
// Left for later: products on the tensor cores (mma.sync / wgmma), where
// large GQA groups (recurrentgemma-2b's 10 rows at D = 256) leave the
// score and P V stages bound by shared-memory reads and not by device
// memory.

#include "attention_tile.cuh"

namespace {

using attn_tile::block_threads;
using attn_tile::cp_async16;
using attn_tile::cp_async_commit;
using attn_tile::cp_async_wait_all;
using attn_tile::from_f32;
using attn_tile::kBFloat16;
using attn_tile::kFloat32;
using attn_tile::kMaxSplits;
using attn_tile::kNegInit;
using attn_tile::kPairs;
using attn_tile::kRowsPerBlock;
using attn_tile::kThreads;
using attn_tile::kTileKeys;
using attn_tile::launch_with_smem;
using attn_tile::load_pair;
using attn_tile::row_stride;
using attn_tile::to_f32;
using attn_tile::unpack;
using attn_tile::warp_max;
using attn_tile::warp_sum;

struct Params {
  const void* q;          // [B, H, D]
  const void* k;          // [B, C, KH, D]
  const void* v;
  const int* key_pos;     // [C] (kp_stride 0) or [B, C] (kp_stride C)
  const int* pos;         // [1] (pos_stride 0) or [B] (pos_stride 1)
  void* out;              // [B, H, D], dtype of q
  float* part_ml;         // [B, H, S, 2]: m, l of each split (S > 1)
  float* part_acc;        // [B, H, S, D]: acc of each split (S > 1)
  int B, H, KH, D, C, kp_stride, pos_stride;
  int S, L;               // splits, keys per split
  int rows;               // query rows per block, min(g, kRowsPerBlock)
  int stages;             // K/V tile buffers: 2 overlap loads with compute
  float scale;
  float softcap;          // <= 0: none
  int window;             // <= 0: none
};

// shared memory of a block: `stages` K/V tile pairs, then q, the scores,
// m, l, alpha, two tiles' key positions and two tiles' any-valid flags
template <typename TKV>
size_t smem_bytes(int stages, int rows, int D) {
  const size_t kv = (size_t)stages * 2 * kTileKeys * row_stride<TKV>(D) *
                    sizeof(TKV);
  return kv + ((size_t)rows * D + (size_t)rows * kTileKeys + 3 * rows) * 4 +
         (2 * kTileKeys + 4) * 4;
}

// kRows: the most query rows a block serves, a compile-time bound, so that
// the per-thread row loops unroll into registers.  Rows past the block's
// own are predicated off but still cost instructions, so launch() picks
// the least of 1, 2, 4, 8, 10 (recurrentgemma-2b's group) and 16 that
// covers it.
template <typename TQ, typename TKV, int kRows>
__global__ void __launch_bounds__(block_threads<kRows>())
decode_attention_kernel(const Params p) {
  constexpr int kVec = 16 / sizeof(TKV);    // elements per 16 bytes
  constexpr int kBlock = block_threads<kRows>();
  constexpr int kScoreGroups = kBlock / kTileKeys;
  constexpr int kScoreRows = (kRows + kScoreGroups - 1) / kScoreGroups;
  constexpr int kPVGroups = kBlock / kPairs;
  constexpr int kPVRows = (kRows + kPVGroups - 1) / kPVGroups;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int j = blockIdx.x;                 // kv head
  const int b = blockIdx.y;                 // slot
  const int split = blockIdx.z % p.S;
  const int r0 = blockIdx.z / p.S * kRowsPerBlock;
  const int D = p.D, DS = row_stride<TKV>(D);
  const int g = p.H / p.KH;
  const int R = min(kRowsPerBlock, g - r0);  // this block's query rows
  const int h0 = j * g + r0;                 // its first query head
  const size_t tile_elems = (size_t)kTileKeys * DS;

  extern __shared__ __align__(16) unsigned char smem[];
  TKV* kv = reinterpret_cast<TKV*>(smem);   // [stages][K, V][KT][DS]
  float* qs = reinterpret_cast<float*>(kv + 2 * p.stages * tile_elems);
  float* sc = qs + (size_t)p.rows * D;      // [rows][KT] scores, then P
  float* m = sc + (size_t)p.rows * kTileKeys;
  float* l = m + p.rows;
  float* alpha = l + p.rows;
  int* kpb = reinterpret_cast<int*>(alpha + p.rows);  // [2][KT], -1 masked
  int* live = kpb + 2 * kTileKeys;          // [2][2]: a warp saw a valid key

  const TQ* q = static_cast<const TQ*>(p.q) + ((size_t)b * p.H + h0) * D;
  for (int idx = tid; idx < R * D; idx += kBlock) qs[idx] = to_f32(q[idx]);
  for (int r = tid; r < R; r += kBlock) {
    m[r] = kNegInit;
    l[r] = 0.f;
  }

  // P V: thread (pg, dp), dp < D/2, owns head elements 2dp, 2dp+1 of rows
  // pg + kPVGroups*u
  const int dp = tid % kPairs, pg = tid / kPairs;
  const bool pv = dp < D / 2 && pg < R;
  float acc[kPVRows][2];
#pragma unroll
  for (int u = 0; u < kPVRows; ++u) acc[u][0] = acc[u][1] = 0.f;
  // scores: thread (sg, st) owns key st of the tile and rows
  // sg + kScoreGroups*u
  const int st = tid % kTileKeys, sg = tid / kTileKeys;

  const int qpos = p.pos[(size_t)b * p.pos_stride];
  const int* kp_row = p.key_pos + (size_t)b * p.kp_stride;
  const size_t slot0 = (size_t)b * p.C * p.KH * D + (size_t)j * D;
  const TKV* kg = static_cast<const TKV*>(p.k) + slot0;
  const TKV* vg = static_cast<const TKV*>(p.v) + slot0;
  const size_t key_stride = (size_t)p.KH * D;
  const int c_begin = split * p.L;
  const int c_end = min(c_begin + p.L, p.C);
  const int n_tiles = (c_end - c_begin + kTileKeys - 1) / kTileKeys;
  const int per_row = D / kVec;             // 16-byte pieces of a row

  // the key positions of tile i into slot i & 1 (-1: masked for every row)
  // and whether each of the two warps saw a valid key
  auto mark = [&](int i) {
    if (tid < kTileKeys) {
      const int c = c_begin + i * kTileKeys + tid;
      const int kpos = c < c_end ? kp_row[c] : -1;
      const bool ok = kpos >= 0 && kpos <= qpos &&
                      (p.window <= 0 || kpos > qpos - p.window);
      kpb[(i & 1) * kTileKeys + tid] = ok ? kpos : -1;
      const unsigned seen = __ballot_sync(0xffffffffu, ok);
      if (lane == 0) live[(i & 1) * 2 + warp] = seen != 0u;
    }
  };
  auto has_valid = [&](int i) {
    return live[(i & 1) * 2] | live[(i & 1) * 2 + 1];
  };
  // the K and V rows of tile i's valid keys into stage `stage`, in flight
  // all at once; a masked key's row is not read and stays zeros
  auto fetch = [&](int i, int stage) {
    const int* kp = kpb + (i & 1) * kTileKeys;
    TKV* ks = kv + 2 * stage * tile_elems;
    TKV* vs = ks + tile_elems;
    const int c0 = c_begin + i * kTileKeys;
    for (int e = tid; e < kTileKeys * per_row; e += kBlock) {
      const int t = e / per_row, part = e - t * per_row;
      const bool ok = kp[t] >= 0;
      const size_t off =
          ok ? (size_t)(c0 + t) * key_stride + (size_t)part * kVec : 0;
      const size_t at = (size_t)t * DS + (size_t)part * kVec;
      cp_async16(ks + at, kg + off, ok ? 16 : 0);
      cp_async16(vs + at, vg + off, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  mark(0);
  __syncthreads();
  if (has_valid(0)) fetch(0, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const bool next = i + 1 < n_tiles;
    if (next) mark(i + 1);
    cp_async_wait_all();
    __syncthreads();        // tile i landed; tile i+1's positions published
    // with two stages tile i+1 loads while tile i is attended
    if (p.stages == 2 && next && has_valid(i + 1)) fetch(i + 1, (i + 1) & 1);
    if (has_valid(i)) {     // a tile with no valid key changes nothing
      const int* kp = kpb + (i & 1) * kTileKeys;
      const TKV* ks = kv + 2 * (p.stages == 2 ? i & 1 : 0) * tile_elems;
      const TKV* vs = ks + tile_elems;

      // scores of key st for its rows: the whole dot product per thread
      {
        const int kpos = kp[st];
        float sv[kScoreRows];
#pragma unroll
        for (int u = 0; u < kScoreRows; ++u) sv[u] = 0.f;
        if (kpos >= 0 && sg < R) {
          const TKV* krow = ks + (size_t)st * DS;
          for (int jj = 0; jj < per_row; ++jj) {
            float kf[kVec];
            unpack(*reinterpret_cast<const uint4*>(krow + jj * kVec), kf,
                   krow);
#pragma unroll
            for (int u = 0; u < kScoreRows; ++u) {
              const int r = sg + kScoreGroups * u;
              if (r < R) {
                const float4* qv = reinterpret_cast<const float4*>(
                    qs + (size_t)r * D + jj * kVec);
#pragma unroll
                for (int w = 0; w < kVec / 4; ++w) {
                  const float4 x = qv[w];
                  sv[u] += x.x * kf[4 * w] + x.y * kf[4 * w + 1] +
                           x.z * kf[4 * w + 2] + x.w * kf[4 * w + 3];
                }
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kScoreRows; ++u) {
          const int r = sg + kScoreGroups * u;
          if (r < R) {
            float x = -CUDART_INF_F;
            if (kpos >= 0) {
              x = sv[u] * p.scale;
              if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
            }
            sc[(size_t)r * kTileKeys + st] = x;
          }
        }
      }
      __syncthreads();

      // online softmax over the tile: one warp per query row
      for (int r = warp; r < R; r += kBlock / 32) {
        float* row = sc + (size_t)r * kTileKeys;
        float mt = kNegInit;
        for (int t = lane; t < kTileKeys; t += 32) mt = fmaxf(mt, row[t]);
        mt = warp_max(mt);
        const float m_old = m[r];
        const float m_new = fmaxf(m_old, mt);
        float sum = 0.f;
        for (int t = lane; t < kTileKeys; t += 32) {
          const float sv = row[t];
          const float pr = sv == -CUDART_INF_F ? 0.f : expf(sv - m_new);
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

      // acc = alpha * acc + P V, acc in registers, V read once per tile
      if (pv) {
#pragma unroll
        for (int u = 0; u < kPVRows; ++u) {
          const int r = pg + kPVGroups * u;
          if (r < R) {
            const float a = alpha[r];
            acc[u][0] *= a;
            acc[u][1] *= a;
          }
        }
        const TKV* vcol = vs + 2 * dp;
        for (int t = 0; t < kTileKeys; t += 4) {
          float2 vv[4];
#pragma unroll
          for (int w = 0; w < 4; ++w)
            vv[w] = load_pair(vcol + (size_t)(t + w) * DS);
#pragma unroll
          for (int u = 0; u < kPVRows; ++u) {
            const int r = pg + kPVGroups * u;
            if (r < R) {
              const float4 pr = *reinterpret_cast<const float4*>(
                  sc + (size_t)r * kTileKeys + t);
              acc[u][0] += pr.x * vv[0].x + pr.y * vv[1].x + pr.z * vv[2].x +
                           pr.w * vv[3].x;
              acc[u][1] += pr.x * vv[0].y + pr.y * vv[1].y + pr.z * vv[2].y +
                           pr.w * vv[3].y;
            }
          }
        }
      }
    }
    __syncthreads();        // tile i's readers are done with its buffers
    if (p.stages == 1 && next && has_valid(i + 1)) fetch(i + 1, 0);
  }

  if (pv) {
#pragma unroll
    for (int u = 0; u < kPVRows; ++u) {
      const int r = pg + kPVGroups * u;
      if (r < R) {
        const size_t row = (size_t)b * p.H + h0 + r;
        if (p.S == 1) {
          TQ* out = static_cast<TQ*>(p.out) + row * D + 2 * dp;
          const float den = fmaxf(l[r], 1e-30f);
          out[0] = from_f32<TQ>(acc[u][0] / den);
          out[1] = from_f32<TQ>(acc[u][1] / den);
        } else {
          *reinterpret_cast<float2*>(
              p.part_acc + (row * p.S + split) * D + 2 * dp) =
              make_float2(acc[u][0], acc[u][1]);
        }
      }
    }
  }
  if (p.S > 1) {
    for (int r = tid; r < R; r += kBlock) {
      const size_t at = (((size_t)b * p.H + h0 + r) * p.S + split) * 2;
      p.part_ml[at] = m[r];
      p.part_ml[at + 1] = l[r];
    }
  }
}

// The S partials of query head blockIdx.x of slot blockIdx.y, merged in
// index order (attention_tile.cuh, merge_splits).
template <typename TQ>
__global__ void __launch_bounds__(kThreads)
decode_attention_merge_kernel(const attn_tile::MergeParams p) {
  attn_tile::merge_splits<TQ>(p);
}

template <typename TQ, typename TKV, int kRows>
cudaError_t launch_rows(const Params& p, dim3 grid, cudaStream_t stream) {
  return launch_with_smem(decode_attention_kernel<TQ, TKV, kRows>, grid,
                          block_threads<kRows>(),
                          smem_bytes<TKV>(p.stages, p.rows, p.D), stream, p);
}

template <typename TQ, typename TKV>
cudaError_t launch(Params p, cudaStream_t stream) {
  const int g = p.H / p.KH;
  const int chunks = (g + kRowsPerBlock - 1) / kRowsPerBlock;
  if ((long long)p.S * chunks > 65535) return cudaErrorInvalidValue;
  p.rows = min(g, kRowsPerBlock);
  // a second stage only where a split has a second tile, and only where it
  // fits (float32 K/V at D = 256 takes one)
  p.stages = p.L > kTileKeys &&
                     smem_bytes<TKV>(2, p.rows, p.D) <= attn_tile::kMaxSmem
                 ? 2
                 : 1;
  const dim3 grid(p.KH, p.B, p.S * chunks);
  const cudaError_t e =
      p.rows <= 1    ? launch_rows<TQ, TKV, 1>(p, grid, stream)
      : p.rows <= 2  ? launch_rows<TQ, TKV, 2>(p, grid, stream)
      : p.rows <= 4  ? launch_rows<TQ, TKV, 4>(p, grid, stream)
      : p.rows <= 8  ? launch_rows<TQ, TKV, 8>(p, grid, stream)
      : p.rows <= 10 ? launch_rows<TQ, TKV, 10>(p, grid, stream)
                     : launch_rows<TQ, TKV, 16>(p, grid, stream);
  if (e != cudaSuccess || p.S == 1) return e;
  return launch_with_smem(
      decode_attention_merge_kernel<TQ>, dim3(p.H, p.B), kThreads, 0, stream,
      attn_tile::MergeParams{p.part_ml, p.part_acc, p.out, p.H, p.D, p.S});
}

}  // namespace

extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* key_pos,
    const void* pos, void* out, void* part_ml, void* part_acc, int B, int H,
    int KH, int D, int C, int kp_stride, int pos_stride, int S, int L,
    float scale, float softcap, int window, int q_dtype, int kv_dtype,
    void* stream) {
  if (B <= 0 || KH <= 0 || H % KH != 0 || D % 32 != 0 || D > 256 ||
      C <= 0 || B > 65535 ||
      (kp_stride != 0 && kp_stride != C) ||
      (pos_stride != 0 && pos_stride != 1) || S < 1 || S > kMaxSplits ||
      L <= 0 || L % kTileKeys != 0 || (long long)(S - 1) * L >= C ||
      (long long)S * L < C || (S > 1 && (!part_ml || !part_acc)))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, static_cast<const int*>(key_pos),
           static_cast<const int*>(pos), out, static_cast<float*>(part_ml),
           static_cast<float*>(part_acc), B, H, KH, D, C, kp_stride,
           pos_stride, S, L, 0, 1, scale, softcap, window};
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
