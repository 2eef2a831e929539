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
// over the C = nbs*bs logical keys of the slot's table, key c living in
// block bt[b, c / bs] at offset c % bs, attended when the entry is mapped
// (>= 0 and inside the pool), key_pos[b, c] >= 0, key_pos <= pos[b] + i
// and, with a window, key_pos > pos[b] + i - window.  Softmax is online, in
// float32; the output is acc / max(l, 1e-30), so a fully masked row gives
// exact zeros.  The TPU wrapper built the mask in XLA as a separate pass and
// bool tensor; here it costs one int read per key.
//
// Bound: device memory.  Per layer the kernel must read every valid key and
// value once, bytes = sum over slots of valid keys * KH * D * 2 * itemsize,
// and does only ~4*D flops per key and query row.  The card reads at its
// rate only with many loads in flight on every SM, so the design is about
// parallelism, and it is the contiguous-ring kernel's (decode_attention.cu)
// carried onto a block table.  Stage by stage, with its counterpart there:
//
// - Grid (KH, B, S * chunks) (decode: the same, with g rows a group).  A
//   block serves at most kRowsPerBlock of the KQ*g rows of one kv head of
//   one slot, chunks = ceil(KQ*g / 16), and walks one split of the table,
//   keys [s*L, min((s+1)*L, C)), in tiles of 64 logical keys.  The split
//   count comes from decode's split_plan at g = H/KH, not KQ*g, from shapes
//   and the SM count only (never pos, key_pos or bt: no host sync, and a
//   call can be captured in a CUDA graph), so KQ = 1 and KQ = 4 split alike.
// - Marking a tile (decode: mark).  For each key the table entry is read
//   once (a tile may straddle cache blocks, for any bs), then key_pos; the
//   key is kept when some row of the block may see it, and a tile with no
//   kept key is skipped whole.  The walk never stops early: a wrapped
//   window ring is not monotonic in c.
// - Loading a tile (decode: fetch).  cp.async for the K and V rows of kept
//   keys only, the whole tile in flight at once; a masked key's row is
//   zero-filled and not read, so unmapped blocks and the pool's scratch
//   block are never read.  Rows are padded by 16 bytes in shared memory;
//   two stages alternate where a split has more than one tile.
// - Scores (decode: the same).  Each thread owns one key and some rows and
//   forms the whole dot product from q in shared memory; the per-row mask
//   (kpos <= pos + i, the window) is applied here: a masked (row, key)
//   scores -inf.
// - Softmax (decode: the same).  One warp per row, online, in float32.
// - P V (decode: the same).  acc stays in registers; each thread owns a pair
//   of head elements of some rows.
// - Merge (decode: the same merge_splits of attention_tile.cuh).  With
//   S > 1 each split writes its unnormalised (m, l, acc) to a float32
//   workspace, [B, KQ, H, S, 2] and [B, KQ, H, S, D], and
//   paged_attention_merge_kernel, one block per (query token, head),
//   combines the partials in index order, with no atomics: the same inputs
//   give the same bits on every call.  With S = 1 the split writes the
//   output itself.
//
// A row's arithmetic does not depend on the other rows of its block: keys
// it may not see score -inf and add exact zeros, and a tile or split it
// sees nothing of leaves its state as it was.  The dot products and the
// P V sums are pinned to one order of fused multiply-adds, so row i of a
// KQ > 1 call gives the bits of a KQ = 1 call at position pos + i, as the
// reference's verify kernel degenerates to its decode kernel.

#include <limits.h>

#include "attention_tile.cuh"

namespace {

using attn_tile::block_threads;
using attn_tile::cp_async16;
using attn_tile::cp_async_commit;
using attn_tile::cp_async_wait_all;
using attn_tile::from_f32;
using attn_tile::kBFloat16;
using attn_tile::kFloat32;
using attn_tile::kMaxSmem;
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
  const void* q;          // [B, KQ, H, D]
  const void* k_pool;     // [n_pool_blocks, bs, KH, D]
  const void* v_pool;
  const int* bt;          // [B, bt_stride] physical block ids, -1 = unmapped
  const int* key_pos;     // [B, nbs * bs] absolute position per ring slot
  const int* pos;         // [B] position of query token 0
  void* out;              // [B, KQ, H, D], dtype of q
  float* part_ml;         // [B, KQ, H, S, 2]: m, l of each split (S > 1)
  float* part_acc;        // [B, KQ, H, S, D]: acc of each split (S > 1)
  int B, KQ, H, KH, D, bs, nbs, bt_stride, n_pool_blocks;
  int S, L;               // splits, keys per split
  int rows;               // query rows per block, min(KQ*g, kRowsPerBlock)
  int stages;             // K/V tile buffers: 2 overlap loads with compute
  float scale;
  float softcap;          // <= 0: none
  int window;             // <= 0: none
};

// shared memory of a block: `stages` K/V tile pairs, then q, the scores,
// m, l, alpha, two tiles' key positions and pool rows, and two tiles'
// any-valid flags
template <typename TKV>
size_t smem_bytes(int stages, int rows, int D) {
  const size_t kv = (size_t)stages * 2 * kTileKeys * row_stride<TKV>(D) *
                    sizeof(TKV);
  return kv + ((size_t)rows * D + (size_t)rows * kTileKeys + 3 * rows) * 4 +
         (4 * kTileKeys + 4) * 4;
}

// kRows: the most query rows a block serves, a compile-time bound, so that
// the per-thread row loops unroll into registers; launch() picks the least
// of 1, 2, 4, 8, 10 (recurrentgemma-2b's group) and 16 that covers it.
template <typename TQ, typename TKV, int kRows>
__global__ void __launch_bounds__(block_threads<kRows>())
paged_attention_kernel(const Params p) {
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
  const int r0 = blockIdx.z / p.S * kRowsPerBlock;  // the block's first row
  const int D = p.D, DS = row_stride<TKV>(D);
  const int g = p.H / p.KH;
  const int R = min(kRowsPerBlock, p.KQ * g - r0);  // this block's rows
  const size_t tile_elems = (size_t)kTileKeys * DS;

  extern __shared__ __align__(16) unsigned char smem[];
  TKV* kv = reinterpret_cast<TKV*>(smem);   // [stages][K, V][KT][DS]
  float* qs = reinterpret_cast<float*>(kv + 2 * p.stages * tile_elems);
  float* sc = qs + (size_t)p.rows * D;      // [rows][KT] scores, then P
  float* m = sc + (size_t)p.rows * kTileKeys;
  float* l = m + p.rows;
  float* alpha = l + p.rows;
  int* kpb = reinterpret_cast<int*>(alpha + p.rows);  // [2][KT], -1 masked
  int* krow = kpb + 2 * kTileKeys;          // [2][KT] pool row of each key
  int* live = krow + 2 * kTileKeys;         // [2][2]: a warp saw a valid key

  // block row r is row r0 + r = i*g + gi: query token i, head j*g + gi; its
  // row of q, of the output and of the workspace
  auto out_row = [&](int r) -> size_t {
    const int ra = r0 + r;
    return ((size_t)b * p.KQ + ra / g) * p.H + (size_t)j * g + ra % g;
  };
  const TQ* q = static_cast<const TQ*>(p.q);
  for (int idx = tid; idx < R * D; idx += kBlock) {
    const int r = idx / D;
    qs[idx] = to_f32(q[out_row(r) * D + (idx - r * D)]);
  }
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
  // sg + kScoreGroups*u, each attending from its own position
  const int st = tid % kTileKeys, sg = tid / kTileKeys;
  const int pos0 = p.pos[b];
  int qpos[kScoreRows];
#pragma unroll
  for (int u = 0; u < kScoreRows; ++u)
    qpos[u] = pos0 + (r0 + sg + kScoreGroups * u) / g;
  // the block's rows attend from positions q_lo .. q_hi
  const int q_lo = pos0 + r0 / g, q_hi = pos0 + (r0 + R - 1) / g;

  const int C = p.nbs * p.bs;
  const int* kp_row = p.key_pos + (size_t)b * C;
  const int* bt_row = p.bt + (size_t)b * p.bt_stride;
  const TKV* kg = static_cast<const TKV*>(p.k_pool) + (size_t)j * D;
  const TKV* vg = static_cast<const TKV*>(p.v_pool) + (size_t)j * D;
  const size_t key_stride = (size_t)p.KH * D;   // pool row to pool row
  const int c_begin = split * p.L;
  const int c_end = min(c_begin + p.L, C);
  const int n_tiles = (c_end - c_begin + kTileKeys - 1) / kTileKeys;
  const int per_row = D / kVec;             // 16-byte pieces of a row

  // tile i's key positions into slot i & 1 (-1: masked for every row of
  // the block), the pool rows of its keys, and whether each of the two
  // warps saw a valid key
  auto mark = [&](int i) {
    if (tid < kTileKeys) {
      const int c = c_begin + i * kTileKeys + tid;
      int kpos = -1, row = 0;
      if (c < c_end) {
        const int blk = bt_row[c / p.bs];
        if (blk >= 0 && blk < p.n_pool_blocks) {
          kpos = kp_row[c];
          row = blk * p.bs + c % p.bs;
        }
      }
      const bool ok = kpos >= 0 && kpos <= q_hi &&
                      (p.window <= 0 || kpos > q_lo - p.window);
      kpb[(i & 1) * kTileKeys + tid] = ok ? kpos : -1;
      krow[(i & 1) * kTileKeys + tid] = row;
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
    const int* kr = krow + (i & 1) * kTileKeys;
    TKV* ks = kv + 2 * stage * tile_elems;
    TKV* vs = ks + tile_elems;
    for (int e = tid; e < kTileKeys * per_row; e += kBlock) {
      const int t = e / per_row, part = e - t * per_row;
      const bool ok = kp[t] >= 0;
      const size_t off =
          ok ? (size_t)kr[t] * key_stride + (size_t)part * kVec : 0;
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

      // scores of key st for its rows: the whole dot product per thread,
      // four products at a time in a fixed order of fused multiply-adds
      {
        const int kpos = kp[st];
        float sv[kScoreRows];
#pragma unroll
        for (int u = 0; u < kScoreRows; ++u) sv[u] = 0.f;
        if (kpos >= 0 && sg < R) {
          const TKV* krow_s = ks + (size_t)st * DS;
          for (int jj = 0; jj < per_row; ++jj) {
            float kf[kVec];
            unpack(*reinterpret_cast<const uint4*>(krow_s + jj * kVec), kf,
                   krow_s);
#pragma unroll
            for (int u = 0; u < kScoreRows; ++u) {
              const int r = sg + kScoreGroups * u;
              if (r < R) {
                const float4* qv = reinterpret_cast<const float4*>(
                    qs + (size_t)r * D + jj * kVec);
#pragma unroll
                for (int w = 0; w < kVec / 4; ++w) {
                  const float4 x = qv[w];
                  float part = __fmul_rn(x.x, kf[4 * w]);
                  part = __fmaf_rn(x.y, kf[4 * w + 1], part);
                  part = __fmaf_rn(x.z, kf[4 * w + 2], part);
                  part = __fmaf_rn(x.w, kf[4 * w + 3], part);
                  sv[u] = __fadd_rn(sv[u], part);
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
            if (kpos >= 0 && kpos <= qpos[u] &&
                (p.window <= 0 || kpos > qpos[u] - p.window)) {
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
          l[r] = __fmaf_rn(a, l[r], sum);
          m[r] = m_new;
        }
      }
      __syncthreads();

      // acc = alpha * acc + P V, acc in registers, V read once per tile,
      // four keys at a time in a fixed order of fused multiply-adds
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
              float x = __fmul_rn(pr.x, vv[0].x);
              float y = __fmul_rn(pr.x, vv[0].y);
              x = __fmaf_rn(pr.y, vv[1].x, x);
              y = __fmaf_rn(pr.y, vv[1].y, y);
              x = __fmaf_rn(pr.z, vv[2].x, x);
              y = __fmaf_rn(pr.z, vv[2].y, y);
              x = __fmaf_rn(pr.w, vv[3].x, x);
              y = __fmaf_rn(pr.w, vv[3].y, y);
              acc[u][0] = __fadd_rn(acc[u][0], x);
              acc[u][1] = __fadd_rn(acc[u][1], y);
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
        const size_t row = out_row(r);
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
      const size_t at = (out_row(r) * p.S + split) * 2;
      p.part_ml[at] = m[r];
      p.part_ml[at + 1] = l[r];
    }
  }
}

// The S partials of query head blockIdx.x of query token blockIdx.y (slot
// b, token i: blockIdx.y = b*KQ + i), merged in index order
// (attention_tile.cuh, merge_splits).
template <typename TQ>
__global__ void __launch_bounds__(kThreads)
paged_attention_merge_kernel(const attn_tile::MergeParams p) {
  attn_tile::merge_splits<TQ>(p);
}

template <typename TQ, typename TKV, int kRows>
cudaError_t launch_rows(const Params& p, dim3 grid, cudaStream_t stream) {
  return launch_with_smem(paged_attention_kernel<TQ, TKV, kRows>, grid,
                          block_threads<kRows>(),
                          smem_bytes<TKV>(p.stages, p.rows, p.D), stream, p);
}

template <typename TQ, typename TKV>
cudaError_t launch(Params p, cudaStream_t stream) {
  const int rows = p.KQ * (p.H / p.KH);
  const int chunks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if ((long long)p.S * chunks > 65535) return cudaErrorInvalidValue;
  p.rows = min(rows, kRowsPerBlock);
  // a second stage only where a split has a second tile, and only where it
  // fits (float32 K/V at D = 256 takes one)
  p.stages =
      p.L > kTileKeys && smem_bytes<TKV>(2, p.rows, p.D) <= kMaxSmem ? 2 : 1;
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
      paged_attention_merge_kernel<TQ>, dim3(p.H, p.B * p.KQ), kThreads, 0,
      stream,
      attn_tile::MergeParams{p.part_ml, p.part_acc, p.out, p.H, p.D, p.S});
}

}  // namespace

extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* bt,
    const void* key_pos, const void* pos, void* out, void* part_ml,
    void* part_acc, int B, int KQ, int H, int KH, int D, int bs, int nbs,
    int bt_stride, int n_pool_blocks, int S, int L, float scale,
    float softcap, int window, int q_dtype, int kv_dtype, void* stream) {
  const long long C = (long long)nbs * bs;
  if (B <= 0 || KQ <= 0 || KH <= 0 || H % KH != 0 || D % 32 != 0 ||
      D > 256 || bs <= 0 || nbs <= 0 || bt_stride < nbs ||
      n_pool_blocks < 0 || (long long)B * KQ > 65535 || C > INT_MAX ||
      (long long)n_pool_blocks * bs > INT_MAX || S < 1 || S > kMaxSplits ||
      L <= 0 || L % kTileKeys != 0 || (long long)(S - 1) * L >= C ||
      (long long)S * L < C || (S > 1 && (!part_ml || !part_acc)))
    return (int)cudaErrorInvalidValue;
  Params p{q, k_pool, v_pool, static_cast<const int*>(bt),
           static_cast<const int*>(key_pos), static_cast<const int*>(pos),
           out, static_cast<float*>(part_ml), static_cast<float*>(part_acc),
           B, KQ, H, KH, D, bs, nbs, bt_stride, n_pool_blocks, S, L, 0, 1,
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
