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
// each K/V tile into shared memory once (16-byte loads, several in flight
// per thread) and serves all KQ*g query rows of the GQA group from it, so
// each cache block is read from device memory once per step.  A tile holds
// several cache blocks (about 64 keys) to amortise the load latency of a
// step.  The tile stages (load, scores, online softmax, P V) are shared
// with the contiguous-ring kernel through attention_tile.cuh.
//
// Known limits, for a later PR: the grid is B*KH blocks, so the card is
// under-filled when B*KH < 132 (Llama2-70B has KH = 8: B = 4 gives 32
// blocks); split-K (flash-decoding) over the context fixes that.  Loads are
// not double-buffered (cp.async / TMA), so each tile waits for its load.

#include "attention_tile.cuh"

namespace {

using namespace attn_tile;

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
  const int D = p.D;
  const int g = p.H / p.KH;
  const int R = p.KQ * g;                   // query rows served per block
  const int KT = p.blocks_per_tile * p.bs;  // keys per tile

  extern __shared__ __align__(16) unsigned char smem[];
  const Tile<TKV> s = carve<TKV>(smem, KT, R, D);
  const TQ* q = static_cast<const TQ*>(p.q);
  const int pos0 = p.pos[b];
  // row r = i*g + gi is query token i at position pos0 + i, head j*g + gi
  auto q_index = [=](int r, int d) {
    return (((size_t)b * p.KQ + r / g) * p.H + (size_t)j * g + r % g) * D + d;
  };
  init_rows(s, R, D, [=](int r, int d) { return to_f32(q[q_index(r, d)]); });

  const size_t row_stride = (size_t)p.KH * D;       // token to token
  const size_t blk_stride = (size_t)p.bs * row_stride;
  for (int ib0 = 0; ib0 < p.nbs; ib0 += p.blocks_per_tile) {
    // a tile with no mapped block changes nothing: skip it (the test is
    // uniform over the thread block, so no thread waits at a barrier alone)
    bool any = false;
    for (int u = 0; u < p.blocks_per_tile; ++u)
      any |= table_entry(p, b, ib0 + u) >= 0;
    if (!any) continue;
    __syncthreads();        // the previous tile's readers are done

    for (int t = threadIdx.x; t < KT; t += kThreads) {
      const int ib = ib0 + t / p.bs;
      s.kp[t] = table_entry(p, b, ib) >= 0
                    ? p.key_pos[(size_t)b * p.nbs * p.bs + (size_t)ib * p.bs +
                                t % p.bs]
                    : -1;
    }
    load_tile(s, static_cast<const TKV*>(p.k_pool),
              static_cast<const TKV*>(p.v_pool), KT, D,
              [=](int t) -> long long {             // unmapped: zeros
                const int blk = table_entry(p, b, ib0 + t / p.bs);
                return blk < 0 ? -1
                               : (long long)(blk * blk_stride +
                                             (size_t)(t % p.bs) * row_stride +
                                             (size_t)j * D);
              });
    __syncthreads();
    attend_tile(s, R, KT, D, p.scale, p.softcap, [=](int r, int kpos) {
      const int qpos = pos0 + r / g;
      return kpos <= qpos && (p.window <= 0 || kpos > qpos - p.window);
    });
  }
  __syncthreads();
  TQ* out = static_cast<TQ*>(p.out);
  store_rows<TQ>(s, R, D, [=](int r, int d) { return out + q_index(r, d); });
}

template <typename TQ, typename TKV>
cudaError_t launch(Params p, cudaStream_t stream) {
  const int R = p.KQ * (p.H / p.KH);
  p.blocks_per_tile = kTileKeys / p.bs > 1 ? kTileKeys / p.bs : 1;
  if (p.blocks_per_tile > p.nbs) p.blocks_per_tile = p.nbs;
  size_t smem = smem_bytes(p.blocks_per_tile * p.bs, R, p.D, sizeof(TKV));
  while (smem > kMaxSmem && p.blocks_per_tile > 1) {
    p.blocks_per_tile /= 2;
    smem = smem_bytes(p.blocks_per_tile * p.bs, R, p.D, sizeof(TKV));
  }
  return launch_with_smem(paged_attention_kernel<TQ, TKV>, dim3(p.KH, p.B),
                          smem, stream, p);
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
