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
// does only ~4*D flops per key and query head.  Design: one thread block per
// (slot, kv head) walks its ring in tiles of 64 keys.  It reads the tile's
// key_pos first and loads the K/V rows of valid keys only; a tile with no
// valid key is skipped whole.  That is exact, and it matters: the ring is
// allocated at max_len and is mostly empty early in a request.  Validity is
// not monotonic in the ring index (a wrapped window ring holds positions
// out of order), so the walk never stops early.  The loaded tile serves the
// whole GQA group from shared memory, so each cache row is read once per
// step, as on the TPU.  The tile stages are shared with the paged kernel
// through attention_tile.cuh.
//
// Known limits, for a later PR: the grid is B*KH blocks, which under-fills
// the 132 SMs when B*KH is small, and a long ring is walked by one block
// (split-K over the ring fixes both); loads are not double-buffered.

#include "attention_tile.cuh"

namespace {

using namespace attn_tile;

struct Params {
  const void* q;          // [B, H, D]
  const void* k;          // [B, C, KH, D]
  const void* v;
  const int* key_pos;     // [C] (kp_stride 0) or [B, C] (kp_stride C)
  const int* pos;         // [1] (pos_stride 0) or [B] (pos_stride 1)
  void* out;              // [B, H, D], dtype of q
  int B, H, KH, D, C, kp_stride, pos_stride;
  int tile_keys;
  float scale;
  float softcap;          // <= 0: none
  int window;             // <= 0: none
};

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const Params p) {
  const int j = blockIdx.x;                 // kv head
  const int b = blockIdx.y;                 // slot
  const int D = p.D;
  const int g = p.H / p.KH;                 // query rows served per block
  const int KT = p.tile_keys;

  extern __shared__ __align__(16) unsigned char smem[];
  const Tile<TKV> s = carve<TKV>(smem, KT, g, D);
  const TQ* q = static_cast<const TQ*>(p.q);
  const size_t head0 = ((size_t)b * p.H + (size_t)j * g) * D;
  init_rows(s, g, D, [=](int r, int d) {
    return to_f32(q[head0 + (size_t)r * D + d]);
  });

  const int qpos = p.pos[(size_t)b * p.pos_stride];
  const int* kp_row = p.key_pos + (size_t)b * p.kp_stride;
  const size_t slot0 = (size_t)b * p.C * p.KH * D + (size_t)j * D;
  for (int c0 = 0; c0 < p.C; c0 += KT) {
    __syncthreads();        // the previous tile's readers are done
    int mine = 0;
    for (int t = threadIdx.x; t < KT; t += kThreads) {
      const int c = c0 + t;
      const int kpos = c < p.C ? kp_row[c] : -1;
      const bool ok = kpos >= 0 && kpos <= qpos &&
                      (p.window <= 0 || kpos > qpos - p.window);
      s.kp[t] = ok ? kpos : -1;
      mine |= ok;
    }
    // a tile with no valid key changes nothing: skip it, reading no K/V row
    // (the barrier also publishes kp to the block)
    if (!__syncthreads_or(mine)) continue;
    const int* kp = s.kp;
    load_tile(s, static_cast<const TKV*>(p.k), static_cast<const TKV*>(p.v),
              KT, D, [=](int t) -> long long {      // masked: zeros
                return kp[t] < 0 ? -1
                                 : (long long)(slot0 + (size_t)(c0 + t) *
                                                           p.KH * D);
              });
    __syncthreads();
    attend_tile(s, g, KT, D, p.scale, p.softcap,
                [](int, int) { return true; });     // kp holds valid keys
  }
  __syncthreads();
  TQ* out = static_cast<TQ*>(p.out);
  store_rows<TQ>(s, g, D, [=](int r, int d) {
    return out + head0 + (size_t)r * D + d;
  });
}

template <typename TQ, typename TKV>
cudaError_t launch(Params p, cudaStream_t stream) {
  const int g = p.H / p.KH;
  p.tile_keys = p.C < kTileKeys ? p.C : kTileKeys;
  size_t smem = smem_bytes(p.tile_keys, g, p.D, sizeof(TKV));
  while (smem > kMaxSmem && p.tile_keys > 1) {
    p.tile_keys = (p.tile_keys + 1) / 2;
    smem = smem_bytes(p.tile_keys, g, p.D, sizeof(TKV));
  }
  return launch_with_smem(decode_attention_kernel<TQ, TKV>, dim3(p.KH, p.B),
                          smem, stream, p);
}

}  // namespace

extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* key_pos,
    const void* pos, void* out, int B, int H, int KH, int D, int C,
    int kp_stride, int pos_stride, float scale, float softcap, int window,
    int q_dtype, int kv_dtype, void* stream) {
  if (B <= 0 || KH <= 0 || H % KH != 0 || D % 32 != 0 ||
      D > 32 * kMaxDPerLane || C <= 0 || B > 65535 ||
      (kp_stride != 0 && kp_stride != C) ||
      (pos_stride != 0 && pos_stride != 1))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, static_cast<const int*>(key_pos),
           static_cast<const int*>(pos), out, B, H, KH, D, C, kp_stride,
           pos_stride, kTileKeys, scale, softcap, window};
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
