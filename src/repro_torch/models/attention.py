"""GQA attention: qk-norm, bias, logit soft-capping, sliding windows.  Port
of the train-mode and cache-writing entry points of
``repro.models.attention``:

- :func:`attend_full`         -- causal attention over the whole sequence
  (train mode: no cache),
- :func:`prefill_cache`       -- run prefill AND write k/v into a ring cache,
- :func:`attend_decode`       -- one token per slot against its ring cache,
- :func:`attend_decode_paged` -- one token per slot against a paged cache,
- :func:`attend_verify_paged` -- K tokens per slot (speculative verify)
  against a paged cache,
- :func:`extend_cache`        -- a prompt chunk per slot at its absolute
  positions against a paged cache (streamed admission).

Prefill supports *masked* left-padded batches: per-row positions [B, S]
hold negative values at pad slots, which are masked out of the softmax and
written with ``key_pos == -1``, so the output for real tokens (and every
later decode step) is independent of the padded width.

``impl`` selects how attention runs in train mode and how the cache is
*read* at decode and verify (unknown values raise, as ``DECODE_IMPLS`` does
in the reference):

- ``"ref"``     -- the masked :func:`_sdpa` over the sequence, the ring, or
  the slot's blocks gathered in ring order (the reference's ``"xla"``
  path),
- ``"chunked"`` -- :func:`_sdpa_chunked`, the online softmax over key
  blocks, for the whole sequence, prefill and extend; one-token decode and
  verify run :func:`_sdpa`, as the reference's alias does,
- ``"cuda"``    -- the hand-written kernels: the whole sequence through
  :func:`repro_torch.kernels.flash_attention.flash_attention`, the
  contiguous ring through
  :func:`repro_torch.kernels.decode_attention.decode_attention`, the paged
  pool through the block table with
  :func:`repro_torch.kernels.paged_attention.paged_attention`; on CPU
  tensors the wrappers run the kernels' plain versions.

Prefill and extend run :func:`_sdpa` under ``"ref"`` and ``"cuda"``, as the
reference's do under ``"xla"`` and ``"pallas"``.

The int8 KV cache (``cfg.kv_dtype == "int8"``) stores K/V quantized per
(token, head) by absmax with float32 scales (:func:`_quantize_kv`) and
reads them dequantized (:func:`_dequantize_kv`) on every path.  Under
``"cuda"`` the contiguous ring is dequantized and read by the ring kernel,
as the reference's ``"pallas"`` does; the paged pool has no int8 kernel in
the reference, so it is gathered and read by :func:`_sdpa` with a warning
once a process (a ``ValueError`` when ``REPRO_STRICT_IMPL`` is set), and
:func:`effective_decode_impl` reports ``"ref"``.
Caches update in place (``index_put_``) where the reference rebuilt them.

Under tensor parallelism (:func:`repro_torch.sharding.rules.tensor_parallel`)
a process runs a config of its own query and K/V heads, holds their
caches, its input enters the projections through ``model_copy`` (whose
backward sums the processes' shares of its gradient), and its output
projection is summed over the processes that split the heads
(:func:`_out_proj`).
"""
from __future__ import annotations

import os
import warnings
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models.config import BlockSpec, ModelConfig
from repro_torch.models.layers import apply_rope, rms_norm_headwise, softcap
from repro_torch.sharding.rules import model_copy, model_sum

NEG_INF = -2.0 ** 30

#: implementations: "ref" (masked sdpa), "chunked" (online softmax over key
#: blocks; decode runs the same sdpa math, as in the reference) and "cuda"
#: (the flash, decode and paged attention kernels)
DECODE_IMPLS = ("ref", "chunked", "cuda")


def _check_decode_impl(impl: str) -> None:
    if impl not in DECODE_IMPLS:
        raise ValueError(
            f"unknown decode impl {impl!r}: expected one of {DECODE_IMPLS}")


def effective_decode_impl(impl: str, cfg: ModelConfig, device: torch.device,
                          cache_layout: str = "contiguous") -> str:
    """The decode read path that actually runs.  ``"cuda"`` over a paged
    int8 cache reads by gather and dequantization, as the reference's
    ``"pallas"`` does, reported as ``"ref"``; otherwise ``"cuda"`` launches
    the kernel only on a GPU, and on the CPU its wrapper runs the plain
    version, reported as ``"plain"``."""
    _check_decode_impl(impl)
    if impl == "cuda" and cache_layout == "paged" and cfg.kv_dtype == "int8":
        return "ref"
    if impl == "cuda" and torch.device(device).type != "cuda":
        return "plain"
    return impl


_INT8_CUDA_NOTED = False


def _note_int8_paged_gather() -> None:
    """``impl="cuda"`` over a paged int8 cache reads by gather: warn once a
    process, or raise when ``REPRO_STRICT_IMPL`` is set (a benchmark that
    must fail rather than measure the wrong path), as the reference does."""
    global _INT8_CUDA_NOTED
    msg = ("impl='cuda' with kv_dtype='int8' reads the paged pool by gather "
           "and dequantization (the reference has no int8 paged kernel); "
           "set impl='ref' to silence, or use a bfloat16 cache for the "
           "paged kernel")
    if os.environ.get("REPRO_STRICT_IMPL"):
        raise ValueError(msg + " (strict: REPRO_STRICT_IMPL is set)")
    if not _INT8_CUDA_NOTED:
        warnings.warn(msg, RuntimeWarning, stacklevel=3)
        _INT8_CUDA_NOTED = True


def _project_qkv(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor,
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B,S,d] -> q [B,S,h,hd], k/v [B,S,n_kv,hd]; RoPE applied."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    x = model_copy(x, "qkv")
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(b, s, cfg.n_heads, hd)
    k = k.reshape(b, s, cfg.n_kv_heads, hd)
    v = v.reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm_headwise(params["q_norm"], q)
        k = rms_norm_headwise(params["k_norm"], k)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(params: Dict, out: torch.Tensor) -> torch.Tensor:
    """The output projection of the heads' outputs [..., q_dim], summed
    over the processes that split the heads (tensor parallelism)."""
    return model_sum(out @ params["wo"], "qkv")


def _sdpa(cfg: ModelConfig, spec: BlockSpec, q: torch.Tensor,
          k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor,
          k_pos: torch.Tensor,
          k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped scaled-dot-product attention with position-based masking.

    q [B,Sq,h,hd], k/v [B,Sk,n_kv,hd]; q_pos [Sq] or [B,Sq], k_pos [Sk] or
    [B,Sk] absolute positions; mask = causal (k_pos <= q_pos) & window &
    validity (k_valid [Sk] or [B,Sk]).  Logits and softmax are float32; the
    probabilities are cast to v's dtype before the PV product, as in the
    reference.  A fully masked row gives the mean of V (``NEG_INF`` is
    finite), as in the reference; callers discard such rows.  The result
    has q's dtype (a cache stored in another dtype does not promote the
    residual stream, since torch matmuls take one dtype).
    """
    b, sq, h, hd = q.shape
    g = h // cfg.n_kv_heads
    qg = q.reshape(b, sq, cfg.n_kv_heads, g, hd)
    logits = torch.einsum("bsngd,btnd->bngst", qg.float(), k.float())
    logits = logits * (hd ** -0.5)
    logits = softcap(logits, cfg.attn_logit_softcap)
    if q_pos.dim() == 1:
        q_pos = q_pos[None]
    if k_pos.dim() == 1:
        k_pos = k_pos[None]
    if k_valid is not None and k_valid.dim() == 1:
        k_valid = k_valid[None]
    mask = k_pos[:, None, :] <= q_pos[:, :, None]                 # causal
    if spec.window is not None:
        mask &= k_pos[:, None, :] > (q_pos[:, :, None] - spec.window)
    if k_valid is not None:
        mask &= k_valid[:, None, :]
    logits = torch.where(mask[:, None, None, :, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bngst,btnd->bsngd", probs.to(v.dtype), v)
    return out.reshape(b, sq, h * hd).to(q.dtype)


def _sdpa_chunked(cfg: ModelConfig, spec: BlockSpec, q: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor,
                  k_pos: torch.Tensor, k_valid: Optional[torch.Tensor] = None,
                  block: int = 1024) -> torch.Tensor:
    """Online-softmax attention over key blocks of ``block`` keys, never
    holding the [.., Sq, Sk] logits: the semantics of :func:`_sdpa` (causal,
    window, softcap, validity; shared or per-row positions), with float32
    running max, sum and accumulator.  A fully masked block contributes an
    explicit zero (its running max stays at ``NEG_INF``, where
    ``exp(logit - m)`` would be 1).  Sk must be a multiple of ``block``
    (or at most ``block``), as in the reference: nothing is padded."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    block = min(block, sk)
    if sk % block:
        raise ValueError(f"chunked attention: {sk} keys are no multiple of "
                         f"the key block {block}")
    n_kv = cfg.n_kv_heads
    g = h // n_kv
    qg = q.reshape(b, sq, n_kv, g, hd).float()
    if q_pos.dim() == 1:
        q_pos = q_pos[None]
    if k_pos.dim() == 1:
        k_pos = k_pos[None].expand(b, sk)
    if k_valid is None:
        k_valid = torch.ones((b, sk), dtype=torch.bool, device=q.device)
    elif k_valid.dim() == 1:
        k_valid = k_valid[None].expand(b, sk)
    scale = hd ** -0.5
    m = torch.full((b, n_kv, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l_sum = torch.zeros_like(m)
    acc = torch.zeros((b, n_kv, g, sq, hd), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, sk, block):
        k_c, v_c = k[:, c0:c0 + block], v[:, c0:c0 + block]
        kp, kv = k_pos[:, c0:c0 + block], k_valid[:, c0:c0 + block]
        logits = torch.einsum("bsngd,btnd->bngst", qg, k_c.float()) * scale
        logits = softcap(logits, cfg.attn_logit_softcap)
        msk = kp[:, None, :] <= q_pos[:, :, None]              # [b, sq, blk]
        if spec.window is not None:
            msk &= kp[:, None, :] > (q_pos[:, :, None] - spec.window)
        msk &= kv[:, None, :]
        msk = msk[:, None, None]
        logits = torch.where(msk, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.where(msk, torch.exp(logits - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l_sum = l_sum * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bngst,btnd->bngsd", p,
                                                    v_c.float())
        m = m_new
    out = acc / l_sum.clamp_min(1e-30)[..., None]               # [b,n,g,sq,hd]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h * hd).to(q.dtype)


def _sdpa_for(impl: str):
    """The sequence attention of train mode, prefill and extend under
    ``impl`` (but the kernel's)."""
    _check_decode_impl(impl)
    return _sdpa_chunked if impl == "chunked" else _sdpa


def attend_full(params: Dict, cfg: ModelConfig, spec: BlockSpec,
                x: torch.Tensor, positions: torch.Tensor, impl: str = "ref",
                ) -> torch.Tensor:
    """Causal attention over the whole sequence (train mode). x: [B, S, d];
    ``positions`` is ``arange(S)``, which the kernel assumes: it masks by
    index.  ``impl="cuda"`` runs the flash-attention kernel, which has no
    backward: with autograd on it raises for inputs that need gradients.
    ``impl="chunked"`` runs the online softmax over key blocks."""
    _check_decode_impl(impl)
    q, k, v = _project_qkv(params, cfg, x, positions)
    if impl == "cuda":
        out = flash_attention(q, k, v, window=spec.window,
                              softcap=cfg.attn_logit_softcap)
        out = out.reshape(*x.shape[:2], cfg.q_dim)
    else:
        out = _sdpa_for(impl)(cfg, spec, q, k, v, positions, positions)
    return _out_proj(params, out)


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) absmax int8 quantization, bit for bit the
    reference's: x [..., hd] -> (q8 [..., hd] int8, scale [...] float32),
    ``scale = max(amax, 1e-6) / 127``, rounded half to even, clipped to
    +-127."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-6) / 127.0
    q8 = torch.round(xf / scale[..., None])
    return q8.clamp(-127, 127).to(torch.int8), scale


def _dequantize_kv(q8: torch.Tensor, scale: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    return (q8.float() * scale[..., None]).to(dtype)


#: each int8 K/V tensor's float32 scales, per (token, head)
_SCALE = {"k": "k_scale", "v": "v_scale", "k_pool": "k_scale_pool",
          "v_pool": "v_scale_pool"}


def _write_kv(cache: Dict, names: Tuple[str, str], index: Tuple,
              k: torch.Tensor, v: torch.Tensor) -> None:
    """Write k/v at ``index`` of the cache tensors ``names`` (the ring's
    ``("k", "v")`` or the pool's ``("k_pool", "v_pool")``), in place: cast
    to the cache dtype, or quantized into an int8 cache with its scales
    beside them (``k_scale``/``v_scale``, ``k_scale_pool``/
    ``v_scale_pool``)."""
    for name, x in zip(names, (k, v)):
        store = cache[name]
        if store.dtype == torch.int8:
            q8, scale = _quantize_kv(x)
            store[index] = q8
            cache[_SCALE[name]][index] = scale
        else:
            store[index] = x.to(store.dtype)


def _read_kv(cache: Dict, name: str, dtype: torch.dtype,
             read: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ring ``cache[name]`` (``read`` None), or the pool's blocks
    ``read`` [B, nbs] gathered in ring order as [B, nbs * bs, n_kv, hd];
    an int8 cache dequantized to ``dtype``."""
    store = cache[name]
    quant = store.dtype == torch.int8
    scale = cache[_SCALE[name]] if quant else None
    if read is not None:
        b = read.shape[0]
        store = store[read].reshape(b, -1, *store.shape[2:])
        if quant:
            scale = scale[read].reshape(b, -1, scale.shape[-1])
    return _dequantize_kv(store, scale, dtype) if quant else store


def _gathered(cache: Dict, nbs: int,
              dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference read of a paged cache: each slot's blocks gathered
    back in ring order ([B, C_pad, n_kv, hd], dequantized from an int8
    pool); unmapped entries read block 0, masked via ``key_pos == -1``."""
    read = cache["bt"][:, :nbs].clamp(min=0)
    return (_read_kv(cache, "k_pool", dtype, read),
            _read_kv(cache, "v_pool", dtype, read))


def prefill_cache(params: Dict, cfg: ModelConfig, spec: BlockSpec,
                  x: torch.Tensor, positions: torch.Tensor, cache: Dict,
                  impl: str = "ref") -> Tuple[torch.Tensor, Dict]:
    """Run prefill AND write k/v into the ring ``cache`` (in place).

    ``positions`` is [S] (batch-shared) or [B, S] (per-row, the masked
    left-padded prefill path).  Per-row positions may be *negative* at pad
    slots; those keys are masked out of the attention (``k_valid``) and
    written with ``key_pos == -1``, so pads never become valid cache keys.
    The cache ends with per-row ``key_pos [B, C]`` and ``pos [B]``; an int8
    ring holds the quantized k/v and their scales.  The prompt attends its
    own unquantized k/v, as in the reference.
    """
    _check_decode_impl(impl)       # "ref" and "cuda" prefill through _sdpa
    b, s = x.shape[:2]
    q, k, v = _project_qkv(params, cfg, x, positions)
    pos_b = positions if positions.dim() == 2 else positions[None].expand(b, s)
    valid = pos_b >= 0                                           # [B, S]
    out = _sdpa_for(impl)(cfg, spec, q, k, v, pos_b, pos_b, k_valid=valid)
    y = _out_proj(params, out)
    c = cache["k"].shape[1]
    k_tail, v_tail, pos_tail, valid_tail = k, v, pos_b, valid
    if s > c:               # sliding window: only the last c tokens survive
        k_tail, v_tail = k[:, -c:], v[:, -c:]
        pos_tail, valid_tail = pos_b[:, -c:], valid[:, -c:]
    # each row's tail positions are S' contiguous integers, so `% c` maps
    # them to distinct ring slots -- pad writes land on slots no valid token
    # occupies and are neutralized by key_pos == -1
    slots = pos_tail % c                                         # [B, S']
    rows = torch.arange(b, device=x.device)[:, None]
    cache["key_pos"][rows, slots] = torch.where(
        valid_tail, pos_tail, -1).to(torch.int32)
    cache["pos"].copy_(pos_b[:, -1] + 1)
    _write_kv(cache, ("k", "v"), (rows, slots), k_tail, v_tail)
    return y, cache


def extend_cache(params: Dict, cfg: ModelConfig, spec: BlockSpec,
                 x: torch.Tensor, positions: torch.Tensor,
                 seq_valid: torch.Tensor, cache: Dict, impl: str = "ref",
                 ) -> Tuple[torch.Tensor, Dict]:
    """Prefill a *continuation* against a **paged** ``cache`` that already
    holds keys for positions below ``positions`` (an adopted shared prefix
    and/or earlier chunks), writing the new k/v into the slot's blocks (in
    place).

    x [B, S, d]; positions [B, S] absolute, right-aligned payload (pads on
    the left, ``seq_valid`` False there).  Only valid where ring slot ==
    position (``kvcache.prefix_sharing_supported``), so a shared block is
    never rewritten.  Pad rows' writes go to the scratch block and their
    ``key_pos`` entries stay untouched, so a padded chunk is bit-for-bit the
    unpadded continuation.

    The chunk's k/v are scattered into the pool first, then attended
    through the block table with the chunk's own causal mask, so token i of
    the chunk sees the adopted prefix, all earlier chunks, and chunk tokens
    0..i.  Every impl reads by the same gather (dequantized from an int8
    pool), as the reference does under ``"pallas"`` (the paged kernel is
    decode-shaped); ``"chunked"`` attends it block by block.
    """
    _check_decode_impl(impl)
    b = x.shape[0]
    q, k, v = _project_qkv(params, cfg, x, positions)
    bt, key_pos = cache["bt"], cache["key_pos"]
    k_pool = cache["k_pool"]
    c_pad = key_pos.shape[-1]
    bsz = k_pool.shape[1]
    nbs = c_pad // bsz
    scratch = k_pool.shape[0] - 1

    # scatter the chunk into the slot's blocks (scratch for pads/unmapped)
    blk = (positions // bsz).clamp(0, nbs - 1).long()             # [B, S]
    off = (positions % bsz).long()
    phys = bt.gather(1, blk)                                      # [B, S]
    tgt = torch.where(seq_valid & (phys >= 0), phys, scratch).long()
    _write_kv(cache, ("k_pool", "v_pool"), (tgt, off), k, v)

    # ring slot == position: mark exactly this chunk's position range valid
    end = positions[:, -1]                                        # [B]
    lo = end + 1 - seq_valid.sum(dim=-1).to(end.dtype)            # chunk start
    iota = torch.arange(c_pad, dtype=key_pos.dtype, device=x.device)[None]
    in_chunk = (iota >= lo[:, None]) & (iota <= end[:, None])
    key_pos.copy_(torch.where(in_chunk, iota, key_pos))
    cache["pos"].copy_(end + 1)

    # attend through the table over the dense gather (prefix + chunk)
    ck, cv = _gathered(cache, nbs, k.dtype)
    out = _sdpa_for(impl)(cfg, spec, q, ck, cv, positions, key_pos,
                          k_valid=key_pos >= 0)
    return _out_proj(params, out), cache


def attend_decode(params: Dict, cfg: ModelConfig, spec: BlockSpec,
                  x: torch.Tensor, cache: Dict, impl: str = "ref",
                  ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode against the ring ``cache``. x: [B, 1, d].

    ``pos`` is per-row [B] and ``key_pos`` per-row [B, C]: every row writes
    its new k/v and position at ring slot ``pos % C`` first, then attends
    its own ring.  The ring, ``key_pos`` and ``pos`` update in place.  An
    int8 ring is dequantized whole and read like a bfloat16 one (by the
    ring kernel under ``"cuda"``, as the reference's ``"pallas"`` does).
    """
    _check_decode_impl(impl)
    b = x.shape[0]
    pos, key_pos = cache["pos"], cache["key_pos"]
    q, k, v = _project_qkv(params, cfg, x, pos[:, None])
    slot = (pos % key_pos.shape[1]).long()                       # [B]
    rows = torch.arange(b, device=x.device)
    _write_kv(cache, ("k", "v"), (rows, slot), k[:, 0], v[:, 0])
    key_pos[rows, slot] = pos
    ck = _read_kv(cache, "k", k.dtype)
    cv = _read_kv(cache, "v", v.dtype)
    if impl == "cuda":
        out = decode_attention(q, ck, cv, key_pos, pos, window=spec.window,
                               softcap=cfg.attn_logit_softcap)
        out = out.reshape(b, 1, cfg.q_dim)
    else:
        out = _sdpa(cfg, spec, q, ck, cv, pos[:, None], key_pos,
                    k_valid=key_pos >= 0)
    y = _out_proj(params, out)
    pos += 1
    return y, cache


def attend_decode_paged(params: Dict, cfg: ModelConfig, spec: BlockSpec,
                        x: torch.Tensor, cache: Dict, impl: str = "ref",
                        write_mask: Optional[torch.Tensor] = None,
                        ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode against a *paged* KV cache. x: [B, 1, d].

    ``cache`` holds the layer's shared block pool plus the slots' view of
    it (see :func:`repro_torch.models.kvcache.init_paged_block_cache`); each
    batch row is an independent slot at its own position ``pos [B]``.

    The new k/v are **scattered into the pool first**, then attended
    through the slot's block table, so the attended key set is
    element-for-element the contiguous ring's.  ``write_mask`` (bool [B])
    redirects masked rows' writes to the scratch block and freezes their
    ``key_pos``/``pos``, so idle slots never touch another slot's blocks.
    The pools, ``key_pos`` and ``pos`` update in place.  An int8 pool is
    read by the reference gather under every impl (see
    :func:`effective_decode_impl`).
    """
    _check_decode_impl(impl)
    b = x.shape[0]
    pos, bt, key_pos = cache["pos"], cache["bt"], cache["key_pos"]
    k_pool = cache["k_pool"]
    c_pad = key_pos.shape[-1]
    bsz = k_pool.shape[1]                             # tokens per block
    nbs = c_pad // bsz                                # this spec's table span
    scratch = k_pool.shape[0] - 1
    q, k, v = _project_qkv(params, cfg, x, pos[:, None])

    # scatter this token's k/v into its slot's current block (or scratch)
    ring = pos % c_pad                                            # [B]
    blk, off = ring // bsz, ring % bsz
    phys = bt.gather(1, blk[:, None].long())[:, 0]                # [B]
    tgt = torch.where(phys >= 0, phys, scratch)
    rows = torch.arange(b, device=x.device)
    live = torch.ones(b, dtype=torch.bool, device=x.device) \
        if write_mask is None else write_mask.to(torch.bool).expand(b)
    tgt = torch.where(live, tgt, scratch)
    _write_kv(cache, ("k_pool", "v_pool"), (tgt, off), k[:, 0], v[:, 0])
    key_pos[rows, ring] = torch.where(live, pos, key_pos[rows, ring])

    quant = cfg.kv_dtype == "int8"
    if impl == "cuda" and quant:
        _note_int8_paged_gather()
    if impl == "cuda" and not quant:
        out = paged_attention(q, k_pool, cache["v_pool"], bt, key_pos, pos,
                              window=spec.window,
                              softcap=cfg.attn_logit_softcap)
        out = out.reshape(b, 1, cfg.q_dim)
    else:
        ck, cv = _gathered(cache, nbs, k.dtype)
        out = _sdpa(cfg, spec, q, ck, cv, pos[:, None], key_pos,
                    k_valid=key_pos >= 0)
    y = _out_proj(params, out)
    pos += live.to(pos.dtype)
    return y, cache


def attend_verify_paged(params: Dict, cfg: ModelConfig, spec: BlockSpec,
                        x: torch.Tensor, lens: torch.Tensor, cache: Dict,
                        impl: str = "ref") -> Tuple[torch.Tensor, Dict]:
    """Multi-token speculative *verify* against a paged KV cache.

    x [B, K, d]: row ``b``'s first ``lens[b]`` tokens are the last accepted
    token plus its drafts, at positions ``pos[b] .. pos[b] + lens[b] - 1``.
    All K tokens are scattered into the pool first -- columns past
    ``lens[b]``, rows with ``lens == 0`` and unmapped blocks to the scratch
    block, with those ring slots keeping their previous ``key_pos`` -- then
    attended in one pass, query token ``i`` seeing keys up to ``pos + i``.
    ``pos`` advances by ``lens``.  Only valid where ring slot == position
    (``prefix_sharing_supported``), which makes the caller's rollback of
    rejected drafts exact.  ``impl="cuda"`` runs the paged attention kernel
    with K query tokens per slot; an int8 pool is read by the reference
    gather, with the warning of :func:`attend_decode_paged`.
    """
    _check_decode_impl(impl)
    b, kq = x.shape[:2]
    pos, bt, key_pos = cache["pos"], cache["bt"], cache["key_pos"]
    k_pool = cache["k_pool"]
    c_pad = key_pos.shape[-1]
    bsz = k_pool.shape[1]
    nbs = c_pad // bsz
    scratch = k_pool.shape[0] - 1
    cols = torch.arange(kq, dtype=pos.dtype, device=x.device)[None]
    positions = pos[:, None] + cols                                  # [B, K]
    valid = cols < lens[:, None]                                     # [B, K]
    q, k, v = _project_qkv(params, cfg, x, positions)

    ring = (positions % c_pad).long()
    blk = (ring // bsz).clamp(0, nbs - 1)
    off = ring % bsz
    phys = bt.gather(1, blk)                                         # [B, K]
    tgt = torch.where(valid & (phys >= 0), phys, scratch).long()
    _write_kv(cache, ("k_pool", "v_pool"), (tgt, off), k, v)
    rows = torch.arange(b, device=x.device)[:, None]
    key_pos[rows, ring] = torch.where(valid, positions, key_pos[rows, ring])

    quant = cfg.kv_dtype == "int8"
    if impl == "cuda" and quant:
        _note_int8_paged_gather()
    if impl == "cuda" and not quant:
        out = paged_attention(q, k_pool, cache["v_pool"], bt, key_pos, pos,
                              window=spec.window,
                              softcap=cfg.attn_logit_softcap)
        out = out.reshape(b, kq, cfg.q_dim)
    else:
        ck, cv = _gathered(cache, nbs, k.dtype)
        out = _sdpa(cfg, spec, q, ck, cv, positions, key_pos,
                    k_valid=key_pos >= 0)
    y = _out_proj(params, out)
    pos += lens.to(pos.dtype)
    return y, cache
