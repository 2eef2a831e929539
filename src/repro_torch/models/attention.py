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

- ``"ref"``  -- the masked :func:`_sdpa` over the sequence, the ring, or
  the slot's blocks gathered in ring order (the reference's ``"xla"``
  path),
- ``"cuda"`` -- the hand-written kernels: the whole sequence through
  :func:`repro_torch.kernels.flash_attention.flash_attention`, the
  contiguous ring through
  :func:`repro_torch.kernels.decode_attention.decode_attention`, the paged
  pool through the block table with
  :func:`repro_torch.kernels.paged_attention.paged_attention`; on CPU
  tensors the wrappers run the kernels' plain versions.

Prefill and extend run :func:`_sdpa` under both impls, as the reference's
do.
Caches update in place (``index_put_``) where the reference rebuilt them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models.config import BlockSpec, ModelConfig
from repro_torch.models.layers import apply_rope, rms_norm_headwise, softcap

NEG_INF = -2.0 ** 30

#: implementations: "ref" (masked sdpa) and "cuda" (the flash, decode and
#: paged attention kernels)
DECODE_IMPLS = ("ref", "cuda")


def _check_decode_impl(impl: str) -> None:
    if impl not in DECODE_IMPLS:
        raise ValueError(
            f"unknown decode impl {impl!r}: expected one of {DECODE_IMPLS}")


def effective_decode_impl(impl: str, device: torch.device) -> str:
    """The decode read path that actually runs: ``"cuda"`` launches the
    kernel only on a GPU; on the CPU its wrapper runs the plain version,
    reported as ``"plain"``."""
    _check_decode_impl(impl)
    if impl == "cuda" and torch.device(device).type != "cuda":
        return "plain"
    return impl


def _project_qkv(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor,
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B,S,d] -> q [B,S,h,hd], k/v [B,S,n_kv,hd]; RoPE applied."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
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
    elif cfg.pos_emb != "none":
        raise ValueError(f"pos_emb={cfg.pos_emb!r} arrives in a later slice")
    return q, k, v


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


def attend_full(params: Dict, cfg: ModelConfig, spec: BlockSpec,
                x: torch.Tensor, positions: torch.Tensor, impl: str = "ref",
                ) -> torch.Tensor:
    """Causal attention over the whole sequence (train mode). x: [B, S, d];
    ``positions`` is ``arange(S)``, which the kernel assumes: it masks by
    index.  ``impl="cuda"`` runs the flash-attention kernel, which has no
    backward: with autograd on it raises for inputs that need gradients."""
    _check_decode_impl(impl)
    q, k, v = _project_qkv(params, cfg, x, positions)
    if impl == "cuda":
        out = flash_attention(q, k, v, window=spec.window,
                              softcap=cfg.attn_logit_softcap)
        out = out.reshape(*x.shape[:2], cfg.q_dim)
    else:
        out = _sdpa(cfg, spec, q, k, v, positions, positions)
    return out @ params["wo"]


def prefill_cache(params: Dict, cfg: ModelConfig, spec: BlockSpec,
                  x: torch.Tensor, positions: torch.Tensor, cache: Dict,
                  impl: str = "ref") -> Tuple[torch.Tensor, Dict]:
    """Run prefill AND write k/v into the ring ``cache`` (in place).

    ``positions`` is [S] (batch-shared) or [B, S] (per-row, the masked
    left-padded prefill path).  Per-row positions may be *negative* at pad
    slots; those keys are masked out of the attention (``k_valid``) and
    written with ``key_pos == -1``, so pads never become valid cache keys.
    The cache ends with per-row ``key_pos [B, C]`` and ``pos [B]``.
    """
    _check_decode_impl(impl)       # both impls prefill through _sdpa
    b, s = x.shape[:2]
    q, k, v = _project_qkv(params, cfg, x, positions)
    pos_b = positions if positions.dim() == 2 else positions[None].expand(b, s)
    valid = pos_b >= 0                                           # [B, S]
    out = _sdpa(cfg, spec, q, k, v, pos_b, pos_b, k_valid=valid)
    y = out @ params["wo"]
    c = cache["k"].shape[1]
    k_tail, v_tail, pos_tail, valid_tail = k, v, pos_b, valid
    if s > c:                   # sliding window: only the last c tokens survive
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
    cache["k"][rows, slots] = k_tail.to(cache["k"].dtype)
    cache["v"][rows, slots] = v_tail.to(cache["v"].dtype)
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
    0..i.  Both impls read by the same gather, as the reference does under
    ``"pallas"`` (the paged kernel is decode-shaped).
    """
    _check_decode_impl(impl)
    b = x.shape[0]
    q, k, v = _project_qkv(params, cfg, x, positions)
    bt, key_pos = cache["bt"], cache["key_pos"]
    k_pool, v_pool = cache["k_pool"], cache["v_pool"]
    c_pad = key_pos.shape[-1]
    bsz = k_pool.shape[1]
    nbs = c_pad // bsz
    scratch = k_pool.shape[0] - 1

    # scatter the chunk into the slot's blocks (scratch for pads/unmapped)
    blk = (positions // bsz).clamp(0, nbs - 1).long()             # [B, S]
    off = (positions % bsz).long()
    phys = bt.gather(1, blk)                                      # [B, S]
    tgt = torch.where(seq_valid & (phys >= 0), phys, scratch).long()
    k_pool[tgt, off] = k.to(k_pool.dtype)
    v_pool[tgt, off] = v.to(v_pool.dtype)

    # ring slot == position: mark exactly this chunk's position range valid
    end = positions[:, -1]                                        # [B]
    lo = end + 1 - seq_valid.sum(dim=-1).to(end.dtype)            # chunk start
    iota = torch.arange(c_pad, dtype=key_pos.dtype, device=x.device)[None]
    in_chunk = (iota >= lo[:, None]) & (iota <= end[:, None])
    key_pos.copy_(torch.where(in_chunk, iota, key_pos))
    cache["pos"].copy_(end + 1)

    # attend through the table over the dense gather (prefix + chunk)
    read = bt[:, :nbs].clamp(min=0)
    ck = k_pool[read].reshape(b, c_pad, cfg.n_kv_heads, -1)
    cv = v_pool[read].reshape(b, c_pad, cfg.n_kv_heads, -1)
    out = _sdpa(cfg, spec, q, ck, cv, positions, key_pos,
                k_valid=key_pos >= 0)
    return out @ params["wo"], cache


def attend_decode(params: Dict, cfg: ModelConfig, spec: BlockSpec,
                  x: torch.Tensor, cache: Dict, impl: str = "ref",
                  ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode against the ring ``cache``. x: [B, 1, d].

    ``pos`` is per-row [B] and ``key_pos`` per-row [B, C]: every row writes
    its new k/v and position at ring slot ``pos % C`` first, then attends
    its own ring.  The ring, ``key_pos`` and ``pos`` update in place.
    """
    _check_decode_impl(impl)
    b = x.shape[0]
    pos, key_pos = cache["pos"], cache["key_pos"]
    q, k, v = _project_qkv(params, cfg, x, pos[:, None])
    slot = (pos % key_pos.shape[1]).long()                       # [B]
    rows = torch.arange(b, device=x.device)
    cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
    key_pos[rows, slot] = pos
    if impl == "cuda":
        out = decode_attention(q, cache["k"], cache["v"], key_pos, pos,
                               window=spec.window,
                               softcap=cfg.attn_logit_softcap)
        out = out.reshape(b, 1, cfg.q_dim)
    else:
        out = _sdpa(cfg, spec, q, cache["k"], cache["v"], pos[:, None],
                    key_pos, k_valid=key_pos >= 0)
    y = out @ params["wo"]
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
    The pools, ``key_pos`` and ``pos`` update in place.
    """
    _check_decode_impl(impl)
    b = x.shape[0]
    pos, bt, key_pos = cache["pos"], cache["bt"], cache["key_pos"]
    k_pool, v_pool = cache["k_pool"], cache["v_pool"]
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
    k_pool[tgt, off] = k[:, 0].to(k_pool.dtype)
    v_pool[tgt, off] = v[:, 0].to(v_pool.dtype)
    key_pos[rows, ring] = torch.where(live, pos, key_pos[rows, ring])

    if impl == "cuda":
        out = paged_attention(q, k_pool, v_pool, bt, key_pos, pos,
                              window=spec.window,
                              softcap=cfg.attn_logit_softcap)
        out = out.reshape(b, 1, cfg.q_dim)
    else:
        # reference: gather the slot's blocks back in ring order
        # ([B, C_pad, n_kv, hd]); unmapped entries read block 0, masked via
        # key_pos == -1
        read = bt[:, :nbs].clamp(min=0)
        ck = k_pool[read].reshape(b, c_pad, cfg.n_kv_heads, -1)
        cv = v_pool[read].reshape(b, c_pad, cfg.n_kv_heads, -1)
        out = _sdpa(cfg, spec, q, ck, cv, pos[:, None], key_pos,
                    k_valid=key_pos >= 0)
    y = out @ params["wo"]
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
    with K query tokens per slot.
    """
    _check_decode_impl(impl)
    b, kq = x.shape[:2]
    pos, bt, key_pos = cache["pos"], cache["bt"], cache["key_pos"]
    k_pool, v_pool = cache["k_pool"], cache["v_pool"]
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
    k_pool[tgt, off] = k.to(k_pool.dtype)
    v_pool[tgt, off] = v.to(v_pool.dtype)
    rows = torch.arange(b, device=x.device)[:, None]
    key_pos[rows, ring] = torch.where(valid, positions, key_pos[rows, ring])

    if impl == "cuda":
        out = paged_attention(q, k_pool, v_pool, bt, key_pos, pos,
                              window=spec.window,
                              softcap=cfg.attn_logit_softcap)
        out = out.reshape(b, kq, cfg.q_dim)
    else:
        read = bt[:, :nbs].clamp(min=0)
        ck = k_pool[read].reshape(b, c_pad, cfg.n_kv_heads, -1)
        cv = v_pool[read].reshape(b, c_pad, cfg.n_kv_heads, -1)
        out = _sdpa(cfg, spec, q, ck, cv, positions, key_pos,
                    k_valid=key_pos >= 0)
    y = out @ params["wo"]
    pos += lens.to(pos.dtype)
    return y, cache
