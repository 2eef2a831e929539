"""GQA attention on the serving path: qk-norm, bias, logit soft-capping,
sliding windows.  Port of the cache-writing entry points of
``repro.models.attention``:

- :func:`prefill_cache`       -- run prefill AND write k/v into a ring cache,
- :func:`attend_decode_paged` -- one token per slot against a paged cache.

Prefill supports *masked* left-padded batches: per-row positions [B, S]
hold negative values at pad slots, which are masked out of the softmax and
written with ``key_pos == -1``, so the output for real tokens (and every
later decode step) is independent of the padded width.

``impl`` selects how the paged cache is *read* at decode (unknown values
raise, as ``DECODE_IMPLS`` does in the reference):

- ``"ref"``  -- gather the slot's blocks in ring order and run the masked
  :func:`_sdpa` (the reference's ``"xla"`` path),
- ``"cuda"`` -- :func:`repro_torch.kernels.paged_attention.paged_attention`:
  the hand-written kernel reads the pool through the block table; on CPU
  tensors the wrapper runs the kernel's plain version.

Prefill runs :func:`_sdpa` under both impls, as the reference's does.
Caches update in place (``index_put_``) where the reference rebuilt them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models.config import BlockSpec, ModelConfig
from repro_torch.models.layers import apply_rope, rms_norm_headwise, softcap

NEG_INF = -2.0 ** 30

#: decode-path implementations: "ref" (gather + masked sdpa) and "cuda"
#: (the paged attention kernel)
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
