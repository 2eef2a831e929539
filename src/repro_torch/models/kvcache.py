"""Attention KV caches: the contiguous ring (prefill workspace) and the
paged block pool.  Port of the attention part of ``repro.models.kvcache``.

- ring:  k/v ``[B, C, n_kv, head_dim]`` (C = min(max_len, window)),
  ``key_pos [B, C]`` absolute position per ring slot (-1 = empty),
  ``pos [B]`` decode position -- both per-row, so one wave of
  length-bucketed (masked, left-padded) prefills can hold a different true
  length per sequence.
- paged: see :func:`init_paged_block_cache`.
- int8 (``cfg.kv_dtype == "int8"``): the ring's k/v and the pool's
  ``k_pool``/``v_pool`` are int8, with float32 absmax scales per (token,
  head) beside them: ``k_scale``/``v_scale [B, C, n_kv]`` on the ring,
  ``k_scale_pool``/``v_scale_pool [NB+1, bs, n_kv]`` on the pool.

- rglru: the RG-LRU block's dense state, ``h [B, R]`` float32 whatever
  the cache dtype, ``conv [B, W-1, R]`` (the causal conv's last inputs) in
  the cache dtype, and ``pos [B]``.
- mlstm: the matrix memory ``C [B, h, hd, hd]``, its normalizer ``n [B, h,
  hd]`` and stabilizer ``m [B, h]``, float32 whatever the cache dtype, and
  ``pos [B]``.
- slstm: ``c``, ``n``, ``h``, ``m`` ``[B, d]`` float32, and ``pos [B]``.

A tensor-parallel process's config (``sharding.rules.local_config``)
counts its own RG-LRU channels ``R`` and mLSTM heads ``h`` (the head
width ``hd`` whole), so its caches hold its share of that state; the
sLSTM's state is whole on every process.

Caches are plain dicts of tensors, one dict per layer.  Unlike the
reference's immutable pytrees, the port updates them in place.  In the
paged layout only attention layers page: recurrent layers (a hybrid's
RG-LRU, the xLSTM blocks) keep their dense per-slot state beside the pools
(``init_paged_caches``).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.config import BlockSpec, ModelConfig

#: vLLM-style paging granularity: tokens per KV block.
DEFAULT_BLOCK_SIZE = 16


def attn_cache_len(spec: BlockSpec, max_len: int) -> int:
    """Ring-buffer length for one attention spec.

    Windowed specs clamp to ``max_len`` -- a window larger than the serving
    length degenerates to full attention and must be *accounted* at the
    clamped length too (paged pools and ``cache_bytes_per_slot`` both size
    from this value, so they always agree).
    """
    return min(max_len, spec.window) if spec.window else max_len


def paged_cache_len(spec: BlockSpec, max_len: int,
                    block_size: int = DEFAULT_BLOCK_SIZE) -> int:
    """`attn_cache_len` rounded up to whole blocks (the gathered width).

    Positions ``attn_cache_len .. paged_cache_len-1`` are never written and
    stay masked via ``key_pos == -1``.
    """
    c = attn_cache_len(spec, max_len)
    return -(-c // block_size) * block_size


def max_ctx_blocks(cfg: ModelConfig, max_len: int,
                   block_size: int = DEFAULT_BLOCK_SIZE) -> int:
    """Most blocks one slot can hold = blocks of the largest (clamped)
    attention cache across the pattern + tail.  0 for attention-free models."""
    specs = [s for s in cfg.layer_specs() if s.kind == "attn"]
    if not specs:
        return 0
    return max(-(-attn_cache_len(s, max_len) // block_size) for s in specs)


def prefix_sharing_supported(cfg: ModelConfig, max_len: int) -> bool:
    """True when every layer's cache is position-addressed with no eviction
    -- the precondition for shared-prefix KV reuse and chunked prefill.

    Requires all-attention layers with no *effective* sliding window at
    this serving length (a windowed ring wraps, so a shared block would be
    overwritten in place -- a copy-on-write violation).
    """
    specs = list(cfg.layer_specs())
    return bool(specs) and all(
        s.kind == "attn" and attn_cache_len(s, max_len) == max_len
        for s in specs)


def block_pool_bytes_per_block(cfg: ModelConfig,
                               dtype: torch.dtype = torch.bfloat16) -> int:
    """Bytes one logical block occupies summed over every attention layer
    (each layer materializes the block id space in its own pool)."""
    hd, nkv = cfg.resolved_head_dim, cfg.n_kv_heads
    if cfg.kv_dtype == "int8":
        per_tok = 2 * nkv * hd * 1 + 2 * nkv * 4        # k/v int8 + scales
    else:
        per_tok = 2 * nkv * hd * dtype.itemsize
    n_attn = sum(1 for s in cfg.layer_specs() if s.kind == "attn")
    return per_tok * n_attn


#: ``ModelConfig.kv_dtype`` values: K/V in the cache dtype, or int8 with
#: per-(token, head) scales
KV_DTYPES = ("bfloat16", "int8")


def _check_kv_dtype(cfg: ModelConfig) -> None:
    if cfg.kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype={cfg.kv_dtype!r}: expected one of "
                         f"{KV_DTYPES}")


def _kv_tensors(cfg: ModelConfig, lead, dtype: torch.dtype, device,
                pool: bool) -> Dict[str, torch.Tensor]:
    """Zeroed k/v of shape ``lead + (n_kv, head_dim)`` in ``dtype``, or
    int8 with float32 scales ``lead + (n_kv,)`` for an int8 cache; named
    for the ring, or for the pool with ``pool``."""
    _check_kv_dtype(cfg)
    nkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    quant = cfg.kv_dtype == "int8"
    sfx = "_pool" if pool else ""
    out = {f"{n}{sfx}": torch.zeros((*lead, nkv, hd), device=device,
                                    dtype=torch.int8 if quant else dtype)
           for n in ("k", "v")}
    if quant:
        out.update({f"{n}_scale{sfx}": torch.zeros(
            (*lead, nkv), dtype=torch.float32, device=device)
            for n in ("k", "v")})
    return out


def init_paged_block_cache(cfg: ModelConfig, spec: BlockSpec, batch: int,
                           max_len: int, num_blocks: int,
                           block_size: int = DEFAULT_BLOCK_SIZE,
                           dtype: torch.dtype = torch.bfloat16,
                           device=None) -> Dict[str, torch.Tensor]:
    """Paged twin of :func:`init_block_cache` for ``spec.kind == "attn"``
    (non-attention kinds keep their dense cache: :func:`init_block_cache`).

    - ``k_pool``/``v_pool`` ``[num_blocks+1, block_size, n_kv, head_dim]`` --
      the shared pool; the **last block is scratch**: writes whose block-table
      entry is unallocated (or whose slot is masked) are redirected there so
      they can never corrupt another slot's blocks,
    - ``bt`` ``[B, max_ctx_blocks]`` int32 physical block ids (-1 = unmapped),
    - ``key_pos`` ``[B, paged_cache_len]`` absolute position per ring slot
      (-1 = empty), per-slot like the contiguous layout,
    - ``pos`` ``[B]`` per-slot decode position,
    - an int8 cache: int8 pools and ``k_scale_pool``/``v_scale_pool``
      ``[num_blocks+1, block_size, n_kv]`` float32.
    """
    if spec.kind != "attn":
        raise ValueError(f"a paged {spec.kind!r} cache: only attention "
                         f"layers page; a {spec.kind!r} layer keeps its "
                         f"dense state (init_block_cache)")
    c = paged_cache_len(spec, max_len, block_size)
    nbs = max_ctx_blocks(cfg, max_len, block_size)
    i32 = dict(dtype=torch.int32, device=device)
    return {
        "bt": torch.full((batch, max(nbs, 1)), -1, **i32),
        "key_pos": torch.full((batch, c), -1, **i32),
        "pos": torch.zeros((batch,), **i32),
        **_kv_tensors(cfg, (num_blocks + 1, block_size), dtype, device,
                      pool=True),
    }


def init_block_cache(cfg: ModelConfig, spec: BlockSpec, batch: int,
                     max_len: int, dtype: torch.dtype = torch.bfloat16,
                     device=None) -> Dict[str, torch.Tensor]:
    """Contiguous cache for one layer: the attention ring (also the paged
    backend's prefill workspace, sized by the bucketed prompt length) or a
    recurrent block's state."""
    f32 = dict(dtype=torch.float32, device=device)
    pos = torch.zeros((batch,), dtype=torch.int32, device=device)
    if spec.kind == "rglru":
        r = cfg.rnn_dim
        return {
            "h": torch.zeros((batch, r), **f32),
            "conv": torch.zeros((batch, cfg.conv_width - 1, r), dtype=dtype,
                                device=device),
            "pos": pos,
        }
    if spec.kind == "mlstm":
        h = cfg.n_heads
        hd = int(cfg.d_model * cfg.mlstm_proj_factor) // h
        return {"C": torch.zeros((batch, h, hd, hd), **f32),
                "n": torch.zeros((batch, h, hd), **f32),
                "m": torch.zeros((batch, h), **f32), "pos": pos}
    if spec.kind == "slstm":
        d = cfg.d_model
        return {**{k: torch.zeros((batch, d), **f32)
                   for k in ("c", "n", "h", "m")}, "pos": pos}
    if spec.kind != "attn":
        raise ValueError(f"unknown block kind {spec.kind!r}")
    c = attn_cache_len(spec, max_len)
    return {
        **_kv_tensors(cfg, (batch, c), dtype, device, pool=False),
        "key_pos": torch.full((batch, c), -1, dtype=torch.int32,
                              device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
