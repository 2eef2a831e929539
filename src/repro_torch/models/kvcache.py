"""Attention KV caches: the contiguous ring (prefill workspace) and the
paged block pool.  Port of the attention part of ``repro.models.kvcache``.

- ring:  k/v ``[B, C, n_kv, head_dim]`` (C = min(max_len, window)),
  ``key_pos [B, C]`` absolute position per ring slot (-1 = empty),
  ``pos [B]`` decode position -- both per-row, so one wave of
  length-bucketed (masked, left-padded) prefills can hold a different true
  length per sequence.
- paged: see :func:`init_paged_block_cache`.

Caches are plain dicts of tensors, one dict per layer.  Unlike the
reference's immutable pytrees, the port updates them in place.  Recurrent
state caches (RG-LRU, xLSTM) arrive with their mixers in a later slice.
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


def _check_attn(cfg: ModelConfig, spec: BlockSpec) -> None:
    if spec.kind != "attn":
        raise ValueError(
            f"{spec.kind!r} caches arrive with the recurrent-mixer slice; "
            f"this slice serves attention decoders only")
    if cfg.kv_dtype != "bfloat16":
        raise ValueError(
            f"kv_dtype={cfg.kv_dtype!r} (the int8 KV cache) arrives in a "
            f"later slice; this slice stores K/V in the cache dtype")


def init_paged_block_cache(cfg: ModelConfig, spec: BlockSpec, batch: int,
                           max_len: int, num_blocks: int,
                           block_size: int = DEFAULT_BLOCK_SIZE,
                           dtype: torch.dtype = torch.bfloat16,
                           device=None) -> Dict[str, torch.Tensor]:
    """Paged twin of :func:`init_block_cache` for one attention layer.

    - ``k_pool``/``v_pool`` ``[num_blocks+1, block_size, n_kv, head_dim]`` --
      the shared pool; the **last block is scratch**: writes whose block-table
      entry is unallocated (or whose slot is masked) are redirected there so
      they can never corrupt another slot's blocks,
    - ``bt`` ``[B, max_ctx_blocks]`` int32 physical block ids (-1 = unmapped),
    - ``key_pos`` ``[B, paged_cache_len]`` absolute position per ring slot
      (-1 = empty), per-slot like the contiguous layout,
    - ``pos`` ``[B]`` per-slot decode position.
    """
    _check_attn(cfg, spec)
    c = paged_cache_len(spec, max_len, block_size)
    nbs = max_ctx_blocks(cfg, max_len, block_size)
    shape = (num_blocks + 1, block_size, cfg.n_kv_heads, cfg.resolved_head_dim)
    i32 = dict(dtype=torch.int32, device=device)
    return {
        "bt": torch.full((batch, max(nbs, 1)), -1, **i32),
        "key_pos": torch.full((batch, c), -1, **i32),
        "pos": torch.zeros((batch,), **i32),
        "k_pool": torch.zeros(shape, dtype=dtype, device=device),
        "v_pool": torch.zeros(shape, dtype=dtype, device=device),
    }


def init_block_cache(cfg: ModelConfig, spec: BlockSpec, batch: int,
                     max_len: int, dtype: torch.dtype = torch.bfloat16,
                     device=None) -> Dict[str, torch.Tensor]:
    """Contiguous ring cache for one attention layer (the paged backend's
    prefill workspace, sized by the bucketed prompt length)."""
    _check_attn(cfg, spec)
    c = attn_cache_len(spec, max_len)
    shape = (batch, c, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "key_pos": torch.full((batch, c), -1, dtype=torch.int32,
                              device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
