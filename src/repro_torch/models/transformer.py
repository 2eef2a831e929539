"""Decoder-only transformer, dense attention path: prefill and paged decode.

Port of the serving entry points of ``repro.models.transformer``:

- :func:`forward`     -- ``mode="prefill"`` of the reference: logits over the
  (left-padded) prompt plus populated ring caches,
- :func:`decode_step` -- one token in, one logits row out, over paged caches.

Parameters are the reference's tree with the layer stack unrolled (see
:mod:`repro_torch.bridge`)::

    {"embedding": [V, d], "lm_head": [d, V] (untied only),
     "final_norm": {"scale": [d]}, "layers": [per-layer dict, ...]}

and caches are one dict per layer.  A Python loop over layers replaces the
reference's ``lax.scan`` over stacked parameters, and the caches update in
place (``index_put_``) where the reference rebuilt them.  Recurrent and MoE
blocks arrive with their mixers in later slices; the train mode with the
flash-attention slice.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models.config import BlockSpec, ModelConfig
from repro_torch.models.kvcache import (DEFAULT_BLOCK_SIZE, init_block_cache,
                                        init_paged_block_cache)
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_tokens,
                                       lm_logits)

Caches = List[Dict[str, torch.Tensor]]


def _check_block(spec: BlockSpec) -> None:
    if spec.kind != "attn" or spec.moe is not None:
        raise ValueError(
            f"block kind={spec.kind!r} moe={spec.moe is not None} arrives "
            f"with its mixer in a later slice; this slice runs dense "
            f"attention decoders")


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype: torch.dtype = torch.bfloat16, device=None) -> Caches:
    """Ring caches, one per layer (the paged backend's prefill workspace)."""
    return [init_block_cache(cfg, spec, batch, max_len, dtype, device)
            for spec in cfg.layer_specs()]


def init_paged_caches(cfg: ModelConfig, batch: int, max_len: int,
                      num_blocks: int, block_size: int = DEFAULT_BLOCK_SIZE,
                      dtype: torch.dtype = torch.bfloat16,
                      device=None) -> Caches:
    """Paged caches, one per layer: a block pool per layer plus per-slot
    block tables (``batch`` = slots)."""
    return [init_paged_block_cache(cfg, spec, batch, max_len, num_blocks,
                                   block_size, dtype, device)
            for spec in cfg.layer_specs()]


def _apply_block(cfg: ModelConfig, spec: BlockSpec, params: Dict,
                 x: torch.Tensor, positions: Optional[torch.Tensor], mode: str,
                 cache: Dict, impl: str,
                 write_mask: Optional[torch.Tensor] = None,
                 seq_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One block; ``cache`` updates in place.  ``seq_valid`` ([B, S],
    masked prefill) re-zeroes pad activations on exit so they cannot leak
    into later layers."""
    _check_block(spec)
    h = apply_norm(params["norm1"], x, cfg.norm)
    if mode == "prefill":
        mix, _ = attn.prefill_cache(params["mixer"], cfg, spec, h, positions,
                                    cache, impl)
    elif mode == "decode":
        mix, _ = attn.attend_decode_paged(params["mixer"], cfg, spec, h,
                                          cache, impl, write_mask=write_mask)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    if cfg.post_norm:
        mix = apply_norm(params["post_norm1"], mix, cfg.norm)
    x = x + mix
    if spec.mlp != "none":
        ffn = apply_mlp(params["ffn"], apply_norm(params["norm2"], x, cfg.norm),
                        spec.mlp)
        if cfg.post_norm:
            ffn = apply_norm(params["post_norm2"], ffn, cfg.norm)
        x = x + ffn
    if seq_valid is not None:
        x = torch.where(seq_valid[..., None], x, 0)
    return x


def forward(cfg: ModelConfig, params: Dict, inputs: torch.Tensor,
            caches: Caches, *, prompt_lens: Optional[torch.Tensor] = None,
            impl: str = "ref") -> Tuple[torch.Tensor, Caches]:
    """Prefill: inputs [B, S] int tokens -> (logits [B, S, vocab], caches).

    ``prompt_lens`` ([B] int) marks inputs as *left-padded* to S with true
    lengths ``prompt_lens[b]``: positions become per-row
    (``s - (S - plen)``; negative at pads), pad keys are masked out of
    attention and written with ``key_pos == -1``, and pad activations are
    zeroed between blocks -- so logits at real positions and the resulting
    caches are independent of the padded width.
    """
    b, s = inputs.shape[:2]
    cols = torch.arange(s, dtype=torch.int32, device=inputs.device)
    if prompt_lens is None:
        positions, seq_valid = cols, None
    else:
        plen = prompt_lens.to(device=inputs.device, dtype=torch.int32)
        positions = cols[None] - (s - plen)[:, None]                 # [B, S]
        seq_valid = positions >= 0
    x = embed_tokens(params, cfg, inputs)
    if seq_valid is not None:
        x = torch.where(seq_valid[..., None], x, 0)
    for spec, p, cache in zip(cfg.layer_specs(), params["layers"], caches):
        x = _apply_block(cfg, spec, p, x, positions, "prefill", cache, impl,
                         seq_valid=seq_valid)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return lm_logits(params, cfg, x), caches


def decode_step(cfg: ModelConfig, params: Dict, inputs: torch.Tensor,
                caches: Caches, impl: str = "ref",
                write_mask: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Caches]:
    """One decode step over paged caches. inputs: [B] int tokens.

    Returns (logits [B, vocab], caches).  Every slot decodes at its own
    ``pos``; ``write_mask [B]`` freezes masked slots (their writes go to the
    scratch block).  ``impl="cuda"`` reads the pools with the paged
    attention kernel; unknown impls raise.
    """
    x = embed_tokens(params, cfg, inputs[:, None])
    for spec, p, cache in zip(cfg.layer_specs(), params["layers"], caches):
        x = _apply_block(cfg, spec, p, x, None, "decode", cache, impl,
                         write_mask=write_mask)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return lm_logits(params, cfg, x)[:, 0], caches
