"""Config registry of the port: ``get_config("<arch-id>")`` and the
input-shape table.

The registry is the reference's: the dense attention decoders (the
paper's Llama2 family, Qwen3-0.6B -- the repo's smoke arch --, Gemma2-2B,
StarCoder2-7B, Qwen1.5-32B and Pixtral-12B's decoder, on tokens or its
vision stub's embeddings), MusicGen-Large (sinusoidal positions, audio
tokens or its EnCodec stub's embeddings), the hybrid RecurrentGemma-2B
(RG-LRU + local attention), the mixture-of-experts decoders
Granite-MoE-1B-A400M and Kimi-K2-1T-A32B, and the attention-free
xLSTM-1.3B (mLSTM + sLSTM).

Variants: ``get_config("qwen3-0.6b", variant="swa")`` applies a documented
override (sliding-window attention for long-context decode; the int8 KV
cache), keeping the base configs exactly as assigned.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.models.config import ModelConfig

from .gemma2_2b import CONFIG as GEMMA2_2B
from .granite_moe_1b_a400m import CONFIG as GRANITE_MOE
from .kimi_k2_1t_a32b import CONFIG as KIMI_K2
from .llama2 import LLAMA2_7B, LLAMA2_13B, LLAMA2_70B
from .musicgen_large import CONFIG as MUSICGEN_LARGE
from .pixtral_12b import CONFIG as PIXTRAL_12B
from .qwen1_5_32b import CONFIG as QWEN15_32B
from .qwen3_0_6b import CONFIG as QWEN3_06B
from .recurrentgemma_2b import CONFIG as RECURRENTGEMMA_2B
from .shapes import SHAPES, get_shape  # noqa: F401
from .starcoder2_7b import CONFIG as STARCODER2_7B
from .xlstm_1_3b import CONFIG as XLSTM_13B

ASSIGNED: Dict[str, ModelConfig] = {
    c.name: c
    for c in (
        QWEN3_06B, QWEN15_32B, PIXTRAL_12B, RECURRENTGEMMA_2B, XLSTM_13B,
        STARCODER2_7B, KIMI_K2, GRANITE_MOE, MUSICGEN_LARGE, GEMMA2_2B,
    )
}

PAPER_MODELS: Dict[str, ModelConfig] = {
    c.name: c for c in (LLAMA2_7B, LLAMA2_13B, LLAMA2_70B)
}

CONFIGS: Dict[str, ModelConfig] = {**ASSIGNED, **PAPER_MODELS}

#: sliding window used by the documented `swa` long-context variant
SWA_WINDOW = 8192


def apply_variant(cfg: ModelConfig, variant: str) -> ModelConfig:
    if variant == "swa":
        # sliding-window override for long-context decode on full-attention
        # archs; recurrent/local blocks are untouched.
        pattern = tuple(
            dataclasses.replace(s, window=SWA_WINDOW)
            if s.kind == "attn" and s.window is None else s
            for s in cfg.pattern
        )
        return dataclasses.replace(cfg, name=cfg.name + "+swa", pattern=pattern)
    if variant == "kvint8":
        # int8 KV cache with per-(token, head) absmax scales
        return dataclasses.replace(cfg, name=cfg.name + "+kvint8",
                                   kv_dtype="int8")
    if variant == "swa+kvint8":
        return apply_variant(apply_variant(cfg, "swa"), "kvint8")
    raise KeyError(f"unknown variant {variant!r}")


def get_config(name: str, variant: Optional[str] = None) -> ModelConfig:
    try:
        cfg = CONFIGS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; options: {sorted(CONFIGS)}"
                       ) from None
    if variant:
        cfg = apply_variant(cfg, variant)
    return cfg
