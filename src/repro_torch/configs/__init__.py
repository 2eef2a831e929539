"""Config registry of the port: ``get_config("<arch-id>")``.

The port serves the dense attention decoders -- the paper's Llama2 family
and Qwen3-0.6B, the repo's smoke arch -- and the hybrid RecurrentGemma-2B
(RG-LRU + local attention).  The other architectures of ``repro.configs``
arrive with their mixers in later slices.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.models.config import ModelConfig

from .llama2 import LLAMA2_7B, LLAMA2_13B, LLAMA2_70B
from .qwen3_0_6b import CONFIG as QWEN3_06B
from .recurrentgemma_2b import CONFIG as RECURRENTGEMMA_2B

CONFIGS: Dict[str, ModelConfig] = {
    c.name: c for c in (QWEN3_06B, LLAMA2_7B, LLAMA2_13B, LLAMA2_70B,
                         RECURRENTGEMMA_2B)
}


def get_config(name: str) -> ModelConfig:
    try:
        return CONFIGS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; options: {sorted(CONFIGS)}"
                       ) from None
