"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409].

VLM: pixtral-ViT vision encoder (STUB frontend -> patch embeddings) feeding a
mistral-nemo style decoder: 40L, d_model=5120, 32 heads GQA kv=8,
head_dim=128, d_ff=14336, vocab=131072.
"""
from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    arch_type="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    pattern=(BlockSpec(kind="attn", mlp="swiglu"),),
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    frontend="vision",
    citation="[hf:mistralai/Pixtral-12B-2409]",
)
