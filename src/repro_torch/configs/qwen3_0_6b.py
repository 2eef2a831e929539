"""Qwen3-0.6B [hf:Qwen/Qwen3-8B family card].

Dense, 28L, d_model=1024, 16 query heads with GQA kv=8, head_dim=128
(Qwen3 uses decoupled head_dim), d_ff=3072, vocab=151936, qk_norm, RoPE.
"""
from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    arch_type="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    pattern=(BlockSpec(kind="attn", mlp="swiglu"),),
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    citation="[hf:Qwen/Qwen3-8B]",
)
