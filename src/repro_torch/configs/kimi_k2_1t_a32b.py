"""Kimi-K2 1T-A32B (paper-table config) [arXiv:2501.kimi2].

Trillion-parameter MoE: 61L, d_model=7168, 64 heads GQA kv=8, per-expert
d_ff=2048, 384 experts top-8 + 1 shared expert, vocab=163840.
"""
from repro_torch.models.config import BlockSpec, ModelConfig, MoEConfig

MOE = MoEConfig(num_experts=384, top_k=8, d_expert=2048, num_shared_experts=1)

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    arch_type="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    vocab_size=163840,
    pattern=(BlockSpec(kind="attn", mlp="swiglu", moe=MOE),),
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    citation="[arXiv:2501.kimi2]",
)
