"""Qwen1.5-32B [hf:Qwen/Qwen1.5-0.5B family card].

Dense, 64L, d_model=5120, 40 heads GQA kv=40 (i.e. MHA), d_ff=27392,
vocab=152064, QKV bias (Qwen1.5 signature), RoPE.
"""
from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    arch_type="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab_size=152064,
    pattern=(BlockSpec(kind="attn", mlp="swiglu"),),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    citation="[hf:Qwen/Qwen1.5-0.5B]",
)
