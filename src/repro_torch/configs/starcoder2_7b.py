"""StarCoder2-7B [arXiv:2402.19173].

Dense code model: 32L, d_model=4608, 36 heads GQA kv=4, d_ff=18432 (GELU),
vocab=49152, RoPE, layernorm, bias.
"""
from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    arch_type="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    pattern=(BlockSpec(kind="attn", mlp="gelu"),),
    qkv_bias=True,
    norm="layernorm",
    rope_theta=100_000.0,
    tie_embeddings=True,
    citation="[arXiv:2402.19173]",
)
