"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base].

Small MoE: 24L, d_model=1024, 16 heads GQA kv=8, 32 experts top-8 with
per-expert d_ff=512, vocab=49155.
"""
from repro_torch.models.config import BlockSpec, ModelConfig, MoEConfig

MOE = MoEConfig(num_experts=32, top_k=8, d_expert=512)

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    arch_type="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    pattern=(BlockSpec(kind="attn", mlp="swiglu", moe=MOE),),
    tie_embeddings=True,
    citation="[hf:ibm-granite/granite-3.0-1b-a400m-base]",
)
