"""Llama2 7B / 13B / 70B — the paper's own benchmark models [arXiv:2307.09288].

Used by the paper-reproduction benchmarks (Table IV, Figs. 7-10).
"""
from repro_torch.models.config import BlockSpec, ModelConfig

LLAMA2_7B = ModelConfig(
    name="llama2-7b", arch_type="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=11008, vocab_size=32000,
    pattern=(BlockSpec(kind="attn", mlp="swiglu"),),
    tie_embeddings=False, citation="[arXiv:2307.09288]")

LLAMA2_13B = ModelConfig(
    name="llama2-13b", arch_type="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=40, head_dim=128,
    d_ff=13824, vocab_size=32000,
    pattern=(BlockSpec(kind="attn", mlp="swiglu"),),
    tie_embeddings=False, citation="[arXiv:2307.09288]")

LLAMA2_70B = ModelConfig(
    name="llama2-70b", arch_type="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=32000,
    pattern=(BlockSpec(kind="attn", mlp="swiglu"),),
    tie_embeddings=False, citation="[arXiv:2307.09288]")
