"""MusicGen-Large [arXiv:2306.05284].

Audio decoder-only transformer over EnCodec tokens: 48L, d_model=2048,
32 heads (MHA: kv=32), d_ff=8192 (GELU), vocab=2048 (codebook size),
sinusoidal positions.  The EnCodec conv codec is a STUB frontend -- the model
consumes precomputed frame embeddings / audio-token ids.
"""
from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    arch_type="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    pattern=(BlockSpec(kind="attn", mlp="gelu"),),
    pos_emb="sinusoidal",
    norm="layernorm",
    tie_embeddings=False,
    frontend="audio",
    citation="[arXiv:2306.05284]",
)
