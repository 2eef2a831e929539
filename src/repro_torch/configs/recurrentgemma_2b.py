"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427].

Hybrid: RG-LRU recurrent blocks + local (sliding-window) attention, pattern
(recurrent, recurrent, local-attn) i.e. attention:recurrent = 1:2.
26L, d_model=2560, 10 heads GQA kv=1 (MQA), head_dim=256, d_ff=7680
(GeGLU), vocab=256000, window 2048, RNN width 2560.

26 = 8 full periods of 3 + a 2-block recurrent tail (handled natively by the
pattern machinery).
"""
from repro_torch.models.config import BlockSpec, ModelConfig

WINDOW = 2048

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    arch_type="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    pattern=(
        BlockSpec(kind="rglru", mlp="gelu"),
        BlockSpec(kind="rglru", mlp="gelu"),
        BlockSpec(kind="attn", window=WINDOW, mlp="gelu"),
    ),
    rnn_width=2560,
    conv_width=4,
    pos_emb="rope",
    tie_embeddings=True,
    citation="[arXiv:2402.19427]",
)
