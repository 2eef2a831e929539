"""xLSTM-1.3B [arXiv:2405.04517].

SSM-family: 48 residual blocks, d_model=2048, 4 heads, vocab=50304 (GPT-NeoX
tokenizer), d_ff=0 (blocks carry their own up/down projections).
xLSTM[7:1] block ratio: every 8th block is sLSTM, the rest mLSTM.
"""
from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    arch_type="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50304,
    pattern=(
        BlockSpec(kind="mlstm", mlp="none"),
        BlockSpec(kind="mlstm", mlp="none"),
        BlockSpec(kind="mlstm", mlp="none"),
        BlockSpec(kind="mlstm", mlp="none"),
        BlockSpec(kind="mlstm", mlp="none"),
        BlockSpec(kind="mlstm", mlp="none"),
        BlockSpec(kind="mlstm", mlp="none"),
        BlockSpec(kind="slstm", mlp="none"),
    ),
    mlstm_proj_factor=2.0,
    slstm_proj_factor=4.0 / 3.0,
    pos_emb="none",
    norm="layernorm",
    tie_embeddings=False,
    citation="[arXiv:2405.04517]",
)
