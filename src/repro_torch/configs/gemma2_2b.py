"""Gemma2-2B [arXiv:2408.00118].

Dense, 26L, d_model=2304, 8 heads GQA kv=4, head_dim=256, d_ff=9216 (GeGLU),
vocab=256000.  Local(4096-window)/global alternating attention, attention and
final logit soft-capping, sandwich (pre+post) norms.

26 = 13 periods of (local, global).
"""
from repro_torch.models.config import BlockSpec, ModelConfig

WINDOW = 4096

CONFIG = ModelConfig(
    name="gemma2-2b",
    arch_type="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    pattern=(
        BlockSpec(kind="attn", window=WINDOW, mlp="gelu"),
        BlockSpec(kind="attn", window=None, mlp="gelu"),
    ),
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    post_norm=True,
    tie_embeddings=True,
    citation="[arXiv:2408.00118]",
)
