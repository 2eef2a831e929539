"""Model configuration system.

A :class:`ModelConfig` describes a decoder-only transformer-family model as a
repeating *pattern* of heterogeneous blocks (attention / RG-LRU / mLSTM /
sLSTM), which is what EdgeShard partitions layer-wise.  The same config object
drives:

- parameter init + forward pass (``models/transformer.py``),
- the analytic per-layer cost profile (``core/profile.py``),
- sharding rules (``sharding/rules.py``),
- the dry-run input specs (``launch/dryrun.py``).

A copy of ``repro.models.config`` kept by the port, which
imports nothing of ``repro``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Literal, Optional, Sequence, Tuple

BlockKind = Literal["attn", "rglru", "mlstm", "slstm"]
MlpKind = Literal["swiglu", "gelu", "none"]
PosEmb = Literal["rope", "sinusoidal", "none"]


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration (dropless, top-k routing)."""

    num_experts: int
    top_k: int
    d_expert: int                      # hidden width of each expert FFN
    num_shared_experts: int = 0        # always-on experts (Kimi-K2 style)
    router_jitter: float = 0.0
    load_balance_weight: float = 0.01  # aux loss coefficient (training)
    capacity_factor: float = 1.25      # EP dispatch slack (drops beyond)

    def __post_init__(self):
        assert 0 < self.top_k <= self.num_experts


@dataclass(frozen=True)
class BlockSpec:
    """One layer of the repeating pattern."""

    kind: BlockKind = "attn"
    # attention-only fields
    window: Optional[int] = None       # None = full causal; int = sliding window
    # feed-forward: "none" for xLSTM blocks (mixer contains its own projections)
    mlp: MlpKind = "swiglu"
    moe: Optional[MoEConfig] = None

    @property
    def is_attention(self) -> bool:
        return self.kind == "attn"

    @property
    def is_recurrent(self) -> bool:
        return self.kind in ("rglru", "mlstm", "slstm")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None     # default d_model // n_heads
    pattern: Tuple[BlockSpec, ...] = (BlockSpec(),)

    # attention details
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    pos_emb: PosEmb = "rope"
    rope_theta: float = 10000.0

    # recurrent details (RG-LRU / xLSTM)
    rnn_width: Optional[int] = None    # RG-LRU recurrent width (default ~1.5x d_model? griffin uses d_model)
    conv_width: int = 4                # temporal conv kernel in recurrent blocks
    mlstm_proj_factor: float = 2.0     # up-projection of mLSTM blocks
    slstm_proj_factor: float = 4.0 / 3.0

    # misc
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    post_norm: bool = False            # gemma2-style sandwich norm
    tie_embeddings: bool = True
    frontend: Optional[Literal["vision", "audio"]] = None
    dtype: str = "bfloat16"
    #: KV-cache storage dtype; "int8" enables the quantized cache (per-token,
    #: per-head absmax scales) — EXPERIMENTS.md §Perf-A next-lever variant.
    kv_dtype: str = "bfloat16"
    citation: str = ""

    # ------------------------------------------------------------------ #
    def __post_init__(self):
        assert self.n_heads % self.n_kv_heads == 0, "GQA requires heads % kv_heads == 0"
        assert self.n_layers >= 1

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.resolved_head_dim

    @property
    def rnn_dim(self) -> int:
        return self.rnn_width if self.rnn_width is not None else self.d_model

    # -- pattern expansion --------------------------------------------- #
    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_full_periods(self) -> int:
        return self.n_layers // self.period

    @property
    def tail(self) -> Tuple[BlockSpec, ...]:
        """Remainder blocks when n_layers is not a multiple of the period."""
        return self.pattern[: self.n_layers % self.period]

    def layer_specs(self) -> Tuple[BlockSpec, ...]:
        """BlockSpec of every layer, in order."""
        full = self.pattern * self.n_full_periods + self.tail
        assert len(full) == self.n_layers
        return full

    # -- parameter counting (used by the profiler & roofline) ----------- #
    def block_param_count(self, spec: BlockSpec) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        q, kv = self.q_dim, self.kv_dim
        n = 0
        if spec.kind == "attn":
            n += d * q + 2 * d * kv + q * d                # wq, wk, wv, wo
            if self.qkv_bias:
                n += q + 2 * kv
            if self.qk_norm:
                n += 2 * hd
            n += d                                          # pre-attn norm
            if self.post_norm:
                n += d
        elif spec.kind == "rglru":
            r = self.rnn_dim
            n += 2 * d * r + r * d                          # gelu/main in-proj, out-proj
            n += 2 * d * r                                  # RG-LRU a / input gate projections
            n += self.conv_width * r + r                    # temporal conv + bias
            n += r                                          # lambda
            n += d
        elif spec.kind == "mlstm":
            dp = int(self.d_model * self.mlstm_proj_factor)
            n += 2 * d * dp                                 # up-proj (main + gate)
            n += 3 * dp * dp                                # q,k,v projections at width dp
            n += 2 * dp                                     # input/forget gate (per-head)
            n += dp * d                                     # down-proj
            n += d
        elif spec.kind == "slstm":
            dp = int(self.d_model * self.slstm_proj_factor)
            n += 4 * d * d                                  # i,f,z,o recurrent cell projections
            n += 4 * d * d                                  # recurrent weights
            n += d * dp + dp * d                            # ffn-style up/down
            n += d
        # feed-forward
        if spec.moe is not None:
            m = spec.moe
            n += d * m.num_experts                          # router
            n += m.num_experts * 3 * d * m.d_expert         # swiglu experts
            n += m.num_shared_experts * 3 * d * m.d_expert
            n += d
        elif spec.mlp == "swiglu":
            n += 3 * d * self.d_ff + d
        elif spec.mlp == "gelu":                            # GeGLU: up+gate+down
            n += 3 * d * self.d_ff + d
        return n

    def param_count(self) -> int:
        n = self.vocab_size * self.d_model                  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        n += self.d_model                                   # final norm
        for spec in self.layer_specs():
            n += self.block_param_count(spec)
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        n = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        n += self.d_model
        for spec in self.layer_specs():
            if spec.moe is not None:
                m = spec.moe
                dense_equiv = dataclasses.replace(spec, moe=None, mlp="none")
                n += self.block_param_count(dense_equiv)
                n += self.d_model * m.num_experts
                n += (m.top_k + m.num_shared_experts) * 3 * self.d_model * m.d_expert
            else:
                n += self.block_param_count(spec)
        return n

    # -- convenience --------------------------------------------------- #
    def reduced(self, n_layers: int = 2, max_d_model: int = 256,
                max_experts: int = 4, vocab: int = 512) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests."""
        scale = min(1.0, max_d_model / self.d_model)
        d_model = max(32, int(self.d_model * scale)) // 16 * 16
        n_heads = max(1, min(self.n_heads, 4))
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        head_dim = max(8, d_model // n_heads)
        d_ff = max(16, int(self.d_ff * scale)) if self.d_ff else 0
        n_layers = max(n_layers, min(len(self.pattern), 4))

        def shrink(spec: BlockSpec) -> BlockSpec:
            moe = spec.moe
            if moe is not None:
                moe = dataclasses.replace(
                    moe, num_experts=min(moe.num_experts, max_experts),
                    top_k=min(moe.top_k, 2),
                    d_expert=max(16, int(moe.d_expert * scale)),
                    num_shared_experts=min(moe.num_shared_experts, 1),
                    capacity_factor=8.0)   # dropless at smoke-test scale
            window = spec.window
            if window is not None:
                window = min(window, 16)
            return dataclasses.replace(spec, moe=moe, window=window)

        pattern = tuple(shrink(s) for s in self.pattern)
        return dataclasses.replace(
            self, name=self.name + "-smoke", n_layers=n_layers, d_model=d_model,
            n_heads=n_heads, n_kv_heads=n_kv, head_dim=head_dim, d_ff=d_ff,
            vocab_size=vocab, pattern=pattern,
            rnn_width=d_model if self.rnn_width is not None else None,
            dtype="float32")


@dataclass(frozen=True)
class InputShape:
    """One of the assigned (seq_len, global_batch, phase) workloads."""

    name: str
    seq_len: int
    global_batch: int
    phase: Literal["train", "prefill", "decode"]

    @property
    def is_decode(self) -> bool:
        return self.phase == "decode"
