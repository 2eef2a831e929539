"""Shared building blocks: norms, RoPE, sinusoidal positions, MLPs,
embeddings.

Port of ``repro.models.layers``.  Weights keep the reference's layout
(``x @ w`` with ``w [in, out]``) so bridged parameters need no transpose,
and every function keeps its reference's precision rule: norms and RoPE
compute in float32 and cast back to the input dtype.  In a
tensor-parallel process (:func:`repro_torch.sharding.rules.tensor_parallel`)
the MLP's down projection is summed over the processes that split ``ff``,
the embedding lookup over those that split the vocabulary, and the head's
columns are gathered from them; the MLP's and the head's inputs enter
their split regions through ``model_copy``, whose backward sums the
processes' shares of their gradients.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.sharding.rules import (model_copy, model_gather, model_sum,
                                        shard_start)

# --------------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------------- #


def apply_norm(params: Dict, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * params["scale"].float()
    elif kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * params["scale"].float() + params["bias"].float()
    else:
        raise ValueError(f"unknown norm {kind!r}")
    return y.to(x.dtype)


def rms_norm_headwise(scale: torch.Tensor, x: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    """qk-norm: RMSNorm over the head_dim axis of [..., head_dim]."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# --------------------------------------------------------------------------- #
# rotary position embeddings
# --------------------------------------------------------------------------- #

def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [seq] or [batch, seq]."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)             # [hd/2]
    angles = positions[..., None].float() * freqs                # [..., seq, hd/2]
    cos = torch.cos(angles)[..., None, :]                        # broadcast heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_embedding(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal position embeddings [..., dim] (sines, then cosines) of
    ``positions`` [...], in float32; callers cast to the activation
    dtype."""
    half = dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-math.log(10000.0) * idx / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------------------- #
# MLPs
# --------------------------------------------------------------------------- #

def apply_mlp(params: Dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "none":
        return torch.zeros_like(x)
    x = model_copy(x, "ff")
    up = x @ params["w_up"]
    gate = x @ params["w_gate"]
    if kind == "swiglu":
        act = F.silu(gate)
    elif kind == "gelu":
        act = F.gelu(gate, approximate="tanh")
    else:
        raise ValueError(f"unknown mlp {kind!r}")
    return model_sum((act * up) @ params["w_down"], "ff")


# --------------------------------------------------------------------------- #
# embeddings / head
# --------------------------------------------------------------------------- #

def embed_tokens(params: Dict, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Integer tokens -> embeddings (a frontend's float inputs take
    ``transformer._embed_inputs``).  Where the vocabulary is split, each
    process looks up the tokens in its rows (zero elsewhere) and the
    partial rows are summed."""
    emb = params["embedding"]
    start = shard_start("vocab", emb.shape[0])
    rows = emb[tokens] if start is None else \
        model_sum(embed_partial(emb, start, tokens), "vocab")
    return scale_embedding(cfg, rows)


def embed_partial(rows: torch.Tensor, base: int,
                  tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens`` that fall in a shard ``rows`` of
    the vocabulary (ids ``base ..``), zero elsewhere: summed over the
    shards they are the embedding."""
    n = rows.shape[0]
    ids = tokens - base
    inside = (ids >= 0) & (ids < n)
    got = rows[ids.clamp(0, n - 1)]
    return torch.where(inside[..., None], got, torch.zeros_like(got))


def scale_embedding(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Embedding rows as the first block takes them: gemma's scale by
    sqrt(d_model)."""
    if cfg.name.startswith("gemma") or cfg.name.startswith("recurrentgemma"):
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def lm_logits(params: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = model_copy(x, "vocab")
    if cfg.tie_embeddings:
        logits = x @ params["embedding"].T
    else:
        logits = x @ params["lm_head"]
    return model_gather(softcap(logits, cfg.final_logit_softcap), "vocab")
