"""Shared building blocks: norms, RoPE, sinusoidal positions, MLPs,
embeddings.

Port of ``repro.models.layers``.  Weights keep the reference's layout
(``x @ w`` with ``w [in, out]``) so bridged parameters need no transpose,
and every function keeps its reference's precision rule: norms and RoPE
compute in float32 and cast back to the input dtype.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

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
    up = x @ params["w_up"]
    gate = x @ params["w_gate"]
    if kind == "swiglu":
        act = F.silu(gate)
    elif kind == "gelu":
        act = F.gelu(gate, approximate="tanh")
    else:
        raise ValueError(f"unknown mlp {kind!r}")
    return (act * up) @ params["w_down"]


# --------------------------------------------------------------------------- #
# embeddings / head
# --------------------------------------------------------------------------- #

def embed_tokens(params: Dict, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Integer tokens -> embeddings (a frontend's float inputs take
    ``transformer._embed_inputs``)."""
    x = params["embedding"][tokens]
    if cfg.name.startswith("gemma") or cfg.name.startswith("recurrentgemma"):
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def lm_logits(params: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ params["embedding"].T
    else:
        logits = x @ params["lm_head"]
    return softcap(logits, cfg.final_logit_softcap)
