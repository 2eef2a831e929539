"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).
Port of ``repro.models.rglru``.

Block structure (recurrent mixer, used in place of attention)::

    x -> [linear -> GeLU] ----------------\\
    x -> [linear -> causal conv1d -> RG-LRU] --*--> linear -> y

RG-LRU recurrence (per channel)::

    r_t = sigmoid(W_a x_t);  i_t = sigmoid(W_x x_t)
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Gates, ``log_a``, the multiplier and h are float32; the conv and the
``h * gelu_branch`` product run in the activation dtype, as in the
reference.  Sequence mode scans with ``impl="cuda"`` through the
:func:`repro_torch.kernels.rglru_scan.rglru_scan` kernel (its plain version
on CPU tensors) and with ``impl="ref"`` through :func:`rglru_scan`, a
log-depth doubling scan written in plain torch (the reference's associative
scan).  Decode is the O(1) single-step update in plain torch, as in the
reference.  The state (``h``, ``conv``, ``pos``) updates in place.

The mixer is diagonal in its channels, so under tensor parallelism
(:func:`repro_torch.sharding.rules.tensor_parallel`, ``rnn`` over
``model``) a process runs its own ``R / m`` channels end to end -- the
gate and input projections, the conv, the scan and its state -- its
input entering through ``model_copy`` and ``w_out``'s partial product
summed over the processes (``model_sum``, the reference's constraint
after ``w_out``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan import rglru_scan as rglru_scan_kernel
from repro_torch.models.attention import _check_decode_impl
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.rules import model_copy, model_sum

_C = 8.0  # Griffin's fixed scaling constant


def _log_a(params: Dict, gate_a: torch.Tensor) -> torch.Tensor:
    """log a_t = -c * softplus(lambda) * sigmoid(W_a x) (float32)."""
    r = torch.sigmoid(gate_a)
    return -_C * F.softplus(params["lam"].float()) * r


def _mult(log_a: torch.Tensor) -> torch.Tensor:
    """sqrt(1 - a_t^2), kept away from 0."""
    return torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))


def rglru_scan(log_a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor]) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1 by recursive doubling.

    log_a, b [B, S, R] float32 (b already holds sqrt(1-a^2) * i_t * x_t);
    h0 optional [B, R].  Step ``k`` combines every element with the one
    ``2**k`` before it, ``(a_l, b_l) . (a_r, b_r) = (a_l a_r, a_r b_l +
    b_r)``, so the scan takes ceil(log2 S) full-tensor steps.
    """
    a = torch.exp(log_a)
    if h0 is not None:
        b = b.clone()
        b[:, 0] += a[:, 0] * h0
    s, step = a.shape[1], 1
    while step < s:
        b = torch.cat([b[:, :step], a[:, step:] * b[:, :-step] + b[:, step:]],
                      dim=1)
        a = torch.cat([a[:, :step], a[:, :-step] * a[:, step:]], dim=1)
        step *= 2
    return b


def _causal_conv(params: Dict, x: torch.Tensor,
                 conv_state: Optional[torch.Tensor],
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d over [B, S, R]; returns (y, new_conv_state)."""
    w = params["conv_w"]                                        # [W, R]
    width = w.shape[0]
    if conv_state is None:
        pad = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                             # [B, W-1+S, R]
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(width))
    y = y + params["conv_b"]
    return y, xp[:, -(width - 1):]


def apply_rglru_seq(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                    state: Optional[Dict] = None, impl: str = "ref",
                    seq_valid: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Sequence mode. x: [B, S, d] -> (y [B, S, d], state or None).

    ``seq_valid`` ([B, S], masked left-padded prefill) turns pad steps into
    state-preserving no-ops: their conv input is zeroed (so the causal
    window over the first real tokens sees the same zeros as an unpadded
    fresh start) and the recurrence uses ``a = 1, b = 0`` (identity), so
    ``h`` at every real position depends only on real tokens.  ``state``
    (``h [B, R]`` float32, ``conv [B, W-1, R]``, ``pos [B]``) updates in
    place; ``pos`` advances by each row's real length.
    """
    _check_decode_impl(impl)
    x = model_copy(x, "rnn")
    gelu_branch = F.gelu(x @ params["w_gelu"], approximate="tanh")
    u = x @ params["w_rnn_in"]
    if seq_valid is not None:
        u = torch.where(seq_valid[..., None], u, 0)
    u, new_conv = _causal_conv(params, u,
                               state["conv"] if state is not None else None)
    gate_a = (x @ params["w_a"]).float()
    gate_x = (x @ params["w_x"]).float()
    log_a = _log_a(params, gate_a)
    i_t = torch.sigmoid(gate_x)
    b = _mult(log_a) * i_t * u.float()
    if seq_valid is not None:
        log_a = torch.where(seq_valid[..., None], log_a, 0.0)   # a_t = 1
        b = torch.where(seq_valid[..., None], b, 0.0)           # b_t = 0
    h0 = state["h"] if state is not None else None
    if impl == "cuda":
        h = rglru_scan_kernel(log_a, b, h0)
    else:
        h = rglru_scan(log_a, b, h0)
    y = model_sum((h.to(x.dtype) * gelu_branch) @ params["w_out"], "rnn")
    if state is None:
        return y, None
    n_real = x.shape[1] if seq_valid is None \
        else seq_valid.sum(dim=1).to(state["pos"].dtype)
    state["h"].copy_(h[:, -1])
    state["conv"].copy_(new_conv)
    state["pos"] += n_real
    return y, state


def apply_rglru_decode(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                       state: Dict) -> Tuple[torch.Tensor, Dict]:
    """Single-token decode. x: [B, 1, d]; ``state`` updates in place."""
    xt = model_copy(x[:, 0], "rnn")
    gelu_branch = F.gelu(xt @ params["w_gelu"], approximate="tanh")
    u = xt @ params["w_rnn_in"]                                  # [B, R]
    window = torch.cat([state["conv"].to(u.dtype), u[:, None]], dim=1)
    u_conv = torch.einsum("bwr,wr->br", window, params["conv_w"]) \
        + params["conv_b"]
    gate_a = (xt @ params["w_a"]).float()
    gate_x = (xt @ params["w_x"]).float()
    log_a = _log_a(params, gate_a)
    i_t = torch.sigmoid(gate_x)
    h = torch.exp(log_a) * state["h"] + _mult(log_a) * i_t * u_conv.float()
    y = model_sum((h.to(x.dtype) * gelu_branch) @ params["w_out"], "rnn")
    state["h"].copy_(h)
    state["conv"].copy_(window[:, 1:])
    state["pos"] += 1
    return y[:, None], state
