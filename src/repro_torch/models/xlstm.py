"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, parallel in
sequence mode) and sLSTM (scalar memory, strictly sequential).  Port of
``repro.models.xlstm``.

mLSTM sequence mode uses the parallel, log-gate stabilized form; decode
uses the O(1) recurrent update.  The two are the same function::

    d_ts = F_t - F_s + log i_s,   F_t = sum_{j<=t} log f_j
    m_t  = max_s d_ts
    h_t  = [sum_s e^{d_ts - m_t} (q_t.k_s/sqrt(d)) v_s]
           / max(|sum_s e^{d_ts - m_t} q_t.k_s/sqrt(d)|, e^{-m_t})

The parallel form builds ``[B, S, S, h]`` float32 weights; the product
``w * qk`` is formed before the contraction with ``v``, so nothing of rank
5 is.  sLSTM runs exponential gating with the same stabilizer and
block-diagonal (per-head) recurrent weights; its sequence mode is a Python
loop over time (the reference's ``lax.scan``) whose input projections are
taken for every step at once before the loop.

Every state leaf is float32 whatever the model dtype, and the states
update in place, as the port's other caches do.

Under tensor parallelism (:func:`repro_torch.sharding.rules.tensor_parallel`)
the mLSTM splits by heads in Megatron's form: the up-projection ``u`` is
computed whole, each process projects its own heads' q, k, v, gates and
output gate from it (column blocks of ``wq``, ``wk``, ``wv``, ``w_gate``,
``w_i``, ``w_f``), runs their recurrence and state, and its rows of
``w_down`` give a partial output summed over the processes
(``model_sum``): one collective a layer.  The sLSTM's state is whole in
the reference, so its recurrence runs whole on every process; only its
up/down-projection splits, by ``ff``, with one sum.  Each block's input
enters its split region through ``model_copy``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.sharding.rules import model_copy, model_sum

_GATES = ("i", "f", "z", "o")

# --------------------------------------------------------------------------- #
# mLSTM
# --------------------------------------------------------------------------- #


def _mlstm_qkv_gates(params: Dict, cfg: ModelConfig, x: torch.Tensor):
    """x [B,S,d] -> q,k,v [B,S,h,hd], log_i/log_f [B,S,h] float32,
    gate [B,S,dp]."""
    b, s, _ = x.shape
    h = cfg.n_heads
    x = model_copy(x, "heads")
    u = x @ params["w_up"]
    gate = x @ params["w_gate"]
    q = (u @ params["wq"]).reshape(b, s, h, -1)
    k = (u @ params["wk"]).reshape(b, s, h, -1)
    v = (u @ params["wv"]).reshape(b, s, h, -1)
    log_i = F.logsigmoid((u @ params["w_i"] + params["b_i"]).float())
    log_f = F.logsigmoid((u @ params["w_f"] + params["b_f"]).float())
    return q, k, v, log_i, log_f, gate


def mlstm_parallel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   log_i: torch.Tensor, log_f: torch.Tensor,
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Parallel mLSTM. q/k/v [B,S,h,hd]; log gates [B,S,h] ->
    (h_out [B,S,h,hd] float32, m [B,S,h], F [B,S,h])."""
    s, hd = q.shape[1], q.shape[-1]
    cum = torch.cumsum(log_f, dim=1)                              # [B,S,h]
    dmat = cum[:, :, None] - cum[:, None] + log_i[:, None]        # [B,t,s,h]
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    dmat = dmat.masked_fill(~causal[None, :, :, None], float("-inf"))
    m = dmat.amax(dim=2)                                          # [B,t,h]
    w = torch.exp(dmat - m[:, :, None])
    del dmat
    qk = torch.einsum("bthd,bshd->btsh", q.float(), k.float()) * hd ** -0.5
    wqk = w * qk
    del w, qk
    num = torch.einsum("btsh,bshd->bthd", wqk, v.float())
    den = torch.maximum(wqk.sum(dim=2).abs(), torch.exp(-m))
    return num / den[..., None], m, cum


def apply_mlstm_seq(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                    state: Optional[Dict] = None,
                    seq_valid: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Sequence mode (train / prefill). x [B, S, d] -> (y, state or None).

    With ``state`` (``C [B,h,hd,hd]``, ``n [B,h,hd]``, ``m [B,h]``,
    ``pos [B]``) the final ``(C, n, m)`` is rebuilt in closed form from the
    parallel pass for the decode hand-off, in place.  ``seq_valid`` ([B,S],
    masked left-padded prefill) excludes pad steps: their input gate is
    forced to ~0 (``log i = -1e30``, an exact zero after the exp) and their
    forget gate to 1 (``log f = 0``), so the outputs at real positions and
    the handed-off state depend on real tokens only.
    """
    b, s, _ = x.shape
    q, k, v, log_i, log_f, gate = _mlstm_qkv_gates(params, cfg, x)
    if seq_valid is not None:
        log_i = torch.where(seq_valid[..., None], log_i, -1e30)
        log_f = torch.where(seq_valid[..., None], log_f, 0.0)
    hseq, m, cum = mlstm_parallel(q, k, v, log_i, log_f)
    hd = q.shape[-1]
    out = hseq.reshape(b, s, -1).to(x.dtype) * F.silu(gate)
    y = model_sum(out @ params["w_down"], "heads")
    if state is None:
        return y, None
    # C_S = sum_s exp(F_S - F_s + log i_s - m_S) k_s v_s^T
    m_last = m[:, -1]                                             # [B,h]
    wgt = torch.exp(cum[:, -1:] - cum + log_i - m_last[:, None])  # [B,S,h]
    kw = wgt[..., None] * (k.float() * hd ** -0.5)                # [B,S,h,hd]
    state["C"].copy_(torch.einsum("bshd,bshe->bhde", kw, v.float()))
    state["n"].copy_(kw.sum(dim=1))
    state["m"].copy_(m_last)
    n_real = s if seq_valid is None \
        else seq_valid.sum(dim=1).to(state["pos"].dtype)
    state["pos"] += n_real
    return y, state


def apply_mlstm_decode(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                       state: Dict) -> Tuple[torch.Tensor, Dict]:
    """One-token recurrent update. x [B, 1, d]; ``state`` updates in
    place."""
    b = x.shape[0]
    q, k, v, log_i, log_f, gate = _mlstm_qkv_gates(params, cfg, x)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                           # [B,h,hd]
    log_i, log_f, gate = log_i[:, 0], log_f[:, 0], gate[:, 0]
    hd = q.shape[-1]
    m_prev = state["m"]
    m_new = torch.maximum(log_f + m_prev, log_i)                  # [B,h]
    f_ = torch.exp(log_f + m_prev - m_new)
    i_ = torch.exp(log_i - m_new)
    kf = k.float() * hd ** -0.5
    c = f_[..., None, None] * state["C"] \
        + i_[..., None, None] * (kf[..., :, None] * v.float()[..., None, :])
    n = f_[..., None] * state["n"] + i_[..., None] * kf
    qf = q.float()
    num = torch.einsum("bhd,bhde->bhe", qf, c)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", qf, n).abs(),
                        torch.exp(-m_new))
    h = (num / den[..., None]).reshape(b, -1)
    y = model_sum((h.to(x.dtype) * F.silu(gate)) @ params["w_down"],
                  "heads")
    state["C"].copy_(c)
    state["n"].copy_(n)
    state["m"].copy_(m_new)
    state["pos"] += 1
    return y[:, None], state


# --------------------------------------------------------------------------- #
# sLSTM
# --------------------------------------------------------------------------- #

def _slstm_inputs(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """The input projections of the four gates for every step at once:
    x [B, S, d] -> [S, 4, B, d] in x's dtype (gates in ``_GATES``
    order)."""
    xw = torch.stack([x @ params[f"w_{g}"] for g in _GATES])     # [4,B,S,d]
    return xw.permute(2, 0, 1, 3)


def _slstm_step(params: Dict, carry: Tuple, xw: torch.Tensor,
                rec_w: torch.Tensor) -> Tuple[Tuple, torch.Tensor]:
    """One sLSTM step. carry: (c, n, h, m) each [B, d] float32; xw [4, B, d]
    the step's input projections; rec_w [4, h, dh, dh] float32 the
    recurrent weights (whose shape gives the head count: a tensor-parallel
    process's config counts its mLSTM heads)."""
    c, n, h, m = carry
    b = h.shape[0]
    heads = rec_w.shape[1]
    hh = h.reshape(b, heads, -1)
    rec = torch.einsum("bhd,ghde->gbhe", hh, rec_w).reshape(4, b, -1)
    pre = [(xw[j].float() + rec[j]) + params[f"b_{g}"].float()
           for j, g in enumerate(_GATES)]
    log_i = pre[0]                                    # exponential input gate
    log_f = F.logsigmoid(pre[1])
    z = torch.tanh(pre[2])
    o = torch.sigmoid(pre[3])
    m_new = torch.maximum(log_f + m, log_i)
    i_ = torch.exp(log_i - m_new)
    f_ = torch.exp(log_f + m - m_new)
    c_new = f_ * c + i_ * z
    n_new = f_ * n + i_
    h_new = o * (c_new / torch.clamp_min(n_new, 1e-6))
    return (c_new, n_new, h_new, m_new), h_new


def _rec_weights(params: Dict) -> torch.Tensor:
    return torch.stack([params[f"r_{g}"] for g in _GATES]).float()


def _slstm_out(params: Dict, hs: torch.Tensor) -> torch.Tensor:
    hs = model_copy(hs, "ff")
    return model_sum(F.gelu(hs @ params["w_up"], approximate="tanh")
                     @ params["w_down"], "ff")


def apply_slstm_seq(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                    state: Optional[Dict] = None,
                    seq_valid: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Sequence mode, a loop over time. x [B, S, d] -> (y, state or None).

    ``seq_valid`` ([B, S], masked left-padded prefill): pad steps carry the
    ``(c, n, h, m)`` state through unchanged, bit for bit, so the
    recurrence over real tokens is the unpadded run's.  ``state`` (``c``,
    ``n``, ``h``, ``m`` [B, d] float32, ``pos [B]``) updates in place.
    """
    b, s, d = x.shape
    if state is None:
        carry = tuple(torch.zeros((b, d), dtype=torch.float32,
                                  device=x.device) for _ in range(4))
    else:
        carry = (state["c"], state["n"], state["h"], state["m"])
    xw = _slstm_inputs(params, x)
    rec_w = _rec_weights(params)
    hs = []
    for t in range(s):
        new, ht = _slstm_step(params, carry, xw[t], rec_w)
        if seq_valid is not None:
            vt = seq_valid[:, t, None]
            new = tuple(torch.where(vt, a, old) for a, old in zip(new, carry))
        carry = new
        hs.append(ht)
    y = _slstm_out(params, torch.stack(hs, dim=1).to(x.dtype))
    if state is None:
        return y, None
    for key, t in zip(("c", "n", "h", "m"), carry):
        state[key].copy_(t)
    n_real = s if seq_valid is None \
        else seq_valid.sum(dim=1).to(state["pos"].dtype)
    state["pos"] += n_real
    return y, state


def apply_slstm_decode(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                       state: Dict) -> Tuple[torch.Tensor, Dict]:
    """One step. x [B, 1, d]; ``state`` updates in place."""
    carry = (state["c"], state["n"], state["h"], state["m"])
    new, ht = _slstm_step(params, carry, _slstm_inputs(params, x)[0],
                          _rec_weights(params))
    for key, t in zip(("c", "n", "h", "m"), new):
        state[key].copy_(t)
    state["pos"] += 1
    return _slstm_out(params, ht.to(x.dtype))[:, None], state
