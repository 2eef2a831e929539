"""Mixture-of-experts FFN: a top-k router and a dropless grouped SwiGLU.
Port of the single-device engine of ``repro.models.moe``.

``moe_ragged`` sorts the ``T * k`` (token, expert) assignments by expert
and runs each expert's SwiGLU over its contiguous slice of the sorted rows:
one ``torch.matmul`` per weight matrix and expert that holds tokens, where
the reference runs one ``jax.lax.ragged_dot`` per weight matrix.  The slice
bounds are the group sizes, which the host reads once a layer call
(:func:`_group_sizes`, one device-to-host copy that waits for the card).
The reference's expert-parallel engine (``moe_ep``:
capacity buckets exchanged with ``all_to_all`` over a mesh) is not ported:
on one device the reference takes ``moe_ragged`` too.

Precision follows the reference: the router's softmax, top-k and aux loss
run in float32, the combine weights are cast back to the activation dtype,
and the expert products run in the weights' dtype.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig, MoEConfig


def router_topk(router_w: torch.Tensor, x: torch.Tensor, moe: MoEConfig,
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [T, d] -> (probs [T, k] in x's dtype, expert ids [T, k], the
    Switch load-balance aux loss, a float32 scalar)."""
    logits = (x @ router_w).float()                              # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, moe.top_k, dim=-1)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    e = moe.num_experts
    density = F.one_hot(top_i[:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(density * probs.mean(dim=0))
    return top_p.to(x.dtype), top_i, aux


def _group_sizes(flat_ids: torch.Tensor, e: int) -> List[int]:
    """Rows a group for each of the ``e`` experts, read on the host."""
    return torch.bincount(flat_ids, minlength=e).tolist()


def _expert_ffn(params: Dict, xs: torch.Tensor,
                sizes: List[int]) -> torch.Tensor:
    """Grouped SwiGLU over expert-sorted rows xs [T', d]: rows
    ``sum(sizes[:e]) ..`` go through expert e."""
    out = torch.empty((xs.shape[0], params["w_down"].shape[-1]),
                      dtype=xs.dtype, device=xs.device)
    lo = 0
    for e, n in enumerate(sizes):
        if not n:
            continue
        rows = xs[lo:lo + n]
        h = F.silu(rows @ params["w_gate"][e]) * (rows @ params["w_up"][e])
        out[lo:lo + n] = h @ params["w_down"][e]
        lo += n
    return out


def moe_ragged(params: Dict, moe: MoEConfig, x: torch.Tensor,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dropless single-device MoE. x [T, d] -> (y [T, d], aux loss)."""
    t, d = x.shape
    k = moe.top_k
    probs, ids, aux = router_topk(params["router"], x, moe)
    flat_ids = ids.reshape(-1)                                   # [T*k]
    order = torch.argsort(flat_ids, stable=True)
    xs = x[order // k]                                           # [T*k, d]
    sizes = _group_sizes(flat_ids, moe.num_experts)
    out_sorted = _expert_ffn(params, xs, sizes)
    out_flat = torch.empty_like(out_sorted)
    out_flat[order] = out_sorted
    y = torch.sum(out_flat.reshape(t, k, d) * probs[..., None], dim=1)
    return y.to(x.dtype), aux


def apply_moe(params: Dict, cfg: ModelConfig, moe: MoEConfig,
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN on x [B, S, d] -> (y [B, S, d], aux loss), with the
    always-on shared experts (``s_gate``/``s_up``/``s_down``) where the
    config has them."""
    b, s, d = x.shape
    y, aux = moe_ragged(params, moe, x.reshape(b * s, d))
    y = y.reshape(b, s, d)
    if moe.num_shared_experts:
        h = F.silu(x @ params["s_gate"]) * (x @ params["s_up"])
        y = y + h @ params["s_down"]
    return y, aux
