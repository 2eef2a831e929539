"""Mixture-of-experts FFN: a top-k router and a dropless grouped SwiGLU,
with an expert-parallel engine for a mesh of processes.
Port of ``repro.models.moe``; two engines with the same semantics (up to
capacity drops), chosen as the reference chooses (:func:`apply_moe`):

- ``moe_ragged`` sorts the ``T * k`` (token, expert) assignments by expert
  and runs each expert's SwiGLU over its contiguous slice of the sorted
  rows: one ``torch.matmul`` per weight matrix and expert that holds
  tokens, where the reference runs one ``jax.lax.ragged_dot`` per weight
  matrix.  The slice bounds are the group sizes, which the host reads once
  a layer call (:func:`_group_sizes`, one device-to-host copy that waits
  for the card).  Without a mesh, or where ``model`` does not divide the
  experts.
- ``moe_ep`` under an installed mesh of processes
  (:class:`repro_torch.core.mesh_procs.MeshProcs`): tokens split over every
  process, experts over ``model`` by the rules (``"experts" -> model``);
  each process buckets its assignments per expert up to a capacity (the
  ones past it dropped), exchanges the buckets with ``all_to_all`` over
  ``model`` (through the process's staging buffers), runs its experts on
  what it received in one batched product a weight matrix, and sends the
  results back (GShard/Switch style, the reference's ``shard_map``).

Precision follows the reference: the router's softmax, top-k and aux loss
run in float32, the combine weights are cast back to the activation dtype,
and the expert products run in the weights' dtype.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.sharding.rules import (all_to_all, current_mesh,
                                        current_rules, gather_blocks,
                                        local_slice, mean_over_mesh,
                                        take_block)


def router_topk(router_w: torch.Tensor, x: torch.Tensor, moe: MoEConfig,
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [T, d] -> (probs [T, k] in x's dtype, expert ids [T, k], the
    Switch load-balance aux loss, a float32 scalar).  Equal probabilities
    go to the lower expert index first, as ``jax.lax.top_k``'s do
    (``torch.topk`` leaves their order open): a zero row, such as the pad
    rows ``moe_ep`` adds, ties every expert."""
    logits = (x @ router_w).float()                              # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :moe.top_k], top_i[:, :moe.top_k]
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


# --------------------------------------------------------------------------- #
# expert-parallel engine
# --------------------------------------------------------------------------- #

def _dispatch_buckets(x: torch.Tensor, flat_ids: torch.Tensor,
                      n_experts: int, cap: int,
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter the assignments x [T*k, d] into per-expert capacity
    buckets, in token order within an expert.  Returns (buckets
    [E, cap, d], slot [T*k] int32, keep [T*k] bool); a dropped
    assignment's slot is ``cap``."""
    tk, dev = flat_ids.shape[0], flat_ids.device
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    starts = torch.searchsorted(sorted_ids, torch.arange(
        n_experts, dtype=sorted_ids.dtype, device=dev), side="left")
    pos = torch.empty(tk, dtype=torch.int32, device=dev)
    pos[order] = (torch.arange(tk, device=dev)
                  - starts[sorted_ids]).to(torch.int32)
    keep = pos < cap
    slot = torch.where(keep, pos, cap)
    buckets = x.new_zeros((n_experts, cap + 1, x.shape[-1]))
    buckets[flat_ids, slot] = x
    return buckets[:, :cap], slot, keep


def _moe_ep_local(x: torch.Tensor, router_w: torch.Tensor,
                  w_gate: torch.Tensor, w_up: torch.Tensor,
                  w_down: torch.Tensor, *, moe: MoEConfig, ep: int, cap: int,
                  mesh, ep_axis: str = "model",
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One process's part: its tokens x [t, d], its ``E / ep`` experts'
    weights.  Returns (y [t, d], its aux loss, keep [t*k]).  Each
    ``all_to_all`` is differentiable, its backward the same exchange of
    the cotangent."""
    t, d = x.shape
    k, e = moe.top_k, moe.num_experts
    e_loc = e // ep
    probs, ids, aux = router_topk(router_w, x, moe)
    flat_ids = ids.reshape(-1)
    rep_x = torch.repeat_interleave(x, k, dim=0)                 # [T*k, d]
    buckets, slot, keep = _dispatch_buckets(rep_x, flat_ids, e, cap)
    # [E, cap, d] -> [ep, E_loc*cap, d] -> all_to_all -> [ep_src, E_loc*cap, d]
    recv = all_to_all(buckets.reshape(ep, e_loc * cap, d), ep_axis, mesh)
    recv = recv.reshape(ep, e_loc, cap, d).transpose(0, 1)
    recv = recv.reshape(e_loc, ep * cap, d)
    h = F.silu(torch.bmm(recv, w_gate)) * torch.bmm(recv, w_up)
    out = torch.bmm(h, w_down)                           # [E_loc, ep*cap, d]
    out = out.reshape(e_loc, ep, cap, d).transpose(0, 1)
    back = all_to_all(out.reshape(ep, e_loc * cap, d), ep_axis, mesh)
    back = back.reshape(e, cap, d)
    gathered = back[flat_ids, slot.clamp(max=cap - 1)]           # [T*k, d]
    gathered = torch.where(keep[:, None], gathered, 0)
    y = torch.sum(gathered.reshape(t, k, d) * probs[..., None], dim=1)
    return y.to(x.dtype), aux, keep


def moe_ep(params: Dict, moe: MoEConfig, x: torch.Tensor,
           capacity_factor: Optional[float] = None,
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE over the ``model`` axis of the installed mesh,
    in a mesh process.  x [t, d] is this process's block of the tokens
    (block ``rank`` of T = t x processes: the reference's ``x`` sharded
    over every axis); ``params`` hold every expert, and this process takes
    its ``E / |model|`` by the rules.  Returns (y [t, d], the mean of every
    process's aux loss).  The capacity is ``max(1, ceil(t k cf / E))``;
    each call reports to the process's comm (``comm.moe_report``)."""
    mesh = current_mesh()
    if mesh is None or mesh.comm is None:
        raise ValueError("moe_ep runs in a mesh process, under use_mesh "
                         "(repro_torch.core.mesh_procs.MeshProcs)")
    ep_axis = "model"
    ep = mesh.shape[ep_axis]
    t_loc = x.shape[0]
    cf = capacity_factor if capacity_factor is not None \
        else moe.capacity_factor
    cap = max(1, int(-(-t_loc * moe.top_k * cf // moe.num_experts)))
    spec = current_rules().spec(("experts", None, None))
    w = [local_slice(params[n], spec, mesh)
         for n in ("w_gate", "w_up", "w_down")]
    if w[0].shape[0] * ep != moe.num_experts:
        raise ValueError(f"the rules place the experts by {spec}: "
                         f"{w[0].shape[0]} a process, not "
                         f"{moe.num_experts} // {ep}")
    y, aux, keep = _moe_ep_local(x, params["router"], *w, moe=moe, ep=ep,
                                 cap=cap, mesh=mesh, ep_axis=ep_axis)
    aux = mean_over_mesh(aux.reshape(1), mesh)[0]
    mesh.comm.moe_report(keep, cap, 2 * moe.num_experts * cap * x.shape[1]
                         * x.element_size())
    return y, aux


def _moe_ep_tokens(params: Dict, moe: MoEConfig, flat: torch.Tensor,
                   mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_ep`` over every token of the batch, flat [T, d] on every
    process: padded to the process count and split over every process as
    the reference splits them, each process's block of y gathered back.
    Under autograd the block's gradient is summed over ``model`` and y's
    over the batch axes (:func:`~repro_torch.sharding.rules.take_block`,
    :func:`~repro_torch.sharding.rules.gather_blocks`)."""
    t, d = flat.shape
    pad = (-t) % mesh.size
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad, d))])
    every = tuple(mesh.axis_names)
    y, aux = moe_ep(params, moe, take_block(flat, every, mesh))
    return gather_blocks(y, every, mesh)[:t], aux


def apply_moe(params: Dict, cfg: ModelConfig, moe: MoEConfig,
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN on x [B, S, d] -> (y [B, S, d], aux loss), with the
    always-on shared experts (``s_gate``/``s_up``/``s_down``) where the
    config has them.  The engine is the reference's choice: ``moe_ep``
    under an installed mesh whose ``model`` axis divides the experts, else
    ``moe_ragged``.  Under a mesh, x is this process's rows of the batch
    (split over the axes the rules give "batch"); either engine sees the
    whole batch's tokens, gathered, as the reference's does, so the
    capacity blocks and the aux loss are its, and each process keeps its
    rows of y."""
    mesh = current_mesh()
    batch = None if mesh is None else current_rules().spec(("batch",))[0]
    whole = x if batch is None else gather_blocks(x, batch, mesh)
    flat = whole.reshape(-1, x.shape[-1])
    if mesh is not None and moe.num_experts % mesh.shape["model"] == 0:
        y, aux = _moe_ep_tokens(params, moe, flat, mesh)
    else:
        y, aux = moe_ragged(params, moe, flat)
    y = y.reshape(whole.shape)
    if batch is not None:
        y = local_slice(y, (batch,), mesh)
    if moe.num_shared_experts:
        h = F.silu(x @ params["s_gate"]) * (x @ params["s_up"])
        y = y + h @ params["s_down"]
    return y, aux
