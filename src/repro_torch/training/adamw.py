"""AdamW with linear warmup and cosine decay, over the port's parameter
tree.  Port of ``repro.training.adamw``.

The tree is the port's parameter dict (:mod:`repro_torch.bridge`): nested
dicts and the ``"layers"`` list, tensors at the leaves.  The moments are
float32 whatever the parameters' dtype; each update runs in float32 and is
cast back to the parameter's dtype (bf16 at full size).  Parameters and
moments update in place under ``torch.no_grad``, where the reference builds
new trees.  The schedule's scalars (learning rate, bias corrections) are
computed in float32 on the host, as the reference computes them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

Tree = Any


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: int          # updates taken
    mu: Tree           # first moments, float32, the parameters' structure
    nu: Tree           # second moments


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    """The tensors of a parameter-shaped tree, in one fixed order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Tree) -> Tree:
    """``fn`` applied to every tensor of ``tree``, in the structure of
    ``tree``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def lr_schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup + cosine decay to ``min_lr_ratio * lr``, in float32."""
    s = _f32(step)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi) * prog))
    decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return float(cfg.lr * warm * decay)


def global_norm(tree: Tree) -> torch.Tensor:
    """The L2 norm of every leaf together, float32 (a 0-d tensor on the
    leaves' device)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tree_leaves(tree)))


def adamw_init(params: Tree) -> AdamWState:
    def zeros():
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)
    return AdamWState(step=0, mu=zeros(), nu=zeros())


def adamw_update(cfg: AdamWConfig, grads: Tree, state: AdamWState,
                 params: Tree, ndim: Optional[Tree] = None,
                 grad_norm: Optional[torch.Tensor] = None,
                 ) -> Tuple[Tree, AdamWState, Dict[str, Any]]:
    """One AdamW step with global-norm clipping.  Returns (params, state,
    {"grad_norm", "lr"}); ``params`` and the moments are updated in place
    and returned.  Decoupled weight decay applies to leaves of rank 2 and
    more (matrices) only, the rank read from ``ndim`` (a tree of ints in
    the structure of ``params``) when given: the trainer passes the ranks
    of the reference's stacked tree
    (:func:`repro_torch.bridge.reference_ndim`).  ``grad_norm``, when
    given, is the norm to clip by in place of :func:`global_norm` of
    ``grads``: a mesh process holds only its shard of the tree, and the
    mesh trainer computes the whole tree's norm across the processes."""
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.grad_clip / gnorm.clamp_min(1e-9), max=1.0) \
        if cfg.grad_clip else 1.0
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1c = float(1 - cfg.b1 ** _f32(step))
    b2c = float(1 - cfg.b2 ** _f32(step))
    leaves = tree_leaves(params)
    ranks = [p.dim() for p in leaves] if ndim is None else tree_leaves(ndim)
    with torch.no_grad():
        for p, rank, g, mu, nu in zip(leaves, ranks, tree_leaves(grads),
                                      tree_leaves(state.mu),
                                      tree_leaves(state.nu)):
            g = g.float() * scale
            mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            nu.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
            delta = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
            if rank >= 2:
                delta = delta + cfg.weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, AdamWState(step, state.mu, state.nu), \
        {"grad_norm": gnorm, "lr": lr}
