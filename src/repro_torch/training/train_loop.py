"""Training loop: the train step (loss, gradients, AdamW) with gradient
accumulation, and training end to end.  Port of
``repro.training.train_loop`` on one device: there is no mesh, and the
parameters are the port's own seeded weights.

Gradients come from torch autograd through the train-mode forward.  As in
the reference, which differentiates its ``"xla"`` path and cannot
differentiate its Pallas kernels, the trainer runs ``impl="ref"`` by
default; ``impl="cuda"`` raises on the card as soon as the flash-attention
kernel sees an input that needs a gradient.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import init_params, reference_ndim
from repro_torch.device import Device, resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.training.adamw import (AdamWConfig, AdamWState, adamw_init,
                                        adamw_update, tree_leaves, tree_map)
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.data import DataConfig, make_dataset


@dataclass
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 0               # 0 = only final
    ckpt_dir: Optional[str] = None
    grad_accum: int = 1
    # the reference's field ("xla" there).  "ref" is the only value that
    # trains on the card: "cuda" raises at the flash kernel's first input
    # that needs a gradient, as the kernel has no backward (nor has the
    # reference's)
    impl: str = "ref"
    optimizer: AdamWConfig = field(default_factory=AdamWConfig)


StepFn = Callable[[Dict, AdamWState, torch.Tensor, torch.Tensor],
                  Tuple[Dict, AdamWState, Dict]]


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig) -> StepFn:
    """Returns ``train_step(params, opt, tokens, labels) -> (params, opt,
    metrics)``; ``metrics`` holds ``loss``, ``grad_norm`` and ``lr``.

    ``params`` is updated in place (its leaves are set to require
    gradients); weight decay follows the ranks of the reference's stacked
    tree, as the reference's AdamW sees them.  With ``grad_accum = n`` the
    batch splits into ``n`` equal micro-batches whose float32 gradients and
    losses are averaged, a Python loop where the reference runs
    ``lax.scan``."""
    def grads_and_loss(leaves, params, tokens, labels):
        total, _ = T.train_loss(cfg, params, tokens, labels, impl=tcfg.impl)
        return torch.autograd.grad(total, leaves), total.detach()

    def train_step(params: Dict, opt: AdamWState, tokens: torch.Tensor,
                   labels: torch.Tensor):
        ndim = reference_ndim(cfg, params)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        n = tcfg.grad_accum
        if n > 1:
            b = tokens.shape[0]
            if b % n:
                raise ValueError(f"batch {b} does not split into "
                                 f"{n} micro-batches")
            mb = b // n
            grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for i in range(n):
                g, part = grads_and_loss(leaves, params,
                                         tokens[i * mb:(i + 1) * mb],
                                         labels[i * mb:(i + 1) * mb])
                for acc, gi in zip(grads, g):
                    acc += gi
                loss = loss + part
            grads = [g / n for g in grads]
            loss = loss / n
        else:
            grads, loss = grads_and_loss(leaves, params, tokens, labels)
        it = iter(grads)
        params, opt, metrics = adamw_update(
            tcfg.optimizer, tree_map(lambda _: next(it), params), opt, params,
            ndim)
        metrics["loss"] = loss
        return params, opt, metrics

    return train_step


def train(cfg: ModelConfig, tcfg: TrainConfig, dcfg: DataConfig, *,
          device: Device = None, seed: int = 0) -> Dict[str, float]:
    """End-to-end training from seeded weights on ``device`` (the GPU by
    default; raises without one unless ``device="cpu"``).  Returns
    ``first_loss``, ``final_loss`` and ``mean_last10``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = init_params(cfg, gen, dev)
    opt = adamw_init(params)
    step_fn = make_train_step(cfg, tcfg)
    data = make_dataset(dcfg)
    t0 = time.time()
    losses = []
    for step, (tokens, labels) in enumerate(data):
        if step >= tcfg.steps:
            break
        params, opt, metrics = step_fn(
            params, opt, torch.from_numpy(tokens).to(dev, torch.long),
            torch.from_numpy(labels).to(dev, torch.long))
        losses.append(float(metrics["loss"]))
        if tcfg.log_every and step % tcfg.log_every == 0:
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"lr {metrics['lr']:.2e} "
                  f"gnorm {float(metrics['grad_norm']):.2f} "
                  f"({time.time() - t0:.1f}s)")
        if tcfg.ckpt_every and tcfg.ckpt_dir and \
                step and step % tcfg.ckpt_every == 0:
            save_checkpoint(tcfg.ckpt_dir, cfg, params, opt, step)
    if tcfg.ckpt_dir:
        save_checkpoint(tcfg.ckpt_dir, cfg, params, opt, tcfg.steps)
    return {"final_loss": losses[-1] if losses else float("nan"),
            "first_loss": losses[0] if losses else float("nan"),
            "mean_last10": float(np.mean(np.float32(losses[-10:])))
            if losses else float("nan")}
