"""Training loop: the train step (loss, gradients, AdamW) with gradient
accumulation, and training end to end, on one device or over a mesh of
processes (``(data, model)`` or ``(pod, data, model)``).  Port of
``repro.training.train_loop``; the parameters are the port's own seeded
weights.

Over a mesh (:class:`MeshTrainStep`, the reference's ``train(...,
mesh=)``), each process of a :class:`~repro_torch.core.mesh_procs.MeshProcs`
trains a private copy of its tensor-parallel view
(:func:`~repro_torch.sharding.rules.tensor_parallel`, the reference's
``param_sharding_tree`` placement) with float32 moments of the same shapes:
its block of the batch's rows (over the batch axes, ``data`` or
``(pod, data)``), its heads (attention's and an mLSTM's),
``ff`` columns, RG-LRU channels and vocabulary rows, and ``moe_ep`` where
``model`` divides the experts.  Autograd runs
through the collectives (:mod:`repro_torch.sharding.rules`).  A step reads
the host's whole trees into the private copies, takes the gradients,
sums the whole leaves' shares over ``model``
(:func:`~repro_torch.sharding.rules.tp_leaves`), averages every gradient
and the loss over the batch axes in one flat float32 all-reduce, clips by
the whole tree's norm and writes the updated shards back into the host's
trees, which so stay whole: a checkpoint is the one-device one.

Gradients come from torch autograd through the train-mode forward.  As in
the reference, which differentiates its ``"xla"`` path and cannot
differentiate its Pallas kernels, the trainer runs ``impl="ref"`` by
default; ``impl="cuda"`` raises on the card as soon as the flash-attention
kernel sees an input that needs a gradient.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import init_params, reference_ndim
from repro_torch.device import Device, resolve_device
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.rules import (axis_size, batch_axes, local_config,
                                        local_slice, reduce_over, spec_axes,
                                        tp_leaves, tp_rules, use_mesh)
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
    # chunked cross entropy over this many positions
    # (``transformer.chunked_xent``, never the whole [B, S, V] logits):
    # the reference's dry-run option; None computes the logits whole
    xent_chunk: Optional[int] = None


StepFn = Callable[[Dict, AdamWState, torch.Tensor, torch.Tensor],
                  Tuple[Dict, AdamWState, Dict]]


def _grads(total: torch.Tensor, leaves: List[torch.Tensor],
           ) -> List[torch.Tensor]:
    """The gradients of ``total`` for ``leaves``; a leaf the loss does not
    read gets zeros, as the reference's ``value_and_grad`` gives it: the
    embedding of a model with an untied head fed a frontend's float
    embeddings."""
    got = torch.autograd.grad(total, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for g, p in zip(got, leaves)]


def _micro_rows(b: int, n: int, rows: int = 1) -> int:
    """Rows of a micro-batch of ``n`` in a batch of ``b``; raises where
    they do not split, or a micro-batch does not split over ``rows`` data
    rows of a mesh."""
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} micro-batches")
    if (b // n) % rows:
        raise ValueError(f"a micro-batch of {b // n} rows does not split "
                         f"over {rows} points of the batch axes")
    return b // n


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, *,
                    mesh: Optional[Mesh] = None,
                    device: Device = None) -> StepFn:
    """Returns ``train_step(params, opt, tokens, labels) -> (params, opt,
    metrics)``; ``metrics`` holds ``loss``, ``grad_norm`` and ``lr``.
    With ``mesh``, a :class:`MeshTrainStep` over its processes (on
    ``device``).

    ``params`` is updated in place (its leaves are set to require
    gradients); weight decay follows the ranks of the reference's stacked
    tree, as the reference's AdamW sees them.  With ``grad_accum = n`` the
    batch splits into ``n`` equal micro-batches whose float32 gradients and
    losses are averaged, a Python loop where the reference runs
    ``lax.scan``."""
    if mesh is not None:
        return MeshTrainStep(cfg, tcfg, mesh, device=device)

    def grads_and_loss(leaves, params, tokens, labels):
        total, _ = T.train_loss(cfg, params, tokens, labels, impl=tcfg.impl,
                                xent_chunk=tcfg.xent_chunk)
        return _grads(total, leaves), total.detach()

    def train_step(params: Dict, opt: AdamWState, tokens: torch.Tensor,
                   labels: torch.Tensor):
        ndim = reference_ndim(cfg, params)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        n = tcfg.grad_accum
        if n > 1:
            mb = _micro_rows(tokens.shape[0], n)
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
          mesh: Optional[Mesh] = None, device: Device = None,
          seed: int = 0) -> Dict[str, float]:
    """End-to-end training from seeded weights on ``device`` (the GPU by
    default; raises without one unless ``device="cpu"``), over ``mesh``'s
    processes when given (spawned here, stopped at the end).  Returns
    ``first_loss``, ``final_loss`` and ``mean_last10``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = init_params(cfg, gen, dev)
    opt = adamw_init(params)
    step_fn = make_train_step(cfg, tcfg, mesh=mesh, device=dev)
    data = make_dataset(dcfg)
    t0 = time.time()
    losses = []
    try:
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
    finally:
        if mesh is not None:
            step_fn.close()
    if tcfg.ckpt_dir:
        save_checkpoint(tcfg.ckpt_dir, cfg, params, opt, tcfg.steps)
    return {"final_loss": losses[-1] if losses else float("nan"),
            "first_loss": losses[0] if losses else float("nan"),
            "mean_last10": float(np.mean(np.float32(losses[-10:])))
            if losses else float("nan")}


# --------------------------------------------------------------------------- #
# the train step over a mesh of processes
# --------------------------------------------------------------------------- #

class MeshTrainStep:
    """The train step over a mesh of processes (``(data, model)`` or
    ``(pod, data, model)``), with the
    one-device step's signature: ``step(params, opt, tokens, labels) ->
    (params, opt, metrics)``, where ``params`` and ``opt``'s moments are
    the host's whole trees, updated in place, and ``tokens``/``labels``
    the global batch.  The processes are ``procs`` (left running by
    :meth:`close`), or a :class:`~repro_torch.core.mesh_procs.MeshProcs`
    over ``mesh`` spawned at the first call with its ``params`` (on
    ``device``; stopped by :meth:`close`).  A call with other trees than
    the last one's loads them into the processes first; every step reads
    the trees' values, so a tree restored in place between steps is
    trained from.  With ``grad_accum = n``, micro-batch ``i`` is rows
    ``i * mb .. (i + 1) * mb`` of the batch, split over the batch axes in
    order, as the reference slices it."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig,
                 mesh: Optional[Mesh] = None, *, device: Device = None,
                 procs=None):
        if mesh is None and procs is None:
            raise ValueError("a mesh train step needs a mesh or its "
                             "processes")
        self.cfg, self.tcfg, self.procs = cfg, tcfg, procs
        self.mesh = procs.mesh if procs is not None else mesh
        self.device = device
        self._own = procs is None
        self._trees: Optional[Tuple] = None
        self._rows = axis_size(self.mesh, batch_axes(self.mesh))

    def __call__(self, params: Dict, opt: AdamWState, tokens: torch.Tensor,
                 labels: torch.Tensor):
        _micro_rows(tokens.shape[0], self.tcfg.grad_accum, self._rows)
        self._load(params, opt)
        metrics = self.procs.train(_step_rank, tokens.cpu(), labels.cpu(),
                                   opt.step)
        if any(m["loss"] != metrics[0]["loss"] for m in metrics):
            raise RuntimeError(f"the mesh processes disagree on the loss: "
                               f"{[m['loss'] for m in metrics]}")
        return params, AdamWState(opt.step + 1, opt.mu, opt.nu), metrics[0]

    def gradients(self, params: Dict, opt: AdamWState, tokens: torch.Tensor,
                  labels: torch.Tensor) -> Dict:
        """The gradients a step on this batch would clip and apply (the
        global loss's, float32), gathered whole on the host in the
        parameters' structure; nothing is updated."""
        _micro_rows(tokens.shape[0], self.tcfg.grad_accum, self._rows)
        self._load(params, opt)
        shards = self.procs.train(_grads_rank, tokens.cpu(), labels.cpu())
        specs = tp_leaves(self.cfg, self.mesh,
                          tp_rules(self.cfg, self.mesh), params)[0]
        whole = [torch.zeros(p.shape) for p in tree_leaves(params)]
        for rank, got in enumerate(shards):
            at = self.mesh.at(rank)
            for w, g, spec in zip(whole, got, specs):
                local_slice(w, spec, at).copy_(g)
        it = iter(whole)
        return tree_map(lambda _: next(it), params)

    def _load(self, params: Dict, opt: AdamWState) -> None:
        """Spawn the processes if this step owns none yet, and load the
        trees into them where they are not the last call's."""
        if self.procs is None:
            from repro_torch.core.mesh_procs import MeshProcs
            self.procs = MeshProcs(self.cfg, params, self.mesh,
                                   impl=self.tcfg.impl, device=self.device)
        trees = (params, opt.mu, opt.nu)
        if self._trees is None or any(a is not b for a, b
                                      in zip(self._trees, trees)):
            self.procs.train(_start_rank, self.cfg, self.tcfg, *trees)
            self._trees = trees

    def evaluate(self, tokens: torch.Tensor, labels: torch.Tensor,
                 impl: str = "ref") -> float:
        """``train_loss`` of the processes' trained shards on the global
        batch under ``torch.no_grad``, with ``impl`` (``"cuda"`` runs the
        flash kernel in every process): its batch blocks' means averaged over
        the batch axes."""
        return self.procs.run(_eval_rank, tokens.cpu(), labels.cpu(),
                              impl)[0]

    def close(self) -> None:
        """Stop the processes this step spawned."""
        if self._own and self.procs is not None:
            self.procs.close()


class _RankTrainer:
    """A mesh process's training state: its local config and rules, the
    private copies of its view of the parameters and of the moments (and
    the same views of the host's trees, to read and to write back), and
    per leaf: its spec, whether it is split over ``model``, whether its
    gradient is a share summed over ``model``, whether this process
    writes it back, its rank in the reference's tree."""

    def __init__(self, rank, cfg: ModelConfig, tcfg: TrainConfig,
                 params: Dict, mu: Dict, nu: Dict):
        mesh = rank.mesh
        self.tcfg = tcfg
        self.rules = tp_rules(cfg, mesh)
        self.cfg = local_config(cfg, mesh, self.rules)
        specs, self.split, self.partial = tp_leaves(cfg, mesh, self.rules,
                                                     params)
        self.host = [[local_slice(t, spec, mesh)
                      for t, spec in zip(tree_leaves(tree), specs)]
                     for tree in (params, mu, nu)]
        self.state = [[t.detach().clone() for t in views]
                      for views in self.host]
        coords = mesh.coords()
        self.writer = [not any(c for a, c in coords.items()
                               if a not in spec_axes(spec))
                       for spec in specs]
        self.ndim = tree_leaves(reference_ndim(cfg, params))
        it = iter(self.state[0])
        self.tree = tree_map(lambda _: next(it), params)
        self.model = tuple(a for a in mesh.axis_names
                           if a not in batch_axes(mesh))


def _start_rank(rank, cfg: ModelConfig, tcfg: TrainConfig, params: Dict,
                mu: Dict, nu: Dict) -> None:
    """In a mesh process: its private copies of its view of the host's
    trees (:class:`_RankTrainer`)."""
    rank.trainer = _RankTrainer(rank, cfg, tcfg, params, mu, nu)


def _rows(rank, x: torch.Tensor) -> torch.Tensor:
    """This process's rows of a batch tensor, on its device: integer
    tokens as int64, a frontend's float embeddings as they are."""
    spec = rank.trainer.rules.spec(("batch",))
    x = local_slice(x, spec, rank.mesh).to(rank.device)
    return x if x.is_floating_point() else x.long()


def _mesh_grads(rank, tokens: torch.Tensor, labels: torch.Tensor,
                ) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """In a mesh process: the host's trees read into its private copies,
    then the gradients of the global loss for its leaves (float32, the
    whole leaves' shares summed over ``model``, every one averaged over
    the batch axes with the loss in one flat buffer), the loss and the
    whole tree's gradient norm."""
    tr, mesh = rank.trainer, rank.mesh
    params, tcfg = tr.state[0], tr.tcfg
    with torch.no_grad():
        for views, state in zip(tr.host, tr.state):
            for h, p in zip(views, state):
                p.copy_(h)
    for p in params:
        p.requires_grad_(True)
    n = tcfg.grad_accum
    mb = _micro_rows(tokens.shape[0], n)
    grads: List[torch.Tensor] = []
    loss = torch.zeros((), dtype=torch.float32, device=rank.device)
    with use_mesh(mesh, tr.rules):
        for i in range(n):
            total, _ = T.train_loss(
                tr.cfg, tr.tree, _rows(rank, tokens[i * mb:(i + 1) * mb]),
                _rows(rank, labels[i * mb:(i + 1) * mb]), impl=tcfg.impl,
                xent_chunk=tcfg.xent_chunk)
            g = _grads(total, params)
            if grads:
                for acc, gi in zip(grads, g):
                    acc += gi
            else:
                grads = [gi.float() for gi in g]
            loss = loss + total.detach()
        del total, g
    for p in params:
        p.requires_grad_(False)
    with torch.no_grad():
        # the whole leaves' shares, summed over model
        shares = [g for g, p in zip(grads, tr.partial) if p]
        if shares and tr.model:
            flat = reduce_over(mesh, tr.model, torch.cat(
                [g.reshape(-1) for g in shares]), "tp")
            for g, part in zip(shares, flat.split([g.numel()
                                                   for g in shares])):
                g.copy_(part.view_as(g))
        # every gradient and the loss, averaged over the batch axes: one
        # flat float32 buffer
        data = batch_axes(mesh)
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
        sizes = [g.numel() for g in grads]
        del grads, shares
        flat = reduce_over(mesh, data, flat, "dp")
        flat /= axis_size(mesh, data) * n
        grads = [part.view(p.shape) for part, p
                 in zip(flat[:-1].split(sizes), params)]
        # the whole tree's norm: the split leaves' squares summed over
        # model, the whole leaves' counted once
        zero = torch.zeros((), device=rank.device)
        squares = torch.stack([
            sum((g.square().sum() for g, s in zip(grads, tr.split) if s),
                zero),
            sum((g.square().sum() for g, s in zip(grads, tr.split)
                 if not s), zero)])
        squares[:1] = reduce_over(mesh, tr.model, squares[:1], "tp")
    return grads, flat[-1], torch.sqrt(squares.sum())


def _update_rank(rank, tokens: torch.Tensor, labels: torch.Tensor,
                 step: int) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """In a mesh process: :func:`_mesh_grads`, then AdamW on its private
    copies (after ``step`` updates), with no read on the host: the global
    loss and the whole tree's gradient norm as tensors on its device, and
    ``adamw_update``'s metrics.  The part of :func:`_step_rank` that the
    dry run (:mod:`repro_torch.launch.dryrun`) runs on ``meta``."""
    tr = rank.trainer
    grads, loss, gnorm = _mesh_grads(rank, tokens, labels)
    params, mu, nu = tr.state
    _, _, metrics = adamw_update(tr.tcfg.optimizer, grads,
                                 AdamWState(step, mu, nu), params, tr.ndim,
                                 grad_norm=gnorm)
    return loss, gnorm, metrics


def _step_rank(rank, tokens: torch.Tensor, labels: torch.Tensor,
               step: int) -> Dict:
    """In a mesh process: one train step of :class:`MeshTrainStep` (after
    ``step`` updates, :func:`_update_rank`), its shards written back into
    the host's trees; the global loss, the whole tree's gradient norm and
    the learning rate."""
    tr = rank.trainer
    loss, gnorm, metrics = _update_rank(rank, tokens, labels, step)
    with torch.no_grad():
        for views, state in zip(tr.host, tr.state):
            for h, p, w in zip(views, state, tr.writer):
                if w:
                    h.copy_(p)
    rank.sync()
    return dict(loss=float(loss), grad_norm=float(gnorm),
                lr=metrics["lr"])


def _grads_rank(rank, tokens: torch.Tensor, labels: torch.Tensor,
                ) -> List[torch.Tensor]:
    """In a mesh process: :func:`_mesh_grads`' gradients, on the host's
    side (:meth:`MeshTrainStep.gradients`)."""
    return [g.cpu() for g in _mesh_grads(rank, tokens, labels)[0]]


def _eval_rank(rank, tokens: torch.Tensor, labels: torch.Tensor,
               impl: str) -> float:
    """In a mesh process: ``train_loss`` of its trained shards on its rows,
    averaged over the batch axes (:meth:`MeshTrainStep.evaluate`)."""
    tr, mesh = rank.trainer, rank.mesh
    with use_mesh(mesh, tr.rules):
        total, _ = rank.timed(T.train_loss, tr.cfg, tr.tree,
                              _rows(rank, tokens), _rows(rank, labels),
                              impl=impl)
    data = batch_axes(mesh)
    return float(reduce_over(mesh, data, total.reshape(1).float())[0]
                 / axis_size(mesh, data))
