"""Logical-axis sharding rules, and a rank's shard of a tensor.

Port of ``repro.sharding.rules``.  Model code names tensor dimensions with
*logical* axes ("batch", "heads", "ff", "experts", ...); an
:class:`AxisRules` maps them to mesh axes, and :func:`use_mesh` installs a
(mesh, rules) pair for the code that runs under it.  The reference hands
the resulting shardings to XLA; here a mesh is a grid of processes
(:mod:`repro_torch.launch.mesh`) and every placement is explicit:
:func:`local_slice` cuts one rank's block out of a tensor by its spec.

Tensor parallelism over ``model`` (Megatron): :func:`tensor_parallel`
gives a mesh process its view of the model -- the rules it places and
computes by (:func:`tp_rules`), its shard of every split weight (views,
by :func:`param_sharding_tree` of :func:`repro_torch.bridge.param_axes`)
and the config of its local head and ff counts (:func:`local_config`).
Where the reference constrains a product over a split dimension back to
``("batch", None, "embed")`` and XLA inserts the all-reduce, the model
code calls :func:`model_sum`; the vocabulary-split head calls
:func:`model_gather`.  Both are the identity outside a mesh process.

Default production mapping (single-pod (data, model) / multi-pod
(pod, data, model)):

    batch    -> (pod?, data)       activations & KV cache
    heads    -> model              attention TP (Megatron)
    kv_heads -> model
    ff       -> model              MLP TP
    experts  -> model              expert parallelism
    vocab    -> model              embedding / logits TP
    stage    -> model              EdgeShard pipeline mode
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.bridge import param_axes
from repro_torch.launch.mesh import Mesh
from repro_torch.models.config import ModelConfig

MeshAxes = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """A mesh axis, a tuple of mesh axes, or None for each dimension
    (trailing dimensions not named are unsharded).  As the reference's
    ``jax.sharding.PartitionSpec``, an entry of one axis is that axis
    (``("data",)`` is ``"data"``) and an empty tuple is None."""

    def __new__(cls, *entries: MeshAxes) -> "PartitionSpec":
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclass(frozen=True)
class AxisRules:
    rules: Tuple[Tuple[str, MeshAxes], ...]

    def spec(self, logical_axes: Sequence[Optional[str]]) -> PartitionSpec:
        table = dict(self.rules)
        return P(*(None if name is None else table.get(name)
                   for name in logical_axes))


def default_rules(multi_pod: bool = False) -> AxisRules:
    batch = ("pod", "data") if multi_pod else ("data",)
    return AxisRules((
        ("batch", batch),
        ("seq", None),
        ("seq_kv", None),
        ("embed", None),
        ("heads", "model"),
        ("kv_heads", "model"),
        ("qkv", "model"),
        ("ff", "model"),
        ("experts", "model"),
        ("rnn", "model"),
        ("vocab", "model"),
        ("stage", "model"),
        ("layers", None),
    ))


def long_context_rules(multi_pod: bool = False) -> AxisRules:
    """Decode with batch << data-axis size: shard the KV cache sequence dim
    over the data axis instead of the (unfillable) batch dim."""
    base = dict(default_rules(multi_pod).rules)
    base["batch"] = None
    base["seq_kv"] = ("pod", "data") if multi_pod else ("data",)
    return AxisRules(tuple(base.items()))


def decode_seq_model_rules(multi_pod: bool = False) -> AxisRules:
    """Shard the decode KV cache over the *model* axis on the sequence dim
    instead of kv_heads (for kv_heads the model axis does not divide, e.g.
    qwen1.5-32b's 40 on a 16-way axis)."""
    base = dict(default_rules(multi_pod).rules)
    base["seq_kv"] = ("model",)
    base["kv_heads"] = None
    return AxisRules(tuple(base.items()))


def fsdp_rules(multi_pod: bool = False) -> AxisRules:
    """Train: also shard weights and optimizer state over the data axis on
    their d_model ("embed") dimension, ZeRO-3 style; for parameters only,
    activations keep the default rules."""
    base = dict(default_rules(multi_pod).rules)
    base["embed"] = ("data",)
    return AxisRules(tuple(base.items()))


_ctx = threading.local()


def current_mesh() -> Optional[Mesh]:
    return getattr(_ctx, "mesh", None)


def current_rules() -> Optional[AxisRules]:
    return getattr(_ctx, "rules", None)


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh], rules: Optional[AxisRules] = None):
    """Install a (mesh, rules) pair for this thread; a ``None`` mesh is
    unsharded.  ``rules`` default to :func:`default_rules` of the mesh."""
    prev = (current_mesh(), current_rules())
    _ctx.mesh = mesh
    _ctx.rules = rules if rules is not None else (
        default_rules("pod" in mesh.axis_names) if mesh is not None else None)
    try:
        yield
    finally:
        _ctx.mesh, _ctx.rules = prev


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``);
    :func:`local_slice` places a tensor by it."""

    mesh: Mesh
    spec: PartitionSpec


def _axes(entry: MeshAxes) -> Tuple[str, ...]:
    return () if entry is None else (entry,) if isinstance(entry, str) \
        else tuple(entry)


def axis_size(mesh: Mesh, entry: MeshAxes) -> int:
    """How many blocks a spec entry cuts a dimension into."""
    return math.prod(mesh.shape[a] for a in _axes(entry))


def local_slice(x: torch.Tensor, spec: Sequence[MeshAxes],
                mesh: Mesh) -> torch.Tensor:
    """The block of ``x`` that ``mesh.rank`` holds under ``spec``: each
    dimension with mesh axes is cut into as many equal blocks as the axes
    have points, and the rank takes the block at its coordinates over
    them, the first axis major (as ``jax`` places ``addressable_shards``).
    A view; raises where a dimension is not a whole number of blocks."""
    spec = tuple(spec)
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} for a tensor of {x.dim()} dims")
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        n = axis_size(mesh, entry)
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                             f"split into {n} blocks over {axes}")
        size = x.shape[dim] // n
        x = x.narrow(dim, _block(mesh, entry) * size, size)
    return x


def _block(mesh: Mesh, entry: MeshAxes) -> int:
    """Which of the blocks a spec entry cuts a dimension into this process
    holds: its coordinates over the entry's axes, the first axis major."""
    coords, block = mesh.coords(), 0
    for a in _axes(entry):
        block = block * mesh.shape[a] + coords[a]
    return block


def logical_sharding(logical_axes: Sequence[Optional[str]],
                     ) -> Optional[NamedSharding]:
    mesh, rules = current_mesh(), current_rules()
    if mesh is None or rules is None:
        return None
    return NamedSharding(mesh, rules.spec(logical_axes))


def logical_constraint(x: torch.Tensor,
                       *logical_axes: Optional[str]) -> torch.Tensor:
    """The identity.  The reference constrains ``x``'s sharding here; a
    rank's tensor is already its shard (placed by :func:`local_slice`),
    and the collectives that move it are explicit (:func:`model_sum`,
    :func:`model_gather`)."""
    return x


def _is_axes_leaf(x) -> bool:
    """A logical-axes annotation: a tuple of axis names / None (not a
    tuple of subtrees, such as a NamedTuple)."""
    return (isinstance(x, tuple)
            and all(isinstance(e, (str, type(None))) for e in x))


def _map(fn, tree, is_leaf, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching nodes of the
    trees in ``rest``, walked by the same keys and positions)."""
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map(fn, v, is_leaf, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if any(len(r) != len(tree) for r in rest):
            raise ValueError("trees of different structure")
        out = [_map(fn, v, is_leaf, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return fn(tree, *rest)


def param_sharding_tree(param_axes, mesh: Optional[Mesh] = None,
                        rules: Optional[AxisRules] = None):
    """Map a tree of logical-axis tuples to :class:`NamedSharding`\\ s (or
    None without a mesh)."""
    mesh = mesh if mesh is not None else current_mesh()
    rules = rules if rules is not None else current_rules()
    if mesh is None:
        return _map(lambda _: None, param_axes, _is_axes_leaf)
    rules = rules or default_rules("pod" in mesh.axis_names)
    return _map(lambda axes: NamedSharding(mesh, rules.spec(axes)),
                param_axes, _is_axes_leaf)


def shape_aware_sharding_tree(arg_tree, axes_tree, mesh: Mesh,
                              rules: AxisRules):
    """Like :func:`param_sharding_tree`, but a mesh axis is dropped from a
    dimension it does not divide (e.g. vocab 49155 on a 16-way model
    axis).  ``arg_tree`` has ``axes_tree``'s structure; its leaves need
    only a ``shape``."""
    def one(axes, leaf):
        spec = list(rules.spec(axes))
        spec += [None] * (len(leaf.shape) - len(spec))
        return NamedSharding(mesh, P(*(
            None if a is not None and dim % axis_size(mesh, a) else a
            for dim, a in zip(leaf.shape, spec))))

    return _map(one, axes_tree, _is_axes_leaf, arg_tree)


# --------------------------------------------------------------------------- #
# tensor parallelism over the model axis
# --------------------------------------------------------------------------- #

#: the logical axes of the attention projections' split dimension
_HEAD_AXES = ("heads", "kv_heads", "qkv")


def tp_rules(cfg: ModelConfig, mesh: Mesh,
             rules: Optional[AxisRules] = None) -> AxisRules:
    """The rules a tensor-parallel process of ``mesh`` places and computes
    by: ``rules`` (the mesh's default ones) with each split the model
    cannot take whole dropped.

    - ``qkv`` (and ``heads``, ``kv_heads``): a process must hold whole
      query heads and the K/V heads of exactly those, so the attention
      splits only where both head counts divide by the axis, read from the
      config (a flattened ``qkv`` width may divide where one head does
      not: recurrentgemma-2b's ``wk`` is one head of 256), and only where
      no mLSTM or sLSTM block reads ``cfg.n_heads`` for its own heads;
    - ``ff`` where ``d_ff`` divides, ``vocab`` where ``vocab_size``
      divides (as :func:`shape_aware_sharding_tree` drops an axis);
    - ``rnn`` never: the recurrent mixers run whole on every process."""
    rules = rules or default_rules("pod" in mesh.axis_names)
    table = dict(rules.rules)

    def divides(axis: str, *counts: int) -> bool:
        n = axis_size(mesh, table.get(axis))
        return all(c > 0 and c % n == 0 for c in counts)

    kinds = {spec.kind for spec in cfg.layer_specs()}
    if not ("attn" in kinds and not kinds & {"mlstm", "slstm"}
            and divides("qkv", cfg.n_heads, cfg.n_kv_heads)):
        table.update({a: None for a in _HEAD_AXES})
    if not divides("ff", cfg.d_ff):
        table["ff"] = None
    if not divides("vocab", cfg.vocab_size):
        table["vocab"] = None
    table["rnn"] = None
    return AxisRules(tuple(table.items()))


def local_config(cfg: ModelConfig, mesh: Mesh,
                 rules: AxisRules) -> ModelConfig:
    """``cfg`` as one process of ``mesh`` runs it under ``rules``
    (:func:`tp_rules`): its query and K/V heads and its ``d_ff`` the
    local counts, the head width fixed; the vocabulary stays whole, as
    sampling sees it."""
    heads = axis_size(mesh, rules.spec(("qkv",))[0])
    ff = axis_size(mesh, rules.spec(("ff",))[0])
    return dataclasses.replace(
        cfg, n_heads=cfg.n_heads // heads,
        n_kv_heads=cfg.n_kv_heads // heads, head_dim=cfg.resolved_head_dim,
        d_ff=cfg.d_ff // ff)


def tensor_parallel(cfg: ModelConfig, params: Dict, mesh: Mesh,
                    rules: Optional[AxisRules] = None,
                    ) -> Tuple[ModelConfig, Dict, AxisRules]:
    """One process's view of the model on ``mesh``: (its config, its
    parameters, the rules to install with :func:`use_mesh`).  Every leaf
    is :func:`local_slice`\\ d by :func:`param_sharding_tree` of the
    reference's axes under :func:`tp_rules` -- views of ``params``'
    tensors, so the weights stay held once -- except the mixers of
    recurrent blocks and the MoE FFNs, whole: the former run replicated,
    and ``moe_ep`` takes its experts itself."""
    rules = tp_rules(cfg, mesh, rules)
    axes = param_axes(cfg)

    def whole(tree):
        return _map(lambda a: (None,) * len(a), tree, _is_axes_leaf)

    for spec, layer in zip(cfg.layer_specs(), axes["layers"]):
        if spec.kind != "attn":
            layer["mixer"] = whole(layer["mixer"])
        if spec.moe is not None:
            layer["ffn"] = whole(layer["ffn"])
    placed = _map(lambda sh, x: local_slice(x, sh.spec, mesh),
                  param_sharding_tree(axes, mesh, rules),
                  lambda t: isinstance(t, NamedSharding), params)
    return local_config(cfg, mesh, rules), placed, rules


def _split(axis: str) -> Optional[Tuple[Mesh, MeshAxes]]:
    """(the mesh of this process, the axes the installed rules give
    logical ``axis``) where they split it over more than one process of a
    mesh process; None elsewhere."""
    mesh, rules = current_mesh(), current_rules()
    if mesh is None or mesh.comm is None or rules is None:
        return None
    entry = rules.spec((axis,))[0]
    return (mesh, entry) if axis_size(mesh, entry) > 1 else None


def shard_start(axis: str, n: int) -> Optional[int]:
    """The first index of this process's block of ``n`` along a dimension
    the installed rules split by logical ``axis``; None where they do not
    split it (or outside a mesh process)."""
    split = _split(axis)
    return None if split is None else _block(*split) * n


def _tally(comm, x: torch.Tensor, run) -> torch.Tensor:
    """Run one collective of the tensor-parallel sites on operand ``x``,
    tallied in ``comm.tp``: the wait for the device before it
    (``wait_s``), the collective with its copies (``s``), the bytes of
    ``x`` (what each process hands to gloo)."""
    t0 = time.perf_counter()
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    t1 = time.perf_counter()
    out = run()
    tp = comm.tp
    tp["calls"] += 1
    tp["bytes"] += x.numel() * x.element_size()
    tp["wait_s"] += t1 - t0
    tp["s"] += time.perf_counter() - t1
    return out


def model_sum(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``x``, a product that contracted a dimension the installed rules
    split by logical ``axis``, summed over the processes that split it:
    the all-reduce XLA inserts where the reference constrains the product
    back to ``("batch", None, "embed")``.  The partials are summed in
    float32 and cast back: a bf16 partial was already rounded by the
    product that made it, but the running sum is not rounded between the
    processes' terms (at twice the bytes of a bf16 all-reduce).  The
    identity where the rules do not split ``axis`` or outside a mesh
    process."""
    split = _split(axis)
    if split is None:
        return x
    mesh, entry = split
    x32 = x.float()
    return _tally(mesh.comm, x32, lambda: mesh.comm.all_reduce(
        x32, entry)).to(x.dtype)


def model_gather(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Every process's block of ``x`` along its last dimension, split by
    logical ``axis`` under the installed rules, concatenated in the order
    of their coordinates (the vocabulary-split head's columns); the
    identity where the rules do not split ``axis`` or outside a mesh
    process."""
    split = _split(axis)
    if split is None:
        return x
    mesh, entry = split
    return _tally(mesh.comm, x,
                  lambda: mesh.comm.all_gather(x, entry, dim=-1))
