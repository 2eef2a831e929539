"""Logical-axis sharding rules, and a rank's shard of a tensor.

Port of ``repro.sharding.rules``.  Model code names tensor dimensions with
*logical* axes ("batch", "heads", "ff", "experts", ...); an
:class:`AxisRules` maps them to mesh axes, and :func:`use_mesh` installs a
(mesh, rules) pair for the code that runs under it.  The reference hands
the resulting shardings to XLA; here a mesh is a grid of processes
(:mod:`repro_torch.launch.mesh`) and every placement is explicit:
:func:`local_slice` cuts one rank's block out of a tensor by its spec.

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
import math
import threading
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple, Union

import torch

from repro_torch.launch.mesh import Mesh

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
    coords = mesh.coords()
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        n = axis_size(mesh, entry)
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                             f"split into {n} blocks over {axes}")
        block = 0
        for a in axes:
            block = block * mesh.shape[a] + coords[a]
        size = x.shape[dim] // n
        x = x.narrow(dim, block * size, size)
    return x


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
    and the collectives that move it are explicit."""
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
