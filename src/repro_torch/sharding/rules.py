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
and the config of its local head, ff and RG-LRU channel counts
(:func:`local_config`).
Where the reference constrains a product over a split dimension back to
``("batch", None, "embed")`` and XLA inserts the all-reduce, the model
code calls :func:`model_sum`; where a whole value enters a split region,
:func:`model_copy`; the vocabulary-split head calls :func:`model_gather`.
All three are the identity outside a mesh process.  Under autograd every
collective here has its exact adjoint for a backward (Megatron's
conventions over ``model``, data parallelism's over the batch axes; the
section "collectives under autograd" below), and :func:`tp_leaves` tells
the trainer which of a process's leaves are split over ``model`` and
which whole ones get only a process's share of their gradient.

Default production mapping (single-pod (data, model) / multi-pod
(pod, data, model)):

    batch    -> (pod?, data)       activations & KV cache
    heads    -> model              attention TP (Megatron)
    kv_heads -> model
    ff       -> model              MLP TP
    experts  -> model              expert parallelism
    rnn      -> model              RG-LRU channels
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


def spec_axes(spec: Sequence[MeshAxes]) -> Tuple[str, ...]:
    """Every mesh axis a spec places a dimension over, in its order."""
    return tuple(a for entry in spec for a in _axes(entry))


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
      query heads and the K/V heads of exactly those, so the heads split
      only where both head counts divide by the axis, read from the config
      (a flattened ``qkv`` width may divide where one head does not:
      recurrentgemma-2b's ``wk`` is one head of 256), and where an mLSTM
      block's up-projection width divides too (its heads are
      ``cfg.n_heads`` blocks of that width);
    - ``ff`` where every ``ff`` width divides: ``d_ff`` and an sLSTM
      block's up-projection ``int(d_model * slstm_proj_factor)`` (as
      :func:`shape_aware_sharding_tree` drops an axis); ``vocab`` where
      ``vocab_size`` divides;
    - ``rnn`` where the RG-LRU width ``cfg.rnn_dim`` divides."""
    rules = rules or default_rules("pod" in mesh.axis_names)
    table = dict(rules.rules)

    def divides(axis: str, *counts: int) -> bool:
        n = axis_size(mesh, table.get(axis))
        return all(c > 0 and c % n == 0 for c in counts)

    kinds = {spec.kind for spec in cfg.layer_specs()}
    if not (kinds & {"attn", "mlstm"}
            and divides("qkv", cfg.n_heads, cfg.n_kv_heads)
            and ("mlstm" not in kinds or divides("qkv", _mlstm_width(cfg)))):
        table.update({a: None for a in _HEAD_AXES})
    ff = ([cfg.d_ff] if cfg.d_ff else []) + (
        [int(cfg.d_model * cfg.slstm_proj_factor)] if "slstm" in kinds
        else [])
    if not (ff and divides("ff", *ff)):
        table["ff"] = None
    if not divides("vocab", cfg.vocab_size):
        table["vocab"] = None
    if not ("rglru" in kinds and divides("rnn", cfg.rnn_dim)):
        table["rnn"] = None
    return AxisRules(tuple(table.items()))


def _mlstm_width(cfg: ModelConfig) -> int:
    """An mLSTM block's up-projection width: its ``n_heads`` heads."""
    return int(cfg.d_model * cfg.mlstm_proj_factor)


def local_config(cfg: ModelConfig, mesh: Mesh,
                 rules: AxisRules) -> ModelConfig:
    """``cfg`` as one process of ``mesh`` runs it under ``rules``
    (:func:`tp_rules`): its query and K/V heads, its ``d_ff`` and its
    RG-LRU width the local counts, every head width whole; the vocabulary
    stays whole, as sampling sees it.  An mLSTM block reads its head width
    as ``d_model * mlstm_proj_factor // n_heads``, so the factor is divided
    with the heads; an sLSTM block, whole on every process, reads its head
    count from its recurrent weights."""
    heads = axis_size(mesh, rules.spec(("qkv",))[0])
    ff = axis_size(mesh, rules.spec(("ff",))[0])
    rnn = axis_size(mesh, rules.spec(("rnn",))[0])
    local = dict(n_heads=cfg.n_heads // heads,
                 n_kv_heads=cfg.n_kv_heads // heads,
                 head_dim=cfg.resolved_head_dim, d_ff=cfg.d_ff // ff)
    if rnn > 1:
        local["rnn_width"] = cfg.rnn_dim // rnn
    if heads > 1 and any(s.kind == "mlstm" for s in cfg.layer_specs()):
        pf = cfg.mlstm_proj_factor / heads
        if int(cfg.d_model * pf) * heads != _mlstm_width(cfg):
            raise ValueError(f"an mLSTM width of {_mlstm_width(cfg)} does "
                             f"not split into {heads} blocks")
        local["mlstm_proj_factor"] = pf
    return dataclasses.replace(cfg, **local)


#: the mLSTM's placement under tensor parallelism, Megatron's (one sum a
#: layer): the up-projection whole, every head's q/k/v columns, gates and
#: output gate on its process, the down-projection split by rows.  The
#: reference's axes split ``w_up``'s columns and the q/k/v rows instead,
#: which would contract a split dimension five times a layer.
_MLSTM_TP = {"w_up": (None, None), "w_gate": (None, "heads"),
             **{k: (None, "heads") for k in ("wq", "wk", "wv", "w_i",
                                             "w_f")},
             "b_i": ("heads",), "b_f": ("heads",),
             "w_down": ("heads", None)}


def _tp_specs(cfg: ModelConfig, mesh: Mesh, rules: AxisRules) -> Dict:
    """The spec of every leaf of a tensor-parallel process's view, in the
    parameters' structure: :func:`param_sharding_tree` of the reference's
    axes under ``rules``, except where the port places otherwise: the
    mLSTM in Megatron's form (``_MLSTM_TP``), an sLSTM's recurrent weights
    whole (its recurrence runs whole on every process; only its
    up/down-projection splits, by ``ff``), and the MoE FFNs whole
    (``moe_ep`` takes its experts itself)."""
    axes = param_axes(cfg)

    def whole(tree):
        return _map(lambda a: (None,) * len(a), tree, _is_axes_leaf)

    for spec, layer in zip(cfg.layer_specs(), axes["layers"]):
        if spec.kind == "mlstm":
            layer["mixer"] = dict(_MLSTM_TP)
        elif spec.kind == "slstm":
            layer["mixer"].update(whole({k: v for k, v in
                                         layer["mixer"].items()
                                         if k.startswith("r_")}))
        if spec.moe is not None:
            layer["ffn"] = whole(layer["ffn"])
    return _map(lambda sh: sh.spec, param_sharding_tree(axes, mesh, rules),
                lambda t: isinstance(t, NamedSharding))


def tensor_parallel(cfg: ModelConfig, params: Dict, mesh: Mesh,
                    rules: Optional[AxisRules] = None,
                    ) -> Tuple[ModelConfig, Dict, AxisRules]:
    """One process's view of the model on ``mesh``: (its config, its
    parameters, the rules to install with :func:`use_mesh`).  Every leaf
    is :func:`local_slice`\\ d by :func:`_tp_specs` under
    :func:`tp_rules` -- views of ``params``' tensors, so the weights stay
    held once: its heads (attention's, an mLSTM's), ``ff`` columns,
    RG-LRU channels and vocabulary rows; an sLSTM's recurrence and the MoE
    FFNs whole (``moe_ep`` takes its experts itself)."""
    rules = tp_rules(cfg, mesh, rules)
    placed = _map(lambda spec, x: local_slice(x, spec, mesh),
                  _tp_specs(cfg, mesh, rules), lambda t: isinstance(t, P),
                  params)
    return local_config(cfg, mesh, rules), placed, rules


def tp_leaves(cfg: ModelConfig, mesh: Mesh, rules: AxisRules, params: Dict,
              ) -> Tuple[list, list, list]:
    """What a trainer needs of each leaf of a process's view (rules from
    :func:`tp_rules`), three lists in the order of the leaves of
    ``params`` (the parameters, or a tree of their structure;
    :func:`repro_torch.training.adamw.tree_leaves`): its spec;
    whether it is split over ``model`` (its squares summed over ``model``
    in the gradient's norm); whether it is whole but read inside a region
    split over ``model``, so that each process's gradient is its share
    and is summed over ``model`` after the backward: ``q_norm`` and
    ``k_norm`` on the local heads, an mLSTM's whole up-projection ``w_up``
    (whose output feeds the local heads), and the router and the experts
    of an MoE layer that runs ``moe_ep`` (each process routes its own
    tokens and holds its own experts' gradients)."""
    specs = _tp_specs(cfg, mesh, rules)
    model = tuple(a for a in mesh.axis_names if a not in batch_axes(mesh))
    split = _map(lambda spec: any(a in model and mesh.shape[a] > 1
                                  for a in spec_axes(spec)),
                 specs, lambda t: isinstance(t, P))
    partial = _map(lambda _: False, specs, lambda t: isinstance(t, P))
    heads = axis_size(mesh, rules.spec(("qkv",))[0]) > 1
    ep = "model" in mesh.shape and mesh.shape["model"] > 1
    for spec, layer in zip(cfg.layer_specs(), partial["layers"]):
        if spec.kind == "attn" and heads:
            for k in ("q_norm", "k_norm"):
                if k in layer["mixer"]:
                    layer["mixer"][k] = True
        if spec.kind == "mlstm" and heads:
            layer["mixer"]["w_up"] = True
        if spec.moe is not None and ep and \
                spec.moe.num_experts % mesh.shape["model"] == 0:
            for k in ("router", "w_gate", "w_up", "w_down"):
                layer["ffn"][k] = True
    out: Tuple[list, list, list] = ([], [], [])
    _map(lambda _, *leaf: [o.append(x) for o, x in zip(out, leaf)], params,
         lambda t: not isinstance(t, (dict, list)), specs, split, partial)
    return out


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


def _tally(comm, x: torch.Tensor, run, kind: str = "tp") -> torch.Tensor:
    """Run one collective on operand ``x``, tallied in ``comm.<kind>``
    (``tp``: the tensor-parallel sites, forward and backward; ``dp``: the
    trainer's gradient sums over the batch axes): the wait for the device
    before it (``wait_s``), the collective with its copies (``s``), the
    bytes of ``x`` (what each process hands to gloo)."""
    t0 = time.perf_counter()
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    t1 = time.perf_counter()
    out = run()
    tally = getattr(comm, kind)
    tally["calls"] += 1
    tally["bytes"] += x.numel() * x.element_size()
    tally["wait_s"] += t1 - t0
    tally["s"] += time.perf_counter() - t1
    return out


# --------------------------------------------------------------------------- #
# collectives under autograd
# --------------------------------------------------------------------------- #
#
# A value that a mesh process holds whole is one logical value held by every
# process of the axes it is replicated over, and its gradients follow two
# conventions, one for each kind of axis:
#
# - over ``model`` (Megatron's): every process holds the whole gradient, the
#   same on each.  A sum over ``model`` passes the cotangent through to each
#   partial; where a whole value enters a region split over ``model``, each
#   process's share of its gradient is summed over ``model``.
# - over the batch axes (data parallelism): each data row's copy holds the
#   gradient of its own rows' loss, and the trainer averages the parameters'
#   gradients over the batch axes once a step.  A gather over them sums the
#   cotangent over them before it takes its own block.
#
# So each collective's backward sums over the batch axes among its own where
# its forward replicates over them, and over ``model`` where its forward
# splits.


class _Collective(torch.autograd.Function):
    """``fwd(x)``, whose backward is ``bwd(cotangent)``."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return fwd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g.contiguous()), None, None


def collective(x: torch.Tensor, fwd, bwd) -> torch.Tensor:
    """``fwd(x)``, a collective, with ``bwd`` its adjoint where autograd
    records ``x``; ``fwd(x)`` alone elsewhere."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Collective.apply(x, fwd, bwd)
    return fwd(x)


def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The mesh axes the installed rules give ``"batch"``: the data
    parallel ones, whose replicas' gradients the trainer averages."""
    rules = current_rules() or default_rules("pod" in mesh.axis_names)
    return _axes(rules.spec(("batch",))[0])


def reduce_over(mesh: Mesh, axes: Sequence[str], x: torch.Tensor,
                kind: Optional[str] = None) -> torch.Tensor:
    """The sum of ``x`` over the processes of mesh ``axes`` (the axes of
    one point dropped), tallied in ``mesh.comm.<kind>`` when ``kind`` is
    given; ``x`` itself where they have one point."""
    axes = tuple(a for a in mesh.axis_names
                 if a in axes and mesh.shape[a] > 1)
    if not axes:
        return x
    run = lambda: mesh.comm.all_reduce(x, axes)  # noqa: E731
    return _tally(mesh.comm, x, run, kind) if kind else run()


def _model_axes(mesh: Mesh, axes: Tuple[str, ...]) -> Tuple[str, ...]:
    data = batch_axes(mesh)
    return tuple(a for a in axes if a not in data)


def _data_axes(mesh: Mesh, axes: Tuple[str, ...]) -> Tuple[str, ...]:
    data = batch_axes(mesh)
    return tuple(a for a in axes if a in data)


def gather_blocks(x: torch.Tensor, entry: MeshAxes,
                  mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Every process's block of a tensor split along its first dimension
    by the mesh axes of ``entry``, concatenated in their coordinates'
    order.  Backward: the cotangent summed over the batch axes among
    them, and this process's block of it."""
    mesh = mesh or current_mesh()
    axes = _axes(entry)
    n = x.shape[0]

    def bwd(g):
        g = reduce_over(mesh, _data_axes(mesh, axes), g)
        return g.narrow(0, _block(mesh, entry) * n, n)
    return collective(x, lambda t: mesh.comm.all_gather(t, entry), bwd)


def take_block(x: torch.Tensor, entry: MeshAxes,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """This process's block of ``x`` along its first dimension, split by
    the mesh axes of ``entry`` (:func:`local_slice`).  Backward: the
    cotangent in the block's place, zeros elsewhere, summed over the
    axes among them other than the batch axes."""
    mesh = mesh or current_mesh()
    axes = _axes(entry)
    shape = x.shape

    def bwd(g):
        whole = g.new_zeros(shape)
        local_slice(whole, (entry,), mesh).copy_(g)
        return reduce_over(mesh, _model_axes(mesh, axes), whole)
    return collective(x, lambda t: local_slice(t, (entry,), mesh), bwd)


def mean_over_mesh(x: torch.Tensor, mesh: Optional[Mesh] = None,
                   ) -> torch.Tensor:
    """The mean of every process's ``x``.  Backward: the cotangent summed
    over the batch axes, over the process count."""
    mesh = mesh or current_mesh()
    every = tuple(mesh.axis_names)
    return collective(
        x, lambda t: mesh.comm.all_reduce(t) / mesh.size,
        lambda g: reduce_over(mesh, _data_axes(mesh, every), g) / mesh.size)


def all_to_all(x: torch.Tensor, axis: str,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``Comm.all_to_all`` of ``x`` [n, ...] over the ``n`` processes of
    ``axis``; its own adjoint, so the backward is the same exchange of
    the cotangent."""
    mesh = mesh or current_mesh()
    run = lambda t: mesh.comm.all_to_all(t, axis)  # noqa: E731
    return collective(x, run, run)


def model_sum(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``x``, a product that contracted a dimension the installed rules
    split by logical ``axis``, summed over the processes that split it:
    the all-reduce XLA inserts where the reference constrains the product
    back to ``("batch", None, "embed")`` (Megatron's *g*; its backward is
    the identity on each process's partial).  The partials are summed in
    float32 and cast back: a bf16 partial was already rounded by the
    product that made it, but the running sum is not rounded between the
    processes' terms (at twice the bytes of a bf16 all-reduce).  The
    identity where the rules do not split ``axis`` or outside a mesh
    process."""
    split = _split(axis)
    if split is None:
        return x
    mesh, entry = split

    def fwd(t):
        t32 = t.float()
        return _tally(mesh.comm, t32, lambda: mesh.comm.all_reduce(
            t32, entry)).to(t.dtype)
    return collective(x, fwd, lambda g: g)


def model_copy(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``x``, a whole value entering a region the installed rules split by
    logical ``axis`` (Megatron's *f*): the identity, whose backward sums
    each process's share of the gradient over the processes that split
    ``axis`` (in float32, as :func:`model_sum`).  The identity both ways
    exactly where :func:`model_sum` is."""
    split = _split(axis)
    if split is None:
        return x
    mesh, entry = split

    def bwd(g):
        g32 = g.float()
        return _tally(mesh.comm, g32, lambda: mesh.comm.all_reduce(
            g32, entry)).to(g.dtype)
    return collective(x, lambda t: t.view_as(t), bwd)


def model_gather(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Every process's block of ``x`` along its last dimension, split by
    logical ``axis`` under the installed rules, concatenated in the order
    of their coordinates (the vocabulary-split head's columns); its
    backward is this process's block of the cotangent.  The identity
    where the rules do not split ``axis`` or outside a mesh process."""
    split = _split(axis)
    if split is None:
        return x
    mesh, entry = split
    n = x.shape[-1]
    return collective(
        x, lambda t: _tally(mesh.comm, t, lambda: mesh.comm.all_gather(
            t, entry, dim=-1)),
        lambda g: g.narrow(-1, _block(mesh, entry) * n, n))
