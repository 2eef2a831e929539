"""Dry run: one mesh process's step run on the ``meta`` device, with its
flops, bytes, memory and collective bytes counted.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles one
step on a faked production mesh and records what XLA reports for it.  The
port has no compiler and no faked devices: its mesh is a description
(:class:`~repro_torch.launch.mesh.Mesh`) and each of its processes runs its
step eagerly.  So the dry run runs **one process's step on ``meta``**
(tensors of a shape and a dtype, with no storage), through the code a
process of the port's mesh runs, not a copy of it:

- ``train``: :func:`repro_torch.training.train_loop._update_rank`, the part
  of a :class:`~repro_torch.training.train_loop.MeshTrainStep` process's
  step before its host reads: ``_mesh_grads`` (the host's trees read into
  the process's private copies, ``train_loss`` under ``use_mesh``, its
  gradients, the sums over ``model`` and the data all-reduce) and
  ``adamw_update``;
- ``prefill``: ``forward(mode="prefill")`` under ``use_mesh`` at the
  process's local config, on its rows and its caches;
- ``decode``: ``decode_step`` under ``use_mesh`` over full caches, as a
  :class:`~repro_torch.runtime.tensor.MeshTensorBackend` process runs it.

The process is rank 0 of ``make_production_mesh`` ((16, 16) over
``(data, model)``, or with ``--multi-pod`` (2, 16, 16) over
``(pod, data, model)``, whose batch axes are ``(pod, data)``;
:func:`analyse`'s ``rank`` picks another), holding its tensor-parallel view of the weights
(:func:`~repro_torch.sharding.rules.tensor_parallel` under ``tp_rules``),
its rows of the batch and its caches.  Under ``tp_rules`` every process of
the mesh has the same shapes -- each split dimension is cut into equal
blocks -- so one rank stands for all.  Its collectives go to
:class:`MetaComm`, a :class:`~repro_torch.core.stage_procs.Comm` that moves
nothing and tallies every operand's bytes as a real process's comm does.
What it counts is what the process would run, op by op, and the counts are
exact for its collectives and its matrix products.  Its figures are a
process's, the counterpart of the reference's figures a device
(``per_process`` in the record):

- ``cost_analysis["flops"]``: ``torch.utils.flop_counter.FlopCounterMode``:
  2mnk of every matrix product forward and backward (attention's QK^T and
  PV included); elementwise work is not counted, where XLA's figure counts
  it;
- ``cost_analysis["bytes accessed"]``: every aten op's input and output
  bytes, views excluded (:class:`StepCounter`).  This is eager, unfused
  traffic, so it bounds from above what a fused program moves;
- ``argument_size_in_bytes``: the process's arguments: its view of the
  parameters and, to train, of the float32 moments (an MoE layer's experts
  counted as its E/m block: a deployment holds only its own, as the
  reference's ``experts`` -> ``model`` placement does, while a port process
  views every expert and ``moe_ep`` takes its own at call time), its rows
  of the inputs and its caches.  The reference's AdamW step counter is an
  int32 argument; the port's is a host int.  ``process_argument_bytes``
  counts the same arguments as a port process has them, every expert of
  an MoE layer whole (a mesh trainer's private copies hold them all): with
  ``temp_size_in_bytes``, a process's peak device memory;
- ``output_size_in_bytes``: the step's outputs: to train, the updated
  parameters and moments, the loss and the gradient norm; to prefill, the
  last position's logits and the caches; to decode, the logits and the
  caches;
- ``temp_size_in_bytes``: the peak of the live storages the step created
  (:class:`StepCounter`: a storage is live from the op that made it to the
  drop of its last view), beyond its arguments; the outputs it creates are
  among them;
- ``collective_bytes``: :class:`MetaComm`'s operand bytes by the
  reference's five kinds (an all-gather's operand is the process's block,
  the result over the group, as the reference's ``collective_bytes``
  reads it; a stage hop is a ``collective-permute``) and ``broadcast``,
  with ``total`` their sum; ``collective_calls`` the calls by kind, and
  ``tp`` / ``dp`` the tensor-parallel and data-parallel tallies of
  :mod:`repro_torch.sharding.rules`.

There is no compile, so the record has no ``lower_s``, ``compile_s``,
``generated_code_size_in_bytes``, ``hlo_bytes_len`` or ``optimal_seconds``:
``run_s`` is the counted run's wall.  An eager run counts every layer, so
nothing is scan-corrected.  One loop is counted in part: the sLSTM's loop
over time (``models/xlstm.py``, ``apply_slstm_seq``), whose steps all have
the same shapes, runs 1 and then 2 steps and the rest is extrapolated (the
reference's own correction, over time instead of over layers): exact for
the flops, bytes, ops and collectives, a linear estimate for the temp peak;
the record's ``loops`` says so.

No kernel runs, in either package: ``impl`` is ``"ref"`` or ``"chunked"``
(the reference's ``"xla"`` is ``"ref"``; anything else raises).  No device
is touched: every tensor the step makes is ``meta`` and nothing is spawned.
It is the one entry point of the port that runs on no device, by its
nature, as the reference's runs on faked host devices and never on the TPU.

``--donate`` is accepted and recorded: the port's eager step already
updates its state in place (AdamW's parameters and moments, a cache's
``index_put_``); ``state_in_place`` in the record checks that every state
output is an argument's storage.

The port's mesh runs ``tp_rules`` over ``default_rules`` only.  Where the
reference picks ``long_context_rules`` (a decode batch smaller than the
``data`` axis), ``decode_seq_model_rules`` (``--rules``) or ``fsdp_rules``
(``--fsdp``, ``--fsdp-gather``), :func:`run_one` raises
``NotImplementedError`` naming the ROADMAP item; nothing runs another
placement instead.  An MoE layer whose experts ``model`` does not divide
runs ``moe_ragged``, whose group sizes are read on the host, which ``meta``
cannot give: such a record fails too.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
        [--out-dir ...]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import weakref
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.bridge import init_params
from repro_torch.configs import SHAPES, get_config
from repro_torch.core.stage_procs import COLLECTIVE_KINDS, Comm
from repro_torch.launch.mesh import Mesh, make_production_mesh, n_chips
from repro_torch.models import transformer as T
from repro_torch.models import xlstm
from repro_torch.models.attention import _check_decode_impl
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.models.frontends import input_spec_for
from repro_torch.sharding.rules import (axis_size, default_rules,
                                        local_slice, tensor_parallel,
                                        use_mesh)
from repro_torch.training.adamw import AdamWConfig, tree_leaves, tree_map
from repro_torch.training.train_loop import (TrainConfig, _RankTrainer,
                                             _update_rank)

PyTree = Any
META = torch.device("meta")

#: archs whose full-attention layers make 524k-token decode unreasonable
#: without the documented sliding-window variant (the reference's set).
LONG_CONTEXT_NATIVE = {"recurrentgemma-2b", "xlstm-1.3b", "gemma2-2b"}

#: the impls a dry run runs: no kernel, in either package
DRYRUN_IMPLS = ("ref", "chunked")

#: where the rule sets the port's mesh cannot run stand in the ROADMAP
SEQ_KV_ITEM = ("ROADMAP.md Queue 1, 'A KV cache split by sequence over a "
               "mesh axis'")
FSDP_ITEM = ("ROADMAP.md Queue 1, 'FSDP parameters gathered once a step "
             "for MeshTrainStep'")


def resolve_impl(impl: str) -> str:
    """``impl`` as the dry run runs it: the reference's ``"xla"`` is
    ``"ref"``; ``"ref"`` and ``"chunked"`` stand; anything else raises (a
    kernel cannot run on ``meta``: ``"cuda"``)."""
    impl = "ref" if impl == "xla" else impl
    _check_decode_impl(impl)
    if impl not in DRYRUN_IMPLS:
        raise ValueError(f"the dry run runs impl {DRYRUN_IMPLS} (or 'xla', "
                         f"which is 'ref'), not {impl!r}: no kernel runs on "
                         f"meta (ROADMAP.md, 'Waiting for a tracing issue': "
                         f"'impl=\"cuda\" in the dry run')")
    return impl


# --------------------------------------------------------------------------- #
# the collectives: a Comm that moves nothing
# --------------------------------------------------------------------------- #

class _MetaGroup:
    def __init__(self, size: int):
        self.size = size


class _MetaRequest:
    def wait(self) -> None:
        pass


class _MetaDist:
    """The ``torch.distributed`` calls a :class:`Comm` makes, moving
    nothing."""

    def __init__(self, size: int):
        self.size = size

    def get_world_size(self, group=None) -> int:
        return self.size if group is None else group.size

    def all_reduce(self, *args, **kw) -> None:
        pass

    broadcast = all_gather = all_to_all_single = all_reduce

    def isend(self, *args, **kw) -> _MetaRequest:
        return _MetaRequest()

    irecv = isend


class MetaComm(Comm):
    """A process's :class:`~repro_torch.core.stage_procs.Comm` on ``meta``:
    each collective returns a meta tensor of its result's shape and dtype
    and moves nothing; the tallies are the real comm's (``tp``, ``dp``,
    ``collectives`` by kind, ``zero_tp``), from the group sizes of the
    described ``mesh``: a group of its size for every tuple of its axes.  The staging buffers are host memory in a real
    process, so they are made outside the counters and do not count as the
    step's memory; the copy back to the device does.  ``moe_report``
    records the capacity and the row count only: the drops are data."""

    def __init__(self, mesh: Mesh):
        super().__init__(_MetaDist(mesh.size), META,
                         {axes: _MetaGroup(axis_size(mesh, axes))
                          for axes in mesh.axis_tuples()},
                         mesh.axis_names)

    def _buf(self, role: str, numel: int, dtype: torch.dtype) -> torch.Tensor:
        with _disable_current_modes():
            return torch.empty(numel, dtype=dtype, device=META)

    def moe_report(self, keep: torch.Tensor, cap: int, a2a_bytes: int,
                   ) -> None:
        self.moe_calls.append(dict(rows=keep.numel(), cap=cap,
                                   a2a_bytes=a2a_bytes))


def collective_bytes(comm: Comm) -> Dict[str, float]:
    """``comm``'s operand bytes by kind, and their ``total``: the
    reference's ``collective_bytes`` keys and ``broadcast``."""
    out = {k: float(comm.collectives[k]["bytes"]) for k in COLLECTIVE_KINDS}
    out["total"] = sum(out.values())
    return out


# --------------------------------------------------------------------------- #
# counting
# --------------------------------------------------------------------------- #

def _meta_tensors(tree) -> List[torch.Tensor]:
    return [t for t in _pytree_leaves(tree)
            if isinstance(t, torch.Tensor) and t.device.type == "meta"]


class StepCounter(TorchDispatchMode):
    """Counts the aten ops that run under it on ``meta``: ``ops`` (views
    excluded), ``bytes_accessed`` (each op's input and output bytes, views
    and ``empty`` allocations excluded: eager, unfused traffic) and the
    live bytes of the storages its ops created (``live``, its ``peak``).
    A storage is created by an op where it first appears as that op's
    output; a storage first seen as an input (an argument of the step) is
    not counted.  A storage is live until its last view is dropped
    (``weakref.finalize`` on it)."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0
        self._known: Dict[int, int] = {}

    def _see(self, t: torch.Tensor, created: bool) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._known:
            return
        n = st.nbytes() if created else 0
        self._known[key] = n
        weakref.finalize(st, self._drop, key)
        if n:
            self.live += n
            self.peak = max(self.peak, self.live)

    def _drop(self, key: int) -> None:
        self.live -= self._known.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _meta_tensors((args, kwargs))
        for t in ins:
            self._see(t, created=False)
        out = func(*args, **kwargs)
        outs = _meta_tensors(out)
        for t in outs:
            self._see(t, created=True)
        if not func.is_view:
            self.ops += 1
            if not func.overloadpacket.__name__.lstrip("_").startswith(
                    ("empty", "new_empty")):
                self.bytes_accessed += sum(_nbytes(t) for t in ins + outs)
        return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _view_key(t: torch.Tensor) -> Tuple:
    return (t.untyped_storage()._cdata, t.storage_offset(), tuple(t.shape),
            t.stride())


def tree_bytes(tree) -> int:
    """The bytes of the tensors of ``tree``, a view counted once (a tied
    head, the embedding's transpose, is a view of the embedding)."""
    views = {_view_key(t): _nbytes(t) for t in _meta_tensors(tree)}
    return sum(views.values())


@contextlib.contextmanager
def _slstm_steps(k: Optional[int]):
    """Run only the first ``k`` steps of each sLSTM loop over time
    (``xlstm.apply_slstm_seq``): every later step returns the ``k``-th
    step's outputs, which have the same shapes.  ``k`` None runs them
    all."""
    if k is None:
        yield
        return
    real = xlstm._slstm_step
    memo: Dict[str, Any] = dict(rec=None, n=0, out=None)

    def step(params, carry, xw, rec_w):
        if memo["rec"] is not rec_w:            # a new loop (a new layer)
            memo.update(rec=rec_w, n=0, out=None)
        if memo["n"] < k:
            memo["n"] += 1
            memo["out"] = real(params, carry, xw, rec_w)
        return memo["out"]

    xlstm._slstm_step = step
    try:
        yield
    finally:
        xlstm._slstm_step = real


def _counted(build: Callable[[], Tuple[Callable, Dict, Comm]],
             slstm_steps: Optional[int] = None) -> Dict[str, Any]:
    """Build one process's step (``build() -> (step, args, comm)``) and
    run it under the counters; its figures."""
    step, args, comm = build()
    counter = StepCounter()
    flops = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with _slstm_steps(slstm_steps), flops, counter:
        out = step()
    run_s = time.perf_counter() - t0
    arg_keys = {t.untyped_storage()._cdata for t in _meta_tensors(args)}
    state = _meta_tensors(out.get("state", ()))
    return dict(
        flops=float(flops.get_total_flops()),
        bytes_accessed=float(counter.bytes_accessed), ops=counter.ops,
        temp=counter.peak, args=args, out=out, comm=comm, run_s=run_s,
        in_place=all(t.untyped_storage()._cdata in arg_keys
                     for t in state))


def _extrapolate(one: Dict, two: Dict, trips: int) -> Dict:
    """``one`` + (``trips`` - 1) x (``two`` - ``one``) for every additive
    figure: a loop counted at 1 and 2 of its ``trips`` steps."""
    k = trips - 1

    def ext(a, b):
        return a + k * (b - a)

    out = dict(one, flops=ext(one["flops"], two["flops"]),
               bytes_accessed=ext(one["bytes_accessed"],
                                  two["bytes_accessed"]),
               ops=ext(one["ops"], two["ops"]),
               temp=ext(one["temp"], two["temp"]),
               run_s=one["run_s"] + two["run_s"])
    c1, c2 = one["comm"], two["comm"]
    for kind in COLLECTIVE_KINDS:
        for f in ("calls", "bytes"):
            c1.collectives[kind][f] = ext(c1.collectives[kind][f],
                                          c2.collectives[kind][f])
    for tally in ("tp", "dp"):
        for f in ("calls", "bytes"):
            getattr(c1, tally)[f] = ext(getattr(c1, tally)[f],
                                        getattr(c2, tally)[f])
    return out


# --------------------------------------------------------------------------- #
# the step of one process
# --------------------------------------------------------------------------- #

def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """Meta stand-ins for every model input of this workload, whole (the
    reference's ``ShapeDtypeStruct``\\ s)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.phase == "train":
        return {"tokens": input_spec_for(cfg, b, s, decode=False),
                "labels": torch.empty((b, s), dtype=torch.int32,
                                      device=META)}
    caches = T.init_caches(cfg, b, s, torch.bfloat16, device=META)
    return {"tokens": input_spec_for(cfg, b, s,
                                     decode=shape.phase == "decode"),
            "caches": caches}


class _MetaRank:
    """The stand-in for a mesh process (``mesh_procs._MeshRank``) that the
    trainer's and the pipeline's rank functions read: its mesh (with its
    rank and a :class:`MetaComm`), its device (``meta``), its totals, and
    whatever else ``fields`` give (``cfg``, ``params``, ``impl``,
    ``act_dtype``)."""

    def __init__(self, mesh: Mesh, **fields):
        self.mesh, self.comm, self.rank = mesh, mesh.comm, mesh.rank
        self.device = META
        self.totals = dict(host_s=0., device_s=0., hop_s=0., hop_bytes=0)
        self.__dict__.update(fields)

    def sync(self) -> None:
        pass

    def timed(self, fn: Callable, *args, **kw):
        return fn(*args, **kw)


def _moe_ragged_check(cfg: ModelConfig, mesh: Mesh) -> None:
    for spec in cfg.layer_specs():
        if spec.moe is not None \
                and spec.moe.num_experts % mesh.shape["model"]:
            raise ValueError(
                f"{cfg.name}: {spec.moe.num_experts} experts do not divide "
                f"over a model axis of {mesh.shape['model']}, so its MoE "
                f"runs moe_ragged, whose group sizes are read on the host "
                f"(moe._group_sizes): meta tensors hold no values")


def held_bytes(cfg: ModelConfig, mesh: Mesh, tree: Dict) -> int:
    """The bytes of a process's view of a parameter-shaped ``tree`` (the
    parameters or a moment), an MoE layer's experts counted as its block
    of E/m: what a deployment holds."""
    model = mesh.shape.get("model", 1)
    experts = {id(t) for spec, layer in zip(cfg.layer_specs(), tree["layers"])
               if spec.moe is not None and model > 1
               and spec.moe.num_experts % model == 0
               for k, t in layer["ffn"].items()
               if k in ("w_gate", "w_up", "w_down")}
    views = {_view_key(t): _nbytes(t) // (model if id(t) in experts else 1)
             for t in _meta_tensors(tree)}
    return sum(views.values())


def build_step(cfg: ModelConfig, shape: InputShape,
               xent_chunk: Optional[int] = None, mesh: Optional[Mesh] = None,
               rules=None, impl: str = "ref",
               ) -> Tuple[Callable[[], Dict], Dict, MetaComm]:
    """One process's step of ``shape`` on ``meta``: (``step()``, which runs
    it and returns its outputs, ``{"state": ..., ...}``; its arguments by
    name; its :class:`MetaComm`).  ``mesh`` is the described mesh with the
    process's rank (``Mesh.at``); its comm is made here.  ``rules``
    default to the mesh's ``default_rules``; the process computes by
    ``tp_rules`` over them (the trainer by its own, ``tp_rules`` over
    the default ones)."""
    comm = MetaComm(mesh)
    at = mesh.at(mesh.rank, comm)
    _moe_ragged_check(cfg, at)
    params = init_params(cfg, None, META)
    specs = input_specs(cfg, shape)
    if shape.phase == "train":
        rank = _MetaRank(at)

        def moment(p):
            return torch.empty(p.shape, dtype=torch.float32, device=META)
        tcfg = TrainConfig(impl=impl, optimizer=AdamWConfig(),
                           xent_chunk=xent_chunk)
        tr = rank.trainer = _RankTrainer(rank, cfg, tcfg, params,
                                         tree_map(moment, params),
                                         tree_map(moment, params))
        trees = []
        for leaves in tr.state:
            it = iter(leaves)
            trees.append(tree_map(lambda _: next(it), params))
        rows = {k: local_slice(v, tr.rules.spec(("batch",)), at)
                for k, v in specs.items()}
        args = dict(params=trees[0], mu=trees[1], nu=trees[2], **rows)

        def step():
            loss, gnorm, _ = _update_rank(rank, specs["tokens"],
                                          specs["labels"], 0)
            return dict(state=trees, loss=loss, grad_norm=gnorm)
        return step, args, comm

    tp_cfg, tp_params, rules = tensor_parallel(cfg, params, at, rules)
    batch = rules.spec(("batch",))
    tokens = local_slice(specs["tokens"], batch, at)
    b = tokens.shape[0]
    caches = T.init_caches(tp_cfg, b, shape.seq_len, torch.bfloat16,
                           device=META)
    args = dict(params=tp_params, tokens=tokens, caches=caches)
    if shape.phase == "prefill":
        def step():
            with use_mesh(at, rules):
                logits, out = T.forward(tp_cfg, tp_params, tokens, caches,
                                        mode="prefill", impl=impl)
            return dict(state=out, logits=logits[:, -1])
    else:
        def step():
            with use_mesh(at, rules):
                logits, out = T.decode_step(tp_cfg, tp_params, tokens,
                                            caches, impl=impl)
            return dict(state=out, logits=logits)
    return step, args, comm


def analyse(cfg: ModelConfig, shape: InputShape, mesh: Mesh, rules=None,
            rank: int = 0, xent_chunk: Optional[int] = None,
            impl: str = "ref") -> Dict[str, Any]:
    """Run process ``rank``'s step of (``cfg``, ``shape``) on ``mesh`` under
    the counters; the record's figures."""
    at = mesh.at(rank)

    def build():
        return build_step(cfg, shape, xent_chunk, at, rules, impl)

    loops = []
    kinds = {s.kind for s in cfg.layer_specs()}
    if "slstm" in kinds and shape.phase != "decode" and shape.seq_len > 2:
        got = _extrapolate(_counted(build, 1), _counted(build, 2),
                           shape.seq_len)
        loops.append(dict(
            loop="models/xlstm.py apply_slstm_seq: the sLSTM's steps over "
                 "time", trips=shape.seq_len,
            counted="steps 1 and 2, the rest extrapolated"))
    else:
        got = _counted(build)
    comm, args = got["comm"], got["args"]
    arg_bytes = sum(held_bytes(cfg, mesh, args[k]) if k in ("params", "mu",
                                                             "nu")
                    else tree_bytes(args[k]) for k in args)
    specs = input_specs(cfg, shape)
    params = init_params(cfg, None, META)
    global_bytes = tree_bytes(params) + tree_bytes(specs)
    if shape.phase == "train":
        # the float32 moments, and the AdamW step: an int32 in the
        # reference's state (a host int in the port's)
        global_bytes += 2 * 4 * sum(t.numel() for t in tree_leaves(params))
        global_bytes += 4
    return {
        "rank": rank, "per_process": True,
        "run_s": round(got["run_s"], 3),
        "cost_analysis": {"flops": got["flops"],
                          "bytes accessed": got["bytes_accessed"]},
        "ops": got["ops"],
        "argument_size_in_bytes": int(arg_bytes),
        "process_argument_bytes": int(sum(tree_bytes(a)
                                          for a in args.values())),
        "output_size_in_bytes": int(tree_bytes(got["out"])),
        "temp_size_in_bytes": int(got["temp"]),
        "collective_bytes": collective_bytes(comm),
        "collective_calls": {k: int(comm.collectives[k]["calls"])
                             for k in COLLECTIVE_KINDS},
        "tp": {k: int(comm.tp[k]) for k in ("calls", "bytes")},
        "dp": {k: int(comm.dp[k]) for k in ("calls", "bytes")},
        "moe_calls": len(comm.moe_calls),
        "state_in_place": got["in_place"],
        "loops": loops,
        "global_argument_bytes": int(global_bytes),
    }


# --------------------------------------------------------------------------- #
# records
# --------------------------------------------------------------------------- #

def run_one(arch: str, shape_name: str, multi_pod: bool = False,
            variant: Optional[str] = None, out_dir: Optional[str] = None,
            mesh: Optional[Mesh] = None, rules_variant: Optional[str] = None,
            fsdp: bool = False, xent_chunk: Optional[int] = None,
            donate: bool = False, fsdp_gather: bool = False,
            impl: str = "ref", tag_suffix: str = "") -> Dict[str, Any]:
    """One (arch, shape) record: process 0's step on ``mesh`` (the
    production mesh by default), which stands for every process.  The
    rules are picked as the reference picks them; the ones the port's mesh
    cannot run raise ``NotImplementedError``."""
    impl = resolve_impl(impl)
    _check_decode_impl(impl)   # library callers bypass argparse choices
    cfg = get_config(arch, variant=variant)
    shape = SHAPES[shape_name]
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    long_ctx = (shape.phase == "decode"
                and shape.global_batch < mesh.shape["data"])
    if rules_variant == "decode-seq-model":
        raise NotImplementedError(
            f"decode_seq_model_rules (the KV cache split by sequence over "
            f"model) is not on the port's mesh: {SEQ_KV_ITEM}")
    if long_ctx:
        raise NotImplementedError(
            f"long_context_rules ({shape.global_batch} rows for a data axis "
            f"of {mesh.shape['data']}: the KV cache split by sequence over "
            f"data) is not on the port's mesh: {SEQ_KV_ITEM}")
    if rules_variant is not None:
        raise ValueError(f"unknown rules variant {rules_variant!r}")
    if fsdp_gather:
        fsdp = True
    if fsdp:
        raise NotImplementedError(
            f"fsdp_rules (weights and moments split over data) is not on "
            f"the port's mesh: {FSDP_ITEM}")
    rules = default_rules("pod" in mesh.axis_names)
    rec: Dict[str, Any] = {
        "arch": cfg.name, "shape": shape_name,
        "mesh": dict(mesh.shape), "chips": n_chips(mesh),
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "phase": shape.phase, "long_context_rules": bool(long_ctx),
        "rules_variant": rules_variant, "fsdp": fsdp,
        "xent_chunk": xent_chunk, "donate": donate,
        "fsdp_gather": fsdp_gather,
        "impl": impl if impl != "ref" else None,
    }
    rec.update(analyse(cfg, shape, mesh, rules, 0, xent_chunk, impl))
    rec["ok"] = True
    if out_dir:
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        tag = f"{cfg.name}{tag_suffix}_{shape_name}_" \
              f"{'multipod' if multi_pod else 'pod'}"
        Path(out_dir, tag.replace("/", "-") + ".json").write_text(
            json.dumps(rec, indent=1))
    return rec


#: which variant each arch needs for long_500k (None = skip impossible)
def long500k_variant(arch: str) -> Optional[str]:
    if arch in LONG_CONTEXT_NATIVE:
        return None            # native sub-quadratic / sliding support
    return "swa"               # documented sliding-window override


def iter_all(multi_pod: bool = False):
    from repro_torch.configs import ASSIGNED
    for arch in ASSIGNED:
        for shape_name in SHAPES:
            variant = None
            if shape_name == "long_500k":
                variant = long500k_variant(arch)
            yield arch, shape_name, variant


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="One mesh process's step on the meta device: flops, "
                    "bytes, memory and collective bytes (no device).")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--variant", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out-dir", default="benchmarks/results/dryrun")
    ap.add_argument("--rules", default=None, dest="rules_variant",
                    choices=[None, "decode-seq-model"],
                    help="sharding-rule variant (not on the port's mesh: "
                         "the record fails)")
    ap.add_argument("--fsdp", action="store_true",
                    help="shard params+opt over the data axis (not on the "
                         "port's mesh: the record fails)")
    ap.add_argument("--xent-chunk", type=int, default=None,
                    help="chunked cross-entropy (never materialize logits)")
    ap.add_argument("--donate", action="store_true",
                    help="recorded; the port's step updates its state in "
                         "place")
    ap.add_argument("--fsdp-gather", action="store_true",
                    help="FSDP with one explicit per-step weight gather "
                         "(implies --fsdp)")
    ap.add_argument("--impl", default="ref",
                    choices=["ref", "xla", "chunked"],
                    help="attention impl for train/prefill (chunked = "
                         "online softmax over key blocks; xla = ref)")
    ap.add_argument("--tag-suffix", default="",
                    help="suffix for the output json (perf iterations)")
    args = ap.parse_args(argv)

    mesh = make_production_mesh(multi_pod=args.multi_pod)
    if args.all:
        for arch, shape_name, variant in iter_all(args.multi_pod):
            try:
                rec = run_one(arch, shape_name, args.multi_pod, variant,
                              args.out_dir, mesh=mesh)
                print(f"OK  {arch:24s} {shape_name:12s} "
                      f"run={rec['run_s']:.1f}s "
                      f"flops={rec['cost_analysis'].get('flops', 0):.3g} "
                      f"coll={rec['collective_bytes']['total']:.3g}B",
                      flush=True)
            except Exception as e:  # noqa: BLE001 -- report and continue
                print(f"FAIL {arch:24s} {shape_name:12s} "
                      f"{type(e).__name__}: {e}", flush=True)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        rec = run_one(args.arch, args.shape, args.multi_pod, args.variant,
                      args.out_dir, mesh=mesh,
                      rules_variant=args.rules_variant, fsdp=args.fsdp,
                      xent_chunk=args.xent_chunk, donate=args.donate,
                      fsdp_gather=args.fsdp_gather, impl=args.impl,
                      tag_suffix=args.tag_suffix)
        print(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
