"""The ``(data, model)`` mesh as a grid of processes: one process a point.

The counterpart of the reference's programs under ``shard_map`` on its
mesh: the GPipe forward (``src/repro/core/pipeline.py:203-277``, stages
over one axis with ``ppermute``, micro-batch rows over the others) and the
whole-model forward whose MoE layers run expert-parallel
(``src/repro/models/moe.py:140-167``, capacity buckets exchanged with
``all_to_all`` over ``model``).  :class:`MeshProcs` spawns one process per
point of a :class:`~repro_torch.launch.mesh.Mesh` on the machinery of
:mod:`repro_torch.core.stage_procs` (:class:`ProcGroup`: spawn, a file
rendezvous, one command at a time from the host, named failures,
shutdown); each process builds a ``torch.distributed`` ``DeviceMesh`` over
the gloo world, so each axis has its own process group, and runs its
collectives through :class:`~repro_torch.core.stage_procs.Comm`'s staging
buffers.  Each process runs one CPU thread.

- **weights**: every process gets the model's own tensors (CUDA IPC on the
  card, shared memory on the CPU), so they are held once however many
  processes read them: a stage's data replicas read the same layer
  tensors, and an expert-parallel MoE layer reads its rank's experts
  through :func:`~repro_torch.sharding.rules.local_slice` (views);
- **inputs and outputs**: the host sends the whole input in the command
  and each process takes its rows with ``local_slice``; the logits go into
  one tensor the host allocates and shares, each process writing its own
  rows, in the order of the token rows;
- :meth:`MeshProcs.pipeline_forward`: stage ``s`` is a process's
  ``stage_axis`` coordinate (its layers a range of ``params["layers"]``,
  :func:`repro_torch.core.pipeline.stage_layers`; the reference pads every
  stage to ``l_max`` periods), each micro-batch's rows split over
  ``batch_axes``; stage ``s`` runs micro-batch ``t - s`` at step ``t`` and
  hands its output ``[mb / |batch|, S, d]`` to stage ``s + 1`` in its data
  row; the last stage runs the final norm and the LM head;
- :meth:`MeshProcs.forward`: ``forward(mode="train")`` on every process
  under :func:`~repro_torch.sharding.rules.use_mesh`, batch rows over
  ``data``, tensor-parallel over ``model``
  (:func:`~repro_torch.sharding.rules.tensor_parallel`, the reference's
  ``param_sharding_tree`` placement): each process holds its query and
  K/V heads, its ``ff`` columns and its vocabulary rows (views), the
  output and down projections and the embedding are summed over
  ``model`` and the head's columns gathered; every MoE layer whose
  experts ``model`` divides runs :func:`repro_torch.models.moe.moe_ep`.
  The serving :class:`~repro_torch.runtime.tensor.TensorBackend` on a
  mesh runs its processes here too (:meth:`MeshProcs.run`).

``impl="cuda"`` runs the kernels in the processes; :meth:`MeshProcs.stats`
gathers each process's kernel launches, its seconds (dispatching, waiting
for the device, in the hops), its hop bytes, its MoE calls and its
tensor-parallel collectives.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Sequence

import torch

from repro_torch.core import pipeline as PL
from repro_torch.core.stage_procs import (DEFAULT_TIMEOUT, Comm, ProcGroup,
                                          kernel_wrappers)
from repro_torch.device import Device, resolve_device
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_norm, lm_logits
from repro_torch.sharding.rules import (P, axis_size, current_rules,
                                        default_rules, local_config,
                                        local_slice, tensor_parallel,
                                        use_mesh)


def microbatch_rows(b: int, n_microbatches: int, n_rows: int) -> int:
    """Rows of a micro-batch; raises where ``b`` is no whole number of
    ``n_microbatches``, or a micro-batch no whole number of ``n_rows``
    blocks (the batch axes' points)."""
    if b % n_microbatches:
        raise ValueError(f"batch {b} is no multiple of {n_microbatches} "
                         f"micro-batches")
    mb = b // n_microbatches
    if mb % n_rows:
        raise ValueError(f"a micro-batch of {mb} rows does not split over "
                         f"{n_rows} points of the batch axes")
    return mb


class MeshProcs(ProcGroup):
    """One process per point of ``mesh``, each with ``params`` (the
    tensors themselves, shared); the host side.  ``device`` is where the
    processes run: the card by default, which raises without one; pass
    ``"cpu"`` to run on the CPU.  Call :meth:`close` when done."""

    kind = "mesh"

    def __init__(self, cfg: ModelConfig, params: Dict, mesh: Mesh, *,
                 impl: str = "ref", device: Device = None,
                 timeout: float = DEFAULT_TIMEOUT):
        self.cfg, self.params, self.impl = cfg, params, impl
        self.mesh = Mesh(mesh.axis_names, mesh.sizes)
        self.device = resolve_device(device)
        job = dict(cfg=cfg, params=params, mesh=self.mesh, impl=impl,
                   device=str(self.device),
                   act_dtype=params["embedding"].dtype)
        self._spawn(_MeshRank, [job] * self.mesh.size, impl=impl,
                    device=self.device, timeout=timeout)

    def run(self, fn: Callable, *args, **kw) -> List[Any]:
        """``fn(rank, *args, **kw)`` under ``torch.no_grad`` on every
        process (``rank`` its :class:`_MeshRank`); their results by rank.
        ``fn`` is pickled by name: a module-level function."""
        return self._call(("run", fn, args, kw))

    def pipeline_forward(self, tokens: torch.Tensor, spec: PL.PipelineSpec,
                         n_microbatches: int, stage_axis: str = "model",
                         batch_axes: Sequence[str] = ("data",),
                         ) -> torch.Tensor:
        """GPipe-style microbatched train-mode forward over the mesh:
        tokens [B, S] (or a frontend's float embeddings [B, S, d]) ->
        logits [B, S, V], the stages over ``stage_axis`` (whose size is
        ``spec.n_stages``), each micro-batch's rows over ``batch_axes``."""
        if self.mesh.shape[stage_axis] != spec.n_stages:
            raise ValueError(f"{spec.n_stages} stages on a {stage_axis} "
                             f"axis of {self.mesh.shape[stage_axis]}")
        PL.stage_layers(self.cfg, spec)
        b, s = tokens.shape[:2]
        microbatch_rows(b, n_microbatches,
                        axis_size(self.mesh, tuple(batch_axes)))
        out = self._out((b, s, self.cfg.vocab_size))
        self.run(_pipeline_rank, tokens, spec, n_microbatches, stage_axis,
                 tuple(batch_axes), out)
        return out

    def forward(self, tokens: torch.Tensor,
                cfg: ModelConfig = None) -> torch.Tensor:
        """``forward(mode="train")`` on every process under ``use_mesh``,
        tensor-parallel over ``model``: tokens [B, S] -> logits [B, S, V],
        each data row's rows from its processes.  ``cfg`` (the weights'
        config by default) may differ from it in what the weights do not
        fix, e.g. the MoE capacity factor."""
        cfg = cfg or self.cfg
        b, s = tokens.shape[:2]
        batch = default_rules("pod" in self.mesh.axis_names).spec(
            ("batch",))[0]
        rows = axis_size(self.mesh, batch)
        if b % rows:
            raise ValueError(f"batch {b} does not split over {rows} points "
                             f"of the batch axes")
        out = self._out((b, s, cfg.vocab_size))
        self.run(_forward_rank, cfg, tokens, out)
        return out

    def stats(self) -> List[Dict]:
        """Each process's kernel launches since :meth:`zero_stats` and its
        totals: ``host_s`` (dispatching its work), ``device_s`` (waiting
        for the device; :meth:`_MeshRank.timed`), ``hop_s`` and
        ``hop_bytes`` (the pipeline's hand-offs, waiting for the
        neighbour included), ``moe`` (one
        record a ``moe_ep`` call: assignments ``rows``, ``dropped``, the
        capacity ``cap``, ``a2a_bytes`` sent, ``keep``) and ``tp`` (the
        tensor-parallel sums and gathers: ``calls``, operand ``bytes``,
        ``wait_s`` for the device before them, ``s`` in them)."""
        return self._call(("stats",))

    def zero_stats(self) -> None:
        self._call(("zero",))

    def _out(self, shape) -> torch.Tensor:
        """The output the processes write: on the card, shared by CUDA IPC
        when the command is sent; on the CPU, in shared memory."""
        out = torch.empty(shape, dtype=self.params["embedding"].dtype,
                          device=self.device)
        return out.share_memory_() if self.device.type == "cpu" else out


class _MeshRank:
    """One process of the mesh: its weights (``params`` whole, and its
    tensor-parallel view ``tp_cfg``, ``tp_params`` under ``rules``), its
    ``mesh`` (with its rank and :class:`Comm`), and its totals."""

    def __init__(self, rank: int, job: Dict, dist):
        from torch.distributed.device_mesh import DeviceMesh
        self.kernels = kernel_wrappers()
        self.rank = rank
        self.cfg, self.params, self.impl = job["cfg"], job["params"], \
            job["impl"]
        self.act_dtype = job["act_dtype"]
        self.device = torch.device(job["device"])
        if self.device.type == "cuda" and self.device.index is not None:
            torch.cuda.set_device(self.device)
        mesh = job["mesh"]
        grid = DeviceMesh("cpu", torch.arange(mesh.size).reshape(mesh.sizes),
                          mesh_dim_names=mesh.axis_names)
        if list(grid.get_coordinate()) != list(mesh.coords(rank).values()):
            raise RuntimeError(f"rank {rank}: DeviceMesh coordinates "
                               f"{grid.get_coordinate()}, mesh "
                               f"{mesh.coords(rank)}")
        self.comm = Comm(dist, self.device,
                         {a: grid.get_group(a) for a in mesh.axis_names},
                         mesh.axis_names)
        self.mesh = mesh.at(rank, self.comm)
        self.tp_cfg, self.tp_params, self.rules = tensor_parallel(
            self.cfg, self.params, self.mesh)
        self._zero()

    def _zero(self) -> None:
        for fn in self.kernels.values():
            fn.launches = 0
        self.totals = dict(host_s=0., device_s=0., hop_s=0., hop_bytes=0)
        self.comm.moe_calls.clear()
        self.comm.zero_tp()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def timed(self, fn: Callable, *args, **kw):
        """``fn(*args, **kw)``, then a wait for the device; the wall goes
        into the totals: ``host_s`` dispatching (the tensor-parallel
        collectives and the waits before them excepted), ``device_s``
        waiting for the device (before those collectives and at the
        end)."""
        tp, tot = self.comm.tp, self.totals
        coll, wait = tp["s"], tp["wait_s"]
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        t1 = time.perf_counter()
        self.sync()
        coll, wait = tp["s"] - coll, tp["wait_s"] - wait
        tot["host_s"] += t1 - t0 - coll - wait
        tot["device_s"] += time.perf_counter() - t1 + wait
        return out

    def handle(self, msg):
        kind = msg[0]
        if kind == "run":
            fn, args, kw = msg[1:]
            with torch.no_grad():
                return fn(self, *args, **kw)
        if kind == "stats":
            return dict(self.totals, moe=list(self.comm.moe_calls),
                        tp=dict(self.comm.tp),
                        launches={k: fn.launches
                                  for k, fn in self.kernels.items()})
        if kind == "zero":
            return self._zero()
        raise ValueError(f"unknown command {kind!r}")


def _pipeline_rank(rank: _MeshRank, tokens: torch.Tensor,
                   spec: PL.PipelineSpec, m: int, stage_axis: str,
                   batch_axes: tuple, out: torch.Tensor) -> None:
    """This process's stage of :meth:`MeshProcs.pipeline_forward`."""
    mesh, comm, cfg, tot = rank.mesh, rank.comm, rank.cfg, rank.totals
    coords = mesh.coords()
    s, ns = coords[stage_axis], spec.n_stages
    layers = PL.stage_layers(cfg, spec)[s]
    b, n = tokens.shape[:2]
    mb = microbatch_rows(b, m, axis_size(mesh, batch_axes))
    rows = P(None, batch_axes)
    mine = local_slice(tokens.reshape(m, mb, *tokens.shape[1:]), rows, mesh)
    outs = local_slice(out.view(m, mb, *out.shape[1:]), rows, mesh)
    mine = mine.to(rank.device)
    positions = torch.arange(n, dtype=torch.int32, device=rank.device)
    shape = (mine.shape[1], n, cfg.d_model)
    prev = mesh.rank_of(dict(coords, **{stage_axis: s - 1})) if s else None
    nxt = mesh.rank_of(dict(coords, **{stage_axis: s + 1})) \
        if s + 1 < ns else None
    sending = None
    for i in range(m):
        t0 = time.perf_counter()
        if prev is None:
            x = T._embed_inputs(cfg, rank.params, mine[i], positions)
        else:
            req, buf = comm.irecv(int(torch.Size(shape).numel()),
                                  rank.act_dtype, prev)
            req.wait()
            x = comm.back(buf, shape)
        t1 = time.perf_counter()
        y = PL._run_stage(cfg, rank.params, layers, x, positions, "train",
                          None, rank.impl)
        if nxt is None:
            h = apply_norm(rank.params["final_norm"], y, cfg.norm)
            outs[i].copy_(lm_logits(rank.params, cfg, h))
        t2 = time.perf_counter()
        rank.sync()
        t3 = time.perf_counter()
        if nxt is not None:
            if y.dtype != rank.act_dtype:
                raise TypeError(f"activation {y.dtype}, staging "
                                f"{rank.act_dtype}")
            if sending is not None:
                sending.wait()
            sending = comm.isend(y, nxt)
            tot["hop_bytes"] += y.numel() * y.element_size()
        tot["host_s"] += t2 - t1
        tot["device_s"] += t3 - t2
        tot["hop_s"] += (t1 - t0) + (time.perf_counter() - t3)
    if sending is not None:
        t0 = time.perf_counter()
        sending.wait()
        tot["hop_s"] += time.perf_counter() - t0


def _forward_rank(rank: _MeshRank, cfg: ModelConfig, tokens: torch.Tensor,
                  out: torch.Tensor) -> None:
    """This process's part of :meth:`MeshProcs.forward`: its data row's
    rows through its shard of the model under ``use_mesh``; the process at
    coordinate 0 of every other axis writes them."""
    mesh = rank.mesh
    with use_mesh(mesh, rank.rules):
        rows = current_rules().spec(("batch",))
        logits, _ = rank.timed(
            T.forward, local_config(cfg, mesh, rank.rules), rank.tp_params,
            local_slice(tokens, rows, mesh).to(rank.device), mode="train",
            impl=rank.impl)
    batch = (rows[0],) if isinstance(rows[0], str) else tuple(rows[0] or ())
    if not any(c for a, c in mesh.coords().items() if a not in batch):
        local_slice(out, rows, mesh).copy_(logits)
        rank.sync()
