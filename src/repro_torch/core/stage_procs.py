"""The EdgeShard stage ring across processes: one process a stage.

The counterpart of the reference's ``shard_map`` over its stage axis
(``repro.core.pipeline.pipeline_decode_tick``), where every device runs its
own stage on a different micro-batch in the same tick.  Here every stage is
a process (:func:`torch.multiprocessing` with the ``spawn`` start method,
which CUDA needs), the stages form one ``gloo`` process group (its
rendezvous through a file in a temporary directory, so no TCP port), and
:class:`StageProcs` in the calling process is the host:

- **weights**: each stage gets its own tensors -- its layers, the
  embedding on stage 0, the final norm and the LM head on the last stage,
  or with ``vocab_sharded`` every stage its shard of the vocabulary
  (:func:`stage_params`) -- through ``torch.multiprocessing``: CUDA IPC on
  the card (nothing is copied or drawn again), shared memory on the CPU.
  The host keeps them alive until :meth:`StageProcs.close`;
- **state**: a stage holds the caches of its own layers only
  (:func:`repro_torch.core.pipeline.init_stage_caches`; on the paged
  layout its pools over one ``[M, nbs]`` block table); ``buf_mb``,
  ``buf_valid`` and ``tick`` are replicated on every stage and on the host,
  each advancing them from the same command stream;
- **the tick**: the host sends every stage one small command -- the fed
  token, its validity and its position, after the ``reset_slot`` /
  ``rollback_slot`` / ``kill_slot`` / block-table updates queued since the
  last tick.  Each live stage runs its layers on the activation it holds,
  at the same time as the others; then each live activation ``[1, 1, d]``
  goes to the next stage (``isend``/``irecv``; gloo moves CPU tensors, so a
  hop is a copy to a pinned buffer, a send, a receive and a copy back), and
  the last stage writes its float32 logits ``[V]`` into a shared-memory
  ``[M, V]`` buffer the host reads.  Every stage acknowledges every
  command, so the host's tick ends when the slowest stage's does;
- **the vocab-sharded tick** (``vocab_sharded=True``; the reference's
  ``src/repro/core/pipeline.py:422-436,497-518``): stage 0's embedding is
  an all-reduce of every stage's masked partial rows, then the port's own
  embed (gemma's scale, sinusoidal positions); the last stage's normed
  hidden is broadcast, and each stage writes ``softcap(h @ W[:, shard])``
  into its columns of the shared row;
- **faults**: a stage that raises sends its traceback and exits; the host
  raises :class:`StageProcError` naming the stage (or the stages that did
  not answer within ``timeout``), after stopping every stage.  Nothing
  falls back to the ring in one process.

The process machinery is shared with the mesh of processes
(:mod:`repro_torch.core.mesh_procs`): :class:`ProcGroup` spawns, answers
and stops the processes, :func:`_proc_main` is a process's life around its
worker object, and :class:`Comm` runs its collectives through staging
buffers on the host.  The host builds the kernel library before it spawns,
so the processes load it and do not each run ``nvcc``.
:meth:`StageProcs.stats` gathers each stage's kernel launches (the
wrappers' ``.launches``) and its seconds: dispatching its layers, waiting
for the device, and in the hop.
"""
from __future__ import annotations

import gc
import shutil
import tempfile
import time
import traceback
import weakref
from datetime import timedelta
from multiprocessing import connection
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import pipeline as PL
from repro_torch.models import transformer as T
from repro_torch.models.attention import _check_decode_impl
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_norm, embed_partial, lm_logits,
                                       scale_embedding)

#: seconds a stage's collectives, and the host's wait for any answer (the
#: stages' start-up included), may take
DEFAULT_TIMEOUT = 120.0
#: seconds :meth:`StageProcs.close` gives the stages to exit before it
#: terminates them
JOIN_TIMEOUT = 10.0
#: the kernel wrappers whose launches a stage reports
KERNELS = ("decode_attention", "paged_attention", "flash_attention",
           "rglru_scan", "int8_matmul")


class StageProcError(RuntimeError):
    """A process failed (``rank``, with its traceback in the message), or
    processes did not answer in time (``rank`` None); ``kind`` names them
    ("stage", or "mesh" for :mod:`repro_torch.core.mesh_procs`)."""

    def __init__(self, rank: Optional[int], detail: str,
                 kind: str = "stage"):
        self.rank = rank
        who = f"{kind} processes" if rank is None \
            else f"{kind} process {rank}"
        super().__init__(f"{who}: {detail}")


def stage_params(cfg: ModelConfig, params: Dict, spec: PL.PipelineSpec,
                 stage: int, vocab_sharded: bool = False) -> Dict:
    """The tensors stage ``stage`` holds, views of ``params``': its layers
    (keyed by their index in the model), the final norm on the last stage,
    and the vocabulary -- the embedding on stage 0 and the head on the last
    (``lm_head``, or the tied embedding), or with ``vocab_sharded`` every
    stage's shard (:func:`~repro_torch.core.pipeline.vocab_params`)."""
    ns = spec.n_stages
    last = stage == ns - 1
    out: Dict = {"layers": {l: params["layers"][l] for l in
                            PL.stage_layers(cfg, spec)[stage]}}
    if vocab_sharded:
        out.update(PL.vocab_params(cfg, params,
                                   PL.vocab_shard(cfg, ns, stage)))
    else:
        if stage == 0 or (last and cfg.tie_embeddings):
            out["embedding"] = params["embedding"]
        if last and not cfg.tie_embeddings:
            out["lm_head"] = params["lm_head"]
    if last:
        out["final_norm"] = params["final_norm"]
    return out


def vocab_bytes(params: Dict) -> int:
    """The bytes of vocabulary weights among a stage's tensors: its
    ``embedding``, ``lm_head`` and ``head`` (a tied head, the embedding's
    transpose, counted once)."""
    views = {(t.data_ptr(), t.numel()): t.numel() * t.element_size()
             for t in (params.get(k) for k in ("embedding", "lm_head", "head"))
             if t is not None}
    return sum(views.values())


class ProcGroup:
    """Processes in one ``gloo`` group, spawned by this process (the host)
    and driven by it one command at a time: each process builds its worker
    (``worker(rank, job, dist)``, a class its module defines) from its job,
    then answers every command with ``worker.handle(msg)``.  A process
    that raises sends its traceback and exits; the host then raises
    :class:`StageProcError` naming it, after stopping every process.
    :meth:`close` stops them all and is idempotent."""

    #: the processes' name in errors
    kind = "stage"

    def _spawn(self, worker, jobs: Sequence[Dict], *, impl: str,
               device: torch.device, timeout: float) -> None:
        """Start one process a job (rank = index), in one ``gloo`` group
        whose rendezvous is a file in a temporary directory, and wait for
        every first answer.  ``impl`` is the processes' (an unknown one
        raises here); with ``"cuda"`` on the card the kernels are built
        first.  Every job gets the host's matmul precision flags, so
        products round as they would here."""
        import torch.multiprocessing as mp

        _check_decode_impl(impl)
        self.timeout = timeout
        self._conns: List = []
        self.procs: List = []
        self._closed = False
        if device.type == "cuda" and impl == "cuda":
            from repro_torch.kernels import build
            build.build()                      # once, before the processes
        self._dir = tempfile.mkdtemp(prefix=f"{self.kind}_procs_")
        common = dict(
            worker=worker, world=len(jobs), timeout=timeout,
            init_file=str(Path(self._dir) / "rdv"),
            matmul=(torch.get_float32_matmul_precision(),
                    torch.backends.cuda.matmul
                    .allow_bf16_reduced_precision_reduction,
                    torch.backends.cuda.matmul
                    .allow_fp16_reduced_precision_reduction))
        ctx = mp.get_context("spawn")
        self._finalizer = weakref.finalize(self, _shutdown, self.procs,
                                           self._conns, self._dir)
        t0 = time.perf_counter()
        for rank, job in enumerate(jobs):
            here, there = ctx.Pipe()
            proc = ctx.Process(target=_proc_main,
                               name=f"{self.kind}-{rank}",
                               args=(rank, there, dict(job, **common)),
                               daemon=True)
            proc.start()
            there.close()
            self._conns.append(here)
            self.procs.append(proc)
        self._collect("start-up")
        #: seconds from the first spawn to every process's first answer
        self.spawn_s = time.perf_counter() - t0

    def close(self) -> None:
        """Stop every process: ask each to exit, join it, terminate (then
        kill) any that has not exited within :data:`JOIN_TIMEOUT`."""
        self._closed = True
        self._finalizer()

    def _call(self, msg) -> List:
        if self._closed:
            raise StageProcError(None, f"the {self.kind} processes are "
                                       f"closed", self.kind)
        for rank, conn in enumerate(self._conns):
            try:
                conn.send(msg)
            except OSError as exc:
                raise self._fail(rank, f"cannot be reached ({exc})") \
                    from None
        return self._collect(msg[0])

    def _collect(self, what: str) -> List:
        """Every process's answer to the last command; raises (after
        stopping them all) on a process's error, exit or silence."""
        n = len(self._conns)
        pending, answers = set(range(n)), [None] * n
        deadline = time.monotonic() + self.timeout
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                raise self._fail(None, f"{sorted(pending)} did not answer "
                                       f"{what!r} within {self.timeout:g} s")
            connection.wait([self._conns[r] for r in pending]
                            + [p.sentinel for p in self.procs], left)
            for rank in sorted(pending):
                conn = self._conns[rank]
                if not conn.poll():
                    continue
                try:
                    kind, _, payload = conn.recv()
                except EOFError:
                    continue                   # it exited: see below
                if kind == "error":
                    raise self._fail(rank, payload)
                answers[rank] = payload
                pending.discard(rank)
            for rank, proc in enumerate(self.procs):
                if proc.exitcode is not None:
                    raise self._fail(rank, f"exited with code "
                                           f"{proc.exitcode} during {what!r}")
        return answers

    def _fail(self, rank: Optional[int], detail: str) -> StageProcError:
        self.close()
        return StageProcError(rank, detail, self.kind)


class StageProcs(ProcGroup):
    """The no-bubbles stage ring with one process a stage; the host side.

    The same methods as :class:`repro_torch.core.pipeline.StageRing` (the
    ring in this process), so
    :class:`~repro_torch.runtime.pipeline_backend.PipelineBackend` drives
    either; ``state`` is the host's copy of the ring (no caches;
    ``logits_out`` the shared ``[M, V]`` buffer the last stage, or every
    stage's shard, writes).  ``device`` is where the stages run (the card
    unless ``"cpu"``).  Call :meth:`close` when done: it stops every stage
    and is idempotent."""

    def __init__(self, cfg: ModelConfig, params: Dict, spec: PL.PipelineSpec,
                 *, n_slots: int, max_len: int, cache_dtype: torch.dtype,
                 cache_layout: str = "contiguous", num_blocks: int = 0,
                 block_size: int = 16, impl: str = "ref", device="cuda",
                 vocab_sharded: bool = False,
                 timeout: float = DEFAULT_TIMEOUT):
        ns = spec.n_stages
        PL.stage_layers(cfg, spec)
        if vocab_sharded:
            PL.vocab_shard(cfg, ns, 0)          # raises where V % ns
        self.spec = spec
        self.device = torch.device(device)
        self.vocab_sharded = vocab_sharded
        logits = torch.zeros((n_slots, cfg.vocab_size),
                             dtype=torch.float32).share_memory_()
        self.state = PL.ring_state(ns, [], logits)
        self._ops: List[Tuple] = []
        #: each stage's tensors, kept alive while the stages use them
        self.stage_params = [stage_params(cfg, params, spec, s,
                                          vocab_sharded) for s in range(ns)]
        job = dict(cfg=cfg, spec=spec, n_slots=n_slots, max_len=max_len,
                   cache_dtype=cache_dtype, cache_layout=cache_layout,
                   num_blocks=num_blocks, block_size=block_size, impl=impl,
                   device=str(self.device), vocab_sharded=vocab_sharded,
                   logits=logits, act_dtype=params["embedding"].dtype)
        self._spawn(_Stage, [dict(job, params=p) for p in self.stage_params],
                    impl=impl, device=self.device, timeout=timeout)

    # ------------------------------------------------------------------ #
    # the ring's methods
    # ------------------------------------------------------------------ #
    def tick(self, feed: int, valid: bool, pos: int) -> Optional[int]:
        """One tick on every stage: stage 0 takes token ``feed`` at
        position ``pos`` for micro-batch ``tick % M`` (live when
        ``valid``).  Returns the micro-batch whose logits completed
        (``state.logits_out[mb]``), or None."""
        mbs, live = PL.ring_turn(self.state, valid)
        ops, self._ops = self._ops, []
        self._call(("tick", int(feed), bool(valid), int(pos), ops))
        done = None
        if live[-1]:
            done = mbs[-1]
            self.state.token_ready[done] = True
        PL.ring_advance(self.state, mbs, live)
        return done

    def reset_slot(self, slot: int, start: int = 0) -> None:
        PL.reset_slot(self.state, slot, start)
        self._ops.append(("reset_slot", slot, start))

    def rollback_slot(self, slot: int, new_pos: int) -> None:
        self._ops.append(("rollback_slot", slot, new_pos))

    def kill_slot(self, slot: int) -> None:
        PL.kill_slot(self.state, slot)
        self._ops.append(("kill_slot", slot))

    def push_table(self, table: np.ndarray) -> None:
        self._ops.append(("push_table", np.array(table, np.int32)))

    def stats(self) -> List[Dict]:
        """Each stage's kernel launches since :meth:`zero_stats` and its
        totals over the ticks since: ``ticks``, ``live`` (ticks its stage
        ran), ``host_s`` (dispatching its layers, the vocab-sharded
        collectives included), ``device_s`` (then waiting for the device),
        ``hop_s`` (the hand-off: copies, send and receive, waiting for the
        neighbour included), ``hop_bytes`` (activations sent),
        ``vocab_bytes`` (its vocabulary weights)."""
        return self._call(("stats",))

    def zero_stats(self) -> None:
        self._call(("zero",))


def _shutdown(procs, conns, tmpdir: str) -> None:
    for conn in conns:
        try:
            conn.send(("close",))
        except OSError:
            pass
    deadline = time.monotonic() + JOIN_TIMEOUT
    for proc in procs:
        proc.join(max(deadline - time.monotonic(), 0.1))
    for stop in ("terminate", "kill"):
        alive = [p for p in procs if p.is_alive()]
        for proc in alive:
            getattr(proc, stop)()
        for proc in alive:
            proc.join(JOIN_TIMEOUT)
    for conn in conns:
        conn.close()
    if torch.cuda.is_initialized():
        torch.cuda.ipc_collect()              # the blocks the processes shared
    shutil.rmtree(tmpdir, ignore_errors=True)


# --------------------------------------------------------------------------- #
# a process of the group
# --------------------------------------------------------------------------- #

def _proc_main(rank: int, conn, job: Dict) -> None:
    """A process's life: join the group, build its worker, then answer the
    host's commands until ``close``.  Any exception is sent to the host
    with its traceback, and the process exits with code 1."""
    import torch.distributed as dist
    try:
        # one thread a process: the processes' threads would contend for
        # the host's cores
        torch.set_num_threads(1)
        precision, bf16, fp16 = job["matmul"]
        torch.set_float32_matmul_precision(precision)
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = bf16
        torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = fp16
        dist.init_process_group(
            "gloo", init_method=f"file://{job['init_file']}", rank=rank,
            world_size=job["world"],
            timeout=timedelta(seconds=job["timeout"]))
        worker = job["worker"](rank, job, dist)
        conn.send(("ok", rank, None))
        while True:
            msg = conn.recv()
            if msg[0] == "close":
                break
            conn.send(("ok", rank, worker.handle(msg)))
    except EOFError:
        return                                  # the host is gone
    except Exception:                           # reported to the host
        try:
            conn.send(("error", rank, traceback.format_exc()))
        except OSError:
            pass
        raise SystemExit(1)
    # drop every shared tensor before exiting, so the host's CUDA IPC
    # counts of them reach zero
    del worker
    job.clear()
    gc.collect()
    dist.destroy_process_group()


def kernel_wrappers() -> Dict:
    """The kernel wrappers of :data:`KERNELS` by name (their ``.launches``
    count a process's launches)."""
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     int8_matmul, paged_attention,
                                     rglru_scan)
    mods = dict(decode_attention=decode_attention,
                paged_attention=paged_attention,
                flash_attention=flash_attention, rglru_scan=rglru_scan,
                int8_matmul=int8_matmul)
    return {k: getattr(mods[k], k) for k in KERNELS}


class Comm:
    """A process's collectives, through staging buffers on the host: gloo
    moves CPU tensors, so each one copies its operand into a buffer
    (pinned when the process runs on the card; the copy waits for the
    device), runs over gloo, and copies the result back to the device.
    Buffers are kept by role and grown as needed.  ``groups`` holds a
    process group for each mesh axis (``axes`` names them in the mesh's
    order); the whole group needs none.  Operations that only move data
    move bytes, so every dtype goes.  ``moe_calls`` collects what each
    expert-parallel MoE call of :mod:`repro_torch.models.moe` reports, and
    ``tp`` tallies the tensor-parallel sums and gathers of
    :mod:`repro_torch.sharding.rules`."""

    def __init__(self, dist, device: torch.device,
                 groups: Optional[Dict] = None, axes: Tuple[str, ...] = ()):
        self.dist, self.device = dist, device
        self.pinned = device.type == "cuda"
        self.groups, self.axes = groups or {}, tuple(axes)
        self._bufs: Dict[str, torch.Tensor] = {}
        self.moe_calls: List[Dict] = []
        self.tp: Dict = {}
        self.zero_tp()

    def zero_tp(self) -> None:
        self.tp.update(calls=0, bytes=0, wait_s=0., s=0.)

    def _buf(self, role: str, numel: int, dtype: torch.dtype) -> torch.Tensor:
        n = numel * torch.empty((), dtype=dtype).element_size()
        buf = self._bufs.get(role)
        if buf is None or buf.numel() < n:
            buf = self._bufs[role] = torch.empty(n, dtype=torch.uint8,
                                                 pin_memory=self.pinned)
        return buf[:n].view(dtype)

    def stage(self, role: str, x: torch.Tensor) -> torch.Tensor:
        """``x``'s elements in the staging buffer of ``role``."""
        buf = self._buf(role, x.numel(), x.dtype)
        buf.copy_(x.reshape(-1))
        return buf

    def back(self, buf: torch.Tensor, shape) -> torch.Tensor:
        """A copy of a staging buffer on the device, in ``shape``."""
        return buf.to(self.device, copy=True).view(shape)

    def group(self, axes):
        """The process group over mesh ``axes`` (an axis, or a tuple of
        them): an axis's own, or None for every axis in the mesh's
        order (the whole group)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if axes == self.axes:
            return None
        if len(axes) == 1 and axes[0] in self.groups:
            return self.groups[axes[0]]
        raise ValueError(f"no process group over {axes} (mesh axes "
                         f"{self.axes})")

    def isend(self, x: torch.Tensor, dst: int, role: str = "send"):
        buf = self.stage(role, x)
        return self.dist.isend(buf.view(torch.uint8), dst)

    def irecv(self, numel: int, dtype: torch.dtype, src: int,
              role: str = "recv"):
        """(the receive's request, its buffer of ``numel`` elements)."""
        buf = self._buf(role, numel, dtype)
        return self.dist.irecv(buf.view(torch.uint8), src), buf

    def all_reduce(self, x: torch.Tensor, axes=None) -> torch.Tensor:
        """The sum of every process's ``x`` (over ``axes``; all of them by
        default)."""
        buf = self.stage("reduce", x)
        self.dist.all_reduce(buf, group=self.group(axes or self.axes))
        return self.back(buf, x.shape)

    def broadcast(self, x: Optional[torch.Tensor], src: int, shape,
                  dtype: torch.dtype) -> torch.Tensor:
        """Process ``src``'s ``x`` (``shape``, ``dtype``) on every process
        of the whole group."""
        buf = self.stage("reduce", x) if x is not None else \
            self._buf("reduce", int(np.prod(shape)), dtype)
        self.dist.broadcast(buf.view(torch.uint8), src)
        return self.back(buf, shape)

    def all_gather(self, x: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
        """Every process's ``x`` over ``axes``, concatenated along ``dim``
        in the order of their coordinates."""
        group = self.group(axes)
        n = self.dist.get_world_size(group)
        x = x.movedim(dim, 0)
        src = self.stage("gather_in", x).view(torch.uint8)
        out = self._buf("gather_out", n * x.numel(), x.dtype)
        self.dist.all_gather(list(out.view(torch.uint8).chunk(n)), src,
                             group=group)
        out = self.back(out, (n * x.shape[0],) + tuple(x.shape[1:]))
        return out.movedim(0, dim)

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x`` [n, ...] over the ``n`` processes of ``axis``: block ``j``
        goes to the process at coordinate ``j``, and block ``i`` of the
        result came from the process at ``i``."""
        src = self.stage("a2a_in", x).view(torch.uint8)
        out = self._buf("a2a_out", x.numel(), x.dtype)
        self.dist.all_to_all_single(out.view(torch.uint8), src,
                                    group=self.group(axis))
        return self.back(out, x.shape)


class _Stage:
    """One stage's state and its part of each tick."""

    def __init__(self, rank: int, job: Dict, dist):
        self.kernels = kernel_wrappers()
        self.dist, self.rank = dist, rank
        cfg, spec = job["cfg"], job["spec"]
        self.cfg, self.ns, self.impl = cfg, spec.n_stages, job["impl"]
        self.device = torch.device(job["device"])
        if self.device.type == "cuda" and self.device.index is not None:
            torch.cuda.set_device(self.device)
        self.params = job["params"]
        self.layers = PL.stage_layers(cfg, spec)[rank]
        caches = PL.init_stage_caches(
            cfg, self.layers, job["n_slots"], job["max_len"],
            job["cache_dtype"], job["cache_layout"], job["num_blocks"],
            job["block_size"], self.device)
        self.state = PL.ring_state(self.ns, caches, job["logits"])
        self.shard = PL.vocab_shard(cfg, self.ns, rank) \
            if job["vocab_sharded"] else None
        self.act_dtype = job["act_dtype"]
        self.comm = Comm(dist, self.device)
        self.held: Optional[torch.Tensor] = None
        self._zero()

    def _zero(self) -> None:
        for fn in self.kernels.values():
            fn.launches = 0
        self.totals = dict(ticks=0, live=0, host_s=0., device_s=0.,
                           hop_s=0., hop_bytes=0)

    def handle(self, msg):
        kind = msg[0]
        if kind == "tick":
            return self.tick(*msg[1:])
        if kind == "stats":
            return dict(self.totals, vocab_bytes=vocab_bytes(self.params),
                        launches={k: fn.launches
                                  for k, fn in self.kernels.items()})
        if kind == "zero":
            return self._zero()
        raise ValueError(f"unknown command {kind!r}")

    def tick(self, feed: int, valid: bool, pos: int,
             ops: Sequence[Tuple]) -> None:
        for name, *args in ops:
            getattr(PL, name)(self.state, *args)
        t0 = time.perf_counter()
        st, r, cfg = self.state, self.rank, self.cfg
        mbs, live = PL.ring_turn(st, valid)
        out = None
        with torch.no_grad():
            x = self.held if r else None
            if live[0] and (r == 0 or self.shard is not None):
                tokens = torch.tensor([[feed]], device=self.device)
                positions = torch.full((1, 1), pos, dtype=torch.int32,
                                       device=self.device)
                if self.shard is not None:
                    rows = self._all_reduce(embed_partial(
                        self.params["embedding"], self.shard.start, tokens))
                    x = T.add_positions(cfg, scale_embedding(cfg, rows),
                                        positions) if r == 0 else x
                else:
                    x = T._embed_inputs(cfg, self.params, tokens, positions)
            if live[r]:
                out = PL.stage_decode(cfg, self.params, self.layers,
                                      st.caches, x, mbs[r], self.impl,
                                      self.layers.start)
            if live[-1]:
                h = apply_norm(self.params["final_norm"], out, cfg.norm) \
                    if r == self.ns - 1 else None
                row = st.logits_out[mbs[-1]]
                if self.shard is not None:
                    h = self._broadcast(h, self.ns - 1)
                    row[self.shard].copy_(PL.logits_partial(
                        cfg, h, self.params["head"])[0, 0])
                elif h is not None:
                    row.copy_(lm_logits(self.params, cfg, h)[0, 0].float())
        t1 = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        self._hop(out, live)
        t3 = time.perf_counter()
        PL.ring_advance(st, mbs, live)
        tot = self.totals
        tot["ticks"] += 1
        tot["live"] += int(live[r])
        tot["host_s"] += t1 - t0
        tot["device_s"] += t2 - t1
        tot["hop_s"] += t3 - t2

    def _hop(self, out: Optional[torch.Tensor], live: List[bool]) -> None:
        """The hand-off: this stage's live activation to the next stage,
        the previous stage's live one into ``held`` for the next tick."""
        r, d = self.rank, self.cfg.d_model
        reqs = []
        if r + 1 < self.ns and live[r]:
            if out.dtype != self.act_dtype:
                raise TypeError(f"activation {out.dtype}, staging "
                                f"{self.act_dtype}")
            reqs.append(self.comm.isend(out, r + 1))
            self.totals["hop_bytes"] += out.numel() * out.element_size()
        takes = r > 0 and live[r - 1]
        if takes:
            req, buf = self.comm.irecv(d, self.act_dtype, r - 1)
            reqs.append(req)
        for req in reqs:
            req.wait()
        self.held = self.comm.back(buf, (1, 1, d)) if takes else None

    def _all_reduce(self, part: torch.Tensor) -> torch.Tensor:
        return self.comm.all_reduce(part).view(1, 1, -1)

    def _broadcast(self, h: Optional[torch.Tensor],
                   src: int) -> torch.Tensor:
        return self.comm.broadcast(h, src, (1, 1, self.cfg.d_model),
                                   self.act_dtype)
