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

The host builds the kernel library before it spawns, so the stages load it
and do not each run ``nvcc``.  :meth:`StageProcs.stats` gathers each
stage's kernel launches (the wrappers' ``.launches``) and its seconds:
dispatching its layers, waiting for the device, and in the hop.
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
from repro_torch.models.layers import apply_norm, lm_logits, scale_embedding

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
    """A stage process failed (``rank``, with its traceback in the
    message), or stages did not answer in time (``rank`` None)."""

    def __init__(self, rank: Optional[int], detail: str):
        self.rank = rank
        who = "stage processes" if rank is None else f"stage process {rank}"
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


class StageProcs:
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
        import torch.multiprocessing as mp

        ns = spec.n_stages
        PL.stage_layers(cfg, spec)
        _check_decode_impl(impl)
        if vocab_sharded:
            PL.vocab_shard(cfg, ns, 0)          # raises where V % ns
        self.spec, self.timeout = spec, timeout
        self.device = torch.device(device)
        self.vocab_sharded = vocab_sharded
        logits = torch.zeros((n_slots, cfg.vocab_size),
                             dtype=torch.float32).share_memory_()
        self.state = PL.ring_state(ns, [], logits)
        self._ops: List[Tuple] = []
        self._closed = False
        if self.device.type == "cuda" and impl == "cuda":
            from repro_torch.kernels import build
            build.build()                      # once, before the stages
        self._dir = tempfile.mkdtemp(prefix="stage_procs_")
        #: each stage's tensors, kept alive while the stages use them
        self.stage_params = [stage_params(cfg, params, spec, s,
                                          vocab_sharded) for s in range(ns)]
        job = dict(cfg=cfg, spec=spec, n_slots=n_slots, max_len=max_len,
                   cache_dtype=cache_dtype, cache_layout=cache_layout,
                   num_blocks=num_blocks, block_size=block_size, impl=impl,
                   device=str(self.device), vocab_sharded=vocab_sharded,
                   logits=logits, act_dtype=params["embedding"].dtype,
                   timeout=timeout, init_file=str(Path(self._dir) / "rdv"),
                   matmul=(torch.get_float32_matmul_precision(),
                           torch.backends.cuda.matmul
                           .allow_bf16_reduced_precision_reduction,
                           torch.backends.cuda.matmul
                           .allow_fp16_reduced_precision_reduction))
        ctx = mp.get_context("spawn")
        self._conns, self.procs = [], []
        self._finalizer = weakref.finalize(self, _shutdown, self.procs,
                                           self._conns, self._dir)
        t0 = time.perf_counter()
        for s in range(ns):
            here, there = ctx.Pipe()
            proc = ctx.Process(target=_stage_main, name=f"stage-{s}",
                               args=(s, there, dict(
                                   job, params=self.stage_params[s])),
                               daemon=True)
            proc.start()
            there.close()
            self._conns.append(here)
            self.procs.append(proc)
        self._collect("start-up")
        #: seconds from the first spawn to every stage's first answer
        self.spawn_s = time.perf_counter() - t0

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

    def close(self) -> None:
        """Stop every stage: ask each to exit, join it, terminate (then
        kill) any that has not exited within :data:`JOIN_TIMEOUT`."""
        self._closed = True
        self._finalizer()

    # ------------------------------------------------------------------ #
    def _call(self, msg) -> List:
        if self._closed:
            raise StageProcError(None, "the ring is closed")
        for s, conn in enumerate(self._conns):
            try:
                conn.send(msg)
            except OSError as exc:
                raise self._fail(s, f"cannot be reached ({exc})") from None
        return self._collect(msg[0])

    def _collect(self, what: str) -> List:
        """Every stage's answer to the last command; raises (after
        stopping the ring) on a stage's error, exit or silence."""
        ns = len(self._conns)
        pending, answers = set(range(ns)), [None] * ns
        deadline = time.monotonic() + self.timeout
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                raise self._fail(None, f"{sorted(pending)} did not answer "
                                       f"{what!r} within {self.timeout:g} s")
            connection.wait([self._conns[s] for s in pending]
                            + [p.sentinel for p in self.procs], left)
            for s in sorted(pending):
                conn = self._conns[s]
                if not conn.poll():
                    continue
                try:
                    kind, _, payload = conn.recv()
                except EOFError:
                    continue                   # it exited: see below
                if kind == "error":
                    raise self._fail(s, payload)
                answers[s] = payload
                pending.discard(s)
            for s, proc in enumerate(self.procs):
                if proc.exitcode is not None:
                    raise self._fail(s, f"exited with code {proc.exitcode} "
                                        f"during {what!r}")
        return answers

    def _fail(self, rank: Optional[int], detail: str) -> StageProcError:
        self.close()
        return StageProcError(rank, detail)


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
        torch.cuda.ipc_collect()              # the blocks the stages shared
    shutil.rmtree(tmpdir, ignore_errors=True)


# --------------------------------------------------------------------------- #
# a stage process
# --------------------------------------------------------------------------- #

def _stage_main(rank: int, conn, job: Dict) -> None:
    """A stage's life: join the group, build its state, then answer the
    host's commands until ``close``.  Any exception is sent to the host
    with its traceback, and the process exits with code 1."""
    import torch.distributed as dist
    try:
        # one thread a stage: the stages' threads would contend for the
        # host's cores
        torch.set_num_threads(1)
        precision, bf16, fp16 = job["matmul"]
        torch.set_float32_matmul_precision(precision)
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = bf16
        torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = fp16
        dist.init_process_group(
            "gloo", init_method=f"file://{job['init_file']}", rank=rank,
            world_size=job["spec"].n_stages,
            timeout=timedelta(seconds=job["timeout"]))
        stage = _Stage(rank, job, dist)
        conn.send(("ok", rank, None))
        while True:
            msg = conn.recv()
            if msg[0] == "close":
                break
            conn.send(("ok", rank, stage.handle(msg)))
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
    del stage
    job.clear()
    gc.collect()
    dist.destroy_process_group()


class _Stage:
    """One stage's state and its part of each tick."""

    def __init__(self, rank: int, job: Dict, dist):
        from repro_torch.kernels import (decode_attention, flash_attention,
                                         int8_matmul, paged_attention,
                                         rglru_scan)
        mods = dict(decode_attention=decode_attention,
                    paged_attention=paged_attention,
                    flash_attention=flash_attention, rglru_scan=rglru_scan,
                    int8_matmul=int8_matmul)
        self.kernels = {k: getattr(mods[k], k) for k in KERNELS}
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
        pinned = self.device.type == "cuda"
        act = dict(dtype=job["act_dtype"], pin_memory=pinned)
        # staging buffers of the hops and the vocab-sharded collectives
        self._send = torch.empty(cfg.d_model, **act)
        self._recv = torch.empty(cfg.d_model, **act)
        self._coll = torch.empty(cfg.d_model, **act)
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
                    rows = self._all_reduce(PL.embed_partial(
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
        r, dist = self.rank, self.dist
        reqs = []
        if r + 1 < self.ns and live[r]:
            self._stage(self._send, out)
            reqs.append(dist.isend(self._send, r + 1))
            self.totals["hop_bytes"] += self._send.numel() \
                * self._send.element_size()
        takes = r > 0 and live[r - 1]
        if takes:
            reqs.append(dist.irecv(self._recv, r - 1))
        for req in reqs:
            req.wait()
        self.held = self._recv.to(self.device, copy=True).view(1, 1, -1) \
            if takes else None

    @staticmethod
    def _stage(buf: torch.Tensor, x: torch.Tensor) -> None:
        if x.dtype != buf.dtype:
            raise TypeError(f"activation {x.dtype}, staging {buf.dtype}")
        buf.copy_(x.reshape(-1))

    def _all_reduce(self, part: torch.Tensor) -> torch.Tensor:
        self._stage(self._coll, part)
        self.dist.all_reduce(self._coll)
        return self._coll.to(self.device, copy=True).view(1, 1, -1)

    def _broadcast(self, h: Optional[torch.Tensor],
                   src: int) -> torch.Tensor:
        if h is not None:
            self._stage(self._coll, h)
        self.dist.broadcast(self._coll, src)
        return self._coll.to(self.device, copy=True).view(1, 1, -1)
