"""Request scheduler: continuous batching over any runtime backend.

The paper's EdgeShard-No-bubbles schedule admits a micro-batch's next
iteration as soon as its token returns, instead of waiting for the iteration
barrier.  At the serving layer this is continuous batching: a slot is
recycled the moment its request finishes, and new requests join without
draining the batch.

Port of ``repro.serving.scheduler`` with host sampling on ``torch``.

The batcher is backend-agnostic (``repro_torch.runtime.InferenceBackend``):
it owns request queues, per-request sampling state (generators + params), slot
assignment and recycling, and admission; the backend owns weights, KV
caches, and the execution schedule.  Driving the no-bubbles pipeline, the
batcher's continuous admission *is* the paper's schedule — each quantum is
one tick and a finished micro-batch slot is refilled while the other stages
keep streaming.

The scheduler is *reentrant*: :meth:`ContinuousBatcher.step` advances one
quantum and returns the :class:`~repro_torch.serving.types.TokenEvent` s it
produced, so servers can interleave ``submit()`` with stepping —
:meth:`run` is just ``step()`` in a loop.  Prompts keep their natural
length: admission groups queued requests into *length buckets* (next power
of two, floored at ``min_bucket`` and capped at the backend's ``max_len``)
and left-pads each wave to its bucket, so the backend sees a bounded set of
prefill shapes and the last prompt position always holds the last real
token.

Padding semantics: bucketing is **semantically neutral**.  Every
``prefill`` call carries the wave's true prompt lengths and the backend
masks the pads (``prompt_lens`` in the backend protocol): pad tokens never
enter attention, never become valid KV-cache keys, and real tokens keep
their exact unpadded positions — so a request's output is a function of
its prompt alone, identical across bucket sizes (``min_bucket`` is purely
a compile-shape/throughput knob, default 1) and identical to an unpadded
exact-length run.  Capacity checks accordingly use the *true* prompt
length, not the padded bucket.

Admission order is a pluggable *policy* (``serving.sched.policy``): the
queue is kept sorted by the policy's key, so ``"fifo"`` (arrival order,
the default), ``"priority"`` (service classes), and ``"edf"``
(earliest pending deadline) all flow through the same bucketed-wave
machinery.  Preemption victims are policy-chosen too (lowest priority /
latest deadline / youngest), capped per request: a request evicted
``max_preemptions`` times is *pinned* — the victim search skips it so
steady overcommit rotates the pain instead of starving one request
(``stats.starvation_avoided`` counts the overrides).  Preemptive policies
additionally evict a victim for a *blocked* urgent request (no free slot
or no block budget — utilization and pool pressure are the trigger), which
is how a tight-deadline arrival cuts past saturated long-running work.
Policies reorder scheduling only: per-request outputs are bit-identical
across policies.
"""
from __future__ import annotations

import heapq
import time
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Set, Tuple

import numpy as np

import torch

from repro_torch.runtime.base import (BackendDead, BackendError,
                                      InferenceBackend, PoolExhausted,
                                      SlotEvent)
from repro_torch.serving.sampling import request_generator, sample_logits
from repro_torch.serving.sched.policy import SchedPolicy, make_policy
from repro_torch.serving.types import Request, TokenEvent

#: cap on the exponential retry backoff (scheduler steps): consecutive
#: transient failures wait 1, 2, 4, ... up to this many steps between
#: attempts, so a long flake never parks a backend for unbounded time
MAX_BACKOFF_STEPS = 8


@dataclass
class SchedulerStats:
    served: int = 0
    decode_steps: int = 0
    prefills: int = 0
    slot_busy_steps: int = 0
    slot_total_steps: int = 0
    exhausted: bool = False             # run() hit max_steps with work left
    preemptions: int = 0                # evictions (pool pressure + SLO)
    slo_preemptions: int = 0            # of which: policy evicted a victim
    #                                     to admit a blocked urgent request
    resumes: int = 0                    # preempted requests re-admitted
    starvation_avoided: int = 0         # victim choices overridden because
    #                                     the preferred victim was pinned
    #                                     (>= max_preemptions evictions)
    queued: int = 0                     # queue depth after the last step
    queue_wait_steps: int = 0           # cumulative steps requests spent
    #                                     queued before (re-)admission
    ttft_misses: int = 0                # first tokens past their ttft_slo
    e2e_misses: int = 0                 # finishes past their e2e_slo
    prefix_hits: int = 0                # admissions that adopted cached blocks
    prefix_hit_tokens: int = 0          # prompt tokens skipped via adoption
    prefill_chunks: int = 0             # per-slot chunk passes (streamed)
    prefill_shapes: Dict[int, int] = field(default_factory=dict)
    # ^ bucketed prompt/chunk length -> number of admission waves at that shape
    spec_drafted: int = 0               # draft tokens fed through verify
    spec_accepted: int = 0              # of which the model itself produced
    failures: int = 0                   # typed BackendError s observed
    retries: int = 0                    # of which: absorbed by backoff
    #                                     retry (the rest escalated)

    @property
    def utilization(self) -> float:
        return self.slot_busy_steps / max(self.slot_total_steps, 1)

    @property
    def spec_acceptance(self) -> float:
        """Fraction of draft tokens accepted (0 when spec decode is off)."""
        return self.spec_accepted / max(self.spec_drafted, 1)

    def __repr__(self):
        return (f"SchedulerStats(served={self.served}, "
                f"decode_steps={self.decode_steps}, "
                f"prefills={self.prefills}, "
                f"preemptions={self.preemptions}, "
                f"utilization={self.utilization:.3f})")

    def __str__(self):
        s = (f"SchedulerStats(served={self.served}, "
             f"decode_steps={self.decode_steps}, "
             f"prefills={self.prefills}, "
             f"utilization={self.utilization:.3f}, "
             f"queued={self.queued}, "
             f"queue_wait_steps={self.queue_wait_steps}, "
             f"preemptions={self.preemptions}")
        if self.slo_preemptions or self.starvation_avoided:
            s += (f", slo_preemptions={self.slo_preemptions}, "
                  f"starvation_avoided={self.starvation_avoided}")
        if self.ttft_misses or self.e2e_misses:
            s += (f", ttft_misses={self.ttft_misses}, "
                  f"e2e_misses={self.e2e_misses}")
        if self.spec_drafted:
            s += (f", spec_drafted={self.spec_drafted}, "
                  f"spec_accepted={self.spec_accepted} "
                  f"({self.spec_acceptance:.0%})")
        if self.failures:
            s += f", failures={self.failures}, retries={self.retries}"
        return s + ")"


class IncompleteServeError(RuntimeError):
    """``run()`` exhausted ``max_steps`` with requests still queued/running.

    ``done`` carries the requests that *did* finish, so callers can salvage
    partial results instead of silently mistaking them for the full set.
    """

    def __init__(self, msg: str, done: Dict[int, Request]):
        super().__init__(msg)
        self.done = done


def _as_backend(backend) -> InferenceBackend:
    if isinstance(backend, InferenceBackend):
        return backend
    raise TypeError(f"not a backend: {type(backend)!r}")


class ContinuousBatcher:
    """Fixed-slot continuous batching over one :class:`InferenceBackend`.

    Requests carry prompts of any length; admission pads them per length
    bucket (see module docstring), so callers never pad.  Requests may
    arrive any time — ``submit()`` between ``step()`` calls, or pre-staged
    with ``submit(req, at_step=...)`` — and a slot is recycled the moment
    its request finishes, without draining the others.

    ``on_token`` (or the events returned by ``step()``) streams tokens as
    slots decode them.
    """

    def __init__(self, backend, seed: int = 0, *, min_bucket: int = 1,
                 pad_id: int = 0,
                 on_token: Optional[Callable[[TokenEvent], None]] = None,
                 reserve_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 policy=None, max_preemptions: int = 3,
                 spec_k: int = 0, draft="ngram", max_retries: int = 3):
        self.backend: InferenceBackend = _as_backend(backend)
        #: speculative decoding: verify up to spec_k tokens per quantum
        #: (1 emitted + spec_k-1 drafts).  0/1 = off.  Takes effect on
        #: backends advertising ``spec_decode``; greedy outputs stay
        #: bit-identical to non-speculative decoding.
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        self.spec_k = int(spec_k)
        self._draft = None
        self._spec_on = False
        if self.spec_k >= 2:
            if self.backend.info.spec_decode:
                from repro_torch.serving.spec import make_draft
                self._draft = make_draft(draft)
                self._spec_on = True
            else:
                warnings.warn(
                    f"spec_k={spec_k} requested but the backend does not "
                    f"support speculative decoding "
                    f"(cache_layout={self.backend.info.cache_layout!r}); "
                    f"running plain decode", RuntimeWarning, stacklevel=2)
        self.min_bucket = min_bucket
        self.pad_id = pad_id
        self.on_token = on_token
        #: admission/victim policy: "fifo" (default), "priority", "edf",
        #: or a SchedPolicy instance (see serving/sched/policy.py)
        self.policy: SchedPolicy = make_policy(policy)
        #: anti-starvation pin: a request evicted this many times is
        #: skipped by the victim search (stats.starvation_avoided) so
        #: steady overcommit cannot thrash one victim forever
        if max_preemptions < 1:
            raise ValueError(
                f"max_preemptions must be >= 1, got {max_preemptions}")
        self.max_preemptions = max_preemptions
        #: transient-failure budget: consecutive BackendError s absorbed by
        #: capped exponential backoff before the failure escalates to the
        #: caller (the Fleet watchdog quarantines on escalation).  0 =
        #: escalate immediately; BackendDead always escalates.
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        self.max_retries = max_retries
        self._consec_failures = 0
        self._backoff_until = 0
        #: chunked prefill: cap each streamed-admission prefill pass at this
        #: many prompt tokens per scheduler quantum (None = whole suffix in
        #: one pass).  Takes effect on backends advertising
        #: ``supports_extend``; others keep monolithic prefill.
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.prefill_chunk = prefill_chunk
        #: paged admission head-room: keep this many free blocks when
        #: admitting so running requests can still grow.  None = dynamic
        #: (one block per currently-running request).
        self.reserve_blocks = reserve_blocks
        self.queue: Deque[Request] = deque()
        self._arrivals: List[Tuple[int, int, Request]] = []   # (step, n, req)
        self._n_submitted = 0
        self.done: Dict[int, Request] = {}
        self._seed = seed
        # per-request sampling generators, made on a request's first
        # temperature > 0 token
        self._gens: Dict[int, torch.Generator] = {}
        self.stats = SchedulerStats()
        # stepping state (was local to run() before the API redesign)
        self._slot_req: Dict[int, Request] = {}
        self._free: Deque[int] = deque(range(self.backend.n_slots))
        self._feeds: Dict[int, int] = {}
        self.step_no = 0
        self._uids: Set[int] = set()
        # preemption/resume bookkeeping (paged overcommit)
        self._resume: Dict[int, np.ndarray] = {}   # uid -> unpadded prefix
        self._admit_seq: Dict[int, int] = {}       # uid -> admission order
        self._n_admitted = 0
        # policy scheduling state: per-uid submission order (the FIFO
        # tiebreak), cached admit keys (static per enqueue), enqueue step
        # (queue-wait accounting), and a dirty flag so the queue is only
        # re-sorted when it changed
        self._sub_seq: Dict[int, int] = {}
        self._akey: Dict[int, Tuple] = {}
        self._enq_step: Dict[int, int] = {}
        self._queue_dirty = False
        # streamed admission (prefix cache / chunked prefill):
        # slot -> {"tokens": unpadded prefix, "fed": tokens prefilled so far}
        self._chunking: Dict[int, Dict] = {}

    # ------------------------------------------------------------------ #
    # submission
    # ------------------------------------------------------------------ #
    def _bucket(self, n: int) -> int:
        b = max(self.min_bucket, 1 << max(n - 1, 0).bit_length())
        return min(b, self.backend.info.max_len)

    def submit(self, req: Request, at_step: int = 0, *,
               arrival_step: Optional[int] = None,
               resume: bool = False) -> int:
        """Enqueue a request (optionally staged to arrive at a later step).

        Returns the request's uid.  Rejects duplicate uids — they would
        silently overwrite each other in ``done`` and share a PRNG stream.

        ``arrival_step`` overrides the SLO clock origin (normally the
        arrival itself): a dispatcher migrating a withdrawn request passes
        the original arrival so deadlines and latency accounting do not
        restart at the hand-off.

        ``resume=True`` admits a request that already generated tokens on
        another backend (``withdraw(..., running=True)``): admission
        re-prefills its unpadded prefix — prompt plus everything generated —
        exactly like a local preempt/resume, so the continued token stream
        is identical to an uninterrupted run (recompute-on-resume makes
        cross-backend migration token-correct).
        """
        if req.uid in self._uids:
            raise ValueError(
                f"duplicate request uid {req.uid}: uids key finished results "
                f"and per-request PRNG streams; use auto-assigned uids "
                f"(Request(prompt) with no uid) or pick a fresh one")
        plen = int(np.asarray(req.prompt).shape[0]) \
            if np.asarray(req.prompt).ndim else 0
        if plen < 1:
            raise ValueError(f"request {req.uid}: empty prompt")
        max_len = self.backend.info.max_len
        if plen > max_len:
            raise ValueError(
                f"request {req.uid}: prompt length {plen} exceeds the "
                f"backend's max_len {max_len}; serve with max_len >= "
                f"{plen + req.params.max_tokens - 1} to also fit "
                f"max_tokens={req.params.max_tokens}")
        if plen + req.params.max_tokens - 1 > max_len:
            # past max_len, KV writes clamp/drop silently and every later
            # token is computed against a corrupted cache — reject up front.
            # Masked prefill means pads never occupy cache positions, so
            # the check uses the TRUE prompt length, not the padded bucket:
            # requests near the context limit stay admissible.
            raise ValueError(
                f"request {req.uid}: prompt length ({plen}) + max_tokens "
                f"({req.params.max_tokens}) overflows the backend's cache "
                f"(max_len {max_len}); lower max_tokens to "
                f"<= {max_len - plen + 1} or serve with a larger max_len")
        info = self.backend.info
        if info.paged:
            # worst case this one request can ever hold (the final sampled
            # token is never written back); a pool smaller than that
            # deadlocks — preempting everyone else still can't fit it
            worst = info.blocks_for_len(
                min(plen + req.params.max_tokens - 1, max_len))
            if worst > info.total_blocks:
                raise ValueError(
                    f"request {req.uid}: prompt length {plen} + max_tokens "
                    f"{req.params.max_tokens} spans up to {worst} KV blocks "
                    f"of {info.block_size} tokens, but the pool holds only "
                    f"{info.total_blocks} blocks total; serve with "
                    f"--kv-blocks >= {worst} (or shrink max_tokens to <= "
                    f"{max(info.total_blocks * info.block_size - plen, 0)})")
        if req.params.temperature > 0.0 and \
                self.backend.info.samples_in_backend:
            raise ValueError(
                f"request {req.uid}: backend samples in-SPMD (greedy); "
                f"temperature/top_k sampling needs a logits-producing "
                f"backend (TensorBackend is)")
        self._uids.add(req.uid)
        self._n_submitted += 1
        self._sub_seq[req.uid] = self._n_submitted
        if resume and req.generated:
            # the resumable unpadded prefix, same as a local preemption's
            self._resume[req.uid] = np.concatenate(
                [np.asarray(req.prompt, np.int32),
                 np.asarray(req.generated, np.int32)])
        req.timing.submitted_s = time.perf_counter()
        req.timing.submit_step = self.step_no
        req.timing.arrival_step = arrival_step if arrival_step is not None \
            else max(at_step, self.step_no)
        if at_step <= self.step_no:
            self._enqueue(req)
        else:
            heapq.heappush(self._arrivals,
                           (at_step, self._n_submitted, req))
        return req.uid

    def _enqueue(self, req: Request, front: bool = False) -> None:
        """Put ``req`` in the queue (front = preemption re-queue), caching
        its policy admit key and starting its queue-wait clock."""
        self._akey[req.uid] = self.policy.admit_key(
            req, self._sub_seq[req.uid])
        self._enq_step[req.uid] = self.step_no
        if front:
            self.queue.appendleft(req)
        else:
            self.queue.append(req)
        self._queue_dirty = True

    def _sort_queue(self) -> None:
        """Keep the queue in policy order.  FIFO's deque order already is
        the policy order (appendleft re-queues preserve resume-first), so
        only reordering policies pay the sort — and only when the queue
        changed since the last one (keys are static per enqueue)."""
        if self._queue_dirty and self.policy.reorders:
            self.queue = deque(
                sorted(self.queue, key=lambda r: self._akey[r.uid]))
        self._queue_dirty = False

    # ------------------------------------------------------------------ #
    # sampling
    # ------------------------------------------------------------------ #
    def _sample(self, req: Request, ev: SlotEvent) -> int:
        if ev.logits is None:
            return int(ev.token)        # backend sampled in-SPMD (greedy)
        if req.params.temperature <= 0.0:
            return int(np.argmax(ev.logits))
        gen = self._gens.get(req.uid)
        if gen is None:
            gen = self._gens[req.uid] = request_generator(self._seed, req.uid)
        return int(sample_logits(gen, torch.as_tensor(ev.logits)[None],
                                 req.params)[0])

    # ------------------------------------------------------------------ #
    # stepping
    # ------------------------------------------------------------------ #
    @property
    def has_work(self) -> bool:
        return bool(self.queue or self._slot_req or self._arrivals)

    @property
    def running(self) -> List[int]:
        return [r.uid for r in self._slot_req.values()]

    @property
    def pending(self) -> List[int]:
        return [r.uid for r in self.queue] + \
            [r.uid for _, _, r in self._arrivals]

    def status(self, uid: int) -> str:
        if uid in self.done:
            return "finished"
        if uid in set(self.running):
            return "running"
        if uid in set(self.pending):
            return "queued"
        return "unknown"

    def release(self, uid: int) -> Optional[Request]:
        """Drop a finished request's record and free its uid for reuse.

        Long-running servers call this after consuming a result so ``done``
        and the uid set do not grow without bound."""
        req = self.done.pop(uid, None)
        if req is not None:
            self._uids.discard(uid)
            self._sub_seq.pop(uid, None)
        return req

    def withdraw(self, uid: int, *, running: bool = False,
                 ) -> Optional[Request]:
        """Remove a request and return it, freeing its uid.

        The default withdraws *queued, never-started* work only — the
        primitive multi-backend spillover is built on: a dispatcher
        withdraws work a saturated batcher has not begun and re-submits it
        to an idle one.  Running, finished, or preempted-mid-flight
        requests return None.

        ``running=True`` additionally withdraws running and
        preempted-mid-flight requests: the slot and its KV blocks are
        freed and the returned request carries the resumable unpadded
        prefix (``prompt`` + ``generated``), so ``submit(req,
        resume=True)`` on any backend continues the exact token stream
        (recompute-on-resume).  This is the one code path both fleet
        failure recovery and user cancellation go through.  Finished
        requests still return None (collect them from ``done``)."""
        if uid in self.done:
            return None
        if not running and \
                (uid in self._resume or uid in set(self.running)):
            return None
        slot = next((s for s, r in self._slot_req.items() if r.uid == uid),
                    None)
        if slot is not None:
            r = self._slot_req.pop(slot)
            self.backend.free_slot(slot)
            self._feeds.pop(slot, None)
            self._chunking.pop(slot, None)
            self._free.append(slot)
            self._uids.discard(uid)
            self._sub_seq.pop(uid, None)
            self._admit_seq.pop(uid, None)
            self._gens.pop(uid, None)
            self._enq_step.pop(uid, None)
            return r
        for i, r in enumerate(self.queue):
            if r.uid == uid:
                del self.queue[i]
                break
        else:
            for j, (_, _, r) in enumerate(self._arrivals):
                if r.uid == uid:
                    del self._arrivals[j]
                    heapq.heapify(self._arrivals)
                    break
            else:
                return None
        self._uids.discard(uid)
        self._sub_seq.pop(uid, None)
        self._akey.pop(uid, None)
        self._resume.pop(uid, None)   # only present when running=True let
        #                               a preempted-mid-flight request out
        # wait spent here still counts: attribute it before handing off
        waited = self.step_no - self._enq_step.pop(uid, self.step_no)
        r.timing.queued_steps += waited
        self.stats.queue_wait_steps += waited
        self._queue_dirty = True
        return r

    def _next_wave(self, cap: Optional[int] = None,
                   ) -> Tuple[int, List[Request]]:
        """Pull the next admission wave: FIFO head plus every queued request
        sharing its length bucket, up to the free-slot capacity (or the
        tighter paged block-budget ``cap``).  Resumed requests never join a
        wave here — the caller admits them singleton (their prefix includes
        generated tokens), bucketed through the same shapes."""
        cap = len(self._free) if cap is None else cap
        blen = self._bucket(len(self.queue[0].prompt))
        wave: List[Request] = []
        keep: Deque[Request] = deque()
        while self.queue:
            r = self.queue.popleft()
            if len(wave) < cap and r.uid not in self._resume and \
                    self._bucket(len(r.prompt)) == blen:
                wave.append(r)
            else:
                keep.append(r)
        self.queue = keep
        return blen, wave

    # ------------------------------------------------------------------ #
    # paged overcommit: preemption + recompute-on-resume
    # ------------------------------------------------------------------ #
    def _preempt(self, slot: int) -> None:
        """Evict the request in ``slot``: free its blocks and requeue it at
        the queue head with its re-prefill prefix — the prompt plus
        everything generated so far, *unpadded*.  Masked prefill makes
        padding invisible, so on resume the prefix is simply re-bucketed
        like any fresh prompt and the recomputed KV (and every later token)
        is identical to an uninterrupted run."""
        req = self._slot_req.pop(slot)
        self.backend.free_slot(slot)
        self._feeds.pop(slot, None)
        self._chunking.pop(slot, None)  # a mid-stream victim re-streams from 0
        self._free.append(slot)
        self._resume[req.uid] = np.concatenate(
            [np.asarray(req.prompt, np.int32),
             np.asarray(req.generated, np.int32)])
        req.timing.preemptions += 1
        self._enqueue(req, front=True)  # re-keyed: pending deadlines changed
        self.stats.preemptions += 1

    def _pick_victim(self) -> Optional[int]:
        """The slot the policy prefers to evict (lowest priority / latest
        deadline / youngest), honoring anti-starvation pins: a request
        already evicted ``max_preemptions`` times is skipped — unless every
        candidate is pinned, in which case the least-evicted one is taken
        (liveness beats fairness).  Counts ``starvation_avoided`` whenever
        the pin changed the outcome."""
        if not self._slot_req:
            return None
        key = lambda s: self.policy.victim_key(
            self._slot_req[s], self._admit_seq[self._slot_req[s].uid])
        raw = max(self._slot_req, key=key)
        unpinned = [s for s in self._slot_req
                    if self._slot_req[s].timing.preemptions
                    < self.max_preemptions]
        if unpinned:
            pick = max(unpinned, key=key)
        else:
            pick = min(self._slot_req,
                       key=lambda s: self._slot_req[s].timing.preemptions)
        if pick != raw:
            self.stats.starvation_avoided += 1
        return pick

    def _preempt_victim(self) -> bool:
        """Preempt the policy-chosen victim.  Returns False when preemption
        cannot help (zero or one request running)."""
        if len(self._slot_req) <= 1:
            return False
        self._preempt(self._pick_victim())
        return True

    # ------------------------------------------------------------------ #
    # transient-failure absorption (typed BackendError, not PoolExhausted)
    # ------------------------------------------------------------------ #
    def _note_failure(self, exc: BackendError) -> bool:
        """Record a typed backend failure whose op mutated nothing (the
        BackendError contract).  Returns True when the failure is absorbed:
        the same quantum retries after a capped exponential backoff
        (1, 2, 4, ... up to ``MAX_BACKOFF_STEPS`` idle steps).  Returns
        False when it must escalate to the caller — ``BackendDead``
        immediately, transients after ``max_retries`` consecutive failures
        (the Fleet watchdog quarantines the backend on escalation)."""
        self.stats.failures += 1
        self._consec_failures += 1
        if isinstance(exc, BackendDead) or \
                self._consec_failures > self.max_retries:
            return False
        self.stats.retries += 1
        self._backoff_until = self.step_no + 1 + min(
            1 << (self._consec_failures - 1), MAX_BACKOFF_STEPS)
        return True

    def _slo_preempt(self) -> bool:
        """Evict one victim for the queue head when the policy says its
        urgency beats the victim's and the head is *blocked on capacity*:
        every slot busy, or the paged block budget cannot cover its
        admission.  This is the SLO-aware counterpart of pool-exhaustion
        preemption — it fires on queue pressure instead of allocation
        failure.  At most one eviction per step (the pins in
        :meth:`_pick_victim` bound per-request churn)."""
        head = self.queue[0]
        plen = len(self._resume.get(head.uid, head.prompt))
        if self._free:
            budget = self._admit_block_budget()
            if budget is None or \
                    self.backend.info.blocks_for_len(plen) <= budget:
                return False            # not blocked: admission will take it
        if not self._slot_req:
            return False
        slot = self._pick_victim()
        victim = self._slot_req[slot]
        if not self.policy.should_preempt(head, victim, self.step_no):
            return False
        self._preempt(slot)
        self.stats.slo_preemptions += 1
        return True

    def _admit_block_budget(self) -> Optional[int]:
        """Free blocks available for admission this step (None when the
        backend is not paged): live free count minus a reserve so running
        requests keep room to grow."""
        info = self.backend.info
        if not info.paged:
            return None
        reserve = self.reserve_blocks if self.reserve_blocks is not None \
            else len(self._slot_req)
        return max(info.free_blocks - reserve, 0)

    def _mark_admitted(self, req: Request, now: Optional[float] = None,
                       ) -> None:
        """Admission bookkeeping shared by every admission path: timing,
        admission order (victim tiebreak), and queue-wait attribution."""
        req.timing.admit_step = self.step_no
        req.timing.admitted_s = now if now is not None else \
            time.perf_counter()
        self._n_admitted += 1
        self._admit_seq[req.uid] = self._n_admitted
        waited = self.step_no - self._enq_step.pop(req.uid, self.step_no)
        self._akey.pop(req.uid, None)
        req.timing.queued_steps += waited
        self.stats.queue_wait_steps += waited

    def _deliver(self, req: Request, slot: int, tok: int,
                 out: List[TokenEvent], *,
                 release_slot: bool = True) -> Optional[str]:
        """Record one emitted token: timing, finish bookkeeping, feed for
        the next quantum, and the surfaced :class:`TokenEvent`.  Returns
        the finish reason (None while the request keeps running).

        ``release_slot=False`` defers ``backend.free_slot`` to the caller —
        the spec-decode path must ``accept()`` a verify quantum before the
        backend may recycle any of its slots."""
        now = time.perf_counter()
        if not req.generated:
            req.timing.first_token_s = now
            req.timing.first_token_step = self.step_no
            slo = req.params.ttft_slo
            if slo is not None and req.timing.ttft_steps > slo:
                self.stats.ttft_misses += 1
        req.generated.append(tok)
        reason = req.check_finish()
        # finish bookkeeping happens BEFORE the event surfaces, so a
        # finished=True event observes a consistent world: the request
        # is already in .done with finish_reason/timing set, and
        # poll(uid) from an on_token callback works
        if reason is not None:
            req.finish_reason = reason
            req.timing.finished_s = now
            req.timing.finish_step = self.step_no
            slo = req.params.e2e_slo
            if slo is not None and req.timing.e2e_steps > slo:
                self.stats.e2e_misses += 1
            self.done[req.uid] = req
            self.stats.served += 1
            self._gens.pop(req.uid, None)
            self._admit_seq.pop(req.uid, None)
            self._sub_seq.pop(req.uid, None)
            if release_slot:
                self.backend.free_slot(slot)
            del self._slot_req[slot]
            self._feeds.pop(slot, None)
            self._free.append(slot)             # continuous: recycle now
        else:
            self._feeds[slot] = tok
        event = TokenEvent(uid=req.uid, token=tok,
                           index=len(req.generated) - 1,
                           step=self.step_no,
                           finished=reason is not None,
                           finish_reason=reason)
        out.append(event)
        if self.on_token is not None:
            self.on_token(event)
        return reason

    def _handle(self, events: List[SlotEvent], out: List[TokenEvent]):
        for ev in events:
            req = self._slot_req.get(ev.slot)
            if req is None:
                continue
            self._deliver(req, ev.slot, self._sample(req, ev), out)

    # ------------------------------------------------------------------ #
    # speculative decoding (draft -> verify -> accept)
    # ------------------------------------------------------------------ #
    def _spec_feeds(self) -> Dict[int, np.ndarray]:
        """Per-slot verify feeds ``[t_last, d_1..d_{n-1}]``.  Slots without
        a sampled token yet (prompt still streaming/ticking) are skipped —
        the backend keeps teacher-forcing them inside ``verify_step``.
        Temperature>0 requests verify n=1 (plain decode through the verify
        path: host sampling needs exactly the next distribution)."""
        feeds: Dict[int, np.ndarray] = {}
        info = self.backend.info
        for slot in sorted(self._slot_req):
            req = self._slot_req[slot]
            if slot not in self._feeds or slot in self._chunking:
                continue
            n = self.spec_k if req.params.temperature <= 0.0 else 1
            n = min(n, req.params.max_tokens - len(req.generated))
            plen = len(req.prompt)
            n = max(min(n, info.max_len - (plen + len(req.generated) - 1)),
                    1)
            toks = [self._feeds[slot]]
            if n > 1 and self._draft is not None:
                ctx = np.concatenate([np.asarray(req.prompt, np.int32),
                                      np.asarray(req.generated, np.int32)])
                toks += self._draft.propose(req.uid, ctx,
                                            len(req.generated), n - 1)
            feeds[slot] = np.asarray(toks, np.int32)
        return feeds

    def _verify_outputs(self, req: Request, ev: SlotEvent) -> List[int]:
        """Model outputs g_0..g_{n-1} from a verify event (g_i = the token
        the model emits after seeing fed token i)."""
        if ev.tokens is not None:               # backend pre-sampled (sim)
            return [int(t) for t in np.asarray(ev.tokens).ravel()]
        logits = np.asarray(ev.logits)
        assert logits.ndim == 2, logits.shape
        if req.params.temperature <= 0.0:
            return [int(t) for t in np.argmax(logits, -1)]
        assert logits.shape[0] == 1, "temperature>0 must verify n=1"
        return [self._sample(req, SlotEvent(slot=0, logits=logits[0]))]

    def _verify_quantum(self, out: List[TokenEvent]) -> None:
        """One spec-decode quantum: draft, verify, emit the longest
        model-matching prefix, accept (rolling rejected KV back), then
        release any slots that finished mid-emission."""
        feeds = self._spec_feeds()
        events = self.backend.verify_step(feeds)
        counts: Dict[int, int] = {}
        finished_slots: List[int] = []
        for ev in events:
            req = self._slot_req.get(ev.slot)
            if req is None:                     # defensive: still accept
                counts[ev.slot] = 1
                continue
            g = self._verify_outputs(req, ev)
            fed = feeds.get(ev.slot)
            if fed is None:
                emit = g[:1]    # pipeline prompt-completion: first token
            else:
                assert len(g) == len(fed), (len(g), len(fed))
                emit = [g[0]]
                for i in range(1, len(fed)):
                    if int(fed[i]) == emit[-1]:
                        emit.append(g[i])
                    else:
                        break
                self.stats.spec_drafted += len(fed) - 1
                self.stats.spec_accepted += len(emit) - 1
            n_emitted = 0
            for tok in emit:
                n_emitted += 1
                if self._deliver(req, ev.slot, tok, out,
                                 release_slot=False) is not None:
                    finished_slots.append(ev.slot)
                    break
            counts[ev.slot] = n_emitted
        self.backend.accept(counts)
        for slot in finished_slots:
            self.backend.free_slot(slot)

    def _pump_chunks(self, out: List[TokenEvent]) -> None:
        """Feed each mid-stream slot its next prompt chunk — one chunk per
        slot per quantum, so decode ticks interleave between a long prompt's
        chunks and running requests never stall behind it (no head-of-line
        blocking).  Chunks are grouped by bucketed width, keeping the same
        bounded power-of-two shape set as whole-prompt prefill; the
        final chunk's events carry the first sampled token."""
        waves: Dict[int, List[int]] = {}
        for slot, st in self._chunking.items():
            n = len(st["tokens"]) - st["fed"]
            if self.prefill_chunk is not None:
                n = min(n, self.prefill_chunk)
            waves.setdefault(self._bucket(n), []).append(slot)
        for width, slots in sorted(waves.items()):
            lens: List[int] = []
            starts: List[int] = []
            last: List[bool] = []
            padded = np.full((len(slots), width), self.pad_id, np.int32)
            for i, slot in enumerate(slots):
                st = self._chunking[slot]
                total, fed = len(st["tokens"]), st["fed"]
                n = total - fed
                if self.prefill_chunk is not None:
                    n = min(n, self.prefill_chunk)
                padded[i, width - n:] = st["tokens"][fed:fed + n]
                lens.append(n)
                starts.append(fed)
                last.append(fed + n >= total)
            try:
                events = self.backend.prefill_chunk(slots, padded, lens,
                                                    starts, last)
            except PoolExhausted:
                # nothing mutated (the backend checks the whole wave before
                # touching the pool): preempt a victim and retry the same
                # chunks next quantum
                if not self._preempt_victim():
                    raise
                return
            except BackendError as e:
                # typed failure before any mutation: the chunk state is
                # intact, so the same chunks retry after backoff
                if not self._note_failure(e):
                    raise
                return
            for slot, n, done in zip(slots, lens, last):
                if done:
                    del self._chunking[slot]
                else:
                    self._chunking[slot]["fed"] += n
            self.stats.prefill_chunks += len(slots)
            self.stats.prefill_shapes[width] = \
                self.stats.prefill_shapes.get(width, 0) + 1
            self._handle(events, out)

    def step(self) -> List[TokenEvent]:
        """Advance one scheduler quantum: release staged arrivals, admit
        bucketed waves into free slots, run one backend decode quantum.
        Returns the tokens produced this step (possibly none).  No-op when
        fully idle.

        Over a paged backend, admission is *block-budget* gated (free
        blocks minus a reserve must cover each wave's prompts) and may
        overcommit relative to worst-case slot demand; if the pool later
        runs dry mid-decode the backend raises
        :class:`~repro_torch.runtime.base.PoolExhausted` and the youngest running
        request is preempted, requeued, and recomputed on resume.
        """
        out: List[TokenEvent] = []
        while self._arrivals and self._arrivals[0][0] <= self.step_no:
            self._enqueue(heapq.heappop(self._arrivals)[2])
        if not (self.queue or self._slot_req or self._arrivals):
            self.stats.queued = 0
            return out
        if self.step_no < self._backoff_until:
            # transient-failure backoff: freeze admission and decode, but
            # the step still counts (arrivals release, queues age, the
            # fleet's lockstep clock advances) so deadlines stay honest
            self.stats.queued = len(self.queue)
            self.step_no += 1
            return out
        # policy order first: the rest of admission just pulls queue[0]
        self._sort_queue()
        # SLO preemption: a preemptive policy may evict one victim per step
        # for a *blocked* urgent head — blocked (no free slot / no block
        # budget for it) is the saturation signal; an idle system admits
        # normally
        if self.queue and self.policy.preemptive and self._slo_preempt():
            self._sort_queue()          # the victim re-queued at the front
        # admission: fill free slots without draining the running batch;
        # one prefill call per length bucket keeps prefill shapes bounded
        info = self.backend.info
        budget = self._admit_block_budget()
        # streamed admission whenever there is something to gain from it:
        # a prefix cache to hit, or chunking requested on a backend that
        # can extend a partially-prefilled slot
        use_stream = info.prefix_caching or \
            (self.prefill_chunk is not None and info.supports_extend)
        while self.queue and self._free:
            head = self.queue[0]
            if use_stream:
                # singleton admission: the backend adopts any cached prefix
                # blocks now (copy-on-write incref, no compute) and the
                # chunk pump below prefills the remaining suffix.  Resumed
                # requests route through the same path — their recompute
                # prefix can itself hit the cache.
                prefix = self._resume.get(head.uid)
                tokens = np.asarray(
                    head.prompt if prefix is None else prefix, np.int32)
                need = info.blocks_for_len(len(tokens))
                if budget is not None and need > budget:
                    break
                req = self.queue.popleft()
                slot = self._free.popleft()
                try:
                    start = self.backend.start_stream(slot, tokens)
                except BackendError as e:
                    # nothing mutated (typed-failure contract): restore the
                    # admission state and either wait out the pool or
                    # retry/escalate the failure
                    self._free.appendleft(slot)
                    self.queue.appendleft(req)
                    self._queue_dirty = True
                    if isinstance(e, PoolExhausted):
                        break
                    if not self._note_failure(e):
                        raise
                    break
                if prefix is not None:
                    del self._resume[req.uid]
                    self.stats.resumes += 1
                self._slot_req[slot] = req
                self._mark_admitted(req)
                self._chunking[slot] = {"tokens": tokens, "fed": start}
                self.stats.prefills += 1
                if start:
                    self.stats.prefix_hits += 1
                    self.stats.prefix_hit_tokens += start
                if budget is not None:
                    budget = max(budget - need, 0)
                continue
            if head.uid in self._resume:
                # resumed requests re-prefill their prefix (prompt +
                # generated tokens) as a singleton wave, bucketed through
                # the same power-of-two shapes as fresh admissions — masked
                # prefill makes the padding invisible, so resumes no longer
                # run one fresh prefill shape per exact length
                prefix = self._resume[head.uid]
                plen = len(prefix)
                blen = self._bucket(plen)
                need = info.blocks_for_len(plen)
                if budget is not None and need > budget:
                    break
                req = self.queue.popleft()
                wave, lens = [req], [plen]
                padded = np.full((1, blen), self.pad_id, np.int32)
                padded[0, blen - plen:] = prefix
                resumed = True
            else:
                resumed = False
                blen = self._bucket(len(head.prompt))
                # cap the wave by the bucket's worst-case block demand
                # (true-length demand, summed below, can only be smaller)
                need_each = info.blocks_for_len(blen)
                cap = len(self._free)
                if budget is not None:
                    if need_each > budget:
                        break
                    if need_each:
                        cap = min(cap, budget // need_each)
                blen, wave = self._next_wave(cap)
                if not wave:                    # defensive: never expected
                    break
                lens = [len(r.prompt) for r in wave]
                need = sum(info.blocks_for_len(n) for n in lens)
                padded = np.full((len(wave), blen), self.pad_id, np.int32)
                for i, req in enumerate(wave):
                    padded[i, blen - len(req.prompt):] = req.prompt
            slots = [self._free.popleft() for _ in wave]
            try:
                events = self.backend.prefill(slots, padded,
                                              prompt_lens=lens)
            except BackendError as e:
                # the lazy-allocating pipeline can reach PoolExhausted here
                # despite the budget gate, and any backend may fail
                # transiently; either way nothing mutated — put everything
                # back (a resumed request keeps its _resume prefix — it is
                # only dropped on success).  Pool pressure waits for decode
                # to drain; typed failures retry with backoff or escalate.
                for s in reversed(slots):
                    self._free.appendleft(s)
                for r in reversed(wave):
                    self.queue.appendleft(r)
                self._queue_dirty = True
                if isinstance(e, PoolExhausted):
                    break
                if not self._note_failure(e):
                    raise
                break
            if resumed:
                del self._resume[wave[0].uid]
            now = time.perf_counter()
            for slot, req in zip(slots, wave):
                self._slot_req[slot] = req
                self._mark_admitted(req, now)
            self.stats.prefills += 1
            if resumed:
                self.stats.resumes += 1
            self.stats.prefill_shapes[blen] = \
                self.stats.prefill_shapes.get(blen, 0) + 1
            if budget is not None:
                budget = max(budget - need, 0)
            self._handle(events, out)
        if self._chunking:
            self._pump_chunks(out)
        if self._slot_req:
            self.stats.decode_steps += 1
            self.stats.slot_total_steps += self.backend.n_slots
            self.stats.slot_busy_steps += len(self._slot_req)
            while True:
                try:
                    if self._spec_on:
                        # verify_step delivers internally (variable tokens
                        # per slot per quantum)
                        self._verify_quantum(out)
                    else:
                        self._handle(self.backend.decode_step(self._feeds),
                                     out)
                    self._consec_failures = 0   # a served quantum resets
                    #                             the transient streak
                    break
                except PoolExhausted:
                    if not self._preempt_victim():
                        raise   # a lone request outgrowing the pool is a
                                # sizing bug submit() should have rejected
                except BackendError as e:
                    # typed failure, nothing mutated: the same feeds retry
                    # after backoff, or the failure escalates to the fleet
                    if not self._note_failure(e):
                        raise
                    break
        self.stats.queued = len(self.queue)
        self.step_no += 1
        return out

    def run(self, max_steps: int = 100_000) -> Dict[int, Request]:
        """Serve until queues drain.  Returns finished requests by uid.

        Raises :class:`IncompleteServeError` (with the partial ``done`` set
        attached) if ``max_steps`` is exhausted first — a partial result
        must never masquerade as a drained workload.
        """
        steps = 0
        while self.has_work and steps < max_steps:
            self.step()
            steps += 1
        if self.has_work:
            self.stats.exhausted = True
            raise IncompleteServeError(
                f"run(max_steps={max_steps}) exhausted with "
                f"{len(self._slot_req)} running {sorted(self.running)} and "
                f"{len(self.pending)} queued {sorted(self.pending)} requests "
                f"({len(self.done)} finished; partial results on .done)",
                done=self.done)
        return self.done
