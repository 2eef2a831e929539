"""Multi-backend dispatcher: N batchers over N backends, one queue surface.

EdgeShard's deployment target is a *set* of heterogeneous executors (edge
boxes, a cloud pipeline, spare accelerators), not one backend.  The
:class:`Fleet` makes them serve as one system:

- **routing** — each arriving request goes to the feasible backend with the
  lowest *cost estimate*: requests in line (queue depth + running) divided
  by the backend's advertised service rate (``BackendInfo.tokens_per_s`` ×
  slots), plus a penalty when its paged pool cannot cover the prompt right
  now.  Routing happens at *arrival* time (staged traces are held in the
  fleet, not pre-routed), so the estimate sees the actual load.
- **spillover migration** — each step, queued-but-never-started work is
  withdrawn (``ContinuousBatcher.withdraw``) from saturated batchers (every
  slot busy *and* a backlog) and resubmitted to idle ones (free slots, no
  queue).  The SLO clock travels with the request (``submit(...,
  arrival_step=)``), so migration never resets deadlines or hides queue
  wait.
- **one clock** — all batchers are driven in lockstep on the fleet's step
  counter, so step-denominated SLOs mean the same thing on every backend.
- **failure recovery** — the paper's edge boxes fail and their links flake,
  so the fleet is a *watchdog* too.  Failures arrive typed
  (:class:`~repro.runtime.base.BackendError`): each batcher absorbs
  transients itself with capped exponential backoff (``max_retries``
  consecutive failures, then escalate); what escapes a batcher's
  ``step()`` — ``BackendDead``, or a transient streak past its retry
  budget — **quarantines** that backend: its finished results are
  salvaged, every queued *and running* request is withdrawn
  (``withdraw(..., running=True)``) and re-admitted to the surviving
  backends in priority order (``submit(..., resume=True)`` re-prefills the
  unpadded prefix, so recovered token streams are bit-identical to a
  fault-free run).  Work no survivor can hold is *shed* — recorded in
  ``failed`` with the reason — so capacity loss degrades goodput, never
  correctness.  ``FleetStats`` accounts every failure, retry, quarantine,
  recovery, recomputed token, and shed request.

Token parity: per-request outputs are a pure function of the prompt on
every backend kind (masked prefill + deterministic decode; ``SimBackend``
hashes its token history), so a fleet run yields token-for-token the same
per-request outputs as a single-backend run of the same kind — routing,
migration, and failure recovery change *when*, never *what*.  The spillover
and chaos tests assert exactly this.  (One caveat: temperature>0 sampling
re-derives its PRNG stream on resume, so *sampled* continuations may
differ after a cross-backend recovery; greedy and sim streams never do.)

Feasibility errors are actionable: a request no backend can serve (prompt
too long everywhere, sampling on greedy-only backends, pool too small, or
— with ``deadline_admission`` — an e2e deadline arithmetic says it can
never meet) raises at submit with the per-backend reason instead of
queueing forever.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.runtime.base import BackendError
from repro_torch.serving.scheduler import (ContinuousBatcher,
                                           IncompleteServeError,
                                           SchedulerStats)
from repro_torch.serving.types import Request, TokenEvent


@dataclass
class FleetStats(SchedulerStats):
    """Fleet-wide :class:`SchedulerStats` plus failure-recovery accounting.

    ``failures``/``retries`` (inherited) aggregate the batchers' transient
    absorption; the fields below are fleet-level watchdog events.
    """

    quarantines: int = 0         # backends removed after a fatal failure
    recovered: int = 0           # requests re-admitted from a quarantined
    #                              backend onto a survivor
    tokens_recomputed: int = 0   # prefix tokens (prompt + generated)
    #                              re-prefilled to rebuild in-flight state
    shed: int = 0                # requests dropped: no surviving backend
    #                              could hold them (see Fleet.failed)

    def __str__(self):
        s = super().__str__()
        if self.quarantines or self.shed:
            s = (s[:-1] + f", quarantines={self.quarantines}, "
                 f"recovered={self.recovered}, "
                 f"tokens_recomputed={self.tokens_recomputed}, "
                 f"shed={self.shed})")
        return s


class Fleet:
    """One serving surface over many backends (see module docstring).

    ``backends`` are :class:`~repro.runtime.base.InferenceBackend` s (or
    anything ``ContinuousBatcher`` accepts); every batcher gets the same
    ``policy`` / ``seed`` / admission knobs, so the fleet behaves like one
    policy-scheduled system that happens to have distributed capacity.

    ``max_retries`` is each batcher's transient-failure budget (consecutive
    ``BackendError`` s absorbed by backoff before the watchdog quarantines
    the backend).  ``deadline_admission`` rejects requests whose e2e
    deadline is provably unmeetable (a request needs at least one step per
    token, so ``max_tokens > e2e_slo`` can never finish in time) at submit,
    with an actionable error, instead of serving them to a certain miss.
    """

    def __init__(self, backends: Sequence, *, policy=None, seed: int = 0,
                 min_bucket: int = 1, pad_id: int = 0,
                 prefill_chunk: Optional[int] = None,
                 reserve_blocks: Optional[int] = None,
                 max_preemptions: int = 3, migrate: bool = True,
                 max_retries: int = 3, deadline_admission: bool = True,
                 on_token=None):
        if not backends:
            raise ValueError("Fleet needs at least one backend")
        self.batchers: List[ContinuousBatcher] = [
            ContinuousBatcher(b, seed=seed, min_bucket=min_bucket,
                              pad_id=pad_id, prefill_chunk=prefill_chunk,
                              reserve_blocks=reserve_blocks, policy=policy,
                              max_preemptions=max_preemptions,
                              max_retries=max_retries,
                              on_token=on_token)
            for b in backends]
        self.migrate = migrate
        self.deadline_admission = deadline_admission
        self.step_no = 0
        self.done: Dict[int, Request] = {}
        self.migrations = 0
        self._arrivals: List[Tuple[int, int, int, Request]] = []
        self._n_submitted = 0
        self._home: Dict[int, int] = {}          # uid -> batcher index
        self._uids = set()
        # watchdog state: quarantined batcher index -> failure description
        self._quarantined: Dict[int, str] = {}
        self._quarantines = 0
        self._recovered = 0
        self._tokens_recomputed = 0
        self._shed = 0
        #: uids re-admitted onto a survivor after a quarantine (recovery
        #: audit trail: chaos tests assert their tokens bit-match baseline)
        self.recovered_uids: List[int] = []
        #: requests the fleet gave up on (shed), with the reason — kept
        #: separate from ``done`` so a partial result never masquerades as
        #: a served one
        self.failed: Dict[int, Request] = {}
        self.failed_reason: Dict[int, str] = {}

    # ------------------------------------------------------------------ #
    # routing
    # ------------------------------------------------------------------ #
    def _infeasible_reason(self, b: ContinuousBatcher, req: Request,
                           ) -> Optional[str]:
        """Why this backend can never serve ``req`` (None = it can)."""
        info = b.backend.info
        plen = int(np.asarray(req.prompt).shape[0])
        total = plen + req.params.max_tokens - 1
        if total > info.max_len:
            return (f"prompt {plen} + max_tokens {req.params.max_tokens} "
                    f"needs context {total} > max_len {info.max_len}")
        if info.paged and info.blocks_for_len(min(total, info.max_len)) \
                > info.total_blocks:
            return (f"worst case spans "
                    f"{info.blocks_for_len(min(total, info.max_len))} KV "
                    f"blocks > pool of {info.total_blocks}")
        if req.params.temperature > 0.0 and info.samples_in_backend:
            return ("samples in-backend (greedy only); temperature/top_k "
                    "needs a logits-producing backend")
        return None

    def _objection(self, i: int, req: Request) -> Optional[str]:
        """Why batcher ``i`` cannot take ``req`` right now (None = it can):
        a quarantined backend objects to everything."""
        if i in self._quarantined:
            return f"quarantined ({self._quarantined[i]})"
        return self._infeasible_reason(self.batchers[i], req)

    def _deadline_objection(self, req: Request) -> Optional[str]:
        """Deadline arithmetic that holds on *every* backend: a request
        needs at least one scheduler step per remaining token, so when that
        lower bound already overshoots its e2e deadline, admitting it just
        burns capacity on a certain miss."""
        if not self.deadline_admission or req.params.e2e_slo is None:
            return None
        arrival = req.timing.arrival_step \
            if req.timing.arrival_step is not None else self.step_no
        deadline = arrival + req.params.e2e_slo
        remaining = max(req.params.max_tokens - len(req.generated), 0)
        if max(self.step_no, arrival) + remaining > deadline:
            return (f"e2e deadline (step {deadline}) is infeasible: "
                    f"{remaining} remaining tokens need >= {remaining} "
                    f"decode steps from step {max(self.step_no, arrival)}; "
                    f"lower max_tokens to <= "
                    f"{max(deadline - max(self.step_no, arrival), 0)} "
                    f"or relax e2e_slo")
        return None

    def _cost(self, b: ContinuousBatcher, req: Request) -> float:
        """Estimated wait (arbitrary units, comparable across batchers):
        requests in line over the backend's service rate, plus a flat
        penalty when the paged pool cannot admit this prompt right now."""
        info = b.backend.info
        in_line = len(b.queue) + len(b._slot_req)
        rate = (info.tokens_per_s or 1.0) * max(info.n_slots, 1)
        cost = (in_line + 1) / rate
        if info.paged:
            need = info.blocks_for_len(len(req.prompt))
            if need > info.free_blocks:
                cost *= 4.0              # will queue on pool pressure
        return cost

    def _pick(self, req: Request, backend: Optional[int], *,
              check_deadline: bool = True) -> Union[int, str]:
        """The batcher index to route ``req`` to, or (when nothing can
        take it) the actionable objection string.  ``check_deadline=False``
        skips deadline admission — recovery re-admits half-done work even
        past its deadline (the miss is counted, the tokens are not lost)."""
        if check_deadline:
            dl = self._deadline_objection(req)
            if dl is not None:
                return f"request {req.uid}: {dl}"
        if backend is not None:
            reason = self._objection(backend, req)
            if reason is not None:
                return (f"request {req.uid}: pinned to backend {backend}, "
                        f"which cannot serve it: {reason}")
            return backend
        feasible, reasons = [], []
        for i in range(len(self.batchers)):
            reason = self._objection(i, req)
            if reason is None:
                feasible.append(i)
            else:
                reasons.append(f"backend {i}: {reason}")
        if not feasible:
            return (f"request {req.uid}: no backend in the fleet can serve "
                    f"it — " + "; ".join(reasons) +
                    ". Re-provision a backend (larger max_len / --kv-blocks,"
                    " or a logits-producing kind for sampling) or relax the"
                    " request.")
        return min(feasible,
                   key=lambda i: (self._cost(self.batchers[i], req), i))

    def _admit(self, req: Request, backend: Optional[int],
               arrival_step: Optional[int] = None, *,
               resume: bool = False,
               check_deadline: bool = True) -> Optional[int]:
        """Route ``req`` to a batcher, shedding it (with the reason on
        ``failed_reason``) when nothing can take it.  Returns the batcher
        index, or None when shed."""
        pick = self._pick(req, backend, check_deadline=check_deadline)
        if isinstance(pick, str):
            self._shed_req(req, pick)
            return None
        self._home[req.uid] = pick
        self.batchers[pick].submit(req, arrival_step=arrival_step,
                                   resume=resume)
        return pick

    def _shed_req(self, req: Request, reason: str) -> None:
        """Priority-ordered load shedding's terminal state: the fleet gives
        up on ``req`` and says why, rather than queueing it forever."""
        self._shed += 1
        req.finish_reason = "shed"
        self.failed[req.uid] = req
        self.failed_reason[req.uid] = reason
        self._home.pop(req.uid, None)

    def submit(self, req: Request, at_step: int = 0, *,
               backend: Optional[int] = None) -> int:
        """Enqueue a request; route it when it *arrives* (``at_step``), by
        live cost estimate.  ``backend=i`` pins it (still checked feasible).
        Raises ``ValueError`` with the per-backend objections when nothing
        can serve it (incl. provably unmeetable deadlines under
        ``deadline_admission``).  Returns the uid."""
        if req.uid in self._uids:
            raise ValueError(f"duplicate request uid {req.uid} in fleet")
        probe = self._pick(req, backend)     # fail fast, even when staged
        if isinstance(probe, str):
            raise ValueError(probe)
        self._uids.add(req.uid)
        self._n_submitted += 1
        if at_step > self.step_no:
            req.timing.arrival_step = at_step     # routing waits for arrival
            heapq.heappush(self._arrivals,
                           (at_step, -1 if backend is None else backend,
                            self._n_submitted, req))
        else:
            self._sync_clocks()
            self._admit(req, backend)
        return req.uid

    # ------------------------------------------------------------------ #
    # spillover migration
    # ------------------------------------------------------------------ #
    def _migrate_once(self) -> bool:
        """Move one queued-never-started request from a saturated batcher
        (no free slot, non-empty queue) to an idle one (free slots, empty
        queue).  Returns True if something moved."""
        idle = [j for j, b in enumerate(self.batchers)
                if j not in self._quarantined and b._free and not b.queue]
        if not idle:
            return False
        for i, src in enumerate(self.batchers):
            if i in self._quarantined or not src.queue or src._free:
                continue
            # take from the tail: the policy-last request loses the least
            # by leaving this queue, and the head keeps its position
            for r in list(src.queue)[::-1]:
                tgt = next((j for j in idle if self._infeasible_reason(
                    self.batchers[j], r) is None), None)
                if tgt is None:
                    continue
                arrival = r.timing.arrival_step
                req = src.withdraw(r.uid)
                if req is None:          # resume-pending: not movable
                    continue
                self.batchers[tgt].submit(req, arrival_step=arrival)
                self._home[req.uid] = tgt
                self.migrations += 1
                return True
        return False

    # ------------------------------------------------------------------ #
    # watchdog: quarantine + drain + re-admission
    # ------------------------------------------------------------------ #
    def _collect(self, b: ContinuousBatcher) -> None:
        for uid in list(b.done):
            self.done[uid] = b.release(uid)

    def _quarantine(self, i: int, exc: BackendError) -> None:
        """Remove batcher ``i`` from service after a fatal failure
        (``BackendDead``, or transients past its retry budget): salvage its
        finished results, withdraw its whole working set — queued AND
        running — and re-admit everything to the survivors, highest
        priority / earliest deadline first, so any shedding falls on the
        least important tail.  Recovered in-flight requests re-prefill
        their unpadded prefix (recompute-on-resume), which keeps their
        token streams bit-identical to a fault-free run."""
        b = self.batchers[i]
        self._quarantined[i] = f"{type(exc).__name__}: {exc}"
        self._quarantines += 1
        self._collect(b)                 # finished results are still good
        victims: List[Request] = []
        for uid in list(b.running) + list(b.pending):
            r = b.withdraw(uid, running=True)
            if r is not None:
                victims.append(r)
        if all(j in self._quarantined for j in range(len(self.batchers))):
            # no survivors: surface the failure instead of spinning with
            # undrainable work; everything still queued/running is shed
            for r in victims:
                self._shed_req(
                    r, f"backend {i} failed with no surviving backend: "
                       f"{self._quarantined[i]}")
            raise exc
        victims.sort(key=lambda r: (-r.priority, r.next_deadline(),
                                    r.timing.arrival_step or 0))
        for r in victims:
            resume = bool(r.generated)
            if self._admit(r, None, arrival_step=r.timing.arrival_step,
                           resume=resume, check_deadline=False) is None:
                continue                 # shed: counted + reason recorded
            self._recovered += 1
            self.recovered_uids.append(r.uid)
            if resume:
                # in-flight state is rebuilt by re-prefilling the whole
                # prefix on the survivor — recompute-on-resume's price
                self._tokens_recomputed += \
                    len(r.prompt) + len(r.generated)

    def health(self) -> List[str]:
        """Per-backend health: the backend's own verdict, or the
        quarantine record once the watchdog removed it."""
        return [f"quarantined ({self._quarantined[i]})"
                if i in self._quarantined else b.backend.health()
                for i, b in enumerate(self.batchers)]

    # ------------------------------------------------------------------ #
    # stepping
    # ------------------------------------------------------------------ #
    def _sync_clocks(self) -> None:
        # lockstep: every batcher's step counter IS the fleet counter (an
        # idle batcher does not advance itself, so push, never pull)
        for b in self.batchers:
            b.step_no = self.step_no

    def step(self) -> List[TokenEvent]:
        """Advance every live batcher one quantum on the shared clock;
        release due staged arrivals (routing them by live cost), migrate
        spillover, collect finishes fleet-wide.  A batcher whose backend
        fails fatally mid-step is quarantined and its work re-admitted (see
        :meth:`_quarantine`)."""
        self._sync_clocks()
        while self._arrivals and self._arrivals[0][0] <= self.step_no:
            _, backend, _, req = heapq.heappop(self._arrivals)
            # deadline admission already ran at submit; a pinned backend
            # quarantined since then sheds here with the recorded reason
            self._admit(req, None if backend < 0 else backend,
                        arrival_step=req.timing.arrival_step,
                        check_deadline=False)
        if self.migrate:
            while self._migrate_once():
                pass
        out: List[TokenEvent] = []
        for i, b in enumerate(self.batchers):
            if i in self._quarantined:
                continue
            try:
                out.extend(b.step())
            except BackendError as exc:
                # fatal: BackendDead, or a transient streak past the
                # batcher's retry budget — quarantine and re-admit its
                # working set to the survivors (recorded in FleetStats)
                self._quarantine(i, exc)
                continue
            self._collect(b)
        self.step_no += 1
        return out

    # ------------------------------------------------------------------ #
    # results / introspection (the batcher surface, fleet-wide)
    # ------------------------------------------------------------------ #
    @property
    def has_work(self) -> bool:
        return bool(self._arrivals) or \
            any(b.has_work for b in self.batchers)

    @property
    def running(self) -> List[int]:
        return [u for b in self.batchers for u in b.running]

    @property
    def pending(self) -> List[int]:
        return [u for b in self.batchers for u in b.pending] + \
            [r.uid for _, _, _, r in self._arrivals]

    def poll(self, uid: int) -> Optional[Request]:
        return self.done.get(uid)

    def release(self, uid: int) -> Optional[Request]:
        req = self.done.pop(uid, None)
        if req is not None:
            self._uids.discard(uid)
            self._home.pop(uid, None)
        return req

    def where(self, uid: int) -> Optional[int]:
        """Which backend a request was last routed to (None: still staged
        or unknown)."""
        return self._home.get(uid)

    @property
    def stats(self) -> FleetStats:
        """Fleet-wide aggregate: counters summed across batchers (so
        utilization weighs each backend by its slot count), plus the
        watchdog's quarantine/recovery/shed accounting."""
        agg = FleetStats()
        for b in self.batchers:
            s = b.stats
            agg.served += s.served
            agg.decode_steps += s.decode_steps
            agg.prefills += s.prefills
            agg.slot_busy_steps += s.slot_busy_steps
            agg.slot_total_steps += s.slot_total_steps
            agg.preemptions += s.preemptions
            agg.slo_preemptions += s.slo_preemptions
            agg.resumes += s.resumes
            agg.starvation_avoided += s.starvation_avoided
            agg.queued += s.queued
            agg.queue_wait_steps += s.queue_wait_steps
            agg.ttft_misses += s.ttft_misses
            agg.e2e_misses += s.e2e_misses
            agg.prefix_hits += s.prefix_hits
            agg.prefix_hit_tokens += s.prefix_hit_tokens
            agg.prefill_chunks += s.prefill_chunks
            agg.failures += s.failures
            agg.retries += s.retries
            agg.exhausted |= s.exhausted
        agg.quarantines = self._quarantines
        agg.recovered = self._recovered
        agg.tokens_recomputed = self._tokens_recomputed
        agg.shed = self._shed
        return agg

    def run(self, max_steps: int = 100_000) -> Dict[int, Request]:
        """Serve until every queue drains; returns finished requests by
        uid (shed requests land in ``failed``, never here).  Raises
        :class:`IncompleteServeError` (partial ``done`` attached) when
        ``max_steps`` is exhausted first."""
        steps = 0
        while self.has_work and steps < max_steps:
            self.step()
            steps += 1
        if self.has_work:
            raise IncompleteServeError(
                f"Fleet.run(max_steps={max_steps}) exhausted with "
                f"{len(self.running)} running and {len(self.pending)} "
                f"pending requests ({len(self.done)} finished; partial "
                f"results on .done)", done=self.done)
        return self.done
