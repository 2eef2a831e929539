"""Admission / preemption policies for the SLO-aware scheduler.

A :class:`SchedPolicy` tells the :class:`~repro_torch.serving.scheduler.
ContinuousBatcher` three things:

- **admission order** — :meth:`admit_key` ranks the queue (lower first);
  the batcher keeps the queue sorted by it, so the existing bucketed-wave
  admission machinery pulls the policy's head instead of the FIFO head.
- **victim choice** — :meth:`victim_key` ranks *running* requests when one
  must be evicted (higher = preferred victim): on KV-pool exhaustion, and
  for the SLO preemption below.
- **SLO preemption** — :meth:`should_preempt` decides whether a blocked
  queued request justifies evicting the preferred victim *now*.  The
  batcher only asks when the queue head is actually blocked on capacity
  (no free slot, or the paged block budget cannot cover it) — saturation,
  read off live ``SchedulerStats`` utilization and pool pressure, is the
  control signal; an idle system never preempts.

Keys are *static per enqueue*: priorities never change and deadlines are
absolute steps, so the batcher caches each request's key at (re)enqueue
time and sorting stays cheap.  Preempted requests are re-keyed when they
re-enter the queue (their pending-deadline set may have changed — a
request past first token no longer races its TTFT deadline).

Semantics note: policies reorder *scheduling* only.  Masked prefill +
recompute-on-resume make admission order and preemption invisible to any
single request's tokens, so every policy produces bit-identical per-request
outputs — they differ only in latency distribution (and therefore in
goodput under SLO).

A copy of ``repro.serving.sched.policy`` kept by the port, which
imports nothing of ``repro``.
"""
from __future__ import annotations

from typing import Tuple, Union

from repro_torch.serving.types import Request

#: steps of head-room before a TTFT deadline at which EDF is willing to
#: preempt for a blocked request: 1 = the last step where admission can
#: still produce the first token in time on a synchronous backend.
DEFAULT_PREEMPT_SLACK = 1


class SchedPolicy:
    """Base policy: FIFO admission, preempt-youngest victims, never
    preempts for the queue (the pre-SLO scheduler behavior)."""

    name: str = "fifo"
    #: whether the policy ever evicts a running request for a queued one
    #: (pool-exhaustion preemption is always on — it is a liveness
    #: mechanism, not a policy choice)
    preemptive: bool = False
    #: whether admission order can differ from arrival order: False lets
    #: the batcher skip queue sorting entirely (FIFO's deque order — with
    #: preempted requests re-queued at the head — already is the policy
    #: order)
    reorders: bool = False

    def admit_key(self, req: Request, sub_seq: int) -> Tuple:
        """Sort key for the queue (lower = admitted first).  ``sub_seq``
        is the request's global submission sequence number — the FIFO
        tiebreak every policy falls back to."""
        return (0 if req.timing.preemptions else 1, sub_seq)

    def victim_key(self, req: Request, admit_seq: int) -> Tuple:
        """Sort key among running requests (higher = preferred victim).
        ``admit_seq`` is the admission sequence number — youngest-first
        is the universal tiebreak."""
        return (admit_seq,)

    def should_preempt(self, queued: Request, victim: Request,
                       step_no: int) -> bool:
        """May ``queued`` (the policy-first blocked request) evict
        ``victim`` (the policy-preferred running victim) this step?"""
        return False


class FIFOPolicy(SchedPolicy):
    """Arrival order; preempted requests resume before fresh arrivals
    (matching the pre-policy scheduler exactly)."""


class PriorityPolicy(SchedPolicy):
    """Strict priority classes: higher ``SamplingParams.priority`` admits
    first; the preferred victim is the lowest-priority (then youngest)
    running request; a blocked queued request preempts only a strictly
    lower-priority victim — so priority inversion (a high-priority request
    stuck behind saturated low-priority work) cannot persist."""

    name = "priority"
    preemptive = True
    reorders = True

    def admit_key(self, req: Request, sub_seq: int) -> Tuple:
        return (-req.priority, sub_seq)

    def victim_key(self, req: Request, admit_seq: int) -> Tuple:
        return (-req.priority, admit_seq)

    def should_preempt(self, queued: Request, victim: Request,
                       step_no: int) -> bool:
        return queued.priority > victim.priority


class EDFPolicy(SchedPolicy):
    """Earliest-deadline-first over each request's *pending* deadline
    (TTFT until the first token is out, then e2e; ``inf`` when none —
    deadline-free requests yield to every deadline).  The preferred victim
    is the latest-deadline running request; preemption fires only when the
    blocked request's TTFT deadline is within ``slack`` steps of expiring
    AND the victim's deadline is strictly later — so EDF rescues imminent
    deadlines without churning slots for far-future ones.
    """

    name = "edf"
    preemptive = True
    reorders = True

    def __init__(self, slack: int = DEFAULT_PREEMPT_SLACK) -> None:
        self.slack = slack

    def admit_key(self, req: Request, sub_seq: int) -> Tuple:
        return (req.next_deadline(), sub_seq)

    def victim_key(self, req: Request, admit_seq: int) -> Tuple:
        return (req.next_deadline(), admit_seq)

    def should_preempt(self, queued: Request, victim: Request,
                       step_no: int) -> bool:
        qd = queued.next_deadline()
        if not qd < victim.next_deadline():
            return False
        # urgency gate: only a deadline that waiting would forfeit
        return qd <= step_no + self.slack


POLICIES = {"fifo": FIFOPolicy, "priority": PriorityPolicy, "edf": EDFPolicy}


def make_policy(policy: Union[str, SchedPolicy, None]) -> SchedPolicy:
    """``"fifo" | "priority" | "edf"`` (or an instance, passed through)."""
    if policy is None:
        return FIFOPolicy()
    if isinstance(policy, SchedPolicy):
        return policy
    try:
        return POLICIES[policy]()
    except KeyError:
        raise ValueError(
            f"unknown scheduling policy {policy!r}: choose from "
            f"{sorted(POLICIES)} (or pass a SchedPolicy instance)") from None
