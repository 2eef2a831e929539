"""Request-lifecycle types for the serving API.

These are the vocabulary every serving layer shares — the scheduler
(``serving.scheduler``), the facade (``serving.llm.LLM``), and any server
built on top:

- :class:`SamplingParams` — per-request decode controls (temperature/top-k,
  length and stop conditions) plus the request's *service class*: a
  ``priority`` and optional TTFT / end-to-end deadlines the SLO-aware
  scheduling policies (``serving.sched``) order admission and choose
  preemption victims by.
- :class:`Request` — one in-flight generation stream.  ``uid`` is
  auto-assigned when omitted; explicit uids are allowed (and checked for
  duplicates at submission).
- :class:`RequestOutput` — the finished view handed back to callers: prompt,
  generated tokens, finish reason, and per-request timing.
- :class:`TokenEvent` — one streamed token, emitted by
  ``ContinuousBatcher.step()`` / ``LLM.stream()`` the moment a slot decodes
  it.

Deliberately jax-free: request bookkeeping must be importable by planner and
server code that never touches an accelerator.

A copy of ``repro.serving.types`` kept by the port, which
imports nothing of ``repro``.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

# Auto-assigned uids start far above any plausible explicit uid so the two
# styles can mix in one batcher without spurious duplicate-uid rejections
# (explicit uids are typically small ints; 2**30 still folds into a PRNG
# stream without overflowing uint32).
AUTO_UID_BASE = 1 << 30
_UIDS = itertools.count(AUTO_UID_BASE)


@dataclass
class SamplingParams:
    """Per-request decode controls.

    ``stop_sequences`` are token-id suffixes: generation finishes as soon as
    the generated stream ends with any of them.  ``min_tokens`` suppresses
    every stop condition (eos and stop sequences, not ``max_tokens``) until
    at least that many tokens have been generated.

    The service-class fields are *scheduling hints*, not semantics: they
    never change a request's tokens, only when the scheduler runs it.
    ``priority`` (higher = more important) orders admission under the
    ``"priority"`` policy; ``ttft_slo`` / ``e2e_slo`` are relative deadlines
    in *scheduler steps* (one step = one admission + decode quantum, the
    deterministic clock shared by real and simulated backends) measured from
    the request's arrival, driving the ``"edf"`` policy and the
    deadline-miss accounting in :class:`SchedulerStats`.  ``None`` = no
    deadline.
    """

    temperature: float = 0.0          # 0 = greedy
    top_k: int = 0                    # 0 = no top-k filtering
    max_tokens: int = 64
    eos_id: Optional[int] = None
    stop_sequences: Tuple[Sequence[int], ...] = ()
    min_tokens: int = 0
    priority: int = 0                 # higher = served first ("priority")
    ttft_slo: Optional[int] = None    # first-token deadline, steps from arrival
    e2e_slo: Optional[int] = None     # completion deadline, steps from arrival


@dataclass
class RequestTiming:
    """Per-request lifecycle timestamps.

    ``*_s`` fields are wall-clock (``time.perf_counter``); ``*_step`` fields
    count scheduler steps (one step = one admission + decode quantum).
    """

    submitted_s: Optional[float] = None
    admitted_s: Optional[float] = None
    first_token_s: Optional[float] = None
    finished_s: Optional[float] = None
    submit_step: Optional[int] = None
    #: step the request entered the queue — equals ``submit_step`` for
    #: immediate submissions, the staged ``at_step`` for pre-staged
    #: arrivals.  The SLO clock: deadlines and the ``*_steps`` latency
    #: views count from here, so trace replay (requests staged far in
    #: advance) measures service latency, not staging lead time.
    arrival_step: Optional[int] = None
    admit_step: Optional[int] = None
    first_token_step: Optional[int] = None
    finish_step: Optional[int] = None
    #: times this request was evicted for KV-pool pressure (paged
    #: overcommit) and later recomputed on resume; generated tokens are
    #: preserved across preemptions, so outputs are unaffected
    preemptions: int = 0
    #: total steps spent waiting in the queue (arrival → admission, summed
    #: across re-queues after preemption): attributes latency to queueing
    #: vs execution
    queued_steps: int = 0

    @property
    def queue_s(self) -> Optional[float]:
        if self.submitted_s is None or self.admitted_s is None:
            return None
        return self.admitted_s - self.submitted_s

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token (submission -> first decoded token)."""
        if self.submitted_s is None or self.first_token_s is None:
            return None
        return self.first_token_s - self.submitted_s

    @property
    def e2e_s(self) -> Optional[float]:
        if self.submitted_s is None or self.finished_s is None:
            return None
        return self.finished_s - self.submitted_s

    @property
    def ttft_steps(self) -> Optional[int]:
        """First-token latency in scheduler steps (from arrival)."""
        if self.arrival_step is None or self.first_token_step is None:
            return None
        return self.first_token_step - self.arrival_step

    @property
    def e2e_steps(self) -> Optional[int]:
        """End-to-end latency in scheduler steps (from arrival)."""
        if self.arrival_step is None or self.finish_step is None:
            return None
        return self.finish_step - self.arrival_step


def check_slo(params: SamplingParams, timing: "RequestTiming",
              ) -> Optional[bool]:
    """Did a finished request meet every deadline it declared?  None when it
    declared no SLO or has not finished."""
    if params.ttft_slo is None and params.e2e_slo is None:
        return None
    if timing.finish_step is None:
        return None
    ok = True
    if params.ttft_slo is not None:
        ok &= timing.ttft_steps is not None and \
            timing.ttft_steps <= params.ttft_slo
    if params.e2e_slo is not None:
        ok &= timing.e2e_steps is not None and \
            timing.e2e_steps <= params.e2e_slo
    return ok


@dataclass
class Request:
    """One generation stream.  ``uid`` auto-assigns when omitted."""

    prompt: np.ndarray                # [S] int32, any length >= 1
    params: SamplingParams = field(default_factory=SamplingParams)
    uid: Optional[int] = None
    generated: List[int] = field(default_factory=list)
    finish_reason: Optional[str] = None       # "length" | "stop" | None
    timing: RequestTiming = field(default_factory=RequestTiming)

    def __post_init__(self) -> None:
        if self.uid is None:
            self.uid = next(_UIDS)
        self.prompt = np.asarray(self.prompt, np.int32)

    def check_finish(self) -> Optional[str]:
        """Finish reason the generated stream has reached, or None."""
        g, p = self.generated, self.params
        if len(g) >= p.min_tokens and g:
            if p.eos_id is not None and g[-1] == p.eos_id:
                return "stop"
            for seq in p.stop_sequences:
                s = list(seq)
                if s and len(g) >= len(s) and g[-len(s):] == s:
                    return "stop"
        if len(g) >= p.max_tokens:
            return "length"
        return None

    @property
    def done(self) -> bool:
        return self.finish_reason is not None or self.check_finish() is not None

    # -- service class (scheduling) ------------------------------------ #
    @property
    def priority(self) -> int:
        return self.params.priority

    def next_deadline(self) -> float:
        """The earliest *pending* absolute deadline (scheduler step), or
        ``inf`` when no SLO constrains this request.  A TTFT deadline stops
        pending once the first token is out; the e2e deadline pends until
        finish.  This is the key EDF orders admission (and picks preemption
        victims) by."""
        arrival = self.timing.arrival_step or 0
        dl = float("inf")
        if self.params.ttft_slo is not None and \
                self.timing.first_token_step is None:
            dl = arrival + self.params.ttft_slo
        if self.params.e2e_slo is not None:
            dl = min(dl, arrival + self.params.e2e_slo)
        return dl

    def slo_met(self) -> Optional[bool]:
        """Whether a *finished* request met every deadline it declared
        (None while unfinished or when it declared none)."""
        return check_slo(self.params, self.timing)


@dataclass
class RequestOutput:
    """Finished request as handed back to callers."""

    uid: int
    prompt: np.ndarray
    tokens: List[int]
    finish_reason: Optional[str]
    timing: RequestTiming
    params: Optional[SamplingParams] = None   # service class incl. SLOs

    @classmethod
    def from_request(cls, req: Request) -> "RequestOutput":
        assert req.uid is not None    # auto-assigned in __post_init__
        return cls(uid=req.uid, prompt=req.prompt, tokens=list(req.generated),
                   finish_reason=req.finish_reason, timing=req.timing,
                   params=req.params)

    def slo_met(self) -> Optional[bool]:
        """Deadline verdict (see :meth:`Request.slo_met`); None when the
        request declared no SLO."""
        if self.params is None:
            return None
        return check_slo(self.params, self.timing)

    @property
    def n_prompt(self) -> int:
        return int(len(self.prompt))

    @property
    def n_generated(self) -> int:
        return len(self.tokens)


@dataclass
class TokenEvent:
    """One token streamed out of the batcher."""

    uid: int
    token: int
    index: int                        # position in the request's stream
    step: int                         # scheduler step that produced it
    finished: bool = False
    finish_reason: Optional[str] = None
