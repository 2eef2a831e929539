"""Reproducible arrival traces for the serve-replay harness.

A trace is a list of :class:`TraceItem` s — ``(at_step, prompt, params)`` —
ready to stage into a :class:`~repro.serving.scheduler.ContinuousBatcher`
or :class:`~repro.serving.sched.fleet.Fleet` via ``submit(..., at_step=)``.
Everything is seeded ``numpy.random.default_rng`` and measured in scheduler
*steps*, so a trace replays bit-identically on any backend and any policy.

Two arrival processes:

- :func:`poisson_trace` — exponential interarrivals at a constant rate:
  the steady open-loop load every queueing result assumes.
- :func:`bursty_trace` — a 2-state Markov-modulated Poisson process
  (CALM / BURST, geometric dwell times, rate multiplied by
  ``burst_factor`` while bursting): the flash-crowd shape that separates
  deadline-aware scheduling from FIFO.  Under Poisson load a modest
  queue rarely inverts deadlines; under bursts the backlog does, and EDF's
  goodput advantage shows up.

Both mix *service classes* (:class:`TraceClass`: a weight, a priority, and
optional TTFT / e2e deadlines) and prompt/output length ranges; an optional
``shared_prefix`` fraction draws prompts from a small set of common
prefixes so prefix-cache runs have something to hit.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.types import SamplingParams


@dataclass(frozen=True)
class TraceClass:
    """One service class requests are drawn from (weights need not sum
    to 1 — they are normalized)."""

    name: str
    weight: float = 1.0
    priority: int = 0
    ttft_slo: Optional[int] = None    # steps from arrival, None = no deadline
    e2e_slo: Optional[int] = None


#: interactive / standard / batch mix: tight deadlines on a minority of
#: traffic, no deadlines on the bulk — the shape that makes deadline-aware
#: admission matter (uniform SLOs degenerate every policy to FIFO)
DEFAULT_CLASSES: Tuple[TraceClass, ...] = (
    TraceClass("interactive", weight=0.25, priority=2,
               ttft_slo=12, e2e_slo=60),
    TraceClass("standard", weight=0.35, priority=1,
               ttft_slo=40, e2e_slo=160),
    TraceClass("batch", weight=0.40, priority=0),
)


@dataclass
class TraceItem:
    """One request of a trace, ready to ``submit(..., at_step=at_step)``."""

    at_step: int
    prompt: np.ndarray
    params: SamplingParams
    cls: str = ""                     # service-class name (reporting only)


@dataclass
class _Lengths:
    prompt: Tuple[int, int]
    output: Tuple[int, int]


def _gen(rng: np.random.Generator, arrivals: Sequence[int],
         classes: Sequence[TraceClass], lens: _Lengths, vocab: int,
         shared_prefix: float, n_prefixes: int, prefix_len: int,
         ) -> List[TraceItem]:
    classes = list(classes)
    w = np.asarray([c.weight for c in classes], float)
    w = w / w.sum()
    plo, phi = lens.prompt
    olo, ohi = lens.output
    prefix_len = min(prefix_len, max(plo - 1, 1))
    prefixes = rng.integers(1, vocab, size=(max(n_prefixes, 1), prefix_len))
    items: List[TraceItem] = []
    for at in arrivals:
        c = classes[int(rng.choice(len(classes), p=w))]
        plen = int(rng.integers(plo, phi + 1))
        prompt = rng.integers(1, vocab, size=plen).astype(np.int32)
        if shared_prefix > 0.0 and rng.random() < shared_prefix:
            g = int(rng.integers(0, len(prefixes)))
            prompt[:prefix_len] = prefixes[g]
        params = SamplingParams(max_tokens=int(rng.integers(olo, ohi + 1)),
                                priority=c.priority, ttft_slo=c.ttft_slo,
                                e2e_slo=c.e2e_slo)
        items.append(TraceItem(at_step=int(at), prompt=prompt, params=params,
                               cls=c.name))
    return items


def poisson_trace(n: int, *, seed: int = 0, mean_iat: float = 2.0,
                  prompt_lens: Tuple[int, int] = (8, 48),
                  out_lens: Tuple[int, int] = (4, 24),
                  classes: Sequence[TraceClass] = DEFAULT_CLASSES,
                  vocab: int = 32000, shared_prefix: float = 0.0,
                  n_prefixes: int = 4, prefix_len: int = 16,
                  ) -> List[TraceItem]:
    """``n`` requests with exponential interarrivals (mean ``mean_iat``
    steps), mixed classes and lengths.  Deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    t, arrivals = 0.0, []
    for _ in range(n):
        t += rng.exponential(mean_iat)
        arrivals.append(int(t))
    return _gen(rng, arrivals, classes, _Lengths(prompt_lens, out_lens),
                vocab, shared_prefix, n_prefixes, prefix_len)


def bursty_trace(n: int, *, seed: int = 0, mean_iat: float = 2.0,
                 burst_factor: float = 8.0, p_enter: float = 0.05,
                 p_exit: float = 0.15,
                 prompt_lens: Tuple[int, int] = (8, 48),
                 out_lens: Tuple[int, int] = (4, 24),
                 classes: Sequence[TraceClass] = DEFAULT_CLASSES,
                 vocab: int = 32000, shared_prefix: float = 0.0,
                 n_prefixes: int = 4, prefix_len: int = 16,
                 ) -> List[TraceItem]:
    """``n`` requests from a 2-state MMPP: CALM interarrivals are scaled so
    the *long-run* mean stays ``mean_iat`` (equal offered load to
    :func:`poisson_trace`), BURST runs ``burst_factor`` times faster;
    state flips with per-arrival probabilities ``p_enter`` / ``p_exit``
    (geometric dwell).  Deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    # long-run fraction of arrivals in BURST under the flip probabilities
    frac_burst = p_enter / max(p_enter + p_exit, 1e-12)
    # solve calm_iat so the mixed mean matches: f/b·x + (1-f)·x = mean_iat
    calm_iat = mean_iat / (1.0 - frac_burst + frac_burst / burst_factor)
    t, burst, arrivals = 0.0, False, []
    for _ in range(n):
        iat = calm_iat / burst_factor if burst else calm_iat
        t += rng.exponential(iat)
        arrivals.append(int(t))
        if burst:
            burst = rng.random() >= p_exit
        else:
            burst = rng.random() < p_enter
    return _gen(rng, arrivals, classes, _Lengths(prompt_lens, out_lens),
                vocab, shared_prefix, n_prefixes, prefix_len)


@dataclass
class ReplayReport:
    """Latency/goodput summary of one replayed trace (steps, not seconds)."""

    n: int = 0
    steps: int = 0                    # scheduler steps the replay took
    ttft_p50: float = 0.0
    ttft_p99: float = 0.0
    e2e_p50: float = 0.0
    e2e_p99: float = 0.0
    n_slo: int = 0                    # requests that declared any SLO
    slo_met: int = 0                  # of those: met every declared deadline
    preemptions: int = 0
    slo_preemptions: int = 0
    migrations: int = 0
    starvation_avoided: int = 0
    queue_wait_steps: int = 0
    # failure accounting (0 unless the server is a Fleet under faults)
    failures: int = 0                 # typed backend failures observed
    retries: int = 0                  # transients absorbed by backoff
    quarantines: int = 0              # backends removed by the watchdog
    recovered: int = 0                # requests re-admitted to survivors
    shed: int = 0                     # requests no survivor could hold
    by_class: dict = field(default_factory=dict)  # name -> {n, slo_met, n_slo}

    @property
    def goodput(self) -> float:
        """Fraction of SLO-declaring requests that met every deadline."""
        return self.slo_met / max(self.n_slo, 1)


def replay(server, trace: Sequence[TraceItem], *, max_steps: int = 1_000_000,
           ) -> ReplayReport:
    """Stage ``trace`` into ``server`` (a :class:`ContinuousBatcher`,
    :class:`~repro.serving.llm.LLM`, or
    :class:`~repro.serving.sched.fleet.Fleet` — anything with
    ``submit(Request, at_step=)`` / ``run()`` / ``done``), serve it to
    completion, and summarize."""
    from repro_torch.serving.types import Request
    batcher = getattr(server, "batcher", server)   # unwrap an LLM facade
    uid_cls = {}
    for it in trace:
        req = Request(prompt=it.prompt, params=it.params)
        batcher.submit(req, at_step=it.at_step)
        uid_cls[req.uid] = it.cls
    done = batcher.run(max_steps=max_steps)
    ttft = [r.timing.ttft_steps for r in done.values()
            if r.timing.ttft_steps is not None]
    e2e = [r.timing.e2e_steps for r in done.values()
           if r.timing.e2e_steps is not None]
    rep = ReplayReport(n=len(done), steps=batcher.step_no)
    if ttft:
        rep.ttft_p50 = float(np.percentile(ttft, 50))
        rep.ttft_p99 = float(np.percentile(ttft, 99))
    if e2e:
        rep.e2e_p50 = float(np.percentile(e2e, 50))
        rep.e2e_p99 = float(np.percentile(e2e, 99))
    for uid, r in done.items():
        met = r.slo_met()
        c = rep.by_class.setdefault(uid_cls.get(uid, ""),
                                    {"n": 0, "n_slo": 0, "slo_met": 0})
        c["n"] += 1
        if met is not None:
            rep.n_slo += 1
            c["n_slo"] += 1
            rep.slo_met += int(met)
            c["slo_met"] += int(met)
    st = batcher.stats
    rep.preemptions = st.preemptions
    rep.slo_preemptions = st.slo_preemptions
    rep.starvation_avoided = st.starvation_avoided
    rep.queue_wait_steps = st.queue_wait_steps
    rep.migrations = getattr(batcher, "migrations", 0)
    rep.failures = st.failures
    rep.retries = st.retries
    rep.quarantines = getattr(st, "quarantines", 0)   # FleetStats only
    rep.recovered = getattr(st, "recovered", 0)
    rep.shed = getattr(st, "shed", 0)
    return rep
