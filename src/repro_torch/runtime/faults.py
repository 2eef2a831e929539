"""Deterministic fault injection over any :class:`InferenceBackend`.

EdgeShard's setting is unreliable edge devices on unstable links, so every
recovery path in the scheduler and fleet must be testable without real
hardware failing on cue.  :class:`FaultInjectionBackend` wraps a backend
and injects *typed* faults from a declarative, seeded schedule:

- ``"crash"``     — the backend dies permanently: the op (and every later
  op except ``free_slot``) raises :class:`BackendDead`.
- ``"timeout"``   — the op raises :class:`BackendTimeout` (transient).
- ``"transient"`` — the op raises a plain :class:`BackendError` (flaky
  link / spurious failure; retryable).
- ``"pool"``      — the op raises :class:`PoolExhausted` (a pool *storm*:
  capacity pressure the preemption machinery must absorb, distinct from
  health failures).
- ``"slow"``      — a straggler: no exception, but the wrapped
  ``SimBackend``'s stage costs are scaled by ``slow_factor`` in place, and
  ``health()`` reports ``"degraded"``.

Injection fires **before** delegating to the wrapped backend, so a failed
op never mutates inner state — the retry-the-same-quantum contract of
:class:`BackendError` holds by construction, and recovered token streams
stay bit-identical to fault-free runs.

A :class:`Fault` triggers either at a fixed per-op call index (``at_call``,
deterministic) or per call with probability ``p`` (seeded rng); ``count``
extends either into a burst of consecutive failures.  Schedules are
expressible as compact strings for CLI use::

    crash@decode_step:40            # 41st decode_step call dies
    transient@prefill:2x3           # prefill calls 2,3,4 fail transiently
    timeout@any~0.01                # any op: 1% timeout chance per call
    slow@decode_step:10*4           # from the 11th decode on, 4x slower
"""
from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.runtime.base import (BackendDead, BackendError,
                                      BackendInfo, BackendTimeout,
                                      InferenceBackend, PoolExhausted,
                                      SlotEvent)

#: ops a fault may target ("any" matches all of them).  ``free_slot`` and
#: ``accept`` are deliberately absent: draining a failed backend must
#: always succeed, and accept() is the committed half of a verify quantum.
FAULT_OPS = ("prefill", "decode_step", "verify_step", "prefill_chunk",
             "start_stream")

_KINDS = ("crash", "timeout", "transient", "pool", "slow")

_SPEC_RE = re.compile(
    r"^(?P<kind>[a-z]+)@(?P<op>[a-z_]+)"
    r"(?::(?P<at>\d+)(?:x(?P<count>\d+))?(?:\*(?P<factor>[\d.]+))?"
    r"|~(?P<p>[\d.]+))?$")


@dataclass(frozen=True)
class Fault:
    """One entry of a fault schedule (see module docstring)."""

    kind: str                      # crash | timeout | transient | pool | slow
    op: str = "any"                # FAULT_OPS entry, or "any"
    at_call: Optional[int] = None  # fire at this 0-based matching-call index
    p: float = 0.0                 # else: per-call probability (seeded rng)
    count: int = 1                 # consecutive matching calls to fail
    slow_factor: float = 4.0       # kind="slow": stage-cost multiplier

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}: "
                             f"choose from {_KINDS}")
        if self.op != "any" and self.op not in FAULT_OPS:
            raise ValueError(f"unknown fault op {self.op!r}: choose from "
                             f"{('any',) + FAULT_OPS}")
        if self.at_call is None and self.p <= 0.0 and self.kind != "slow":
            raise ValueError(f"fault {self.kind}@{self.op} needs at_call "
                             f"or p > 0")
        if self.count < 1:
            raise ValueError(f"count must be >= 1, got {self.count}")


def parse_faults(spec: Union[str, Sequence]) -> List[Fault]:
    """Parse a comma-separated schedule string (``kind@op[:at[xcount]
    [*factor] | ~p]``) into :class:`Fault` s; passes sequences of
    ready-made ``Fault`` s through."""
    if not isinstance(spec, str):
        return [f if isinstance(f, Fault) else parse_faults(f)[0]
                for f in spec]
    faults = []
    for part in filter(None, (s.strip() for s in spec.split(","))):
        m = _SPEC_RE.match(part)
        if m is None:
            raise ValueError(
                f"bad fault spec {part!r}: expected kind@op:call[xcount]"
                f"[*factor] or kind@op~p, e.g. 'crash@decode_step:40' or "
                f"'transient@any~0.01'")
        at = m.group("at")
        faults.append(Fault(
            kind=m.group("kind"), op=m.group("op"),
            at_call=None if at is None else int(at),
            count=int(m.group("count") or 1),
            slow_factor=float(m.group("factor") or 4.0),
            p=float(m.group("p") or 0.0)))
    return faults


class FaultInjectionBackend(InferenceBackend):
    """Wrap ``backend`` and inject faults per ``faults`` (a schedule string
    or a sequence of :class:`Fault` s).  Deterministic in ``seed`` for
    probabilistic entries; schedule-indexed entries need no rng at all.

    ``injected`` counts fired faults by kind; :meth:`health` surfaces the
    live verdict and ``info.health`` mirrors it for introspection.
    """

    def __init__(self, backend: InferenceBackend,
                 faults: Union[str, Sequence] = (), seed: int = 0) -> None:
        self.inner = backend
        self.faults: List[Fault] = parse_faults(faults)
        self._rng = np.random.default_rng(seed)
        self._seen = [0] * len(self.faults)    # matching calls observed
        self._burst = [0] * len(self.faults)   # forced failures remaining
        self._slowed = [False] * len(self.faults)
        self._dead: Optional[str] = None
        self.injected: Dict[str, int] = {k: 0 for k in _KINDS}

    # ------------------------------------------------------------------ #
    # injection
    # ------------------------------------------------------------------ #
    def _tick(self, op: str) -> None:
        """Give every fault matching ``op`` a chance to fire — BEFORE the
        delegate runs, so inner state never mutates on a failed op."""
        if self._dead is not None:
            raise BackendDead(self._dead)
        for i, f in enumerate(self.faults):
            if f.op != "any" and f.op != op:
                continue
            k = self._seen[i]
            self._seen[i] = k + 1
            if self._burst[i] > 0:
                self._burst[i] -= 1
            elif f.at_call is not None:
                if not f.at_call <= k < f.at_call + f.count:
                    continue
            elif f.p > 0.0 and self._rng.random() < f.p:
                self._burst[i] = f.count - 1
            else:
                continue
            self._fire(i, f, op, k)

    def _fire(self, idx: int, f: Fault, op: str, call: int) -> None:
        self.injected[f.kind] += 1
        msg = f"injected {f.kind} on {op} (call {call})"
        if f.kind == "slow":
            self._slow_down(idx, f)
            return
        if f.kind == "crash":
            self._dead = msg
            raise BackendDead(msg)
        if f.kind == "timeout":
            raise BackendTimeout(msg)
        if f.kind == "pool":
            raise PoolExhausted(needed=1, free=0)
        raise BackendError(msg)

    def _slow_down(self, idx: int, f: Fault) -> None:
        """Straggler: scale the wrapped SimBackend's stage costs in place
        (numpy arrays inside the frozen StageCosts), once per fault."""
        if self._slowed[idx]:
            return
        self._slowed[idx] = True
        costs = getattr(self.inner, "costs", None)
        if costs is None:
            return                     # device backend: health-only
        for name in ("prefill", "decode", "comm_prefill", "comm_decode"):
            arr = getattr(costs, name, None)
            if arr is not None:
                arr *= f.slow_factor

    # ------------------------------------------------------------------ #
    # protocol (every op delegates after its injection gate)
    # ------------------------------------------------------------------ #
    @property
    def info(self) -> BackendInfo:
        return dataclasses.replace(self.inner.info, health=self.health())

    def health(self) -> str:
        if self._dead is not None:
            return f"dead: {self._dead}"
        if any(self._slowed):
            return "degraded"
        return self.inner.health()

    def prefill(self, slots: Sequence[int], prompts: np.ndarray,
                prompt_lens: Optional[Sequence[int]] = None,
                ) -> List[SlotEvent]:
        self._tick("prefill")
        return self.inner.prefill(slots, prompts, prompt_lens)

    def cached_prefix_len(self, prompt: np.ndarray) -> int:
        return self.inner.cached_prefix_len(prompt)

    def start_stream(self, slot: int, prompt: np.ndarray) -> int:
        self._tick("start_stream")
        return self.inner.start_stream(slot, prompt)

    def prefill_chunk(self, slots: Sequence[int], chunks: np.ndarray,
                      chunk_lens: Sequence[int], starts: Sequence[int],
                      last: Sequence[bool]) -> List[SlotEvent]:
        self._tick("prefill_chunk")
        return self.inner.prefill_chunk(slots, chunks, chunk_lens, starts,
                                        last)

    def verify_step(self, feeds: Dict[int, np.ndarray]) -> List[SlotEvent]:
        self._tick("verify_step")
        return self.inner.verify_step(feeds)

    def accept(self, counts: Dict[int, int]) -> None:
        # never injected: accept() commits a verify quantum the backend
        # already ran — failing between the two would corrupt cache state
        self.inner.accept(counts)

    def decode_step(self, feeds: Dict[int, int]) -> List[SlotEvent]:
        self._tick("decode_step")
        return self.inner.decode_step(feeds)

    def free_slot(self, slot: int) -> None:
        # never injected, and tolerated after death: the scheduler must be
        # able to drain a quarantined backend's slot bookkeeping
        self.inner.free_slot(slot)
