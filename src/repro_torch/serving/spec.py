"""Draft sources for speculative decoding.

The scheduler's spec-decode loop (``ContinuousBatcher(spec_k=...)``) feeds
each generating slot ``[t_last, d_1 .. d_{n-1}]`` — the last emitted token
plus up to ``spec_k - 1`` *draft* tokens — through the backend's
``verify_step``, then keeps the longest prefix of drafts the model itself
would have produced.  Greedy outputs are bit-identical to non-speculative
decoding by construction: every emitted token is the model's own argmax,
drafts only decide how many of them one verify pass yields.

A draft source proposes those tokens.  This module ships:

- :class:`NGramDraft` — self-speculation via prompt/output n-gram lookup
  (no second model): match the current suffix earlier in the context and
  propose whatever followed it.  Free, surprisingly effective on repetitive
  or templated text, useless on high-entropy text (acceptance ~ chance).
- :class:`OracleDraft` — replays a known continuation with a tunable
  per-token corruption rate; the benchmark/test harness uses it to pin the
  acceptance rate of a workload.
- :class:`CallableDraft` — adapter for an arbitrary draft *model* hook:
  any ``fn(context, k) -> tokens`` (e.g. a small transformer's greedy
  continuation) becomes a draft source.

All sources are consulted per quantum with the request's full visible
context (prompt + generated so far); they may return fewer than ``k``
tokens (or none — the quantum degenerates to a plain 1-token verify).

A copy of ``repro.serving.spec`` kept by the port, which
imports nothing of ``repro``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np


class DraftSource:
    """Protocol: propose up to ``k`` draft tokens for one request."""

    def propose(self, uid: int, context: np.ndarray, ngen: int,
                k: int) -> List[int]:
        """``uid``: request id; ``context``: prompt + generated tokens;
        ``ngen``: how many of those are generated; ``k``: max drafts."""
        raise NotImplementedError


class NGramDraft(DraftSource):
    """Prompt-lookup self-speculation: find the most recent earlier
    occurrence of the context's trailing n-gram (longest n first) and
    propose the tokens that followed it."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        assert 1 <= min_ngram <= max_ngram
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, uid: int, context: np.ndarray, ngen: int,
                k: int) -> List[int]:
        ctx = np.asarray(context, np.int32).ravel()
        length = len(ctx)
        if k <= 0 or length < self.min_ngram + 1:
            return []
        for n in range(min(self.max_ngram, length - 1),
                       self.min_ngram - 1, -1):
            pat = ctx[length - n:]
            # most recent earlier match wins (local repetition beats stale)
            for s in range(length - n - 1, -1, -1):
                if np.array_equal(ctx[s:s + n], pat):
                    prop = ctx[s + n:s + n + k]
                    if len(prop):
                        return [int(t) for t in prop]
        return []


class OracleDraft(DraftSource):
    """Replay a known continuation, corrupting each draft independently
    with probability ``1 - accept_prob`` — the standard way to benchmark
    the verify path at a controlled acceptance rate."""

    def __init__(self, continuations: Dict[int, Sequence[int]],
                 accept_prob: float = 1.0, seed: int = 0,
                 vocab_size: int = 32000):
        assert 0.0 <= accept_prob <= 1.0
        self.continuations = {u: list(c) for u, c in continuations.items()}
        self.accept_prob = accept_prob
        self.vocab_size = vocab_size
        self._rng = np.random.default_rng(seed)

    def propose(self, uid: int, context: np.ndarray, ngen: int,
                k: int) -> List[int]:
        cont = self.continuations.get(uid)
        if cont is None or k <= 0:
            return []
        out = []
        for t in cont[ngen:ngen + k]:
            if self._rng.random() >= self.accept_prob:
                t = (int(t) + 1 + int(self._rng.integers(0, 7))) \
                    % self.vocab_size
            out.append(int(t))
        return out


class CallableDraft(DraftSource):
    """Adapter for a draft-model hook ``fn(context, k) -> tokens`` (e.g. a
    distilled model's greedy continuation of the context)."""

    def __init__(self, fn: Callable[[np.ndarray, int], Sequence[int]]):
        self.fn = fn

    def propose(self, uid: int, context: np.ndarray, ngen: int,
                k: int) -> List[int]:
        return [int(t) for t in self.fn(context, k)][:k]


def make_draft(spec: Union[None, str, Callable, DraftSource],
               ) -> Optional[DraftSource]:
    """Resolve a draft-source spec: ``"ngram"`` / ``"ngram:<max>"`` /
    ``"off"`` / ``None`` / a callable hook / a DraftSource instance."""
    if spec is None or spec == "off":
        return None
    if isinstance(spec, DraftSource):
        return spec
    if callable(spec):
        return CallableDraft(spec)
    if isinstance(spec, str):
        if spec == "ngram":
            return NGramDraft()
        if spec.startswith("ngram:"):
            return NGramDraft(max_ngram=int(spec.split(":", 1)[1]))
    raise ValueError(f"unknown draft source {spec!r} "
                     f"(expected 'ngram', 'ngram:<max>', 'off', a callable, "
                     f"or a DraftSource)")
