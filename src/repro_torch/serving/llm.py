"""The ``LLM`` facade: request-lifecycle serving over the port's runtime.

Port of ``repro.serving.llm``.  This is the public serving surface — the
backend and batcher below it are plumbing it wires together:

    llm = LLM.from_plan(cfg, cluster, workload, kind="pipeline",
                        params=params, impl="cuda")     # Fig. 3 in one call
    llm = LLM.from_backend(TensorBackend(cfg, params, n_slots=4,
                                         max_len=512, impl="cuda"))
    outs = llm.generate(prompts, SamplingParams(max_tokens=32))

Three ways to drive it, all over the same :class:`ContinuousBatcher`:

- **batch** — :meth:`generate` submits, serves to completion, and returns
  one :class:`RequestOutput` per prompt (original order).
- **streaming** — :meth:`stream` yields :class:`TokenEvent` s as slots
  decode, token by token.
- **stepping** — :meth:`submit` / :meth:`step` / :meth:`poll` for servers:
  requests join mid-flight between steps, and completion is polled per
  request instead of draining the world.

Prompts keep their natural length; the batcher pads per length bucket
(*masked* — pads are semantically invisible, so outputs are identical for
any bucket size and to an unpadded run), callers never pad, and
mixed-length prompts share one continuous batch.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Union

import numpy as np

from repro_torch.serving.scheduler import (ContinuousBatcher,
                                           IncompleteServeError,
                                           SchedulerStats)
from repro_torch.serving.types import (Request, RequestOutput, SamplingParams,
                                       TokenEvent)

Prompt = Union[Sequence[int], np.ndarray]


def _as_prompt_list(prompts) -> List[np.ndarray]:
    """Normalize: one prompt or many, lists or arrays, any lengths."""
    if isinstance(prompts, np.ndarray):
        arrs = [prompts] if prompts.ndim == 1 else [np.asarray(p) for p in prompts]
    else:
        prompts = list(prompts)
        if prompts and isinstance(prompts[0], (int, np.integer)):
            arrs = [np.asarray(prompts)]
        else:
            arrs = [np.asarray(p) for p in prompts]
    return [a.astype(np.int32) for a in arrs]


def _params_for(params, n: int) -> List[SamplingParams]:
    if params is None:
        return [SamplingParams() for _ in range(n)]
    if isinstance(params, SamplingParams):
        return [params] * n
    params = list(params)
    assert len(params) == n, f"{len(params)} params for {n} prompts"
    return params


class LLM:
    """Streaming serving facade over one :class:`InferenceBackend`."""

    def __init__(self, backend, *, seed: int = 0, min_bucket: int = 1,
                 pad_id: int = 0, prefill_chunk: Optional[int] = None,
                 policy=None, max_preemptions: int = 3,
                 spec_k: int = 0, draft="ngram", max_retries: int = 3):
        self.batcher = ContinuousBatcher(backend, seed=seed,
                                         min_bucket=min_bucket, pad_id=pad_id,
                                         prefill_chunk=prefill_chunk,
                                         policy=policy,
                                         max_preemptions=max_preemptions,
                                         spec_k=spec_k, draft=draft,
                                         max_retries=max_retries)
        self.backend = self.batcher.backend
        self.deployment = None          # set by from_plan

    # ------------------------------------------------------------------ #
    # constructors
    # ------------------------------------------------------------------ #
    @classmethod
    def from_backend(cls, backend, **kw) -> "LLM":
        """Wrap an already-built backend."""
        return cls(backend, **kw)

    @classmethod
    def from_plan(cls, cfg, cluster, workload=None, *,
                  objective: str = "throughput", kind: str = "pipeline",
                  params=None, n_slots: Optional[int] = None,
                  max_len: int = 256, cache_dtype=None,
                  schedule: str = "nobubbles", impl: str = "ref",
                  seed: int = 0, min_bucket: int = 1, pad_id: int = 0,
                  cache_layout: str = "contiguous", block_size: int = 16,
                  num_blocks: Optional[int] = None,
                  prefix_cache: bool = False,
                  prefill_chunk: Optional[int] = None,
                  policy=None, max_preemptions: int = 3,
                  spec_k: int = 0, draft="ngram", max_retries: int = 3,
                  device=None, stage_procs: bool = False) -> "LLM":
        """Plan -> backend -> serving in one call (the paper's Fig. 3 flow).

        Runs the EdgeShard joint device-selection + partition DP over
        ``cluster`` (the port's copy of the planner) and materializes the
        chosen deployment as a running backend: ``kind="pipeline"`` (the
        no-bubbles stage pipeline, its uneven stages the planner's),
        ``"tensor"`` (the single-device tensor backend), or ``"sim"`` (the
        cost model -- no ``params`` needed).  The planned ``Deployment`` is
        kept on ``llm.deployment``.  Real kinds run on ``device``: the GPU
        unless ``"cpu"`` is asked for.

        The other keywords are :meth:`from_backend`'s and
        :func:`~repro_torch.runtime.factory.from_deployment`'s.  On the
        paged layout the pipeline verifies ``spec_k`` drafts and, with
        ``prefix_cache=True``, adopts cached prompt prefixes; on the
        contiguous layout it reports ``spec_decode=False`` (``spec_k`` then
        serves plain decode) and ignores the prefix cache.  ``prefill_chunk``
        streams admissions on both layouts.  ``stage_procs=True`` runs each
        planned stage in its own process (the reference's one device a
        stage); ``llm.backend.close()`` stops them.
        """
        from repro_torch.core.planner import plan_deployment
        from repro_torch.core.profile import Workload
        from repro_torch.runtime.factory import from_deployment
        workload = workload or Workload(dtype_bytes=2)
        dep = plan_deployment(cfg, cluster, workload, objective=objective)
        backend = from_deployment(dep, cluster, cfg, kind=kind, params=params,
                                  workload=workload, n_slots=n_slots,
                                  max_len=max_len, cache_dtype=cache_dtype,
                                  schedule=schedule, impl=impl,
                                  cache_layout=cache_layout,
                                  block_size=block_size,
                                  num_blocks=num_blocks,
                                  prefix_cache=prefix_cache, device=device,
                                  stage_procs=stage_procs)
        llm = cls(backend, seed=seed, min_bucket=min_bucket, pad_id=pad_id,
                  prefill_chunk=prefill_chunk, policy=policy,
                  max_preemptions=max_preemptions,
                  spec_k=spec_k, draft=draft, max_retries=max_retries)
        llm.deployment = dep
        return llm

    # ------------------------------------------------------------------ #
    # stepping interface (servers)
    # ------------------------------------------------------------------ #
    def submit(self, prompt: Prompt, params: Optional[SamplingParams] = None,
               *, uid: Optional[int] = None, at_step: int = 0) -> int:
        """Enqueue one request (any time, including mid-flight between
        ``step()`` calls).  Returns its uid."""
        req = Request(prompt=np.asarray(prompt, np.int32),
                      params=params or SamplingParams(), uid=uid)
        return self.batcher.submit(req, at_step=at_step)

    def step(self) -> List[TokenEvent]:
        """Advance one scheduler quantum; returns the tokens it produced."""
        return self.batcher.step()

    def poll(self, uid: int, *, release: bool = False,
             ) -> Optional[RequestOutput]:
        """The finished output for ``uid``, or None while it is still
        queued/running (see ``batcher.status(uid)`` for which).

        ``release=True`` drops the finished record after reading it (and
        frees the uid), so long-running servers don't accumulate every
        result ever served."""
        req = self.batcher.done.get(uid)
        if req is None:
            return None
        out = RequestOutput.from_request(req)
        if release:
            self.batcher.release(uid)
        return out

    @property
    def has_work(self) -> bool:
        return self.batcher.has_work

    @property
    def stats(self) -> SchedulerStats:
        return self.batcher.stats

    # ------------------------------------------------------------------ #
    # batch + streaming interfaces
    # ------------------------------------------------------------------ #
    def _submit_all(self, prompts, params) -> List[int]:
        plist = _as_prompt_list(prompts)
        return [self.submit(p, sp)
                for p, sp in zip(plist, _params_for(params, len(plist)))]

    def _drain(self, live: set, max_steps: int) -> Iterator[TokenEvent]:
        """Step until every uid in ``live`` finishes, yielding their events.
        The single stall/exhaustion path behind generate() and stream()."""
        steps = 0
        while live:
            if not self.batcher.has_work or steps >= max_steps:
                self.batcher.stats.exhausted = True
                raise IncompleteServeError(
                    f"serving stalled after {steps} steps with "
                    f"{len(live)} requests unfinished", done=self.batcher.done)
            for ev in self.batcher.step():
                if ev.uid in live:
                    yield ev
                    if ev.finished:
                        live.discard(ev.uid)
            steps += 1

    def generate(self, prompts, params=None, *, max_steps: int = 1_000_000,
                 ) -> List[RequestOutput]:
        """Serve a batch of (variable-length) prompts to completion.

        ``params`` is one shared :class:`SamplingParams` or a list (one per
        prompt).  Returns outputs in prompt order.
        """
        uids = self._submit_all(prompts, params)
        for _ in self._drain(set(uids), max_steps):
            pass
        return [self.poll(u) for u in uids]

    def stream(self, prompts, params=None, *, max_steps: int = 1_000_000,
               ) -> Iterator[TokenEvent]:
        """Serve prompts, yielding each token the step it is decoded.

        Events interleave across requests (continuous batching); per
        request, ``index`` increases 0,1,2,… and the last event has
        ``finished=True``.  Only events for *these* prompts are yielded;
        other in-flight requests keep being served.
        """
        return self._drain(set(self._submit_all(prompts, params)), max_steps)
