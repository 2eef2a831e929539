"""SimBackend: the discrete-event cost model (``core/simulator.py``) behind
the runtime backend protocol, so planner and benchmark code drive the exact
interface the real backends serve.

Each slot is a micro-batch of ``mb_batch`` sequences flowing through the
planned stages.  ``decode_step`` advances every slot that has a fresh input
token through the stage chain, respecting serially-reusable device resources
(``dev_free``) exactly like :func:`repro.core.simulator.simulate_pipeline`:

- the scheduler's continuous admission *is* the paper's No-bubbles schedule
  (a micro-batch re-enters stage 0 as soon as its token returns),
- ``schedule="bubbles"`` inserts the Fig. 5(a) iteration barrier inside the
  backend, so the two schedules are compared over identical scheduler code.

Tokens are synthetic but *deterministic in the token history*: each emitted
token is a hash of the slot's unpadded prompt + everything generated so far
(salted by ``seed``), so a request's token stream is a pure function of its
prompt — identical across slot placement, admission order, preempt/resume
(the resume prefix *is* prompt+generated), and across separate SimBackend
instances built with the same seed.  That last property is what lets the
multi-backend spillover tests assert token-for-token parity between a fleet
run and a single-backend baseline.  Timing comes from
:class:`repro.core.simulator.StageCosts`.
"""
from __future__ import annotations

import zlib
from typing import Dict, List, Literal, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.simulator import SimResult, StageCosts
from repro_torch.runtime.base import (BackendInfo, InferenceBackend,
                                      PoolExhausted, SlotEvent, SlotPager)
from repro_torch.runtime.prefix_cache import PrefixCache


class SimBackend(InferenceBackend):
    """Event-driven timing simulation of a planned stage deployment.

    ``cache_layout="paged"`` adds *cost-model-only* paging: a
    :class:`~repro.runtime.base.SlotPager` tracks per-slot block tables over
    ``num_blocks`` logical blocks (no storage — the sim has no tensors), so
    planner sweeps exercise the same overcommit admission / PoolExhausted /
    preemption protocol the real backends serve.
    """

    def __init__(self, costs: StageCosts, n_slots: int, mb_batch: int = 1,
                 schedule: Literal["nobubbles", "bubbles"] = "nobubbles",
                 vocab_size: int = 32000, seed: int = 0,
                 max_len: int = 1 << 30,
                 cache_layout: str = "contiguous", block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 prefix_cache: bool = False):
        assert cache_layout in ("contiguous", "paged"), cache_layout
        self.costs = costs
        self.mb_batch = mb_batch
        self.schedule = schedule
        self._n_slots = n_slots
        self._dev_free = np.zeros(costs.n_stages)
        self._ready = np.zeros(n_slots)         # per-slot re-entry time
        self._active = [False] * n_slots
        self._fed = [0] * n_slots               # feeds consumed per slot
        self._seen = [0] * n_slots              # tokens emitted per slot
        self._plen = [0] * n_slots              # prompt tokens per slot
        self._hist: List[List[int]] = [[] for _ in range(n_slots)]
        # ^ unpadded prompt + generated tokens: the hash input for _emit
        self._seed = seed
        self._vocab = vocab_size
        self.makespan = 0.0
        self.tokens_done = 0
        self.pager: Optional[SlotPager] = None
        if cache_layout == "paged":
            nbs = -(-max_len // block_size) if max_len < (1 << 30) \
                else (1 << 30)
            if num_blocks is None:
                num_blocks = n_slots * 8        # sweep-friendly default
            self.pager = SlotPager(n_slots, num_blocks, block_size, nbs,
                                   table_width=min(nbs, num_blocks))
        # cost-model-only prefix sharing: block ids are shared/adopted/
        # registered exactly like the device backends, just with no tensors
        self._prefix_on = bool(prefix_cache) and self.pager is not None
        self.prefix: Optional[PrefixCache] = None
        if self._prefix_on:
            self.prefix = PrefixCache(self.pager.allocator, block_size)
        self._prefix_hits = 0
        self._prefix_hit_tokens = 0
        self._stream_tokens: Dict[int, np.ndarray] = {}
        # advisory decode rate for dispatcher cost estimates: sequences per
        # second through one full decode pass of the stage chain
        step_t = float(np.sum(costs.decode) + np.sum(costs.comm_decode)
                       + costs.return_comm)
        self._pending: Dict[int, Tuple[int, List[int]]] = {}
        self._info = BackendInfo(
            n_slots=n_slots, max_len=max_len, samples_in_backend=True,
            cache_layout=cache_layout,
            block_size=block_size if self.pager else 0,
            total_blocks=self.pager.total_blocks if self.pager else 0,
            free_blocks=self.pager.total_blocks if self.pager else 0,
            max_ctx_blocks=self.pager.max_ctx_blocks if self.pager else 0,
            prefix_caching=self._prefix_on, supports_extend=True,
            spec_decode=True,
            tokens_per_s=mb_batch / max(step_t, 1e-12))

    @property
    def info(self) -> BackendInfo:
        return self._live_info()

    # ------------------------------------------------------------------ #
    def _run_through_stages(self, slot: int, prefill: bool) -> float:
        c = self.costs
        t = self._ready[slot]
        for s in range(c.n_stages):
            start = max(t, self._dev_free[s])
            finish = start + (c.prefill[s] if prefill else c.decode[s])
            self._dev_free[s] = finish
            t = finish
            if s < c.n_stages - 1:
                t += float(c.comm_prefill[s] if prefill else c.comm_decode[s])
        t += c.return_comm                      # sampled ids back to source
        self._ready[slot] = t
        self.makespan = max(self.makespan, t)
        return t

    def _emit(self, slot: int) -> SlotEvent:
        self._seen[slot] += 1
        self.tokens_done += self.mb_batch
        hist = np.asarray(self._hist[slot], np.int32)
        tok = (zlib.crc32(hist.tobytes()) ^ self._seed) % self._vocab
        self._hist[slot].append(tok)
        return SlotEvent(slot=slot, token=int(tok))

    def prefill(self, slots: Sequence[int], prompts: np.ndarray,
                prompt_lens: Optional[Sequence[int]] = None,
                ) -> List[SlotEvent]:
        prompts = np.atleast_2d(np.asarray(prompts))
        lens = [prompts.shape[1]] * len(slots) if prompt_lens is None \
            else [int(n) for n in prompt_lens]
        assert len(lens) == len(slots)
        if self.pager is not None:
            # atomic: on exhaustion nothing mutates; paging accounts each
            # slot's TRUE prompt length — pads hold no blocks
            self.pager.realloc_wave(slots, lens)
        out = []
        for i, (slot, plen) in enumerate(zip(slots, lens)):
            self._active[slot] = True
            self._fed[slot] = 0
            self._seen[slot] = 0
            self._plen[slot] = plen
            # true tokens sit right-aligned in the padded row; the hash
            # history starts from the unpadded prompt so pads (and slot /
            # wave placement) can never change the stream
            self._hist[slot] = \
                prompts[i, prompts.shape[1] - plen:].astype(np.int32).tolist()
            self._ready[slot] = self.makespan if self.schedule == "bubbles" \
                else self._ready[slot]
            self._run_through_stages(slot, prefill=True)
            out.append(self._emit(slot))        # prefill emits the first token
        return out

    # --------------------------- streamed admission ------------------- #
    def cached_prefix_len(self, prompt: np.ndarray) -> int:
        if not self._prefix_on:
            return 0
        p = np.asarray(prompt, np.int32).ravel()
        bs = self.pager.block_size
        cap = ((len(p) - 1) // bs) * bs
        return self.prefix.matched_tokens(p[:cap])

    def start_stream(self, slot: int, prompt: np.ndarray) -> int:
        p = np.asarray(prompt, np.int32).ravel()
        if self.pager is not None:
            self.pager.release(slot)
        start = 0
        if self._prefix_on:
            bs = self.pager.block_size
            cap = ((len(p) - 1) // bs) * bs
            blocks = self.prefix.lookup(p[:cap])
            if blocks:
                start = len(blocks) * bs
                self.pager.adopt(slot, blocks)
                self._prefix_hits += 1
                self._prefix_hit_tokens += start
            self._stream_tokens[slot] = p
        self._active[slot] = True
        self._fed[slot] = 0
        self._seen[slot] = 0
        self._plen[slot] = start                # grows as chunks land
        self._hist[slot] = p.tolist()           # full prompt: chunk layout
        #                                         never changes the stream
        return start

    def prefill_chunk(self, slots: Sequence[int], chunks: np.ndarray,
                      chunk_lens: Sequence[int], starts: Sequence[int],
                      last: Sequence[bool]) -> List[SlotEvent]:
        """Each chunk pays one prefill pass through the stage chain (the
        cost model has no per-token prefill resolution); the final chunk
        emits the first sampled token, like :meth:`prefill`."""
        if self.pager is not None:
            need = sum(max(self.pager.blocks_for_len(
                int(starts[i]) + int(chunk_lens[i]))
                - int(self.pager.n_alloc[s]), 0)
                for i, s in enumerate(slots))
            if need > self.pager.free_blocks:   # atomic: nothing mutates
                raise PoolExhausted(needed=need,
                                    free=self.pager.free_blocks)
            for i, s in enumerate(slots):
                end = int(starts[i]) + int(chunk_lens[i])
                if end:
                    self.pager.ensure(s, end - 1)
        out = []
        for i, slot in enumerate(slots):
            assert self._active[slot], slot
            assert int(starts[i]) == self._plen[slot], \
                (starts[i], self._plen[slot])
            self._plen[slot] += int(chunk_lens[i])
            self._run_through_stages(slot, prefill=True)
            if last[i]:
                toks = self._stream_tokens.pop(slot, None)
                if toks is not None and self._prefix_on:
                    bs = self.pager.block_size
                    nfull = min(len(toks) // bs,
                                int(self.pager.n_alloc[slot]))
                    if nfull:
                        self.prefix.register(
                            toks, self.pager.table[slot, :nfull].tolist())
                out.append(self._emit(slot))
        return out

    def decode_step(self, feeds: Dict[int, int]) -> List[SlotEvent]:
        live = [s for s in sorted(feeds) if self._active[s]]
        if not live:
            return []
        if self.pager is not None:
            need = sum(self.pager.blocks_needed(
                s, self._plen[s] + self._fed[s]) for s in live)
            if need > self.pager.free_blocks:   # raise BEFORE any mutation
                raise PoolExhausted(needed=need,
                                    free=self.pager.free_blocks)
            for s in live:
                self.pager.ensure(s, self._plen[s] + self._fed[s])
        if self.schedule == "bubbles":          # Fig. 5(a) iteration barrier
            barrier = max(self._ready[s] for s in live)
            for s in live:
                self._ready[s] = barrier
        out = []
        for slot in live:
            self._fed[slot] += 1
            self._run_through_stages(slot, prefill=False)
            out.append(self._emit(slot))
        return out

    # ----------------------- speculative verify ----------------------- #
    def verify_step(self, feeds: Dict[int, np.ndarray]) -> List[SlotEvent]:
        """Score each slot's fed tokens in ONE pass through the stage chain
        — the cost model's expression of the verify amortization: n fed
        tokens cost one decode round instead of n.  Computation is
        non-mutating (the g-chain is derived from a scratch copy of the
        history); :meth:`accept` commits the kept prefix."""
        live = [s for s in sorted(feeds) if self._active[s]]
        if not live:
            return []
        assert not self._pending, "verify_step before accept() of the last"
        fed = {s: np.asarray(feeds[s], np.int32).ravel() for s in live}
        assert all(len(f) >= 1 for f in fed.values())
        if self.pager is not None:
            need = sum(max(self.pager.blocks_for_len(
                self._plen[s] + self._fed[s] + len(fed[s]))
                - int(self.pager.n_alloc[s]), 0) for s in live)
            if need > self.pager.free_blocks:   # raise BEFORE any mutation
                raise PoolExhausted(needed=need,
                                    free=self.pager.free_blocks)
            for s in live:
                self.pager.ensure(
                    s, self._plen[s] + self._fed[s] + len(fed[s]) - 1)
        if self.schedule == "bubbles":
            barrier = max(self._ready[s] for s in live)
            for s in live:
                self._ready[s] = barrier
        out = []
        for s in live:
            self._run_through_stages(s, prefill=False)
            hist = list(self._hist[s])
            g: List[int] = []
            for i in range(len(fed[s])):
                if i:
                    # fed token i is draft d_i; its key joins the history
                    # the (i+1)-th output conditions on
                    hist.append(int(fed[s][i]))
                tok = (zlib.crc32(np.asarray(hist, np.int32).tobytes())
                       ^ self._seed) % self._vocab
                g.append(int(tok))
            self._pending[s] = (len(fed[s]), g)
            out.append(SlotEvent(slot=s, tokens=np.asarray(g, np.int32)))
        return out

    def accept(self, counts: Dict[int, int]) -> None:
        pend, self._pending = self._pending, {}
        assert set(counts) == set(pend), (sorted(counts), sorted(pend))
        for s, e in counts.items():
            n, g = pend[s]
            e = int(e)
            assert 0 <= e <= n, (s, e, n)
            # the scheduler only emits g[i] when draft i+1 matched g[i], so
            # appending the emitted prefix reproduces the sequential stream
            self._hist[s].extend(g[:e])
            self._seen[s] += e
            self._fed[s] += e
            self.tokens_done += e * self.mb_batch

    def free_slot(self, slot: int) -> None:
        self._active[slot] = False
        self._stream_tokens.pop(slot, None)
        self._pending.pop(slot, None)
        if self.pager is not None:
            self.pager.release(slot)

    # ------------------------------------------------------------------ #
    def sim_result(self) -> SimResult:
        """Aggregate metrics in the simulator's units."""
        tokens = self.tokens_done
        ms = max(self.makespan, 1e-12)
        return SimResult(self.makespan, tokens, ms / max(tokens, 1),
                         tokens / ms)
