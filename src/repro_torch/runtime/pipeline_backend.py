"""PipelineBackend: the EdgeShard stage pipeline (planner-chosen, possibly
uneven stages; no-bubbles tick decode) behind the runtime backend protocol.

Port of ``repro.runtime.pipeline_backend``, on one device.  A *slot* is one
micro-batch of the tick protocol (:mod:`repro_torch.core.pipeline`) and
serves exactly one request stream.

Prompt processing is teacher-forced through the same tick path the paper
uses for generation: each of the slot's turns feeds the next prompt token;
outputs before the last prompt token are discarded.  Slots with no active
request tick with ``feed_valid=False``, so no stage runs for them and no
cache row of theirs is touched -- which also makes slot recycling safe: a
freed slot's caches are reset on admission and nothing in flight can write
to them afterwards.

The quantum is one tick.  Each ``decode_step`` feeds micro-batch
``tick % M`` and completes (at most) the micro-batch fed ``n_stages - 1``
ticks ago, whose last-stage logits returned to stage 0 -- so events carry
``logits`` and the scheduler samples on the host.

``cache_layout="paged"`` swaps the dense per-micro-batch KV for a block
pool per layer, with one host-side allocator
(:class:`~repro_torch.runtime.base.SlotPager`) governing the block ids of
every stage.  Blocks are allocated lazily, one table growth per tick as the
teacher-forced or decode position crosses a block boundary; when the pool
cannot cover the next tick the backend raises
:class:`~repro_torch.runtime.base.PoolExhausted` before mutating anything,
and the scheduler preempts.

``impl="cuda"`` reads the caches with the hand-written decode attention
kernels: the contiguous ring through ``decode_attention``, the pool through
the micro-batch's block-table row with ``paged_attention`` (one slot a
call).  An int8 KV cache (``kv_dtype="int8"``) rides both layouts, its
scale pools in every micro-batch's view; its pool is read by gather, as
the reference does (``attn_impl`` reports ``"ref"``).

Speculative decoding (``verify_step``/``accept``) teacher-forces each
slot's draft tokens through the same tick protocol, one token a turn, and
returns the per-position logits stacked ``[n, V]``; a rejected suffix is
cut by rewriting the slot's ``key_pos`` rows in every layer
(:func:`~repro_torch.core.pipeline.rollback_slot`; ring slot equals
absolute position under the paged spec gate).  Streamed admission
(``start_stream``/``prefill_chunk``) queues a prompt's chunks for the same
teacher-forcing, on both layouts; with ``prefix_cache=True`` on the paged
layout a :class:`~repro_torch.runtime.prefix_cache.PrefixCache` over the
pager's allocator adopts a prompt's cached whole-block prefix, and the slot
starts decoding after it.

Not yet ported from the reference: several lanes a slot, the vocab-sharded
tick and stages on more than one card.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import pipeline as PL
from repro_torch.device import Device, resolve_device, torch_dtype
from repro_torch.models import kvcache as KV
from repro_torch.models.attention import effective_decode_impl
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.base import (BackendInfo, InferenceBackend,
                                      PoolExhausted, SlotEvent, SlotPager)
from repro_torch.runtime.prefix_cache import PrefixCache
from repro_torch.runtime.tensor import _leaves, _nbytes


class PipelineBackend(InferenceBackend):
    """No-bubbles stage-pipeline decode with micro-batch-granular slots."""

    def __init__(self, cfg: ModelConfig, params: Dict, spec: PL.PipelineSpec,
                 *, n_slots: Optional[int] = None, max_len: int = 256, cache_dtype: Optional[torch.dtype] = None,
                 impl: str = "ref", cache_layout: str = "contiguous",
                 block_size: int = KV.DEFAULT_BLOCK_SIZE,
                 num_blocks: Optional[int] = None,
                 prefix_cache: bool = False, device: Device = None):
        if cache_layout not in ("contiguous", "paged"):
            raise ValueError(f"cache_layout={cache_layout!r}: expected "
                             f"'contiguous' or 'paged'")
        m = n_slots or spec.n_stages
        if m < spec.n_stages:
            raise ValueError(f"need >= {spec.n_stages} micro-batch slots for "
                             f"no bubbles, got {m}")
        nbs = KV.max_ctx_blocks(cfg, max_len, block_size)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.spec = spec
        self.max_len = max_len
        self.impl = impl
        #: KV storage dtype; defaults to the model dtype, as the port's
        #: TensorBackend does
        self.cache_dtype = cache_dtype if cache_dtype is not None \
            else torch_dtype(cfg.dtype)
        self.cache_layout = cache_layout
        self.block_size = block_size
        self._m = m
        paged = cache_layout == "paged"
        # an attention-free model has nothing to page: it keeps the
        # contiguous machinery and reports an (empty) paged pool, as the
        # tensor backend does
        self._paged_exec = paged and nbs > 0
        self.num_blocks = 0
        self.pager: Optional[SlotPager] = None
        if paged:
            self.num_blocks = num_blocks if num_blocks is not None \
                else m * nbs
            self.pager = SlotPager(m, self.num_blocks, block_size, nbs)
        # prefix sharing and spec decode ride the paged pool with absolute
        # ring positions: all-attention, no effective window at max_len
        # (one lane a slot, so the reference's lanes term is always met)
        self._spec_ok = self._paged_exec and \
            KV.prefix_sharing_supported(cfg, max_len)
        self._prefix_on = bool(prefix_cache) and self._spec_ok
        self.prefix: Optional[PrefixCache] = None
        if self._prefix_on:
            self.prefix = PrefixCache(self.pager.allocator, block_size)
        self._prefix_hits = 0
        self._prefix_hit_tokens = 0
        self.state = PL.init_pipeline_decode_state(
            cfg, spec, m, max_len, self.cache_dtype,
            "paged" if self._paged_exec else "contiguous", self.num_blocks,
            block_size, self.device)
        self._bt_dirty = False

        self._prompts: Dict[int, np.ndarray] = {}       # slot -> [plen]
        self._rounds: Dict[int, int] = {}               # feeds so far
        self._gen_ready: Dict[int, int] = {}            # generated tokens seen
        # feed tick -> (slot, round, occupancy epoch): the epoch guard drops
        # completions of a preempted occupancy that were still in the ring
        # when the slot was freed and re-admitted
        self._inflight: Dict[int, Tuple[int, int, int]] = {}
        # feed tick -> (slot, draft index, epoch) for in-flight verify feeds
        self._vflight: Dict[int, Tuple[int, int, int]] = {}
        self._epoch: Dict[int, int] = {}
        # slot -> (first round, tokens, "verify" | "first") awaiting accept()
        self._pending: Dict[int, Tuple[int, int, str]] = {}
        self._base: Dict[int, int] = {}          # slot -> adopted prefix len
        self._stream_done: Dict[int, bool] = {}  # every chunk queued?
        self._full_tokens: Dict[int, np.ndarray] = {}  # for registration

        caches = self.state.caches
        cache_bytes = _nbytes({id(t): t for c in caches
                               for t in c.values()}.values())
        self._info = BackendInfo(
            n_slots=m, max_len=max_len,
            cache_bytes_per_slot=cache_bytes // m,
            param_bytes=_nbytes(_leaves(params)),
            samples_in_backend=False,
            attn_impl=effective_decode_impl(
                impl, cfg, self.device,
                "paged" if self._paged_exec else "contiguous"),
            spec_decode=self._spec_ok,
            cache_layout=cache_layout,
            block_size=block_size if paged else 0,
            total_blocks=self.num_blocks,
            free_blocks=self.num_blocks,
            bytes_per_block=KV.block_pool_bytes_per_block(
                cfg, self.cache_dtype) if paged else 0,
            max_ctx_blocks=nbs if paged else 0,
            prefix_caching=self._prefix_on,
            # teacher-forcing feeds one token a tick, so chunked admission
            # is a staged feed queue: supported on both layouts
            supports_extend=True)

    @property
    def info(self) -> BackendInfo:
        return self._live_info()

    # ------------------------------------------------------------------ #
    def prefill(self, slots: Sequence[int], prompts: np.ndarray,
                prompt_lens: Optional[Sequence[int]] = None,
                ) -> List[SlotEvent]:
        """Admit prompts; tokens stream through subsequent ticks, so the
        first sampled token arrives from a later ``decode_step``.

        ``prompt_lens[i]`` marks ``prompts[i]`` as left-padded to a bucket
        with true length ``prompt_lens[i]``.  Teacher-forcing is shape-free
        (one token per tick), so the pads are *stripped* and only the real
        tokens are fed, starting at position 0."""
        prompts = np.asarray(prompts, np.int32)
        assert prompts.ndim == 2 and prompts.shape[0] == len(slots)
        if prompt_lens is None:
            lens = [prompts.shape[1]] * len(slots)
        else:
            lens = [int(n) for n in prompt_lens]
            assert len(lens) == len(slots)
            assert all(1 <= n <= prompts.shape[1] for n in lens), \
                (lens, prompts.shape)
        for i, slot in enumerate(slots):
            self._release(slot)                 # blocks grow lazily per tick
            self._full_tokens.pop(slot, None)
            self._admit(slot, prompts[i, prompts.shape[1] - lens[i]:], 0,
                        True)
        return []

    def _release(self, slot: int) -> None:
        if self.pager is not None and self.pager.release(slot):
            self._bt_dirty = True

    def _admit(self, slot: int, prompt: np.ndarray, start: int,
               stream_done: bool) -> None:
        """A new occupancy of ``slot`` that teacher-forces ``prompt`` from
        position ``start`` (an adopted prefix's length)."""
        PL.reset_slot(self.state, slot, start)
        self._prompts[slot] = prompt
        self._rounds[slot] = 0
        self._gen_ready[slot] = 0
        self._epoch[slot] = self._epoch.get(slot, 0) + 1
        self._base[slot] = start
        self._stream_done[slot] = stream_done

    # --------------------------- streamed admission ------------------- #
    def _adoptable(self, prompt: np.ndarray) -> np.ndarray:
        """The prompt's head a cached prefix may cover: whole blocks, and
        never the whole prompt (at least one token must run so the first
        sampled token exists).  Every write of the slot then lands at or
        above it, so the adopted (shared) blocks are never written."""
        p = np.asarray(prompt, np.int32).ravel()
        return p[:((len(p) - 1) // self.block_size) * self.block_size]

    def cached_prefix_len(self, prompt: np.ndarray) -> int:
        if not self._prefix_on:
            return 0
        return self.prefix.matched_tokens(self._adoptable(prompt))

    def start_stream(self, slot: int, prompt: np.ndarray) -> int:
        start = 0
        self._release(slot)
        if self._prefix_on:
            blocks = self.prefix.lookup(self._adoptable(prompt))
            if blocks:
                start = len(blocks) * self.block_size
                self.pager.adopt(slot, blocks)
                self._bt_dirty = True
                self._prefix_hits += 1
                self._prefix_hit_tokens += start
            self._full_tokens[slot] = np.asarray(prompt, np.int32).ravel()
        self._admit(slot, np.zeros(0, np.int32), start, False)
        return start

    def prefill_chunk(self, slots: Sequence[int], chunks: np.ndarray,
                      chunk_lens: Sequence[int], starts: Sequence[int],
                      last: Sequence[bool]) -> List[SlotEvent]:
        """Queue suffix tokens for the tick loop's teacher-forcing: later
        ``decode_step`` ticks feed them one a turn, so no event is emitted
        here (the first sampled token rides the ring after the last chunk's
        last token)."""
        chunks = np.atleast_2d(np.asarray(chunks, np.int32))
        for i, slot in enumerate(slots):
            assert slot in self._prompts \
                and self._stream_done.get(slot) is False, slot
            n = int(chunk_lens[i])
            toks = chunks[i, chunks.shape[1] - n:]          # strip left pads
            fed = self._base[slot] + len(self._prompts[slot])
            assert int(starts[i]) == fed, (starts[i], fed)
            self._prompts[slot] = np.concatenate([self._prompts[slot], toks])
            if last[i]:
                self._stream_done[slot] = True
        return []

    def _feed_for(self, slot: int, feeds: Dict[int, int],
                  ) -> Optional[np.ndarray]:
        """Next input token [1] for this slot's turn, or None to idle."""
        if slot not in self._prompts:
            return None                             # no active request
        r = self._rounds[slot]
        prompt = self._prompts[slot]
        if r < len(prompt):
            return prompt[r:r + 1]                  # teacher-forced prefill
        # generation: consume the scheduler's sampled token exactly once
        if (r - len(prompt)) < self._gen_ready[slot] and slot in feeds:
            return np.full(1, feeds[slot], np.int32)
        return None                                 # stalled (no fresh token)

    def _push_table(self) -> None:
        pool = next(c for c in self.state.caches if "k_pool" in c)
        pool["bt"].copy_(
            torch.from_numpy(self.pager.table).to(self.device))
        self._bt_dirty = False

    def decode_step(self, feeds: Dict[int, int]) -> List[SlotEvent]:
        slot = self.state.tick % self._m
        feed = self._feed_for(slot, feeds)
        valid = feed is not None
        if valid and self._paged_exec:
            # this tick writes position base + rounds[slot] (base = the
            # adopted shared-prefix length); grow the slot's block table
            # first, raising BEFORE any bookkeeping so the scheduler can
            # preempt a victim and retry the very same tick
            pos = self._base[slot] + self._rounds[slot]
            need = self.pager.blocks_needed(slot, pos)
            if need > self.pager.free_blocks:
                raise PoolExhausted(needed=need, free=self.pager.free_blocks)
            if self.pager.ensure(slot, pos):
                self._bt_dirty = True
        if self._bt_dirty:
            self._push_table()
        tick = self.state.tick
        if valid:
            self._inflight[tick] = (slot, self._rounds[slot],
                                    self._epoch.get(slot, 0))
            self._rounds[slot] += 1
        else:
            feed = np.zeros(1, np.int32)
        self._tick(feed, valid)
        done = self._inflight.pop(tick - (self.spec.n_stages - 1), None)
        if done is None:
            return []
        dslot, r, epoch = done
        if self._completes_prompt(dslot, r, epoch):
            self._gen_ready[dslot] += 1
            self._maybe_register_prefix(dslot)
            return [SlotEvent(slot=dslot, logits=self._logits(dslot))]
        return []

    def _tick(self, feed: np.ndarray, valid: bool) -> None:
        with torch.no_grad():
            PL.pipeline_decode_tick(
                self.cfg, self.params, self.state,
                torch.from_numpy(feed.astype(np.int64)).to(self.device),
                self.spec, impl=self.impl, feed_valid=valid)

    def _logits(self, slot: int) -> np.ndarray:
        # a copy: on the CPU .cpu() would alias the ring's buffer
        return self.state.logits_out[slot].to("cpu", copy=True).numpy()

    def _completes_prompt(self, slot: int, r: int, epoch: int) -> bool:
        """Whether round ``r`` of ``slot``'s occupancy ``epoch`` fed the
        last prompt token (or a generated one): its logits are an event."""
        return slot in self._prompts and epoch == self._epoch.get(slot, 0) \
            and self._stream_done.get(slot, True) \
            and r >= len(self._prompts[slot]) - 1

    def _maybe_register_prefix(self, slot: int) -> None:
        full = self._full_tokens.pop(slot, None)
        if full is not None and self._prefix_on:
            # the whole prompt's KV is resident now: publish its full
            # blocks (generated tokens never land in them: the first
            # partial block stays private by the // floor)
            nfull = min(len(full) // self.block_size,
                        int(self.pager.n_alloc[slot]))
            if nfull:
                self.prefix.register(
                    full, self.pager.table[slot, :nfull].tolist())

    # --------------------------- speculative decode ------------------- #
    def verify_step(self, feeds: Dict[int, np.ndarray]) -> List[SlotEvent]:
        """Teacher-force each slot's ``[t_last, d_1..d_{n-1}]`` through the
        tick protocol and return per-slot logits ``[n, V]``.

        Draft tokens are fed one a turn, exactly like prompt tokens, so a
        verify of n tokens costs that slot n ring turns: no multi-token
        kernel win, but the scheduler's draft/verify protocol stays the
        same across backends.  Slots still in their prompt phase keep
        teacher-forcing on spare turns; a prompt that completes mid-verify
        emits a ``[1, V]`` event (its first sampled token's logits), which
        the caller accepts with count 1.

        The caller MUST follow with :meth:`accept` before the next quantum.
        """
        assert self._spec_ok, "spec decode needs the paged layout"
        assert not self._pending, "accept() the previous verify first"
        feeds = {int(s): np.asarray(t, np.int32).ravel()
                 for s, t in feeds.items()}
        for s, toks in feeds.items():
            assert s in self._prompts and len(toks) >= 1, s
            assert self._rounds[s] >= len(self._prompts[s]), \
                f"slot {s} still in prompt phase"
            assert self._base[s] + self._rounds[s] + len(toks) \
                <= self.max_len, "verify feed overruns max_len"
        # atomic block growth for every candidate position, before any
        # bookkeeping: a rejected tail's blocks stay allocated (reused by
        # later decode, or released with the slot)
        need = sum(self.pager.blocks_needed(
            s, self._base[s] + self._rounds[s] + len(t) - 1)
            for s, t in feeds.items())
        if need > self.pager.free_blocks:
            raise PoolExhausted(needed=need, free=self.pager.free_blocks)
        for s, toks in feeds.items():
            if self.pager.ensure(
                    s, self._base[s] + self._rounds[s] + len(toks) - 1):
                self._bt_dirty = True

        r0 = {s: self._rounds[s] for s in feeds}
        fed = {s: 0 for s in feeds}
        collect: Dict[int, List[np.ndarray]] = {s: [] for s in feeds}
        events: List[SlotEvent] = []
        guard = 0
        total = sum(len(t) for t in feeds.values())
        max_ticks = (total + self._m + self.spec.n_stages) * self._m + 8
        # empty feeds (every slot still prefilling) run exactly one tick,
        # decode_step's quantum
        while (any(len(collect[s]) < len(feeds[s]) for s in feeds)
               if feeds else guard == 0):
            guard += 1
            assert guard <= max_ticks, "verify tick loop failed to converge"
            tick = self.state.tick
            slot = tick % self._m
            feed: Optional[np.ndarray] = None
            if slot in feeds and fed[slot] < len(feeds[slot]):
                feed = feeds[slot][fed[slot]:fed[slot] + 1]
                self._vflight[tick] = (slot, fed[slot],
                                       self._epoch.get(slot, 0))
                fed[slot] += 1
                self._rounds[slot] += 1
            else:
                # prompt-phase slots keep teacher-forcing on spare turns; a
                # slot short of blocks stalls (no raise mid-verify: it
                # retries once the pool drains)
                p = self._feed_for(slot, {})      # prompt tokens only
                if p is not None:
                    pos = self._base[slot] + self._rounds[slot]
                    if self.pager.blocks_needed(slot, pos) \
                            <= self.pager.free_blocks:
                        if self.pager.ensure(slot, pos):
                            self._bt_dirty = True
                        feed = p
                        self._inflight[tick] = (slot, self._rounds[slot],
                                                self._epoch.get(slot, 0))
                        self._rounds[slot] += 1
            valid = feed is not None
            if self._bt_dirty:
                self._push_table()
            self._tick(feed if valid else np.zeros(1, np.int32), valid)
            done_tick = tick - (self.spec.n_stages - 1)
            vdone = self._vflight.pop(done_tick, None)
            if vdone is not None:
                dslot, idx, epoch = vdone
                # verify slots cannot be freed mid-verify (free_slot is a
                # scheduler call, never issued inside this loop)
                assert epoch == self._epoch.get(dslot, 0), dslot
                assert idx == len(collect[dslot]), (idx, dslot)
                collect[dslot].append(self._logits(dslot))
                continue
            pdone = self._inflight.pop(done_tick, None)
            if pdone is not None and self._completes_prompt(*pdone):
                dslot = pdone[0]
                self._gen_ready[dslot] += 1
                self._maybe_register_prefix(dslot)
                self._pending[dslot] = (self._rounds[dslot], 1, "first")
                events.append(SlotEvent(slot=dslot,
                                        logits=self._logits(dslot)[None]))
        for s in feeds:
            self._pending[s] = (r0[s], len(feeds[s]), "verify")
            events.append(SlotEvent(slot=s, logits=np.stack(collect[s])))
        return events

    def accept(self, counts: Dict[int, int]) -> None:
        """Commit per-slot accepted counts from the last ``verify_step``:
        roll rejected draft positions out of every layer's ring view and
        rewind the feed round, so the next quantum resumes at the accept
        point.  No activation of a verified slot is in flight here: the
        verify loop ran until every fed draft's logits came back."""
        counts = {int(s): int(e) for s, e in counts.items()}
        assert set(counts) == set(self._pending), \
            (sorted(counts), sorted(self._pending))
        for s, e in counts.items():
            r0, n, kind = self._pending[s]
            assert 1 <= e <= n, (s, e, n)
            if kind == "first":
                continue                     # prompt completion: nothing fed
            assert not any(v and mb == s for v, mb in zip(
                self.state.buf_valid, self.state.buf_mb)), \
                f"slot {s} has an activation in flight at accept"
            self._rounds[s] = r0 + e
            self._gen_ready[s] += e
            if e < n and s in self._prompts:
                PL.rollback_slot(self.state, s, self._base[s] + r0 + e)
        self._pending.clear()

    def free_slot(self, slot: int) -> None:
        self._pending.pop(slot, None)
        self._prompts.pop(slot, None)
        self._rounds.pop(slot, None)
        self._gen_ready.pop(slot, None)
        self._base.pop(slot, None)
        self._stream_done.pop(slot, None)
        self._full_tokens.pop(slot, None)
        self._epoch[slot] = self._epoch.get(slot, 0) + 1
        # a preempted slot may still be riding the ring: kill its validity
        # so its remaining stage passes cannot scribble on freed (possibly
        # reallocated) pool blocks or on the rows of the slot's next
        # occupant.  The reference kills on the paged layout only; here the
        # kill is a host-side flag, so both layouts take it.
        PL.kill_slot(self.state, slot)
        self._release(slot)
