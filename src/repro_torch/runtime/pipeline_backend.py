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
call).

Not yet ported from the reference: speculative verify (``verify_step``/
``accept``), the prefix cache and streamed admission
(``start_stream``/``prefill_chunk``), the vocab-sharded tick and stages on
more than one card.  ``BackendInfo`` reports ``spec_decode``,
``prefix_caching`` and ``supports_extend`` off, so the scheduler serves
plain decode with monolithic admission; ``prefix_cache=True`` raises.
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
from repro_torch.runtime.tensor import _leaves, _nbytes

_LATER = ("PipelineBackend: the pipeline's {} arrives in a later slice of "
          "the port (spec_decode and supports_extend are False)")


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
        if prefix_cache:
            raise ValueError(
                "prefix_cache=True: the pipeline's prefix cache and streamed "
                "admission arrive in a later slice of the port; serve with "
                "prefix_cache=False")
        m = n_slots or spec.n_stages
        if m < spec.n_stages:
            raise ValueError(f"need >= {spec.n_stages} micro-batch slots for "
                             f"no bubbles, got {m}")
        nbs = KV.max_ctx_blocks(cfg, max_len, block_size)
        if nbs == 0:
            raise ValueError(f"{cfg.name} has no attention layers")
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
        self.num_blocks = 0
        self.pager: Optional[SlotPager] = None
        if paged:
            self.num_blocks = num_blocks if num_blocks is not None \
                else m * nbs
            self.pager = SlotPager(m, self.num_blocks, block_size, nbs)
        self.state = PL.init_pipeline_decode_state(
            cfg, spec, m, max_len, self.cache_dtype, cache_layout,
            self.num_blocks, block_size, self.device)
        self._bt_dirty = False

        self._prompts: Dict[int, np.ndarray] = {}       # slot -> [plen]
        self._rounds: Dict[int, int] = {}               # feeds so far
        self._gen_ready: Dict[int, int] = {}            # generated tokens seen
        # feed tick -> (slot, round, occupancy epoch): the epoch guard drops
        # completions of a preempted occupancy that were still in the ring
        # when the slot was freed and re-admitted
        self._inflight: Dict[int, Tuple[int, int, int]] = {}
        self._epoch: Dict[int, int] = {}

        caches = self.state.caches
        cache_bytes = _nbytes({id(t): t for c in caches
                               for t in c.values()}.values())
        self._info = BackendInfo(
            n_slots=m, max_len=max_len,
            cache_bytes_per_slot=cache_bytes // m,
            param_bytes=_nbytes(_leaves(params)),
            samples_in_backend=False,
            attn_impl=effective_decode_impl(impl, self.device),
            spec_decode=False,
            cache_layout=cache_layout,
            block_size=block_size if paged else 0,
            total_blocks=self.num_blocks,
            free_blocks=self.num_blocks,
            bytes_per_block=KV.block_pool_bytes_per_block(
                cfg, self.cache_dtype) if paged else 0,
            max_ctx_blocks=nbs if paged else 0,
            prefix_caching=False,
            supports_extend=False)

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
            if self.pager is not None and self.pager.release(slot):
                self._bt_dirty = True           # blocks grow lazily per tick
            PL.reset_slot(self.state, slot)
            self._prompts[slot] = prompts[i, prompts.shape[1] - lens[i]:]
            self._rounds[slot] = 0
            self._gen_ready[slot] = 0
            self._epoch[slot] = self._epoch.get(slot, 0) + 1
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
        self.state.caches[0]["bt"].copy_(
            torch.from_numpy(self.pager.table).to(self.device))
        self._bt_dirty = False

    def decode_step(self, feeds: Dict[int, int]) -> List[SlotEvent]:
        slot = self.state.tick % self._m
        feed = self._feed_for(slot, feeds)
        valid = feed is not None
        if valid and self.pager is not None:
            # this tick writes position rounds[slot]; grow the slot's block
            # table first, raising BEFORE any bookkeeping so the scheduler
            # can preempt a victim and retry the very same tick
            pos = self._rounds[slot]
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
        with torch.no_grad():
            PL.pipeline_decode_tick(
                self.cfg, self.params, self.state,
                torch.from_numpy(feed.astype(np.int64)).to(self.device),
                self.spec, impl=self.impl, feed_valid=valid)
        done = self._inflight.pop(tick - (self.spec.n_stages - 1), None)
        if done is None:
            return []
        dslot, r, epoch = done
        if dslot in self._prompts and epoch == self._epoch.get(dslot, 0) \
                and r >= len(self._prompts[dslot]) - 1:
            # a copy: on the CPU .cpu() would alias the ring's buffer
            logits = self.state.logits_out[dslot].to(
                "cpu", copy=True).numpy()                      # [V]
            self._gen_ready[dslot] += 1
            return [SlotEvent(slot=dslot, logits=logits)]
        return []

    # ------------------------------------------------------------------ #
    # not yet ported: BackendInfo advertises neither capability, so the
    # scheduler never calls these; a direct call says what is missing
    # ------------------------------------------------------------------ #
    def verify_step(self, feeds: Dict[int, np.ndarray]) -> List[SlotEvent]:
        raise NotImplementedError(_LATER.format("speculative verify"))

    def accept(self, counts: Dict[int, int]) -> None:
        raise NotImplementedError(_LATER.format("speculative verify"))

    def start_stream(self, slot: int, prompt: np.ndarray) -> int:
        raise NotImplementedError(_LATER.format("streamed admission"))

    def prefill_chunk(self, slots: Sequence[int], chunks: np.ndarray,
                      chunk_lens: Sequence[int], starts: Sequence[int],
                      last: Sequence[bool]) -> List[SlotEvent]:
        raise NotImplementedError(_LATER.format("streamed admission"))

    def free_slot(self, slot: int) -> None:
        self._prompts.pop(slot, None)
        self._rounds.pop(slot, None)
        self._gen_ready.pop(slot, None)
        self._epoch[slot] = self._epoch.get(slot, 0) + 1
        # a preempted slot may still be riding the ring: kill its validity
        # so its remaining stage passes cannot scribble on freed (possibly
        # reallocated) pool blocks or on the rows of the slot's next
        # occupant.  The reference kills on the paged layout only; here the
        # kill is a host-side flag, so both layouts take it.
        PL.kill_slot(self.state, slot)
        if self.pager is not None and self.pager.release(slot):
            self._bt_dirty = True
