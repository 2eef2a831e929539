"""TorchTensorBackend: the single-device torch execution path behind the
:class:`~repro_torch.runtime.base.InferenceBackend` protocol.

Port of ``repro.runtime.tensor.TensorBackend`` for the **paged** KV layout:
slots map vLLM-style block tables into a shared pool of ``num_blocks`` KV
blocks (``block_size`` tokens each, one pool per attention layer; see
``models/kvcache.py``).  Decode runs the whole slot batch in one pass with
per-slot positions, scattering the new token's k/v into the pool and
attending through each slot's table: ``impl="cuda"`` reads the blocks with
the paged attention kernel, ``impl="ref"`` gathers them into a dense
``[B, C_pad, ...]`` temporary and runs the masked sdpa.  Host-side
allocation (:class:`~repro_torch.runtime.base.SlotPager`) grows tables as
slots cross block boundaries and raises
:class:`~repro_torch.runtime.base.PoolExhausted` *before* mutating anything
when the pool cannot cover the next quantum -- the scheduler's cue to
preempt and requeue.

Prefill is *masked* (pads never become cache keys) and runs the admission
wave through dense ring caches sized by the bucketed prompt length, then
scatters them into the pool by absolute position -- the reference's path,
not a direct paged prefill.

Not in this slice: the contiguous layout, the prefix cache, ``extend``
(streamed admission) and ``verify_step``/``accept`` (speculative decoding);
:class:`BackendInfo` reports all of them off.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import Device, resolve_device, torch_dtype
from repro_torch.models import kvcache as KV
from repro_torch.models import transformer as T
from repro_torch.models.attention import effective_decode_impl
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.base import (BackendInfo, InferenceBackend,
                                      PoolExhausted, SlotEvent, SlotPager)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class TorchTensorBackend(InferenceBackend):
    """Masked wave prefill + batched paged decode on one device."""

    def __init__(self, cfg: ModelConfig, params: Dict, n_slots: int,
                 max_len: int, impl: str = "ref",
                 cache_dtype: Optional[torch.dtype] = None,
                 cache_layout: str = "paged",
                 block_size: int = KV.DEFAULT_BLOCK_SIZE,
                 num_blocks: Optional[int] = None, device: Device = None):
        if cache_layout != "paged":
            raise ValueError(
                f"cache_layout={cache_layout!r}: the contiguous layout "
                f"arrives with the contiguous-decode kernel slice; this slice "
                f"serves cache_layout='paged'")
        nbs = KV.max_ctx_blocks(cfg, max_len, block_size)
        if nbs == 0:
            raise ValueError(f"{cfg.name} has no attention layers to page")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.impl = impl
        #: KV storage dtype; defaults to the model dtype (torch matmuls do
        #: not promote, and a float32 pool doubles a bf16 model's cache)
        self.cache_dtype = cache_dtype if cache_dtype is not None \
            else torch_dtype(cfg.dtype)
        self.cache_layout = cache_layout
        self.block_size = block_size
        self.num_blocks = num_blocks if num_blocks is not None \
            else n_slots * nbs
        self.pager = SlotPager(n_slots, self.num_blocks, block_size, nbs)
        self.caches = T.init_paged_caches(cfg, n_slots, max_len,
                                          self.num_blocks, block_size,
                                          self.cache_dtype, self.device)
        # host mirrors for paged allocation (decode position per slot)
        self._pos = np.zeros(n_slots, np.int64)
        self._active = np.zeros(n_slots, bool)

        cache_bytes = _nbytes(t for c in self.caches for t in c.values())
        param_bytes = _nbytes(_leaves(params))
        self._info = BackendInfo(
            n_slots=n_slots, max_len=max_len,
            cache_bytes_per_slot=cache_bytes // n_slots,
            param_bytes=param_bytes,
            samples_in_backend=False,
            cache_layout=cache_layout,
            block_size=block_size,
            total_blocks=self.num_blocks,
            free_blocks=self.num_blocks,
            bytes_per_block=KV.block_pool_bytes_per_block(cfg,
                                                          self.cache_dtype),
            max_ctx_blocks=nbs,
            prefix_caching=False,
            supports_extend=False,
            attn_impl=effective_decode_impl(impl, self.device),
            spec_decode=False)

    @property
    def info(self) -> BackendInfo:
        return self._live_info()

    # ------------------------------------------------------------------ #
    # paged scatter: dense ring prefill caches -> block pool
    # ------------------------------------------------------------------ #
    def _scatter_one_paged(self, paged: Dict, dense: Dict,
                           slots: torch.Tensor, bt_rows: torch.Tensor) -> None:
        """Scatter one layer's wave prefill (ring layout, any cache length)
        into its pool by absolute position, in place.

        The dense wave cache is per-row (``key_pos [W, C_d]``, ``pos [W]``):
        after a masked prefill each row holds its own true length, with pad
        slots at ``key_pos == -1`` -- those scatter to the scratch block and
        stay invisible.  Duplicate rows (the wave padded by repeating its
        first entry) write identical values to identical indices."""
        c_pad = paged["key_pos"].shape[-1]
        bs = paged["k_pool"].shape[1]
        scratch = paged["k_pool"].shape[0] - 1
        kp0 = dense["key_pos"]                          # [W, C_d]
        valid = kp0 >= 0
        ring = torch.where(valid, kp0 % c_pad, 0)
        blk, off = ring // bs, ring % bs                # [W, C_d]
        phys = bt_rows.gather(1, blk.long())            # [W, C_d]
        tgt = torch.where(valid & (phys >= 0), phys, scratch)
        for pool_key, dense_key in (("k_pool", "k"), ("v_pool", "v")):
            pool = paged[pool_key]                      # [NB+1, bs, ...]
            pool[tgt, off] = dense[dense_key].to(pool.dtype)

        # per-slot ring view: key_pos rows rebuilt at the paged ring length
        # (index c_pad is the sacrificial column for invalid entries)
        w = kp0.shape[0]
        rows = torch.arange(w, device=kp0.device)[:, None]
        safe = torch.where(valid, ring, c_pad)
        row = torch.full((w, c_pad + 1), -1, dtype=torch.int32,
                         device=kp0.device)
        row[rows, safe] = torch.where(valid, kp0, -1)
        paged["key_pos"][slots] = row[:, :c_pad]
        paged["pos"][slots] = dense["pos"]
        paged["bt"][slots] = bt_rows

    def _push_tables(self) -> None:
        """Refresh the device block-table tensors from the host pager."""
        table = torch.from_numpy(self.pager.table).to(self.device)
        for cache in self.caches:
            cache["bt"].copy_(table)

    def _grow_atomic(self, targets: Sequence[Tuple[int, int]]) -> bool:
        """Grow several slots' tables as ONE transaction: ensure every
        ``(slot, pos)`` or roll the partial growth back and re-raise
        :class:`PoolExhausted`.  The aggregate precheck in decode_step makes
        mid-loop exhaustion unreachable today, but the rollback keeps
        ensure-then-mutate atomic even if the precheck and the pager's
        accounting ever diverge.  Returns True when any table changed
        (caller refreshes the device tables)."""
        grown: List[Tuple[int, int]] = []   # (slot, n_alloc before growth)
        changed = False
        try:
            for s, pos in targets:
                lo = int(self.pager.n_alloc[s])
                if self.pager.ensure(s, pos):
                    grown.append((s, lo))
                    changed = True
        except PoolExhausted:
            for s, lo in grown:
                hi = int(self.pager.n_alloc[s])
                self.pager.allocator.free(self.pager.table[s, lo:hi].tolist())
                self.pager.table[s, lo:hi] = -1
                self.pager.n_alloc[s] = lo
            raise
        return changed

    # ------------------------------------------------------------------ #
    def prefill(self, slots: Sequence[int], prompts: np.ndarray,
                prompt_lens: Optional[Sequence[int]] = None,
                ) -> List[SlotEvent]:
        prompts = np.atleast_2d(np.asarray(prompts, np.int32))
        k = prompts.shape[0]
        assert len(slots) == k
        lens = np.full(k, prompts.shape[1], np.int32) if prompt_lens is None \
            else np.asarray(prompt_lens, np.int32)
        assert lens.shape == (k,) and np.all(lens >= 1) \
            and np.all(lens <= prompts.shape[1]), (lens, prompts.shape)
        # atomic: on exhaustion nothing mutates and the scheduler can retry
        # the wave after preempting.  Blocks cover each slot's TRUE length.
        self.pager.realloc_wave(slots, lens)
        # pad the wave to the full slot width by repeating the first entry
        # (duplicate scatter indices write identical values), so prefill
        # runs one batch shape per bucket whatever the wave size
        pad = self.n_slots - k
        prompts_p = np.concatenate(
            [prompts, np.repeat(prompts[:1], pad, axis=0)]) if pad else prompts
        lens_p = np.concatenate([lens, np.repeat(lens[:1], pad)]) \
            if pad else lens
        slots_p = np.asarray(list(slots) + [slots[0]] * pad)
        dev = self.device
        # dense workspace sized by the bucketed prompt length (not max_len):
        # transient prefill memory stays proportional to the wave, the pool
        # holds the persistent state
        fresh = T.init_caches(self.cfg, self.n_slots, prompts.shape[1],
                              self.cache_dtype, dev)
        with torch.no_grad():
            logits, dense = T.forward(
                self.cfg, self.params,
                torch.from_numpy(prompts_p).to(dev, torch.long), fresh,
                prompt_lens=torch.from_numpy(lens_p).to(dev), impl=self.impl)
            idx = torch.from_numpy(slots_p).to(dev)
            bt_rows = torch.from_numpy(self.pager.table[slots_p]).to(dev)
            for paged, d in zip(self.caches, dense):
                self._scatter_one_paged(paged, d, idx, bt_rows)
            last = logits[:, -1].float().cpu().numpy()
        for s, n in zip(slots, lens):
            self._pos[s] = int(n)
            self._active[s] = True
        return [SlotEvent(slot=s, logits=last[i]) for i, s in enumerate(slots)]

    def decode_step(self, feeds: Dict[int, int]) -> List[SlotEvent]:
        if not feeds:
            return []
        tokens = np.zeros(self.n_slots, np.int64)
        for s, t in feeds.items():
            tokens[s] = t
        live = [s for s in sorted(feeds) if self._active[s]]
        need = sum(self.pager.blocks_needed(s, int(self._pos[s]))
                   for s in live)
        if need > self.pager.free_blocks:     # raise BEFORE any mutation
            raise PoolExhausted(needed=need, free=self.pager.free_blocks)
        if self._grow_atomic([(s, int(self._pos[s])) for s in live]):
            self._push_tables()
        mask = np.zeros(self.n_slots, bool)
        mask[live] = True
        with torch.no_grad():
            logits, self.caches = T.decode_step(
                self.cfg, self.params, torch.from_numpy(tokens).to(self.device),
                self.caches, impl=self.impl,
                write_mask=torch.from_numpy(mask).to(self.device))
            # the protocol hands numpy logits to the host sampler: one
            # readback per step, as in the reference
            logits = logits.float().cpu().numpy()
        for s in live:
            self._pos[s] += 1
        return [SlotEvent(slot=s, logits=logits[s]) for s in sorted(feeds)]

    def free_slot(self, slot: int) -> None:
        # the pool returns the slot's blocks to the free list immediately
        self._active[slot] = False
        self.pager.release(slot)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]
