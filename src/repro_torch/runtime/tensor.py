"""TensorBackend: the single-device torch execution path behind the
:class:`~repro_torch.runtime.base.InferenceBackend` protocol.

Port of ``repro.runtime.tensor.TensorBackend`` (``TorchTensorBackend`` is
kept as an alias of the same class).  Two cache layouts,
selected by ``cache_layout``:

- ``"contiguous"`` (default, as in the reference) -- one worst-case
  ``max_len`` ring per slot and layer, ``[n_slots, C, KH, D]``.  Decode
  runs every slot in one batched pass (the reference vmaps the
  single-sequence step over the slot axis; here the slot axis is the batch
  dimension): idle slots decode a 0 token into their own rows, which the
  next prefill of the slot overwrites whole.  ``impl="cuda"`` reads the
  rings with the decode attention kernel, ``impl="ref"`` runs the masked
  sdpa over them.
- ``"paged"`` -- slots map vLLM-style block tables into a shared pool of
  ``num_blocks`` KV blocks (``block_size`` tokens each, one pool per
  attention layer; see ``models/kvcache.py``).  Decode runs the whole slot
  batch in one pass with per-slot positions, scattering the new token's k/v
  into the pool and attending through each slot's table: ``impl="cuda"``
  reads the blocks with the paged attention kernel, ``impl="ref"`` gathers
  them into a dense ``[B, C_pad, ...]`` temporary and runs the masked sdpa.
  Host-side allocation (:class:`~repro_torch.runtime.base.SlotPager`) grows
  tables as slots cross block boundaries and raises
  :class:`~repro_torch.runtime.base.PoolExhausted` *before* mutating
  anything when the pool cannot cover the next quantum -- the scheduler's
  cue to preempt and requeue.  Where ring slot == position (no effective
  window), the paged layout also verifies speculative drafts
  (``verify_step``/``accept``): K tokens per slot in one pass through the
  same kernel, rejected drafts rolled back.

Both layouts run *masked* prefill through dense ring caches -- at
``max_len`` for the contiguous layout, at the bucketed prompt length for
the paged one -- then scatter the wave's rows into the slots' storage: the
reference's path, not a direct paged prefill.

Hybrid models (recurrentgemma: RG-LRU and local-attention layers) serve on
both layouts: each RG-LRU layer keeps its dense state (``h`` float32, the
conv window, ``pos``) per slot -- beside the rings, or beside the
attention layers' block pools -- and a prefill wave writes it into the
wave's slot rows whole, so a freed, preempted or resumed slot carries no
stale recurrent state into its next occupant.  Speculative verify and
streamed admission need all-attention layers, as in the reference.  A model
with no attention layer at all (xlstm-1.3b: mLSTM and sLSTM blocks) has
nothing to page: on the paged layout it keeps the contiguous machinery and
reports an empty pool, as the reference does.

Streamed admission (``start_stream`` + ``prefill_chunk``): where ring slot
== position -- the paged layout with no effective window
(``kvcache.prefix_sharing_supported``) -- a prompt can be prefilled in
chunks through ``transformer.extend_step``, and with ``prefix_cache=True``
admission first adopts the blocks a content-addressed index
(:class:`~repro_torch.runtime.prefix_cache.PrefixCache`) already holds for
the prompt's head, copy-on-write, and prefills only the rest.  Any other
deployment silently keeps monolithic prefill (``BackendInfo`` reports
``supports_extend``/``prefix_caching`` off), as in the reference.

On a mesh (``mesh=``, a ``(1, N)`` :class:`~repro_torch.launch.mesh.Mesh`
over ``("data", "model")``, as the reference's launcher builds) the
backend is tensor-parallel over ``model``: :class:`MeshTensorBackend` is
the host side of one process a point
(:class:`~repro_torch.core.mesh_procs.MeshProcs`), each running a
``TensorBackend`` over its shard of the weights
(:func:`~repro_torch.sharding.rules.tensor_parallel`: its query and K/V
heads, and so its share of every ring or pool, its ``ff`` columns, its
vocabulary rows, an RG-LRU layer's channels and an mLSTM layer's heads
with their share of the recurrent state; an sLSTM layer's recurrence and
state whole) under ``use_mesh``, the Megatron sums and the head's gather
between them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.stage_procs import DEFAULT_TIMEOUT
from repro_torch.device import Device, resolve_device, torch_dtype
from repro_torch.launch.mesh import Mesh
from repro_torch.models import kvcache as KV
from repro_torch.models import transformer as T
from repro_torch.models.attention import effective_decode_impl
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.base import (BackendInfo, InferenceBackend,
                                      PoolExhausted, SlotEvent, SlotPager)
from repro_torch.runtime.prefix_cache import PrefixCache
from repro_torch.sharding.rules import use_mesh


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class TensorBackend(InferenceBackend):
    """Masked wave prefill + batched (contiguous | paged) decode, and
    speculative verify and streamed admission on the paged layout, on one
    device; with ``mesh``, a :class:`MeshTensorBackend`."""

    def __new__(cls, cfg: ModelConfig = None, params: Dict = None,
                n_slots: int = 0, max_len: int = 0,
                mesh: Optional[Mesh] = None, *args, **kw):
        # not a TensorBackend, so its __init__ is not run a second time
        if mesh is not None:
            return MeshTensorBackend(cfg, params, n_slots, max_len, mesh,
                                     *args, **kw)
        return super().__new__(cls)

    def __init__(self, cfg: ModelConfig, params: Dict, n_slots: int,
                 max_len: int, mesh: Optional[Mesh] = None,
                 impl: str = "ref",
                 cache_dtype: Optional[torch.dtype] = None,
                 cache_layout: str = "contiguous",
                 block_size: int = KV.DEFAULT_BLOCK_SIZE,
                 num_blocks: Optional[int] = None, device: Device = None,
                 prefix_cache: bool = False):
        if cache_layout not in ("contiguous", "paged"):
            raise ValueError(f"cache_layout={cache_layout!r}: expected "
                             f"'contiguous' or 'paged'")
        nbs = KV.max_ctx_blocks(cfg, max_len, block_size)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.impl = impl
        #: KV storage dtype; defaults to the model dtype (torch matmuls do
        #: not promote, and a float32 cache doubles a bf16 model's)
        self.cache_dtype = cache_dtype if cache_dtype is not None \
            else torch_dtype(cfg.dtype)
        self.cache_layout = cache_layout
        self.block_size = block_size
        paged = cache_layout == "paged"
        # an attention-free model has nothing to page: it keeps the
        # contiguous machinery and reports an (empty) paged pool
        self._paged_exec = paged and nbs > 0
        self.num_blocks = 0
        self.pager: Optional[SlotPager] = None
        if paged:
            self.num_blocks = num_blocks if num_blocks is not None \
                else n_slots * nbs
            self.pager = SlotPager(n_slots, self.num_blocks, block_size, nbs)
        if self._paged_exec:
            self.caches = T.init_paged_caches(cfg, n_slots, max_len,
                                              self.num_blocks, block_size,
                                              self.cache_dtype, self.device)
            #: the attention layers' paged entries (a hybrid's recurrent
            #: layers keep dense per-slot state beside them)
            self._pools = [c for c in self.caches if "k_pool" in c]
        else:
            self.caches = T.init_caches(cfg, n_slots, max_len,
                                        self.cache_dtype, self.device)
            self._pools = []
        # streamed admission (prefix reuse + chunked prefill) and speculative
        # verify need ring slot == absolute position (a rejected draft rolls
        # back exactly, a shared block is never rewritten): the paged layout
        # with no effective window.  Other deployments silently keep
        # monolithic prefill (the --prefix-cache "contiguous ignore" rule).
        self._extend_ok = self._paged_exec and \
            KV.prefix_sharing_supported(cfg, max_len)
        self._spec_ok = self._extend_ok
        self._prefix_on = bool(prefix_cache) and self._extend_ok
        self.prefix: Optional[PrefixCache] = None
        if self._prefix_on:
            self.prefix = PrefixCache(self.pager.allocator, block_size)
        self._prefix_hits = 0
        self._prefix_hit_tokens = 0
        self._stream_tokens: Dict[int, np.ndarray] = {}
        self._pending: Dict[int, int] = {}     # slot -> fed len, last verify
        # host mirrors: decode position and occupancy per slot
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
            block_size=block_size if paged else 0,
            total_blocks=self.num_blocks,
            free_blocks=self.num_blocks,
            bytes_per_block=KV.block_pool_bytes_per_block(
                cfg, self.cache_dtype) if paged else 0,
            max_ctx_blocks=nbs if paged else 0,
            prefix_caching=self._prefix_on,
            supports_extend=self._extend_ok,
            attn_impl=effective_decode_impl(
                impl, cfg, self.device,
                "paged" if self._paged_exec else "contiguous"),
            spec_decode=self._spec_ok)

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
        first entry) write identical values to identical indices.  An int8
        wave carries its scales into the scale pools."""
        c_pad = paged["key_pos"].shape[-1]
        bs = paged["k_pool"].shape[1]
        scratch = paged["k_pool"].shape[0] - 1
        kp0 = dense["key_pos"]                          # [W, C_d]
        valid = kp0 >= 0
        ring = torch.where(valid, kp0 % c_pad, 0)
        blk, off = ring // bs, ring % bs                # [W, C_d]
        phys = bt_rows.gather(1, blk.long())            # [W, C_d]
        tgt = torch.where(valid & (phys >= 0), phys, scratch)
        pairs = [("k_pool", "k"), ("v_pool", "v")]
        if self.cfg.kv_dtype == "int8":
            pairs += [("k_scale_pool", "k_scale"), ("v_scale_pool", "v_scale")]
        for pool_key, dense_key in pairs:
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
        for cache in self._pools:
            cache["bt"].copy_(table)

    def _grow_atomic(self, targets: Sequence[Tuple[int, int]]) -> bool:
        """Grow several slots' tables as ONE transaction: ensure every
        ``(slot, pos)`` or roll the partial growth back and re-raise
        :class:`PoolExhausted`.  The aggregate prechecks in decode_step and
        verify_step make mid-loop exhaustion unreachable today, but the
        rollback keeps ensure-then-mutate atomic even if the precheck and
        the pager's accounting ever diverge.  Returns True when any table changed
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

    def _rollback(self, new_pos: torch.Tensor, mask: torch.Tensor) -> None:
        """Verify rollback, in place: for every masked slot, mark positions
        below ``new_pos[s]`` valid and everything above empty, and rewind
        ``pos``.  Exact because ring slot == position on the spec path, so
        a rejected draft's key is invalidated without touching any
        surviving key."""
        for cache in self._pools:
            iota = torch.arange(cache["key_pos"].shape[-1], dtype=torch.int32,
                                device=self.device)[None]
            row = torch.where(iota < new_pos[:, None], iota, -1)  # [B, C]
            cache["key_pos"].copy_(torch.where(mask[:, None], row,
                                               cache["key_pos"]))
            cache["pos"].copy_(torch.where(mask, new_pos, cache["pos"]))

    # ------------------------------------------------------------------ #
    # speculative verify: K fed tokens per slot, one forward pass
    # ------------------------------------------------------------------ #
    def verify_step(self, feeds: Dict[int, np.ndarray]) -> List[SlotEvent]:
        if not feeds:
            return []
        assert self._spec_ok, "backend does not advertise spec_decode"
        assert not self._pending, "verify_step before accept() of the last"
        fed = {s: np.asarray(f, np.int64).ravel() for s, f in feeds.items()}
        kq = max(len(f) for f in fed.values())
        assert kq >= 1 and all(len(f) >= 1 for f in fed.values())
        tokens = np.zeros((self.n_slots, kq), np.int64)
        lens = np.zeros(self.n_slots, np.int32)
        live = [s for s in sorted(fed) if self._active[s]]
        for s in live:
            assert int(self._pos[s]) + len(fed[s]) <= self.max_len, \
                (s, int(self._pos[s]), len(fed[s]), self.max_len)
            tokens[s, :len(fed[s])] = fed[s]
            lens[s] = len(fed[s])
        # atomic growth: blocks for ALL candidate positions up front (a
        # rejected tail keeps its blocks -- they back the next tokens), and
        # PoolExhausted before any state changes
        need = sum(
            max(self.pager.blocks_for_len(int(self._pos[s] + lens[s]))
                - int(self.pager.n_alloc[s]), 0) for s in live)
        if need > self.pager.free_blocks:
            raise PoolExhausted(needed=need, free=self.pager.free_blocks)
        if self._grow_atomic(
                [(s, int(self._pos[s] + lens[s]) - 1) for s in live]):
            self._push_tables()
        dev = self.device
        with torch.no_grad():
            logits, self.caches = T.verify_step(
                self.cfg, self.params, torch.from_numpy(tokens).to(dev),
                self.caches, torch.from_numpy(lens).to(dev), impl=self.impl)
            logits = logits.float().cpu().numpy()
        # host _pos stays at the pre-verify position until accept() commits
        self._pending = {s: int(lens[s]) for s in live}
        return [SlotEvent(slot=s, logits=logits[s, :int(lens[s])])
                for s in live]

    def accept(self, counts: Dict[int, int]) -> None:
        pend, self._pending = self._pending, {}
        assert set(counts) == set(pend), (sorted(counts), sorted(pend))
        new_pos = self._pos.copy()
        mask = np.zeros(self.n_slots, bool)
        partial = False
        for s, e in counts.items():
            e = int(e)
            assert 0 <= e <= pend[s], (s, e, pend[s])
            mask[s] = True
            new_pos[s] = self._pos[s] + e
            partial |= e < pend[s]
        if partial:
            # rewind rejected draft keys; full acceptance leaves the device
            # state exactly right already (pos advanced by lens in verify)
            self._rollback(torch.from_numpy(new_pos.astype(np.int32))
                           .to(self.device),
                           torch.from_numpy(mask).to(self.device))
        for s in counts:
            self._pos[s] = int(new_pos[s])

    # ------------------------------------------------------------------ #
    # streamed admission: prefix adoption + chunked/offset prefill
    # ------------------------------------------------------------------ #
    def cached_prefix_len(self, prompt: np.ndarray) -> int:
        if not self._prefix_on:
            return 0
        p = np.asarray(prompt).ravel()
        cap = ((len(p) - 1) // self.block_size) * self.block_size
        return self.prefix.matched_tokens(p[:cap])

    def start_stream(self, slot: int, prompt: np.ndarray) -> int:
        assert self._extend_ok, "backend does not advertise supports_extend"
        prompt = np.asarray(prompt, np.int32).ravel()
        plen = len(prompt)
        assert plen >= 1
        self.pager.release(slot)
        start = 0
        if self._prefix_on:
            # cap so at least one suffix token remains to produce logits
            cap = ((plen - 1) // self.block_size) * self.block_size
            blocks = self.prefix.lookup(prompt[:cap])
            start = len(blocks) * self.block_size
            if start:
                self.pager.adopt(slot, blocks)
                self._prefix_hits += 1
                self._prefix_hit_tokens += start
        self._reset_stream(slot, start)
        self._stream_tokens[slot] = prompt
        self._pos[slot] = start
        self._active[slot] = True
        return start

    def _reset_stream(self, slot: int, start: int) -> None:
        """Wipe one slot's paged ring view for a streamed admission, in
        place: positions below ``start`` (the adopted prefix, whose blocks
        the host just wired into the table) become valid keys, everything
        above empty -- stale keys of the slot's previous occupant must never
        be attended."""
        for cache in self._pools:
            iota = torch.arange(cache["key_pos"].shape[-1], dtype=torch.int32,
                                device=self.device)
            cache["key_pos"][slot] = torch.where(iota < start, iota, -1)
            cache["pos"][slot] = start

    def prefill_chunk(self, slots: Sequence[int], chunks: np.ndarray,
                      chunk_lens: Sequence[int], starts: Sequence[int],
                      last: Sequence[bool]) -> List[SlotEvent]:
        chunks = np.atleast_2d(np.asarray(chunks, np.int64))
        k, w = chunks.shape
        lens = np.asarray(chunk_lens, np.int32)
        sts = np.asarray(starts, np.int64)
        assert len(slots) == k and lens.shape == (k,) and sts.shape == (k,)
        assert np.all(lens >= 1) and np.all(lens <= w)
        # atomic growth check: raise before any table mutates so the
        # scheduler can preempt and retry the whole chunk wave
        need = sum(
            max(self.pager.blocks_for_len(int(st + ln))
                - int(self.pager.n_alloc[s]), 0)
            for s, st, ln in zip(slots, sts, lens))
        if need > self.pager.free_blocks:
            raise PoolExhausted(needed=need, free=self.pager.free_blocks)
        self._grow_atomic([(s, int(st + ln) - 1)
                           for s, st, ln in zip(slots, sts, lens)])
        self._push_tables()
        # extend_step works in slot space [n_slots, w]: the wave's rows go to
        # their slots and every other row is a no-op (len 0: writes to the
        # scratch block; start = pos: pos unchanged)
        full_chunks = np.zeros((self.n_slots, w), np.int64)
        full_lens = np.zeros(self.n_slots, np.int32)
        full_starts = self._pos.astype(np.int32)
        for i, s in enumerate(slots):
            full_chunks[s] = chunks[i]
            full_lens[s] = lens[i]
            full_starts[s] = sts[i]
        dev = self.device
        with torch.no_grad():
            logits, self.caches = T.extend_step(
                self.cfg, self.params, torch.from_numpy(full_chunks).to(dev),
                self.caches, torch.from_numpy(full_starts).to(dev),
                torch.from_numpy(full_lens).to(dev), impl=self.impl)
            last_logits = logits[:, -1].float().cpu().numpy()
        events = []
        for i, s in enumerate(slots):
            self._pos[s] = int(sts[i] + lens[i])
            if last[i]:
                if self._prefix_on:
                    self._register_stream(s)
                self._stream_tokens.pop(s, None)
                events.append(SlotEvent(slot=s, logits=last_logits[s]))
        return events

    def _register_stream(self, slot: int) -> None:
        """Index the finished stream's full token blocks for future reuse."""
        toks = self._stream_tokens.get(slot)
        if toks is None:
            return
        nfull = min(len(toks) // self.block_size,
                    int(self.pager.n_alloc[slot]))
        if nfull:
            self.prefix.register(toks, self.pager.table[slot, :nfull].tolist())

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
        paged = self._paged_exec
        if paged:
            # atomic: on exhaustion nothing mutates and the scheduler can
            # retry the wave after preempting.  Blocks cover each slot's
            # TRUE length.
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
        # paged: a dense workspace sized by the bucketed prompt length (the
        # pool holds the persistent state); contiguous: fresh max_len rings
        # whose rows replace the slots' rows whole
        fresh = T.init_caches(self.cfg, self.n_slots,
                              prompts.shape[1] if paged else self.max_len,
                              self.cache_dtype, dev)
        with torch.no_grad():
            logits, dense = T.forward(
                self.cfg, self.params,
                torch.from_numpy(prompts_p).to(dev, torch.long), fresh,
                prompt_lens=torch.from_numpy(lens_p).to(dev), impl=self.impl)
            idx = torch.from_numpy(slots_p).to(dev)
            bt_rows = torch.from_numpy(self.pager.table[slots_p]).to(dev) \
                if paged else None
            for store, d in zip(self.caches, dense):
                if "k_pool" in store:
                    self._scatter_one_paged(store, d, idx, bt_rows)
                else:
                    # dense per-slot state (contiguous rings, a hybrid's
                    # recurrent state in either layout): every leaf, pos
                    # included, lands at the wave's slot rows whole
                    for key, t in store.items():
                        t[idx[:k]] = d[key][:k].to(t.dtype)
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
        mask = None
        if self._paged_exec:
            need = sum(self.pager.blocks_needed(s, int(self._pos[s]))
                       for s in live)
            if need > self.pager.free_blocks:  # raise BEFORE any mutation
                raise PoolExhausted(needed=need, free=self.pager.free_blocks)
            if self._grow_atomic([(s, int(self._pos[s])) for s in live]):
                self._push_tables()
            mask = np.zeros(self.n_slots, bool)
            mask[live] = True
            mask = torch.from_numpy(mask).to(self.device)
        with torch.no_grad():
            logits, self.caches = T.decode_step(
                self.cfg, self.params, torch.from_numpy(tokens).to(self.device),
                self.caches, impl=self.impl, write_mask=mask)
            # the protocol hands numpy logits to the host sampler: one
            # readback per step, as in the reference
            logits = logits.float().cpu().numpy()
        for s in live:
            self._pos[s] += 1
        return [SlotEvent(slot=s, logits=logits[s]) for s in sorted(feeds)]

    def free_slot(self, slot: int) -> None:
        # contiguous rows are overwritten whole by the slot's next prefill;
        # the pool returns the slot's blocks to the free list immediately
        # (prefix-indexed blocks park in the cached-free LRU instead)
        self._active[slot] = False
        self._stream_tokens.pop(slot, None)
        if self.pager is not None:
            self.pager.release(slot)


class MeshTensorBackend(InferenceBackend):
    """``TensorBackend(..., mesh=...)``: tensor-parallel over the mesh's
    ``model`` axis, one process a point, every process on ``device`` (the
    card unless ``"cpu"``).  Each method call goes to every process, whose
    ``TensorBackend`` over its shard runs it under ``use_mesh``; their
    pagers and prefix caches decide alike, since they see the same calls,
    and every answer carries the process's slot positions and block
    tables, which must agree (else :class:`RuntimeError`).  Process 0's
    events come back, their logits whole after the head's gather; a
    :class:`PoolExhausted` in the processes is raised here.  ``info`` is
    process 0's, with the cache bytes a slot and a block summed over the
    processes and the parameter bytes held once.  Call :meth:`close` when
    done: it stops every process."""

    def __init__(self, cfg: ModelConfig, params: Dict, n_slots: int,
                 max_len: int, mesh: Optional[Mesh] = None,
                 impl: str = "ref",
                 cache_dtype: Optional[torch.dtype] = None,
                 cache_layout: str = "contiguous",
                 block_size: int = KV.DEFAULT_BLOCK_SIZE,
                 num_blocks: Optional[int] = None, device: Device = None,
                 prefix_cache: bool = False,
                 timeout: float = DEFAULT_TIMEOUT):
        from repro_torch.core.mesh_procs import MeshProcs
        if tuple(mesh.axis_names) != ("data", "model") \
                or mesh.shape["data"] != 1:
            raise ValueError(f"a tensor-parallel TensorBackend serves on a "
                             f"(1, N) mesh over ('data', 'model'), as the "
                             f"reference's launcher builds: not {mesh}")
        self.cfg, self.params, self.max_len = cfg, params, max_len
        self.mesh, self.impl = mesh, impl
        self.device = resolve_device(device)
        self.procs = MeshProcs(cfg, params, mesh, impl=impl,
                               device=self.device, timeout=timeout)
        infos = self.procs.run(_open_backend, dict(
            n_slots=n_slots, max_len=max_len, impl=impl,
            cache_dtype=cache_dtype, cache_layout=cache_layout,
            block_size=block_size, num_blocks=num_blocks,
            prefix_cache=prefix_cache))
        #: the byte counts summed over the processes
        self._sums = dict(
            cache_bytes_per_slot=sum(i.cache_bytes_per_slot for i in infos),
            bytes_per_block=sum(i.bytes_per_block for i in infos),
            param_bytes=_nbytes(_leaves(params)))
        self._info = infos[0]

    @property
    def info(self) -> BackendInfo:
        return dataclasses.replace(self._info, **self._sums)

    def _each(self, method: str, *args):
        """``method(*args)`` on every process's backend; process 0's
        result."""
        answers = self.procs.run(_call_backend, method, args)
        if len({a[1] for a in answers}) > 1:
            raise RuntimeError(f"{method}: the {self.mesh.size} processes' "
                               f"slots and block tables differ")
        out, _, self._info = answers[0]
        if isinstance(out, PoolExhausted):
            raise out
        return out

    def prefill(self, slots, prompts, prompt_lens=None) -> List[SlotEvent]:
        return self._each("prefill", slots, prompts, prompt_lens)

    def decode_step(self, feeds: Dict[int, int]) -> List[SlotEvent]:
        return self._each("decode_step", feeds) if feeds else []

    def verify_step(self, feeds: Dict[int, np.ndarray]) -> List[SlotEvent]:
        return self._each("verify_step", feeds) if feeds else []

    def accept(self, counts: Dict[int, int]) -> None:
        return self._each("accept", counts)

    def cached_prefix_len(self, prompt: np.ndarray) -> int:
        return self._each("cached_prefix_len", prompt)

    def start_stream(self, slot: int, prompt: np.ndarray) -> int:
        return self._each("start_stream", slot, prompt)

    def prefill_chunk(self, slots, chunks, chunk_lens, starts,
                      last) -> List[SlotEvent]:
        return self._each("prefill_chunk", slots, chunks, chunk_lens, starts,
                          last)

    def free_slot(self, slot: int) -> None:
        return self._each("free_slot", slot)

    def stats(self) -> List[Dict]:
        """Each process's totals since :meth:`zero_stats`
        (:meth:`MeshProcs.stats`): kernel launches; ``host_s`` (running
        the calls, the collectives and the waits before them excepted),
        ``device_s`` (waiting for the device: before each collective and
        at the end of each call), ``calls`` by method, and ``tp``: the
        sums and gathers (``calls``, operand ``bytes``, ``s``)."""
        return self.procs.stats()

    def zero_stats(self) -> None:
        self.procs.zero_stats()

    def close(self) -> None:
        """Stop every process (idempotent)."""
        self.procs.close()


class _Exhausted(PoolExhausted):
    """A :class:`PoolExhausted` that pickles (its arguments are its
    fields), for the answer of a mesh process."""

    def __reduce__(self):
        return _Exhausted, (self.needed, self.free)


def _open_backend(rank, kw: Dict) -> BackendInfo:
    """In a mesh process: its ``TensorBackend`` over its shard."""
    rank.backend = TensorBackend(rank.tp_cfg, rank.tp_params,
                                 device=rank.device, **kw)
    return rank.backend.info


def _call_backend(rank, method: str, args: Tuple):
    """In a mesh process: one method of its backend under ``use_mesh``,
    timed into its totals (``rank.timed``) and counted by method.  Returns
    (the result on process 0 -- a :class:`PoolExhausted` as a value --,
    the slots' positions and block tables, its live ``info``)."""
    be = rank.backend

    def call():
        with use_mesh(rank.mesh, rank.rules):
            try:
                return getattr(be, method)(*args)
            except PoolExhausted as exc:
                return _Exhausted(exc.needed, exc.free)

    out = rank.timed(call)
    calls = rank.totals.setdefault("calls", {})
    calls[method] = calls.get(method, 0) + 1
    state = be._pos.tobytes() + be._active.tobytes() + (
        be.pager.table.tobytes() + be.pager.n_alloc.tobytes()
        if be.pager is not None else b"")
    return (out if rank.rank == 0 else None), state, be.info


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


#: the class's earlier name, kept for existing callers
TorchTensorBackend = TensorBackend
