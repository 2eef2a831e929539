"""The runtime seam: one backend protocol for every execution path.

An :class:`InferenceBackend` owns model state (weights + per-slot KV caches)
and exposes a *slot-granular* serving interface.  A slot is one independent
request stream with its own cache positions; the scheduler above
(``serving.ContinuousBatcher``) owns request queues, sampling state, and slot
recycling, and never touches jax directly.

The protocol is event-driven rather than batch-lockstep because the paper's
no-bubbles pipeline is inherently skewed: one tick feeds one micro-batch and
completes (at most) one other.  Backends advance by their natural quantum —

- ``TensorBackend``   quantum = one batched decode step (all slots),
- ``PipelineBackend`` quantum = one no-bubbles tick (one stage ring shift),
- ``SimBackend``      quantum = one simulated decode round —

and report finished work as :class:`SlotEvent` s.  A backend that samples
in-SPMD (the pipeline's last-stage greedy argmax riding the token ring)
returns ``token``; a backend that exposes logits returns ``logits`` and the
scheduler applies the request's own sampling params.

A copy of ``repro.runtime.base`` kept by the port, which
imports nothing of ``repro``.
"""
from __future__ import annotations

import abc
import dataclasses
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Set, Union

import numpy as np


class BackendError(RuntimeError):
    """Typed failure of one backend operation.

    The root of the runtime's failure taxonomy.  The contract every backend
    (and the fault-injection wrapper) honors: a ``BackendError`` is raised
    *before* the operation mutates any backend state, so the caller may
    retry the same quantum verbatim.  A plain ``BackendError`` is
    *transient* — the scheduler absorbs it with capped exponential backoff;
    the subclasses refine the semantics:

    - :class:`BackendTimeout` — the op exceeded its deadline (slow link,
      hung device).  Transient: retryable like the base class.
    - :class:`BackendDead` — the backend is gone for good (crash, lost
      host).  Fatal: the fleet watchdog quarantines it and re-admits its
      whole working set elsewhere; retrying is useless.
    - :class:`PoolExhausted` — KV capacity, not health.  Handled by the
      preempt-and-recompute machinery, never by retry/backoff.
    """


class BackendTimeout(BackendError):
    """An operation exceeded its deadline.  Transient: retry with backoff."""


class BackendDead(BackendError):
    """The backend is permanently gone — every further operation (except
    ``free_slot``, which must keep working so the scheduler can drain its
    bookkeeping) will raise this too.  Fatal: do not retry; quarantine."""


class PoolExhausted(BackendError):
    """A paged backend could not allocate KV blocks for its next quantum.

    Raised *before* any state mutates, so the quantum can be retried after
    the scheduler frees capacity (preempt-and-requeue the youngest request).
    Capacity pressure, not a health signal: the scheduler's preemption
    machinery owns it, never the retry/quarantine path.
    """

    def __init__(self, needed: int, free: int) -> None:
        super().__init__(f"KV block pool exhausted: need {needed} block(s), "
                         f"{free} free")
        self.needed = needed
        self.free = free


class BlockAllocator:
    """Free-list + refcount allocator over ``num_blocks`` logical KV blocks.

    Pure host-side bookkeeping (numpy/int only — importable without jax).
    Block ids are indices into the backend's device pools; every attention
    layer materializes the same id space in its own pool storage, so one
    logical block backs one (block_size-token) stripe of every layer's cache.
    Refcounts let prefix sharing map one block into several slots' tables.

    **Cached-free LRU** (prefix caching): a block marked via
    :meth:`register` whose refcount drops to 0 is not returned to the free
    list — it parks in an LRU of *cached-free* blocks whose device bytes
    stay intact, still counting toward :attr:`free_blocks` (the pool never
    shrinks).  :meth:`incref` resurrects a cached-free block for zero-copy
    reuse; :meth:`alloc` repurposes cached-free blocks (oldest first) only
    after the plain free list runs dry, notifying ``on_evict`` so the
    prefix index can drop its mapping.
    """

    def __init__(self, num_blocks: int) -> None:
        assert num_blocks >= 0
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self.refcount = np.zeros(num_blocks, np.int32)
        self._registered: Set[int] = set()     # live blocks worth caching
        self._cached: "OrderedDict[int, None]" = OrderedDict()  # LRU order
        self.on_evict: Optional[Callable[[int], None]] = None

    @property
    def free_blocks(self) -> int:
        """Allocatable blocks: truly free plus cached-free (evictable)."""
        return len(self._free) + len(self._cached)

    @property
    def cached_blocks(self) -> int:
        """Cached-free blocks (refcount 0, device bytes still meaningful)."""
        return len(self._cached)

    def alloc(self, n: int) -> List[int]:
        """Allocate ``n`` blocks atomically; raises :class:`PoolExhausted`
        (allocating nothing) when fewer than ``n`` are free.  Prefers the
        plain free list; falls back to evicting the oldest cached-free
        blocks (calling ``on_evict`` for each)."""
        if n > self.free_blocks:
            raise PoolExhausted(needed=n, free=self.free_blocks)
        out: List[int] = []
        for _ in range(n):
            if self._free:
                out.append(self._free.pop())
            else:
                b, _ = self._cached.popitem(last=False)     # LRU eviction
                self._registered.discard(b)
                if self.on_evict is not None:
                    self.on_evict(b)
                out.append(b)
        self.refcount[out] += 1
        return out

    def incref(self, block: int) -> None:
        if self.refcount[block] == 0:
            # resurrect a cached-free block: its bytes are being adopted
            assert block in self._cached, f"incref of free block {block}"
            del self._cached[block]
        self.refcount[block] += 1

    def register(self, block: int) -> None:
        """Mark a live block as prefix-indexed: when its refcount drops to
        0 it parks in the cached-free LRU instead of the free list."""
        assert self.refcount[block] > 0, f"register of free block {block}"
        self._registered.add(int(block))

    def free(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            assert self.refcount[b] > 0, f"double free of block {b}"
            self.refcount[b] -= 1
            if self.refcount[b] == 0:
                if b in self._registered:
                    self._cached[int(b)] = None     # newest end of the LRU
                else:
                    self._free.append(int(b))


class SlotPager:
    """Per-slot block tables over one :class:`BlockAllocator`.

    ``max_ctx_blocks`` is the most blocks one slot can ever hold — derived
    from the *clamped* attention cache length (``attn_cache_len``), so
    windowed specs with ``window > max_len`` account for ``max_len`` tokens,
    never the nominal window.  The table grows in position order; ring reuse
    past the cache length allocates nothing (the ring slot maps to an
    already-held block).
    """

    def __init__(self, n_slots: int, num_blocks: int, block_size: int,
                 max_ctx_blocks: int,
                 table_width: Optional[int] = None) -> None:
        assert block_size >= 1
        self.block_size = block_size
        self.max_ctx_blocks = max_ctx_blocks
        self.allocator = BlockAllocator(num_blocks)
        # -1 = unallocated; device side redirects -1 writes to scratch.
        # Device backends keep the full max_ctx_blocks width (the gather
        # spans it); accounting-only users (SimBackend with unbounded
        # max_len) cap it at the pool size a slot could ever hold.
        width = max_ctx_blocks if table_width is None else table_width
        self.table = np.full((n_slots, max(width, 1)), -1, np.int32)
        self.n_alloc = np.zeros(n_slots, np.int32)

    @property
    def free_blocks(self) -> int:
        return self.allocator.free_blocks

    @property
    def total_blocks(self) -> int:
        return self.allocator.num_blocks

    def blocks_for_len(self, n_tokens: int) -> int:
        """Blocks a sequence of ``n_tokens`` occupies (window-clamped)."""
        if n_tokens <= 0:
            return 0
        need = -(-n_tokens // self.block_size)          # ceil div
        return min(need, self.max_ctx_blocks)

    def blocks_needed(self, slot: int, pos: int) -> int:
        """Blocks that must be allocated before writing position ``pos``."""
        return max(self.blocks_for_len(pos + 1) - int(self.n_alloc[slot]), 0)

    def ensure(self, slot: int, pos: int) -> bool:
        """Grow ``slot``'s table so position ``pos`` is backed by a block.

        Returns True when the table changed.  Raises :class:`PoolExhausted`
        (mutating nothing) when the pool cannot cover the growth.
        """
        need = self.blocks_needed(slot, pos)
        if not need:
            return False
        new = self.allocator.alloc(need)
        lo = int(self.n_alloc[slot])
        self.table[slot, lo:lo + need] = new
        self.n_alloc[slot] = lo + need
        return True

    def adopt(self, slot: int, blocks: Sequence[int]) -> None:
        """Map already-populated blocks (a cached prefix) into an empty
        slot's table head, increfing each — copy-on-write sharing: the slot
        reads these blocks through its table but only ever writes positions
        past them.  Blocks may be live (shared with another slot) or
        cached-free (resurrected); either way no data moves."""
        assert int(self.n_alloc[slot]) == 0, \
            f"adopt into non-empty slot {slot}"
        assert len(blocks) <= self.table.shape[1], (len(blocks), self.table.shape)
        for b in blocks:
            self.allocator.incref(int(b))
        n = len(blocks)
        if n:
            self.table[slot, :n] = np.asarray(blocks, np.int32)
        self.n_alloc[slot] = n

    def release(self, slot: int) -> bool:
        """Free every block ``slot`` holds.  Returns True if any were held."""
        n = int(self.n_alloc[slot])
        if not n:
            return False
        self.allocator.free(self.table[slot, :n].tolist())
        self.table[slot, :n] = -1
        self.n_alloc[slot] = 0
        return True

    def realloc_wave(self, slots: Sequence[int],
                     n_tokens: Union[int, Sequence[int]]) -> None:
        """Release every slot in an admission wave, then grow each table to
        cover its prompt positions — atomically: on :class:`PoolExhausted`
        the partial growth is rolled back (the wave's slots end empty,
        which is what they were: freed slots being re-admitted), so the
        caller can preempt and retry.

        ``n_tokens`` is one shared length or a per-slot sequence (masked
        prefill allocates each slot's *true* prompt length, not the padded
        bucket)."""
        lens = [int(n_tokens)] * len(slots) \
            if np.ndim(n_tokens) == 0 else [int(n) for n in n_tokens]
        assert len(lens) == len(slots), (len(lens), len(slots))
        for s in slots:
            self.release(s)
        grown: List[int] = []
        try:
            for s, n in zip(slots, lens):
                if n > 0:
                    self.ensure(s, n - 1)
                grown.append(s)
        except PoolExhausted:
            for s in grown:
                self.release(s)
            raise


@dataclass
class SlotEvent:
    """One slot produced its next token (or the logits to sample it from).

    Decode events carry ``logits [V]`` or a pre-sampled ``token``.
    Speculative *verify* events (from :meth:`InferenceBackend.verify_step`)
    carry ``logits [n, V]`` — one next-token distribution per fed token —
    or ``tokens [n]`` for backends that sample in-backend; the scheduler
    runs longest-prefix acceptance over them and reports the kept count
    back via :meth:`InferenceBackend.accept`.
    """

    slot: int
    logits: Optional[np.ndarray] = None   # [V] or [n, V] — scheduler samples
    token: Optional[int] = None           # pre-sampled (greedy in-SPMD)
    tokens: Optional[np.ndarray] = None   # [n] pre-sampled verify outputs

    def __post_init__(self) -> None:
        assert (self.logits is not None) or (self.token is not None) \
            or (self.tokens is not None)


@dataclass(frozen=True)
class BackendInfo:
    """Capacity / memory metadata the scheduler and planner can introspect.

    ``cache_layout`` is ``"contiguous"`` (one worst-case ``max_len`` cache
    per slot) or ``"paged"`` (slots map block tables into a shared pool).
    For paged backends ``cache_bytes_per_slot`` is the *provisioned* share
    (pool bytes / n_slots) — honest rather than worst-case, and smaller than
    the contiguous figure whenever the pool overcommits — and
    ``free_blocks`` is a live count (the backend rebuilds ``info`` per read).
    """

    n_slots: int
    max_len: int
    cache_bytes_per_slot: int = 0
    param_bytes: int = 0
    samples_in_backend: bool = False   # True -> events carry tokens, not logits
    cache_layout: str = "contiguous"   # "contiguous" | "paged"
    block_size: int = 0                # tokens per KV block (paged only)
    total_blocks: int = 0              # shared pool size (paged only)
    free_blocks: int = 0               # live unallocated blocks (paged only)
    bytes_per_block: int = 0           # summed over every attention layer
    max_ctx_blocks: int = 0            # most blocks one slot can ever hold
    prefix_caching: bool = False       # shared-prefix KV reuse is active
    supports_extend: bool = False      # start_stream/prefill_chunk available
    prefix_hits: int = 0               # admissions that adopted cached blocks
    prefix_hit_tokens: int = 0         # prompt tokens served from the cache
    prefix_blocks_cached: int = 0      # cached-free blocks held for reuse
    #: advisory decode rate (tokens/s per busy slot-step) for dispatcher
    #: cost estimates; 0.0 = unknown (the Fleet treats unknown as 1.0)
    tokens_per_s: float = 0.0
    #: decode impl actually executing (may differ from the requested impl —
    #: e.g. pallas+int8 KV downgrades to the xla gather path); benchmarks
    #: assert on this instead of trusting their own flag
    attn_impl: str = "xla"
    #: verify_step/accept (multi-token speculative verify) available
    spec_decode: bool = False
    #: live health verdict: "healthy", "degraded" (serving but slow/flaky),
    #: or "dead: <reason>" — mirrors :meth:`InferenceBackend.health`
    health: str = "healthy"

    @property
    def paged(self) -> bool:
        return self.cache_layout == "paged"

    @property
    def blocks_per_token(self) -> float:
        """Marginal pool demand per generated token (0 when contiguous)."""
        return 1.0 / self.block_size if self.paged and self.block_size else 0.0

    def blocks_for_len(self, n_tokens: int) -> int:
        """Blocks a sequence of ``n_tokens`` occupies (window-clamped)."""
        if not self.paged or n_tokens <= 0:
            return 0
        return min(-(-n_tokens // self.block_size), self.max_ctx_blocks)

    @property
    def cache_bytes(self) -> int:
        return self.cache_bytes_per_slot * self.n_slots


class InferenceBackend(abc.ABC):
    """Slot-granular prefill/decode over a fixed model deployment."""

    #: construction-time :class:`BackendInfo` snapshot; every concrete
    #: backend assigns it in ``__init__`` and ``_live_info`` refreshes the
    #: live counters from it on each ``info`` read.
    _info: BackendInfo

    @property
    @abc.abstractmethod
    def info(self) -> BackendInfo:
        ...

    def _live_info(self) -> BackendInfo:
        """Shared ``info`` body for paged backends: refresh the frozen
        construction-time snapshot (``self._info``) with the pager's live
        free-block count.  Backends without a pager return the snapshot."""
        info = self._info
        pager = getattr(self, "pager", None)
        if pager is None:
            return info
        return dataclasses.replace(
            info, free_blocks=pager.free_blocks,
            prefix_hits=int(getattr(self, "_prefix_hits", 0)),
            prefix_hit_tokens=int(getattr(self, "_prefix_hit_tokens", 0)),
            prefix_blocks_cached=pager.allocator.cached_blocks)

    @property
    def n_slots(self) -> int:
        return self.info.n_slots

    def health(self) -> str:
        """Live health verdict: ``"healthy"``, ``"degraded"`` (still
        serving, but slow or flaky), or ``"dead: <reason>"``.  In-process
        backends are healthy by construction; wrappers (fault injection,
        remote shims) override this to surface their live state.  The fleet
        watchdog reads it for reporting only — failure *classification*
        rides the typed :class:`BackendError` hierarchy, not polling."""
        return "healthy"

    @abc.abstractmethod
    def prefill(self, slots: Sequence[int], prompts: np.ndarray,
                prompt_lens: Optional[Sequence[int]] = None,
                ) -> List[SlotEvent]:
        """Admit ``prompts[i]`` (shape [S], int32) into ``slots[i]``.

        ``prompt_lens[i]`` is the *true* length of prompt ``i``;
        ``prompts`` is then left-padded to a shared width S and the backend
        must treat the leading pads as semantically invisible (masked out
        of attention, never valid cache keys, positions 0..len-1) — the
        slot's outputs must equal an exact-length unpadded prefill.  With
        ``prompt_lens=None`` every prompt is taken at face value (len = S).

        Resets each slot's cache state.  Backends that process prompts
        synchronously return one event per slot (logits after the last
        prompt token); pipelined backends may return ``[]`` and emit the
        first token from a later ``decode_step``.
        """

    # -- streamed admission (prefix caching + chunked prefill) ---------- #
    # Optional protocol: backends advertising ``info.supports_extend``
    # implement these three; the scheduler then admits via
    # ``start_stream`` + one or more ``prefill_chunk`` calls instead of
    # the monolithic ``prefill``.  The defaults keep simple backends
    # (tests' fakes, remote shims) valid without opting in.

    def cached_prefix_len(self, prompt: np.ndarray) -> int:
        """Advisory: prompt tokens a ``start_stream`` would serve from the
        prefix cache right now (block-aligned, capped so at least one
        suffix token remains).  Used for admission budgeting; the
        authoritative match happens inside ``start_stream``."""
        return 0

    def start_stream(self, slot: int, prompt: np.ndarray) -> int:
        """Reset ``slot`` and begin a streamed admission of ``prompt``
        (int32 [plen], unpadded).  Adopts any cached prefix blocks
        copy-on-write and returns ``start`` — how many prompt tokens are
        already in cache (0 on miss or with prefix caching off).  The
        caller then feeds ``prompt[start:]`` through ``prefill_chunk``."""
        raise NotImplementedError(type(self).__name__)

    def prefill_chunk(self, slots: Sequence[int], chunks: np.ndarray,
                      chunk_lens: Sequence[int], starts: Sequence[int],
                      last: Sequence[bool]) -> List[SlotEvent]:
        """Continue streamed admissions: write ``chunk_lens[i]`` tokens
        (right-aligned in ``chunks[i]``, left-padded to the shared width)
        at absolute positions ``starts[i]..starts[i]+chunk_lens[i]-1`` of
        ``slots[i]``'s cache, with all earlier keys visible.  Rows with
        ``last[i]`` finish their prompt; synchronous backends return their
        first-token events (pipelined backends may return ``[]`` and emit
        from a later ``decode_step``).  Raises :class:`PoolExhausted`
        before mutating anything when the pool cannot back the chunk."""
        raise NotImplementedError(type(self).__name__)

    # -- speculative decode (draft-then-verify) ------------------------- #
    # Optional protocol: backends advertising ``info.spec_decode``
    # implement these two.  One verify quantum scores every fed token in a
    # single forward pass; the scheduler accepts a prefix and the backend
    # rolls rejected positions back.  ``verify_step`` with 1-token feeds is
    # semantically a ``decode_step`` (and must match it bit-for-bit under
    # greedy sampling).

    def verify_step(self, feeds: Dict[int, np.ndarray],
                    ) -> List[SlotEvent]:
        """Score ``feeds[slot]`` (int32 [n], n >= 1: the last accepted
        token followed by ``n-1`` draft continuations) for each live slot
        in one forward pass.  Returns one event per fed slot whose
        ``logits`` is [n, V] (or ``tokens`` [n] when sampling in-backend):
        entry ``i`` is the model's next-token output after fed token ``i``.
        All ``n`` candidate keys are written to the slot's cache; the
        caller MUST follow with :meth:`accept` before the next quantum."""
        raise NotImplementedError(type(self).__name__)

    def accept(self, counts: Dict[int, int]) -> None:
        """Commit ``counts[slot]`` tokens of the last ``verify_step``'s
        feeds-plus-outputs for each slot and roll back the rest: cache
        state must end exactly as if the slot had decoded those tokens
        one-by-one (rejected draft keys invalidated, position rewound)."""
        raise NotImplementedError(type(self).__name__)

    @abc.abstractmethod
    def decode_step(self, feeds: Dict[int, int]) -> List[SlotEvent]:
        """Advance one quantum, consuming per-slot input tokens from
        ``feeds`` as needed.  ``feeds[slot]`` is the last sampled token of
        the request in ``slot``; entries persist until the slot is freed, so
        backends with internal skew read them when the slot's turn comes.
        """

    @abc.abstractmethod
    def free_slot(self, slot: int) -> None:
        """Release a slot for reuse.  Backends must tolerate subsequent
        quanta before the slot is re-prefilled."""
