"""Content-addressed prefix index over the paged KV block pool.

The paged runtime already has the two hard preconditions for prefix
sharing: masked prefill makes shared prompt prefixes produce
*block-identical* KV (PR 4), and :class:`~repro.runtime.base.BlockAllocator`
refcounts pool blocks (PR 3).  This module adds the missing piece — a map
from token content to the pool block that already holds its KV — so
admission can wire cached blocks straight into a new slot's block table
(copy-on-write: the new slot *reads* the shared blocks through its table
but only ever writes positions past them) and prefill just the non-shared
suffix.

Keys are **chained**: block ``j`` of a prompt is identified by
``(parent_block_id, tokens[j*bs:(j+1)*bs])`` where ``parent_block_id`` is
the *physical* id of block ``j-1`` (``ROOT`` for the first block).  Using
the physical parent id instead of a rolling hash makes keys exact — two
different left contexts can never alias, because they resolve to different
parent blocks — at the cost of an eviction cascade: when a parent block is
repurposed, its descendants' keys become unreachable and are dropped from
the index (the descendant *blocks* stay in the allocator's cached-free
LRU until the pool actually needs them).

Lifecycle of a shared block:

- **register** — a stream finished prefilling; its full token blocks enter
  the index (first writer wins: concurrent identical prompts each hold
  private copies, only one is indexed).
- **release** — the owning slot frees; a registered block at refcount 0
  parks in the allocator's cached-free LRU (``BlockAllocator.free``): its
  device bytes stay intact and it still counts as a free block.
- **adopt** — a later admission looks up the longest cached chain and
  increfs the blocks into its own table (``SlotPager.adopt``), resurrecting
  cached-free blocks without any copy or recompute.
- **evict** — the pool runs dry and ``alloc`` repurposes the LRU
  cached-free block; the allocator calls back into :meth:`_on_evict`, which
  drops the block's key and cascades over its (now unreachable) children.

Pure host-side bookkeeping (numpy/int only), like the allocator and pager
it composes with.

A copy of ``repro.runtime.prefix_cache`` kept by the port, which imports
nothing of ``repro``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.runtime.base import BlockAllocator

#: parent id of the first block in every chain.
ROOT = -1

Key = Tuple[int, Tuple[int, ...]]


class PrefixCache:
    """Hash-chained token-block -> pool-block index over one allocator.

    Installs itself as ``allocator.on_evict`` so index entries die exactly
    when the pool repurposes their block.  ``block_size`` must match the
    pool's paging granularity.
    """

    def __init__(self, allocator: BlockAllocator, block_size: int):
        assert block_size >= 1
        self.allocator = allocator
        self.block_size = block_size
        self._index: Dict[Key, int] = {}      # key -> physical block id
        self._key_of: Dict[int, Key] = {}     # physical block id -> its key
        self._kids: Dict[int, Set[int]] = {}  # parent block -> child blocks
        allocator.on_evict = self._on_evict

    # ------------------------------------------------------------------ #
    @property
    def n_indexed(self) -> int:
        """Blocks currently reachable through the index."""
        return len(self._index)

    def _key(self, parent: int, tokens: np.ndarray) -> Key:
        return (parent, tuple(int(t) for t in tokens))

    def lookup(self, tokens: Sequence[int]) -> List[int]:
        """Longest chain of indexed blocks covering a block-aligned prefix
        of ``tokens``.  Returns physical block ids in position order; the
        blocks are *not* increfed — the caller adopts them atomically
        (``SlotPager.adopt``) before any allocation can evict them.
        """
        tokens = np.asarray(tokens)
        bs = self.block_size
        blocks: List[int] = []
        parent = ROOT
        for j in range(len(tokens) // bs):
            b = self._index.get(self._key(parent, tokens[j * bs:(j + 1) * bs]))
            if b is None:
                break
            blocks.append(b)
            parent = b
        return blocks

    def matched_tokens(self, tokens: Sequence[int],
                       cap: Optional[int] = None) -> int:
        """Tokens covered by :meth:`lookup`, optionally capped (admission
        caps at ``((plen - 1) // bs) * bs`` so at least one suffix token is
        always prefilled to produce the first logits)."""
        n = len(self.lookup(tokens)) * self.block_size
        return min(n, cap) if cap is not None else n

    def register(self, tokens: Sequence[int], blocks: Sequence[int]) -> int:
        """Index a finished stream's full token blocks.

        ``blocks[j]`` must be the physical block holding the KV of
        ``tokens[j*bs:(j+1)*bs]`` (the slot's block-table prefix) and must
        be live (refcount > 0).  First writer wins: a key already mapping
        to a *different* block is left alone — the duplicate copy stays a
        private, unindexed block and is freed normally.  Returns how many
        blocks were newly indexed.
        """
        tokens = np.asarray(tokens)
        bs = self.block_size
        assert len(blocks) <= len(tokens) // bs, (len(blocks), len(tokens))
        added = 0
        parent = ROOT
        for j, b in enumerate(blocks):
            b = int(b)
            key = self._key(parent, tokens[j * bs:(j + 1) * bs])
            have = self._index.get(key)
            if have is not None:
                if have != b and b in self._key_of:
                    # stale: b was indexed under an older chain; keep the
                    # established entry and leave b to age out
                    pass
                parent = have
                continue
            if b in self._key_of:       # one block, one key
                parent = b
                continue
            self._index[key] = b
            self._key_of[b] = key
            self._kids.setdefault(parent, set()).add(b)
            self.allocator.register(b)
            added += 1
            parent = b
        return added

    # ------------------------------------------------------------------ #
    def _drop(self, block: int) -> None:
        key = self._key_of.pop(block, None)
        if key is None:
            return
        if self._index.get(key) == block:
            del self._index[key]
        for child in self._kids.pop(block, ()):  # cascade: kids unreachable
            self._drop(child)

    def _on_evict(self, block: int) -> None:
        """Allocator callback: a cached-free block was repurposed."""
        self._drop(block)
