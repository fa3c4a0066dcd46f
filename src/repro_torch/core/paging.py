"""Paged KV-cache bookkeeping: refcounted page pool + shared-prefix tree.

The port's copy of the JAX package's ``core/paging.py`` (numpy only),
with its fault-injection hook (``page.alloc``, raised before any state
moves) and its preemption registry (``park``/``unpark``): a preempted
slot's page chain keeps its refcounts while no table row points at it,
and :meth:`PagePool.check` verifies every parked page is still live.

The serving runtime used to allocate one contiguous, bucket-sized KV
cache per slot — every admission paid ``max_len`` rows of memory up
front and slot swap-in was an O(cache-copy) row gather.  This module
extends the paper's explicit buffer-management philosophy (Phase-4
liveness + linear-scan allocation over IR registers) to the serving
layer: the KV cache becomes a fixed page store (``kv_pages:
[num_pages, page_size, n_kv_heads, head_dim]`` per layer) indexed by a
per-slot int32 page table, and page lifetime is managed *explicitly*
by the host — alloc at admission, refcount while referenced, free at
retirement — instead of opaquely by bucket residency.

Two host-side structures (numpy only; the device side is plain
gather/scatter through the tables, see ``repro_torch.models.attention``):

* :class:`PagePool` — the allocator.  Integer refcounts per page,
  free-list allocation, ``fork`` (share a page read-only: refcount
  bump), ``free`` (decrement; page returns to the free list at zero).
  Double-free and foreign-page frees raise.  Page 0 is reserved as the
  *trash page*: unallocated page-table entries point at it, and
  slot-masked writes land in it — it is never handed out and never
  freed, so masked lanes can scatter garbage without corrupting live
  pages.
* :class:`PrefixTree` — shared-prefix reuse.  A tree keyed on
  token-block hashes (one node per full ``page_size`` token block,
  child keyed under its parent so equal blocks in different contexts
  never collide).  A request whose prompt prefix matches a chain of
  nodes forks the nodes' pages into its page table instead of
  re-prefilling them; at registration the tree takes one reference per
  cached page so prefix pages outlive the request that produced them.
  When the pool runs dry the tree reclaims least-recently-used leaf
  nodes whose pages no live slot shares (LRU over last match/insert
  time) and returns their pages to the free list.

Invariant (asserted by the slot scheduler after every tick):
``pages_in_use + pages_free == num_pages`` (the pinned trash page
counts as permanently in use).  :meth:`PagePool.check` verifies it
together with refcount consistency.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..runtime import chaos

#: the reserved trash page: unallocated table entries point here, masked
#: writes land here; never allocated, never freed
TRASH_PAGE = 0


@dataclass
class PageStats:
    """Page-pool / prefix-tree counters (surfaced via bucket_report and
    the serve CLI; see also ``ExecutorStats`` page fields)."""

    #: pages handed out by :meth:`PagePool.alloc` (fresh allocations)
    pages_allocated: int = 0
    #: pages shared instead of allocated (:meth:`PagePool.fork` bumps)
    pages_reused: int = 0
    #: pages returned to the free list by LRU tree reclaim
    pages_reclaimed: int = 0
    #: all-time high-water mark of pages_in_use
    peak_pages_in_use: int = 0
    #: prompts that matched >= 1 full page in the prefix tree
    prefix_hits: int = 0
    #: prompts that matched nothing
    prefix_misses: int = 0
    #: prompt tokens whose prefill was skipped via a prefix match
    tokens_reused: int = 0
    #: prompt tokens actually prefilled (prefix-skip denominator)
    tokens_prefilled: int = 0
    # -- preemption (park/resume) counters --------------------------------
    #: preempted slots whose pages were parked (:meth:`PagePool.park`)
    parks: int = 0
    #: parked slots resumed (:meth:`PagePool.unpark`)
    unparks: int = 0
    #: high-water mark of simultaneously parked pages
    peak_parked_pages: int = 0

    @property
    def prefix_hit_rate(self) -> float:
        n = self.prefix_hits + self.prefix_misses
        return self.prefix_hits / n if n else 0.0

    @property
    def prefill_skip_rate(self) -> float:
        n = self.tokens_reused + self.tokens_prefilled
        return self.tokens_reused / n if n else 0.0


class PagePool:
    """Refcounted fixed-capacity page allocator (host-side bookkeeping).

    ``num_pages`` counts the whole store including the reserved trash
    page, matching the device array's leading extent; ``capacity``
    (= num_pages - 1) pages are allocatable.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (one is the reserved trash page)")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        #: refcount per page; trash page pinned with a permanent self-ref
        self._refs = np.zeros(self.num_pages, np.int32)
        self._refs[TRASH_PAGE] = 1
        #: LIFO free list — recently freed pages are re-issued first
        #: (their device rows are warm)
        self._free: List[int] = list(range(self.num_pages - 1, TRASH_PAGE, -1))
        #: parked-page registry: owner token -> that preempted slot's
        #: page chain.  Parking moves no refcounts — the slot's own
        #: references simply persist while the slot itself is gone, and
        #: this registry is what keeps them *reachable* (check() verifies
        #: every live page is reachable from a slot, the tree, or here)
        self._parked: Dict[object, List[int]] = {}
        self.stats = PageStats()

    # -- introspection ----------------------------------------------------

    @property
    def capacity(self) -> int:
        return self.num_pages - 1

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        """Live pages, including the permanently pinned trash page —
        so ``pages_in_use + pages_free == num_pages`` always holds."""
        return self.num_pages - len(self._free)

    def refcount(self, page: int) -> int:
        return int(self._refs[page])

    @property
    def parked_owners(self) -> int:
        return len(self._parked)

    @property
    def parked_pages(self) -> int:
        return sum(len(v) for v in self._parked.values())

    def check(self) -> None:
        """Assert pool accounting: free + in-use partitions the store."""
        in_use = int(np.count_nonzero(self._refs))
        assert in_use == self.pages_in_use, (
            f"refcount map says {in_use} pages live, free list says "
            f"{self.pages_in_use}"
        )
        assert self.pages_in_use + self.pages_free == self.num_pages, (
            f"pages_in_use({self.pages_in_use}) + pages_free"
            f"({self.pages_free}) != num_pages({self.num_pages})"
        )
        assert self._refs[TRASH_PAGE] >= 1, "trash page lost its pin"
        assert len(set(self._free)) == len(self._free), "free list corrupt"
        # parked reachability: each parked chain still holds live pages,
        # and no page is claimed by more parked owners than it has
        # references (a parked owner's claim IS one of its refcounts)
        claims: Dict[int, int] = {}
        for owner, pages in self._parked.items():
            for p in pages:
                assert p != TRASH_PAGE, f"trash page parked by {owner!r}"
                assert self._refs[p] >= 1, (
                    f"parked page {p} (owner {owner!r}) is dead"
                )
                claims[p] = claims.get(p, 0) + 1
        for p, c in claims.items():
            assert c <= int(self._refs[p]), (
                f"page {p} parked by {c} owners but refcount {self._refs[p]}"
            )

    # -- lifecycle --------------------------------------------------------

    def alloc(self, n: int) -> List[int]:
        """Allocate ``n`` fresh pages (refcount 1 each) or raise
        MemoryError without allocating any."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if chaos.should_fault(chaos.SITE_PAGE_ALLOC):
            # injected exhaustion: raised before any state is touched, so
            # pool accounting stays exact and callers hit their organic
            # defer/reclaim path
            raise MemoryError(
                f"injected page-pool exhaustion: want {n}, "
                f"free {len(self._free)} of {self.capacity}"
            )
        if n > len(self._free):
            raise MemoryError(
                f"page pool exhausted: want {n}, free {len(self._free)} "
                f"of {self.capacity}"
            )
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        self.stats.pages_allocated += n
        self.stats.peak_pages_in_use = max(
            self.stats.peak_pages_in_use, self.pages_in_use
        )
        return pages

    def fork(self, pages: Sequence[int]) -> None:
        """Share already-live pages (prefix reuse): one refcount bump
        per page.  Forking a dead or trash page raises."""
        for p in pages:
            if p == TRASH_PAGE:
                raise ValueError("cannot fork the trash page")
            if self._refs[p] <= 0:
                raise ValueError(f"fork of dead page {p}")
        for p in pages:
            self._refs[p] += 1
        self.stats.pages_reused += len(pages)

    def free(self, pages: Sequence[int]) -> List[int]:
        """Drop one reference per page; returns the pages whose count
        hit zero (now back on the free list).  Double-free raises."""
        for p in pages:
            if p == TRASH_PAGE:
                raise ValueError("cannot free the trash page")
            if self._refs[p] <= 0:
                raise ValueError(f"double free of page {p}")
        released = []
        for p in pages:
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(int(p))
                released.append(int(p))
        return released

    # -- preemption (park / resume) ---------------------------------------

    def park(self, owner: object, pages: Sequence[int]) -> None:
        """Register a preempted slot's page chain under ``owner``.

        No refcounts move: the slot's own references stay live, the
        registry just keeps them *reachable* while no slot row points at
        them (the page-table row is trashed on preemption).  Parking a
        dead/trash page or an already-parked owner raises — both would
        mean the scheduler lost track of a preemption.
        """
        if owner in self._parked:
            raise ValueError(f"owner {owner!r} already has parked pages")
        for p in pages:
            if p == TRASH_PAGE:
                raise ValueError("cannot park the trash page")
            if self._refs[p] <= 0:
                raise ValueError(f"park of dead page {p}")
        self._parked[owner] = [int(p) for p in pages]
        self.stats.parks += 1
        self.stats.peak_parked_pages = max(
            self.stats.peak_parked_pages, self.parked_pages
        )

    def unpark(self, owner: object) -> List[int]:
        """Release ``owner``'s parked chain, returning it in prefix
        order.  The caller either resumes the slot (page-table row
        write) or frees the pages (abort).  Unknown owners raise."""
        if owner not in self._parked:
            raise KeyError(f"no parked pages for owner {owner!r}")
        self.stats.unparks += 1
        return self._parked.pop(owner)


@dataclass
class _Node:
    """One full token block of a cached prefix chain."""

    key: Tuple[int, bytes]  # (parent node id, token-block hash)
    page: int
    parent: int  # node id; -1 at the root level
    children: Dict[bytes, int] = field(default_factory=dict)
    #: LRU clock value of the most recent match/insert touching this node
    last_used: int = 0


class PrefixTree:
    """Token-block-hash tree over pool pages (shared-prefix reuse).

    Each node caches ONE full page (``page_size`` tokens) of prefilled
    KV, keyed by the hash of its token block *under its parent* — so
    the chain of nodes from the root spells out an exact token prefix.
    The tree holds one pool reference per cached page; matching forks
    those pages into the requesting slot's table (refcount bump, no
    prefill), and LRU reclaim releases cold chains back to the pool.
    """

    def __init__(self, pool: PagePool):
        self.pool = pool
        self._nodes: Dict[int, _Node] = {}
        self._by_key: Dict[Tuple[int, bytes], int] = {}
        self._next_id = 0
        self._clock = 0

    def __len__(self) -> int:
        return len(self._nodes)

    @property
    def cached_pages(self) -> int:
        return len(self._nodes)

    @staticmethod
    def block_hash(tokens: np.ndarray) -> bytes:
        """Position-independent hash of one page's token block."""
        return np.ascontiguousarray(tokens, np.int32).tobytes()

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _blocks(self, tokens: np.ndarray) -> List[np.ndarray]:
        ps = self.pool.page_size
        tokens = np.asarray(tokens, np.int32)
        return [tokens[i: i + ps] for i in range(0, len(tokens) - ps + 1, ps)]

    # -- match / insert ---------------------------------------------------

    def match(self, tokens: np.ndarray, *, max_tokens: Optional[int] = None
              ) -> Tuple[List[int], int]:
        """Longest cached prefix of ``tokens`` in full-page units.

        Returns ``(pages, n_tokens)``: the chain's pages in prefix
        order and the token count they cover (a multiple of
        ``page_size``).  ``max_tokens`` caps the match (the caller must
        keep at least the prompt's last token for prefill, so the
        first generated token's logits exist).  The caller owns the
        fork: this method only reads.
        """
        now = self._tick()
        pages: List[int] = []
        parent = -1
        matched = 0
        ps = self.pool.page_size
        cap = len(tokens) if max_tokens is None else min(max_tokens, len(tokens))
        for block in self._blocks(tokens):
            if matched + ps > cap:
                break
            nid = self._by_key.get((parent, self.block_hash(block)))
            if nid is None:
                break
            node = self._nodes[nid]
            node.last_used = now
            pages.append(node.page)
            parent = nid
            matched += ps
        if pages:
            self.pool.stats.prefix_hits += 1
            self.pool.stats.tokens_reused += matched
        else:
            self.pool.stats.prefix_misses += 1
        return pages, matched

    def insert(self, tokens: np.ndarray, pages: Sequence[int]) -> int:
        """Register a prefilled prefix chain: block ``i`` of ``tokens``
        is cached in ``pages[i]``.  Only full pages may be registered
        (the caller passes ``len(tokens) // page_size`` pages at most).
        Nodes already present are refreshed; new nodes take one pool
        reference each (fork) so the pages outlive the inserting slot.
        Returns the number of NEW nodes created.
        """
        now = self._tick()
        ps = self.pool.page_size
        blocks = self._blocks(tokens)
        if len(pages) > len(blocks):
            raise ValueError(
                f"{len(pages)} pages but only {len(blocks)} full blocks "
                f"in a {len(tokens)}-token prefix (page_size={ps})"
            )
        parent = -1
        created = 0
        for block, page in zip(blocks, pages):
            key = (parent, self.block_hash(block))
            nid = self._by_key.get(key)
            if nid is None:
                self.pool.fork([page])  # the tree's own reference
                nid = self._next_id
                self._next_id += 1
                node = _Node(key=key, page=int(page), parent=parent,
                             last_used=now)
                self._nodes[nid] = node
                self._by_key[key] = nid
                if parent >= 0:
                    self._nodes[parent].children[key[1]] = nid
                created += 1
            else:
                node = self._nodes[nid]
                if node.page != page:
                    # same tokens prefilled into a different page (e.g.
                    # two concurrent admissions): keep the incumbent —
                    # values are identical by the fidelity contract
                    pass
                node.last_used = now
            parent = nid
        return created

    # -- reclaim ----------------------------------------------------------

    def _evictable(self) -> List[int]:
        """Leaf nodes whose page no live slot shares (tree holds the
        only reference) — the reclaim frontier, LRU-first."""
        out = [
            nid for nid, n in self._nodes.items()
            if not n.children and self.pool.refcount(n.page) == 1
        ]
        out.sort(key=lambda nid: self._nodes[nid].last_used)
        return out

    def _drop(self, nid: int) -> int:
        node = self._nodes.pop(nid)
        del self._by_key[node.key]
        if node.parent >= 0 and node.parent in self._nodes:
            self._nodes[node.parent].children.pop(node.key[1], None)
        released = self.pool.free([node.page])
        self.pool.stats.pages_reclaimed += len(released)
        return len(released)

    def reclaim(self, n_pages: int) -> int:
        """Free >= ``n_pages`` pages by evicting LRU unshared leaves
        (walking up chains as leaves unlock their parents).  Returns
        the number of pages actually returned to the free list."""
        freed = 0
        while freed < n_pages:
            frontier = self._evictable()
            if not frontier:
                break
            for nid in frontier:
                freed += self._drop(nid)
                if freed >= n_pages:
                    break
        return freed

    def clear(self) -> int:
        """Drop every cached chain (releases all tree references)."""
        freed = 0
        while self._nodes:
            before = len(self._nodes)
            for nid in list(self._evictable()):
                freed += self._drop(nid)
            if len(self._nodes) == before:  # shared pages keep nodes alive
                break
        return freed


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` cache rows."""
    return -(-int(n_tokens) // int(page_size)) if n_tokens > 0 else 0


def build_row_table(pages: Sequence[int], max_pages: int) -> np.ndarray:
    """One slot's page-table row: ``pages`` then trash padding."""
    if len(pages) > max_pages:
        raise ValueError(f"{len(pages)} pages > table width {max_pages}")
    row = np.full((max_pages,), TRASH_PAGE, np.int32)
    row[: len(pages)] = np.asarray(pages, np.int32)
    return row
