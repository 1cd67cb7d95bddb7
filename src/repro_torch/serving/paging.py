"""Host-side page allocator + shared-prefix index for the paged KV cache.

The device holds one shared page pool per attention layer
(``[n_pages, page_size, kv_heads, head_dim]``) plus an integer page table
per slot; this module owns the *indices*. Pages are fixed-size, so
allocation is a free-list pop and free is a push — O(1), no compaction,
no fragmentation beyond per-page internal padding (< ``page_size`` tokens
per request).

Pages are REFCOUNTED so requests with a common prompt prefix can share
the prefix's pages instead of recomputing (and re-storing) them:

  * ``alloc`` grants fresh pages at refcount 1 (exclusive);
  * ``share`` aliases already-live pages into another slot (refcount+1);
  * ``free_slot`` decrefs everything a slot holds and only returns a page
    to the free list when its refcount reaches 0;
  * ``retain``/``release`` let a non-slot owner — the ``PrefixIndex`` —
    keep prefix chains alive after the request that computed them is gone.

``PrefixIndex`` is a host-side radix tree over *full pages* of prompt
tokens: each node is one page whose ``page_size`` tokens are the edge
label. ``lookup`` walks the longest cached chain for a new prompt (full
pages aliased read-only; a partially-matching tail page is surfaced for
copy-on-write), ``register`` inserts a finished prompt's full pages, and
``evict`` drops least-recently-touched chains whose pages no live slot
references (refcount held only by the index) under pool pressure.

Invariants (tests/test_paging.py, tests/test_prefix_cache.py):
  * page 0 is reserved as the trash page: freed/inactive slots point their
    page-table rows at it, so a stale slot's decode writes can never land
    in a page owned by a live request; the trash page is never granted,
    shared, or indexed;
  * ``alloc`` is all-or-nothing: it returns None (admission backpressure)
    rather than a partial grant;
  * a page returns to the free list (LIFO, cache-friendly reuse) exactly
    when its last reference drops — eviction can never free a page a live
    slot still reads.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class OutOfPagesError(RuntimeError):
    """Raised when decode growth needs a page and the pool is exhausted.

    Admission-time shortage is signalled by ``alloc`` returning None (the
    engine queues the request); mid-decode shortage means the pool was
    sized without decode headroom — size ``pool_pages`` at
    ``slots * ceil(max_seq / page_size) + 1`` (the +1 covers the reserved
    trash page) to make this unreachable.
    """


class PageAllocator:
    """Refcounted free-list allocator over a fixed pool of KV pages.

    ``n_pages`` counts the whole pool including the reserved trash page
    (page 0), so ``capacity`` = n_pages - reserved usable pages.
    """

    TRASH_PAGE = 0

    def __init__(self, n_pages: int, page_size: int, *, reserved: int = 1):
        if n_pages <= reserved:
            raise ValueError(f"pool of {n_pages} pages leaves none usable "
                             f"({reserved} reserved)")
        self.n_pages = n_pages
        self.page_size = page_size
        self.reserved = reserved
        # LIFO free list: lowest page numbers on top so early allocations
        # are dense (nicer locality, easier to eyeball in tests).
        self._free: List[int] = list(range(n_pages - 1, reserved - 1, -1))
        self._owned: Dict[int, List[int]] = {}
        self._ref: Dict[int, int] = {}  # live page -> reference count

    # -- sizing ------------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.n_pages - self.reserved

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.capacity - len(self._free)

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def refcount(self, page: int) -> int:
        """References currently held on ``page`` (0 = free or trash)."""
        return self._ref.get(page, 0)

    @property
    def total_refs(self) -> int:
        """Sum of all live refcounts (0 = fully drained pool — the
        zero-leak probe benches assert after clear_prefix_cache)."""
        return sum(self._ref.values())

    # -- alloc / share / free ----------------------------------------------
    def alloc(self, slot: int, n: int) -> Optional[List[int]]:
        """Grant ``n`` fresh pages to ``slot`` (appending to what it owns,
        each at refcount 1), or None if the pool cannot cover the whole
        request."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        self._owned.setdefault(slot, []).extend(pages)
        return pages

    def share(self, slot: int, pages: List[int]) -> List[int]:
        """Alias already-live ``pages`` into ``slot`` (refcount+1 each).
        Never allocates, so it cannot fail for lack of pool space; sharing
        a free (or trash) page is a lifecycle bug and raises."""
        for p in pages:
            if self._ref.get(p, 0) <= 0:
                raise ValueError(f"page {p} is not live; cannot share")
        for p in pages:
            self._ref[p] += 1
        self._owned.setdefault(slot, []).extend(pages)
        return list(pages)

    def retain(self, page: int):
        """Take a non-slot reference on a live page (the PrefixIndex's
        hold, keeping cached prefixes alive after their slot frees)."""
        if self._ref.get(page, 0) <= 0:
            raise ValueError(f"page {page} is not live; cannot retain")
        self._ref[page] += 1

    def release(self, page: int) -> bool:
        """Drop one reference; returns True when the page was reclaimed
        (refcount reached 0 and it went back to the free list)."""
        r = self._ref.get(page, 0)
        if r <= 0:
            raise ValueError(f"page {page} is not live; cannot release")
        if r > 1:
            self._ref[page] = r - 1
            return False
        del self._ref[page]
        self._free.append(page)
        return True

    def owned(self, slot: int) -> List[int]:
        return list(self._owned.get(slot, ()))

    def owned_tokens(self, slot: int) -> int:
        """Token capacity currently backed by the slot's pages."""
        return len(self._owned.get(slot, ())) * self.page_size

    def free_slot(self, slot: int) -> List[int]:
        """Drop the slot's reference on every page it holds; returns the
        pages actually reclaimed (refcount hit 0). Shared pages survive
        with the other holders (LIFO: newest reclaimed pages reused
        first)."""
        pages = self._owned.pop(slot, [])
        freed = [p for p in reversed(pages) if self.release(p)]
        return freed

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"PageAllocator(pages={self.n_pages}, size={self.page_size}, "
                f"in_use={self.pages_in_use}, free={self.free_pages})")


# ---------------------------------------------------------------------------
# shared-prefix radix index
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PrefixHit:
    """Longest cached prefix for a prompt: ``full_pages`` alias read-only
    (their whole ``page_size`` span matches), ``tail_page`` (if >= 0)
    matches only its first ``tail_tokens`` tokens and must be COPIED into
    a private page before the admitting slot writes anything into that
    span (copy-on-write). ``tokens`` is the total usable hit, capped at
    prompt_len - 1 so the last prompt token is always recomputed (its
    logits seed the first output token; only KV is cached)."""

    tokens: int
    full_pages: Tuple[int, ...] = ()
    tail_page: int = -1
    tail_tokens: int = 0


@dataclass
class _PrefixNode:
    key: Tuple[int, ...]  # the page's page_size prompt tokens (edge label)
    page: int
    children: Dict[Tuple[int, ...], "_PrefixNode"] = field(default_factory=dict)
    stamp: int = 0  # insertion/touch order (LRU eviction key)


class PrefixIndex:
    """Radix tree mapping prompt-token prefixes to cached page chains.

    Granularity is one FULL page per node: a node exists only when every
    one of its ``page_size`` tokens came from a registered prompt, so an
    indexed page is immutable by construction (its owner's decode appends
    land strictly after the prompt span). The index holds one allocator
    reference per node (``retain``); eviction releases it, and the page
    returns to the pool the moment no live slot aliases it.
    """

    def __init__(self, allocator: PageAllocator, page_size: int):
        self.allocator = allocator
        self.page_size = page_size
        self._root: Dict[Tuple[int, ...], _PrefixNode] = {}
        self._clock = 0
        self._nodes = 0
        self.evicted_pages = 0  # cumulative (engine telemetry)

    # -- stats -------------------------------------------------------------
    @property
    def cached_pages(self) -> int:
        return self._nodes

    @property
    def cached_tokens(self) -> int:
        return self._nodes * self.page_size

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # -- lookup ------------------------------------------------------------
    @staticmethod
    def _common(key: Tuple[int, ...], toks) -> int:
        n = 0
        for a, b in zip(key, toks):
            if a != int(b):
                break
            n += 1
        return n

    def lookup(self, prompt) -> Optional[PrefixHit]:
        """Longest cached prefix of ``prompt`` (token ids, 1-D). The hit is
        capped at ``len(prompt) - 1``: a full-to-the-end match converts its
        last page into a COW tail so the final token's logits are always
        recomputed. Returns None when no full page matches (a sub-page hit
        is not worth the gather). Touches matched nodes' LRU stamps."""
        ps = self.page_size
        plen = int(len(prompt))
        cap = plen - 1
        full: List[_PrefixNode] = []
        level = self._root
        off = 0
        tail: Optional[_PrefixNode] = None
        tail_t = 0
        while off < cap:
            rem = cap - off
            node = None
            if rem >= ps:
                node = level.get(tuple(int(x) for x in prompt[off:off + ps]))
            if node is not None:
                full.append(node)
                off += ps
                level = node.children
                continue
            # partial tail: the child sharing the longest leading run
            upto = min(ps, plen - off)
            toks = prompt[off:off + upto]
            for child in level.values():
                t = self._common(child.key, toks)
                if t > tail_t:
                    tail, tail_t = child, t
            tail_t = min(tail_t, rem)
            break
        if not full:
            return None
        now = self._tick()
        for n in full:
            n.stamp = now
        if tail is not None and tail_t > 0:
            tail.stamp = now
            return PrefixHit(off + tail_t, tuple(n.page for n in full),
                             tail.page, tail_t)
        return PrefixHit(off, tuple(n.page for n in full))

    def match_len(self, prompt) -> int:
        """Usable hit length WITHOUT touching LRU stamps or hit counters —
        the routing probe (cluster prefix affinity)."""
        ps = self.page_size
        plen = int(len(prompt))
        cap = plen - 1
        level = self._root
        off = 0
        while off + ps <= cap:
            node = level.get(tuple(int(x) for x in prompt[off:off + ps]))
            if node is None:
                break
            off += ps
            level = node.children
        if not off:
            return 0  # sub-page matches are not taken (see lookup)
        best = 0
        upto = min(ps, plen - off)
        toks = prompt[off:off + upto]
        for child in level.values():
            best = max(best, self._common(child.key, toks))
        return min(off + best, cap)

    # -- registration ------------------------------------------------------
    def register(self, prompt, pages: List[int]) -> int:
        """Insert a prefilled prompt's FULL pages (``pages[i]`` backs tokens
        ``[i*ps, (i+1)*ps)``). Existing nodes are kept — a concurrent
        duplicate prompt does not replace the cached chain — and each new
        node takes one allocator reference. Returns new nodes added."""
        ps = self.page_size
        level = self._root
        added = 0
        for i in range(int(len(prompt)) // ps):
            key = tuple(int(x) for x in prompt[i * ps:(i + 1) * ps])
            node = level.get(key)
            if node is None:
                page = pages[i]
                if page == PageAllocator.TRASH_PAGE:
                    raise ValueError("cannot index the trash page")
                self.allocator.retain(page)
                node = _PrefixNode(key, page, {}, self._tick())
                level[key] = node
                self._nodes += 1
                added += 1
            else:
                node.stamp = self._tick()
            level = node.children
        return added

    # -- eviction ----------------------------------------------------------
    def _leaves(self, level, out):
        for key, node in level.items():
            if node.children:
                self._leaves(node.children, out)
            else:
                out.append((node.stamp, key, node, level))

    def evict(self, n_pages: int) -> int:
        """Free >= ``n_pages`` pool pages by dropping cached chains, oldest
        stamp first, leaves inward. Only nodes whose page no live slot
        references (allocator refcount == 1, the index's own hold) are
        candidates — eviction can NEVER reclaim a page out from under a
        running request. Returns pages actually freed (may fall short)."""
        freed = 0
        while freed < n_pages:
            leaves: List = []
            self._leaves(self._root, leaves)
            cands = sorted((x for x in leaves
                            if self.allocator.refcount(x[2].page) == 1),
                           key=lambda x: x[0])
            if not cands:
                break
            for _, key, node, level in cands:
                if freed >= n_pages:
                    break
                del level[key]
                self._nodes -= 1
                if self.allocator.release(node.page):
                    freed += 1
                    self.evicted_pages += 1
        return freed

    def clear(self) -> int:
        """Drop every cached chain (engine reset): releases the index's
        reference on every node; pages with no live slot return to the
        pool. Returns pages freed."""
        freed = 0
        stack = [self._root]
        while stack:
            level = stack.pop()
            for node in level.values():
                stack.append(node.children)
                if self.allocator.release(node.page):
                    freed += 1
        self._root = {}
        self._nodes = 0
        return freed

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"PrefixIndex(pages={self._nodes}, "
                f"tokens={self.cached_tokens}, evicted={self.evicted_pages})")
