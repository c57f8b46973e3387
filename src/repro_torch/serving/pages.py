"""PagePool: host-side accounting for the block-paged spike-train KV cache.

Twin of ``repro/serving/pages.py`` (the original imports the reference's
serving state, so it is ported rather than imported).  The device side of
paged serving is a zero-initialised page pool plus per-slot page tables
(:class:`repro_torch.serving.state.PagedDecodeState`); everything stateful
lives here, in O(pages) host bookkeeping:

* **free list + refcounts** -- a page is writable iff its refcount is 1;
  releasing the last reference frees it (the scheduler zeroes freed pages
  on the device before reuse).  Double free and use after free raise,
  after calling :attr:`PagePool.on_violation` (the flight recorder's dump
  site, :mod:`repro_torch.obs`).
* **prefix cache** -- an exact-match LRU map from *chained block keys* to
  physical pages: a full prompt block is keyed by ``(parent chain id, its
  own page_len tokens)``, the parent id naming the cache entry of the
  preceding block (0 = the empty prefix), so a hit proves the whole token
  prefix matches link by link.  Chain ids are never reused.  Prefill spike
  randomness is keyed by (content, position)
  (:func:`repro_torch.serving.state.content_keys`), so a hit is
  bit-identical sharing.  The cache holds its own reference on every
  registered page; under pool pressure, LRU entries whose pages are
  cache-only (refcount 1) are dropped to free pages.
* **reservations** -- admission reserves a request's worst-case page need
  up front, so running slots never wait for a page: admission blocks on
  free pages, running slots never do.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.serving.state import NULL_PAGE, RESERVED_PAGES, TRASH_PAGE


class PagePool:
    """Refcounted physical-page accounting + exact-prefix page cache."""

    def __init__(self, n_pages: int, page_len: int):
        if n_pages <= RESERVED_PAGES:
            raise ValueError(
                f"n_pages ({n_pages}) must exceed the {RESERVED_PAGES} "
                "reserved pages (null + trash)")
        self.n_pages = n_pages
        self.page_len = page_len
        self.refcount = np.zeros(n_pages, np.int32)
        self.refcount[NULL_PAGE] = self.refcount[TRASH_PAGE] = 1  # immortal
        self._free: List[int] = list(range(n_pages - 1, RESERVED_PAGES - 1, -1))
        self._reserved = 0
        # chained-block key -> (page id, chain id | None); insertion order
        # is the LRU order
        self._prefix: "OrderedDict[Tuple, Tuple[int, Optional[int]]]" = \
            OrderedDict()
        self._next_chain = 1
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.cow_copies = 0
        self.peak_in_use = 0
        # invariant-guard hook: called with the violation message right
        # before a double-free / use-after-free raise, so a flight recorder
        # can dump a postmortem while its rings still hold the events that
        # led here.  The raise always proceeds.
        self.on_violation: Optional[Callable[[str], None]] = None

    def _violate(self, msg: str) -> str:
        if self.on_violation is not None:
            self.on_violation(msg)
        return msg

    # -- capacity -------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.n_pages - RESERVED_PAGES - len(self._free)

    def available(self) -> int:
        """Pages allocatable without eating someone else's reservation."""
        return len(self._free) - self._reserved

    def reserve(self, n: int) -> None:
        if n > self.available():
            raise RuntimeError(
                f"page reservation of {n} exceeds available {self.available()}")
        self._reserved += n

    def unreserve(self, n: int) -> None:
        if not 0 <= n <= self._reserved:
            raise RuntimeError("unbalanced page reservation")
        self._reserved -= n

    # -- alloc / refcount ----------------------------------------------

    def alloc(self, *, reserved: bool = False) -> int:
        """Take a free (zeroed) page; ``reserved=True`` consumes one unit of
        the caller's prior :meth:`reserve`."""
        if not self._free:
            raise RuntimeError("page pool exhausted (reservation bug?)")
        if reserved:
            self.unreserve(1)
        pid = self._free.pop()
        self.refcount[pid] = 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return pid

    def retain(self, pid: int) -> None:
        """Add a reference to a live page (prefix hit / registration)."""
        if pid in (NULL_PAGE, TRASH_PAGE):
            raise ValueError(self._violate(f"cannot retain reserved page {pid}"))
        if self.refcount[pid] <= 0:
            raise ValueError(
                self._violate(f"retain of dead page {pid} (use-after-free)"))
        self.refcount[pid] += 1

    def release(self, pid: int) -> bool:
        """Drop a reference; True when the page became free (the caller
        zeroes it on the device before reuse).  Releasing a free page
        raises: the double-free guard."""
        if pid in (NULL_PAGE, TRASH_PAGE):
            raise ValueError(
                self._violate(f"cannot release reserved page {pid}"))
        if self.refcount[pid] <= 0:
            raise ValueError(self._violate(f"double free of page {pid}"))
        self.refcount[pid] -= 1
        if self.refcount[pid] == 0:
            self._free.append(int(pid))
            return True
        return False

    # -- prefix cache ---------------------------------------------------

    def prefix_lookup(self, key: Tuple) -> Optional[Tuple[int, Optional[int]]]:
        """Look a chained block key up; on a hit, retain the page for the
        caller, refresh the entry's LRU position and return ``(page id,
        chain id)`` (the chain id keys the next block's lookup)."""
        ent = self._prefix.get(key)
        if ent is None:
            self.prefix_misses += 1
            return None
        self._prefix.move_to_end(key)
        self.retain(ent[0])
        self.prefix_hits += 1
        return ent

    def prefix_register(self, key: Tuple, pid: int, *,
                        chain: bool = False) -> Optional[int]:
        """Publish a pristine page under a chained block key (the cache
        takes its own reference) and return the entry's chain id
        (``chain=True`` mints one for full blocks; partial tails are
        leaves).  An already cached key retains nothing and returns the
        existing chain id, so the caller's chain stays canonical."""
        ent = self._prefix.get(key)
        if ent is not None:
            return ent[1]
        self.retain(pid)
        cid = None
        if chain:
            cid = self._next_chain
            self._next_chain += 1
        self._prefix[key] = (int(pid), cid)
        return cid

    def prefix_evict(self, need: int) -> List[int]:
        """Drop LRU prefix entries until ``need`` pages are freed (only
        cache-only pages free; shared ones live on under their slots).
        Returns the freed page ids, for the caller to zero on the device."""
        freed: List[int] = []
        while len(freed) < need and self._prefix:
            _, (pid, _) = self._prefix.popitem(last=False)
            if self.release(pid):
                freed.append(pid)
        return freed

    def prefix_contains(self, key: Tuple) -> bool:
        return key in self._prefix

    def prefix_len(self) -> int:
        return len(self._prefix)
