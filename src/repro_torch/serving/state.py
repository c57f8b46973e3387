"""Serving state: the dense :class:`DecodeState` and the block-paged
:class:`PagedDecodeState`, their surgery helpers, and the step factories.

Twin of ``repro/serving/state.py``.  Dense: the cache keeps one
fixed-length region per slot; admission copies a prefilled batch-1 cache
into a slot, eviction zeroes it, which also masks the slot out of the
spiking comparators.  Paged: K/V spike trains live in a global page pool
and each slot addresses its logical blocks through a row of the page
table; pages are refcounted on the host
(:class:`repro_torch.serving.pages.PagePool`).  Physical page 0 is the
permanently zero *null page* (unallocated table entries read as zero
spikes) and page 1 the *trash page* idle slots write into (never in a
table).  Every tensor keeps one shape for the server's lifetime.  Where
the reference returns new arrays, these functions update the state **in
place** and return it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.models import transformer as T

Tensor = torch.Tensor

# reserved physical pages of every paged pool
NULL_PAGE = 0  # permanently zero; the target of unallocated table entries
TRASH_PAGE = 1  # where idle slots' decode writes land; never read
RESERVED_PAGES = 2


@dataclasses.dataclass
class DecodeState:
    """One continuous batch: model cache + per-slot serving counters.

    cache   -- model cache tree (per-slot ``pos`` counters inside leaves)
    tokens  -- [slots] int64, next input token per slot
    seeds   -- [slots] int64 holding uint32 PRN stream ids
    """

    cache: Any
    tokens: Tensor
    seeds: Tensor


def init_state(cfg, slots: int, cache_len: int, device,
               kv_heads: Optional[int] = None) -> DecodeState:
    """A fresh dense batch of ``slots`` (a mesh rank: its own slots and
    ``kv_heads``)."""
    return DecodeState(
        cache=T.init_cache(cfg, slots, cache_len, device, kv_heads),
        tokens=torch.zeros(slots, dtype=torch.int64, device=device),
        seeds=torch.zeros(slots, dtype=torch.int64, device=device),
    )


def _map_cache(cache, f_periods, f_remainder, *rest):
    """Apply ``f(leaf, *rest_leaves)`` over the cache; ``periods`` leaves
    carry a leading period axis, ``remainder`` leaves do not."""
    def walk(tree, others, f):
        if isinstance(tree, dict):
            return {k: walk(v, [o[k] for o in others], f) for k, v in tree.items()}
        return f(tree, *others)

    out = {}
    if "periods" in cache:
        out["periods"] = walk(cache["periods"], [r["periods"] for r in rest],
                              f_periods)
    if "remainder" in cache:
        out["remainder"] = walk(cache["remainder"],
                                [r["remainder"] for r in rest], f_remainder)
    return out


def slot_splice(cache, one, slot: int) -> None:
    """Copy a batch-1 cache into slot ``slot`` of the batched cache."""
    def p(a, o):
        a[:, slot] = o[:, 0]

    def r(a, o):
        a[slot] = o[0]

    _map_cache(cache, p, r, one)


def slot_zero(cache, slot: int) -> None:
    """Zero one slot's cache leaves (state release: pos=0, spike trains=0)."""
    def p(a):
        a[:, slot] = 0

    def r(a):
        a[slot] = 0

    _map_cache(cache, p, r)


def splice_request(state: DecodeState, slot: int, cache1, token: int,
                   seed: int) -> DecodeState:
    """Admit a prefilled request into ``slot`` (continuous-batching splice)."""
    slot_splice(state.cache, cache1, slot)
    state.tokens[slot] = int(token)
    state.seeds[slot] = int(seed) & 0xFFFFFFFF
    return state


def release_slot(state: DecodeState, slot: int) -> DecodeState:
    """Evict: zero the slot's cache and mark it free."""
    slot_zero(state.cache, slot)
    state.tokens[slot] = 0
    state.seeds[slot] = 0
    return state


# ---------------------------------------------------------------------------
# Block-paged serving state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PagedDecodeState:
    """One paged continuous batch: global page pool + per-slot counters.

    pool        -- page pool tree (``kp``/``vp [.., n_pages, T, KV,
                   page_len, hd]`` leaves; no slot axis)
    page_table  -- [slots, max_pages] int32 physical page per logical block
                   (NULL_PAGE = unallocated: reads as zero spikes)
    pos         -- [slots] int32, each slot's next logical write position
    tokens      -- [slots] int64, next input token per slot
    seeds       -- [slots] int64 holding uint32 PRN stream ids
    active      -- [slots] bool, slot occupancy
    """

    pool: Any
    page_table: Tensor
    pos: Tensor
    tokens: Tensor
    seeds: Tensor
    active: Tensor

    def leaves(self):
        """The pool's ``kp``/``vp`` tensors (page axis at -5)."""
        return [leaf for grp in self.pool.values() for blk in grp.values()
                for leaf in blk.values()]


def init_paged_state(cfg, slots: int, cache_len: int, page_len: int,
                     n_pages: int, device, kv_heads: Optional[int] = None
                     ) -> PagedDecodeState:
    """A fresh paged batch: all pages free and zeroed, all tables null (a
    mesh rank: its own slots' tables, the whole pool of its
    ``kv_heads``)."""
    if cache_len % page_len:
        raise ValueError(f"cache_len ({cache_len}) must be a multiple of "
                         f"page_len ({page_len})")
    if n_pages <= RESERVED_PAGES:
        raise ValueError("the pool needs pages beyond null + trash")
    return PagedDecodeState(
        pool=T.init_paged_pool(cfg, n_pages, page_len, device, kv_heads),
        page_table=torch.full((slots, cache_len // page_len), NULL_PAGE,
                              dtype=torch.int32, device=device),
        pos=torch.zeros(slots, dtype=torch.int32, device=device),
        tokens=torch.zeros(slots, dtype=torch.int64, device=device),
        seeds=torch.zeros(slots, dtype=torch.int64, device=device),
        active=torch.zeros(slots, dtype=torch.bool, device=device),
    )


def paged_admit_slot(state: PagedDecodeState, slot: int, table_row,
                     seed: int, pos: int) -> PagedDecodeState:
    """Open a slot: install its page-table row (prefix hits filled in) and
    its starting position (the first prompt position not covered by a
    hit); the scheduler feeds tokens and PRN stream ids per step."""
    state.page_table[slot] = torch.as_tensor(table_row, dtype=torch.int32)
    state.pos[slot] = int(pos)
    state.seeds[slot] = int(seed) & 0xFFFFFFFF
    state.active[slot] = True
    return state


def paged_release_slot(state: PagedDecodeState, slot: int
                       ) -> PagedDecodeState:
    """Close a slot: null its table row and zero its counters.  (The host
    :class:`~repro_torch.serving.pages.PagePool` decides which of its pages
    are freed: shared pages live on under other references.)"""
    state.page_table[slot] = NULL_PAGE
    state.pos[slot] = 0
    state.tokens[slot] = 0
    state.seeds[slot] = 0
    state.active[slot] = False
    return state


def paged_set_table_entry(state: PagedDecodeState, slot: int, idx: int,
                          pid: int) -> PagedDecodeState:
    """Point one logical block of one slot at a physical page."""
    state.page_table[slot, idx] = int(pid)
    return state


def pool_zero_pages(state: PagedDecodeState, pids) -> PagedDecodeState:
    """Zero physical pages (freed pages must read as zero spikes before
    reuse)."""
    for leaf in state.leaves():
        idx = torch.as_tensor(pids, dtype=torch.int64, device=leaf.device)
        leaf.index_fill_(leaf.dim() - 5, idx, 0)
    return state


def pool_copy_page(state: PagedDecodeState, src: int, dst: int,
                   keep_upto: int) -> PagedDecodeState:
    """Copy-on-write: duplicate page ``src`` into ``dst``, keeping only
    in-page positions ``< keep_upto`` (later offsets are zeroed so the new
    owner's unwritten tail stays comparator-masked)."""
    for leaf in state.leaves():
        page = leaf.select(-5, int(src))  # [.., T, KV, page_len, hd]
        keep = (torch.arange(page.shape[-2], device=leaf.device)
                < int(keep_upto))[:, None]
        leaf.select(-5, int(dst)).copy_(page * keep)
    return state


def exchange_page_writes(state: PagedDecodeState, write_pids: Tensor,
                         offsets: Tensor, own: slice,
                         reduce: Callable[[Tensor], Tensor]) -> None:
    """Make a step's K/V writes whole on every replica of the pool (a data
    group of a mesh, each rank having written only its own slots ``own``):
    each rank puts its slots' new rows ``pool[write_pids[b], ..., offsets
    [b], :]`` into a zero buffer over all slots, ``reduce`` sums the
    buffers over the group (one rank fills each slot: exact), and every
    replica writes every slot's row.  Idle slots write the trash page."""
    pids = write_pids.to(torch.int64)
    offs = offsets.to(torch.int64)
    for leaf in state.leaves():
        view = leaf.movedim(-5, 0).movedim(-2, 1)  # [P, page_len, ..., hd]
        buf = torch.zeros((pids.shape[0],) + tuple(view.shape[2:]),
                          dtype=torch.float32, device=leaf.device)
        buf[own] = view[pids[own], offs[own]].to(torch.float32)
        reduce(buf)
        view[pids, offs] = buf.to(leaf.dtype)


# ---------------------------------------------------------------------------
# Content-keyed prefill PRN streams
# ---------------------------------------------------------------------------


def _splitmix32(x: int) -> int:
    """32-bit splitmix finaliser (int -> int in [0, 2^32), well-mixed)."""
    x = (x + 0x9E3779B9) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x21F0AAAD) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x735A2D97) & 0xFFFFFFFF
    x ^= x >> 15
    return x


def content_keys(tokens) -> np.ndarray:
    """Per-position *content* PRN stream ids for prompt prefill:
    ``key[i] = H(tokens[0..i])``, a rolling hash chain, so prefill spike
    randomness depends only on the token prefix and the position."""
    toks = np.asarray(tokens, np.int64)
    out = np.empty(toks.shape[0], np.uint32)
    h = 0x1C0FFEE5
    for i, t in enumerate(toks):
        h = _splitmix32(h ^ _splitmix32(int(t) & 0xFFFFFFFF))
        out[i] = h
    return out


# ---------------------------------------------------------------------------
# Step factories
# ---------------------------------------------------------------------------


def make_decode_fn(cfg, backend, plan=None, moe_impl: str = "ep_a2a",
                   pctx=None):
    """The batched decode step: ``(params, state) -> (logits [slots,1,V],
    state, activity [slots])``.  Every slot advances one token (greedy
    argmax written back into ``state.tokens``); ``plan`` picks the fused
    layer kernel or the unfused primitives; ``moe_impl`` a float stack's
    MoE path, and ``pctx`` (:class:`repro_torch.models.moe.ParallelCtx`)
    its placement on a mesh."""

    def step(params, state: DecodeState):
        logits, _, act = T.decode_step(
            params, state.cache, state.tokens[:, None], cfg, backend=backend,
            seeds=state.seeds, with_activity=True, plan=plan,
            moe_impl=moe_impl, pctx=pctx)
        state.tokens = torch.argmax(logits[:, 0, :], dim=-1)
        return logits, state, act

    return step


def make_prefill_fn(cfg, backend, moe_impl: str = "ep_a2a", pctx=None):
    """Batch-1 prompt prefill through the same decode path, with **no**
    plan (the unfused primitives, as in the reference).

    On a mesh every data rank prefills the prompt, and a MoE block routes
    its one token over the rank's model group (``pctx``): the dispatch the
    reference computes on a ``(1, model)`` mesh.  The reference cannot
    split a batch of one over ``data > 1`` (its ``shard_map`` raises), so
    this is the port's definition of that path; its tokens equal one
    device's wherever no choice drops.

    ``(params, prompt [n], seeds [n], cache1) -> (cache1, activity)``:
    one decode step per prompt position, position ``i`` keyed by the
    content key ``seeds[i]``.  The reference scans a power-of-two padded
    prompt and discards the padded steps; eager PyTorch runs only the
    ``n`` real ones, with the same result."""

    def prefill(params, prompt: Tensor, seeds: Tensor, cache1):
        act = torch.zeros((), dtype=torch.float32, device=prompt.device)
        for i in range(prompt.shape[0]):
            _, cache1, a = T.decode_step(
                params, cache1, prompt[i].view(1, 1), cfg, backend=backend,
                seeds=seeds[i].view(1), with_activity=True,
                moe_impl=moe_impl, pctx=pctx)
            act = act + a[0]
        return cache1, act

    return prefill


def make_paged_decode_fn(cfg, backend, plan=None):
    """The batched step of a *paged* server: decode and chunked prefill
    ride the same step.

    ``(params, state, feed_tok [B], feed_seed [B], feed_mask [B],
    write_pids [B]) -> (logits, state, activity)``.  Slots with
    ``feed_mask`` take their input token and PRN stream id from the feed
    (chunked prefill: the next prompt token keyed by its content key;
    admission handoff: the last prompt token keyed by the request seed);
    the others ride the state (greedy next token written back).
    ``write_pids`` names each slot's private physical page for this step's
    K/V write (the scheduler guarantees sole ownership by copy-on-write;
    idle slots point at the trash page).  The fed seed persists into
    ``state.seeds``, so after the handoff a slot keeps decoding on its
    request stream with no further feeds."""

    def step(params, state: PagedDecodeState, feed_tok, feed_seed, feed_mask,
             write_pids):
        tok = torch.where(feed_mask, feed_tok, state.tokens)
        seed = torch.where(feed_mask, feed_seed, state.seeds)
        logits, _, act = T.paged_decode_step(
            params, state.pool, state.page_table, tok[:, None], state.pos,
            seed, write_pids, cfg, backend=backend, plan=plan)
        state.pos += 1
        state.tokens = torch.argmax(logits[:, 0, :], dim=-1)
        state.seeds = seed
        return logits, state, act

    return step
