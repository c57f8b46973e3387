"""Dense serving state: :class:`DecodeState`, slot surgery, step factories.

Twin of the dense half of ``repro/serving/state.py`` (lines 52-187 and
365-437).  The cache keeps one fixed-length region per slot; admission
copies a prefilled batch-1 cache into a slot, eviction zeroes it, which
also masks the slot out of the spiking comparators.  Every tensor keeps
one shape for the server's lifetime.  Where the reference returns new
arrays, these functions update the state **in place** and return it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.models import transformer as T

Tensor = torch.Tensor


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


def init_state(cfg, slots: int, cache_len: int, device) -> DecodeState:
    return DecodeState(
        cache=T.init_cache(cfg, slots, cache_len, device),
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


def make_decode_fn(cfg, backend, plan=None):
    """The batched decode step: ``(params, state) -> (logits [slots,1,V],
    state, activity [slots])``.  Every slot advances one token (greedy
    argmax written back into ``state.tokens``); ``plan`` picks the fused
    layer kernel or the unfused primitives."""

    def step(params, state: DecodeState):
        logits, _, act = T.decode_step(
            params, state.cache, state.tokens[:, None], cfg, backend=backend,
            seeds=state.seeds, with_activity=True, plan=plan)
        state.tokens = torch.argmax(logits[:, 0, :], dim=-1)
        return logits, state, act

    return step


def make_prefill_fn(cfg, backend):
    """Batch-1 prompt prefill through the same decode path, with **no**
    plan (the unfused primitives, as in the reference).

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
                seeds=seeds[i].view(1), with_activity=True)
            act = act + a[0]
        return cache1, act

    return prefill
