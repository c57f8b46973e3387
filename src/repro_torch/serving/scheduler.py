"""BatchScheduler: dense continuous batching over :class:`DecodeState`.

Twin of the dense path of ``repro/serving/scheduler.py``:

* **admission** -- queued requests splice into free slots mid-flight,
  each prefilled batch-1 through the unfused decode path (the K1 spiking
  linear and K2 SSA-decode kernels on the card);
* **decode** -- one batched step advances every slot through the fused
  layer kernel (K3), once per layer;
* **eviction** -- a finished slot's cache is zeroed.

Per-slot PRN streams ``f(seed, pos)`` make a request's tokens a pure
function of ``(params, prompt, seed)``, never of batch composition.
Paged serving, energy booking, the drift lifecycle and telemetry are not
part of this slice.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.engine import get_backend
from repro_torch.kernels.plan import build_decode_plan
from repro_torch.models import transformer as T
from repro_torch.serving import state as ST


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [P] int64
    max_new: int
    seed: int
    ckeys: np.ndarray  # content keys of the prompt context (prompt[:-1])

    @property
    def n_ctx(self) -> int:
        return len(self.prompt) - 1


@dataclasses.dataclass
class ServeStats:
    requests: int = 0
    decode_steps: int = 0
    decoded_tokens: int = 0
    prefill_tokens: int = 0
    admissions: int = 0
    evictions: int = 0
    wall_s: float = 0.0  # whole serve loop (admission/prefill included)
    decode_s: float = 0.0  # batched decode steps only
    prefill_s: float = 0.0  # batch-1 prefills at admission
    spike_events: float = 0.0  # measured residual-stream spike events
    peak_active_slots: int = 0

    @property
    def tokens_per_sec(self) -> float:
        """Decoded tokens per second of the whole loop (prefill included)."""
        return self.decoded_tokens / max(self.wall_s, 1e-9)

    @property
    def decode_tokens_per_sec(self) -> float:
        """Decoded tokens per second spent inside batched decode steps."""
        return self.decoded_tokens / max(self.decode_s, 1e-9)


class BatchScheduler:
    """Continuous-batching scheduler: submit prompts, run, collect outputs.

    Greedy decoding; a request finishes after ``max_new`` tokens.  Outputs
    land in :attr:`outputs` (rid -> generated token ids).  ``params`` is
    the model tree (float weights, as :func:`repro_torch.models.
    transformer.init_params` or :mod:`repro_torch.convert` make them); the
    scheduler moves it to ``device`` and quantises the spiking linears
    once.  ``device`` defaults to CUDA and raises without it.
    """

    def __init__(self, params: Any, cfg, backend=None, *, slots: int = 4,
                 cache_len: int = 64, decode_kernel: str = "auto",
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the unembed is a float32 matmul: keep it out of TF32
            torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg
        self.backend = get_backend(backend)
        self.slots = slots
        self.cache_len = cache_len
        self.source_params = params
        self.params = T.quantize_params(_to_device(params, self.device), cfg)
        # one plan per scheduler lifetime; prefill always runs unfused
        self.plan = build_decode_plan(cfg, self.backend, kernel=decode_kernel)
        self._decode = ST.make_decode_fn(cfg, self.backend, plan=self.plan)
        self._prefill = ST.make_prefill_fn(cfg, self.backend)
        self.state = ST.init_state(cfg, slots, cache_len, self.device)
        self._queue: Deque[Request] = deque()
        self._slot_req: List[Optional[Request]] = [None] * slots
        self._remaining: List[int] = [0] * slots
        self.outputs: Dict[int, List[int]] = {}
        self.stats = ServeStats()
        self._next_rid = 0

    def reset(self) -> None:
        """Drop all requests and state (a fresh server on the same params)."""
        self.state = ST.init_state(self.cfg, self.slots, self.cache_len,
                                   self.device)
        self._queue.clear()
        self._slot_req = [None] * self.slots
        self._remaining = [0] * self.slots
        self.outputs = {}
        self.stats = ServeStats()

    # -- request intake ------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new: int,
               seed: Optional[int] = None) -> int:
        """Queue a request; returns its rid.  ``seed`` (default: the rid)
        fixes the request's spike PRN stream."""
        p = np.asarray(prompt, np.int64).reshape(-1)
        if p.shape[0] < 1:
            raise ValueError("prompt must hold at least one token")
        if p.min() < 0 or p.max() >= self.cfg.vocab_size:
            # an out-of-range embedding gather would fault on the card
            raise ValueError(f"prompt tokens must lie in [0, "
                             f"{self.cfg.vocab_size})")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if p.shape[0] + max_new > self.cache_len:
            raise ValueError(
                f"prompt ({p.shape[0]}) + max_new ({max_new}) exceeds "
                f"cache_len ({self.cache_len})")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(Request(rid, p, max_new,
                                   rid if seed is None else int(seed),
                                   ST.content_keys(p[:-1])))
        self.stats.requests += 1
        return rid

    # -- slot management -----------------------------------------------

    def admit(self) -> int:
        """Prefill queued requests batch-1 and splice them into free slots;
        the other slots' state is untouched.  Returns #admitted."""
        admitted = 0
        for slot in range(self.slots):
            if not self._queue or self._slot_req[slot] is not None:
                continue
            req = self._queue.popleft()
            t0 = time.perf_counter()
            cache1 = T.init_cache(self.cfg, 1, self.cache_len, self.device)
            ctx = torch.as_tensor(req.prompt[:-1], device=self.device)
            ckeys = torch.as_tensor(req.ckeys.astype(np.int64),
                                    device=self.device)
            cache1, act = self._prefill(self.params, ctx, ckeys, cache1)
            ST.splice_request(self.state, slot, cache1, req.prompt[-1],
                              req.seed)
            spikes = float(act)  # syncs the prefill
            self.stats.prefill_s += time.perf_counter() - t0
            self._slot_req[slot] = req
            self._remaining[slot] = req.max_new
            self.outputs[req.rid] = []
            self.stats.spike_events += spikes
            self.stats.prefill_tokens += req.n_ctx
            self.stats.admissions += 1
            admitted += 1
        self.stats.peak_active_slots = max(
            self.stats.peak_active_slots,
            sum(r is not None for r in self._slot_req))
        return admitted

    def evict(self, slot: int, requeue: bool = False) -> None:
        """Release a slot's state.  With ``requeue=True`` the request
        restarts from its prompt on a later admission.  Evicting an
        unoccupied slot raises."""
        req = self._slot_req[slot]
        if req is None:
            raise ValueError(f"evict of unoccupied slot {slot} "
                             "(double-evict or use-after-evict)")
        if requeue:
            self._queue.appendleft(req)
            self.outputs.pop(req.rid, None)
        self._slot_req[slot] = None
        self._remaining[slot] = 0
        ST.release_slot(self.state, slot)
        self.stats.evictions += 1

    # -- serving loop --------------------------------------------------

    def step(self) -> int:
        """Admit, then advance every active slot one token.  Returns the
        number of tokens decoded (0 when idle)."""
        self.admit()
        if not any(r is not None for r in self._slot_req):
            return 0
        t0 = time.perf_counter()
        _, self.state, act = self._decode(self.params, self.state)
        nxt = self.state.tokens.cpu().numpy()  # syncs the step
        act = act.cpu().numpy()
        self.stats.decode_s += time.perf_counter() - t0
        self.stats.decode_steps += 1
        decoded = 0
        for slot in range(self.slots):
            req = self._slot_req[slot]
            if req is None:
                continue
            self.outputs[req.rid].append(int(nxt[slot]))
            decoded += 1
            self.stats.spike_events += float(act[slot])
            self._remaining[slot] -= 1
            if self._remaining[slot] == 0:
                self.evict(slot)
        self.stats.decoded_tokens += decoded
        return decoded

    def run(self) -> Dict[int, List[int]]:
        """Serve until the queue and all slots drain; returns outputs."""
        t0 = time.perf_counter()
        while self._queue or any(r is not None for r in self._slot_req):
            self.step()
        self.stats.wall_s += time.perf_counter() - t0
        return self.outputs


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
