"""Serving CLI of the port: continuous batching of a spiking GPT.

    python -m repro_torch.launch.serve --arch xpikeformer-gpt-4-256 --requests 8

Serves ``--requests`` synthetic prompts (the reference CLI's prompts:
``randint(fold_in(PRNGKey(seed + 1), i), (4 + 3 * (i % 4),), 0, vocab)``)
with random weights from ``--seed``, on the CUDA kernels by default.
``--smoke`` serves the reduced CPU-test config; ``--device cpu`` runs the
plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import time
from typing import List

import torch

from repro_torch import prng
from repro_torch.engine import XpikeformerEngine


def make_prompts(n: int, vocab: int, seed: int) -> List[List[int]]:
    key = prng.PRNGKey(seed + 1)
    return [prng.randint(prng.fold_in(key, i), (4 + 3 * (i % 4),), 0,
                         vocab).tolist() for i in range(n)]


def serve(arch: str, *, smoke: bool = False, n_requests: int = 8,
          slots: int = 4, max_new: int = 16, cache_len: int = 64,
          seed: int = 0, backend: str = "cuda", decode_kernel: str = "auto",
          device: str = "cuda"):
    eng = XpikeformerEngine.from_config(arch, task="lm", backend=backend,
                                        reduced=smoke, device=device)
    eng.init(seed)
    sch = eng.scheduler(slots=slots, cache_len=cache_len,
                        decode_kernel=decode_kernel)
    print(f"[serve] {eng.cfg.name} on {eng.device} through the "
          f"'{eng.backend.name}' backend; decode kernel: {sch.plan.describe()}")
    prompts = make_prompts(n_requests, eng.cfg.vocab_size, seed)
    rids = [sch.submit(p, max_new, seed=seed + i) for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    outs = sch.run()
    dt = time.perf_counter() - t0
    st = sch.stats
    print(f"[serve] served {st.requests} requests, {st.decoded_tokens} tokens "
          f"in {dt:.2f}s ({st.tokens_per_sec:.1f} tok/s, "
          f"{st.decode_steps} batched decode steps, {st.admissions} admissions)")
    return [outs[r] for r in rids]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="cuda", choices=["cuda", "integer"])
    ap.add_argument("--decode-kernel", default="auto",
                    choices=["auto", "fused", "unfused"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced CPU-test config")
    a = ap.parse_args(argv)
    with torch.no_grad():
        serve(a.arch, smoke=a.smoke, n_requests=a.requests, slots=a.slots,
              max_new=a.max_new, cache_len=a.cache_len, seed=a.seed,
              backend=a.backend, decode_kernel=a.decode_kernel,
              device=a.device)


if __name__ == "__main__":
    main()
