"""Spiking-ViT image classification (Sec. VI Task 1, reduced scale).

    python -m repro_torch.examples.image_classify [--mode ann|lif|ssa] [--T 8]
    python -m repro_torch.examples.image_classify --backend cuda
    python -m repro_torch.examples.image_classify --device cpu --steps 20

A twin of ``examples/image_classify.py``: trains a ViT on the procedural
image data (:mod:`repro_torch.data.synthetic_images`) in the chosen
attention mode with the paper's two-stage recipe (CT, then HWAT for an
eighth of the steps; :mod:`repro_torch.train.hwat`) on the float
reference backend, then reports accuracy on 512 held-out images through
:class:`repro_torch.engine.XpikeformerEngine` on the backend of your
choice (``reference``; ``integer`` / ``cuda``, alias ``pallas``: the
bit-exact digital datapath, K1 and K8 on the card).  Runs on the card
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import torch

from repro_torch import prng
from repro_torch.core.spiking_transformer import SpikingConfig, init_vit
from repro_torch.data.synthetic_images import ImageConfig, sample_batch
from repro_torch.engine import XpikeformerEngine
from repro_torch.train.hwat import data_seed, model_forward, two_stage_train


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="ssa", choices=["ann", "lif", "ssa"])
    ap.add_argument("--backend", default="reference",
                    choices=["reference", "integer", "cuda", "pallas"],
                    help="compute backend for the final evaluation")
    ap.add_argument("--T", type=int, default=8)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--eval-batch", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    icfg = ImageConfig(size=16)
    vcfg = SpikingConfig(depth=args.depth, dim=args.dim, num_heads=2,
                         T=args.T, mode=args.mode, image_size=icfg.size,
                         patch_size=4)
    print(f"ViT {args.depth}-{args.dim} mode={args.mode} T={args.T}")
    params = init_vit(vcfg, 0, args.device)
    dev = params["head"]["w"].device
    fwd = model_forward(vcfg, "vit")

    def data(k):
        return sample_batch(data_seed(k), icfg, args.batch, dev)

    params, curves = two_stage_train(params, fwd, data, ct_steps=args.steps,
                                     hwat_steps=args.steps // 8, lr=3e-3,
                                     log_every=max(args.steps // 10, 1))
    b = sample_batch(99, icfg, args.eval_batch, dev)
    backend = {"pallas": "cuda"}.get(args.backend, args.backend)
    eng = XpikeformerEngine.from_config(vcfg, task="vit", backend=backend,
                                        wmode="hwat", device=dev)
    eng.params = params
    with torch.no_grad():
        preds = eng.classify(b["images"], prng.PRNGKey(3))
    acc = float(torch.mean((preds == b["labels"]).to(torch.float32)))
    print(f"accuracy[{backend}] = {acc:.3f}")
    return {"accuracy": acc, "ct_first": curves["ct"][0],
            "ct_last": curves["ct"][-1]}


if __name__ == "__main__":
    main()
