"""Xpikeformer-GPT on in-context MIMO symbol detection (Sec. VI Task 2).

    python -m repro_torch.examples.icl_symbol_detection            # quick
    python -m repro_torch.examples.icl_symbol_detection --paper    # 4-256
    python -m repro_torch.examples.icl_symbol_detection --backend cuda

A twin of ``examples/icl_symbol_detection.py``: trains the decoder-only
spiking transformer on the ICL data twin (:mod:`repro_torch.data.
icl_mimo`) with the paper's two-stage recipe (CT, then HWAT for a fifth
of the steps) on the float reference backend, programs the weights onto
simulated PCM (:func:`repro_torch.train.hwat.train_and_program`, key
``PRNGKey(42)``), and reports the bit error rate on 512 held-out
sequences at deployment (t = 0) and after one year of conductance drift,
without and with GDC, on the backend of your choice.  Every backend runs
the programmed lifecycle: ``reference`` the analog simulation (drift,
read noise, ADC), ``integer`` / ``cuda`` (alias ``pallas``) the drifted
int8 image (K6 folds it on the card; K1 and K8 run the forward).  Runs on
the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import torch

from repro_torch import prng
from repro_torch.core.aimc import AIMCConfig
from repro_torch.core.spiking_transformer import SpikingConfig, init_gpt
from repro_torch.data.icl_mimo import MIMOConfig, ber, sample_batch
from repro_torch.engine import XpikeformerEngine
from repro_torch.train.hwat import data_seed, model_forward, train_and_program

YEAR_S = 3.15e7


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paper", action="store_true",
                    help="paper-scale 4-256 model")
    ap.add_argument("--antennas", type=int, default=2, choices=[2, 4])
    ap.add_argument("--T", type=int, default=6)
    ap.add_argument("--steps", type=int, default=0,
                    help="CT steps (default 250; 1500 with --paper)")
    ap.add_argument("--backend", default="reference",
                    choices=["reference", "integer", "cuda", "pallas"],
                    help="compute backend for deployment-time inference")
    ap.add_argument("--eval-batch", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    mcfg = MIMOConfig(n_tx=args.antennas, n_rx=args.antennas)
    depth, dim, steps = (4, 256, 1500) if args.paper else (2, 96, 250)
    steps = args.steps or steps
    gcfg = SpikingConfig(depth=depth, dim=dim, num_heads=max(dim // 64, 2),
                         T=args.T, mode="ssa", input_dim=mcfg.feat_dim,
                         vocab=mcfg.n_classes)
    acfg = AIMCConfig()
    print(f"Xpikeformer-GPT {depth}-{dim}, T={args.T}, {args.antennas}x"
          f"{args.antennas} antennas ({mcfg.n_classes} classes), {steps} CT "
          "steps")
    params = init_gpt(gcfg, 0, args.device)
    dev = params["head"]["w"].device

    def data(k):
        return sample_batch(data_seed(k), mcfg, 64, dev)

    t0 = time.time()
    hw, curves = train_and_program(
        params, model_forward(gcfg, "gpt"), data, ct_steps=steps,
        hwat_steps=steps // 5, program_key=prng.PRNGKey(42), aimc_cfg=acfg,
        lr=2e-3, log_every=max(steps // 10, 1))
    print(f"trained in {time.time() - t0:.0f}s; CT loss "
          f"{curves['ct'][0]:.3f}->{curves['ct'][-1]:.3f}")

    test = sample_batch(777, mcfg, args.eval_batch, dev)
    backend = {"pallas": "cuda"}.get(args.backend, args.backend)
    out = {"ct_first": curves["ct"][0], "ct_last": curves["ct"][-1]}
    for label, t, gdc in (("deploy (t=0)", 0.0, True),
                          ("1 year, no GDC", YEAR_S, False),
                          ("1 year, GDC", YEAR_S, True)):
        eng = XpikeformerEngine.from_config(gcfg, task="gpt", backend=backend,
                                            wmode="hw", aimc_cfg=acfg,
                                            device=dev)
        eng.params = hw
        if t > 0:  # the device lifecycle: age the PCM state, optionally GDC
            eng.drift_to(t)
            if gdc:
                eng.recalibrate()
        with torch.no_grad():
            logits = eng.forward(test["features"], prng.PRNGKey(5))
        b = float(ber(logits, test["labels"], test["mask"], mcfg))
        out[label] = b
        print(f"  BER [{label:16s}, {backend}] = {b:.4f}")
    return out


if __name__ == "__main__":
    main()
