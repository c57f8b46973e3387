#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. **device and build** -- the card (``nvidia-smi`` name and power limit)
   and the ``nvcc`` build of the Hopper kernels from
   ``src/repro_torch/kernels/csrc`` (all sources compile in parallel).
2. **kernels** -- K1 ``aimc_spiking_linear``, K2 ``ssa_decode``, K3
   ``fused_decode_layer``, K7 ``ssa_decode_paged`` and K9
   ``fused_decode_layer_paged`` against their plain PyTorch versions on the
   card, at the serving path's widths (``d=256``, ``H=KV=4``, ``hd=64``,
   ``T=4``, ``B=8`` slots, ``L=256``; paged: ``page_len=8``, 32 table
   columns holding null pages, a shared prefix page and an idle slot
   writing the trash page) and at padding (``hd=16``, ``L=24``, ``B=3``;
   paged ``page_len=5``), GQA and ``pos >= L`` edges.  K2 twice: its
   keyed entry (the serving path's: the draws made in the kernel from the
   slot keys, the cache read through the permuted view, scores up to each
   slot's ``pos``) at the dense prefill row (``pos`` =
   :data:`PREFILL_POS`, the row the kernels line reads), at three slots
   of distinct ``pos``, at a head offset and without ``pos``; and its
   given-draws entry at the prefill shape and the padding edge.  Outputs must be
   exactly equal.  Each kernel and its plain version are timed with CUDA
   events (runs of 20 back-to-back calls, median of 9 runs after warm-up).
   K3 and K9 are also checked at one slot and at 32 (256 clusters of 8
   blocks), and their rows carry the kernel's own device time a launch
   (``device_ms``, torch.profiler: ``ms`` is the host's issue rate where
   that is slower), the plan's cluster size and grid beside where one
   launch's blocks ran as the hardware reports it (each block writes its
   ``%smid``, ``%cluster_nctarank`` and ``%clusterid.x``: the cluster size,
   the clusters, the blocks, the distinct SMs and the most blocks one SM
   took), the wrapper's host microseconds a call and the bare ``ctypes``
   launch's;
   their bound counts only what these inputs need (cached key rows below
   ``pos``, the value rows whose score spiked); so do the keyed K2's and
   K7's, which read no draws, and their rows carry the profiler's device
   time, the wrapper's host microseconds and the bare launch's, as K4's
   rows do.  K7 twice too: its keyed entry (the unfused paged path's: draws
   in the kernel, q and out in the caller's layout, scores up to each
   slot's write position) at the paged decode shape, at pos 0, mid-page,
   ``L - 1``, ``L`` and past it, GQA with ``page_len=5`` and a head
   offset, and without ``pos``; its given-draws entry at the paged shape
   and the padding edge.
3. **serve** -- the full-width ``xpikeformer-gpt-4-256`` (random weights
   from a seed) served by ``BatchScheduler(slots=8, cache_len=256)``: 16
   requests, prompts of 8-32 tokens, 32 new tokens each, submitted in
   waves so that admissions land mid-flight.  The launch counters must
   show K3 once per layer and decode step and K1/K2 on every prefill
   position, and a profiled prefill position fewer than 2,000 kernels
   (the keyed K2 draws on the card); the same requests served through the plain versions on the
   card (``IntegerBackend``) must give the same token streams, and the
   reduced config on the card the tokens of the CPU.
4. **paged serve** -- the same model on ``BatchScheduler(slots=8,
   cache_len=256, paged=True, page_len=8)`` (258 pages): 16 requests of
   8-32 prompt tokens and 32 new tokens, submitted 4 every 8 steps; eight
   share a 16-token system prompt (two full pages) and two pairs share a
   12-token context (a partial page: copy-on-write).  K9 must run once per
   layer and step and K1/K2/K3/K7 never; the prefix cache must hit and
   copy on write; the tokens must equal the dense port's and the plain
   backend's paged tokens.  A paged run under the unfused plan on four of
   the requests must launch K7 once per layer and step and give the same
   tokens, and three profiled steps of 8 busy slots on that plan fewer
   than 2,000 kernels a step (the keyed K7 draws on the card).
   **front_door** -- the serving front door and its telemetry
   (``repro_torch.server``, ``repro_torch.obs``) over the same model, dense
   then paged.  (a) Phase 3's / 4's requests served again the same way
   with a telemetry bundle attached (metrics, tracer, flight recorder; no
   profiler), then detached: the tokens, every request's metered joules
   and every kernel's launches must equal the direct run's both times.
   It prints tokens/s and ``decode_step_ms`` of the three runs (phase
   3/4's without telemetry, with, without), ``obs_overhead_rel`` (with
   over the run without that follows it) beside the two runs without
   telemetry's spread, and the host seconds the telemetry itself took
   (every trace event and per-step hook timed).  (b) The same requests
   through ``HttpFrontDoor`` on 127.0.0.1, all at once, as three tenants:
   ``interactive`` at priority 0, ``batch`` and ``metered`` at 1;
   ``metered`` holds a joule bucket of a quarter of its cheapest
   request's metered energy, ``preempt=True`` and no refill until its
   first preemption, when an operator loop turns on a refill of 50 times
   the direct run's joules a second.  Every SSE stream must equal the
   direct run's stream token for token; the metered tenant, and only it,
   must be preempted and re-admitted; every other request must book the
   direct run's joules exactly (paged: where its prefix-cache hits equal
   the direct run's); K3 (dense, and K1/K2 a prefill position) / K9
   (paged) must run on every step; a ``GET /metrics`` scrape mid-run and
   after must parse, the latter's ``decoded_tokens_total`` and
   ``energy_joules_total`` equal to ``ServeStats``.  The run's telemetry
   holds a ``StepProfiler(3)`` window over decode steps 1-3, opened and
   closed in the pump thread (the ``--http --profile-steps`` path): it
   must end ``done`` and its Chrome trace hold 4 K3 (dense) / K9 (paged)
   launches a step.  It prints TTFT p50/p99 and tokens/s through HTTP
   beside the direct run's (and less the window's own host seconds), and
   the admission records' counts.
   **lm_forward** -- the LM stack's full-sequence forward:
   ``xpikeformer-gpt-4-256`` (4 layers, ``d=256``, 4 heads of 64,
   ``d_ff=1024``, vocab 64, ``T=4``) and ``xpikeformer-gpt-8-512`` (8
   layers, ``d=512``, 8 heads) at full width, random weights from a seed,
   ``engine.forward(task="lm")`` on tokens ``[8, 256]`` and ``loss_fn`` on
   ``[8, 257]`` (N = 256, the serve's ``cache_len``): K1 six times and the
   keyed K8 (causal) once a layer and nothing else, logits and loss equal
   to ``IntegerBackend``'s on the card bit for bit; the unprofiled median
   wall of 5 forwards, one profiled forward (kernels, busy, idle share)
   and the loss.
5. **paper forward** -- the paper's spiking ViT ``xpikeformer-vit-4-384``
   on a batch of 64 images of the ``synthetic_images`` twin, and its
   spiking GPT ``xpikeformer-gpt-4-256`` on 64 ICL sequences of 37 tokens
   of the ``icl_mimo`` twin (random weights from a seed), through
   ``XpikeformerEngine.forward`` on the kernels and on the plain versions
   (``IntegerBackend``) on the card, from the same params and key: the
   logits must be bitwise equal and the labels equal, with K8 once per
   block through its keyed entry (the comparators drawn in the kernel, the
   heads read and written in place; no given-draws launch) and K1 six
   times per block; a reduced config (2 blocks) on the card must give
   the CPU's labels and logits within 1e-4.  Each forward reports the
   comparators its K8 tiles hold, need (a count above zero) and draw (warp
   words with a lane that counts), from the operands its blocks hand the
   backend.  Each model also runs the paper's baseline rows on the same
   weights and inputs, ``mode="lif"`` (the LIF attention: K1 six times a
   block, no K8) and ``mode="ann"`` (the float transformer: no kernel),
   whose logits must equal the plain backend's; each prints its wall.
   Then ``Backend.lif`` (K4) on the ViT's widest pre-activation shape,
   equal to the plain version.

6. **drift** -- the programmed-PCM lifecycle.  (a) ``xpikeformer-gpt-4-256``
   on the LM stack, programmed (``engine.program``), served paged (the
   paged phase's 16 requests) under ``DriftPolicy(seconds_per_step=60,
   recal_interval_s=3600)``, the settings of ``launch/serve.py --program
   --drift-step 60 --recal-every 3600``: the clock must read 60 s a decode
   step, GDC must run at least once, every request must book energy, K6
   must launch once per image fold and twice per recalibration (every
   leaf in one launch; once a leaf at programming), and the plain
   versions on the card, from the same
   programmed state, must serve the same tokens with the same clock,
   folds, recalibrations and energy.  (b) the paper ViT-4-384 at batch 64,
   programmed, forward at t = 0, 1 h, 1 day, 30 days and 1 year without
   GDC, then at 1 day and 1 year after ``recalibrate()``, each through the
   keyed K8: kernel and plain
   logits bitwise equal at every point (the mean ``|logit - logit(t=0)|``
   printed), then ``forward(metering=True)``, whose logits must equal the
   unmetered ones (the report printed).

7. **mesh** -- the same model on a ``(data, model) = (2, 2)`` mesh: four
   ranks spawned by ``repro_torch.launch.mesh.run_ranks``, sharing the
   card over gloo (NCCL refuses two ranks on one device), each serving
   its share through ``repro_torch.distributed.Executor`` with the CUDA
   backend: slots data-parallel, Q/K/V and MLP-in column-parallel,
   attention-out and MLP-out row-parallel (K5 counts summed over the
   model group, then K4), SSA heads split.  (a) dense: the serve phase's
   first 8 requests, 16 new tokens; (b) paged: the paged phase's 16
   requests, 8 new tokens; 8 slots, ``cache_len=256``.  Every rank's
   streams must be the prefixes of the single-device streams, the paged
   run must hit the prefix cache and copy on write, and K5, K4, K3, K9
   and K1 must launch, K4 once per K5 (one epilogue launch per
   row-parallel linear).  Then one row-parallel linear at each of the
   mesh's shapes, in this process over a one-process stand-in for the
   model group, must hand PyTorch's dispatcher nothing but its outputs'
   allocations and views beside one K5 and one K4 launch (the kernels
   phase holds the same calls, and under the profiler finds no kernel but
   K5's and K4's).  (c) ``Executor.forward`` on tokens ``[8, 64]`` at full
   width, the batch split over ``data``: every rank's logits must equal
   one card's ``engine.forward``, bit for bit.  (d) phase 9's
   checkpoint, read on every rank with its serving placement
   (``launch/elastic.state_shardings``) and served dense: every rank's
   streams must equal one card's.  The phase runs after phase 9.
   Its times measure four processes sharing one card and gloo's host
   staging, not NVLink.  In the same spawn, the float and MoE stacks
   (budget 90 s): (e) phi3.5-moe at full width in bfloat16, 4 of its 32
   layers, each rank drawing only its share (8 experts a layer and the
   whole rest, at their flat indices in the whole draw), serving (a)'s 8
   requests x 16 new tokens with 8 slots: every request gets its tokens,
   every rank's streams are rank 0's, and after the timed run the served
   tree's ``Executor.forward`` logits on tokens [8, 16] are finite; per
   rank tokens/s, ``decode_step_ms``, the choices dropped at each
   capacity, the all-to-alls a decode step and their bytes.  (f) the same
   cut to 2 layers in float32 on tokens [8, 64]: each rank's
   ``Executor.forward`` (one card's dispatch over the whole batch, the
   experts' products split over the model group) within 1e-5 of one
   card's largest logit, and three teacher-forced decode steps within
   1e-4 of it where neither side drops a choice.  (g) phase moe (d)'s
   spiking MoE, its attention held whole (one KV head): forward logits
   and dense and paged streams equal to one card's, bit for bit; its
   launches join the phase's sums.  Training on the same spawn (budget
   90 s, the memory reckoning printed first): (h) phi3.5-moe at full
   width in bfloat16, 2 of its 32 layers, each rank drawing only its cut
   (its 16 heads, its 8 experts' half of ``d_ff``, the rest whole), 4
   steps of ``make_train_step`` on ``MarkovStream`` tokens ``[8, 257]``:
   every loss finite and equal on all ranks, the fixed-batch probe loss
   lower after the steps; per rank the step ms, the all-to-alls and
   gathers a step and their bytes, the FSDP branch taken, the choices
   dropped and ``max_memory_allocated``; then recurrentgemma-9b at full
   width in bfloat16, one period (3 of its 38 layers), 2 steps on the
   same tokens under every cut of the reference's rules (ZeRO-3 over
   ``data``, its tied table over both axes, RG-LRU and the query heads
   over ``model``): its losses finite and equal on all ranks, each rank's
   ``max_memory_allocated`` beside the reckoning of both layouts and
   below the old layout's state alone, its step ms.  (i) the reduced
   spiking GPT, the reduced phi3.5-moe (capacity factor 16: nothing
   drops), and the reduced mamba2-780m and recurrentgemma-9b with a
   vocabulary of 256 (cut over ``model``), one step each: every rank's
   loss and gradient norm within
   ``MESH_TRAIN_LOSS_ATOL``/``MESH_TRAIN_NORM_RTOL`` of one card's whole
   step; then
   the spiking GPT trained 2 steps through the launcher's rank function
   on the mesh, its checkpoint (gathered whole) read with each rank's
   serving placement and served through K5/K4/K3: every rank's streams
   equal to one card's serve of the same checkpoint.  (j) the front door
   on the same spawn (budget 45 s): rank 0 serves (a)'s 8 requests x 16
   new tokens through ``HttpFrontDoor`` as the three ``FD_TENANTS``
   (``metered`` on a joule bucket, preempted and re-admitted), the other
   ranks following it (``repro_torch.server.mesh``), dense then paged:
   every SSE stream equals (a)'s, every rank's scheduler ends with rank
   0's outputs and stats, the replay passed its bit check, ``/metrics``
   after the last ``done`` reads no running or queued request and one
   TTFT a request, rank 0's trace holds every request's admit, first
   token and finish, no other rank holds telemetry, and K5, K4 and K3
   (dense) or K9 (paged) launch on every rank; rank 0's HTTP tokens/s
   and TTFT p50/p99.

8. **train** -- training on the card, through the float reference
   backend (plain PyTorch: no kernel of the port in a step) and AdamW.
   The paper ViT-4-384 and GPT-4-256 at full width, random weights from a
   seed, one fixed batch of 64 each: ``two_stage_train`` (6 CT steps,
   then 3 HWAT steps, lr 1e-3; the GPT through ``train_and_program``,
   whose programming launches K6); the LM stack's GPT-4-256:
   ``make_train_step`` on ``MarkovStream`` tokens ``[8, 257]``, 6 steps
   of float32 state, then one of int8 state and two microbatches.  Every
   loss and gradient norm must be finite, the CT loss lower after its
   steps, the first step's loss and gradient norm on the card within
   ``TRAIN_LOSS_ATOL`` and ``TRAIN_NORM_RTOL`` of the same step on the
   host CPU, and the trained weights deployed through the kernels (K1
   and the keyed K8; the programmed GPT's drifted image) must give the
   plain backend's logits bit for bit.  Each model prints its step times,
   one profiled step (kernels, busy time, idle share) and the
   deployment's launches.

9. **train_launch** -- ``repro_torch.launch.train.run`` at full width
   (``xpikeformer-gpt-4-256``, ``MarkovStream`` batches ``[8, 257]``, 8
   steps, a checkpoint every 3): (a) uninterrupted; (b) again with
   ``fail_at=5``, the injected failure, then the rerun, which must restore
   step 3 and end within 1e-4 of (a)'s final loss (the largest
   difference of steps 3-7 and whether they are equal bit for bit
   printed); (c) a copy of (b)'s step-3 checkpoint resumed on a ``(2,
   1)`` mesh (two ranks sharing the card over gloo), steps 3-7 within
   1e-3 of (a)'s, its checkpoint restored on one device; (d) (a)'s final
   checkpoint restored into a fresh tree and served dense (K3, K1/K2: 4
   requests, 16 new tokens), the tokens equal to (a)'s in-memory
   parameters' and the plain backend's; then programmed (K6), drifted an
   hour, saved, restored and served paged under ``DriftPolicy(60, 3600)``
   (K9): tokens, clock, folds and joules equal to the in-memory tree's.
   It prints each run's step times, its seconds and its launches (the
   ``kernels`` line's ``launches_train_launch``).

10. **float_lm** -- the float LM stack, which launches none of K1-K9
   (its products are cuBLAS; the launch counts, zeroed before the serve,
   must stay zero), run after phase 9 and before the mesh.  (a) yi-9b at
   full width and depth in its config's bfloat16 (48 layers, d=4,096, 32
   heads on 4 KV heads of 128, d_ff=11,008, vocab 64,000; 8.83B random
   weights drawn on the card through the threefry twin, as the
   reference's ``init_params`` draws them): ``BatchScheduler(slots=8,
   cache_len=256)`` serves the serve phase's 16 requests, 32 new tokens
   each; every request must get its tokens, every decode step's logits be
   finite and the metered energy zero.  It prints the draw's seconds,
   tokens/s, ``decode_step_ms``, ``prefill_token_ms``,
   ``max_memory_allocated``, a profiled window of three decode steps of 8
   busy slots (kernels a step, busy time, idle share) and the greedy
   tokens' agreement with a batch-1 replay of the two shortest requests
   (reported, not asserted: cuBLAS may round a GEMM of 8 rows and of one
   row differently).  (b) yi-9b cut to 2 layers and (c) mamba2-780m at
   full depth and recurrentgemma-9b cut to one period (rglru, rglru,
   local), in float32 with TF32 off: the forward's logits on tokens [2,
   64] on the card against the same parameters on the host
   (``FLOAT_HOST_ATOL``), teacher-forced decode against the forward on
   the card (the reference's own 5e-3), and the long-sequence paths on
   the card against their plain forms: flash (s = 4,096) against the
   masked attention, the windowed flash and banded loops (2 and 3
   windows) against the window mask (``FLOAT_PATH_ATOL``), chunked SSD (s
   = 1,024) against the float64 step recurrence (``FLOAT_SSD_RTOL``,
   relative).  Each error is printed beside its tolerance.

11. **moe** -- Mixture-of-Experts on one card (``models/moe.py``), run
   after phase 10 and before the mesh, in a budget of 90 s.  (a)
   phi3.5-moe-42b-a6.6b at full width in bfloat16 (d=4,096, 32 heads on 8
   KV heads of 128, 16 experts of d_ff 6,400, top 2), cut to 8 of its 32
   layers (all 32 take ~83.8 GB), 10.7B weights drawn on the card as in
   phase 10, served as phase 10 serves (the same checks and readings, no
   replay) with the scheduler's default ``moe_impl="ep_a2a"``: no kernel
   of the port, and the step's weight-read bound (every expert read).
   (b) the same cut to 2 layers in float32, TF32 off, on tokens [2, 64]:
   the forward (``ep_a2a``) against the host's, teacher-forced decode
   under ``"dense"`` against the dense forward, and layer 0's ``moe_ep``
   at capacity factor 16 (no choice dropped) against ``moe_dense``
   (``MOE_EP_RTOL`` of the largest output).  (c) arctic-480b's MoE at full
   width (128 experts of d_ff 4,864 beside the dense residual MLP, d =
   7,168), one of 35 layers, bfloat16: ``moe_ep`` at factor 16 against
   ``moe_dense``, logits and the MoE's output (``ARCTIC_RTOL`` of the
   largest value), and the choices dropped at the config's 1.25.  (d)
   the reduced phi3.5-moe as a spiking SSA stack (T = 4) through the CUDA
   backend: the forward's logits equal to the plain backend's bit for bit
   (K1 four times a layer, the keyed K8 once), then dense (K1, K2) and
   paged (K1, K7) serves whose streams equal the plain backend's; the
   launches, counted from zero before these runs, are the ``kernels``
   line's ``launches_moe``.

Past the port's old caps the kernels phase holds K1 and K5 at T = 9 and
16 (few rows and many: the split of ``d_in`` and the tensor-core GEMM, on
residual-valued spikes up to 17), K9 at T = 9, and K8 at N = 513 and at
``G = 2, N = 2,048, D = 512``, a tile past a block's shared memory (K and
V streamed), each equal to its plain version; K1 is timed at the ViT's
MLP shapes (``384 -> 1,536`` and ``1,536 -> 384``, ``M = 4,096``) too.

The kernels phase also holds K5 ``aimc_matmul_counts`` at every shape
the mesh gives it (``T = 4``, ``M = 4`` decode slots or the ``M = 1``
prefill row, ``128 -> 256`` attention out and ``512 -> 256`` MLP out) and
at ``M = 4,096``, ``384 -> 384``, timed beside ``torch.matmul`` of the
same counts (TF32 off), K8 ``ssa_attention`` at the ViT's tile
(``G = 1,536``, ``N = D = 64``) and the GPT's causal tile (``G = 1,024``,
``N = 37``) twice: its keyed entry (the paper forwards' and the LM
stack's: comparators drawn in the kernel from one key, q/k/v read through
the heads views of ``[T, B, N, H*hd]`` trains, out written into a
``[T, B, N, H, hd]`` buffer; also at the LM stack's causal tile
``T=4, B=8, H=4, N=256, D=64``, at a ``(2, 2)`` mesh rank's block of it
(batch rows from 4, heads from 2: the whole tile's comparators at its own
tiles, equal to that block of the whole tile), at N = 513 and streamed at
``N = 2,048, D = 512``; each row with the profiler's device time, the
wrapper's host microseconds, the comparators the tile holds, needs and
draws, and a bound on the draws this data needs; the kernels line reads
the ViT's) and its given-draws entry (also at N = 513 and streamed), and
the SASS instructions of one in-kernel draw (``cuobjdump -sass`` of probe
kernels built from ``csrc/threefry.cuh``) with what they take at the
card's INT32 issue rate (the keyed K2's, K7's and K8's bounds count each
draw they need at that many instructions on the INT32 pipe), K4 ``lif``'s counts entry (the row-parallel epilogue) at
the mesh's ``[4, 4, 256]`` and ``[4, 1, 256]`` with and without a bias
and its currents entry there and at the ViT's ``[4, 64*64*1536]`` (each
row with the profiler's device time, the wrapper's host microseconds and
the bare launch's), K1 at the ViT's rows
(``M = 4,096``, and ``M = 65,536``), and K6
``drift_requantize`` (grouped: a tree's leaves in one launch) at the
ViT's ``w1`` leaf ``[384, 1536]``, the LM stack's stacked ``mlp.wi`` leaf
``[4, 256, 1024]`` and ``[300, 17]``, at t = 0, t < t0, 1 h and 1 year,
image gains 1 and 7, and over trees of 1, 6, 26 and 40 leaves (unaligned
rows, t = 0, the calibration read), its row timed at one ``[384, 1536]``
leaf with L2 flushed between launches (``device_ms``) and L2-warm.

A kernel's device time (``device_ms``, torch.profiler) is refused and the
session taken again where the profiler saw other than the launches made,
or where the calls kept the card busy and its busy time differs by more
than 10% from CUDA events around the same calls; three refused sessions
fail the run.

Then the ``kernels`` line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Any failed check raises, so the run
exits non-zero and prints no result.  Without a CUDA device it exits 2.
Each path's launch counts are read from a run that starts with every count
at zero: K1-K3 from the dense serve, K9 from the paged serve, K7 from the
unfused paged run, K8 from the ViT forward (its keyed entry), K6 from the
programmed paged serve, K5 and K4 from the mesh phase (summed over its
ranks).  The K1
row at the prefill shape also carries the host-clock cost of a wrapper call
and of the bare ``ctypes`` launch (1,000 calls each).

    python3 chip_smoke.py --ab <other tree>/src

compares another tree of the port (unpacked with ``git archive``) with this
one instead: each tree's windows (:func:`phase_windows`: K1/K5, K3/K9 at
the decode shapes, the serve windows with the dense prefill's time and
kernels a position, the unfused paged serve window, the forward windows,
the whole-tree drift folds of the LM stack and the ViT, and the
programmed paged serve; the forwards with their kernels, busy time and
idle share) run in a process of its own, parent, change,
change, parent, and the trees must serve the same tokens, give the same
logits, K3/K9 outputs and folded images, and run the same lifecycle.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import functools
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
ARCH = "xpikeformer-gpt-4-256"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor rate
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
PAPER = (("xpikeformer-vit-4-384", 64), ("xpikeformer-gpt-4-256", 64))
T0 = 20.0  # PCM drift reference time (Table II)
# K6's float operations an element: max, divide, log, multiply, exp, add,
# two multiplies, round, two clamps (exp and log counted as one each)
K6_OPS = 11
REPS, BATCH, WARMUP = 9, 20, 5
HOST_CALLS = 1000
# launches that open each profiler session that counts launches, ahead of
# the counted ones (device_ms, row_linear_kernels), and the sessions each
# takes before it fails (the card's profiler loses launches, from a few to
# a whole session's); the sessions taken and misread, by reason
LEAD_IN, PROFILE_TAKES = 16, 6
PROFILER_SESSIONS = collections.Counter()
# the live length of the keyed K2's timed prefill row: the middle of the
# serve phases' 8-32-token prompts
PREFILL_POS = 20


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def time_ms(fn) -> float:
    """Time of one call: CUDA events around ``BATCH`` back-to-back calls,
    over ``BATCH``; the median of ``REPS`` such runs after warm-up.  A call
    that the host cannot issue as fast as the card runs it is timed at the
    host's rate, which is what a caller of the wrapper gets."""
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(BATCH):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / BATCH)
    return statistics.median(times)


def device_ms(fn, kernel: str, calls: int = BATCH) -> float:
    """The card's time of one launch of the kernel whose name holds
    ``kernel``: torch.profiler over ``calls`` calls of ``fn`` after warm-up,
    that kernel's device time over its launches (what ``time_ms`` reads
    when the host issues calls slower than the card runs them is the
    host's rate).

    A session is taken again, up to :data:`PROFILE_TAKES` times, where it
    misreads: where the launches it saw are not ``calls`` (one a call), or
    where the calls keep the card busy (the host issues them in under half
    the card's time) and the device time of every kernel the session saw
    differs by more than 10% from CUDA events around the same calls made
    without the profiler (inside a session the profiler's own cost widens
    the gaps between launches).  :data:`PROFILE_TAKES` misreading sessions
    in a row fail the run rather than print a wrong time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    issue_ms = 1e3 * (time.perf_counter() - t0) / calls
    b.record()
    torch.cuda.synchronize()
    events_ms = a.elapsed_time(b) / calls
    bad = []
    for _ in range(PROFILE_TAKES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # lead-in launches (ATen's spin_kernel, left out of the busy
            # time): a session can miss the first few launches it sees,
            # more of them as a run's sessions accumulate
            for _ in range(LEAD_IN):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and "spin_kernel" not in e.key]
        ks = [e for e in dev if kernel in e.key]
        n = sum(e.count for e in ks)
        PROFILER_SESSIONS["taken"] += 1
        if n != calls:
            PROFILER_SESSIONS["launches_lost"] += 1
            bad.append(f"{n} launches seen, {calls} made")
            continue
        busy_ms = sum(e.self_device_time_total for e in dev) / calls / 1e3
        if issue_ms < 0.5 * events_ms and \
                abs(busy_ms - events_ms) > 0.1 * events_ms:
            PROFILER_SESSIONS["busy_off"] += 1
            bad.append(f"busy {busy_ms:.5f} ms a call against CUDA events' "
                       f"{events_ms:.5f}")
            continue
        return sum(e.self_device_time_total for e in ks) / n / 1e3
    check(False, f"the profiler misread {kernel} in {PROFILE_TAKES} "
          f"sessions: {bad}")


def nbytes(*xs) -> int:
    """Bytes of every tensor in ``xs`` (nested tuples/lists, None skipped)."""
    total = 0
    for x in xs:
        if isinstance(x, (tuple, list)):
            total += nbytes(*x)
        elif x is not None:
            total += x.numel() * x.element_size()
    return total


def bound(n_bytes: int, n_ops: int, ops_per_s: float = INT8_OPS_PER_S):
    """The least time for ``n_bytes`` of memory traffic and ``n_ops``
    operations at ``ops_per_s`` (integer by default):
    ``(ms, what bounds it, bytes, ops)``."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / ops_per_s * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations", n_bytes, n_ops)


def summary(r: dict) -> dict:
    """A kernel result for a JSON line: its bound tuple spelled out."""
    out = {k: v for k, v in r.items() if k != "bound"}
    out["bound_ms"], out["bound_by"], out["bound_bytes"], out["bound_ops"] = \
        r["bound"]
    return out


def wall_ms(fn, reps: int) -> float:
    """Median host-clock time of ``fn()`` to ``cuda.synchronize``."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host-clock microseconds a call of ``fn`` over ``calls`` calls issued
    back to back (the card keeps up: what is timed is the caller's cost)."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / calls


def bare_k1(x, w, out):
    """K1's ``ctypes`` launcher with every argument ready: what a call
    costs the host without the wrapper's checks, plan and allocation."""
    from repro_torch.kernels import aimc_matmul as KA
    from repro_torch.kernels import build as KB

    t, m, d_in = x.shape
    d_out = w[0].shape[1]
    args = (x.data_ptr(), w[0].data_ptr(), w[1].data_ptr(), w[2].data_ptr(),
            out.data_ptr(), t, m, d_in, d_out, 0.5, 1.0,
            *KA._plan_args(KA.launch_plan(t, m, d_in, d_out), x.device,
                           KB.stream_ptr(x), out.numel(), d_out))
    fn = KA._lib()
    return lambda: fn(*args)


def bare_layer(head, ws, draws, hd: int, paged: bool):
    """K3's or K9's ``ctypes`` launcher with every argument ready (outputs
    allocated once): what a call costs the host without the wrapper's
    checks, plan and allocation."""
    from repro_torch.kernels import build as KB
    from repro_torch.kernels import decode_fused as KFD

    s, rs4, ra4 = head[0], draws[0], draws[1]
    kv = head[1].shape[2] if paged else head[1].shape[3]
    made, ptrs, dims, dff, mlp, plan, outs = KFD._layer_operands(
        s, ws, rs4, ra4, hd=hd, kv=kv, with_tail=True, with_mlp=True)
    t, b, d, h, kv, hd = dims
    tail = (1, int(mlp), plan.cluster, plan.threads, 0.5, 1.0, plan.smem,
            KB.stream_ptr(s))
    outp = [o.data_ptr() for o in outs] + [0]  # no placement probe
    if paged:
        table, pos, write = head[3], head[4], head[5].to(torch.int64)
        args = (s.data_ptr(), head[1].data_ptr(), head[2].data_ptr(),
                table.data_ptr(), write.data_ptr(), pos.data_ptr(),
                rs4.data_ptr(), ra4.data_ptr(), *ptrs, *outp, t, b, d, h, kv,
                hd, head[1].shape[3], table.shape[1], dff, *tail)
        fn = KFD._lib("launch_fused_decode_layer_paged")
    else:
        write = None
        args = (s.data_ptr(), head[1].data_ptr(), head[2].data_ptr(),
                head[3].data_ptr(), rs4.data_ptr(), ra4.data_ptr(), *ptrs,
                *outp, t, b, d, h, kv, hd, head[1].shape[2], dff, *tail)
        fn = KFD._lib("launch_fused_decode_layer")
    return lambda keep=(made, outs, write): fn(*args)


def keyed_inputs(gen, dev, *, t, b, h, l, d, pos):
    """The keyed K2's operands as the serving path passes them: ``q
    [T,B,H,1,D]``, the cache ``[B,T,L,H,D]`` seen through its permuted
    ``[T,B,H,L,D]`` view (rows at and past each slot's ``pos`` zero),
    distinct slot keys ``[B, 2]`` and ``pos`` int32 (or ``None``)."""
    from repro_torch import prng

    q = spikes(gen, (t, b, h, 1, d), 0.5, dev)
    sk = spikes(gen, (b, t, l, h, d), 0.5, "cpu")
    sv = spikes(gen, (b, t, l, h, d), 0.5, "cpu")
    for i, p in enumerate(pos or []):
        sk[i, :, p:] = 0
        sv[i, :, p:] = 0
    keys = prng.key_from_seeds(torch.randint(0, 2 ** 32, (b,), generator=gen))
    tpos = None if pos is None else torch.tensor(pos, dtype=torch.int32).to(dev)
    return (q, sk.to(dev).permute(1, 0, 3, 2, 4),
            sv.to(dev).permute(1, 0, 3, 2, 4), keys.to(dev), tpos)


def bare_keyed(args, out, h0: int, i_max: int):
    """The keyed K2's ``ctypes`` launcher with every argument ready."""
    from repro_torch import prng
    from repro_torch.kernels import build as KB

    q, k, v, keys, pos = args
    t, b, h, l, d = k.shape
    a = (q.data_ptr(), k.data_ptr(), v.data_ptr(), keys.data_ptr(),
         0 if pos is None else pos.data_ptr(), out.data_ptr(), b, t, h, l, d,
         h0, *k.stride()[:4], d, prng.randint_multiplier(d), i_max,
         prng.randint_multiplier(i_max), KB.stream_ptr(q))
    fn = getattr(KB.load("ssa_attention"), "launch_ssa_decode_keyed")
    return lambda: fn(*a)


def draws_bound(n_bytes: int, pop_ops: int, pop_rate: float, draws: int,
                pipes: dict):
    """The least time of a keyed kernel: ``n_bytes`` over the memory rate,
    or its operations -- ``pop_ops`` AND-popcount operations at
    ``pop_rate`` and ``draws`` comparators of a draw's compiled
    instructions (``pipes``, :func:`sass_per_draw`) on the integer pipes
    and the issue limit (:func:`int32_issue_ms`) -- whichever is longer:
    :func:`bound`'s tuple, the operations counted as popcount operations
    plus draw instructions."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = pop_ops / pop_rate * 1e3 + int32_issue_ms(draws, pipes)
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations", n_bytes,
            pop_ops + pipes["issued"] * draws)


def keyed_bound(args, got, h0: int, i_max: int, pipes: dict):
    """The least time of one keyed K2 launch on these inputs: ``q``, the
    slot keys, ``pos`` and the output once; each query row's cached key
    rows below its slot's ``pos``; the value rows whose score spiked; no
    draw is read.  Operations: two a lane of each AND-popcount (the live
    scores and the counted value rows) at the card's f32 rate, and a
    comparator drawn for each live row and output lane, a draw's
    instructions on the integer pipes (:func:`draws_bound`)."""
    from repro_torch.kernels import ref as KREF

    q, k, v, keys, pos = args
    t, b, h, l, d = k.shape
    rs, _ = KREF.draw_slot_decode_prns(keys, t, h, l, d, i_max, h0)
    rs = rs.reshape(b, t, h, l).permute(1, 0, 2, 3)  # [T, B, H, L]
    n = (pos.long() if pos is not None
         else torch.full((b,), l, device=k.device)).clamp(0, l)
    live = torch.arange(l, device=k.device)[None, :] < n[:, None]  # [B, L]
    spike = ((q & k).sum(-1, dtype=torch.int32) > rs) & live[None, :, None]
    n_live = t * h * int(live.sum())
    v_rows = int(spike.sum())
    n_bytes = nbytes(q, keys, pos, got) + d * (n_live + v_rows)
    return draws_bound(n_bytes, 2 * d * (n_live + v_rows), FP32_OPS_PER_S,
                       n_live + t * b * h * d, pipes)


def paged_keyed_inputs(gen, dev, *, b, t, h, kv, d, pl, mp, pos, idle):
    """The keyed K7's operands as the unfused paged path passes them: ``q
    [T,B,H,1,D]``, the pools after the step's scatter (each active slot's
    rows up to and including its write position live, later ones zero),
    the table, distinct slot keys and the write positions (or ``None``)."""
    from repro_torch import prng

    table, _, kp, vp = paged_inputs(
        gen, b=b, t=t, kv=kv, hd=d, pl=pl, mp=mp,
        pos=[mp * pl] * b if pos is None else [min(p + 1, mp * pl)
                                                for p in pos], idle=idle)
    q = spikes(gen, (t, b, h, 1, d), 0.5, dev)
    keys = prng.key_from_seeds(torch.randint(0, 2 ** 32, (b,), generator=gen))
    tpos = None if pos is None else torch.tensor(pos, dtype=torch.int32).to(dev)
    return (q, kp.to(dev), vp.to(dev), table.to(dev), keys.to(dev), tpos)


def bare_paged_keyed(args, out, h0: int, i_max: int):
    """The keyed K7's ``ctypes`` launcher with every argument ready."""
    from repro_torch import prng
    from repro_torch.kernels import build as KB

    q, kp, vp, table, keys, pos = args
    t, b, h, _, d = q.shape
    a = (q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(),
         keys.data_ptr(), 0 if pos is None else pos.data_ptr(),
         out.data_ptr(), b, t, h, kp.shape[2], kp.shape[3], table.shape[1],
         d, h0, d, prng.randint_multiplier(d), i_max,
         prng.randint_multiplier(i_max), KB.stream_ptr(q))
    fn = getattr(KB.load("ssa_attention"), "launch_ssa_decode_paged_keyed")
    return lambda: fn(*a)


def paged_keyed_bound(args, got, h0: int, i_max: int, pipes: dict):
    """The least time of one keyed K7 launch on these inputs: ``q``, the
    table, the slot keys, ``pos`` and the output once; each distinct live
    key row (rows up to each slot's write position, not in a null page; a
    page two slots share once; a KV head's row once for its query-head
    group); the distinct value rows whose score spiked for some query
    head; no draw is read.  Operations as :func:`keyed_bound` counts
    them."""
    from repro_torch.kernels import ref as KREF

    q, kp, vp, table, keys, pos = args
    t, b, h, _, d = q.shape
    kv, pl, mp = kp.shape[2], kp.shape[3], table.shape[1]
    l = mp * pl
    rs, _ = KREF.draw_slot_decode_prns(keys, t, h, l, d, i_max, h0)
    rs = rs.reshape(b, t, h, l).permute(1, 0, 2, 3)  # [T, B, H, L]
    j = torch.arange(l, device=q.device)
    page = table.long()[:, j // pl]  # [B, L]
    n = (torch.full((b,), l, device=q.device) if pos is None
         else torch.where(pos.long() >= l, l, (pos.long() + 1).clamp(min=0)))
    live = (j[None, :] < n[:, None]) & (page != 0)  # [B, L]
    phys = page * pl + j % pl
    kview = KREF.gather_kv_pages_ref(kp, table)  # [T, B, KV, L, D]
    kq = kview.repeat_interleave(h // kv, dim=2)
    cnt = (q & kq).sum(-1, dtype=torch.int32)  # [T, B, H, L]
    spike = (cnt > rs) & live[None, :, None, :]
    vrows = spike.reshape(t, b, kv, h // kv, l).any(3)  # [T, B, KV, L]

    def distinct(mask):  # (t, kv head, physical row) triples under mask
        idx = torch.stack(torch.broadcast_tensors(
            torch.arange(t, device=q.device)[:, None, None, None],
            torch.arange(kv, device=q.device)[None, None, :, None],
            phys[None, :, None, :]), -1)
        return int(torch.unique(idx[mask], dim=0).shape[0])

    k_rows = distinct(live[None, :, None, :].expand(t, b, kv, l))
    v_rows = distinct(vrows)
    n_live = t * h * int(live.sum())
    n_bytes = nbytes(q, table, keys, pos, got) + d * (k_rows + v_rows)
    return draws_bound(n_bytes, 2 * d * (n_live + int(spike.sum())),
                       FP32_OPS_PER_S, n_live + t * b * h * d, pipes)


def bare_lif_counts(counts, scale, bias, out):
    """K4's counts entry's ``ctypes`` launcher with every argument ready."""
    from repro_torch.kernels import build as KB
    from repro_torch.kernels import lif as KL

    t, m, n = counts.shape
    a = (counts.data_ptr(), scale.data_ptr(),
         0 if bias is None else bias.data_ptr(), out.data_ptr(), t, m * n, n,
         0.5, 1.0, KB.stream_ptr(counts))
    fn = KL._lib("launch_lif_counts")
    return lambda: fn(*a)


def bare_lif(cur, out):
    """K4's currents entry's ``ctypes`` launcher, ``cur [T, M]`` f32."""
    from repro_torch.kernels import build as KB
    from repro_torch.kernels import lif as KL

    a = (cur.data_ptr(), out.data_ptr(), cur.shape[0], cur.shape[1], 0.5, 1.0,
         KB.stream_ptr(cur))
    fn = KL._lib()
    return lambda: fn(*a)


def layer_launch(launch, b: int) -> dict:
    """Where one K3/K9 launch at ``b`` slots ran: ``launch(placement)``
    runs the wrapper with the probe, whose blocks each write their SM, the
    size of their cluster and the cluster's index as the hardware reports
    them (``%smid``, ``%cluster_nctarank``, ``%clusterid.x``).  Returns the
    plan's cluster size and grid (``decode_fused.layer_plan``), and the
    measured cluster size, clusters, blocks, distinct SMs and the most
    blocks that one SM took in that launch."""
    from repro_torch.kernels import decode_fused as KFD

    n = b * KFD.CLUSTER
    placement = torch.full((n, 3), -1, dtype=torch.int32, device="cuda")
    launch(placement)
    torch.cuda.synchronize()
    ran = [r for r in placement.cpu().tolist() if r[0] >= 0]
    sizes = sorted({r[1] for r in ran})
    per_sm = collections.Counter(r[0] for r in ran)
    clusters = len({r[2] for r in ran})
    check(len(ran) == n and sizes == [KFD.CLUSTER] and clusters == b,
          f"K3/K9 placement: {len(ran)} of {n} blocks ran, cluster sizes "
          f"{sizes}, {clusters} clusters of {b}")
    return dict(plan_cluster=KFD.CLUSTER, plan_blocks=n, cluster=sizes[0],
                clusters=clusters, blocks=len(ran), sms_used=len(per_sm),
                most_blocks_on_one_sm=max(per_sm.values()))


def layer_bound(head, ws, draws, got, hd: int, paged: bool):
    """The least time of one K3/K9 step on these inputs: every weight,
    scale and bias, the residual, ``pos`` (paged: the table and write
    pages), ``ra`` and the outputs once; the cached key rows below each
    slot's ``pos`` (not in a null page; a row two slots share once), their
    score draws and the draw at ``pos``; and the value rows of (t, KV head)
    whose score spiked for some query head.  Operations: two a MAC of the
    five linears, two an AND-popcount lane of a score and a counted value
    lane.  Returns :func:`bound`'s tuple."""
    from repro_torch.kernels import ref as KREF

    s, pos = head[0], head[4] if paged else head[3]
    t, b, d = s.shape
    q = KREF._lin_lif_ref(s, ws[0], beta=0.5, v_thresh=1.0).reshape(
        t, b, -1, hd).to(torch.uint8)
    h = q.shape[2]
    if paged:
        table, pl = head[3].long(), head[1].shape[3]
        kview = KREF.gather_kv_pages_ref(head[1], head[3])
        j = torch.arange(table.shape[1] * pl, device=s.device)
        page = table[:, j // pl]
        phys = torch.where(page != 0, page * pl + j % pl, -1)
    else:
        kview = head[1].permute(1, 0, 3, 2, 4)  # [T, B, KV, L, hd]
        j = torch.arange(head[1].shape[2], device=s.device)
        phys = torch.arange(b, device=s.device)[:, None] * j.numel() + j
    kv, l = kview.shape[2], kview.shape[3]
    live = (j[None, :] < pos[:, None].long().clamp(max=l)) & (phys >= 0)
    kq = kview.repeat_interleave(h // kv, dim=2)  # [T, B, H, L, hd]
    cnt = (q[:, :, :, None, :] & kq).sum(-1, dtype=torch.int32)
    spike = (cnt > draws[0].permute(1, 0, 2, 3)) & live[None, :, None, :]
    vrows = spike.reshape(t, b, kv, h // kv, l).any(3)  # [T, B, KV, L]
    n_live = int(live.sum())
    k_rows = int(torch.unique(phys[live]).numel())
    v_rows = int(torch.unique(torch.stack(torch.broadcast_tensors(
        torch.arange(t, device=s.device)[:, None, None, None],
        torch.arange(kv, device=s.device)[None, None, :, None],
        phys[None, :, None, :]), -1)[vrows], dim=0).shape[0])
    n_bytes = (nbytes(head[0], head[3:] if paged else head[3], ws, draws[1],
                      got) + t * kv * hd * k_rows + hd * v_rows
               + 4 * t * h * (n_live + b))
    macs = t * b * (d * h * hd + 2 * d * kv * hd + h * hd * d
                    + 2 * d * ws[4][0].shape[1])
    return bound(n_bytes, 2 * macs + 2 * t * h * hd * n_live
                 + 2 * hd * int(spike.sum()))


def max_abs_err(got, want) -> float:
    if isinstance(got, (tuple, list)):
        return max(max_abs_err(g, w) for g, w in zip(got, want))
    return float((got.double() - want.double()).abs().max())


# ---------------------------------------------------------------------------
# Inputs (torch.Generator: no JAX stream is mirrored here)
# ---------------------------------------------------------------------------


def triple(gen, d_in, d_out, dev, bias=True):
    """int8 levels in [-15, 15] with dyadic scales and biases, which put
    many membranes exactly on the threshold."""
    lv = torch.randint(-15, 16, (d_in, d_out), generator=gen, dtype=torch.int8)
    sc = torch.randint(1, 4, (d_out,), generator=gen).float() / 8
    bi = torch.randint(-4, 9, (d_out,), generator=gen).float() / 8
    return (lv.to(dev), sc.to(dev), bi.to(dev) if bias else None)


def spikes(gen, shape, p, dev):
    return (torch.rand(shape, generator=gen) < p).to(torch.uint8).to(dev)


# the keyed K8's cases, (T, B, H, N, D, causal): the paper ViT's tile and
# the paper GPT's (batch 64), N = 513 on the resident design and a tile
# past a block's shared memory (streamed)
# (T, B, H, N, D, causal, block): the LM stack's causal tile of the
# lm_forward phase (8 sequences of 256), and a (2, 2) mesh rank's block of
# it (batch rows 4-7, heads 2-3: (b0, h0, rows, heads)), which draws the
# whole tile's comparators at its own tiles
KEYED_TILES = {"vit": (4, 64, 6, 64, 64, False, None),
               "gpt": (4, 64, 4, 37, 64, True, None),
               "lm": (4, 8, 4, 256, 64, True, None),
               "lm_shard": (4, 8, 4, 256, 64, True, (4, 2, 4, 2)),
               "n513": (1, 2, 32, 513, 64, True, None),
               "stream": (1, 1, 2, 2048, 512, True, None)}


def heads(gen, shape, p, dev):
    """Spikes of a ``[T, B, N, H, hd]``-shaped train seen as ``spikes.heads``
    hands them over: the ``[T, B, H, N, hd]`` view, no copy."""
    return spikes(gen, shape, p, dev).movedim(-2, -3)


def tile_draws(q, k, v, key, causal, tile=None) -> dict:
    """The keyed K8's comparators on these inputs: ``total``, what the
    tile holds (what the threefry twin draws); ``needed``, those whose
    count is not zero (no other can fire; a causal score past the diagonal
    counts zero); ``issued``, the lane draws the warps make (a warp pass
    takes two words of 32 lanes of a row: 64 lane draws where more than 32
    of its counts are not zero, 32 where 1 to 32 are, packed onto its
    lanes, none where none are; padding lanes included).  ``tile`` places
    the tiles in a larger grid (``b0``, ``h0``, ``batch``, ``heads``)."""
    from repro_torch.kernels import ref as KREF

    t, b, h, n, d = q.shape
    g = t * b * h
    qf, kf, vf = (x.reshape(g, n, d).float() for x in (q, k, v))
    cs = qf @ kf.transpose(1, 2)  # exact integers in f32 (TF32 is off)
    if causal:
        cs = cs * torch.tril(torch.ones((n, n), device=q.device))
    gi = KREF.tile_index(t, b, h, device=q.device, **(tile or {}))
    rs, _ = KREF.draw_tile_prns(key, gi.reshape(-1), n, d)
    ca = (cs > rs).float() @ vf

    def words(c):
        pad = (-c.shape[-1]) % 64
        m = torch.nn.functional.pad((c > 0).to(torch.uint8), (0, pad))
        live = m.reshape(*c.shape[:-1], -1, 64).sum(-1, dtype=torch.int64)
        return 64 * int((live > 32).sum()) + 32 * int(
            ((live > 0) & (live <= 32)).sum())

    return dict(total=g * n * (n + d), needed=int((cs > 0).sum())
                + int((ca > 0).sum()), issued=words(cs) + words(ca))


def keyed_tile_bound(q, k, v, key, got, draws, causal, pipes: dict):
    """The least time of one keyed K8 launch on these inputs: bytes, q, k,
    v, the key and the output once (no comparator is read); operations,
    the AND-popcounts (two operations a lane, both stages) at the int8
    tensor rate, as the given-draws row counts them, and each comparator
    this data needs (``needed``: a zero count needs none) at a draw's
    compiled instructions on the integer pipes (:func:`draws_bound`)."""
    t, b, h, n, d = q.shape
    pairs = n * (n + 1) // 2 if causal else n * n
    pop = 2 * 2 * t * b * h * pairs * d
    return draws_bound(nbytes(q, k, v, key, got), pop, INT8_OPS_PER_S,
                       draws["needed"], pipes)


SASS_PROBE = r"""
#include "threefry.cuh"
extern "C" __global__ void draw1(XpkRandintFast r, unsigned long long i0,
                                 unsigned* out) {
  const uint64_t i[1] = {i0 + threadIdx.x};
  uint32_t o[1];
  r.at<1>(i, o);
  out[threadIdx.x] = o[0];
}
extern "C" __global__ void draw2(XpkRandintFast r, unsigned long long i0,
                                 unsigned* out) {
  const uint64_t i[2] = {i0 + threadIdx.x, i0 + threadIdx.x + 32};
  uint32_t o[2];
  r.at<2>(i, o);
  out[threadIdx.x] = o[0] ^ o[1];
}
"""


def sass_per_draw() -> dict:
    """The SASS instructions of one keyed K8 draw: two probe kernels built
    from ``csrc/threefry.cuh`` with the library's flags, one draw and two
    in lockstep (``XpkRandintFast::at<1>``, ``at<2>``), disassembled by
    ``cuobjdump -sass``; their difference is what one more draw costs.
    Returns the counts, that difference by pipe (``pipes``: on the ALU, on
    the FMA pipe, all issued; :data:`ALU_OPS`) and the opcodes of the
    second draw's probe, or the error (the kernels phase fails on one: its
    keyed bounds count a draw at these instructions)."""
    import re

    from repro_torch.kernels import build as KB

    try:
        work = KB.BUILD_DIR / "sass_probe"
        work.mkdir(parents=True, exist_ok=True)
        (work / "probe.cu").write_text(SASS_PROBE)
        nvcc = Path(KB._nvcc())
        flags = [f for f in KB.NVCC_FLAGS
                 if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
        subprocess.run([str(nvcc), *flags, "-cubin", "-I", str(KB.CSRC), "-o",
                        str(work / "probe.cubin"), str(work / "probe.cu")],
                       check=True, capture_output=True, text=True, timeout=300)
        dump = subprocess.run([str(nvcc.parent / "cuobjdump"), "-sass",
                               str(work / "probe.cubin")], check=True,
                              capture_output=True, text=True,
                              timeout=120).stdout
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        return {"error": f"{type(e).__name__}: {e}"[:300]}
    ops, fn = {}, None
    for line in dump.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = m.group(1)
            ops[fn] = []
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        if m and fn and not m.group(1).startswith("NOP"):
            ops[fn].append(m.group(1).split(".")[0])
    n1, n2 = len(ops.get("draw1", [])), len(ops.get("draw2", []))
    if not n1 or not n2:
        return {"error": "cuobjdump listed no probe instructions"}
    c1, c2 = (collections.Counter(ops[f]) for f in ("draw1", "draw2"))
    one = {op: c2[op] - c1[op] for op in c1.keys() | c2.keys()}

    def on(pipe):
        return max(0, sum(n for op, n in one.items() if op in pipe))

    return dict(one_draw_kernel=n1, two_draw_kernel=n2, per_draw=n2 - n1,
                pipes=dict(alu=on(ALU_OPS), fma=on(FMA_INT_OPS),
                           issued=n2 - n1),
                two_draw_opcodes=dict(collections.Counter(ops["draw2"])
                                      .most_common(10)))


def keyed_resources(n: int, d: int) -> dict:
    """The keyed K8's launch at ``N = n``, ``D = d`` as the card sees it:
    registers and spill bytes a thread (``cudaFuncGetAttributes``), the
    blocks of 8 warps an SM holds (``cudaOccupancyMaxActiveBlocksPer
    Multiprocessor``) and the occupancy those give (warps resident over
    the SM's 64); the error code where a query fails."""
    import ctypes

    from repro_torch.kernels import build as KB
    from repro_torch.kernels import ssa_attention as KS

    plan = KS.attention_plan(n, d)
    out = (ctypes.c_int * 3)()
    fn = KB.load("ssa_attention").ssa_attention_keyed_resources
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    err = fn(int(plan.design == "stream"), plan.smem, ctypes.addressof(out))
    if err:
        return {"error": err}
    return dict(design=plan.design, smem=plan.smem, registers=out[0],
                spill_bytes=out[1], blocks_per_sm=out[2],
                occupancy=out[2] * 8 / 64)


# the pipes a draw's SASS opcodes run on (Nsight Compute's pipeline
# list): the ALU takes the logic, shift, add and compare instructions but
# not IMAD/IMUL, which run on the FMA pipe.  Each pipe retires 64 integer
# lanes a clock an SM on compute capability 9.0 (the CUDA C++ guide's
# throughput table), and an SM issues 128 lanes a clock (four schedulers,
# one warp instruction each).  An opcode listed in neither set (VIADD,
# MOV, the uniform datapath's) counts toward the issue limit only, so the
# bound stays a least time whichever pipe runs it.
ALU_OPS = frozenset({"LOP3", "LOP", "SHF", "IADD3", "ISETP", "SEL", "LEA",
                     "PRMT", "IMNMX", "IABS", "PLOP3", "BMSK", "SGXT"})
FMA_INT_OPS = frozenset({"IMAD", "IMUL"})
INT_PIPE_LANES, ISSUE_LANES = 64, 128


@functools.lru_cache(maxsize=None)
def sm_clocks_per_s() -> float:
    """The card's SMs times its maximum SM clock (``nvidia-smi
    clocks.max.sm``): SM-clocks a second."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * mhz * 1e6


def int32_issue_ms(lanes: int, pipes: dict) -> float:
    """Least time of ``lanes`` draws of a draw's instructions (``pipes``:
    ``alu``, ``fma`` and all ``issued``, :func:`sass_per_draw`): the
    busiest of the ALU pipe, the FMA pipe and the SM's issue limit."""
    clocks = max(pipes["alu"] / INT_PIPE_LANES, pipes["fma"] / INT_PIPE_LANES,
                 pipes["issued"] / ISSUE_LANES)
    return lanes * clocks / sm_clocks_per_s() * 1e3


# leaf shapes of the grouped K6: the ViT's widest, the LM stack's stacked
# mlp.wi, ragged widths (rows past the first not 16-byte aligned), 2-D
FOLD_SHAPES = ((384, 1536), (4, 256, 1024), (300, 17), (3, 70, 40),
               (2, 17, 33), (64, 32), (129, 7))


def fold_leaf(gen, shape, dev, *, offset=0, gains=(7.0,), times=(3600.0,)):
    """One programmed leaf's K6 operands as ``program`` draws them --
    integer levels in [-15, 15], ``eps ~ 0.45 N(0, 1)``, ``nu ~ max(0.06 +
    0.02 N(0, 1), 0)`` -- ``offset`` elements into their allocations
    (``offset % 4 != 0``: rows unaligned), with a time and ``1 / gain`` per
    matrix cycling through ``times`` and ``gains``."""
    from repro_torch.kernels import drift_requantize as KD

    def put(x):
        buf = torch.empty(x.numel() + offset, dtype=torch.float32, device=dev)
        buf[offset:] = x.reshape(-1).to(dev)
        return buf[offset:].view(shape)

    lead = shape[:-2]
    m = math.prod(lead)
    tt = torch.tensor([times[i % len(times)] for i in range(m)],
                      dtype=torch.float32).reshape(lead)
    inv = torch.tensor([1.0 / gains[i % len(gains)] for i in range(m)],
                       dtype=torch.float32).reshape(lead)
    return KD.FoldLeaf(
        put(torch.randint(-15, 16, shape, generator=gen).float()),
        put(0.45 * torch.randn(shape, generator=gen)),
        put(torch.clamp_min(0.06 + 0.02 * torch.randn(shape, generator=gen),
                            0)), tt.to(dev), inv.to(dev))


def bare_fold(leaves, outs):
    """The grouped K6's ``ctypes`` launcher with its descriptors ready:
    what a fold costs the host without the wrapper's checks, descriptors
    and allocations (``outs`` one image a leaf)."""
    import ctypes

    from repro_torch.kernels import build as KB
    from repro_torch.kernels import drift_requantize as KD

    descs = (KD._Leaf * len(leaves))()
    for d, leaf, o in zip(descs, leaves, outs):
        d.levels, d.eps, d.nu = (x.data_ptr() for x in leaf[:3])
        d.t_sec = 0 if leaf.t_seconds is None else leaf.t_seconds.data_ptr()
        d.img_inv, d.out, d.sums = leaf.img_inv.data_ptr(), o.data_ptr(), 0
        d.n = leaf.levels.shape[-2] * leaf.levels.shape[-1]
        d.n_mat = math.prod(leaf.levels.shape[:-2])
    fn, ptr = KD._lib(), ctypes.addressof(descs)
    stream = KB.stream_ptr(leaves[0].levels)
    return lambda keep=descs: fn(ptr, len(leaves), T0, stream)


def layer_inputs(gen, dev, *, t, b, d, h, kv, hd, l, dff, pos):
    s = torch.randint(0, 3, (t, b, d), generator=gen).float()
    sk = spikes(gen, (b, t, l, kv, hd), 0.3, "cpu")
    sv = spikes(gen, (b, t, l, kv, hd), 0.3, "cpu")
    for i, p in enumerate(pos):  # the serving invariant: rows >= pos are 0
        sk[i, :, p:] = 0
        sv[i, :, p:] = 0
    ws = [triple(gen, d, h * hd, dev), triple(gen, d, kv * hd, dev, bias=False),
          triple(gen, d, kv * hd, dev), triple(gen, h * hd, d, dev),
          triple(gen, d, dff, dev), triple(gen, dff, d, dev, bias=False)]
    rs = torch.randint(0, hd, (b, t, h, l), generator=gen, dtype=torch.int32)
    ra = torch.randint(0, l, (b, t, h, hd), generator=gen, dtype=torch.int32)
    head = [x.to(dev) for x in (s, sk, sv, torch.tensor(pos, dtype=torch.int32))]
    return head, ws, [rs.to(dev), ra.to(dev)]


def paged_inputs(gen, *, b, t, kv, hd, pl, mp, pos, idle=(), extra=4):
    """Page tables, write pages and page pools as a server holds them:
    each active slot owns the pages of its blocks ``0 .. pos // pl``
    (slot 1's block 0 is slot 0's page, a shared prefix), rows at and
    after ``pos`` and the null page 0 are zero, idle slots hold a null row
    and write the trash page 1 (which holds garbage)."""
    table = torch.zeros((b, mp), dtype=torch.int32)
    write = torch.ones((b,), dtype=torch.int32)
    nxt = 2
    for i in range(b):
        if i in idle:
            continue
        for j in range(min(pos[i] // pl, mp - 1) + 1):
            table[i, j] = nxt
            nxt += 1
        if pos[i] < mp * pl:
            write[i] = table[i, pos[i] // pl]
    if b > 1 and min(pos[0], pos[1]) >= pl and 1 not in idle:
        table[1, 0] = table[0, 0]
    n_pages = nxt + extra
    perm = torch.arange(n_pages)
    perm[2:] = perm[2:][torch.randperm(n_pages - 2, generator=gen)]
    table = torch.where(table >= 2, perm[table.long()].int(), table)
    write = torch.where(write >= 2, perm[write.long()].int(), write)
    kp = spikes(gen, (n_pages, t, kv, pl, hd), 0.5, "cpu")
    vp = spikes(gen, (n_pages, t, kv, pl, hd), 0.5, "cpu")
    kp[0] = vp[0] = 0
    for i, p in enumerate(pos):
        for j in range(mp):
            pid = int(table[i, j])
            if pid >= 2:
                lo = min(max(p - j * pl, 0), pl)
                kp[pid, :, :, lo:] = 0
                vp[pid, :, :, lo:] = 0
    return table, write, kp, vp


def paged_reads(table, pl: int):
    """What a paged kernel must read of the pools for these tables: the
    distinct non-null pages, and each slot's non-null cached rows."""
    pages = int(torch.unique(table[table != 0]).numel())
    rows = ((table != 0).sum(1) * pl).tolist()
    return pages, rows


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def phase_kernels(dev):
    from repro_torch.kernels import aimc_matmul as KA
    from repro_torch.kernels import build as KB
    from repro_torch.kernels import decode_fused as KFD
    from repro_torch.kernels import ref as KREF
    from repro_torch.kernels import ssa_attention as KS

    gen = torch.Generator().manual_seed(1234)
    results = {}
    # the compiled instructions of one in-kernel draw, by pipe: the keyed
    # kernels' bounds count their draws at these on the integer pipes
    sass = sass_per_draw()
    check("pipes" in sass, f"no SASS count of a draw: {sass}")
    pipes = sass["pipes"]

    # K1 at the prefill shapes (one token: M=1) and a ragged edge
    k1 = {}
    for t, m, d_in, d_out in [(4, 1, 256, 256), (4, 1, 256, 1024),
                              (4, 1, 1024, 256), (3, 5, 64, 48)]:
        x = torch.randint(0, 4, (t, m, d_in), generator=gen).float().to(dev)
        w = triple(gen, d_in, d_out, dev, bias=d_out != 48)
        got = KA.aimc_spiking_linear_kernel(x, *w)
        want = KREF.aimc_spiking_linear_ref(x, *w)
        k1[(t, m, d_in, d_out)] = (got, want, x, w)
        check(torch.equal(got, want), f"K1 {t}x{m}x{d_in}->{d_out} differs")
    got, want, x, w = k1[(4, 1, 256, 256)]
    n_bytes = nbytes(x, w, got)
    results["aimc_spiking_linear"] = dict(
        shape="T=4, M=1, 256->256 (a prefill Q/K/V/O projection)",
        max_abs_err=max(max_abs_err(g, w_) for g, w_, *_ in k1.values()),
        ms=time_ms(lambda: KA.aimc_spiking_linear_kernel(x, *w)),
        plain_ms=time_ms(lambda: KREF.aimc_spiking_linear_ref(x, *w)),
        wrapper_host_us=host_us(lambda: KA.aimc_spiking_linear_kernel(x, *w)),
        bare_launch_host_us=host_us(bare_k1(x, w, torch.empty_like(got))),
        bound=bound(n_bytes, 2 * 4 * 1 * 256 * 256))

    # K2 with given draws (the tests' fuzz surface) at the prefill shape (G =
    # 1 slot x T x H) and the padding edge
    k2 = {}
    for g, l, d in [(16, 256, 64), (48, 24, 16)]:
        q = spikes(gen, (g, 1, d), 0.5, dev)
        k = spikes(gen, (g, l, d), 0.5, dev)
        v = spikes(gen, (g, l, d), 0.5, dev)
        rs = torch.randint(0, d, (g, 1, l), generator=gen, dtype=torch.int32).to(dev)
        ra = torch.randint(0, l, (g, 1, d), generator=gen, dtype=torch.int32).to(dev)
        args = (q, k, v, rs, ra)
        got, want = KS.ssa_decode_kernel(*args), KREF.ssa_decode_ref(*args)
        k2[(g, l, d)] = (got, want, args)
        check(torch.equal(got, want), f"K2 G={g} L={l} D={d} differs")
    got, want, args = k2[(16, 256, 64)]
    results["ssa_decode_given_draws"] = dict(
        shape="G=16 (1 slot x T=4 x H=4), L=256, D=64, draws given, every "
              "row read",
        max_abs_err=max(max_abs_err(g, w_) for g, w_, _ in k2.values()),
        ms=time_ms(lambda: KS.ssa_decode_kernel(*args)),
        plain_ms=time_ms(lambda: KREF.ssa_decode_ref(*args)),
        device_ms=device_ms(lambda: KS.ssa_decode_kernel(*args),
                            "ssa_decode_kernel"),
        bound=bound(nbytes(args, got), 2 * 2 * 16 * 256 * 64))

    # K2 keyed (the serving path's entry: draws from the slot keys, the
    # cache read through the permuted view, scores up to each slot's pos):
    # the dense prefill row of one slot, three slots of distinct pos, a
    # rank's head offset, no pos
    k2k = {}
    for name, (t, b, h, l, d, h0, pos) in {
            "prefill": (4, 1, 4, 256, 64, 0, [PREFILL_POS]),
            "b3": (4, 3, 4, 256, 64, 0, [0, 131, 256]),
            "h0": (4, 3, 2, 256, 64, 2, [7, 256, 64]),
            "no_pos": (4, 2, 4, 256, 64, 1, None)}.items():
        args = keyed_inputs(gen, dev, t=t, b=b, h=h, l=l, d=d, pos=pos)
        run = (lambda args=args, h0=h0, l=l:
               KS.ssa_decode_keyed_kernel(*args, h0=h0, i_max=l))
        plain = (lambda args=args, h0=h0, l=l:
                 KREF.ssa_decode_keyed_ref(*args[:4], h0, i_max=l))
        got, want = run(), plain()
        k2k[name] = (got, want, run, plain, args)
        check(torch.equal(got, want), f"keyed K2 case {name} differs")
    got, want, run, plain, args = k2k["prefill"]
    results["ssa_decode"] = dict(
        shape=f"T=4 x B=1 x H=4 query rows (a dense prefill position), "
              f"L=256, D=64, live length pos={PREFILL_POS}, draws in the "
              "kernel",
        pos=PREFILL_POS,
        max_abs_err=max(max_abs_err(g, w_) for g, w_, *_ in k2k.values()),
        ms=time_ms(run), plain_ms=time_ms(plain),
        device_ms=device_ms(run, "ssa_decode_keyed_kernel"),
        wrapper_host_us=host_us(run),
        bare_launch_host_us=host_us(bare_keyed(args, torch.empty_like(got),
                                               0, 256)),
        bound=keyed_bound(args, got, 0, 256, pipes))

    # K3 at the decode shape, the padding edge, GQA, one slot and 32 slots
    # (256 clusters of 8: more than the card holds at once)
    cases = {
        "main": dict(t=4, b=8, d=256, h=4, kv=4, hd=64, l=256, dff=1024,
                     pos=[0, 1, 40, 100, 200, 254, 255, 17]),
        "padding": dict(t=4, b=3, d=64, h=4, kv=4, hd=16, l=24, dff=128,
                        pos=[0, 9, 23]),
        "gqa": dict(t=4, b=8, d=256, h=4, kv=2, hd=64, l=256, dff=1024,
                    pos=[3, 0, 255, 256, 64, 128, 7, 31]),
        "b1": dict(t=4, b=1, d=256, h=4, kv=4, hd=64, l=256, dff=1024,
                   pos=[130]),
        "b32": dict(t=4, b=32, d=256, h=4, kv=4, hd=64, l=256, dff=1024,
                    pos=[(37 * i) % 257 for i in range(32)]),
    }
    k3 = {}
    for name, c in cases.items():
        head, ws, draws = layer_inputs(gen, dev, **c)
        run = (lambda head=head, ws=ws, draws=draws, hd=c["hd"]:
               KFD.fused_decode_layer_kernel(*head, *ws, *draws, hd=hd))
        plain = (lambda head=head, ws=ws, draws=draws, hd=c["hd"]:
                 KREF.decode_layer_ref(*head, *ws, *draws, hd=hd))
        got, want = run(), plain()
        k3[name] = (got, want, run, plain, head, ws, draws)
        check(all(torch.equal(g, w_) for g, w_ in zip(got, want)),
              f"K3 case {name} differs")
    got, want, run, plain, head, ws, draws = k3["main"]
    results["fused_decode_layer"] = dict(
        shape="T=4, B=8, d=256, H=KV=4, hd=64, L=256, d_ff=1024 (decode)",
        max_abs_err=max(max_abs_err(g, w_) for g, w_, *_ in k3.values()),
        ms=time_ms(run), plain_ms=time_ms(plain),
        device_ms=device_ms(run, "fused_decode_layer_kernel"),
        **layer_launch(lambda pl: KFD.fused_decode_layer_kernel(
            *head, *ws, *draws, hd=64, placement=pl), 8),
        wrapper_host_us=host_us(run),
        bare_launch_host_us=host_us(bare_layer(head, ws, draws, 64, False)),
        bound=layer_bound(head, ws, draws, got, 64, False))

    # K7 with given draws (the tests' fuzz surface) at the unfused paged
    # decode shape and the padding/GQA edge (its pools hold each slot's rows
    # up to and including pos: post-scatter); every row read
    k7 = {}
    for name, c in {
            "main": dict(b=8, t=4, h=4, kv=4, d=64, pl=8, mp=32,
                         pos=[40, 100, 0, 5, 200, 255, 17, 64], idle=(6,)),
            "edge": dict(b=3, t=4, h=4, kv=2, d=16, pl=5, mp=5,
                         pos=[3, 24, 9], idle=())}.items():
        b, t, h, d, pl, mp = (c[k] for k in ("b", "t", "h", "d", "pl", "mp"))
        l = mp * pl
        table, _, kp, vp = paged_inputs(
            gen, b=b, t=t, kv=c["kv"], hd=d, pl=pl, mp=mp,
            pos=[p + 1 for p in c["pos"]], idle=c["idle"])
        q = spikes(gen, (b, t, h, d), 0.5, "cpu")
        rs = torch.randint(0, d, (b, t * h, 1, l), generator=gen, dtype=torch.int32)
        ra = torch.randint(0, l, (b, t * h, 1, d), generator=gen, dtype=torch.int32)
        args = tuple(x.to(dev) for x in (q, kp, vp, table, rs, ra))
        run = lambda args=args: KS.ssa_decode_paged_kernel(*args)
        plain = (lambda args=args, b=b, t=t, h=h, d=d, l=l:
                 KREF.ssa_decode_paged_ref(
                     args[0][:, :, :, None, :], *args[1:4],
                     args[4].reshape(b, t, h, 1, l),
                     args[5].reshape(b, t, h, 1, d))[:, :, :, 0, :])
        got, want = run(), plain()
        k7[name] = (got, want, run, plain, args, c)
        check(torch.equal(got, want), f"K7 case {name} differs")
    got, want, run, plain, args, c = k7["main"]
    pages, rows = paged_reads(args[3], c["pl"])
    t, h, kv, d, pl = (c[k] for k in ("t", "h", "kv", "d", "pl"))
    n_bytes = (nbytes(args[0], args[3], args[5], got)
               + 4 * t * h * sum(rows) + 2 * pages * t * kv * pl * d)
    results["ssa_decode_paged_given_draws"] = dict(
        shape="B=8 x T=4 x H=4, page_len=8, 32 table columns, hd=64, draws "
              "given, every row read",
        max_abs_err=max(max_abs_err(g, w_) for g, w_, *_ in k7.values()),
        ms=time_ms(run), plain_ms=time_ms(plain),
        device_ms=device_ms(run, "ssa_decode_paged_kernel"),
        bound=bound(n_bytes, 2 * 2 * t * h * d * sum(rows)))

    # K7 keyed (the unfused paged serving path's entry: draws from the slot
    # keys, q and out in the caller's layout, scores up to each slot's write
    # position): the paged decode shape with an idle slot, pos 0, mid-page,
    # L - 1, L and past L, GQA with page_len 5 and a head offset, no pos
    k7k = {}
    for name, c in {
            "main": dict(b=8, t=4, h=4, kv=4, d=64, pl=8, mp=32, h0=0,
                         pos=[40, 100, 0, 5, 200, 255, 17, 64], idle=(6,)),
            "pos_edges": dict(b=5, t=4, h=4, kv=4, d=64, pl=8, mp=4, h0=0,
                              pos=[0, 12, 31, 32, 39], idle=()),
            "gqa_pl5_h0": dict(b=4, t=4, h=4, kv=2, d=16, pl=5, mp=5, h0=2,
                               pos=[3, 24, 9, 30], idle=(2,)),
            "no_pos": dict(b=3, t=4, h=4, kv=4, d=64, pl=8, mp=32, h0=1,
                           pos=None, idle=())}.items():
        args = paged_keyed_inputs(gen, dev, **{k: v for k, v in c.items()
                                               if k != "h0"})
        i_max = c["mp"] * c["pl"]
        run = (lambda args=args, h0=c["h0"], i_max=i_max:
               KS.ssa_decode_paged_keyed_kernel(*args, h0=h0, i_max=i_max))
        plain = (lambda args=args, h0=c["h0"], i_max=i_max:
                 KREF.ssa_decode_paged_keyed_ref(*args[:5], h0, i_max=i_max))
        got, want = run(), plain()
        k7k[name] = (got, want, run, plain, args)
        check(torch.equal(got, want), f"keyed K7 case {name} differs")
    got, want, run, plain, args = k7k["main"]
    results["ssa_decode_paged"] = dict(
        shape="T=4 x B=8 x H=4 query rows (unfused paged decode), "
              "page_len=8, 32 table columns (L=256), hd=64, write positions "
              "40/100/0/5/200/255/17/64 (slot 6 idle), draws in the kernel",
        max_abs_err=max(max_abs_err(g, w_) for g, w_, *_ in k7k.values()),
        ms=time_ms(run), plain_ms=time_ms(plain),
        device_ms=device_ms(run, "ssa_decode_paged_keyed_kernel"),
        wrapper_host_us=host_us(run),
        bare_launch_host_us=host_us(bare_paged_keyed(
            args, torch.empty_like(got), 0, 256)),
        bound=paged_keyed_bound(args, got, 0, 256, pipes))

    # K9 at the paged decode shape, the padding/GQA edge and pos >= L
    k9 = {}
    for name, c in {
            "main": dict(t=4, b=8, d=256, h=4, kv=4, hd=64, pl=8, mp=32,
                         dff=1024, pos=[40, 100, 0, 5, 200, 255, 17, 64],
                         idle=(6,)),
            "edge": dict(t=4, b=4, d=64, h=4, kv=2, hd=16, pl=5, mp=5,
                         dff=128, pos=[7, 25, 3, 30], idle=(2,)),
            "t9": dict(t=9, b=8, d=256, h=4, kv=4, hd=64, pl=8, mp=32,
                       dff=1024, pos=[40, 100, 0, 5, 200, 255, 17, 64],
                       idle=(6,)),
            "b1": dict(t=4, b=1, d=256, h=4, kv=4, hd=64, pl=8, mp=32,
                       dff=1024, pos=[77], idle=()),
            "b32": dict(t=4, b=32, d=256, h=4, kv=4, hd=64, pl=8, mp=32,
                        dff=1024, pos=[(37 * i) % 257 for i in range(32)],
                        idle=(3, 17, 30))}.items():
        t, b, d, h, kv, hd, dff = (c[k] for k in ("t", "b", "d", "h", "kv", "hd", "dff"))
        l = c["mp"] * c["pl"]
        table, write, kp, vp = paged_inputs(
            gen, b=b, t=t, kv=kv, hd=hd, pl=c["pl"], mp=c["mp"], pos=c["pos"],
            idle=c["idle"])
        s_in = torch.randint(0, 3, (t, b, d), generator=gen).float()
        ws = [triple(gen, d, h * hd, dev), triple(gen, d, kv * hd, dev, bias=False),
              triple(gen, d, kv * hd, dev), triple(gen, h * hd, d, dev),
              triple(gen, d, dff, dev), triple(gen, dff, d, dev, bias=False)]
        rs = torch.randint(0, hd, (b, t, h, l), generator=gen, dtype=torch.int32)
        ra = torch.randint(0, l, (b, t, h, hd), generator=gen, dtype=torch.int32)
        head = [x.to(dev) for x in (s_in, kp, vp, table,
                                    torch.tensor(c["pos"], dtype=torch.int32),
                                    write.long())]  # int64, as the scheduler
        draws = [rs.to(dev), ra.to(dev)]
        run = (lambda head=head, ws=ws, draws=draws, hd=hd:
               KFD.fused_decode_layer_paged_kernel(*head, *ws, *draws, hd=hd))
        plain = (lambda head=head, ws=ws, draws=draws, hd=hd:
                 KREF.decode_layer_paged_ref(*head, *ws, *draws, hd=hd))
        got, want = run(), plain()
        k9[name] = (got, want, run, plain, head, ws, draws, c)
        check(all(torch.equal(g, w_) for g, w_ in zip(got, want)),
              f"K9 case {name} differs")
    got, want, run, plain, head, ws, draws, c = k9["main"]
    results["fused_decode_layer_paged"] = dict(
        shape="T=4, B=8, d=256, H=KV=4, hd=64, page_len=8, 32 table columns, "
              "d_ff=1024 (paged decode)",
        max_abs_err=max(max_abs_err(g, w_) for g, w_, *_ in k9.values()),
        ms=time_ms(run), plain_ms=time_ms(plain),
        device_ms=device_ms(run, "fused_decode_layer_kernel"),
        **layer_launch(lambda pl: KFD.fused_decode_layer_paged_kernel(
            *head, *ws, *draws, hd=64, placement=pl), 8),
        wrapper_host_us=host_us(run),
        bare_launch_host_us=host_us(bare_layer(head, ws, draws, 64, True)),
        bound=layer_bound(head, ws, draws, got, 64, True))

    # K1 at the paper ViT's rows (the tensor-core regime): B = 64 images x
    # 64 patches at the attention projections and the MLP's two linears, and
    # B = 1,024 (M = 65,536 rows)
    for m, d_in, d_out, label, what in (
            (4096, 384, 384, "vit_b64", "a ViT-4-384 Q/K/V/O projection"),
            (65536, 384, 384, "rows_65536", "a Q/K/V/O projection, B = 1,024"),
            (4096, 384, 1536, "vit_mlp_in", "the ViT-4-384's MLP in"),
            (4096, 1536, 384, "vit_mlp_out", "the ViT-4-384's MLP out")):
        x = torch.randint(0, 4, (4, m, d_in), generator=gen).float().to(dev)
        w = triple(gen, d_in, d_out, dev)
        got = KA.aimc_spiking_linear_kernel(x, *w)
        want = KREF.aimc_spiking_linear_ref(x, *w)
        check(torch.equal(got, want), f"K1 at M={m}, {d_in}->{d_out} differs")
        results[f"aimc_spiking_linear_{label}"] = dict(
            shape=f"T=4, M={m}, {d_in}->{d_out} ({what})",
            max_abs_err=max_abs_err(got, want),
            ms=time_ms(lambda x=x, w=w: KA.aimc_spiking_linear_kernel(x, *w)),
            plain_ms=time_ms(lambda x=x, w=w: KREF.aimc_spiking_linear_ref(x, *w)),
            bound=bound(nbytes(x, w, got), 2 * 4 * m * d_in * d_out))
        del x, got, want

    # K1 and K5 past the old 8-step cap, in both regimes, on residual-valued
    # spikes in [0, 17] (1 + 2 x depth 8)
    long_trains = {}
    for t, m, d_in, d_out in ((9, 1, 256, 256), (9, 4, 512, 256),
                              (9, 4096, 384, 384), (16, 4, 1024, 256),
                              (16, 4096, 384, 384)):
        x = torch.randint(0, 18, (t, m, d_in), generator=gen).float().to(dev)
        lv, sc, bi = triple(gen, d_in, d_out, dev)
        sc = sc / 16
        got = KA.aimc_spiking_linear_kernel(x, lv, sc, bi)
        want = KREF.aimc_spiking_linear_ref(x, lv, sc, bi)
        check(torch.equal(got, want), f"K1 at T={t}, M={m} differs")
        cgot = KA.aimc_matmul_counts_kernel(x, lv)
        cwant = KREF.aimc_counts_ref(x, lv)
        check(torch.equal(cgot, cwant), f"K5 at T={t}, M={m} differs")
        long_trains[f"T={t}, M={m}, {d_in}->{d_out}"] = dict(
            regime=KA.launch_plan(t, m, d_in, d_out).regime,
            k1_max_abs_err=max_abs_err(got, want),
            k5_max_abs_err=max_abs_err(cgot, cwant),
            spike_share=float(want.float().mean()))
        del x, got, want, cgot, cwant
    results["crossbar_long_trains"] = long_trains

    # K5 at every shape the (2, 2) mesh gives it -- the attention-out
    # (128 local rows) and MLP-out (512 local rows) -> 256 linears, at the
    # decode step's 4 local slots and the batch-1 prefill's one row -- and
    # at a ViT-sized shape; the yardstick is one torch.matmul of the same
    # counts (TF32 off: full f32).  The kernels line reads the MLP-out
    # decode tail.
    mesh_k5 = {"": ((4, 4, 512, 256), "the MLP-out decode tail"),
               "_attn_out": ((4, 4, 128, 256), "the attention-out decode"),
               "_prefill": ((4, 1, 512, 256), "the MLP-out prefill row"),
               "_prefill_attn_out": ((4, 1, 128, 256),
                                     "the attention-out prefill row")}
    for label, ((t, m, d_in, d_out), what) in (
            *mesh_k5.items(),
            ("_m4096", ((4, 4096, 384, 384), "ViT-sized rows")),
            (None, ((3, 5, 130, 33), "ragged"))):
        x = torch.randint(0, 4, (t, m, d_in), generator=gen).float().to(dev)
        lv = torch.randint(-127, 128, (d_in, d_out), generator=gen,
                           dtype=torch.int8).to(dev)
        got = KA.aimc_matmul_counts_kernel(x, lv)
        want = KREF.aimc_counts_ref(x, lv)
        check(torch.equal(got, want), f"K5 {t}x{m}x{d_in}->{d_out} differs")
        lib = torch.matmul(x.reshape(t * m, d_in), lv.float()).reshape(
            t, m, d_out)
        check(torch.equal(lib, want),
              f"K5's library call differs at {t}x{m}x{d_in}->{d_out}")
        if label is None:
            continue
        results["aimc_matmul_counts" + label] = dict(
            shape=f"T={t}, M={m}, {d_in}->{d_out} ({what})",
            max_abs_err=max_abs_err(got, want),
            ms=time_ms(lambda x=x, lv=lv: KA.aimc_matmul_counts_kernel(x, lv)),
            plain_ms=time_ms(lambda x=x, lv=lv: KREF.aimc_counts_ref(x, lv)),
            library_ms=time_ms(lambda x=x, lv=lv, t=t, m=m, d_in=d_in:
                               torch.matmul(x.reshape(t * m, d_in),
                                            lv.float())),
            bound=bound(nbytes(x, lv, got), 2 * t * m * d_in * d_out))
        del x, lv, got, want, lib

    # K8 with given draws (the tests' fuzz surface) at the ViT's tile (B =
    # 64) and the paper GPT's causal one (B = 64, L = 37); the score draws a
    # causal row needs are rs[i, :i+1]
    k8 = {}
    for name, (g, n, d, causal) in {"vit": (1536, 64, 64, False),
                                    "gpt": (1024, 37, 64, True)}.items():
        args = (spikes(gen, (g, n, d), 0.5, dev), spikes(gen, (g, n, d), 0.6, dev),
                spikes(gen, (g, n, d), 0.4, dev),
                torch.randint(0, d, (g, n, n), generator=gen,
                              dtype=torch.int32).to(dev),
                torch.randint(0, n, (g, n, d), generator=gen,
                              dtype=torch.int32).to(dev))
        run = lambda args=args, c=causal: KS.ssa_attention_kernel(*args, causal=c)
        plain = lambda args=args, c=causal: KREF.ssa_attention_ref(*args, causal=c)
        got, want = run(), plain()
        check(torch.equal(got, want), f"K8 {name} tile differs")
        pairs = n * (n + 1) // 2 if causal else n * n
        k8[name] = dict(
            shape=(f"G={g} (T=4 x B=64 x H={g // 256}), N={n}, D={d}, "
                   + ("causal (paper GPT)" if causal else "non-causal (ViT)")
                   + ", draws given"),
            max_abs_err=max_abs_err(got, want), ms=time_ms(run),
            plain_ms=time_ms(plain),
            bound=bound(nbytes(args[:3], args[4], got) + 4 * g * pairs,
                        2 * 2 * g * pairs * d))
    results["ssa_attention_given"] = k8["vit"]
    results["ssa_attention_given_gpt"] = k8["gpt"]
    # K8 past the old N, D <= 512: N = 513 on the resident tile, and a tile
    # past a block's shared memory (N = 2,048, D = 512: K and V stream)
    long_tiles = {}
    for g, n, d, causal in ((64, 513, 64, False), (64, 513, 64, True),
                            (2, 2048, 512, True)):
        args = (spikes(gen, (g, n, d), 0.5, dev), spikes(gen, (g, n, d), 0.6, dev),
                spikes(gen, (g, n, d), 0.4, dev),
                torch.randint(0, d, (g, n, n), generator=gen,
                              dtype=torch.int32).to(dev),
                torch.randint(0, n, (g, n, d), generator=gen,
                              dtype=torch.int32).to(dev))
        got = KS.ssa_attention_kernel(*args, causal=causal)
        want = KREF.ssa_attention_ref(*args, causal=causal)
        check(torch.equal(got, want), f"K8 at G={g}, N={n}, D={d} differs")
        long_tiles[f"G={g}, N={n}, D={d}, causal={causal}"] = dict(
            design=KS.attention_plan(n, d).design,
            max_abs_err=max_abs_err(got, want))
        del args, got, want
    results["ssa_attention_given_long"] = long_tiles

    # K8 keyed (the paper forwards' and the LM stack's entry: the
    # comparators drawn in the kernel from the block's key, q/k/v read
    # through the heads view of [T, B, N, H*hd] trains, out written into a
    # [T, B, N, H, hd] buffer) at the ViT's and the paper GPT's tiles (the
    # kernels line reads the ViT's), the LM stack's causal tile and a mesh
    # rank's block of it, at N = 513 and at a streamed tile (G = 2, N =
    # 2,048, D = 512)
    for name, (t, b, h, n, d, causal, block) in KEYED_TILES.items():
        q, k, v = (heads(gen, (t, b, n, h, d), p, dev) for p in (0.5, 0.6, 0.4))
        key = torch.randint(0, 2 ** 32, (2,), generator=gen).to(dev)
        tile = {}
        if block is not None:
            b0, h0, nb, nh = block
            sl = (slice(None), slice(b0, b0 + nb), slice(h0, h0 + nh))
            whole = KS.ssa_attention_keyed_kernel(q, k, v, key, causal=causal)
            q, k, v = q[sl], k[sl], v[sl]
            tile = dict(b0=b0, h0=h0, batch=b, heads=h)
        run = (lambda q=q, k=k, v=v, key=key, c=causal, tile=tile:
               KS.ssa_attention_keyed_kernel(q, k, v, key, causal=c, **tile))
        plain = (lambda q=q, k=k, v=v, key=key, c=causal, tile=tile:
                 KREF.ssa_attention_keyed_ref(q, k, v, key, causal=c, **tile))
        got, want = run(), plain()
        check(torch.equal(got, want), f"keyed K8 {name} tile differs")
        check(got.movedim(-3, -2).is_contiguous(),
              f"keyed K8 {name}: not the heads view of a [T,B,N,H,hd] buffer")
        if block is not None:
            check(torch.equal(got, whole[sl]),
                  f"keyed K8 {name}: not the whole tile's block")
            del whole
        draws = tile_draws(q, k, v, key, causal, tile)
        r = dict(
            shape=(f"T={t} x B={q.shape[1]} x H={q.shape[2]} tiles, N={n}, "
                   f"D={d}, " + ("causal" if causal else "non-causal")
                   + " (heads views of [T,B,N,H*D] trains)"
                   + (f", the block from batch row {tile['b0']} and head "
                      f"{tile['h0']} of B={b} x H={h}" if tile else "")),
            entry="keyed: comparators drawn in the kernel, heads read and "
                  "written in place",
            design=KS.attention_plan(n, d).design,
            max_abs_err=max_abs_err(got, want), ms=time_ms(run),
            wrapper_host_us=host_us(run, 200), plain_ms=time_ms(plain),
            draws=draws, bound=keyed_tile_bound(q, k, v, key, got, draws,
                                                causal, pipes))
        if name in ("vit", "gpt", "lm", "lm_shard"):  # the profiler's time
            r["device_ms"] = device_ms(run, "ssa_attention_keyed")
        r["resources"] = keyed_resources(n, d)
        r["int32_issue_ms"] = int32_issue_ms(draws["issued"], pipes)
        results["ssa_attention" + ("" if name == "vit" else "_" + name)] = r
        del q, k, v, got, want
    results["ssa_attention"]["sass"] = sass
    torch.cuda.synchronize()

    # K4's counts entry (the row-parallel epilogue, what ShardedBackend's
    # row linears run after the all_reduce) at the (2, 2) mesh's shapes --
    # [T, 4 local slots, 256] at decode, [T, 1, 256] at prefill -- with no
    # bias (the LM stack's linears have none) and with one, and a ragged
    # width; its currents entry through ops.lif_fused (what Backend.lif
    # runs) at the same shapes and at the ViT's widest pre-activation (the
    # FFN's, B = 64).  Dyadic values put membranes exactly on the
    # threshold.  The kernels line reads the counts entry's decode shape.
    from repro_torch.kernels import lif as KL
    from repro_torch.kernels import ops as KOPS

    def dyadic(*shape):
        return (torch.randint(-4, 12, shape, generator=gen).float() / 8).to(dev)

    def lif_plain(c):
        return KREF.lif_ref(c.reshape(c.shape[0], -1)).reshape(c.shape)

    for label, shape, with_bias, what in (
            ("", (4, 4, 256), False, "the row-parallel linears' decode "
             "epilogue: 4 local slots x d_model 256, no bias"),
            ("_prefill", (4, 1, 256), False,
             "the batch-1 prefill row's epilogue"),
            ("_bias", (4, 4, 256), True, "the decode epilogue with a bias"),
            (None, (3, 5, 1001), False, "ragged"),
            (None, (3, 5, 1001), True, "ragged")):
        counts = torch.randint(-40, 41, shape, generator=gen).float().to(dev)
        n = shape[-1]
        scale = (torch.randint(1, 4, (n,), generator=gen).float() / 32).to(dev)
        bias = ((torch.randint(-4, 9, (n,), generator=gen).float() / 8).to(dev)
                if with_bias else None)
        run = (lambda c=counts, s_=scale, b_=bias:
               KL.lif_counts_kernel(c, s_, b_))
        plain = (lambda c=counts, s_=scale, b_=bias:
                 KREF.lif_counts_ref(c, s_, b_))
        got, want = run(), plain()
        check(torch.equal(got, want), f"K4 counts entry at {list(shape)} "
              f"(bias {bias is not None}) differs")
        if label is None:
            continue
        results["lif" + label] = dict(
            shape=f"{list(shape)} ({what})", entry="counts",
            max_abs_err=max_abs_err(got, want), ms=time_ms(run),
            plain_ms=time_ms(plain), device_ms=device_ms(run, "lif_kernel"),
            wrapper_host_us=host_us(run),
            bare_launch_host_us=host_us(bare_lif_counts(
                counts, scale, bias, torch.empty_like(got))),
            bound=bound(nbytes(counts, scale, bias, got),
                        (5 if bias is not None else 4) * counts.numel(),
                        FP32_OPS_PER_S))
        del counts, got, want
    for label, shape, what in (
            ("_currents", (4, 4, 256), "currents of the decode shape"),
            ("_vit", (4, 64 * 64 * 1536),
             "T x 64 images x 64 patches x d_ff=1536")):
        cur = dyadic(*shape)
        run = lambda cur=cur: KOPS.lif_fused(cur)  # noqa: E731
        got, want = run(), lif_plain(cur)
        check(torch.equal(got, want), f"K4 at {list(shape)} differs")
        r = results["lif" + label] = dict(
            shape=f"{list(shape)} ({what})", entry="currents",
            max_abs_err=max_abs_err(got, want), ms=time_ms(run),
            plain_ms=time_ms(lambda cur=cur: lif_plain(cur)),
            device_ms=device_ms(run, "lif_kernel"),
            bound=bound(nbytes(cur, got), 3 * cur.numel(), FP32_OPS_PER_S))
        if label == "_currents":  # host-bound: what a call costs the host
            r.update(wrapper_host_us=host_us(run),
                     bare_launch_host_us=host_us(bare_lif(
                         cur.reshape(shape[0], -1), torch.empty_like(got))))
        del cur, got, want
    edge = dyadic(3, 1001)
    check(torch.equal(KL.lif_kernel(edge, beta=0.25),
                      KREF.lif_ref(edge, beta=0.25)), "K4 edge differs")
    # the (2, 2) mesh's row-parallel linears on the card: one K5 and one K4
    # launch a call, no other op (the dispatcher), and no kernel but theirs
    # (the profiler)
    from repro_torch.configs import registry

    cfg = registry.get_config(ARCH)
    results["row_linear_dispatched"] = row_linear_dispatch(cfg)
    results["row_linear_kernels"] = row_linear_kernels(cfg)

    # division by a constant: PyTorch on CUDA divides by a Python number
    # through its reciprocal; the port's div_const must equal the CPU's IEEE
    # quotient, as K6's t / t0 and the column scales need
    from repro_torch.core import aimc as AM

    x = torch.rand(1_000_000, generator=gen) * 3
    want = x / 15
    results["division_by_15"] = dict(
        python_number_differs=int(((x.to(dev) / 15).cpu() != want).sum()),
        div_const_differs=int((AM.div_const(x.to(dev), 15).cpu() != want)
                              .sum()), n=x.numel())
    check(results["division_by_15"]["div_const_differs"] == 0,
          "div_const on the card differs from the CPU's division")

    # K6, grouped: one leaf at the ViT's widest (w1, [384, 1536]), the LM
    # stack's stacked mlp.wi leaf ([4, 256, 1024]: a time and a gain per
    # layer) and a ragged shape, at t = 0, t < t0, an hour and a year,
    # gains 1 and 7 (1 / img_inv rounded on the card); then trees of 1, 6,
    # 26 and 40 leaves of mixed shapes, every third one's rows unaligned,
    # one leaf at t = 0: images and calibration reads
    from repro_torch.kernels import drift_requantize as KD

    k6 = {}
    for shape in ((384, 1536), (4, 256, 1024), (300, 17)):
        for t in (0.0, 10.0, 3600.0, 3.1536e7):
            for gain in (1.0, 7.0):
                leaf = fold_leaf(gen, shape, dev, gains=(gain, 8.0),
                                 times=(t, 86400.0))
                (got,) = KD.drift_fold_kernel([leaf], t0=T0)
                (want,) = KREF.drift_fold_leaves_ref([leaf], t0=T0)
                check(torch.equal(got, want),
                      f"K6 {shape} t={t} gain={gain} differs")
                k6[(shape, t, gain)] = max_abs_err(got, want)
    groups = {}
    for n_leaves in (1, 6, 26, 40):
        leaves = [fold_leaf(gen, FOLD_SHAPES[i % len(FOLD_SHAPES)], dev,
                            offset=1 if i % 3 == 2 else 0,
                            gains=(7.0, 1.0, 8.0, 7.4),
                            times=(3600.0 * (i + 1), 10.0, 3.1536e7))
                  for i in range(n_leaves)]
        leaves[-1] = leaves[-1]._replace(t_seconds=None)
        n = KB.LAUNCHES["drift_requantize"]
        got = KD.drift_fold_kernel(leaves, t0=T0)
        sums = KD.drift_abs_sums_kernel(leaves, t0=T0)
        chunks = -(-n_leaves // KD.MAX_LEAVES)
        check(KB.LAUNCHES["drift_requantize"] == n + 2 * chunks,
              f"K6 over {n_leaves} leaves: not {chunks} launch(es) a call")
        want = KREF.drift_fold_leaves_ref(leaves, t0=T0)
        check(all(torch.equal(g, w_) for g, w_ in zip(got, want)),
              f"K6 over {n_leaves} leaves differs")
        check(torch.equal(sums, KREF.drift_abs_sums_ref(leaves, t0=T0)),
              f"K6's calibration read over {n_leaves} leaves differs")
        k6[("group", n_leaves)] = max(max_abs_err(g, w_)
                                      for g, w_ in zip(got, want))
        groups[n_leaves] = dict(
            launches_a_call=chunks,
            elements=sum(x.levels.numel() for x in leaves),
            ms=time_ms(lambda leaves=leaves: KD.drift_fold_kernel(
                leaves, t0=T0)),
            wrapper_host_us=host_us(lambda leaves=leaves: KD.drift_fold_kernel(
                leaves, t0=T0), 200))
        del leaves, got, want, sums
    leaf = fold_leaf(gen, (384, 1536), dev, gains=(7.0,), times=(3600.0,))
    (got,) = KD.drift_fold_kernel([leaf], t0=T0)
    run = lambda: KD.drift_fold_kernel([leaf], t0=T0)  # noqa: E731
    # 7.7 MB of operands fit the 50 MB L2: the flushed reading reads 64 MB
    # between launches (a read leaves no dirty line for the fold to write
    # back), as a fold every few serving steps finds them
    flush = torch.ones(64 << 20, dtype=torch.uint8, device=dev)
    results["drift_requantize"] = dict(
        shape="one leaf [384, 1536] (the ViT-4-384's w1), t = 1 h, gain 7",
        cases=len(k6), max_abs_err=max(k6.values()),
        ms=time_ms(run),
        plain_ms=time_ms(lambda: KREF.drift_fold_leaves_ref([leaf], t0=T0)),
        device_ms=device_ms(lambda: (flush.sum(), run()),
                            "drift_fold_kernel"),
        device_ms_l2_warm=device_ms(run, "drift_fold_kernel"),
        wrapper_host_us=host_us(run),
        bare_launch_host_us=host_us(bare_fold([leaf], [got])),
        groups=groups,
        bound=bound(nbytes(leaf, got), K6_OPS * got.numel(), FP32_OPS_PER_S))
    del flush
    torch.cuda.synchronize()
    return results


# ---------------------------------------------------------------------------
# Phase 3: serve the full-width spiking GPT
# ---------------------------------------------------------------------------


def make_requests(vocab: int, n: int = 16):
    gen = torch.Generator().manual_seed(7)
    lens = torch.randint(8, 33, (n,), generator=gen).tolist()
    return [torch.randint(0, vocab, (k,), generator=gen).tolist() for k in lens]


def drive(sch, prompts, max_new: int, wave: int = 4, gap: int = 8):
    """Submit ``wave`` requests every ``gap`` steps (so later admissions
    land while earlier requests decode), then serve to the end."""
    rids = []
    t0 = time.perf_counter()
    for i in range(0, len(prompts), wave):
        rids += [sch.submit(p, max_new, seed=1000 + i + j)
                 for j, p in enumerate(prompts[i:i + wave])]
        for _ in range(gap):
            sch.step()
    out = sch.run()
    torch.cuda.synchronize()
    return [out[r] for r in rids], time.perf_counter() - t0


def request_energies(sch) -> list:
    """The metered joules of each request of the scheduler's run since
    its last reset, in submission order."""
    return [sch.request_energy_j[r] for r in sorted(sch.request_energy_j)]


def profile_window(fn) -> dict:
    """One call of ``fn`` under torch.profiler: wall time, the card's busy
    time (sum of kernel times; one stream, so they do not overlap), the
    idle share, the kernel count, the four costliest kernels and the six
    host operations of most self time (the profiler's clock).  The
    profiler's own host cost lengthens the wall time, so the idle share is
    an upper bound; ``None`` where the trace shows no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:4]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                idle_share=(1 - busy_ms / wall_ms) if busy_ms else None,
                kernels=sum(e.count for e in kern),
                top=[[e.key[:70], e.count, e.self_device_time_total / 1e3]
                     for e in top],
                host_top=[[e.key[:70], e.count, e.self_cpu_time_total / 1e3]
                          for e in sorted(prof.key_averages(),
                                          key=lambda e: -e.self_cpu_time_total)
                          [:6]])


def phase_serve(dev):
    from repro_torch.engine import XpikeformerEngine, get_backend
    from repro_torch.kernels import build as KB
    from repro_torch.models import transformer as T

    eng = XpikeformerEngine.from_config(ARCH, task="lm", backend="cuda",
                                        device=dev)
    cfg = eng.cfg
    eng.init(seed=0)
    prompts = make_requests(cfg.vocab_size)
    max_new = 32
    sch = eng.scheduler(slots=8, cache_len=256)
    check(sch.plan.fused, f"decode plan is not fused: {sch.plan.describe()}")
    drive(sch, prompts[:2], 4)  # warm-up: first cuBLAS/allocator calls
    sch.reset()

    KB.reset_launches()
    outs, wall_s = drive(sch, prompts, max_new)
    launches = dict(KB.LAUNCHES)
    energy = request_energies(sch)
    st = sch.stats
    layers = cfg.num_layers
    check(st.admissions == len(prompts) and st.evictions == len(prompts),
          "not every request was admitted and evicted")
    check(all(len(o) == max_new for o in outs), "a request got too few tokens")
    check(all(0 <= tok < cfg.vocab_size for o in outs for tok in o),
          "a token is out of the vocabulary")
    check(launches["fused_decode_layer"] == layers * st.decode_steps,
          f"K3 launches {launches['fused_decode_layer']} != "
          f"{layers} layers x {st.decode_steps} steps")
    check(launches["ssa_decode"] == layers * st.prefill_tokens > 0,
          f"K2 launches {launches['ssa_decode']} != {layers} x "
          f"{st.prefill_tokens} prefill positions")
    check(launches["aimc_spiking_linear"] == 6 * layers * st.prefill_tokens,
          f"K1 launches {launches['aimc_spiking_linear']} != 6 x {layers} x "
          f"{st.prefill_tokens}")
    served = dict(
        tokens=st.decoded_tokens, decode_steps=st.decode_steps,
        prefill_tokens=st.prefill_tokens, admissions=st.admissions,
        peak_active_slots=st.peak_active_slots, wall_s=wall_s,
        decode_s=st.decode_s, prefill_s=st.prefill_s,
        tokens_per_s=st.decoded_tokens / wall_s,
        decode_tokens_per_s=st.decode_tokens_per_sec,
        decode_step_ms=1e3 * st.decode_s / st.decode_steps,
        prefill_token_ms=1e3 * st.prefill_s / st.prefill_tokens,
        request_energy_j=energy)

    # where a step's time goes: one admission (15 prefill positions), then
    # three decode steps of 8 busy slots
    sch.reset()
    sch.submit(list(range(16)), 4, seed=1)
    prof = served["profile_prefill_15_positions"] = profile_window(sch.admit)
    served["kernels_per_prefill_position"] = prof["kernels"] / 15
    check(served["kernels_per_prefill_position"] < 2000,
          f"a dense prefill position launched "
          f"{served['kernels_per_prefill_position']} kernels (the keyed K2 "
          "draws on the card)")
    for i, p in enumerate(prompts[1:8]):
        sch.submit(p, 8, seed=2 + i)
    sch.admit()
    served["profile_decode_3_steps"] = profile_window(
        lambda: [sch.step() for _ in range(3)])

    # the same requests through the plain versions on the card
    plain = XpikeformerEngine(cfg=cfg, backend=get_backend("integer"),
                              device=eng.device, params=eng.params)
    psch = plain.scheduler(slots=8, cache_len=256)
    pouts, served["plain_wall_s"] = drive(psch, prompts, max_new)
    check(pouts == outs, "kernel and plain token streams differ")

    # one batched step's logits: finite, of the expected shape
    cache = T.init_cache(cfg, 8, 256, dev)
    toks = torch.arange(8, device=dev).view(8, 1)
    logits, _ = T.decode_step(sch.params, cache, toks, cfg, backend=eng.backend,
                              seeds=torch.arange(8, device=dev), plan=sch.plan)
    check(tuple(logits.shape) == (8, 1, cfg.vocab_size), "logits shape")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")

    # the reduced config: card (kernels) == CPU (plain versions)
    small = {}
    for d, backend in (("cpu", "integer"), (dev, "cuda")):
        e = XpikeformerEngine.from_config(ARCH, task="lm", reduced=True,
                                          backend=backend, device=d)
        e.init(seed=3)
        small[str(d)], _ = e.serve(prompts[:3], 8, slots=2, cache_len=64)
    check(small["cpu"] == small[str(dev)], "reduced config: card != CPU")
    served["reduced_config_matches_cpu"] = True
    return eng, launches, served, outs


# ---------------------------------------------------------------------------
# Phase 4: paged serving of the same model
# ---------------------------------------------------------------------------


def paged_requests(vocab: int, n: int = 16):
    """The chat pattern the prefix cache serves: ``n`` prompts of 8-32
    tokens; the even ones open with one 16-token system prompt (two full
    pages), and requests 1/9 and 5/13 share a 12-token context (one full
    page and a partial one, so the second of each pair copies on write)."""
    gen = torch.Generator().manual_seed(11)
    lens = torch.randint(8, 33, (n,), generator=gen).tolist()
    prompts = [torch.randint(0, vocab, (k,), generator=gen).tolist()
               for k in lens]
    system = torch.randint(0, vocab, (16,), generator=gen).tolist()
    for i in range(0, n, 2):
        prompts[i] = system + prompts[i][:max(lens[i], 17) - 16]
    for a, b in ((1, 9), (5, 13)):
        ctx = torch.randint(0, vocab, (12,), generator=gen).tolist()
        prompts[a] = ctx + prompts[a][-1:]
        prompts[b] = ctx + prompts[b][-1:]
    return prompts


def phase_paged(dev, eng):
    from repro_torch.engine import XpikeformerEngine, get_backend
    from repro_torch.kernels import build as KB

    cfg = eng.cfg
    layers = cfg.num_layers
    prompts = paged_requests(cfg.vocab_size)
    max_new = 32
    sch = eng.scheduler(slots=8, cache_len=256, paged=True, page_len=8)
    check(sch.plan.fused and sch.plan.layout == "paged",
          f"paged plan: {sch.plan.describe()}")
    check(sch.n_pages == 8 * 32 + 2, f"default pool of {sch.n_pages} pages")
    drive(sch, prompts[:2], 4)  # warm-up
    sch.reset()

    KB.reset_launches()
    outs, wall_s = drive(sch, prompts, max_new)
    launches = dict(KB.LAUNCHES)
    energy = request_energies(sch)
    st = sch.stats
    check(st.admissions == len(prompts) and st.evictions == len(prompts),
          "paged: not every request was admitted and evicted")
    check(all(len(o) == max_new for o in outs), "paged: too few tokens")
    check(all(0 <= tok < cfg.vocab_size for o in outs for tok in o),
          "paged: a token is out of the vocabulary")
    check(launches["fused_decode_layer_paged"] == layers * st.decode_steps > 0,
          f"K9 launches {launches['fused_decode_layer_paged']} != "
          f"{layers} layers x {st.decode_steps} steps")
    others = {k: v for k, v in launches.items()
              if k != "fused_decode_layer_paged" and v}
    check(not others, f"the paged path launched other kernels: {others}")
    check(st.prefix_hits > 0, "paged: no prefix-cache hit")
    check(st.cow_copies > 0, "paged: no copy-on-write")
    served = dict(
        tokens=st.decoded_tokens, decode_steps=st.decode_steps,
        prefill_tokens=st.prefill_tokens, admissions=st.admissions,
        prefix_hits=st.prefix_hits, prefix_hit_tokens=st.prefix_hit_tokens,
        cow_copies=st.cow_copies, pages_in_use_peak=st.pages_in_use_peak,
        peak_active_slots=st.peak_active_slots, wall_s=wall_s,
        decode_s=st.decode_s, tokens_per_s=st.decoded_tokens / wall_s,
        decode_step_ms=1e3 * st.decode_s / st.decode_steps,
        request_energy_j=energy)

    # where a step's time goes: three steps of 8 busy slots
    sch.reset()
    for i, p in enumerate(prompts[:8]):
        sch.submit(p, 8, seed=2 + i)
    sch.step()
    served["profile_paged_3_steps"] = profile_window(
        lambda: [sch.step() for _ in range(3)])

    # the same requests through the dense port and the plain versions
    douts, served["dense_wall_s"] = drive(
        eng.scheduler(slots=8, cache_len=256), prompts, max_new)
    check(douts == outs, "paged and dense token streams differ")
    plain = XpikeformerEngine(cfg=cfg, backend=get_backend("integer"),
                              device=eng.device, params=eng.params)
    pouts, served["plain_wall_s"] = drive(
        plain.scheduler(slots=8, cache_len=256, paged=True, page_len=8),
        prompts, max_new)
    check(pouts == outs, "paged kernel and plain token streams differ")

    # the unfused paged plan: K7 on every layer and step
    usch = eng.scheduler(slots=8, cache_len=256, paged=True, page_len=8,
                         decode_kernel="unfused")
    KB.reset_launches()
    uouts, served["unfused_wall_s"] = drive(usch, prompts[:4], max_new)
    ulaunches = dict(KB.LAUNCHES)
    ust = usch.stats
    check(ulaunches["ssa_decode_paged"] == layers * ust.decode_steps > 0,
          f"K7 launches {ulaunches['ssa_decode_paged']} != {layers} layers x "
          f"{ust.decode_steps} steps")
    check(ulaunches["aimc_spiking_linear"] == 6 * layers * ust.decode_steps,
          "unfused paged: K1 is not six launches per layer and step")
    check(ulaunches["fused_decode_layer_paged"] == 0, "unfused ran K9")
    check(uouts == outs[:4], "unfused paged tokens differ")
    served.update(unfused_decode_steps=ust.decode_steps,
                  unfused_tokens_per_s=ust.decoded_tokens
                  / served["unfused_wall_s"],
                  unfused_decode_step_ms=1e3 * ust.decode_s / ust.decode_steps)
    # where an unfused step's time goes: three steps of 8 busy slots; the
    # keyed K7 draws on the card, so no step launches the twin's ~5,600
    # draw kernels for it
    usch.reset()
    for i, p in enumerate(prompts[:8]):
        usch.submit(p, 8, seed=2 + i)
    usch.step()
    prof = served["profile_unfused_paged_3_steps"] = profile_window(
        lambda: [usch.step() for _ in range(3)])
    served["unfused_kernels_per_step"] = prof["kernels"] / 3
    check(served["unfused_kernels_per_step"] < 2000,
          f"an unfused paged step launched {served['unfused_kernels_per_step']}"
          " kernels (the keyed K7 draws on the card)")
    return launches, ulaunches, served, outs


# ---------------------------------------------------------------------------
# Phase front_door: the HTTP/SSE front door and the telemetry
# ---------------------------------------------------------------------------


FD_TENANTS = ("interactive", "batch", "metered")  # request i: i % 3
FD_PROFILE_STEPS = 3
# one Prometheus text 0.0.4 sample: series (name and labels), value
PROM_SAMPLE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|'
    r'\\.)*"(,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*\})?) '
    r'(-?(\d+(\.\d+)?([eE][+-]?\d+)?|\+Inf|inf|nan))$')


def parse_prometheus(text: str) -> dict:
    """Prometheus text 0.0.4 -> {series: value}; raises on a line that is
    neither a HELP/TYPE comment nor a well-formed sample."""
    check(text.endswith("\n"), "a /metrics scrape does not end in a newline")
    out = {}
    for line in text.rstrip("\n").split("\n"):
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            continue
        m = PROM_SAMPLE.match(line)
        check(m is not None, f"malformed /metrics line: {line!r}")
        out[m.group(1)] = float(m.group(4))
    return out


async def http_call(host: str, port: int, path: str, body=None):
    """One HTTP/1.1 request over a socket: ``GET path`` returns the raw
    response; with a JSON ``body``, ``POST /generate`` reads its SSE
    stream and returns (token ids, the done payload)."""
    from repro_torch.server import generate, http_request

    if body is None:
        return await http_request(host, port, "GET", path)
    toks, done, error = await generate(host, port, body)
    check(error is None, f"SSE error event: {error}")
    return toks, done


def percentile(xs, q: float) -> float:
    """Nearest-rank percentile."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, round(q / 100 * (len(xs) - 1))))]


def admits(events) -> dict:
    """The scheduler's ADMIT trace events: rid -> prefix-hit tokens (0 on
    the dense path)."""
    return {e["rid"]: e.get("prefix_hit_tokens", 0) for e in events
            if e["event"] == "admit" and "slot" in e}


def timed(fn, spent: list):
    """``fn`` adding its host seconds to ``spent[0]``."""
    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            spent[0] += time.perf_counter() - t0
    return wrapper


def serve_http(sch, prompts, max_new: int, energy_scale: float,
               refill_j_per_s: float, out_dir: str):
    """Serve ``prompts`` (request ``i`` on seed ``1000 + i``, the direct
    runs' streams) through ``HttpFrontDoor`` on 127.0.0.1, as the three
    :data:`FD_TENANTS`: ``interactive`` at priority 0, ``batch`` and
    ``metered`` at 1; ``metered`` holds a joule bucket of
    ``energy_scale`` with ``preempt=True`` and no refill until its first
    preemption is recorded, when the operator loop turns a refill of
    ``refill_j_per_s`` on.  The telemetry holds a
    :data:`FD_PROFILE_STEPS`-step profiler window, which the pump thread
    opens and closes (the ``--http --profile-steps`` path).  Returns the
    streams, results, records, trace events, the profiler and its own
    host seconds, two ``/metrics`` scrapes (mid-run, after the streams)
    and the makespan."""
    import asyncio

    from repro_torch.obs import ListSink, StepProfiler, Telemetry
    from repro_torch.server import (FrontDoor, HttpFrontDoor, TenantPolicy,
                                    admission as ADM)

    sch.reset()
    prof = StepProfiler(FD_PROFILE_STEPS, out_dir)
    prof_s = [0.0]
    prof._start = timed(prof._start, prof_s)
    prof.stop = timed(prof.stop, prof_s)
    obs = Telemetry.create(flight_dir=out_dir, profiler=prof)
    sink = ListSink()
    obs.tracer.add_sink(sink)
    metered = dict(priority=1, energy_budget_j=energy_scale, preempt=True)
    front = FrontDoor(sch, telemetry=obs, policies={
        "interactive": TenantPolicy(priority=0),
        "batch": TenantPolicy(priority=1),
        "metered": TenantPolicy(refill_j_per_s=0.0, **metered)})

    async def operator():
        while not any(r.decision == ADM.PREEMPT_ENERGY
                      for r in front.adm.records):
            await asyncio.sleep(0.005)
        front.adm.set_policy("metered", TenantPolicy(
            refill_j_per_s=refill_j_per_s, **metered))

    async def go():
        async with HttpFrontDoor(front, host="127.0.0.1", port=0) as srv:
            op = asyncio.create_task(operator())
            t0 = time.perf_counter()
            gens = [asyncio.create_task(http_call(
                srv.host, srv.port, "/generate",
                dict(prompt=p, max_new=max_new, seed=1000 + i,
                     tenant=FD_TENANTS[i % 3])))
                for i, p in enumerate(prompts)]
            await asyncio.sleep(0.5)
            live = await http_call(srv.host, srv.port, "/metrics")
            got = await asyncio.gather(*gens)
            makespan = time.perf_counter() - t0
            done = await http_call(srv.host, srv.port, "/metrics")
            stats = json.loads((await http_call(
                srv.host, srv.port, "/stats")).split(b"\r\n\r\n", 1)[1])
            preempted = op.done()
            op.cancel()
            return got, live, done, stats, makespan, preempted

    got, live, done, stats, makespan, preempted = asyncio.run(go())
    sch.detach_obs()
    check(preempted, "the metered tenant was never preempted")
    return dict(front=front, got=got, live=live, done=done, stats=stats,
                makespan=makespan, events=sink.events, prof=prof,
                prof_s=prof_s[0])


def front_door_layout(eng, name: str, prompts, direct_outs, direct,
                      direct_launches) -> dict:
    """One layout of the front_door phase (``direct``: phase 3 or 4's
    served dict, telemetry off): the 16 requests with telemetry attached
    (no profiler), then detached, each against the direct run; then the
    same requests through HTTP with a :data:`FD_PROFILE_STEPS`-step
    profiler window in the pump thread."""
    from repro_torch.kernels import build as KB
    from repro_torch.obs import ListSink, Telemetry

    paged = name == "paged"
    kw = dict(paged=True, page_len=8) if paged else {}
    sch = eng.scheduler(slots=8, cache_len=256, **kw)
    layers = eng.cfg.num_layers
    max_new = 32
    direct_energy = direct["request_energy_j"]
    res = {}

    def leg() -> dict:
        sch.reset()
        KB.reset_launches()
        outs, wall_s = drive(sch, prompts, max_new)
        st = sch.stats
        check(outs == direct_outs, f"{name}: telemetry "
              f"{'on' if sch.obs else 'off'} changed the tokens")
        check(request_energies(sch) == direct_energy,
              f"{name}: telemetry {'on' if sch.obs else 'off'} changed the "
              "energy")
        return dict(launches=dict(KB.LAUNCHES), wall_s=wall_s,
                    tokens_per_s=st.decoded_tokens / wall_s,
                    decode_step_ms=1e3 * st.decode_s / st.decode_steps,
                    decode_steps=st.decode_steps)

    # telemetry on, unprofiled, between two runs without it (phase 3/4's
    # and the next): the same tokens, joules and launches, and the host
    # seconds the telemetry itself took (every trace event and per-step
    # hook timed)
    sink = ListSink()
    spent = [0.0]
    with tempfile.TemporaryDirectory() as tmp:
        obs = Telemetry.create(flight_dir=tmp)
        obs.tracer.add_sink(sink)
        obs.trace = timed(obs.trace, spent)
        sch._obs_step = timed(sch._obs_step, spent)
        sch.attach_obs(obs)
        try:
            on = leg()
        finally:
            sch.detach_obs()
            del sch._obs_step
    check(on["launches"] == direct_launches,
          f"{name}: telemetry changed the kernel launches: {on['launches']} "
          f"!= {direct_launches}")
    off = leg()
    check(off["launches"] == direct_launches, f"{name}: launches off")
    direct_hits = admits(sink.events)
    direct_hits = [direct_hits[r] for r in sorted(direct_hits)]
    rel = on["tokens_per_s"] / off["tokens_per_s"]
    spread = abs(direct["tokens_per_s"] / off["tokens_per_s"] - 1)
    res["telemetry"] = dict(
        tokens_per_s_on=on["tokens_per_s"],
        tokens_per_s_off=off["tokens_per_s"],
        tokens_per_s_direct=direct["tokens_per_s"],
        wall_s_on=on["wall_s"], wall_s_off=off["wall_s"],
        wall_s_direct=direct["wall_s"],
        decode_step_ms_on=on["decode_step_ms"],
        decode_step_ms_off=off["decode_step_ms"],
        decode_step_ms_direct=direct["decode_step_ms"],
        obs_overhead_rel=rel, off_runs_spread_rel=spread,
        obs_host_s=spent[0], obs_host_share=spent[0] / on["wall_s"],
        obs_host_us_per_step=1e6 * spent[0] / on["decode_steps"],
        decode_steps=on["decode_steps"], trace_events=len(sink.events),
        launches_per_step={k: v / on["decode_steps"]
                           for k, v in on["launches"].items() if v})

    # through HTTP/SSE: three tenants, one preempted by its joule bucket;
    # the pump thread's profiler window over steps 1-3 (K3 / K9 4 a step)
    e_min = min(direct_energy[2::3])
    KB.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        run = serve_http(sch, prompts, max_new, 0.25 * e_min,
                         50 * sum(direct_energy) / (len(prompts) * max_new)
                         * direct["tokens_per_s"], tmp)
        prof = run["prof"]
        check(prof.state == "done", f"{name}: profiler window {prof.state}: "
              f"{prof.error}")
        with open(prof.trace_path) as f:
            trace = json.load(f)
        size = Path(prof.trace_path).stat().st_size
    launches = dict(KB.LAUNCHES)
    kernel = "fused_decode_layer_paged" if paged else "fused_decode_layer"
    cache = "PagedCache" if paged else "DenseCache"
    kern = [e for e in trace["traceEvents"] if e.get("cat") == "kernel"]
    del trace
    k39 = [e for e in kern if "fused_decode_layer_kernel" in e["name"]
           and cache in e["name"]]
    check(len(k39) == layers * FD_PROFILE_STEPS,
          f"{name}: the profiler window holds {len(k39)} {kernel} launches, "
          f"not {layers} x {FD_PROFILE_STEPS} steps")
    res["profiler"] = dict(state=prof.state, steps=FD_PROFILE_STEPS,
                           thread="pump", kernels=len(kern), k3_k9=len(k39),
                           k3_k9_device_ms=sum(e["dur"] for e in k39) / 1e3,
                           host_s=run["prof_s"], trace_mb=size / 2**20)
    st = sch.stats
    front = run["front"]
    check(launches[kernel] == layers * st.decode_steps > 0,
          f"{name} HTTP: {kernel} launches {launches[kernel]} != {layers} x "
          f"{st.decode_steps} steps")
    if not paged:
        check(launches["aimc_spiking_linear"] == 6 * layers * st.prefill_tokens
              and launches["ssa_decode"] == layers * st.prefill_tokens,
              f"dense HTTP: K1/K2 launches {launches} for "
              f"{st.prefill_tokens} prefill positions")
    for i, ((toks, done), want) in enumerate(zip(run["got"], direct_outs)):
        check(toks == want and done is not None and done["tokens"] == want,
              f"{name} HTTP: request {i}'s stream differs from the direct run")
    # fid -> the scheduler rids it ran as (one a streak)
    rids = collections.defaultdict(list)
    for e in run["events"]:
        if e["event"] in ("admit", "readmit") and "fid" in e:
            rids[e["fid"]].append(e["rid"])
    hits = admits(run["events"])
    results = {r.request_id: r for r in front.results}
    check(len(results) == len(prompts), f"{name} HTTP: missing results")
    fid_of = {done["request_id"]: i for i, (_, done) in enumerate(run["got"])}
    compared = 0
    preempted_tenants = {results[f].tenant for f in results
                         if results[f].preemptions}
    check(preempted_tenants == {"metered"},
          f"{name} HTTP: preempted tenants {preempted_tenants}")
    for fid, r in results.items():
        i = fid_of[fid]
        check(r.tenant == FD_TENANTS[i % 3], f"{name}: tenant of {i}")
        booked = sum(sch.request_energy_j[rid] for rid in rids[fid])
        check(math.isclose(r.energy_j, booked, rel_tol=1e-9),
              f"{name} HTTP: request {i} streamed {r.energy_j} J, booked "
              f"{booked}")
        if r.preemptions:
            check(len(rids[fid]) == r.preemptions + 1 and
                  r.energy_j > direct_energy[i],
                  f"{name} HTTP: request {i}'s replays were not charged")
            continue
        (rid,) = rids[fid]
        if hits[rid] != direct_hits[i]:
            continue  # the prefix cache skipped other prompt positions
        compared += 1
        check(sch.request_energy_j[rid] == direct_energy[i],
              f"{name} HTTP: request {i} booked {sch.request_energy_j[rid]} "
              f"J, the direct run {direct_energy[i]}")
    check(compared >= 1, f"{name} HTTP: no request's energy compared")
    check(front.preemptions >= 1, f"{name}: no preemption")
    records = collections.Counter(r.decision for r in front.adm.records)
    check(records["readmit"] >= 1, f"{name}: no re-admission")
    # the scrapes parse; the counters mirror ServeStats
    for key in ("live", "done"):
        head, _, body = run[key].partition(b"\r\n\r\n")
        check(b" 200 " in head.split(b"\r\n", 1)[0] and
              b"text/plain; version=0.0.4" in head, f"{name}: /metrics {key}")
        run[key] = parse_prometheus(body.decode())
    scrape = run["done"]
    check(scrape["xpike_decoded_tokens_total"] == st.decoded_tokens,
          f"{name}: decoded_tokens_total {scrape['xpike_decoded_tokens_total']}"
          f" != {st.decoded_tokens}")
    check(math.isclose(scrape["xpike_energy_joules_total"], st.energy_j,
                       rel_tol=1e-12),
          f"{name}: energy_joules_total {scrape['xpike_energy_joules_total']}"
          f" != {st.energy_j}")
    check(run["stats"]["scheduler"]["decoded_tokens"] == st.decoded_tokens,
          f"{name}: /stats")
    ttft = [r.ttft_s for r in results.values()]
    delivered = sum(len(t) for t, _ in run["got"])
    res["http"] = dict(
        requests=len(prompts), tokens=delivered,
        decoded_tokens=st.decoded_tokens, makespan_s=run["makespan"],
        tokens_per_s=delivered / run["makespan"],
        tokens_per_s_less_profiler=delivered / (run["makespan"]
                                                - run["prof_s"]),
        direct_tokens_per_s=direct["tokens_per_s"],
        profiler_host_s=run["prof_s"],
        ttft_p50_s=percentile(ttft, 50), ttft_p99_s=percentile(ttft, 99),
        ttft_by_tenant={t: percentile([r.ttft_s for r in results.values()
                                       if r.tenant == t], 50)
                        for t in FD_TENANTS},
        decode_steps=st.decode_steps, prefill_tokens=st.prefill_tokens,
        preemptions=front.preemptions, records=dict(records),
        energy_compared=compared, bucket_j=0.25 * e_min,
        live_scrape_series=len(run["live"]),
        metered_energy_j=sum(r.energy_j for r in results.values()
                             if r.tenant == "metered"),
        metered_direct_energy_j=sum(direct_energy[2::3]),
        launches={k: v for k, v in launches.items() if v})
    return res


def phase_front_door(eng, dense, paged) -> dict:
    """The front door and the telemetry over the card's decode path, dense
    then paged (``dense``/``paged``: the direct streams, the served dict
    and the launches of phase 3 / 4): telemetry on against off at the
    served size, HTTP/SSE against the direct runs, the metrics scrape,
    the pump thread's profiler window."""
    cfg = eng.cfg
    out = {}
    for name, prompts, (direct, srv, launches) in (
            ("dense", make_requests(cfg.vocab_size), dense),
            ("paged", paged_requests(cfg.vocab_size), paged)):
        t0 = time.perf_counter()
        out[name] = front_door_layout(eng, name, prompts, direct, srv,
                                      launches)
        out[name]["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# Phase 5: the paper models' forward
# ---------------------------------------------------------------------------


def paper_inputs(task: str, cfg, batch: int, dev):
    from repro_torch.data import icl_mimo as MIMO
    from repro_torch.data import synthetic_images as SI

    if task == "vit":
        return SI.sample_batch(17, SI.ImageConfig(size=cfg.image_size),
                               batch, dev)["images"], None
    data = MIMO.sample_batch(17, MIMO.MIMOConfig(), batch, dev)
    return data["features"], data


def forward_draws(eng, x, key) -> dict:
    """:func:`tile_draws` summed over a forward's blocks, on the operands
    each block hands ``Backend.ssa_attention`` (recorded on the way), and
    the keyed K8's time a launch on the first block's (CUDA events)."""
    from repro_torch.kernels import ssa_attention as KS

    seen = []
    inner = eng.backend.ssa_attention

    def record(k, q, kk, v, *, causal=False, **tile):
        seen.append((k, q, kk, v, causal))
        return inner(k, q, kk, v, causal=causal, **tile)

    eng.backend.ssa_attention = record
    try:
        eng.forward(x, key)
    finally:
        del eng.backend.ssa_attention
    total = collections.Counter()
    for k, q, kk, v, causal in seen:
        total.update(tile_draws(q, kk, v, k, causal))
    k, q, kk, v, causal = seen[0]
    return dict(total, block0_ms=time_ms(
        lambda: KS.ssa_attention_keyed_kernel(q, kk, v, k, causal=causal)))


def baseline_modes(eng, plain, x, key) -> dict:
    """The paper's baseline rows on the same weights and inputs: ``"lif"``
    (the spiking blocks with the LIF attention: K1 six times a block, no
    K8), whose logits on the kernels' backend must equal the plain one's
    bit for bit, and ``"ann"`` (the float transformer: no kernel of the
    port, so no backend changes its result); for each, its launches and
    the unprofiled median wall of 3 forwards."""
    import dataclasses

    from repro_torch.kernels import build as KB

    out = {}
    for mode in ("lif", "ann"):
        cfg = dataclasses.replace(eng.cfg, mode=mode)
        me, mp = (dataclasses.replace(e, cfg=cfg) for e in (eng, plain))
        me.forward(x, key)  # warm-up
        KB.reset_launches()
        logits = me.forward(x, key)
        torch.cuda.synchronize()
        got = {k: v for k, v in KB.LAUNCHES.items() if v}
        want = ({"aimc_spiking_linear": 6 * cfg.depth} if mode == "lif"
                else {})
        check(got == want, f"{mode} mode launched {got}, not {want}")
        check(bool(torch.isfinite(logits).all()), f"{mode}: non-finite")
        r = out[mode] = dict(launches_per_forward=got,
                             forward_ms=wall_ms(lambda: me.forward(x, key), 3),
                             labels_head=logits.argmax(-1).reshape(-1)[:8]
                             .tolist())
        if mode == "lif":
            check(torch.equal(logits, mp.forward(x, key)),
                  "lif mode: kernel and plain logits differ")
            r.update(logits_bitwise_equal=True, plain_forward_ms=wall_ms(
                lambda: mp.forward(x, key), 3))
    return out


def phase_paper(dev):
    import dataclasses

    from repro_torch import prng
    from repro_torch.data import icl_mimo as MIMO
    from repro_torch.engine import XpikeformerEngine, get_backend
    from repro_torch.kernels import build as KB

    out, launches = {}, {}
    key = prng.PRNGKey(42, dev)
    for name, batch in PAPER:
        eng = XpikeformerEngine.from_config(name, backend="cuda", device=dev)
        cfg, task = eng.cfg, eng.task
        eng.init(seed=0)
        x, data = paper_inputs(task, cfg, batch, dev)
        plain = XpikeformerEngine(cfg=cfg, backend=get_backend("integer"),
                                  device=eng.device, params=eng.params,
                                  task=task)
        eng.forward(x, key)  # warm-up: first cuBLAS/allocator calls
        KB.reset_launches()
        logits = eng.forward(x, key)
        torch.cuda.synchronize()
        got = dict(KB.LAUNCHES)
        launches[name] = got
        check(got["ssa_attention_keyed"] == cfg.depth,
              f"{name}: keyed K8 launches {got['ssa_attention_keyed']} != "
              f"{cfg.depth} blocks")
        check(got["aimc_spiking_linear"] == 6 * cfg.depth,
              f"{name}: K1 launches {got['aimc_spiking_linear']} != 6 x "
              f"{cfg.depth} blocks")
        others = {k: v for k, v in got.items() if v and k not in (
            "ssa_attention_keyed", "aimc_spiking_linear")}
        check(not others, f"{name}: the forward launched {others}")
        want_shape = ((batch, cfg.num_classes) if task == "vit"
                      else (batch, x.shape[1], cfg.vocab))
        check(tuple(logits.shape) == want_shape, f"{name}: logits shape")
        check(bool(torch.isfinite(logits).all()), f"{name}: non-finite logits")
        plogits = plain.forward(x, key)
        check(torch.equal(logits, plogits),
              f"{name}: kernel and plain logits differ")
        label = "classify" if task == "vit" else "detect_symbols"
        labels = getattr(eng, label)(x, key)
        check(torch.equal(labels, getattr(plain, label)(x, key)),
              f"{name}: kernel and plain labels differ")
        check(torch.equal(labels, logits.argmax(-1)), f"{name}: labels")
        ms = wall_ms(lambda: eng.forward(x, key), 5)
        r = dict(task=task, batch=batch, depth=cfg.depth, dim=cfg.dim,
                 heads=cfg.num_heads, tokens=x.shape[1] if task == "gpt"
                 else cfg.num_patches, T=cfg.T, logits_shape=list(want_shape),
                 logits_bitwise_equal=True, forward_ms=ms,
                 per_s=batch / ms * 1e3,
                 plain_forward_ms=wall_ms(lambda: plain.forward(x, key), 3),
                 launches_per_forward={k: v for k, v in got.items() if v},
                 k8_draws_per_forward=forward_draws(eng, x, key),
                 labels_head=labels.reshape(-1)[:8].tolist(),
                 profile_forward=profile_window(lambda: eng.forward(x, key)))
        if data is not None:
            r["ber"] = float(MIMO.ber(logits, data["labels"], data["mask"],
                                      MIMO.MIMOConfig()))
        # a small input against the CPU: 2 blocks of the smoke config
        scfg = dataclasses.replace(
            XpikeformerEngine.from_config(f"xpikeformer-{task}-smoke",
                                          device="cpu").cfg, depth=2)
        small = {}
        for d, backend in (("cpu", "integer"), (dev, "cuda")):
            e = XpikeformerEngine.from_config(scfg, backend=backend, device=d)
            e.init(seed=3)
            sx, _ = paper_inputs(task, scfg, 4, "cpu")
            small[str(d)] = e.forward(sx, prng.PRNGKey(9)).cpu()
        check(torch.allclose(small["cpu"], small[str(dev)], rtol=0, atol=1e-4)
              and torch.equal(small["cpu"].argmax(-1),
                              small[str(dev)].argmax(-1)),
              f"{name}: the reduced config on the card != the CPU")
        r["reduced_config_matches_cpu"] = True
        r["baseline_modes"] = baseline_modes(eng, plain, x, key)
        out[name] = r
        if task == "vit":
            vit = eng

    # K4's path: Backend.lif at the ViT's widest pre-activation shape
    cur = (torch.randint(-4, 12, (4, 64, 64, 1536),
                         generator=torch.Generator().manual_seed(5)).float()
           / 8).to(dev)
    KB.reset_launches()
    s = vit.backend.lif(cur)
    torch.cuda.synchronize()
    launches["lif"] = KB.LAUNCHES["lif"]
    check(launches["lif"] == 1, "Backend.lif did not launch K4 once")
    check(torch.equal(s, get_backend("integer").lif(cur)),
          "Backend.lif: kernel and plain spikes differ")
    out["lif_path"] = dict(shape=list(cur.shape), launches=launches["lif"])
    return out, launches


# ---------------------------------------------------------------------------
# Phase lm_forward: the LM stack's full-sequence forward and loss
# ---------------------------------------------------------------------------

# (arch, batch, sequence): the serve phases' model at its cache length, and
# the larger paper GPT on the LM stack
LM_FORWARD = (("xpikeformer-gpt-4-256", 8, 256), ("xpikeformer-gpt-8-512", 8,
                                                   256))
# the (2, 2) mesh's forward: 8 sequences of 64 tokens, key PRNGKey(MESH_KEY)
MESH_TOKENS, MESH_KEY = (8, 64), 77


def lm_tokens(vocab: int, b: int, s: int, seed: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (b, s), generator=gen)


def phase_lm_forward(dev):
    """The LM stack's full forward (``engine.forward(task="lm")``) and
    ``loss_fn`` at full width, random weights from a seed, on 8 sequences
    of 256 tokens (the loss on 257): K1 on every spiking linear and the
    keyed K8 causal on every block's tile, nothing else of the port; the
    logits and the loss equal the plain versions' (``IntegerBackend``) on
    the card, bit for bit.  Each model reports the unprofiled median wall
    of 5 forwards (after a warm-up), one profiled forward and the loss.
    Also the one-card logits of the mesh phase's forward."""
    from repro_torch import prng
    from repro_torch.engine import XpikeformerEngine, get_backend
    from repro_torch.kernels import build as KB
    from repro_torch.models import transformer as T

    out = {}
    key = prng.PRNGKey(42, dev)
    for name, b, n in LM_FORWARD:
        eng = XpikeformerEngine.from_config(name, task="lm", backend="cuda",
                                            device=dev)
        cfg = eng.cfg
        eng.init(seed=0)
        plain = XpikeformerEngine(cfg=cfg, backend=get_backend("integer"),
                                  device=eng.device, params=eng.params)
        tokens = lm_tokens(cfg.vocab_size, b, n + 1, 5).to(dev)
        x = tokens[:, :-1]
        eng.forward(x, key)  # warm-up: first cuBLAS/allocator calls
        KB.reset_launches()
        logits = eng.forward(x, key)
        torch.cuda.synchronize()
        got = {k: v for k, v in KB.LAUNCHES.items() if v}
        layers = cfg.num_layers
        want = {"aimc_spiking_linear": 6 * layers,
                "ssa_attention_keyed": layers}
        check(got == want, f"{name}: the forward launched {got}, not {want}")
        check(tuple(logits.shape) == (b, n, cfg.vocab_size),
              f"{name}: logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), f"{name}: non-finite logits")
        check(torch.equal(logits, plain.forward(x, key)),
              f"{name}: kernel and plain logits differ")
        loss, aux = T.loss_fn(eng.params, {"tokens": tokens}, cfg, rng=key,
                              backend=eng.backend)
        ploss, paux = T.loss_fn(eng.params, {"tokens": tokens}, cfg, rng=key,
                                backend=plain.backend)
        check(float(loss) == float(ploss) and bool(torch.isfinite(loss)),
              f"{name}: loss {float(loss)} against plain {float(ploss)}")
        ms = wall_ms(lambda: eng.forward(x, key), 5)
        out[name] = dict(
            layers=layers, d_model=cfg.d_model, heads=cfg.num_heads,
            head_dim=cfg.resolved_head_dim, d_ff=cfg.d_ff,
            vocab=cfg.vocab_size, T=cfg.spike_T, batch=b, tokens=n,
            logits_shape=list(logits.shape), logits_bitwise_equal=True,
            loss=float(loss), xent=float(aux["xent"]),
            loss_bitwise_equal=True, forward_ms=ms,
            tokens_per_s=b * n / ms * 1e3,
            plain_forward_ms=wall_ms(lambda: plain.forward(x, key), 3),
            launches_per_forward=got,
            profile_forward=profile_window(lambda: eng.forward(x, key)))
        if name == ARCH:
            mesh_tokens = lm_tokens(cfg.vocab_size, *MESH_TOKENS, 6)
            mesh_ref = (mesh_tokens.numpy(), eng.forward(
                mesh_tokens.to(dev), prng.PRNGKey(MESH_KEY, dev)).cpu())
        del eng, plain
        torch.cuda.empty_cache()
    return out, mesh_ref


# ---------------------------------------------------------------------------
# Phase train: CT -> HWAT on the paper models, the LM stack's train step
# ---------------------------------------------------------------------------

# (arch, batch, CT steps, HWAT steps, lr): the paper's two models at full
# width on one fixed batch each (at 3e-3 a first Adam step, about lr *
# sign(g) on every weight, threw the ViT's loss from 2.5 to 7.6)
TRAIN_PAPER = (("xpikeformer-vit-4-384", 64, 6, 3, 1e-3),
               ("xpikeformer-gpt-4-256", 64, 6, 3, 1e-3))
# the LM stack: tokens [8, 256] (+1 for the targets), float32-state steps
TRAIN_LM = ("xpikeformer-gpt-4-256", 8, 256, 6, 1e-3)
# the first step on the card against the host: loss within TRAIN_LOSS_ATOL,
# the gradients' global norm within TRAIN_NORM_RTOL (float sums in other
# orders; a spike a membrane an ulp from the threshold may flip)
TRAIN_LOSS_ATOL, TRAIN_NORM_RTOL = 1e-3, 1e-2


def _first_step(forward, params, batch, key, sim, dev):
    """One step's loss and gradient norm on ``dev`` (``make_step``'s
    loss and ``value_and_grad``)."""
    from repro_torch import tree as TR
    from repro_torch.optim import adamw as A
    from repro_torch.train import hwat as H
    from repro_torch.train.loop import value_and_grad

    def loss_fn(p, b, r):
        logits = forward(p, b, sim, r)
        return H.xent_loss(logits, b["labels"], b.get("mask")), {}

    params = TR.tree_map(lambda x: x.to(dev), params)
    batch = {k: v.to(dev) for k, v in batch.items()}
    (loss, _), grads = value_and_grad(loss_fn)(params, batch, key.to(dev))
    return float(loss), float(A.global_norm(grads))


def _deploy(eng_kw, params, x, key, dev, launches_want) -> dict:
    """Trained weights through ``CudaBackend`` (the kernels) and
    ``IntegerBackend`` (their plain versions) on the card: logits equal
    bit for bit, the kernels launched as the path needs."""
    from repro_torch.engine import XpikeformerEngine
    from repro_torch.kernels import build as KB

    engs = [XpikeformerEngine.from_config(backend=b, device=dev, **eng_kw)
            for b in ("cuda", "integer")]
    for e in engs:
        e.params = params
    with torch.no_grad():
        engs[0].forward(x, key)  # warm-up
        KB.reset_launches()
        got = engs[0].forward(x, key)
        torch.cuda.synchronize()
        launches = {k: v for k, v in KB.LAUNCHES.items() if v}
        want = engs[1].forward(x, key)
    check(launches == launches_want,
          f"deploy launched {launches}, not {launches_want}")
    check(bool(torch.isfinite(got).all()), "deploy: non-finite logits")
    check(torch.equal(got, want), "deploy: kernel and plain logits differ")
    return dict(launches=launches, logits_bitwise_equal=True,
                labels_head=got.argmax(-1).reshape(-1)[:8].tolist())


def phase_train(dev):
    """Training on the card.  (a) The paper ViT-4-384 and GPT-4-256 at
    full width, random weights from a seed, one fixed batch each (64
    images of the ``synthetic_images`` twin, 64 ICL sequences of 37
    tokens): ``two_stage_train`` (CT then HWAT, the float reference
    backend, AdamW), every loss finite and the CT loss lower after its
    steps; the GPT through ``train_and_program`` (K6 programs the trained
    weights).  The first CT step's loss and gradient norm on the card
    against the same step on the host CPU.  One CT step profiled.  The
    trained weights deployed through the kernels (K1, the keyed K8; the
    programmed GPT's image) equal the plain versions' logits bit for bit.
    (b) The LM stack ``xpikeformer-gpt-4-256``: ``make_train_step`` on
    ``MarkovStream`` tokens ``[8, 257]``, a few float32-state steps on one
    batch (the loss lower, every loss and gradient norm finite), one step
    of int8 state and two microbatches, the first step against the host,
    the trained weights deployed through K1 and the keyed K8."""
    from repro_torch import aimc_device as AD
    from repro_torch import prng
    from repro_torch import tree as TR
    from repro_torch.configs import ParallelConfig
    from repro_torch.configs.xpikeformer import SPIKING_ARCHS
    from repro_torch.core.spiking_transformer import AIMCSim
    from repro_torch.data.pipeline import DataConfig, MarkovStream
    from repro_torch.engine import XpikeformerEngine
    from repro_torch.kernels import build as KB
    from repro_torch.optim import adamw as A
    from repro_torch.train import hwat as H
    from repro_torch.train import loop as L

    out = {}
    key = prng.PRNGKey(42, dev)
    for name, batch, ct, hw, lr in TRAIN_PAPER:
        task, cfg = SPIKING_ARCHS[name]
        eng = XpikeformerEngine.from_config(name, backend="reference",
                                            device=dev)
        params = eng.init(seed=0)
        x, data = paper_inputs(task, cfg, batch, dev)
        if data is None:
            from repro_torch.data import synthetic_images as SI

            data = SI.sample_batch(17, SI.ImageConfig(size=cfg.image_size),
                                   batch, dev)
        fwd = H.model_forward(cfg, task)
        first_key = prng.split(prng.fold_in(prng.PRNGKey(0), 0))[1]
        card = _first_step(fwd, params, data, first_key, AIMCSim(), dev)
        host = _first_step(fwd, params, data, first_key, AIMCSim(), "cpu")
        check(all(math.isfinite(v) for v in card + host),
              f"{name}: a first-step loss or gradient norm is not finite")
        check(abs(card[0] - host[0]) <= TRAIN_LOSS_ATOL
              and abs(card[1] - host[1]) <= TRAIN_NORM_RTOL * host[1],
              f"{name}: first step on the card {card} != host {host}")
        log = []

        def data_fn(k):
            torch.cuda.synchronize()
            log.append(time.perf_counter())
            return data

        KB.reset_launches()
        if task == "gpt":
            trained, curves = H.train_and_program(
                params, fwd, data_fn, ct_steps=ct, hwat_steps=hw, lr=lr)
            torch.cuda.synchronize()
            k6 = KB.LAUNCHES["drift_requantize"]
            check(k6 > 0, f"{name}: programming launched no K6")
            check(AD.has_device_state(trained), f"{name}: not programmed")
        else:
            trained, curves = H.two_stage_train(
                params, fwd, data_fn, ct_steps=ct, hwat_steps=hw, lr=lr)
            torch.cuda.synchronize()
            k6 = 0
        log.append(time.perf_counter())
        # step i's time: a stage reads each loss to the host before it asks
        # for the next batch
        times = [1e3 * (b - a) for a, b in zip(log, log[1:])]
        losses = curves["ct"] + curves["hwat"]
        check(len(losses) == ct + hw and all(map(math.isfinite, losses)),
              f"{name}: losses {losses}")
        check(curves["ct"][-1] < curves["ct"][0],
              f"{name}: {ct} CT steps did not lower the loss {curves['ct']}")
        weights = [v.levels if isinstance(v, AD.AIMCDeviceState) else v
                   for v in TR.flatten(trained, lambda t: isinstance(
                       t, AD.AIMCDeviceState))[0]]
        check(all(bool(torch.isfinite(v).all()) for v in weights),
              f"{name}: non-finite trained weights")
        step = H.make_step(fwd, A.AdamWConfig(lr=lr), AIMCSim())
        opt_state = A.init_opt_state(params, A.AdamWConfig(lr=lr))
        prof = profile_window(lambda: step(params, opt_state, data,
                                           first_key.to(dev)))
        if task == "vit":
            dep = _deploy(dict(name_or_cfg=name), trained, x, key, dev,
                          {"aimc_spiking_linear": 6 * cfg.depth,
                           "ssa_attention_keyed": cfg.depth})
        else:
            dep = _deploy(dict(name_or_cfg=name, wmode="hw"), trained, x,
                          key, dev, {"aimc_spiking_linear": 6 * cfg.depth,
                                     "ssa_attention_keyed": cfg.depth})
        out[name] = dict(
            batch=batch, ct_steps=ct, hwat_steps=hw, lr=lr,
            ct_losses=curves["ct"], hwat_losses=curves["hwat"],
            ct_step_ms=statistics.median(times[1:ct]),
            # the stage's first step sets up its optimizer; the GPT's
            # last one is followed by programming
            hwat_step_ms=statistics.median(times[ct + 1:ct + hw - 1]),
            first_ct_step_ms=times[0], first_step_card=card,
            first_step_host=host, k6_launches_programming=k6,
            profile_ct_step=prof, deploy=dep)
        del eng, params, trained
        torch.cuda.empty_cache()

    name, b, n, steps, lr = TRAIN_LM
    eng = XpikeformerEngine.from_config(name, task="lm", backend="reference",
                                        device=dev)
    cfg = eng.cfg
    stream = MarkovStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=n,
                                     global_batch=b, seed=0), device=dev)
    batch = stream.batch_at(0)
    opt = A.AdamWConfig(lr=lr, warmup_steps=1, total_steps=steps)
    params, state = L.init_state(0, cfg, opt, device=dev)
    loss_f = L.value_and_grad(L.make_loss(cfg))
    card = loss_f(params, batch, prng.PRNGKey(1, dev))
    host = loss_f(TR.tree_map(lambda t: t.cpu(), params),
                  {"tokens": batch["tokens"].cpu()}, prng.PRNGKey(1))
    card_v = (float(card[0][0]), float(A.global_norm(card[1])))
    host_v = (float(host[0][0]), float(A.global_norm(host[1])))
    del card, host
    check(abs(card_v[0] - host_v[0]) <= TRAIN_LOSS_ATOL
          and abs(card_v[1] - host_v[1]) <= TRAIN_NORM_RTOL * host_v[1],
          f"{name} LM: first step on the card {card_v} != host {host_v}")
    step = L.make_train_step(cfg, ParallelConfig(), opt)
    losses, norms, times = [], [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch, prng.PRNGKey(1, dev))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        times.append(1e3 * (time.perf_counter() - t0))
    check(all(map(math.isfinite, losses + norms)),
          f"{name} LM: losses {losses}, gradient norms {norms}")
    check(losses[-1] < losses[0], f"{name} LM: {steps} steps did not lower "
          f"the loss {losses}")
    prof = profile_window(lambda: step(params, state, batch,
                                       prng.PRNGKey(1, dev)))
    iopt = A.AdamWConfig(lr=lr, state_dtype="int8", warmup_steps=1)
    par = ParallelConfig(microbatches=2)
    p8, s8 = L.init_state(0, cfg, iopt, par, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p8, s8, m8 = L.make_train_step(cfg, par, iopt)(p8, s8, batch,
                                                   prng.PRNGKey(1, dev))
    int8_ms = 1e3 * (time.perf_counter() - t0)
    check(math.isfinite(float(m8["loss"])) and math.isfinite(
        float(m8["grad_norm"])), f"{name} LM: the int8 step is not finite")
    check(any(isinstance(v, dict) for v in TR.flatten(
        s8["m"], lambda t: isinstance(t, dict) and "q" in t)[0]),
        f"{name} LM: no int8 moment")
    dep = _deploy(dict(name_or_cfg=name, task="lm"), params,
                  batch["tokens"][:, :-1], key, dev,
                  {"aimc_spiking_linear": 6 * cfg.num_layers,
                   "ssa_attention_keyed": cfg.num_layers})
    out[f"{name} (LM stack)"] = dict(
        batch=b, tokens=n, steps=steps, lr=lr, losses=losses,
        grad_norms=norms, step_ms=statistics.median(times[1:]),
        first_step_ms=times[0], first_step_card=card_v,
        first_step_host=host_v, int8_microbatch2_loss=float(m8["loss"]),
        int8_microbatch2_step_ms=int8_ms, profile_step=prof, deploy=dep)
    return out


# ---------------------------------------------------------------------------
# Phase 9: training's launcher -- checkpoints, crash and restart, elastic
# ---------------------------------------------------------------------------

# launch.train.run at full width on MarkovStream batches [8, 257]
TRAIN_LAUNCH = dict(arch=ARCH, smoke=False, steps=8, batch=8, seq_len=256,
                    ckpt_every=3, seed=0, lr=1e-3, log_every=0)
TRAIN_LAUNCH_FAIL_AT = 5
TRAIN_LAUNCH_MESH = (2, 1)
# the restarted run's final loss (tests/test_fault_tolerance.py's bound),
# and the elastic run's losses (its gradient sums in another order)
RESTART_ATOL, ELASTIC_ATOL = 1e-4, 1e-3
LAUNCH_REQUESTS, LAUNCH_NEW = 4, 16
LAUNCH_DRIFT_S = 3600.0


def _launch_run(report_into: dict, name: str, **kw) -> list:
    """One ``launch.train.run`` on the card: its losses, and in
    ``report_into[name]`` its restored step, median step ms (the first
    step of a run sets up its allocator and cuBLAS) and wall seconds."""
    from repro_torch.launch import train as LT

    rep = {}
    t0 = time.perf_counter()
    losses = LT.run(device="cuda", report=rep, **{**TRAIN_LAUNCH, **kw})
    wall_s = time.perf_counter() - t0
    check(all(map(math.isfinite, losses)), f"train_launch {name}: losses "
          f"{losses}")
    ms = [1e3 * s for s in rep["step_s"]]
    report_into[name] = dict(
        start_step=rep["start_step"], losses=losses, step_ms=ms,
        step_ms_median=statistics.median(ms[1:] or ms),
        stragglers=rep["stragglers"], wall_s=wall_s)
    return losses, rep


def _launch_serve(eng, params, prompts, **sched) -> tuple:
    """``params`` served on ``eng`` (16 new tokens a request): the
    streams, the stats, the per-request joules and the launches of the
    run."""
    from repro_torch.kernels import build as KB

    eng.params = params
    sch = eng.scheduler(slots=8, cache_len=256, **sched)
    KB.reset_launches()
    outs, wall_s = drive(sch, prompts, LAUNCH_NEW)
    launches = {k: v for k, v in KB.LAUNCHES.items() if v}
    return outs, sch.stats, request_energies(sch), launches, wall_s


def phase_train_launch(dev, root: Path) -> tuple:
    """The train launcher on the card at full width
    (:data:`TRAIN_LAUNCH`, checkpoints every 3 steps under ``root``):
    (a) uninterrupted; (b) again with ``fail_at=5`` -- the injected
    ``RuntimeError``, then the rerun, which must restore step 3 and end
    within :data:`RESTART_ATOL` of (a)'s final loss; (c) a copy of (b)'s
    step-3 checkpoint resumed on a ``(2, 1)`` mesh (two ranks sharing the
    card over gloo), steps 3-7 within :data:`ELASTIC_ATOL` of (a)'s, and
    the checkpoint it writes restored on one device; (d) (a)'s final
    checkpoint restored into a fresh tree and served dense (K3, K1/K2) --
    the same tokens as (a)'s in-memory parameters and as the plain backend
    -- then programmed (K6), drifted an hour, saved, restored and served
    paged under ``DriftPolicy(60, 3600)`` (K9): tokens, device clock,
    folds and joules equal to the in-memory programmed tree's.  Returns
    the phase's record and what the mesh phase serves from (a)'s
    checkpoint: its directory, the requests and (d)'s one-card streams."""
    import shutil

    from repro_torch import aimc_device as AD
    from repro_torch import prng
    from repro_torch import tree as TR
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import leaves
    from repro_torch.configs import registry
    from repro_torch.engine import XpikeformerEngine, get_backend
    from repro_torch.optim import adamw as A
    from repro_torch.train import loop as TL

    t_phase = time.perf_counter()
    cfg = (registry.reduced_config if TRAIN_LAUNCH["smoke"]
           else registry.get_config)(TRAIN_LAUNCH["arch"])
    steps, every = TRAIN_LAUNCH["steps"], TRAIN_LAUNCH["ckpt_every"]
    runs, out = {}, {"arch": cfg.name, "tokens": [TRAIN_LAUNCH["batch"],
                                                  TRAIN_LAUNCH["seq_len"] + 1],
                     "steps": steps, "ckpt_every": every}
    dir_a, dir_b, dir_c = root / "a", root / "b", root / "c"
    # (a) uninterrupted
    la, rep_a = _launch_run(runs, "uninterrupted", ckpt_dir=str(dir_a))
    check(len(la) == steps and rep_a["start_step"] == 0,
          f"train_launch (a): {len(la)} losses from step {rep_a['start_step']}")
    check(CheckpointManager(dir_a).latest_step() == steps,
          "train_launch (a): no final checkpoint")
    # (b) crash at step 5, then the rerun from step 3
    t0 = time.perf_counter()
    try:
        _launch_run(runs, "crashed", ckpt_dir=str(dir_b),
                    fail_at=TRAIN_LAUNCH_FAIL_AT)
        check(False, "train_launch (b): the injected failure did not raise")
    except RuntimeError as e:
        check(f"injected failure at step {TRAIN_LAUNCH_FAIL_AT}" in str(e),
              f"train_launch (b): {e}")
    crash_s = time.perf_counter() - t0
    last = (TRAIN_LAUNCH_FAIL_AT // every) * every
    check(CheckpointManager(dir_b).latest_step() == last,
          f"train_launch (b): the crash left step "
          f"{CheckpointManager(dir_b).latest_step()}, not {last}")
    dir_c.mkdir()
    shutil.copytree(dir_b / f"step_{last:08d}", dir_c / f"step_{last:08d}")
    (dir_c / "LATEST").write_text(str(last))
    lb, rep_b = _launch_run(runs, "restarted", ckpt_dir=str(dir_b))
    check(rep_b["start_step"] == last, f"train_launch (b): the rerun restored "
          f"step {rep_b['start_step']}, not {last}")
    diff_b = [abs(x - y) for x, y in zip(lb, la[last:])]
    check(abs(lb[-1] - la[-1]) <= RESTART_ATOL,
          f"train_launch (b): final loss {lb[-1]} != {la[-1]}")
    out["restart"] = dict(crash_wall_s=crash_s, restored_step=last,
                          max_abs_loss_diff=max(diff_b),
                          final_loss_diff=abs(lb[-1] - la[-1]),
                          bitwise_equal=lb == la[last:],
                          final_atol=RESTART_ATOL)
    # (c) elastic: (b)'s step-3 checkpoint on a (2, 1) mesh
    lc, rep_c = _launch_run(runs, "elastic_2x1", ckpt_dir=str(dir_c),
                            mesh_shape=TRAIN_LAUNCH_MESH)
    check(rep_c["start_step"] == last and len(lc) == steps - last,
          f"train_launch (c): restored step {rep_c['start_step']}")
    check(all(r == lc for r in rep_c["rank_losses"]),
          "train_launch (c): the ranks' losses differ")
    diff_c = [abs(x - y) for x, y in zip(lc, la[last:])]
    check(max(diff_c) <= ELASTIC_ATOL, f"train_launch (c): losses {lc} vs "
          f"one card's {la[last:]}")
    opt = A.AdamWConfig()
    like = TL.init_state(1, cfg, opt, device=dev)
    (pc, _), step_c = CheckpointManager(dir_c).restore(like)
    check(step_c == steps and all(bool(torch.isfinite(x).all())
                                  for x in leaves(pc)),
          "train_launch (c): the mesh's checkpoint does not restore")
    out["elastic"] = dict(
        mesh=list(TRAIN_LAUNCH_MESH), process_group="gloo",
        ranks_share_one_card=True, max_abs_loss_diff=max(diff_c),
        atol=ELASTIC_ATOL, restored_on_one_device_step=step_c,
        max_abs_param_diff_vs_one_card=max(
            float((x - y).abs().max()) for x, y in zip(
                leaves(pc), leaves(rep_a["params"]))))
    # (d) deploy from disk: dense (K3, K1/K2) ...
    (pd, _), step_d = CheckpointManager(dir_a).restore(like)
    check(step_d == steps and all(torch.equal(x, y) for x, y in zip(
        leaves(pd), leaves(rep_a["params"]))),
          "train_launch (d): the restored params are not (a)'s")
    eng = XpikeformerEngine.from_config(cfg, task="lm", backend="cuda",
                                        device=dev)
    plain = XpikeformerEngine(cfg=cfg, backend=get_backend("integer"),
                              device=eng.device)
    prompts = make_requests(cfg.vocab_size)[:LAUNCH_REQUESTS]
    d_disk = _launch_serve(eng, pd, prompts)
    d_mem = _launch_serve(eng, rep_a["params"], prompts)
    d_plain = _launch_serve(plain, pd, prompts)
    check(d_disk[0] == d_mem[0] == d_plain[0],
          "train_launch (d): restored, in-memory and plain tokens differ")
    check(all(len(o) == LAUNCH_NEW for o in d_disk[0]),
          "train_launch (d): too few tokens")
    check(d_disk[3].get("fused_decode_layer", 0) == cfg.num_layers
          * d_disk[1].decode_steps and d_disk[3].get("aimc_spiking_linear")
          and d_disk[3].get("ssa_decode"),
          f"train_launch (d): dense launches {d_disk[3]}")
    # ... then programmed (K6), an hour old, through disk, paged (K9)
    eng.params = pd
    from repro_torch.kernels import build as KB

    KB.reset_launches()
    eng.program(prng.PRNGKey(42))
    eng.drift_to(LAUNCH_DRIFT_S)
    torch.cuda.synchronize()
    k6_program = KB.LAUNCHES["drift_requantize"]
    check(k6_program > 0, "train_launch (d): programming launched no K6")
    mem = eng.params
    mgr = CheckpointManager(root / "programmed", keep=1)
    mgr.save(steps, mem, blocking=True)
    prog, _ = mgr.restore(mem)
    check(all(torch.equal(x, y) and x.dtype == y.dtype
              for x, y in zip(leaves(prog), leaves(mem))),
          "train_launch (d): the programmed tree changed through disk")
    policy = AD.DriftPolicy(seconds_per_step=DRIFT_STEP_S,
                            recal_interval_s=RECAL_EVERY_S)
    paged = dict(paged=True, page_len=8, drift=policy)
    p_disk = _launch_serve(eng, prog, prompts, **paged)
    p_mem = _launch_serve(eng, mem, prompts, **paged)
    st_d, st_m = p_disk[1], p_mem[1]
    check(p_disk[0] == p_mem[0], "train_launch (d): paged tokens differ")
    check((st_d.t_device_s, st_d.image_folds, st_d.recalibrations,
           st_d.energy_j) == (st_m.t_device_s, st_m.image_folds,
                              st_m.recalibrations, st_m.energy_j)
          and p_disk[2] == p_mem[2],
          "train_launch (d): the programmed serve's clock, folds or joules "
          "differ")
    check(st_d.t_device_s == LAUNCH_DRIFT_S + DRIFT_STEP_S
          * st_d.decode_steps, f"train_launch (d): device clock "
          f"{st_d.t_device_s}")
    check(p_disk[3].get("fused_decode_layer_paged", 0) == cfg.num_layers
          * st_d.decode_steps and p_disk[3].get("drift_requantize", 0) > 0,
          f"train_launch (d): paged launches {p_disk[3]}")
    out["deploy"] = dict(
        requests=len(prompts), max_new=LAUNCH_NEW,
        dense=dict(tokens_equal_in_memory=True, tokens_equal_plain=True,
                   wall_s=d_disk[4], plain_wall_s=d_plain[4],
                   decode_step_ms=1e3 * d_disk[1].decode_s
                   / d_disk[1].decode_steps, launches=d_disk[3],
                   first_tokens=d_disk[0][0][:8]),
        programmed_paged=dict(
            drifted_s=LAUNCH_DRIFT_S, k6_programming=k6_program,
            tokens_equal_in_memory=True, t_device_s=st_d.t_device_s,
            image_folds=st_d.image_folds,
            recalibrations=st_d.recalibrations, energy_j=st_d.energy_j,
            joules_equal_in_memory=True, wall_s=p_disk[4],
            decode_step_ms=1e3 * st_d.decode_s / st_d.decode_steps,
            launches=p_disk[3], first_tokens=p_disk[0][0][:8]))
    launches = {}
    for rec in (d_disk[3], p_disk[3], {"drift_requantize": k6_program}):
        for k, v in rec.items():
            launches[k] = launches.get(k, 0) + v
    out.update(runs=runs, launches=launches,
               seconds=time.perf_counter() - t_phase)
    del eng, plain, like
    torch.cuda.empty_cache()
    return out, launches, dict(ckpt=str(dir_a), prompts=prompts,
                               outs=d_disk[0])


# ---------------------------------------------------------------------------
# Phase 6: the programmed-PCM lifecycle and energy metering
# ---------------------------------------------------------------------------


DRIFT_STEP_S, RECAL_EVERY_S = 60.0, 3600.0  # launch/serve.py's documented run
LIFECYCLE = ((0.0, False), (3600.0, False), (86400.0, False),
             (2.592e6, False), (3.1536e7, False), (86400.0, True),
             (3.1536e7, True))  # (device age, after recalibrate())


def phase_drift(dev):
    """(a) The LM stack programmed and served paged under the drift policy
    of ``launch/serve.py --drift-step 60 --recal-every 3600``, on the
    kernels and on the plain versions from the same programmed state; (b)
    the paper ViT-4-384 at batch 64 programmed, through the Table V
    lifecycle and one metered forward."""
    from repro_torch import aimc_device as AD
    from repro_torch import prng
    from repro_torch.engine import XpikeformerEngine, get_backend
    from repro_torch.kernels import build as KB
    from repro_torch.kernels import drift_requantize as KD

    out = {}
    # (a) programmed, paged, under the drift policy
    eng = XpikeformerEngine.from_config(ARCH, task="lm", backend="cuda",
                                        device=dev)
    cfg = eng.cfg
    eng.init(seed=0)
    KB.reset_launches()
    eng.program(prng.PRNGKey(42))
    torch.cuda.synchronize()
    leaves = len(AD.device_states(eng.params))
    check(KB.LAUNCHES["drift_requantize"] == leaves,
          "program did not fold each leaf once")
    programmed = eng.params
    plain = XpikeformerEngine(cfg=cfg, backend=get_backend("integer"),
                              device=eng.device, params=programmed,
                              wmode="hw")
    prompts = paged_requests(cfg.vocab_size)
    max_new = 32
    policy = AD.DriftPolicy(seconds_per_step=DRIFT_STEP_S,
                            recal_interval_s=RECAL_EVERY_S)
    sch = eng.scheduler(slots=8, cache_len=256, paged=True, page_len=8,
                        drift=policy)
    check(sch.programmed and sch._t_device == 0.0, "a fresh device clock")
    KB.reset_launches()
    outs, wall_s = drive(sch, prompts, max_new)
    launches = dict(KB.LAUNCHES)
    st = sch.stats
    served_outs = outs
    check(all(len(o) == max_new for o in outs), "drift: too few tokens")
    check(st.t_device_s == DRIFT_STEP_S * st.decode_steps,
          f"device clock {st.t_device_s} != {DRIFT_STEP_S} x "
          f"{st.decode_steps} steps")
    check(st.recalibrations >= 1, "no GDC recalibration ran")
    check(st.energy_j > 0, "no energy was booked")
    check(len(sch.request_energy_j) == len(prompts)
          and all(v > 0 for v in sch.request_energy_j.values()),
          "a request has no energy")
    chunks = -(-leaves // KD.MAX_LEAVES)  # launches a whole-tree pass
    want = chunks * (st.image_folds + 2 * st.recalibrations)
    check(launches["drift_requantize"] == want > 0,
          f"K6 launches {launches['drift_requantize']} != {chunks} x "
          f"({st.image_folds} folds + 2 x {st.recalibrations} recalibrations)")
    check(launches["fused_decode_layer_paged"] == cfg.num_layers
          * st.decode_steps, "drift: K9 is not one launch per layer and step")
    psch = plain.scheduler(slots=8, cache_len=256, paged=True, page_len=8,
                           drift=policy)
    pouts, plain_wall_s = drive(psch, prompts, max_new)
    check(pouts == outs, "programmed paged: kernel and plain tokens differ")
    pst = psch.stats
    check((pst.t_device_s, pst.recalibrations, pst.image_folds)
          == (st.t_device_s, st.recalibrations, st.image_folds),
          "plain scheduler's lifecycle differs")
    check(abs(pst.energy_j - st.energy_j) <= 1e-12 * st.energy_j,
          "plain scheduler's energy differs")
    check(AD.device_time(sch.source_params) == sch._t_image > 0,
          "the served state is not the last fold's")
    out["lm_paged_drift"] = dict(
        arch=ARCH, slots=8, cache_len=256, page_len=8,
        requests=len(prompts), seconds_per_step=DRIFT_STEP_S,
        recal_interval_s=RECAL_EVERY_S, programmed_leaves=leaves,
        decode_steps=st.decode_steps, tokens=st.decoded_tokens,
        t_device_s=st.t_device_s, image_folds=st.image_folds,
        recalibrations=st.recalibrations,
        gdc_gain_mean=AD.gdc_gain_summary(sch.source_params),
        energy_j=st.energy_j, j_per_token=st.j_per_token,
        spike_events=st.spike_events,
        request_energy_j_max=max(sch.request_energy_j.values()),
        wall_s=wall_s, decode_s=st.decode_s,
        tokens_per_s=st.decoded_tokens / wall_s,
        decode_step_ms=1e3 * st.decode_s / st.decode_steps,
        plain_wall_s=plain_wall_s, tokens_equal_plain=True,
        launches={k: v for k, v in launches.items() if v},
        first_tokens=outs[0][:8])
    # where a programmed step's time goes (three steps of 8 busy slots),
    # and a whole-tree fold on its own: the lifecycle's device cost
    tree = sch.source_params
    out["lm_fold_ms"] = wall_ms(lambda: AD.drift_tree(tree, 7200.0,
                                                      policy.cfg), 5)
    out["profile_lm_fold"] = profile_window(
        lambda: AD.drift_tree(tree, 7200.0, policy.cfg))
    sch.reset()
    for i, p in enumerate(prompts[:8]):
        sch.submit(p, 8, seed=2 + i)
    sch.step()
    out["profile_programmed_paged_3_steps"] = profile_window(
        lambda: [sch.step() for _ in range(3)])
    del sch, psch, tree

    # (b) the paper ViT programmed: the Table V lifecycle
    name, batch = PAPER[0]
    vit = XpikeformerEngine.from_config(name, backend="cuda", device=dev)
    vcfg = vit.cfg
    vit.init(seed=0)
    x, _ = paper_inputs("vit", vcfg, batch, dev)
    key = prng.PRNGKey(42, dev)
    KB.reset_launches()
    vit.program(prng.PRNGKey(7))
    torch.cuda.synchronize()
    vleaves = len(AD.device_states(vit.params))
    check(vleaves == 2 + 6 * vcfg.depth, f"{vleaves} programmed ViT leaves")
    check(KB.LAUNCHES["drift_requantize"] == vleaves, "ViT program folds")
    vplain = XpikeformerEngine(cfg=vcfg, backend=get_backend("integer"),
                               device=vit.device, params=vit.params,
                               task="vit", wmode="hw")
    points, l0 = [], None
    for t, recal in LIFECYCLE:
        if t != vit.t_seconds or recal:
            vit.drift_to(t)
        if recal:
            vit.recalibrate()
        logits = vit.forward(x, key)
        plogits = vplain.forward(x, key, vit.params)
        check(torch.equal(logits, plogits),
              f"ViT t={t} gdc={recal}: kernel and plain logits differ")
        check(bool(torch.isfinite(logits).all()), "non-finite ViT logits")
        if l0 is None:
            l0 = logits
        points.append(dict(
            t_seconds=t, gdc=recal,
            mean_abs_logit_err=float(torch.mean(torch.abs(logits - l0))),
            gdc_gain_mean=AD.gdc_gain_summary(vit.params),
            labels_agree_t0=float((logits.argmax(-1) == l0.argmax(-1))
                                  .float().mean())))
    torch.cuda.synchronize()
    vlaunches = dict(KB.LAUNCHES)
    n_points = len(LIFECYCLE)
    check(vlaunches["drift_requantize"] == vleaves + -(-vleaves // KD.MAX_LEAVES)
          * (sum(t != 0.0 for t, _ in LIFECYCLE) + 2 * sum(
              r for _, r in LIFECYCLE)), "ViT lifecycle K6 launches")
    check(vlaunches["ssa_attention_keyed"] == vcfg.depth * n_points
          and vlaunches["ssa_attention"] == 0
          and vlaunches["aimc_spiking_linear"] == 6 * vcfg.depth * n_points,
          "ViT lifecycle forwards did not run the keyed K8 and K1")
    check(points[3]["mean_abs_logit_err"] > points[1]["mean_abs_logit_err"],
          "a month of drift did not move the logits more than an hour")
    mlogits, report = vit.forward(x, key, metering=True)
    check(torch.equal(mlogits, vit.forward(x, key)),
          "metered logits differ from unmetered")
    rep = report.as_dict()
    check(rep["aimc_pj"] > 0 and rep["ssa_pj"] > 0 and rep["lif_pj"] > 0,
          "metering reported no energy")
    out["vit_lifecycle"] = dict(
        arch=name, batch=batch, programmed_leaves=vleaves,
        programmed_elements=sum(s.levels.numel()
                                for s in AD.device_states(vit.params)),
        points=points, logits_bitwise_equal_plain=True,
        launches={k: v for k, v in vlaunches.items() if v},
        metering=rep, metered_logits_equal=True)
    vtree = vit.params
    out["vit_fold_ms"] = wall_ms(lambda: AD.drift_tree(vtree, 7200.0,
                                                       vit.aimc_cfg), 5)
    out["profile_vit_fold"] = profile_window(
        lambda: AD.drift_tree(vtree, 7200.0, vit.aimc_cfg))
    out["vit_forward_programmed_ms"] = wall_ms(lambda: vit.forward(x, key), 3)
    out["profile_vit_forward_programmed"] = profile_window(
        lambda: vit.forward(x, key))
    return out, launches, served_outs


# ---------------------------------------------------------------------------
# Phase float_lm: the float LM stack (no kernel of the port)
# ---------------------------------------------------------------------------

# (a) the served model: full width and depth, its config's bfloat16
FLOAT_SERVE = "yi-9b"
# (b), (c): (arch, layers kept (None: all), the cut) in float32, TF32 off
FLOAT_CHECKS = (
    ("yi-9b", 2, "full width, 2 of 48 layers"),
    ("mamba2-780m", None, "full width and depth"),
    ("recurrentgemma-9b", 3,
     "full width, one period (rglru, rglru, local) of 38 layers"),
)
FLOAT_TOKENS = (2, 64)  # the checks' [batch, sequence]
# tolerances: the card against the host (float32 sums in other orders,
# over d_model = 4,096 and 11,008-12,288 wide products); teacher-forced
# decode against the forward (the reference's own, tests/test_transformer
# .py); a long-sequence path (flash, banded, chunked SSD) against its
# masked / one-chunk form on the same inputs
FLOAT_HOST_ATOL, FLOAT_DECODE_ATOL, FLOAT_PATH_ATOL = 1e-3, 5e-3, 1e-4
# chunked SSD in float32 against the float64 recurrence, relative to the
# output's largest value: the chunk's decays exp(cumsum(log a)) lose
# float32 digits over 256 steps (2.2e-5 measured on the reduced config)
FLOAT_SSD_RTOL = 1e-4


def _float_serve(dev, cfg, *, replay: bool = True) -> dict:
    """(a): a float config (yi-9b at full width and depth) in bfloat16
    served by ``BatchScheduler(slots=8, cache_len=256)`` (a MoE config
    with its default ``moe_impl``, ``"ep_a2a"``): the serve phase's 16
    requests (8-32 prompt tokens, 32 new, waves of 4 every 8 steps).
    ``replay``: two requests again at batch 1."""
    from repro_torch import tree as TR
    from repro_torch.kernels import build as KB
    from repro_torch.models import transformer as T
    from repro_torch.serving import BatchScheduler

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, 0, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = TR.flatten(params)[0]
    n_params = sum(x.numel() for x in leaves)
    weight_bytes = sum(x.numel() * x.element_size() for x in leaves)
    sch = BatchScheduler(params, cfg, slots=8, cache_len=256, device=dev)
    check(sch.plan is None, "a float config built a decode plan")
    prompts = make_requests(cfg.vocab_size)
    max_new = 32
    spent = {"init_s": init_s}
    t0 = time.perf_counter()
    drive(sch, [p[:2] for p in prompts[:2]], 2)  # warm-up: cuBLAS, allocator
    sch.reset()
    spent["warmup_s"] = time.perf_counter() - t0

    finite = []  # every decode step's logits finite (read after the run)
    decode = sch._decode

    def watched(p, state):
        logits, state, act = decode(p, state)
        finite.append(torch.isfinite(logits).all())
        return logits, state, act

    sch._decode = watched
    KB.reset_launches()
    outs, wall_s = drive(sch, prompts, max_new)
    launched = {k: v for k, v in KB.LAUNCHES.items() if v}
    sch._decode = decode
    st = sch.stats
    check(launched == {}, f"the float path launched port kernels {launched}")
    check(st.admissions == len(prompts) and st.evictions == len(prompts),
          "not every request was admitted and evicted")
    check(all(len(o) == max_new for o in outs), "a request got too few tokens")
    check(all(0 <= t < cfg.vocab_size for o in outs for t in o),
          "a token is out of the vocabulary")
    check(len(finite) == st.decode_steps and bool(torch.stack(finite).all()),
          "non-finite decode logits")
    check(st.energy_j == 0.0, f"a float serve booked {st.energy_j} J")
    out = dict(
        arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
        heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
        dtype=cfg.dtype, params=n_params, init_s=init_s,
        moe_impl=sch.moe_impl if cfg.is_moe else None, slots=8,
        cache_len=256, requests=len(prompts), tokens=st.decoded_tokens,
        decode_steps=st.decode_steps, prefill_tokens=st.prefill_tokens,
        wall_s=wall_s, tokens_per_s=st.decoded_tokens / wall_s,
        decode_step_ms=1e3 * st.decode_s / st.decode_steps,
        prefill_token_ms=1e3 * st.prefill_s / st.prefill_tokens,
        # every weight read once a step (moe_ep runs every expert on its
        # rows, so a MoE step reads all of them too)
        weight_read_bound_ms=1e3 * weight_bytes / HBM_BYTES_PER_S,
        energy_j=st.energy_j, logits_finite=True,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        first_tokens=outs[0][:8])

    spent["serve_s"] = wall_s
    # three decode steps of 8 busy slots under the profiler (2-token
    # prompts: the window reads decode steps, not prefill)
    t0 = time.perf_counter()
    sch.reset()
    for i, p in enumerate(prompts[:8]):
        sch.submit(p[:2], 8, seed=i)
    sch.admit()
    prof = profile_window(lambda: [sch.step() for _ in range(3)])
    out["profile_decode_3_steps"] = prof
    out["kernels_per_step"] = prof["kernels"] / 3
    out["busy_ms_per_step"] = prof["device_busy_ms"] / 3
    spent["profile_s"] = time.perf_counter() - t0
    if replay:
        # the two shortest requests replayed alone (batch 1): cuBLAS may
        # round a GEMM of 8 rows and of one row differently, so the
        # agreement is reported only
        t0 = time.perf_counter()
        one = BatchScheduler(params, cfg, slots=1, cache_len=256, device=dev)
        agree = []
        for i in sorted(range(len(prompts)),
                        key=lambda i: len(prompts[i]))[:2]:
            rid = one.submit(prompts[i], max_new, seed=1000 + i)
            alone = one.run()[rid]
            same = [a == b for a, b in zip(alone, outs[i])]
            agree.append({"request": i, "equal": sum(same), "of": max_new,
                          "first_difference": same.index(False)
                          if False in same else None})
        out["batch1_replay"] = agree
        spent["replay_s"] = time.perf_counter() - t0
        del one
    out["spent"] = spent
    del sch, params
    torch.cuda.empty_cache()
    return out


def _max_err(a, b) -> float:
    return float((a.float() - b.float().to(a.device)).abs().max())


def _float_paths(cfg, params, dev) -> dict:
    """A long sequence's path against its plain form on the card, on the
    first layer of each mixer, over random inputs: flash (s = 4,096, four
    KV blocks) against the masked attention; a windowed layer's flash (s = 2
    windows) and banded (s = 3 windows) loops against the window mask;
    SSD in chunks of ``ssm_chunk`` (s = 1,024: four chunks) against the
    step recurrence in float64."""
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S
    from repro_torch.models import transformer as T

    gen = torch.Generator(device=dev).manual_seed(9)
    out = {}
    for layer, blk, mixer, _ in T._layers(params, cfg):
        if mixer == "ssd" and "ssd_chunked" not in out:
            x = torch.randn((1, 1024, cfg.d_model), generator=gen, device=dev)
            got = S.ssd_mixer(blk["mixer"], x, cfg)
            # the step recurrence (ssd_decode) in float64
            p64 = {k: v.double() for k, v in blk["mixer"].items()}
            c64 = {k: v.double() if v.is_floating_point() else v
                   for k, v in S.ssd_cache(cfg, 1, dev).items()}
            rec = torch.cat([S.ssd_decode(p64, x[:, i:i + 1].double(), c64,
                                          cfg)[0] for i in range(1024)], 1)
            err = _max_err(got, rec)
            out["ssd_chunked"] = dict(
                layer=layer, s=1024, chunk=cfg.ssm_chunk, max_abs_err=err,
                rel_err=err / float(rec.abs().max()), rtol=FLOAT_SSD_RTOL)
            check(out["ssd_chunked"]["rel_err"] <= FLOAT_SSD_RTOL,
                  f"{cfg.name}: chunked SSD {err} from the recurrence")
        if mixer in ("attn", "local") and mixer not in out:
            window = cfg.window_size if mixer == "local" else 0
            runs = ([("flash", 2 * window), ("banded", 3 * window)] if window
                    else [("flash", 4096)])
            res = {}
            for path, s in runs:
                x = torch.randn((1, s, cfg.d_model), generator=gen, device=dev)
                pos = torch.arange(s, device=dev).expand(1, s)
                q, k, v = L._qkv(blk["mixer"], x, pos, cfg)
                if path == "flash":
                    got = L._flash_attention(q, k, v, cfg.attn_softcap,
                                             window=window, blk=s // 4)
                else:
                    got = L._banded_local(q, k, v, cfg, window)
                mask = (L.window_mask(s, s, window, device=dev) if window
                        else L.causal_mask(s, s, device=dev))
                want = L._sdpa(q, k, v, mask[None, None, None],
                               cfg.attn_softcap)
                res[path] = dict(s=s, max_abs_err=_max_err(got, want),
                                 atol=FLOAT_PATH_ATOL)
                del q, k, v, got, want
            out[mixer] = dict(layer=layer, window=window, **res)
    for what in out.values():
        for r in [what] + [v for v in what.values() if isinstance(v, dict)]:
            if "atol" in r:
                check(r["max_abs_err"] <= r["atol"],
                      f"{cfg.name}: a long-sequence path is "
                      f"{r['max_abs_err']} from its plain form")
    return out


def _float_check(name: str, layers, cut: str, dev) -> dict:
    """(b)/(c): float32 at full width (``layers`` of the depth kept):
    forward logits on [2, 64] on the card against the same parameters on
    the host, teacher-forced decode against the forward on the card, and
    the long-sequence paths (:func:`_float_paths`)."""
    from repro_torch import tree as TR
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(registry.get_config(name), dtype="float32")
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    gen = torch.Generator().manual_seed(11)
    b, s = FLOAT_TOKENS
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
    t0 = time.perf_counter()
    params = T.init_params(cfg, 1, dev)
    with torch.no_grad():
        card = T.forward(params, {"tokens": tokens.to(dev)}, cfg,
                         remat="none")[0]
        check(bool(torch.isfinite(card).all()), f"{name}: non-finite logits")
        host = T.forward(TR.tree_map(torch.Tensor.cpu, params),
                         {"tokens": tokens}, cfg, remat="none")[0]
        host_err = _max_err(card, host)
        del host
        cache = T.init_cache(cfg, b, s, dev)
        dec = torch.cat([T.decode_step(params, cache, tokens[:, i:i + 1]
                                       .to(dev), cfg)[0] for i in range(s)],
                        dim=1)
        decode_err = _max_err(dec, card)
        paths = _float_paths(cfg, params, dev)
    check(host_err <= FLOAT_HOST_ATOL,
          f"{name}: card logits {host_err} from the host's")
    check(decode_err <= FLOAT_DECODE_ATOL,
          f"{name}: decode logits {decode_err} from the forward's")
    out = dict(
        arch=name, reduced=cut, layers=cfg.num_layers,
        block_pattern=list(cfg.block_pattern), d_model=cfg.d_model,
        dtype="float32", tf32=torch.backends.cuda.matmul.allow_tf32,
        tokens=[b, s], logit_max=float(card.abs().max()),
        card_vs_host=dict(max_abs_err=host_err, atol=FLOAT_HOST_ATOL),
        decode_vs_forward=dict(max_abs_err=decode_err,
                               atol=FLOAT_DECODE_ATOL),
        paths=paths, seconds=time.perf_counter() - t0)
    del params, card, dec, cache
    torch.cuda.empty_cache()
    return out


def phase_float_lm(dev) -> dict:
    """The float LM stack on the card (it launches none of K1-K9): (a)
    yi-9b served at full width and depth in bfloat16; (b) yi-9b cut to 2
    layers and (c) mamba2-780m whole and recurrentgemma-9b cut to one
    period, in float32 with TF32 off, checked against the host, decode
    against forward, and the long-sequence paths against their plain
    forms."""
    from repro_torch.configs import registry

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    out = {"serve": _float_serve(dev, registry.get_config(FLOAT_SERVE))}
    for name, layers, cut in FLOAT_CHECKS:
        out[name] = _float_check(name, layers, cut, dev)
    return out


# ---------------------------------------------------------------------------
# Phase moe: Mixture-of-Experts (models/moe.py; the float stacks launch no
# kernel of the port, a spiking MoE runs K1, K2, K7 and K8)
# ---------------------------------------------------------------------------

MOE_NAME = "phi3.5-moe-42b-a6.6b"
RG_NAME = "recurrentgemma-9b"
# (a) served in its config's bfloat16 at full width, 8 of its 32 layers:
# all 32 take ~83.8 GB of weights, past the card's 80 GB
MOE_SERVE_LAYERS = 8
# (b) float32, TF32 off, 2 layers, on tokens [2, 64] (as float_lm's
# checks): the card against the host (FLOAT_HOST_ATOL), teacher-forced
# decode under moe_impl="dense" against the dense forward
# (FLOAT_DECODE_ATOL), and moe_ep with no drop against moe_dense within
# MOE_EP_RTOL of the largest |y|: the reference's init draws an expert's
# weights with std 1/sqrt(E) (its fan is the leaf's first axis), so a
# unit-scale input gives outputs in the thousands, and the two paths sum
# their float32 products in other orders
MOE_CHECK_LAYERS = 2
MOE_EP_RTOL = 1e-4
# (c) arctic-480b, one of its 35 layers, bfloat16: moe_ep (capacity factor
# 16: no choice dropped) against moe_dense.  Both round each expert's
# output and the combine in bfloat16 (2**-8 relative), at other points:
# held within ARCTIC_RTOL of the largest |value|, 8 ulps of it
ARCTIC = "arctic-480b"
ARCTIC_RTOL = 2.0 ** -5
MOE_NO_DROP_CF = 16.0
# (d) the spiking MoE's served requests: 4 of the serve phase's prompts,
# 8 new tokens, 4 slots, cache_len 64 (paged: pages of 8); the plain
# backend's serves draw through the threefry twin, the phase's slowest part
MOE_SPIKING_SERVE = dict(requests=4, max_new=8, slots=4, cache_len=64,
                         page_len=8)
MOE_BUDGET_S = 90.0


def dropped_choices(idx, cfg) -> dict:
    """How many of the router's choices ``idx [tokens, k]`` moe_ep drops
    on one device: past the packed buffer's ``cap`` rows, then past an
    expert's ``c2`` rows (``models/moe.py:capacities``)."""
    from repro_torch.models import moe as M

    n_tok, k = idx.shape
    cap, c2 = M.capacities(n_tok, cfg)
    cnt = torch.bincount(idx.reshape(-1)[:cap], minlength=cfg.num_experts)
    return dict(choices=n_tok * k, cap=cap, c2=c2,
                past_cap=max(n_tok * k - cap, 0),
                past_c2=int((cnt - c2).clamp(min=0).sum()),
                busiest_expert=int(cnt.max()))


def _moe_check(dev) -> dict:
    """(b): phi3.5-moe cut to 2 layers in float32 (TF32 off) on tokens
    [2, 64]: the forward (``ep_a2a``) on the card against the same
    parameters on the host; teacher-forced decode under ``"dense"``
    against the dense forward; layer 0's ``moe_ep`` at capacity factor 16
    (no choice dropped) against ``moe_dense``."""
    from repro_torch import tree as TR
    from repro_torch.configs import registry
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(registry.get_config(MOE_NAME), dtype="float32",
                              num_layers=MOE_CHECK_LAYERS)
    gen = torch.Generator().manual_seed(13)
    b, s = FLOAT_TOKENS
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
    t0 = time.perf_counter()
    params = T.init_params(cfg, 1, dev)
    with torch.no_grad():
        card, card_aux = T.forward(params, {"tokens": tokens.to(dev)}, cfg,
                                   remat="none")
        check(bool(torch.isfinite(card).all()), "phi3.5-moe: non-finite logits")
        host, host_aux = T.forward(TR.tree_map(torch.Tensor.cpu, params),
                                   {"tokens": tokens}, cfg, remat="none")
        host_err = _max_err(card, host)
        aux_err = abs(float(card_aux) - float(host_aux))
        del host
        dense, _ = T.forward(params, {"tokens": tokens.to(dev)}, cfg,
                             remat="none", moe_impl="dense")
        cache = T.init_cache(cfg, b, s, dev)
        dec = torch.cat([T.decode_step(params, cache, tokens[:, i:i + 1]
                                       .to(dev), cfg, moe_impl="dense")[0]
                         for i in range(s)], dim=1)
        decode_err = _max_err(dec, dense)
        wide = dataclasses.replace(cfg, capacity_factor=MOE_NO_DROP_CF)
        blk = T._take(params["periods"], 0)["blk0"]["moe"]
        x = torch.randn((b, s, cfg.d_model), generator=gen).to(dev)
        ye, _ = M.moe_ep(blk, x, wide)
        yd, _ = M.moe_dense(blk, x, wide)
        ep_err, y_max = _max_err(ye, yd), float(yd.abs().max())
        drops = dropped_choices(M.router(blk, x, wide)[1].reshape(b * s, -1),
                                wide)
    check(host_err <= FLOAT_HOST_ATOL,
          f"phi3.5-moe: card logits {host_err} from the host's")
    check(aux_err <= FLOAT_HOST_ATOL, f"phi3.5-moe: aux {aux_err} from the host's")
    check(decode_err <= FLOAT_DECODE_ATOL,
          f"phi3.5-moe: dense decode {decode_err} from the dense forward")
    check(drops["past_cap"] + drops["past_c2"] == 0,
          f"phi3.5-moe: capacity factor 16 dropped choices {drops}")
    check(ep_err <= MOE_EP_RTOL * y_max,
          f"phi3.5-moe: moe_ep {ep_err} from moe_dense (max {y_max})")
    out = dict(
        arch=MOE_NAME, layers=cfg.num_layers, dtype="float32",
        tf32=torch.backends.cuda.matmul.allow_tf32, tokens=[b, s],
        logit_max=float(card.abs().max()), aux=float(card_aux),
        card_vs_host=dict(max_abs_err=host_err, aux_err=aux_err,
                          atol=FLOAT_HOST_ATOL),
        decode_vs_forward_dense=dict(max_abs_err=decode_err,
                                     atol=FLOAT_DECODE_ATOL),
        ep_vs_dense_cf16=dict(max_abs_err=ep_err, y_max=y_max,
                              rtol_of_max=MOE_EP_RTOL, **drops),
        seconds=time.perf_counter() - t0)
    del params, card, dense, dec, cache
    torch.cuda.empty_cache()
    return out


def _arctic_check(dev) -> dict:
    """(c): arctic-480b's MoE at full width (128 experts of d_ff 4,864 and
    the dense residual MLP at d = 7,168), one layer, bfloat16, on tokens
    [2, 64]: the forward's logits and the layer's MoE on unit-scale inputs
    under ``moe_ep`` at capacity factor 16 against ``moe_dense``
    (``ARCTIC_RTOL``); at the config's 1.25 the dropped choices."""
    from repro_torch import tree as TR
    from repro_torch.configs import registry
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(registry.get_config(ARCTIC), num_layers=1)
    wide = dataclasses.replace(cfg, capacity_factor=MOE_NO_DROP_CF)
    gen = torch.Generator().manual_seed(17)
    b, s = FLOAT_TOKENS
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen).to(dev)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_params(cfg, 2, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in TR.flatten(params)[0])
    blk = T._take(params["periods"], 0)["blk0"]["moe"]
    x = torch.randn((b, s, cfg.d_model), generator=gen).to(dev, torch.bfloat16)
    res = {}
    with torch.no_grad():
        le, _ = T.forward(params, {"tokens": tokens}, wide, remat="none")
        ld, _ = T.forward(params, {"tokens": tokens}, wide, remat="none",
                          moe_impl="dense")
        ye, _ = M.moe_ep(blk, x, wide)
        yd, _ = M.moe_dense(blk, x, wide)
        for what, got, want in (("logits", le, ld), ("moe", ye, yd)):
            check(bool(torch.isfinite(got).all()), f"arctic: non-finite {what}")
            err, top = _max_err(got, want), float(want.float().abs().max())
            res[what] = dict(max_abs_err=err, max_abs=top,
                             rtol_of_max=ARCTIC_RTOL)
            check(err <= ARCTIC_RTOL * top,
                  f"arctic: moe_ep {what} {err} from moe_dense's (max {top})")
        idx = M.router(blk, x, cfg)[1].reshape(b * s, -1)
        wide_drops = dropped_choices(idx, wide)
        check(wide_drops["past_cap"] + wide_drops["past_c2"] == 0,
              f"arctic: capacity factor 16 dropped choices {wide_drops}")
        y125, _ = M.moe_ep(blk, x, cfg)
        default = dict(capacity_factor=cfg.capacity_factor,
                       **dropped_choices(idx, cfg),
                       max_abs_err_vs_dense=_max_err(y125, yd))
    out = dict(arch=ARCTIC, layers=1, experts=cfg.num_experts,
               d_model=cfg.d_model, d_ff=cfg.d_ff,
               moe_dense_ff=cfg.moe_dense_ff, dtype=cfg.dtype,
               params=n_params, init_s=init_s, tokens=[b, s],
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               ep_vs_dense_cf16=res, drops_cf16=wide_drops,
               drops_default=default, seconds=time.perf_counter() - t0)
    del params, blk, le, ld, ye, yd, y125
    torch.cuda.empty_cache()
    return out


def _moe_spiking(dev) -> tuple:
    """(d): the reduced phi3.5-moe as a spiking SSA stack (T = 4; its FFN
    ``moe_dense`` on the rate interface) through the CUDA backend: the
    forward's logits (K1 on q/k/v/o, the keyed K8 once a layer) equal to
    the plain backend's bit for bit, then dense (K1, K2) and paged (K1,
    K7; the fused plan refuses MoE) serves whose streams equal the plain
    backend's.  Every count starts at zero before the CUDA runs."""
    from repro_torch import prng
    from repro_torch.configs import registry
    from repro_torch.engine import XpikeformerEngine, get_backend
    from repro_torch.kernels import build as KB

    cfg = dataclasses.replace(registry.reduced_config(MOE_NAME), spiking=True,
                              attention_kind="ssa", spike_T=4)
    eng = XpikeformerEngine.from_config(cfg, backend="cuda", device=dev)
    eng.init(seed=0)
    plain = XpikeformerEngine(cfg=cfg, backend=get_backend("integer"),
                              device=eng.device, params=eng.params)
    key = prng.PRNGKey(42, dev)
    x = lm_tokens(cfg.vocab_size, 8, 64, 5).to(dev)
    sv = MOE_SPIKING_SERVE
    prompts = make_requests(cfg.vocab_size, sv["requests"])
    kw = dict(slots=sv["slots"], cache_len=sv["cache_len"])
    paged = dict(kw, paged=True, page_len=sv["page_len"])
    t0 = time.perf_counter()
    KB.reset_launches()
    logits = eng.forward(x, key)
    torch.cuda.synchronize()
    fwd = {k: v for k, v in KB.LAUNCHES.items() if v}
    dense_outs, _ = eng.serve(prompts, sv["max_new"], **kw)
    plan = eng.scheduler(**kw).plan
    paged_outs, pst = eng.serve(prompts, sv["max_new"], **paged)
    torch.cuda.synchronize()
    launched = {k: v for k, v in KB.LAUNCHES.items() if v}
    layers = cfg.num_layers
    want_fwd = {"aimc_spiking_linear": 4 * layers,
                "ssa_attention_keyed": layers}
    check(fwd == want_fwd, f"spiking MoE: the forward launched {fwd}")
    check(not plan.fused, f"spiking MoE: {plan.describe()}")
    for name in ("aimc_spiking_linear", "ssa_decode", "ssa_decode_paged",
                 "ssa_attention_keyed"):
        check(launched.get(name, 0) > 0, f"spiking MoE: {name} never ran")
    check(not launched.get("fused_decode_layer")
          and not launched.get("fused_decode_layer_paged"),
          f"spiking MoE: a fused layer ran {launched}")
    check(torch.equal(logits, plain.forward(x, key)),
          "spiking MoE: kernel and plain logits differ")
    check(dense_outs == plain.serve(prompts, sv["max_new"], **kw)[0],
          "spiking MoE: dense streams differ from the plain backend's")
    check(paged_outs == plain.serve(prompts, sv["max_new"], **paged)[0],
          "spiking MoE: paged streams differ from the plain backend's")
    check(paged_outs == dense_outs, "spiking MoE: paged streams differ from dense")
    out = dict(arch=cfg.name, layers=layers, d_model=cfg.d_model,
               experts=cfg.num_experts, T=cfg.spike_T, tokens=list(x.shape),
               logits_bitwise_equal=True, streams_equal_plain=True,
               plan=plan.describe(), launches_forward=fwd,
               launches=launched, prefix_hits=pst.prefix_hits,
               first_tokens=dense_outs[0], seconds=time.perf_counter() - t0)
    # one card's results, which the mesh phase's (g) must equal
    ref = dict(cfg=cfg, tokens=x.cpu().numpy(), logits=logits.cpu(),
               prompts=prompts, dense=dense_outs, paged=paged_outs)
    del eng, plain
    torch.cuda.empty_cache()
    return out, launched, ref


def phase_moe(dev) -> tuple:
    """Mixture-of-Experts on one card: (a) phi3.5-moe at full width, 8 of
    32 layers, bfloat16, served as the float serve is (``moe_impl=
    "ep_a2a"``); (b) its float32 checks; (c) arctic-480b's MoE at full
    width, one layer; (d) a spiking MoE through K1, K2, K7 and K8.  ->
    (the phase's line, the spiking MoE's launches, its one-card results
    for the mesh phase)."""
    from repro_torch.configs import registry

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    t0 = time.perf_counter()
    cfg = dataclasses.replace(registry.get_config(MOE_NAME),
                              num_layers=MOE_SERVE_LAYERS)
    out = {"serve": _float_serve(dev, cfg, replay=False)}
    out["serve"]["reduced"] = f"{MOE_SERVE_LAYERS} of 32 layers"
    out["check"] = _moe_check(dev)
    out["arctic"] = _arctic_check(dev)
    out["spiking"], launched, ref = _moe_spiking(dev)
    out["budget_s"] = MOE_BUDGET_S
    out["seconds"] = time.perf_counter() - t0
    return out, launched, ref


# ---------------------------------------------------------------------------
# Phase 7: the (data, model) mesh on one card
# ---------------------------------------------------------------------------


MESH = (2, 2)
# (e)-(g), the float and MoE stacks on the same mesh, in a budget of 90 s
# (its ranks' job seconds, the slowest rank's sum, and this process's
# one-card references).  (e) phi3.5-moe at full width in bfloat16, 4 of
# its 32 layers, each rank drawing its share (8 experts a layer and the
# whole rest): ~2.9B weights, 5.9 GB, a rank.  (f) 2 layers in float32:
# the forward within MESH_FWD_RTOL of one card's largest |logit| (every
# rank runs one card's dispatch over the whole batch; only cuBLAS's
# batching of the expert products differs), three teacher-forced decode
# steps within MESH_DECODE_RTOL where neither side drops a choice (a
# data rank routes its 4 slots with the reference's per-device
# capacities); (g) the spiking MoE of phase moe (d), bit for bit
MESH_MOE_LAYERS, MESH_MOE_CHECK_LAYERS = 4, 2
MESH_FWD_RTOL, MESH_DECODE_RTOL = 1e-5, 1e-4
MESH_DECODE_STEPS = 3
MESH_STACKS_BUDGET_S = 90.0


# (h)-(i): training on the same spawn, in a budget of 90 s (the ranks' job
# seconds, the slowest rank's sum, and this process's one-card steps and
# serve).  (h) phi3.5-moe at full width in bfloat16, 2 of its 32 layers
MESH_TRAIN_LAYERS, MESH_TRAIN_STEPS = 2, 4
MESH_TRAIN_DATA = (8, 256, 7)  # MarkovStream (batch, seq_len, seed)
MESH_TRAIN_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=MESH_TRAIN_STEPS)
# bytes a weight of (h)'s state: bfloat16 weight and gradient, two float32
# moments
MESH_TRAIN_BYTES_PER_WEIGHT = 2 + 2 + 4 + 4
# (h) recurrentgemma-9b at full width in bfloat16, one period (3 of its 38
# layers), 2 steps on MESH_TRAIN_DATA: its tied 256,000-row table is cut
# over both axes, RG-LRU over model, every embed axis over data (ZeRO-3)
MESH_RG_LAYERS, MESH_RG_STEPS = 3, 2
# (i) the reduced configs, one step each on (8, 32) tokens (mamba2-780m
# and recurrentgemma-9b with a vocabulary of 256, which the model axis
# cuts: the reduced 257 is prime); the spiking GPT's launcher run and the
# serve of its checkpoint
MESH_TRAIN_SMALL = (8, 32, 0)
MESH_TRAIN_SMALL_VOCAB = 256
MESH_TRAIN_SERVE = dict(requests=4, max_new=8, slots=4, cache_len=64)
# 150 s: 90 s used 23.1-27.8 s before recurrentgemma-9b's full-width
# steps and the two more reduced configs joined
MESH_TRAIN_BUDGET_S = 150.0
# (i) a mesh rank's first step against one card's: the same float32 work
# in other orders (no choice drops at factor 16), read 4.8e-7 apart on
# the GPT's loss and equal on its gradient norm and on phi3.5-moe's loss
# (NVIDIA H100 80GB HBM3, 700 W); tight enough that the router's
# statistics left unaveraged or a leaf left out of the norm would fail
MESH_TRAIN_LOSS_ATOL, MESH_TRAIN_NORM_RTOL = 1e-5, 1e-4
MESH_TRAIN_FIRST_STEP = ("train_gpt", "train_moe", "train_mamba",
                         "train_rg_small")
# (j) the front door on the same spawn, in a budget of 45 s (rank 0's job
# seconds, both layouts): (a)'s 8 requests x 16 new tokens through
# HttpFrontDoor on rank 0 as the three FD_TENANTS, ``metered`` holding a
# quarter of its cheapest request's joules (the serve phase's), its refill
# (FD_REFILL_TOKENS tokens' joules at the serve phase's rate, each
# second) on only once it has been preempted; dense, then paged
MESH_FD_BUDGET_S = 45.0
MESH_FD_NEW = 16
FD_BUCKET_SHARE, FD_REFILL_TOKENS = 0.25, 50


def megatron_only_specs(cfg):
    """The training cut before ZeRO-3 and the vocabulary, SSD and RG-LRU
    cuts, for the reckoning beside this one: the attention's heads over
    ``model`` only where the KV heads divide too, ``ffn``, the experts and
    (``fsdp``) their ``d_ff``; every other leaf whole."""
    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding as SH

    over = {k: () for k in ("embed", "vocab", "ssm_inner", "ssm_heads",
                            "ssm_conv", "lru")}
    if cfg.num_kv_heads % MESH[1]:
        over.update(heads=(), kv_heads=())
    sizes = {"data": MESH[0], "model": MESH[1]}

    def walk(axes, shapes):
        if isinstance(axes, dict):
            return {k: walk(axes[k], shapes[k]) for k in axes}
        return SH.spec_for(axes, shapes, sizes, overrides=over)

    return walk(SH.param_axes(cfg), T._model_shapes(cfg))


def mesh_train_reckoning(cfg, opt_bytes: int = MESH_TRAIN_BYTES_PER_WEIGHT
                         ) -> dict:
    """(h)'s memory reckoning, before its first call: the weights each
    rank of ``MESH`` holds under the training cut, and their state's
    bytes at ``opt_bytes`` a weight, per rank and for the card; the same
    under the layout before the memory-only cuts (``megatron_only``:
    :func:`megatron_only_specs`)."""
    from repro_torch import tree as TR
    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding as SH

    shapes = TR.flatten(T._model_shapes(cfg),
                        is_leaf=lambda x: isinstance(x, tuple))[0]

    def held(specs):  # every rank holds an even cut
        flat = TR.flatten(specs, is_leaf=lambda x: isinstance(x, tuple))[0]
        n = sum(math.prod(shape) // math.prod(
            {"data": MESH[0], "model": MESH[1]}.get(a, 1) for a in spec)
            for shape, spec in zip(shapes, flat))
        return [n] * (MESH[0] * MESH[1])

    def layout(ranks):
        return {"weights_per_rank": ranks,
                "gb_per_rank": [r * opt_bytes / 1e9 for r in ranks],
                "gb_card": sum(ranks) * opt_bytes / 1e9}

    ranks = held(SH.train_specs(cfg, MESH))
    return {"weights_whole": sum(math.prod(x) for x in shapes),
            "bytes_per_weight": opt_bytes, **layout(ranks),
            "megatron_only": layout(held(megatron_only_specs(cfg)))}


def mesh_train_jobs(root: Path) -> dict:
    """(h)-(i)'s rank jobs, in spawn order."""
    from repro_torch.configs import registry

    full = dataclasses.replace(registry.get_config(MOE_NAME),
                               num_layers=MESH_TRAIN_LAYERS)
    rg = dataclasses.replace(registry.get_config(RG_NAME),
                             num_layers=MESH_RG_LAYERS)
    gpt = registry.reduced_config(ARCH)
    small_vocab = {n: dataclasses.replace(registry.reduced_config(n),
                                          vocab_size=MESH_TRAIN_SMALL_VOCAB)
                   for n in ("mamba2-780m", RG_NAME)}
    moe = dataclasses.replace(registry.reduced_config(MOE_NAME),
                              capacity_factor=MOE_NO_DROP_CF)
    par = dict(remat="none")
    small = dict(kind="train", init_seed=0, data=MESH_TRAIN_SMALL, steps=1,
                 key_seed=0, parallel=par, opt=MESH_TRAIN_OPT)
    sv = MESH_TRAIN_SERVE
    return {
        "train_full": dict(kind="train", cfg=full, init_seed=5,
                           data=MESH_TRAIN_DATA, steps=MESH_TRAIN_STEPS,
                           key_seed=0, probe=True, parallel=par,
                           opt=MESH_TRAIN_OPT),
        "train_rg": dict(kind="train", cfg=rg, init_seed=6,
                         data=MESH_TRAIN_DATA, steps=MESH_RG_STEPS,
                         key_seed=0, parallel=par, opt=MESH_TRAIN_OPT),
        "train_gpt": dict(small, cfg=gpt),
        "train_moe": dict(small, cfg=moe),
        "train_mamba": dict(small, cfg=small_vocab["mamba2-780m"]),
        "train_rg_small": dict(small, cfg=small_vocab[RG_NAME]),
        "launch_gpt": dict(kind="launch", arch=ARCH, kw=dict(
            smoke=True, steps=2, batch=MESH_TRAIN_SMALL[0],
            seq_len=MESH_TRAIN_SMALL[1], ckpt_dir=str(root / "mesh_launch"),
            ckpt_every=0, fail_at=-1, restore=False, straggler_factor=3.0,
            seed=0, log_every=0, lr=1e-3, probe=False)),
        "serve_trained": dict(
            cfg=gpt, ckpt=str(root / "mesh_launch"), backend="cuda",
            prompts=[p[:12] for p in make_requests(gpt.vocab_size)[
                :sv["requests"]]], max_new=sv["max_new"], slots=sv["slots"],
            cache_len=sv["cache_len"], seed0=1000),
    }


def mesh_train_one_card(dev, jobs: dict) -> dict:
    """(i)'s one-card side: the whole step of each reduced config (the
    same train job on a mesh of one rank)."""
    from repro_torch.distributed import jobs as J
    from repro_torch.launch.mesh import ServingMesh

    t0 = time.perf_counter()
    one = ServingMesh.single(dev)
    out = {n: J.train_job(one, jobs[n])["metrics"][0]
           for n in MESH_TRAIN_FIRST_STEP}
    out["seconds"] = time.perf_counter() - t0
    return out


def mesh_train(res, first: int, jobs: dict, one_card: dict, dev,
               total: dict, rg_reckoning: dict) -> dict:
    """(h)-(i)'s checks and readings from the ranks' results (``jobs`` in
    order from ``first``); (i)'s serve launches join ``total``;
    ``rg_reckoning``: recurrentgemma-9b's (:func:`mesh_train_reckoning`)."""
    from repro_torch.distributed import jobs as J
    from repro_torch.launch.mesh import ServingMesh

    names = list(jobs)
    got = {n: [r[first + i] for r in res] for i, n in enumerate(names)}
    out = {}
    # (h) the full-width MoE
    ranks = []
    for rank, r in enumerate(got["train_full"]):
        losses = [m["loss"] for m in r["metrics"]]
        check(all(math.isfinite(x) for x in losses),
              f"mesh train (h): rank {rank}: a loss is not finite")
        check(losses == [m["loss"] for m in got["train_full"][0]["metrics"]],
              f"mesh train (h): rank {rank}'s losses differ from rank 0's")
        check(r["probe_after"] < r["probe_before"],
              f"mesh train (h): rank {rank}: probe loss {r['probe_before']} "
              f"-> {r['probe_after']}")
        steps = []
        for d in r["dispatch"]:
            rows = list(d["by_tokens"].values())
            steps.append(dict(
                all_to_alls=sum(x["all_to_alls"] for x in rows),
                a2a_bytes=sum(x["a2a_bytes"] for x in rows),
                gathers=sum(x.get("gathers", 0) for x in rows),
                gather_bytes=sum(x.get("gather_bytes", 0) for x in rows),
                branches=sorted({b for x in rows
                                 for b in x.get("branches", [])}),
                dropped_past_cap=d["past_cap"], dropped_past_c2=d["past_c2"]))
        ranks.append(dict(
            rank=rank, weights_held=r["held"], losses=losses,
            grad_norms=[m["grad_norm"] for m in r["metrics"]],
            probe_before=r["probe_before"], probe_after=r["probe_after"],
            step_ms=[1e3 * t for t in r["step_s"]],
            per_step_forward_dispatch=steps,
            max_memory_allocated=r["max_memory_allocated"],
            job_s=r["job_s"]))
    full = jobs["train_full"]["cfg"]
    out["moe_full"] = dict(
        arch=full.name, layers=full.num_layers,
        reduced=f"{MESH_TRAIN_LAYERS} of 32 layers", dtype=full.dtype,
        tokens=[MESH_TRAIN_DATA[0], MESH_TRAIN_DATA[1] + 1],
        steps=MESH_TRAIN_STEPS, ranks=ranks,
        note="dispatch counts are the forward's; the backward moves the "
             "same bytes back")
    # (h) recurrentgemma-9b at full width under the cuts
    rg = jobs["train_rg"]["cfg"]
    rg_ranks = []
    for rank, r in enumerate(got["train_rg"]):
        losses = [m["loss"] for m in r["metrics"]]
        check(all(math.isfinite(x) for x in losses),
              f"mesh train (h) {rg.name}: rank {rank}: a loss is not finite")
        check(losses == [m["loss"] for m in got["train_rg"][0]["metrics"]],
              f"mesh train (h) {rg.name}: rank {rank}'s losses differ from "
              "rank 0's")
        rg_ranks.append(dict(
            rank=rank, weights_held=r["held"], losses=losses,
            grad_norms=[m["grad_norm"] for m in r["metrics"]],
            step_ms=[1e3 * t for t in r["step_s"]],
            max_memory_allocated=r["max_memory_allocated"],
            job_s=r["job_s"]))
    old = rg_reckoning["megatron_only"]["gb_per_rank"][0] * 1e9
    for r in rg_ranks:
        check(r["max_memory_allocated"] < old,
              f"mesh train (h) {rg.name}: rank {r['rank']} peaked at "
              f"{r['max_memory_allocated']} B, not below the old layout's "
              f"state alone ({old:.0f} B)")
    out["rg_full"] = dict(
        arch=rg.name, reduced=f"{MESH_RG_LAYERS} of 38 layers (one period)",
        dtype=rg.dtype, tokens=[MESH_TRAIN_DATA[0], MESH_TRAIN_DATA[1] + 1],
        steps=MESH_RG_STEPS, ranks=rg_ranks)
    # (i) the reduced configs' first step against one card's
    first_step = {}
    for name in MESH_TRAIN_FIRST_STEP:
        want = one_card[name]
        rows = []
        for rank, r in enumerate(got[name]):
            m = r["metrics"][0]
            check(abs(m["loss"] - want["loss"]) <= MESH_TRAIN_LOSS_ATOL,
                  f"mesh train (i) {name}: rank {rank} loss {m['loss']} vs "
                  f"one card's {want['loss']}")
            check(abs(m["grad_norm"] - want["grad_norm"])
                  <= MESH_TRAIN_NORM_RTOL * abs(want["grad_norm"]),
                  f"mesh train (i) {name}: rank {rank} grad norm "
                  f"{m['grad_norm']} vs one card's {want['grad_norm']}")
            rows.append(dict(rank=rank, loss=m["loss"],
                             grad_norm=m["grad_norm"],
                             dropped=sum(d["past_cap"] + d["past_c2"]
                                         for d in r["dispatch"])))
        first_step[name] = dict(arch=jobs[name]["cfg"].name,
                                one_card_loss=want["loss"],
                                one_card_grad_norm=want["grad_norm"],
                                ranks=rows)
    out["first_step"] = dict(loss_atol=MESH_TRAIN_LOSS_ATOL,
                             norm_rtol=MESH_TRAIN_NORM_RTOL, **first_step)
    # (i) the launcher's (2, 2) checkpoint served on the mesh and one card
    t0 = time.perf_counter()
    serve = jobs["serve_trained"]
    card = J.serve_job(ServingMesh.single(dev), serve)
    card_s = time.perf_counter() - t0
    served = {}
    for rank, r in enumerate(got["serve_trained"]):
        check(r["outputs"] == card["outputs"],
              f"mesh train (i): rank {rank}'s streams of the trained "
              "checkpoint differ from one card's")
        check(r["fused"] and r["backend"] == "sharded[cuda]",
              f"mesh train (i): plan {r['fused']}, {r['backend']}")
        for k, v in r["launches"].items():
            served[k] = served.get(k, 0) + v
            total[k] = total.get(k, 0) + v
    for k in ("aimc_matmul_counts", "lif", "fused_decode_layer"):
        check(served.get(k, 0) > 0, f"mesh train (i): {k} never ran")
    out["trained_checkpoint_served"] = dict(
        launcher_losses=got["launch_gpt"][0]["losses"],
        requests=len(serve["prompts"]), max_new=serve["max_new"],
        streams_equal_one_card=True,
        launches={k: v for k, v in served.items() if v})
    slowest = max(sum(r[first + i]["job_s"] for i in range(len(names)))
                  for r in res)
    out["rank_job_s"] = slowest
    out["one_card_s"] = one_card["seconds"] + card_s
    out["seconds"] = slowest + out["one_card_s"]
    out["budget_s"] = MESH_TRAIN_BUDGET_S
    return out


def mesh_front_door_jobs(base: dict, prompts, served: dict) -> dict:
    """(j)'s rank jobs: the front door dense, then paged, with the serve
    phase's request energies (32 new tokens each) setting ``metered``'s
    bucket and refill."""
    energy = served["request_energy_j"]
    bucket = FD_BUCKET_SHARE * min(energy[2:len(prompts):3])
    refill = (FD_REFILL_TOKENS * sum(energy) / served["tokens"]
              * served["tokens_per_s"])
    tenants = {"interactive": dict(priority=0), "batch": dict(priority=1),
               "metered": dict(priority=1, energy_budget_j=bucket,
                               preempt=True)}
    fd = dict(base, kind="front_door", prompts=prompts, max_new=MESH_FD_NEW,
              tenants=tenants, refill_on_preempt={"metered": refill})
    return {"dense": fd, "paged": dict(fd, paged=True, page_len=8)}


def mesh_front_door(res, first: int, jobs: dict, want, total: dict) -> dict:
    """(j)'s checks and readings from the ranks' results (``jobs`` in
    order from ``first``; ``want``: (a)'s streams, one card's); the
    launches join ``total``."""
    out, seconds = {}, 0.0
    for j, (layout, job) in enumerate(jobs.items()):
        where = f"mesh front door ({layout})"
        ranks = [r[first + j] for r in res]
        r0 = ranks[0]
        check(r0["streams"] == want, f"{where}: the SSE streams differ from "
              "(a)'s direct mesh streams")
        check(r0["errors"] == [None] * len(want) and
              [d["tokens"] for d in r0["done"]] == want,
              f"{where}: a stream failed or its done payload differs: "
              f"{r0['errors']}")
        results = {r["request_id"]: r for r in r0["results"]}
        check(len(results) == len(want), f"{where}: missing results")
        preempted = {r["tenant"] for r in results.values()
                     if r["preemptions"]}
        check(preempted == {"metered"} and r0["preemptions"] >= 1,
              f"{where}: preempted tenants {preempted}")
        records = collections.Counter(r["decision"] for r in r0["records"])
        check(records["readmit"] >= 1, f"{where}: no re-admission")
        kernel = ("fused_decode_layer_paged" if job.get("paged")
                  else "fused_decode_layer")
        same = ("decode_steps", "decoded_tokens", "prefill_tokens",
                "admissions", "evictions", "energy_j", "prefix_hits")
        for rank, r in enumerate(ranks):
            check(r["outputs"] == r0["outputs"] and
                  {k: r["stats"][k] for k in same} ==
                  {k: r0["stats"][k] for k in same} and
                  r["request_energy_j"] == r0["request_energy_j"],
                  f"{where}: rank {rank}'s scheduler ended unlike rank 0's")
            check(r["telemetry"] == (rank == 0) and
                  ("events" in r) == (rank == 0),
                  f"{where}: rank {rank} telemetry {r['telemetry']}")
            for k in ("aimc_matmul_counts", "lif", kernel):
                check(r["launches"].get(k, 0) > 0,
                      f"{where}: rank {rank} launched no {k}")
            if rank:
                check(r["followed"]["steps"] == r0["stats"]["decode_steps"],
                      f"{where}: rank {rank} stepped "
                      f"{r['followed']['steps']} times, rank 0 "
                      f"{r0['stats']['decode_steps']}")
            for k, v in r["launches"].items():
                total[k] = total.get(k, 0) + v
        events = {(e["event"], e["fid"]) for e in r0["events"] if "fid" in e}
        for fid in results:
            check({("admit", fid), ("first_token", fid),
                   ("finish", fid)} <= events,
                  f"{where}: rank 0's trace lacks request {fid}'s lifecycle")
        scrape = parse_prometheus(r0["metrics"])
        check(scrape["xpike_frontdoor_running"] == 0 and
              scrape["xpike_frontdoor_queue_depth"] == 0,
              f"{where}: /metrics after the last done reads running "
              f"{scrape['xpike_frontdoor_running']}, queued "
              f"{scrape['xpike_frontdoor_queue_depth']}")
        check(scrape["xpike_ttft_seconds_count"] == len(want),
              f"{where}: {scrape['xpike_ttft_seconds_count']} TTFTs for "
              f"{len(want)} requests")
        ttft = [r["ttft_s"] for r in results.values()]
        delivered = sum(len(t) for t in r0["streams"])
        st = r0["stats"]
        seconds += r0["job_s"]
        out[layout] = dict(
            requests=len(want), tokens=delivered,
            makespan_s=r0["makespan_s"],
            tokens_per_s=delivered / r0["makespan_s"],
            ttft_p50_s=percentile(ttft, 50), ttft_p99_s=percentile(ttft, 99),
            preemptions=r0["preemptions"], records=dict(records),
            decode_steps=st["decode_steps"],
            prefill_tokens=st["prefill_tokens"],
            decode_step_ms=1e3 * st["decode_s"] / st["decode_steps"],
            bucket_j=job["tenants"]["metered"]["energy_budget_j"],
            followers=[r["followed"] for r in ranks[1:]],
            job_s=r0["job_s"],
            launches={k: v for k, v in r0["launches"].items() if v})
    out["seconds"] = seconds
    out["budget_s"] = MESH_FD_BUDGET_S
    return out


def mesh_moe_one_card(dev, cfg, seed: int, tokens) -> dict:
    """(f)'s one-card side: the whole tree's forward (``ep_a2a``) on
    ``tokens [8, 64]`` and three teacher-forced decode steps of 8 slots,
    each with the choices it dropped."""
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    params = T.init_params(cfg, seed, dev)
    x = tokens.to(dev)
    with torch.no_grad():
        M.DISPATCH.reset()
        fwd = T.forward(params, {"tokens": x}, cfg, remat="none")[0]
        fwd_drops = M.DISPATCH.read()
        cache = T.init_cache(cfg, x.shape[0], MESH_DECODE_STEPS, dev)
        dec, drops = [], []
        for i in range(MESH_DECODE_STEPS):
            M.DISPATCH.reset()
            dec.append(T.decode_step(params, cache, x[:, i:i + 1], cfg)[0])
            drops.append(M.DISPATCH.read())
        M.DISPATCH.reset(enabled=False)
    out = dict(forward=fwd.float().cpu(), forward_drops=fwd_drops,
               decode=torch.cat(dec, 1).float().cpu(), decode_drops=drops,
               seconds=time.perf_counter() - t0)
    del params, cache, fwd, dec
    torch.cuda.empty_cache()
    return out


def _dropped(d: dict) -> int:
    return d["past_cap"] + d["past_c2"]


def mesh_stacks(res, first: int, jobs: dict, one_card: dict, spiking: dict,
                total: dict) -> dict:
    """(e)-(g)'s checks and readings from the ranks' results (the jobs of
    ``jobs``, in order, from ``first``); (g)'s launches join ``total``."""
    names = list(jobs)
    got = {n: [r[first + i] for r in res] for i, n in enumerate(names)}
    out = {}
    # (e) the served phi3.5-moe
    serve, ranks = jobs["moe_serve"], []
    for rank, r in enumerate(got["moe_serve"]):
        st, moe = r["stats"], r["moe"]
        check(all(len(o) == serve["max_new"] for o in r["outputs"]),
              f"mesh moe: rank {rank}: a request got too few tokens")
        check(r["logits_finite"],
              f"mesh moe: rank {rank}: the served tree's logits are not "
              "all finite")
        check(r["outputs"] == got["moe_serve"][0]["outputs"],
              f"mesh moe: rank {rank}'s streams differ from rank 0's")
        step = moe["by_tokens"].get(serve["slots"] // MESH[0], {})
        ranks.append(dict(
            rank=rank, params=r["params"],
            tokens_per_s=st["decoded_tokens"] / r["wall_s"],
            wall_s=r["wall_s"], job_s=r["job_s"],
            decode_steps=st["decode_steps"],
            decode_step_ms=1e3 * st["decode_s"] / st["decode_steps"],
            prefill_tokens=st["prefill_tokens"],
            prefill_token_ms=1e3 * st["prefill_s"] / st["prefill_tokens"],
            dropped_past_cap=moe["past_cap"], dropped_past_c2=moe["past_c2"],
            all_to_alls_per_step=step.get("all_to_alls", 0)
            / st["decode_steps"],
            a2a_bytes_per_step=step.get("a2a_bytes", 0) / st["decode_steps"],
            by_tokens=moe["by_tokens"]))
    out["moe_serve"] = dict(
        arch=serve["cfg"].name, layers=serve["cfg"].num_layers,
        reduced=f"{MESH_MOE_LAYERS} of 32 layers", dtype=serve["cfg"].dtype,
        requests=len(serve["prompts"]), max_new=serve["max_new"],
        slots=serve["slots"], ranks=ranks)
    # (f) the float32 forward and decode against one card's
    fcfg = jobs["moe_forward"]["cfg"]
    ref_max = float(one_card["forward"].abs().max())
    errs = []
    for rank, r in enumerate(got["moe_forward"]):
        err = float((torch.from_numpy(r["logits"]).float()
                     - one_card["forward"]).abs().max())
        check(err <= MESH_FWD_RTOL * ref_max,
              f"mesh moe forward: rank {rank} {err} from one card's "
              f"(max {ref_max})")
        errs.append(err)
    dec_max = float(one_card["decode"].abs().max())
    steps = []
    for i in range(MESH_DECODE_STEPS):
        card_drops = _dropped(one_card["decode_drops"][i])
        row = dict(step=i, one_card_dropped=card_drops, ranks=[])
        for rank, r in enumerate(got["moe_decode"]):
            mesh_drops = _dropped(r["drops"][i])
            err = float((torch.from_numpy(r["logits"][:, i])
                         - one_card["decode"][:, i]).abs().max())
            if card_drops == 0 and mesh_drops == 0:
                check(err <= MESH_DECODE_RTOL * dec_max,
                      f"mesh moe decode: step {i} rank {rank} {err} from "
                      f"one card's (max {dec_max})")
            row["ranks"].append(dict(rank=rank, dropped=mesh_drops,
                                     max_abs_err=err))
        steps.append(row)
    check(any(all(x["dropped"] == 0 for x in row["ranks"])
              and row["one_card_dropped"] == 0 for row in steps),
          "mesh moe decode: every step dropped a choice: nothing compared")
    out["moe_check"] = dict(
        layers=fcfg.num_layers, dtype=fcfg.dtype,
        tokens=list(jobs["moe_forward"]["tokens"].shape),
        forward=dict(max_abs_err=max(errs), logit_max=ref_max,
                     rtol_of_max=MESH_FWD_RTOL,
                     one_card_dropped=_dropped(one_card["forward_drops"])),
        decode=dict(logit_max=dec_max, rtol_of_max=MESH_DECODE_RTOL,
                    steps=steps),
        one_card_s=one_card["seconds"])
    # (g) the spiking MoE, the attention held whole (one KV head)
    g = {}
    for rank in range(len(res)):
        fwd = got["spiking_forward"][rank]
        check(torch.equal(torch.from_numpy(fwd["logits"]), spiking["logits"]),
              f"mesh spiking moe: rank {rank}'s logits differ from one card's")
        for name in ("spiking_dense", "spiking_paged"):
            r = got[name][rank]
            check(r["outputs"] == spiking[name.split("_")[1]],
                  f"mesh {name}: rank {rank}'s streams differ from one card's")
        for name in ("spiking_forward", "spiking_dense", "spiking_paged"):
            for k, v in got[name][rank]["launches"].items():
                g[k] = g.get(k, 0) + v
                total[k] = total.get(k, 0) + v
    for k in ("aimc_spiking_linear", "ssa_attention_keyed"):
        check(g.get(k, 0) > 0, f"mesh spiking moe: {k} never ran")
    out["spiking_moe"] = dict(
        arch=spiking["cfg"].name, kv_heads=spiking["cfg"].num_kv_heads,
        attention="held whole (one KV head does not split over model=2)",
        logits_equal_one_card=True, streams_equal_one_card=True,
        launches={k: v for k, v in g.items() if v})
    slowest = max(sum(r[first + i]["job_s"] for i in range(len(names)))
                  for r in res)
    out["rank_job_s"] = slowest
    return out


def phase_mesh(dev, dense_outs, paged_outs, mesh_ref, launched, spiking,
               served):
    """The full-width spiking GPT on a (2, 2) mesh of four ranks sharing
    the card over gloo (NCCL refuses two ranks on one device), through
    ``run_ranks`` and the CUDA backend: (a) dense, the serve phase's first
    8 requests, 16 new tokens; (b) paged, the paged phase's 16 requests, 8
    new tokens; 8 slots (4 a data rank), ``cache_len=256``, waves of 4
    every 8 steps, seeds ``1000 + i``.  Each stream must be the prefix of
    the single-device stream of the same request; the launches of the
    measured runs (counted from zero on each rank) must show K5, K4, K3,
    K9 and K1.  (c) ``Executor.forward`` on ``mesh_ref``'s tokens ``[8,
    64]`` (4 rows a data rank): every rank's logits must equal one card's
    (``mesh_ref``'s), bit for bit, with K1, K5, K4 and the keyed K8
    launched.  (d) the train_launch phase's checkpoint (``launched``: its
    directory, requests and one card's streams of the restored tree),
    read on every rank with its serving placement
    (``elastic.state_shardings``) and served dense: every rank's streams
    must equal one card's.  (e)-(g): the float and MoE stacks on the same
    spawn (:func:`mesh_stacks`; ``spiking`` is phase moe (d)'s one-card
    results).  (h)-(i): training on the same spawn (:func:`mesh_train`,
    its memory reckoning emitted first).  (j): the front door on rank 0
    over the same spawn, the other ranks following it
    (:func:`mesh_front_door`; ``served``: the serve phase's readings)."""
    from repro_torch.configs import registry
    from repro_torch.distributed import jobs
    from repro_torch.launch.mesh import pick_backend, run_ranks

    cfg = registry.get_config(ARCH)
    base = dict(cfg=cfg, init_seed=0, backend="cuda", slots=8,
                cache_len=256, seed0=1000, wave=4, gap=8, warmup=True)
    dense = dict(base, prompts=make_requests(cfg.vocab_size)[:8], max_new=16)
    paged = dict(base, prompts=paged_requests(cfg.vocab_size), max_new=8,
                 paged=True, page_len=8)
    forward = dict(kind="forward", cfg=cfg, init_seed=0, backend="cuda",
                   tokens=mesh_ref[0], key_seed=MESH_KEY, warmup=True)
    restored = dict(base, ckpt=launched["ckpt"], prompts=launched["prompts"],
                    max_new=LAUNCH_NEW, warmup=False)
    t_stacks = time.perf_counter()
    moe_cfg = dataclasses.replace(registry.get_config(MOE_NAME),
                                  num_layers=MESH_MOE_LAYERS)
    check_cfg = dataclasses.replace(moe_cfg, dtype="float32",
                                    num_layers=MESH_MOE_CHECK_LAYERS)
    check_tokens = lm_tokens(check_cfg.vocab_size, *MESH_TOKENS, 19)
    one_card = mesh_moe_one_card(dev, check_cfg, 4, check_tokens)
    sv = MOE_SPIKING_SERVE
    skw = dict(cfg=spiking["cfg"], init_seed=0, backend="cuda",
               prompts=spiking["prompts"], max_new=sv["max_new"],
               slots=sv["slots"], cache_len=sv["cache_len"])
    stack_jobs = {
        "moe_serve": dict(base, cfg=moe_cfg, init_seed=3,
                          prompts=make_requests(moe_cfg.vocab_size)[:8],
                          max_new=16, check_tokens=lm_tokens(
                              moe_cfg.vocab_size, 8, 16, 23).numpy()),
        "moe_forward": dict(kind="forward", cfg=check_cfg, init_seed=4,
                            tokens=check_tokens.numpy(), key_seed=0),
        "moe_decode": dict(kind="decode", cfg=check_cfg, init_seed=4,
                           tokens=check_tokens.numpy(),
                           steps=MESH_DECODE_STEPS),
        "spiking_forward": dict(kind="forward", cfg=spiking["cfg"],
                                init_seed=0, backend="cuda",
                                tokens=spiking["tokens"], key_seed=42),
        "spiking_dense": skw,
        "spiking_paged": dict(skw, paged=True, page_len=sv["page_len"]),
    }
    t_stacks = time.perf_counter() - t_stacks
    root = Path(launched["ckpt"]).parent
    train_jobs = mesh_train_jobs(root)
    reckoning = mesh_train_reckoning(train_jobs["train_full"]["cfg"])
    emit({"phase": "mesh_train_reckoning", "card": card_line(),
          "arch": MOE_NAME, "layers": MESH_TRAIN_LAYERS, **reckoning})
    rg_reckoning = mesh_train_reckoning(train_jobs["train_rg"]["cfg"])
    emit({"phase": "mesh_train_reckoning", "card": card_line(),
          "arch": RG_NAME, "layers": MESH_RG_LAYERS, **rg_reckoning})
    train_one = mesh_train_one_card(dev, train_jobs)
    fd_jobs = mesh_front_door_jobs(base, dense["prompts"], served)
    t0 = time.perf_counter()
    res = run_ranks(jobs.run_jobs, MESH, device="cuda",
                    args=([dense, paged, forward, restored,
                           *stack_jobs.values(), *train_jobs.values(),
                           *fd_jobs.values()],),
                    timeout_s=900)
    wall_s = time.perf_counter() - t0
    out, total = {"shape": list(MESH),
                  "process_group": pick_backend(4, "cuda"),
                  "ranks_share_one_card": True, "run_ranks_s": wall_s}, {}
    for name, i, want in (("dense", 0, [o[:16] for o in dense_outs[:8]]),
                          ("paged", 1, [o[:8] for o in paged_outs]),
                          ("restored_checkpoint", 3, launched["outs"])):
        ranks = []
        for rank, r in enumerate(res):
            got = r[i]
            st = got["stats"]
            check(got["outputs"] == want,
                  f"mesh {name}: rank {rank}'s streams differ from one card's")
            check(got["fused"] and got["backend"] == "sharded[cuda]",
                  f"mesh {name}: plan {got['fused']}, {got['backend']}")
            check((st["data_shards"], st["model_shards"]) == MESH,
                  f"mesh {name}: shards")
            for k, v in got["launches"].items():
                total[k] = total.get(k, 0) + v
            ranks.append(dict(
                rank=rank, data_index=rank // MESH[1],
                model_index=rank % MESH[1], wall_s=got["wall_s"],
                tokens=st["decoded_tokens"],
                tokens_per_s=st["decoded_tokens"] / got["wall_s"],
                decode_steps=st["decode_steps"],
                decode_step_ms=1e3 * st["decode_s"] / st["decode_steps"],
                prefix_hits=st["prefix_hits"], cow_copies=st["cow_copies"],
                launches={k: v for k, v in got["launches"].items() if v}))
        if name == "paged":
            check(ranks[0]["prefix_hits"] > 0, "mesh paged: no prefix hit")
            check(ranks[0]["cow_copies"] > 0, "mesh paged: no copy-on-write")
        out[name] = dict(requests=len(want), streams_equal_one_card=True,
                         ranks=ranks)
    ftotal, franks = {}, []
    for rank, r in enumerate(res):
        got = r[2]
        check(torch.equal(torch.from_numpy(got["logits"]), mesh_ref[1]),
              f"mesh forward: rank {rank}'s logits differ from one card's")
        check(got["backend"] == "sharded[cuda]",
              f"mesh forward: backend {got['backend']}")
        for k, v in got["launches"].items():
            ftotal[k] = ftotal.get(k, 0) + v
            total[k] = total.get(k, 0) + v
        franks.append(dict(rank=rank, wall_s=got["wall_s"],
                           launches={k: v for k, v in got["launches"].items()
                                     if v}))
    for k in ("aimc_spiking_linear", "aimc_matmul_counts", "lif",
              "ssa_attention_keyed"):
        check(ftotal.get(k, 0) > 0, f"mesh forward: {k} never ran")
    check(ftotal["lif"] == ftotal["aimc_matmul_counts"],
          "mesh forward: K4 not once per K5")
    out["forward"] = dict(tokens=list(MESH_TOKENS), logits_equal_one_card=True,
                          ranks=franks)
    for k in ("aimc_matmul_counts", "lif", "fused_decode_layer",
              "fused_decode_layer_paged", "aimc_spiking_linear"):
        check(total.get(k, 0) > 0, f"mesh: {k} never ran")
    check(total["lif"] == total["aimc_matmul_counts"],
          f"mesh: {total['lif']} K4 launches for "
          f"{total['aimc_matmul_counts']} row-parallel linears")
    stacks = mesh_stacks(res, 4, stack_jobs, one_card, spiking, total)
    stacks["seconds"] = t_stacks + stacks["rank_job_s"]
    stacks["budget_s"] = MESH_STACKS_BUDGET_S
    out["stacks"] = stacks
    out["train"] = dict(reckoning=reckoning, rg_reckoning=rg_reckoning,
                        **mesh_train(
        res, 4 + len(stack_jobs), train_jobs, train_one, dev, total,
        rg_reckoning))
    out["front_door"] = mesh_front_door(
        res, 4 + len(stack_jobs) + len(train_jobs), fd_jobs,
        [o[:MESH_FD_NEW] for o in dense_outs[:8]], total)
    out["launches_summed_over_ranks"] = {k: v for k, v in total.items() if v}
    out["row_linear_dispatched"] = row_linear_dispatch(cfg)
    return out, total


def row_linear_cases(cfg):
    """One row-parallel spiking linear at each of the (2, 2) mesh's shapes
    (attention out and MLP out; the 4 local decode slots and the prefill
    row; with and without a bias): ``(label, run)``, ``run()`` calling
    ``ShardedBackend`` over the CUDA backend with a one-process stand-in
    for the model group (its ``all_reduce`` of whole rows is the identity;
    the ranks' own run gloo's)."""
    from types import SimpleNamespace

    from repro_torch.distributed.backend import ShardedBackend
    from repro_torch.engine import CudaBackend

    mesh = SimpleNamespace(model=MESH[1], model_index=0,
                           all_reduce_model=lambda x: x)
    be = ShardedBackend(CudaBackend(), mesh, cfg)
    gen = torch.Generator().manual_seed(21)
    dev = torch.device("cuda", 0)
    d_local = {"attn_out": cfg.num_heads * cfg.resolved_head_dim // MESH[1],
               "mlp_out": cfg.d_ff // MESH[1]}
    for name, d_in in d_local.items():
        for m in (4, 1):
            for with_bias in (False, True):
                lv, sc, bi = triple(gen, d_in, cfg.d_model, dev, with_bias)
                p = {"levels": lv, "scale": sc, "b": bi}
                x = spikes(gen, (cfg.spike_T, m, 1, d_in), 0.5, dev).float()
                run = (lambda p=p, x=x:
                       be.spiking_linear(p, x, part="row"))
                run()  # K5's scratch is allocated once
                torch.cuda.synchronize()
                yield f"{name}_m{m}" + ("_bias" if with_bias else ""), run


def row_linear_kernels(cfg, calls: int = BATCH) -> dict:
    """The device kernels of ``calls`` calls of each row-parallel linear
    of :func:`row_linear_cases` under torch.profiler: K5's kernel and K4's,
    exactly one of each a call, and no other.  Each session opens with
    :data:`LEAD_IN` spin kernels, as :func:`device_ms`'s do; a session that
    saw fewer launches than were made (the profiler drops launches, more of
    them as a run's sessions accumulate) is taken again, up to three times.
    A kernel other than K4's, K5's or the lead-in's fails at once.
    Returns each case's kernels and their counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for label, run in row_linear_cases(cfg):
        for _ in range(WARMUP):
            run()
        bad = []
        for _ in range(PROFILE_TAKES):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(LEAD_IN):
                    torch.cuda._sleep(1)
                torch.cuda.synchronize()
                for _ in range(calls):
                    run()
                torch.cuda.synchronize()
            kern = {e.key.split("namespace)::")[-1].split("(")[0]: e.count
                    for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and "spin_kernel" not in e.key}
            k4 = sum(n for k, n in kern.items() if k.startswith("lif_kernel"))
            k5 = sum(n for k, n in kern.items() if k.startswith("crossbar_"))
            check(k4 + k5 == sum(kern.values()) and k4 <= calls
                  and k5 <= calls, f"row-parallel linear {label}: kernels "
                  f"of {calls} calls: {kern}")
            PROFILER_SESSIONS["taken"] += 1
            if k4 == calls and k5 == calls:
                out[label] = kern
                break
            PROFILER_SESSIONS["launches_lost"] += 1
            bad.append(kern)
        check(label in out, f"row-parallel linear {label}: the profiler "
              f"misread {calls} calls in {PROFILE_TAKES} sessions: {bad}")
    return out


def row_linear_dispatch(cfg) -> dict:
    """What one call of each row-parallel linear of :func:`row_linear_cases`
    hands PyTorch's dispatcher (a ctypes launch dispatches nothing): only
    its outputs' allocations and views, with one K5 and one K4 launch
    counted -- no ``* scale``, ``+ b`` or other op that could launch a
    kernel.  Returns each case's dispatched ops."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.kernels import build as KB

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(str(func))
            return func(*args, **(kwargs or {}))

    out = {}
    for label, run in row_linear_cases(cfg):
        n5, n4 = KB.LAUNCHES["aimc_matmul_counts"], KB.LAUNCHES["lif"]
        with Ops() as ops:
            run()
        torch.cuda.synchronize()
        others = [f for f in ops.seen
                  if not f.startswith(("aten.empty", "aten.view"))]
        check(not others and KB.LAUNCHES["aimc_matmul_counts"] == n5 + 1
              and KB.LAUNCHES["lif"] == n4 + 1,
              f"row-parallel linear {label}: dispatched {ops.seen}")
        out[label] = ops.seen
    return out


# ---------------------------------------------------------------------------
# A/B of two trees of the port on one card (--ab): the windows alone
# ---------------------------------------------------------------------------

# (T, M, d_in, d_out): K1's prefill row, the ViT's projection and MLP rows;
# K5's four mesh shapes and the ViT's rows
AB_K1 = [(4, 1, 256, 256), (4, 4096, 384, 384), (4, 4096, 384, 1536),
         (4, 4096, 1536, 384)]
AB_K5 = [(4, 4, 512, 256), (4, 4, 128, 256), (4, 1, 512, 256),
         (4, 1, 128, 256), (4, 4096, 384, 384)]
AB_SERVES = 3  # timed runs of each serve window a tree
# K3 / K9 at the dense and paged decode shapes
AB_K3 = dict(t=4, b=8, d=256, h=4, kv=4, hd=64, l=256, dff=1024,
             pos=[0, 1, 40, 100, 200, 254, 255, 17])
AB_K9 = dict(t=4, b=8, d=256, h=4, kv=4, hd=64, pl=8, mp=32, dff=1024,
             pos=[40, 100, 0, 5, 200, 255, 17, 64], idle=(6,))


def digest(xs) -> str:
    """A short hash of token streams or a tensor, to hold two trees'
    outputs equal."""
    import hashlib

    if isinstance(xs, torch.Tensor):
        return hashlib.sha256(xs.cpu().numpy().tobytes()).hexdigest()[:16]
    return hashlib.sha256(json.dumps(xs).encode()).hexdigest()[:16]


def phase_windows(dev) -> dict:
    """The windows an A/B compares, on the tree whose ``src`` is first on
    the path: K1/K5 at :data:`AB_K1`/:data:`AB_K5` and K3/K9 at the decode
    shapes :data:`AB_K3`/:data:`AB_K9` (CUDA events; K3/K9 with digests of
    their outputs), K1's wrapper on the host clock at the prefill row and
    K3's and K9's at the decode shapes, the dense and paged serve
    windows of phases 3-4 (16 requests, 32 new tokens, after a warm-up,
    :data:`AB_SERVES` times; then three decode steps of 8 busy slots under
    the profiler) and
    the paper ViT and GPT forwards of phase 5 (unprofiled median of 5, then
    one profiled), with digests of the tokens and logits; the unfused
    paged window (phase 4's side run, three times, then three profiled
    steps), the whole-tree drift folds of the programmed LM stack and ViT
    (median of 9, with a digest of the images) and phase 6's programmed
    paged serve (with a digest of its tokens, clock, folds, GDC runs,
    gains and energy)."""
    from repro_torch import aimc_device as AD
    from repro_torch import prng
    from repro_torch.engine import XpikeformerEngine
    from repro_torch.kernels import aimc_matmul as KA
    from repro_torch.kernels import decode_fused as KFD

    gen = torch.Generator().manual_seed(16)
    out = {"k1_ms": {}, "k5_ms": {}}
    # K3 and K9 at the decode shapes (the kernels phase's main cases)
    head, ws, draws = layer_inputs(gen, dev, **AB_K3)
    k3 = lambda: KFD.fused_decode_layer_kernel(*head, *ws, *draws, hd=64)
    c = AB_K9
    table, write, kp, vp = paged_inputs(
        gen, b=c["b"], t=c["t"], kv=c["kv"], hd=c["hd"], pl=c["pl"],
        mp=c["mp"], pos=c["pos"], idle=c["idle"])
    t, b, d, h, hd, dff = (c[k] for k in ("t", "b", "d", "h", "hd", "dff"))
    l = c["mp"] * c["pl"]
    s_in = torch.randint(0, 3, (t, b, d), generator=gen).float()
    pws = [triple(gen, d, h * hd, dev), triple(gen, d, h * hd, dev, bias=False),
           triple(gen, d, h * hd, dev), triple(gen, h * hd, d, dev),
           triple(gen, d, dff, dev), triple(gen, dff, d, dev, bias=False)]
    pdraws = [torch.randint(0, hd, (b, t, h, l), generator=gen,
                            dtype=torch.int32).to(dev),
              torch.randint(0, l, (b, t, h, hd), generator=gen,
                            dtype=torch.int32).to(dev)]
    phead = [x.to(dev) for x in (s_in, kp, vp, table,
                                 torch.tensor(c["pos"], dtype=torch.int32),
                                 write.long())]
    k9 = lambda: KFD.fused_decode_layer_paged_kernel(*phead, *pws, *pdraws,
                                                     hd=64)
    for name, fn in (("k3", k3), ("k9", k9)):
        out[name] = dict(ms=time_ms(fn),
                         device_ms=device_ms(fn, "fused_decode_layer_kernel"),
                         wrapper_host_us=host_us(fn),
                         out=digest(torch.cat([x.flatten().float()
                                               for x in fn()])))
    for shapes, key in ((AB_K1, "k1_ms"), (AB_K5, "k5_ms")):
        for t, m, d_in, d_out in shapes:
            x = torch.randint(0, 4, (t, m, d_in), generator=gen).float().to(dev)
            w = triple(gen, d_in, d_out, dev)
            fn = ((lambda x=x, w=w: KA.aimc_spiking_linear_kernel(x, *w))
                  if key == "k1_ms" else
                  (lambda x=x, w=w: KA.aimc_matmul_counts_kernel(x, w[0])))
            out[key][f"{t}x{m}x{d_in}->{d_out}"] = time_ms(fn)
            if (t, m) == (4, 1) and key == "k1_ms":
                out["k1_wrapper_host_us"] = host_us(fn)
    eng = XpikeformerEngine.from_config(ARCH, task="lm", backend="cuda",
                                        device=dev)
    eng.init(seed=0)
    for name, prompts, kw in (
            ("dense", make_requests(eng.cfg.vocab_size), {}),
            ("paged", paged_requests(eng.cfg.vocab_size),
             dict(paged=True, page_len=8))):
        sch = eng.scheduler(slots=8, cache_len=256, **kw)
        drive(sch, prompts[:2], 4)  # warm-up
        runs = []
        for _ in range(AB_SERVES):
            sch.reset()
            outs, wall_s = drive(sch, prompts, 32)
            st = sch.stats
            runs.append((st.decoded_tokens / wall_s,
                         1e3 * st.decode_s / st.decode_steps,
                         1e3 * st.prefill_s / max(st.prefill_tokens, 1)))
        out[name] = dict(tokens_per_s=[r[0] for r in runs],
                         decode_step_ms=[r[1] for r in runs],
                         tokens=digest(outs))
        if name == "dense":  # batch-1 prefill: the unfused path (K1, K2)
            out[name]["prefill_token_ms"] = [r[2] for r in runs]
            sch.reset()
            sch.submit(list(range(16)), 4, seed=1)
            prof = profile_window(sch.admit)
            out[name].update(profiled_prefill_position_ms=prof["wall_ms"] / 15,
                             prefill_position_busy_ms=prof["device_busy_ms"]
                             / 15,
                             kernels_per_prefill_position=prof["kernels"] / 15)
        # three decode steps of 8 busy slots under the profiler
        sch.reset()
        for i, p in enumerate(prompts[:8]):
            sch.submit(p, 8, seed=2 + i)
        sch.step()
        prof = profile_window(lambda: [sch.step() for _ in range(3)])
        out[name].update(profiled_step_ms=prof["wall_ms"] / 3,
                         step_busy_ms=prof["device_busy_ms"] / 3,
                         kernels_per_step=prof["kernels"] / 3,
                         host_top=prof["host_top"])
    # the unfused paged plan (K1 linears, K7 rows): the paged phase's side
    # run, 4 requests of 32 new tokens, then three steps of 8 busy slots
    prompts = paged_requests(eng.cfg.vocab_size)
    usch = eng.scheduler(slots=8, cache_len=256, paged=True, page_len=8,
                         decode_kernel="unfused")
    drive(usch, prompts[:2], 4)  # warm-up
    runs = []
    for _ in range(AB_SERVES):
        usch.reset()
        outs, wall_s = drive(usch, prompts[:4], 32)
        st = usch.stats
        runs.append((st.decoded_tokens / wall_s,
                     1e3 * st.decode_s / st.decode_steps))
    usch.reset()
    for i, p in enumerate(prompts[:8]):
        usch.submit(p, 8, seed=2 + i)
    usch.step()
    prof = profile_window(lambda: [usch.step() for _ in range(3)])
    out["unfused_paged"] = dict(
        tokens_per_s=[r[0] for r in runs], decode_step_ms=[r[1] for r in runs],
        tokens=digest(outs), profiled_step_ms=prof["wall_ms"] / 3,
        step_busy_ms=prof["device_busy_ms"] / 3,
        kernels_per_step=prof["kernels"] / 3)
    del usch
    key = prng.PRNGKey(42, dev)
    for name, batch in PAPER:
        e = XpikeformerEngine.from_config(name, backend="cuda", device=dev)
        e.init(seed=0)
        x, _ = paper_inputs(e.task, e.cfg, batch, dev)
        logits = e.forward(x, key)  # warm-up
        prof = profile_window(lambda: e.forward(x, key))
        out[name] = dict(forward_ms=wall_ms(lambda: e.forward(x, key), 5),
                         profiled_wall_ms=prof["wall_ms"],
                         device_busy_ms=prof["device_busy_ms"],
                         idle_share=prof["idle_share"],
                         kernels=prof["kernels"], logits=digest(logits))
    # whole-tree drift folds: the LM stack's 6 leaves and the ViT's 26,
    # programmed from a seed (host wall to synchronize, median of 9; the
    # images' digest); then phase 6's programmed paged serve under the
    # drift policy (tokens, clock, folds, GDC runs, gains and energy)
    for name, task in ((ARCH, "lm"), (PAPER[0][0], None)):
        e = XpikeformerEngine.from_config(name, backend="cuda", device=dev,
                                          **({"task": task} if task else {}))
        e.init(seed=0)
        e.program(prng.PRNGKey(42))
        tree = e.params
        folded = AD.drift_tree(tree, 7200.0, e.aimc_cfg)  # warm-up
        out[f"fold_{e.task}"] = dict(
            leaves=len(AD.device_states(tree)),
            fold_ms=wall_ms(lambda: AD.drift_tree(tree, 7200.0, e.aimc_cfg),
                            9),
            images=digest(torch.cat([s.levels_t.flatten().float() for s in
                                     AD.device_states(folded)])))
        if e.task == "lm":
            sch = e.scheduler(slots=8, cache_len=256, paged=True, page_len=8,
                              drift=AD.DriftPolicy(
                                  seconds_per_step=DRIFT_STEP_S,
                                  recal_interval_s=RECAL_EVERY_S))
            outs, wall_s = drive(sch, paged_requests(e.cfg.vocab_size), 32)
            st = sch.stats
            out["programmed_paged"] = dict(
                tokens_per_s=st.decoded_tokens / wall_s,
                decode_step_ms=1e3 * st.decode_s / st.decode_steps,
                lifecycle=digest([outs, st.t_device_s, st.image_folds,
                                  st.recalibrations, st.energy_j,
                                  AD.gdc_gain_summary(sch.source_params)]))
    return out


def phase_ab(parent_src: str) -> dict:
    """:func:`phase_windows` on the tree at ``parent_src`` and on this one,
    each in a process of its own, in turns: parent, change, change,
    parent.  Both trees must serve the same tokens and give the same
    logits."""
    runs = []
    for label, src in (("parent", parent_src), ("change", ROOT / "src"),
                       ("change", ROOT / "src"), ("parent", parent_src)):
        r = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--windows", str(Path(src).resolve())],
                           capture_output=True, text=True, timeout=1200)
        check(r.returncode == 0,
              f"windows of {src} failed:\n{r.stdout[-2000:]}{r.stderr[-4000:]}")
        runs.append({"label": label, **json.loads(r.stdout.splitlines()[-1])})
    for k in ("dense", "paged", "unfused_paged"):
        check(len({r[k]["tokens"] for r in runs}) == 1,
              f"A/B: the trees' {k} tokens differ")
    for k in ("fold_lm", "fold_vit"):
        check(len({r[k]["images"] for r in runs}) == 1,
              f"A/B: the trees' {k} images differ")
    check(len({r["programmed_paged"]["lifecycle"] for r in runs}) == 1,
          "A/B: the trees' programmed paged serves differ (tokens, clock, "
          "folds, GDC runs, gains or energy)")
    for k in ("k3", "k9"):
        check(len({r[k]["out"] for r in runs}) == 1,
              f"A/B: the trees' {k.upper()} outputs differ")
    for name, _ in PAPER:
        check(len({r[name]["logits"] for r in runs}) == 1,
              f"A/B: the trees' {name} logits differ")
    return {"phase": "ab", "card": card_line(), "parent": str(parent_src),
            "runs": runs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ab", metavar="SRC", help="instead of the smoke run, "
                    "A/B the windows of the port's tree at SRC (its src "
                    "directory) against this one, in turns on one card")
    ap.add_argument("--windows", metavar="SRC",
                    help="only the A/B windows of the tree at SRC")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(a.windows) if a.windows else ROOT / "src"))
    from repro_torch.kernels import build as KB

    torch.backends.cuda.matmul.allow_tf32 = False  # the unembed stays f32
    torch.backends.cudnn.allow_tf32 = False
    if a.ab:
        emit(phase_ab(a.ab))
        return 0
    if a.windows:
        build_s = KB.build()
        emit({"build_s": build_s, **phase_windows(torch.device("cuda", 0))})
        return 0

    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)

    build_s = KB.build()
    ptxas = {n: [ln.strip() for ln in log.splitlines() if "Used" in ln]
             for n, log in KB.BUILD_LOG.items()}
    emit({"phase": "build", "card": card, "build_s": build_s,
          "sources": list(KB.SOURCES), "ptxas": ptxas})

    t0 = time.perf_counter()
    kres = phase_kernels(dev)
    emit({"phase": "kernels", "card": card, "exact": True,
          "seconds": time.perf_counter() - t0,
          "profiler_sessions": dict(PROFILER_SESSIONS),
          **{k: summary(v) if "bound" in v else v for k, v in kres.items()}})

    t0 = time.perf_counter()
    eng, launches, served, outs = phase_serve(dev)
    emit({"phase": "serve", "card": card, "arch": ARCH, "slots": 8,
          "cache_len": 256, "requests": len(outs),
          "seconds": time.perf_counter() - t0, **served,
          "launches": launches, "first_tokens": outs[0][:8]})

    t0 = time.perf_counter()
    plaunches, ulaunches, pserved, pouts = phase_paged(dev, eng)
    emit({"phase": "paged_serve", "card": card, "arch": ARCH, "slots": 8,
          "cache_len": 256, "page_len": 8, "requests": len(pouts),
          "seconds": time.perf_counter() - t0, **pserved,
          "launches": plaunches, "unfused_launches": ulaunches,
          "first_tokens": pouts[0][:8]})

    t0 = time.perf_counter()
    fd = phase_front_door(eng, (outs, served, dict(launches)),
                          (pouts, pserved, dict(plaunches)))
    emit({"phase": "front_door", "card": card, "arch": ARCH, "slots": 8,
          "cache_len": 256, "page_len": 8,
          "seconds": time.perf_counter() - t0, **fd})

    t0 = time.perf_counter()
    lm, mesh_ref = phase_lm_forward(dev)
    emit({"phase": "lm_forward", "card": card,
          "seconds": time.perf_counter() - t0, **lm})
    t0 = time.perf_counter()
    paper, flaunches = phase_paper(dev)
    emit({"phase": "paper_forward", "card": card,
          "seconds": time.perf_counter() - t0, **paper})
    t0 = time.perf_counter()
    drift, dlaunches, douts = phase_drift(dev)
    emit({"phase": "drift", "card": card,
          "seconds": time.perf_counter() - t0, **drift})
    t0 = time.perf_counter()
    train = phase_train(dev)
    emit({"phase": "train", "card": card,
          "seconds": time.perf_counter() - t0, **train})
    with tempfile.TemporaryDirectory(prefix="xpk_train_launch_") as root:
        tl, tlaunches, launched = phase_train_launch(dev, Path(root))
        emit({"phase": "train_launch", "card": card, **tl})
        t0 = time.perf_counter()
        flm = phase_float_lm(dev)
        emit({"phase": "float_lm", "card": card,
              "seconds": time.perf_counter() - t0, **flm})
        moe, moe_launches, spiking_moe = phase_moe(dev)
        emit({"phase": "moe", "card": card, **moe})
        t0 = time.perf_counter()
        mesh, mlaunches = phase_mesh(dev, outs, pouts, mesh_ref, launched,
                                     spiking_moe, served)
        emit({"phase": "mesh", "card": card,
              "seconds": time.perf_counter() - t0, **mesh})
    # each kernel's launches on its own path
    launches["aimc_matmul_counts"] = mlaunches["aimc_matmul_counts"]
    launches["drift_requantize"] = dlaunches["drift_requantize"]
    launches["fused_decode_layer_paged"] = plaunches["fused_decode_layer_paged"]
    launches["ssa_decode_paged"] = ulaunches["ssa_decode_paged"]
    launches["ssa_attention"] = flaunches[PAPER[0][0]]["ssa_attention_keyed"]
    launches["lif"] = mlaunches["lif"]  # the row-parallel linears' LIF

    meta = {
        "aimc_spiking_linear": ("src/repro_torch/kernels/csrc/aimc_matmul.cu",
                                "src/repro/kernels/aimc_matmul.py:205"),
        "ssa_decode": ("src/repro_torch/kernels/csrc/ssa_attention.cu",
                       "src/repro/kernels/ssa_attention.py:120"),
        "fused_decode_layer": ("src/repro_torch/kernels/csrc/decode_fused.cu",
                               "src/repro/kernels/decode_fused.py:283"),
        "ssa_decode_paged": ("src/repro_torch/kernels/csrc/ssa_attention.cu",
                             "src/repro/kernels/ssa_attention.py:214"),
        "fused_decode_layer_paged": (
            "src/repro_torch/kernels/csrc/decode_fused.cu",
            "src/repro/kernels/decode_fused.py:491"),
        "ssa_attention": ("src/repro_torch/kernels/csrc/ssa_attention.cu",
                          "src/repro/kernels/ssa_attention.py:237"),
        "lif": ("src/repro_torch/kernels/csrc/lif.cu",
                "src/repro/kernels/lif.py:54"),
        "drift_requantize": ("src/repro_torch/kernels/csrc/drift_requantize.cu",
                             "src/repro/kernels/aimc_matmul.py:172"),
        "aimc_matmul_counts": ("src/repro_torch/kernels/csrc/aimc_matmul.cu",
                               "src/repro/kernels/aimc_matmul.py:123"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        r = kres[name]
        bound_ms, bound_by, n_bytes, n_ops = r["bound"]
        check(launches[name] > 0, f"{name} never ran on the main path")
        check(r["max_abs_err"] == 0.0, f"{name} differs from its plain version")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "launches_train_launch": tlaunches.get(name, 0),
            "launches_moe": moe_launches.get(
                "ssa_attention_keyed" if name == "ssa_attention" else name, 0),
            "exact": r["max_abs_err"] == 0.0,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_bytes": n_bytes, "bound_ops": n_ops,
            "library_ms": r.get("library_ms"), "shape": r["shape"],
            **{k: r[k] for k in ("pos", "entry", "design", "draws",
                                 "int32_issue_ms", "sass", "resources",
                                 "device_ms",
                                 "device_ms_l2_warm", "plan_cluster",
                                 "plan_blocks", "cluster", "clusters",
                                 "blocks", "sms_used",
                                 "most_blocks_on_one_sm", "wrapper_host_us",
                                 "bare_launch_host_us")
               if k in r}})
    check(all(math.isfinite(k["ms"]) for k in kernels), "a time is not finite")
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    # the ranks' spawns started multiprocessing's resource tracker, which
    # would outlive this process by a moment: stop it before exiting
    from multiprocessing import resource_tracker
    resource_tracker._resource_tracker._stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
