"""Xpikeformer on PyTorch and CUDA: the ported slices of the JAX package.

A second package beside ``repro``: the paper's spiking ViT and GPT forward
(``SPIKING_ARCHS``, SSA mode, ideal or programmed-PCM weights), the dense
and block-paged continuous-batching decode of the spiking GPT on the
generic LM stack, the programmed-PCM lifecycle (program, drift, GDC;
:mod:`repro_torch.aimc_device`) and energy metering
(:mod:`repro_torch.energy`), with the kernels those paths run written by
hand for Hopper (``sm_90a``) under ``repro_torch/kernels/csrc``.  Module names mirror
``repro`` so each counterpart is easy to find; nothing here imports JAX or
``repro``.

Bit-exactness is the contract: spike trains are integer data, and a
request's tokens are a pure function of ``(params, prompt, seed)``.  The
spike randomness therefore comes from :mod:`repro_torch.prng`, a twin of
the threefry2x32 streams JAX draws, not from ``torch.Generator``.

Entry points (:class:`repro_torch.engine.XpikeformerEngine`,
:class:`repro_torch.serving.BatchScheduler`, ``python -m
repro_torch.launch.serve``) run on ``device="cuda"`` unless the caller
passes ``device="cpu"``, where every kernel wrapper takes its plain
PyTorch version.
"""
