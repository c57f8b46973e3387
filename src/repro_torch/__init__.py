"""Xpikeformer on PyTorch and CUDA: the serving slice of the JAX package.

A second package beside ``repro``: the dense continuous-batching decode of
the spiking GPT (``xpikeformer-gpt-*`` on the generic LM stack), with the
three kernels that path runs written by hand for Hopper (``sm_90a``) under
``repro_torch/kernels/csrc``.  Module names mirror ``repro`` so each
counterpart is easy to find; nothing here imports JAX or ``repro``.

Bit-exactness is the contract: spike trains are integer data, and a
request's tokens are a pure function of ``(params, prompt, seed)``.  The
spike randomness therefore comes from :mod:`repro_torch.prng`, a twin of
the threefry2x32 streams JAX draws, not from ``torch.Generator``.

Entry points (:class:`repro_torch.serving.BatchScheduler`,
:class:`repro_torch.engine.XpikeformerEngine`, ``python -m
repro_torch.launch.serve``) run on ``device="cuda"`` unless the caller
passes ``device="cpu"``, where every kernel wrapper takes its plain
PyTorch version.
"""
