"""The port's train launcher (``repro_torch.launch.train``) on the CPU.

* Crash and restart: a run killed by ``fail_at`` and rerun restores the
  last checkpoint, seeks the stream, and gives the uninterrupted run's
  losses bit for bit.
* Against the reference: the port's ``run`` and JAX's ``LT.run``, each
  resumed from the same checkpoint written by the JAX package, agree on
  every loss of 3 steps within 1e-4 (the bound of
  ``tests/test_fault_tolerance.py``).
* Data-parallel and elastic: a ``(2, 1)`` gloo mesh (one spawn) resumes a
  one-device checkpoint; its 2 steps are within 1e-5 of one device's, the
  ranks agree, and the checkpoint it writes restores on one device.
* A model axis raises; so does the launcher without a card unless the
  caller asks for the CPU; the CLI with ``--fail-at`` and its rerun; the
  straggler watchdog under a scripted clock.
"""

import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import registry as JR
from repro.configs.base import ParallelConfig as JParallel
from repro.launch import train as JLT
from repro.optim import adamw as JA
from repro.train import loop as JTL
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import leaves
from repro_torch.configs import ParallelConfig
from repro_torch.configs import registry as R
from repro_torch.data.pipeline import MarkovStream
from repro_torch.launch import train as LT
from repro_torch.launch.mesh import ServingMesh
from repro_torch.optim import adamw as A
from repro_torch.train import loop as TL

ARCH = "xpikeformer-gpt-4-256"
RUN = dict(batch=4, seq_len=16, seed=3, log_every=0, lr=1e-3)
LOSS_ATOL_JAX = 1e-4  # tests/test_fault_tolerance.py's bound
LOSS_ATOL_MESH = 1e-5  # the same step, its sums over ranks in another order



@pytest.fixture(autouse=True)
def one_thread():
    """Torch's CPU ops on one thread: these steps run many small ops, whose
    thread teams would wait on threads the other test workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_STREAMS = {}


@pytest.fixture(autouse=True)
def shared_streams(monkeypatch):
    """The launcher's runs in this process share one ``MarkovStream`` per
    ``DataConfig``: a stream is a pure function of its config (``batch_at``
    holds no state), and making one draws its ``257**3`` transition table
    through the threefry twin, seconds on one CPU thread."""
    def stream(cfg, device=None):
        key = (cfg, str(device))
        if key not in _STREAMS:
            _STREAMS[key] = MarkovStream(cfg, device=device)
        return _STREAMS[key]

    monkeypatch.setattr(LT, "MarkovStream", stream)

@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """Six steps on one device, checkpoints at 2, 4 and 6 (2 kept)."""
    d = tmp_path_factory.mktemp("ref")
    report = {}
    losses = LT.run(ARCH, steps=6, ckpt_dir=str(d), ckpt_every=2,
                    device="cpu", report=report, **RUN)
    assert report["start_step"] == 0 and len(losses) == 6
    return d, losses


def test_crash_restart_replays_exactly(tmp_path, uninterrupted):
    _, want = uninterrupted
    d = tmp_path / "b"
    with pytest.raises(RuntimeError, match="injected failure at step 5"):
        LT.run(ARCH, steps=6, ckpt_dir=str(d), ckpt_every=2, fail_at=5,
               device="cpu", **RUN)
    assert CheckpointManager(d).latest_step() == 4
    report = {}
    got = LT.run(ARCH, steps=6, ckpt_dir=str(d), ckpt_every=2,
                 device="cpu", report=report, **RUN)
    assert report["start_step"] == 4
    assert got == want[4:]  # bit for bit


def test_resume_from_a_jax_checkpoint_tracks_jax(tmp_path):
    """The JAX package's state at step 2 (its init, saved by its manager);
    JAX's launcher and the port's each resume it for 3 steps."""
    cfg = JR.reduced_config(ARCH)
    opt = JA.AdamWConfig(lr=RUN["lr"], warmup_steps=1, total_steps=5)
    state = JTL.init_state(jax.random.PRNGKey(11), cfg, opt,
                           JParallel(remat="none"))
    JManager(tmp_path / "jax", keep=2).save(2, state, blocking=True)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    jl = JLT.run(ARCH, steps=5, ckpt_dir=str(tmp_path / "jax"), ckpt_every=0,
                 **RUN)
    report = {}
    tl = LT.run(ARCH, steps=5, ckpt_dir=str(tmp_path / "port"), ckpt_every=0,
                device="cpu", report=report, **RUN)
    assert report["start_step"] == 2 and len(jl) == len(tl) == 3
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOSS_ATOL_JAX)


def test_data_parallel_elastic_resume(tmp_path, uninterrupted):
    """One device's step-4 checkpoint resumed on a ``(2, 1)`` mesh of gloo
    ranks: steps 4 and 5 within 1e-5 of one device's, both ranks' losses
    equal; the step-6 checkpoint rank 0 writes restores on one device,
    its parameters within the two AdamW steps' reach (each moves a weight
    by about the learning rate) of one device's."""
    ref_dir, want = uninterrupted
    d = tmp_path / "mesh"
    d.mkdir()
    shutil.copytree(ref_dir / "step_00000004", d / "step_00000004")
    (d / "LATEST").write_text("4")
    report = {}
    got = LT.run(ARCH, steps=6, ckpt_dir=str(d), ckpt_every=0,
                 mesh_shape=(2, 1), device="cpu", report=report, **RUN)
    assert report["start_step"] == 4
    assert report["rank_losses"][0] == report["rank_losses"][1] == got
    np.testing.assert_allclose(got, want[4:], rtol=0, atol=LOSS_ATOL_MESH)

    cfg = R.reduced_config(ARCH)
    like = TL.init_state(0, cfg, A.AdamWConfig(), device="cpu")
    mine, step = CheckpointManager(d).restore(like)
    ref, _ = CheckpointManager(ref_dir).restore(like, step=6)
    assert step == 6
    for a, b in zip(leaves(mine[0]), leaves(ref[0])):
        assert a.dtype == b.dtype and a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=2 * 2 * RUN["lr"])


def test_model_axis_raises(tmp_path):
    """A model axis trains (``tests/test_torch_mesh.py``), with
    microbatches and EF-int8 compression of a cut state too
    (``tests/test_torch_mesh_train.py``); what still raises on it, before
    any rank is spawned: a float MoE whose experts it does not divide."""
    cfg = R.reduced_config(ARCH)
    mesh = ServingMesh((2, 2), 0, torch.device("cpu"))
    assert callable(TL.make_train_step(cfg, mesh=mesh))
    assert callable(TL.make_train_step(cfg, ParallelConfig(microbatches=2),
                                       mesh=mesh))
    assert callable(TL.make_train_step(
        cfg, ParallelConfig(grad_compression=True), mesh=mesh))
    assert callable(TL.make_train_step(
        dataclasses.replace(cfg, num_kv_heads=1), mesh=mesh))
    moe = dataclasses.replace(R.reduced_config("phi3.5-moe-42b-a6.6b"),
                              num_experts=3)
    with pytest.raises(ValueError, match="experts do not split"):
        TL.make_train_step(moe, mesh=mesh)


def test_launcher_needs_a_card_unless_asked_for_the_cpu(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mesh in ((1, 1), (2, 1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LT.run(ARCH, steps=1, ckpt_dir=str(tmp_path), mesh_shape=mesh,
                   **RUN)
    assert CheckpointManager(tmp_path).latest_step() is None


def test_cli_fail_at_then_rerun(tmp_path, capsys):
    argv = ["--arch", ARCH, "--steps", "4", "--batch", str(RUN["batch"]),
            "--seq-len", str(RUN["seq_len"]), "--seed", str(RUN["seed"]),
            "--ckpt-every", "2", "--ckpt-dir", str(tmp_path),
            "--device", "cpu"]
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        LT.main(argv + ["--fail-at", "3"])
    LT.main(argv)
    out = capsys.readouterr().out
    assert "[train] restored step 2" in out
    assert "[train] done: final loss" in out
    assert CheckpointManager(tmp_path).latest_step() == 4


def test_straggler_watchdog_on_a_scripted_clock(tmp_path, monkeypatch,
                                                capsys):
    """Each step is timed from its batch until its loss is on the host:
    with step 6 scripted to take 5 s among 1 s steps it is the one
    straggler; the first five steps are never judged.  (With ``probe``
    the run also returns the fixed batch's loss before and after.)"""
    dts = [1.0, 1.0, 9.0, 1.0, 1.0, 1.0, 5.0, 1.0]
    stamps = iter(np.cumsum([x for dt in dts for x in (0.0, dt)]).tolist())
    monkeypatch.setattr(LT, "_now", lambda: next(stamps))
    report = {}
    losses, before, after = LT.run(ARCH, steps=8, ckpt_dir=str(tmp_path),
                                   ckpt_every=0, device="cpu", probe=True,
                                   report=report, **RUN)
    assert len(losses) == 8 and np.isfinite([before, after]).all()
    assert report["step_s"] == dts
    assert report["stragglers"] == 1
    assert "straggler: step 6 took 5.00s (median 1.00s)" in \
        capsys.readouterr().out
