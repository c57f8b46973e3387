"""The port's checkpoints (``repro_torch.checkpoint``) on the CPU.

* The cases of ``tests/test_checkpoint.py`` on the port: a bfloat16 round
  trip, retention, atomicity, elastic restore onto another mesh, a
  programmed and aged ``AIMCDeviceState`` tree decoding bit-exactly after
  restore, a failed background save surfacing in ``wait()``, and the
  resharding plan's keys.
* Both directions across the packages: a checkpoint the reference's
  ``CheckpointManager`` writes restores in the port, and one the port
  writes restores in the reference, leaf for leaf and dtype for dtype
  (reduced-GPT params, AdamW state in float32, bfloat16 and int8, a
  programmed and aged tree), held to ``convert.params_from_numpy`` /
  ``opt_state_from_numpy`` of the reference's own trees.
* The async save's host copy: an in-place update after ``save`` does not
  reach the files.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import aimc_device as JAD
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import registry as JR
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro_torch import aimc_device as AD
from repro_torch import convert, prng
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import leaves, map_with_placement
from repro_torch.configs import registry as R
from repro_torch.launch import elastic
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as A
from repro_torch.serving import BatchScheduler

ARCH = "xpikeformer-gpt-4-256"
CPU = torch.device("cpu")


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 16, generator=g).to(torch.bfloat16),
                       "b": torch.arange(5, dtype=torch.int32)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _assert_same(got, want):
    """Two torch trees equal leaf for leaf, dtype for dtype, in JAX's leaf
    order (and of the same structure)."""
    g, w = leaves(got), leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)



@pytest.fixture(autouse=True)
def one_thread():
    """Torch's CPU ops on one thread: these steps run many small ops, whose
    thread teams would wait on threads the other test workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def jax_trees():
    """The reference's reduced-GPT params, AdamW states of three dtypes
    after one update (non-zero moments; int8's ``{"q", "scale"}``) and a
    programmed tree an hour old -- and the port's conversions of each."""
    cfg = JR.reduced_config(ARCH)
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.01), params)
    states = {}
    for dt in ("float32", "bfloat16", "int8"):
        opt = JA.AdamWConfig(state_dtype=dt, warmup_steps=1)
        _, st, _ = jax.jit(JA.apply_updates, static_argnums=3)(
            params, grads, JA.init_opt_state(params, opt), opt)
        states[dt] = st
    acfg = JAD.AIMCConfig()
    dev = JAD.drift_tree(JAD.program_lm_tree(jax.random.PRNGKey(1), params,
                                             acfg), 3600.0, cfg=acfg)
    host = jax.tree.map(np.asarray, (params, states, dev))
    tp = convert.params_from_numpy(host[0], device=CPU)
    ts = {k: convert.opt_state_from_numpy(v, device=CPU)
          for k, v in host[1].items()}
    td = convert.params_from_numpy(host[2], device=CPU)
    return (params, states, dev), (tp, ts, td)


# -- the cases of tests/test_checkpoint.py -----------------------------------


def test_roundtrip_exact(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    state = _state()
    mgr.save(7, state, blocking=True)
    restored, step = mgr.restore(state)
    assert step == 7
    _assert_same(restored, state)  # bfloat16 survives the round trip
    meta = json.loads((tmp_path / "step_00000007" / "manifest.json")
                      .read_text())
    assert [m["dtype"] for m in meta["leaves"]] == ["int32", "bfloat16",
                                                    "int32"]
    assert meta["treedef"] is None


def test_retention_keeps_newest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    state = _state()
    for s in (1, 2, 3, 4):
        mgr.save(s, state, blocking=True)
    assert sorted(mgr.steps()) == [3, 4]
    assert mgr.latest_step() == 4


def test_atomicity_ignores_partial(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    state = _state()
    mgr.save(5, state, blocking=True)
    # a crashed write: a tmp dir, and a final dir without a manifest
    (tmp_path / ".tmp_step_00000009").mkdir()
    broken = tmp_path / "step_00000010"
    broken.mkdir()
    (broken / "leaf_00000.npy").write_bytes(b"garbage")
    assert mgr.latest_step() == 5
    _, step = mgr.restore(state)
    assert step == 5


def test_elastic_restore_new_mesh(tmp_path):
    """A training state saved on one device restores on a rank of a
    ``(2, 1)`` data-parallel mesh as that rank's ZeRO-3 cut (each
    ``embed`` axis's block over ``data``, int8 moments' row scales
    included); a programmed tree restores on a
    rank of a ``(2, 2)`` serving mesh as that rank's model cut, equal
    to ``convert.shard_params``'s, every rank."""
    cfg = R.reduced_config(ARCH)
    opt = A.AdamWConfig(state_dtype="int8")
    params = T.init_params(cfg, 0, CPU)
    state = A.init_opt_state(params, opt)
    mgr = CheckpointManager(tmp_path / "train", keep=1)
    mgr.save(3, (params, state), blocking=True)
    placement = elastic.state_shardings(cfg, (2, 1), opt, device=CPU, rank=1)
    restored, step = mgr.restore((params, state), placement=placement)
    assert step == 3
    _assert_same(restored, map_with_placement(
        lambda x, where, field: x if where.whole else where.piece(x, field),
        (params, state), placement))
    assert leaves(restored)[0].shape == (cfg.vocab_size, cfg.d_model // 2)

    acfg = AD.AIMCConfig()
    dev = AD.drift_tree(AD.program_lm_tree(prng.PRNGKey(1), params, acfg),
                        3600.0, acfg)
    mgr = CheckpointManager(tmp_path / "serve", keep=1)
    mgr.save(4, dev, blocking=True)
    for rank in range(4):
        pl, opt_pl = elastic.state_shardings(cfg, (2, 2), opt, device=CPU,
                                             rank=rank, serving=True)
        assert opt_pl is None  # a serving rank holds no optimizer state
        got, _ = mgr.restore(dev, placement=pl)
        want = convert.shard_params(T.quantize_params(dev, cfg,
                                                      keep_state=True),
                                    cfg, 2, rank % 2)
        _assert_same(got, want)
    # a float tree on the serving mesh: held whole (cut after quantising)
    pl, _ = elastic.state_shardings(cfg, (2, 2), opt, device=CPU, rank=1,
                                    serving=True)
    got, _ = CheckpointManager(tmp_path / "train").restore(
        (params, state), placement=(pl, None))
    _assert_same(got[0], params)
    assert leaves(got[1]) == []  # the optimizer state: not read
    assert set(got[1]) == {"m", "v", "step"}


def test_aimc_device_state_roundtrip_decode_exact(tmp_path):
    """A programmed, aged device tree survives save -> restore leaf for
    leaf and decodes bit-exactly on the integer backend."""
    cfg = R.reduced_config(ARCH)
    acfg = AD.AIMCConfig()
    params = T.init_params(cfg, 0, CPU)
    dev = AD.drift_tree(AD.program_lm_tree(prng.PRNGKey(1), params, acfg),
                        3600.0, acfg)
    assert AD.has_device_state(dev)
    mgr = CheckpointManager(tmp_path, keep=1)
    mgr.save(11, dev, blocking=True)
    manifest = json.loads((tmp_path / "step_00000011" / "manifest.json")
                          .read_text())
    assert manifest["treedef"] is None
    restored, step = mgr.restore(dev)
    assert step == 11
    _assert_same(restored, dev)

    def decode(p):
        sch = BatchScheduler(p, cfg, "integer", device="cpu", slots=1,
                             cache_len=16)
        r = sch.submit([3, 4, 5, 6], 4, seed=5)
        return sch.run()[r]

    assert decode(restored) == decode(dev)


def test_save_thread_errors_surface_in_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(tmp_path, keep=1)

    def boom(step, host_state):
        raise OSError("disk on fire")

    monkeypatch.setattr(mgr, "_write", boom)
    mgr.save(1, {"w": torch.zeros(3)})
    with pytest.raises(OSError, match="disk on fire"):
        mgr.wait()
    # the error is consumed: the manager stays usable for the next save
    monkeypatch.undo()
    mgr.save(2, {"w": torch.zeros(3)}, blocking=True)
    assert mgr.latest_step() == 2


def test_resharding_plan_reports():
    cfg = R.reduced_config(ARCH)
    plan = elastic.resharding_plan(cfg, (1, 1), (2, 1))
    assert plan["old_mesh"] == {"data": 1, "model": 1}
    assert plan["new_mesh"] == {"data": 2, "model": 1}
    # data-parallel: ZeRO-3 cuts every leaf's ``embed`` axis over data
    # (the table, the final norm and the unembedding, and each block's six
    # linears and two norms)
    assert plan["n_params_relaid"] == 3 + 8 * cfg.period
    specs = {c["param"]: c["new"] for c in plan["changes"]}
    assert specs["['embed']['table']"] == "(None, 'data')"
    assert specs["['periods']['blk0']['mixer']['wo']"] == \
        "(None, None, None, 'data')"
    plan = elastic.resharding_plan(cfg, (1, 1), (2, 2), serving=True)
    # every spiking linear of every block: Q/K/V and MLP in by columns,
    # attention and MLP out by rows
    assert plan["n_params_relaid"] == 6 * cfg.period
    specs = {c["param"].split("[")[-1]: c["new"] for c in plan["changes"]}
    assert specs == {"'wq']": "col/2", "'wk']": "col/2", "'wv']": "col/2",
                     "'wi']": "col/2", "'wo']": "row/2"}
    # a training mesh with a model axis: the heads and d_ff cut
    plan = elastic.resharding_plan(cfg, (1, 1), (1, 2))
    assert plan["n_params_relaid"] == 6 * cfg.period
    specs = {c["param"].split("[")[-2] + c["param"].split("[")[-1]: c["new"]
             for c in plan["changes"]}
    assert specs == {"'mixer']'wq']": "(None, None, 'model')",
                     "'mixer']'wk']": "(None, None, 'model')",
                     "'mixer']'wv']": "(None, None, 'model')",
                     "'mixer']'wo']": "(None, 'model')",
                     "'mlp']'wi']": "(None, None, 'model')",
                     "'mlp']'wo']": "(None, 'model')"}


# -- across the packages ------------------------------------------------------


def test_jax_checkpoint_restores_in_the_port(tmp_path, jax_trees):
    """The reference's manager writes params, three AdamW states and a
    programmed tree; the port restores each into its own tree, equal to
    the reference's trees converted, leaf for leaf and dtype for dtype."""
    (jp, js, jd), (tp, ts, td) = jax_trees
    jm = JManager(tmp_path, keep=5)
    for i, dt in enumerate(("float32", "bfloat16", "int8")):
        jm.save(i + 1, (jp, js[dt]), blocking=True)
    jm.save(9, jd, blocking=True)
    mgr = CheckpointManager(tmp_path)
    for i, dt in enumerate(("float32", "bfloat16", "int8")):
        like = (T.init_params(R.reduced_config(ARCH), 1, CPU),
                A.init_opt_state(T.init_params(R.reduced_config(ARCH), 1,
                                               CPU),
                                 A.AdamWConfig(state_dtype=dt)))
        got, step = mgr.restore(like, step=i + 1)
        assert step == i + 1
        _assert_same(got, (tp, ts[dt]))
    got, _ = mgr.restore(td, step=9)
    _assert_same(got, td)


def test_port_checkpoint_restores_in_jax(tmp_path, jax_trees):
    """The port writes the same trees; the reference's manager restores
    them into its own, equal to the originals leaf for leaf and dtype for
    dtype (bfloat16 moments through ``ml_dtypes``, int8 ``q``)."""
    (jp, js, jd), (tp, ts, td) = jax_trees
    mgr = CheckpointManager(tmp_path, keep=5)
    for i, dt in enumerate(("float32", "bfloat16", "int8")):
        mgr.save(i + 1, (tp, ts[dt]), blocking=True)
    mgr.save(9, td, blocking=True)
    jm = JManager(tmp_path)
    for i, dt in enumerate(("float32", "bfloat16", "int8")):
        got, step = jm.restore((jp, js[dt]), step=i + 1)
        assert step == i + 1
        want_l, got_l = jax.tree.leaves((jp, js[dt])), jax.tree.leaves(got)
        assert len(got_l) == len(want_l)
        for a, b in zip(got_l, want_l):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    got, _ = jm.restore(jd, step=9)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jd)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert isinstance(jax.tree.leaves(got, is_leaf=lambda x: isinstance(
        x, JAD.AIMCDeviceState))[2], JAD.AIMCDeviceState)


def test_async_save_snapshots_the_state(tmp_path):
    """``save`` returns before the files are written; an in-place update
    of the state after it (on the CPU, where ``.cpu()`` is the tensor
    itself) does not reach the checkpoint."""
    mgr = CheckpointManager(tmp_path, keep=1)
    state = {"w": torch.arange(1 << 16, dtype=torch.float32)}
    want = state["w"].clone()
    mgr.save(1, state)
    state["w"].add_(1.0)
    mgr.wait()
    got, _ = mgr.restore(state)
    assert torch.equal(got["w"], want)
