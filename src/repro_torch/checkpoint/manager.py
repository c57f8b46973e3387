"""Fault-tolerant checkpointing: atomic, async, retention, elastic restore.

Twin of ``repro.checkpoint.manager``, writing the same files, so a
checkpoint written by either package restores in the other::

    <dir>/step_<k:08d>/          written as .tmp_step_<k:08d>, then renamed
        manifest.json            {"step", "treedef": null, "leaves":
                                  [{"shape", "dtype"}, ...]}
        leaf_00000.npy ...       one file per leaf, in JAX's leaf order
    <dir>/LATEST                 the newest committed step

* **Leaf order** is ``jax.tree.flatten``'s (:func:`leaves`): dict keys
  sorted, lists and tuples in order, an :class:`~repro_torch.aimc_device.
  AIMCDeviceState` by its fields (the order of the reference node's
  children), ``None`` no leaf.  The port's own trees keep insertion order
  (:mod:`repro_torch.tree`); the file order does not depend on it.
* **Dtypes** -- native ones as ``np.save`` writes them; a bfloat16 leaf as
  the reference's manager writes it without a numpy dtype of its own: its
  raw bytes as ``uint8``, ``"bfloat16"`` in the manifest, read back through
  an ``int16`` view.  int8 moments ``{"q", "scale"}`` and the int32
  ``step`` keep their dtypes.
* **Atomicity** -- the rename is the commit point, ``LATEST`` is written
  after it; a directory without a manifest is never restored.
* **Async** -- :meth:`CheckpointManager.save` copies every leaf to the
  host (a real copy also of a CPU tensor, so an in-place update after the
  call cannot reach the files) and writes them in a thread;
  :meth:`~CheckpointManager.wait` joins it and re-raises what it hit.
* **Retention** -- the newest ``keep`` checkpoints stay; older ones go
  only after a commit, never the one just written.
* **Elastic restore** -- leaves are saved whole; :meth:`~CheckpointManager.
  restore` places each on the device of the matching leaf of
  ``state_like``, or as an explicit ``placement`` says (a rank's piece:
  :mod:`repro_torch.parallel.sharding`, :mod:`repro_torch.launch.elastic`).
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import threading
from pathlib import Path
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.aimc_device import AIMCDeviceState

Tensor = torch.Tensor

_NATIVE = {torch.float32: "float32", torch.float64: "float64",
           torch.float16: "float16", torch.int8: "int8", torch.uint8: "uint8",
           torch.int16: "int16", torch.int32: "int32", torch.int64: "int64",
           torch.bool: "bool"}


# ---------------------------------------------------------------------------
# Trees in JAX's leaf order
# ---------------------------------------------------------------------------


def _children(node) -> Optional[List[Tuple[Any, Any]]]:
    """``(name, child)`` pairs of an inner node in JAX's order, or ``None``
    for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    if isinstance(node, AIMCDeviceState):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return None


def _rebuild(node, named: List[Tuple[Any, Any]]):
    """``node``'s kind of container around the ``(name, child)`` pairs of
    :func:`_children` (a dict keeps its own key order)."""
    if isinstance(node, dict):
        got = dict(named)
        return {k: got[k] for k in node}
    children = [c for _, c in named]
    if isinstance(node, AIMCDeviceState):
        return AIMCDeviceState(*children)
    return tuple(children) if isinstance(node, tuple) else children


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree.flatten``'s order."""
    out: List[Any] = []

    def walk(t):
        if t is None:
            return
        kids = _children(t)
        if kids is None:
            out.append(t)
        else:
            for _, c in kids:
                walk(c)

    walk(tree)
    return out


def map_with_placement(fn: Callable[[Any, Any, Optional[str]], Any], tree,
                       placement=None):
    """``tree`` rebuilt with ``fn(leaf, where, field)`` at each leaf.
    ``placement`` is a prefix of ``tree``: where it holds a non-tree value
    (a :class:`repro_torch.parallel.sharding.Placement`, or ``None``) that
    value is ``where`` for every leaf below it, and ``field`` is the name
    of the leaf's place in the subtree it covers (a dict key or a device
    state's field; ``None`` for the subtree's root)."""

    def walk(t, p, field):
        if t is None:
            return None
        kids = _children(t)
        if kids is None:
            return fn(t, p, field)
        ps = _children(p) if p is not None else None
        if ps is None:  # p covers this whole subtree
            return _rebuild(t, [(name, walk(c, p, name)) for name, c in kids])
        pk = dict(ps)
        return _rebuild(t, [(name, walk(c, pk[name], field))
                            for name, c in kids])

    return walk(tree, placement, None)


# ---------------------------------------------------------------------------
# Leaves on disk
# ---------------------------------------------------------------------------


def _host_copy(x) -> Tensor:
    """A host copy of a leaf that no later in-place update can reach."""
    if isinstance(x, Tensor):
        return x.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(x, copy=True))


def _dtype_name(x: Tensor) -> str:
    if x.dtype == torch.bfloat16:
        return "bfloat16"
    if x.dtype not in _NATIVE:
        raise TypeError(f"no checkpoint format for a {x.dtype} leaf")
    return _NATIVE[x.dtype]


def _save_leaf(path: Path, x: Tensor) -> None:
    x = x.contiguous()
    if x.dtype == torch.bfloat16:  # raw bytes; the dtype lives in the manifest
        arr = x.reshape(-1).view(torch.int16).numpy().view(np.uint8)
    else:
        arr = x.numpy()
    np.save(path, arr, allow_pickle=False)


def _load_leaf(path: Path, shape, dtype_name: str) -> np.ndarray:
    """The leaf as numpy, memory-mapped (a piece reads only its bytes);
    a bfloat16 leaf as its ``int16`` bit patterns."""
    raw = np.load(path, mmap_mode="r", allow_pickle=False)
    if dtype_name == "bfloat16":
        return raw.view(np.int16).reshape(shape)
    if str(raw.dtype) != dtype_name:
        raise ValueError(f"{path}: {raw.dtype} on disk, {dtype_name} in the "
                         "manifest")
    return raw.reshape(shape)


def _to_tensor(arr: np.ndarray, dtype_name: str, device) -> Tensor:
    t = torch.from_numpy(np.array(arr, copy=True))  # keeps a 0-d leaf 0-d
    if dtype_name == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


# ---------------------------------------------------------------------------
# The manager
# ---------------------------------------------------------------------------


class CheckpointManager:
    """Save and restore trees of tensors under ``directory`` (see the
    module); ``keep`` newest checkpoints are retained."""

    def __init__(self, directory, *, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, state, *, blocking: bool = False) -> None:
        """Snapshot ``state`` on the host now and write it as ``step`` in
        a background thread (joined first if one is still writing; with
        ``blocking`` joined again before returning)."""
        host = [_host_copy(x) for x in leaves(state)]
        self.wait()
        t = threading.Thread(target=self._guarded_write, args=(step, host),
                             daemon=True)
        t.start()
        self._thread = t
        if blocking:
            self.wait()

    def wait(self) -> None:
        """Join the in-flight save; re-raises any exception it hit (a
        silently dropped checkpoint is worse than a crashed train loop)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _guarded_write(self, step: int, host: List[Tensor]) -> None:
        try:
            self._write(step, host)
        except BaseException as e:  # surfaced by the next wait()/save()
            self._error = e

    def _write(self, step: int, host: List[Tensor]) -> None:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f".tmp_step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "treedef": None, "leaves": []}
        for i, x in enumerate(host):
            _save_leaf(tmp / f"leaf_{i:05d}.npy", x)
            manifest["leaves"].append({"shape": list(x.shape),
                                       "dtype": _dtype_name(x)})
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # commit point
        (self.dir / "LATEST").write_text(str(step))
        self._gc(step)

    def _gc(self, newest: int) -> None:
        steps = sorted(self.steps())
        for s in steps[: max(len(steps) - self.keep, 0)]:
            if s != newest:
                shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ---------------------------------------------------------- restore
    def steps(self) -> List[int]:
        """The committed steps (directories with a manifest)."""
        return [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                if (p / "manifest.json").exists()]

    def latest_step(self) -> Optional[int]:
        marker = self.dir / "LATEST"
        if marker.exists():
            s = int(marker.read_text().strip())
            if (self.dir / f"step_{s:08d}" / "manifest.json").exists():
                return s
        steps = self.steps()
        return max(steps) if steps else None

    def restore(self, state_like, *, step: Optional[int] = None,
                placement=None):
        """``(state, step)``: the checkpoint ``step`` (the latest when
        ``None``) in the structure of ``state_like``, whose leaves give the
        shapes (checked against the manifest) and, without a
        ``placement``, each leaf's device.

        ``placement`` (:func:`repro_torch.launch.elastic.state_shardings`)
        is a prefix tree of ``state_like`` holding
        :class:`repro_torch.parallel.sharding.Placement` values: each leaf
        below one is read as that placement's piece of it, onto its
        device.  A ``None`` there marks a subtree this rank does not hold:
        its leaves are not read and come back as ``None``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        src = self.dir / f"step_{step:08d}"
        manifest = json.loads((src / "manifest.json").read_text())
        metas = manifest["leaves"]
        n_like = len(leaves(state_like))
        if n_like != len(metas):
            raise ValueError(f"{src}: {len(metas)} leaves on disk, "
                             f"{n_like} in the state to restore into")
        index = iter(range(len(metas)))

        def load(like, where, field):
            i = next(index)
            meta = metas[i]
            shape = tuple(meta["shape"])
            if tuple(like.shape) != shape:
                raise ValueError(f"{src}: leaf {i} is {shape} on disk, "
                                 f"{tuple(like.shape)} in the state")
            if placement is not None and where is None:
                return None  # not held by this rank
            arr = _load_leaf(src / f"leaf_{i:05d}.npy", shape, meta["dtype"])
            if where is None:
                device = like.device if isinstance(like, Tensor) else "cpu"
            else:
                arr, device = where.piece(arr, field), where.device
            return _to_tensor(arr, meta["dtype"], device)

        return map_with_placement(load, state_like, placement), step
