"""Checkpointer with atomic publish and async writes, port of
``repro.checkpoint.checkpointer``.

Layout per step, the reference's on disk:
    <dir>/step_<n>.tmp/            written first
        manifest.json              tree structure, shapes, dtypes, step
        arr_<i>.npy                one file per leaf, in ``jax.tree`` order
    <dir>/step_<n>/                atomic rename after all writes land

Leaves are flattened in ``jax.tree.flatten``'s order
(:mod:`repro_torch.tree`), so a checkpoint the reference wrote restores
onto the port's ``(params, opt_state)`` leaf for leaf, and the other way
round for float32 state.  NumPy has no bfloat16: such a leaf is stored as
its raw bits (an ``int16`` view) with ``"bfloat16"`` in the manifest; the
reference cannot read those.

Guarantees: a crash mid-write never yields a readable checkpoint (readers
only look at renamed dirs); ``save`` copies to host memory at once and
writes on a background thread (``wait()`` joins it); ``restore`` puts each
leaf on the device of the target tree's leaf; the newest ``keep``
checkpoints are retained.  Not applicable: the reference's ``shardings=``
argument of ``restore`` (``jax.device_put`` onto GSPMD shardings).

``history`` records each save (``step``, ``bytes``, ``snapshot_s``: the copy
to host memory, ``write_s``: the files on the background thread) and each
restore (``step``, ``bytes``, ``seconds``).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_unflatten

__all__ = ["Checkpointer"]

_BF16 = "bfloat16"


def _to_host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.to("cpu", copy=True).numpy()
    return np.array(x, copy=True)


def _dtype_name(x, a: np.ndarray) -> str:
    return _BF16 if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16 \
        else str(a.dtype)


def _from_host(a: np.ndarray, dtype: str, target):
    if not isinstance(target, torch.Tensor):
        return a
    t = torch.from_numpy(a)
    if dtype == _BF16:
        t = t.view(torch.bfloat16)
    return t.to(target.device)


class Checkpointer:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.history: list[dict] = []

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, *, blocking: bool = False):
        """Snapshot to host memory synchronously, write to disk async."""
        self.wait()
        t0 = time.perf_counter()
        leaves, treedef = tree_flatten(tree)
        host = [_to_host(x) for x in leaves]       # device->host copy NOW
        dtypes = [_dtype_name(x, a) for x, a in zip(leaves, host)]
        record = {"kind": "save", "step": step, "bytes": sum(a.nbytes for a in host),
                  "snapshot_s": time.perf_counter() - t0}
        self.history.append(record)
        treedef_str = str(treedef)

        def _write():
            t1 = time.perf_counter()
            tmp = self.dir / f"step_{step}.tmp"
            final = self.dir / f"step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {"step": step, "n_leaves": len(host),
                        "treedef": treedef_str,
                        "leaves": [{"shape": list(a.shape), "dtype": dt}
                                   for a, dt in zip(host, dtypes)]}
            for i, a in enumerate(host):
                np.save(tmp / f"arr_{i}.npy", a)
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)                  # atomic publish
            self._gc()
            record["write_s"] = time.perf_counter() - t1

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                      if not p.name.endswith(".tmp"))

    def restore(self, step: int, target_tree: Any) -> Any:
        t0 = time.perf_counter()
        path = self.dir / f"step_{step}"
        manifest = json.loads((path / "manifest.json").read_text())
        arrays = [np.load(path / f"arr_{i}.npy") for i in range(manifest["n_leaves"])]
        targets, treedef = tree_flatten(target_tree)
        if len(targets) != len(arrays):
            raise ValueError(f"checkpoint step {step} holds {len(arrays)} leaves, "
                             f"the target tree {len(targets)}")
        leaves = [_from_host(a, spec["dtype"], x)
                  for a, spec, x in zip(arrays, manifest["leaves"], targets)]
        tree = tree_unflatten(treedef, leaves)
        self.history.append({"kind": "restore", "step": step,
                             "bytes": sum(a.nbytes for a in arrays),
                             "seconds": time.perf_counter() - t0})
        return tree

    def restore_latest(self, target_tree: Any):
        steps = self.steps()
        if not steps:
            return None, None
        s = steps[-1]
        return s, self.restore(s, target_tree)
