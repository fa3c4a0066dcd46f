"""Checkpointing: async save, atomic visibility, keep-last-k, restore onto
the example state's devices.  A port of the JAX package's
``checkpoint/manager.py`` with its on-disk layout:

* ``step_XXXXXXXXXX/leaf_XXXXX.npy``, one file per leaf of the state
  tree in the JAX package's order (dict keys sorted), and ``MANIFEST.json`` with
  ``step``, ``time``, ``n_leaves``, ``treedef``, ``extra`` and per-leaf
  ``shape`` / ``dtype``, the dtype named as numpy names it
  (``"bfloat16"``, not ``"torch.bfloat16"``);
* dtypes numpy cannot save (bfloat16, fp8) are stored as their raw
  bytes (``uint8`` along the last axis) and viewed back on restore;
* **async**: ``save()`` snapshots every leaf to host memory at once
  (later in-place writes or freed device buffers cannot reach the
  snapshot), the file I/O runs on a daemon thread, and ``wait()`` joins
  it and raises the write's error, if any;
* **atomic**: a step is written under ``step_*.tmp`` and becomes
  visible only through the rename to ``step_*``, so a job killed
  mid-save never restores a torn checkpoint; ``keep_last`` steps are
  kept.

``restore(example_state, step=None, device_fn=None)`` puts each leaf on
the device of the matching example leaf (``device_fn(path, example)``
may name another), the one-device form of the reference's
``sharding_fn``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree


def tree_leaves_sorted(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in the JAX package's flattening order: dict
    keys sorted, sequences in order.  A checkpoint's leaf indices do not
    depend on the order a dict was built in (the port's model inits and
    the bridge build the same params in different key orders)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves_sorted(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in tree_leaves_sorted(v, f"{path}[{i}]")]
    return [] if tree is None else [(path, tree)]


def _rebuild(example: Any, leaves: Iterator[Any]) -> Any:
    """``example``'s structure (and dict key order) over ``leaves``, taken
    in :func:`tree_leaves_sorted` order."""
    if isinstance(example, dict):
        got = {k: _rebuild(example[k], leaves) for k in sorted(example)}
        return {k: got[k] for k in example}
    if isinstance(example, (list, tuple)):
        items = [_rebuild(v, leaves) for v in example]
        if isinstance(example, list):
            return items
        return type(example)(*items) if hasattr(example, "_fields") else type(example)(items)
    return None if example is None else next(leaves)


def _host_copy(x: Any) -> Tuple[np.ndarray, List[int], str]:
    """(array to save, logical shape, dtype name) of one leaf."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        return a, list(a.shape), str(a.dtype)
    t = x.detach().to("cpu", copy=True)
    # the dtype as numpy (and the JAX package's manifest) names it
    shape, name = list(t.shape), str(t.dtype).removeprefix("torch.")
    try:
        return t.numpy(), shape, name
    except TypeError:  # no numpy dtype: raw bytes along the last axis, as
        # the JAX package stores them
        return t.reshape(shape or [1]).contiguous().view(torch.uint8).numpy(), shape, name


def _from_host(arr: np.ndarray, shape: List[int], name: str) -> torch.Tensor:
    if str(arr.dtype) == name:
        return torch.from_numpy(arr)
    return torch.from_numpy(arr).view(getattr(torch, name)).reshape(shape)


@dataclass
class CheckpointManager:
    directory: str
    keep_last: int = 3
    async_save: bool = True

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        #: seconds of each save's snapshot to host memory, of each write
        #: (on its thread) and of each restore, in call order
        self.timings: Dict[str, List[float]] = {"snapshot_s": [], "write_s": [],
                                                "restore_s": []}

    # -- save ------------------------------------------------------------------

    def save(self, step: int, state: Any,
             extra_meta: Optional[Dict[str, Any]] = None) -> None:
        self.wait()
        # snapshot to host memory NOW
        t0 = time.perf_counter()
        host = [_host_copy(x) for _, x in tree_leaves_sorted(state)]
        self.timings["snapshot_s"].append(time.perf_counter() - t0)
        meta = {
            "step": int(step),
            "time": time.time(),
            "n_leaves": len(host),
            "treedef": str(pytree.tree_structure(state)),
            "extra": extra_meta or {},
            "leaves": [{"idx": i, "shape": shape, "dtype": name}
                       for i, (_, shape, name) in enumerate(host)],
        }
        arrays = [a for a, _, _ in host]

        def write():
            t0 = time.perf_counter()
            try:
                step_dir = os.path.join(self.directory, f"step_{step:010d}")
                tmp = step_dir + ".tmp"
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                for i, a in enumerate(arrays):
                    np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), a)
                with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                    json.dump(meta, f)
                if os.path.exists(step_dir):
                    shutil.rmtree(step_dir)
                os.rename(tmp, step_dir)  # atomic visibility
                self._gc()
                self.timings["write_s"].append(time.perf_counter() - t0)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()
            self._raise_if_failed()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint save failed: {err!r}")

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_last] if self.keep_last else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"), ignore_errors=True)

    # -- restore -----------------------------------------------------------------

    def all_steps(self) -> List[int]:
        out = []
        for d in sorted(os.listdir(self.directory)):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, d, "MANIFEST.json")):
                    out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, example_state: Any, step: Optional[int] = None,
                device_fn: Optional[Callable[[str, Any], Any]] = None) -> Tuple[Any, int]:
        """Load a checkpoint: ``example_state`` supplies the tree structure
        and, leaf by leaf, the device (``device_fn(path, example)``, when
        given, names it instead).  A save still writing on its thread is
        waited for first, so the latest step is the last one saved (a
        1.2 GB write outlasts a few training steps: without the wait, the
        supervisor's restore after a fault found an older step)."""
        self.wait()
        t0 = time.perf_counter()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        step_dir = os.path.join(self.directory, f"step_{step:010d}")
        with open(os.path.join(step_dir, "MANIFEST.json")) as f:
            meta = json.load(f)
        with_paths = tree_leaves_sorted(example_state)
        if meta["n_leaves"] != len(with_paths):
            raise ValueError(f"leaf count mismatch: checkpoint {meta['n_leaves']} vs tree "
                             f"{len(with_paths)}")
        loaded = []
        for i, (path, ex) in enumerate(with_paths):
            expect = meta["leaves"][i]
            t = _from_host(np.load(os.path.join(step_dir, f"leaf_{i:05d}.npy")),
                           expect["shape"], expect["dtype"])
            if list(t.shape) != expect["shape"]:
                raise ValueError(f"{path}: shape {list(t.shape)} != manifest {expect['shape']}")
            device = device_fn(path, ex) if device_fn is not None else (
                ex.device if isinstance(ex, torch.Tensor) else None)
            loaded.append(t.to(device) if device is not None else t)
        self.timings["restore_s"].append(time.perf_counter() - t0)
        return _rebuild(example_state, iter(loaded)), step
