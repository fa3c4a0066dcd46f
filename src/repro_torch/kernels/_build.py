"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``.  The
library lands in ``build/repro_torch_kernels/`` at the repository root
(resolved from this file, not from the working directory) under a name
that carries the hash of the sources and flags, so an edited source is
rebuilt at its next use and an unchanged one is loaded as built.
Nothing is built at import time: the first launch builds, or
:func:`build_all` builds every library at once, one ``nvcc`` per source,
all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("fused_linear", "flash_attention", "paged_attention", "rg_lru", "rms_norm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh") and (src.suffix == ".cuh" or src.stem == name):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> Tuple[subprocess.Popen, Path, Path]:
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: Path, out: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return log


def build_all(names: Tuple[str, ...] = SOURCES) -> Dict[str, str]:
    """Build every missing library in parallel; returns nvcc's log per
    library built (``-Xptxas -v``: registers, shared memory, spills)."""
    with _lock:
        started: List[Tuple[str, subprocess.Popen, Path, Path]] = []
        for name in names:
            if not library_path(name).exists():
                started.append((name, *_start(name)))
        return {name: _finish(name, *rest) for name, *rest in started}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
    return lib


#: every kernel wrapper's counter, in creation order
COUNTERS: List["LaunchCount"] = []


class LaunchCount:
    """Plain launch counter of one kernel wrapper: ``n`` grows by one
    where the wrapper launches its kernel, and nowhere else;
    ``variants`` counts the same launches by the kernel variant taken,
    for wrappers that choose one.

    A launch captured into a CUDA graph runs again at every replay
    without its wrapper: the graph's owner takes the launches its
    capture recorded (:func:`launch_snapshot` before and after,
    :func:`launch_delta`), takes them back off (the capture itself
    launched nothing) and adds them at each replay (:func:`add_launches`),
    so ``n`` keeps counting launches on the device."""

    def __init__(self) -> None:
        self.n = 0
        self.variants: Dict[str, int] = {}
        COUNTERS.append(self)

    def count(self, variant: Optional[str] = None) -> None:
        self.n += 1
        if variant is not None:
            self.variants[variant] = self.variants.get(variant, 0) + 1

    def reset(self) -> None:
        self.n = 0
        self.variants = {}


_SCRATCH: Dict[Tuple[str, Optional[int], int], torch.Tensor] = {}
#: buffers a larger one replaced: kept, since a captured graph may hold them
_RETIRED: List[torch.Tensor] = []


def stream_scratch(name: str, device: torch.device, n: int,
                   init: Optional[Callable[[torch.Tensor], None]] = None) -> torch.Tensor:
    """Zeroed int32 device scratch of at least ``n`` elements, one per
    (name, device, stream): the counters and flags a kernel leaves as it
    found them after every call (tickets that re-arm, flags tagged with
    an epoch), so calls on one stream need no memset between them.

    Safe under CUDA graphs: a captured launch keeps the buffer's address,
    so a buffer is made only outside a capture (a capture that finds none
    large enough raises: run the call once on the capture stream first)
    and is never freed: a larger one replaces it for later calls, and the
    old one stays alive for the graphs that hold it.  ``init`` sets a new
    buffer's first values."""
    stream = torch.cuda.current_stream(device)
    key = (name, device.index, stream.cuda_stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{name}: no scratch of {n} ints on this stream before a CUDA "
                               f"graph capture; run the call once on the capture stream first")
        size = max(n, 2 * buf.numel()) if buf is not None else n
        if buf is not None:
            _RETIRED.append(buf)
        buf = torch.zeros(size, dtype=torch.int32, device=device)
        if init is not None:
            init(buf)
        _SCRATCH[key] = buf
    return buf


#: one launch count per counter, by variant too: (n, variants) each
Snapshot = Tuple[Tuple[int, Dict[str, int]], ...]
#: the launches between two snapshots, by counter index: (i, n, variants)
Delta = Tuple[Tuple[int, int, Tuple[Tuple[str, int], ...]], ...]


def launch_snapshot() -> Snapshot:
    return tuple((c.n, dict(c.variants)) for c in COUNTERS)


def launch_delta(before: Snapshot, after: Snapshot) -> Delta:
    """The launches counted between two snapshots (counters made in
    between start from zero)."""
    out = []
    for i, (n, variants) in enumerate(after):
        n0, v0 = before[i] if i < len(before) else (0, {})
        dv = tuple((k, c - v0.get(k, 0)) for k, c in variants.items() if c != v0.get(k, 0))
        if n != n0 or dv:
            out.append((i, n - n0, dv))
    return tuple(out)


def add_launches(delta: Delta, sign: int = 1) -> None:
    """Add ``sign`` times the launches of ``delta`` to the counters."""
    for i, dn, dv in delta:
        c = COUNTERS[i]
        c.n += sign * dn
        for k, d in dv:
            c.variants[k] = c.variants.get(k, 0) + sign * d
            if not c.variants[k]:
                del c.variants[k]


def check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {rc}")
