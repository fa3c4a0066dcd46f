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
from typing import Any, Callable, Dict, List, Optional, Tuple

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
    without its wrapper: a capture runs inside :class:`recording`, which
    records the launches of the capturing thread instead of counting
    them (the capture itself launched nothing), and the graph's owner
    adds them at each replay (:func:`add_launches`), so ``n`` keeps
    counting launches on the device."""

    def __init__(self) -> None:
        self.n = 0
        self.variants: Dict[str, int] = {}
        self.index = len(COUNTERS)
        COUNTERS.append(self)

    def count(self, variant: Optional[str] = None) -> None:
        rec = getattr(_RECORDING, "rec", None)
        if rec is not None:  # this thread is capturing a CUDA graph
            rec.launches.append((self.index, variant))
            return
        with _COUNT_LOCK:
            self.n += 1
            if variant is not None:
                self.variants[variant] = self.variants.get(variant, 0) + 1

    def reset(self) -> None:
        self.n = 0
        self.variants = {}


_SCRATCH: Dict[Tuple[str, Optional[int], int, Any], torch.Tensor] = {}
#: buffers a larger one replaced: kept, since a captured graph may hold them
_RETIRED: List[torch.Tensor] = []
_SCOPE = threading.local()


class scratch_scope:
    """Context: this thread's :func:`stream_scratch` calls inside it get
    buffers of their own, keyed by ``key`` besides the stream.  A program
    captured as CUDA graphs takes its warm run and captures inside its
    own scope, so no two programs' graphs share kernel scratch (and a
    compile worker's warm run never touches a scratch that a graph the
    serving thread replays holds)."""

    def __init__(self, key: Any):
        self.key = key

    def __enter__(self) -> None:
        self._prev = getattr(_SCOPE, "key", None)
        _SCOPE.key = self.key

    def __exit__(self, *exc) -> None:
        _SCOPE.key = self._prev


def stream_scratch(name: str, device: torch.device, n: int,
                   init: Optional[Callable[[torch.Tensor], None]] = None) -> torch.Tensor:
    """Zeroed int32 device scratch of at least ``n`` elements, one per
    (name, device, stream, :class:`scratch_scope`): the counters and
    flags a kernel leaves as it found them after every call (tickets that
    re-arm, flags tagged with an epoch), so calls on one stream need no
    memset between them.

    Safe under CUDA graphs: a captured launch keeps the buffer's address,
    so a buffer is made only outside a capture (a capture that finds none
    large enough raises: run the call once on the capture stream first)
    and is never freed: a larger one replaces it for later calls, and the
    old one stays alive for the graphs that hold it.  ``init`` sets a new
    buffer's first values."""
    stream = torch.cuda.current_stream(device)
    key = (name, device.index, stream.cuda_stream, getattr(_SCOPE, "key", None))
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


#: the launches recorded by a capture, by counter index: (i, n, variants)
Delta = Tuple[Tuple[int, int, Tuple[Tuple[str, int], ...]], ...]


def add_launches(delta: Delta) -> None:
    """Add the launches of ``delta`` to the counters (a graph replay)."""
    with _COUNT_LOCK:
        for i, dn, dv in delta:
            c = COUNTERS[i]
            c.n += dn
            for k, d in dv:
                c.variants[k] = c.variants.get(k, 0) + d


#: counters are bumped from the serving thread and compile workers alike
_COUNT_LOCK = threading.Lock()
_RECORDING = threading.local()


class _Recorder:
    def __init__(self) -> None:
        self.launches: List[Tuple[int, Optional[str]]] = []

    def delta(self) -> Delta:
        """The recorded launches as a :data:`Delta`."""
        per: Dict[int, Tuple[int, Dict[str, int]]] = {}
        for i, variant in self.launches:
            n, v = per.get(i, (0, {}))
            if variant is not None:
                v[variant] = v.get(variant, 0) + 1
            per[i] = (n + 1, v)
        return tuple((i, n, tuple(v.items())) for i, (n, v) in sorted(per.items()))


class recording:
    """Context: the launches this thread's wrappers make inside it are
    recorded, not counted (a CUDA graph capture: the graph's owner adds
    them at each replay with :func:`add_launches`).  Other threads keep
    counting."""

    def __enter__(self) -> _Recorder:
        self._prev = getattr(_RECORDING, "rec", None)
        _RECORDING.rec = _Recorder()
        return _RECORDING.rec

    def __exit__(self, *exc) -> None:
        _RECORDING.rec = self._prev


def check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {rc}")
