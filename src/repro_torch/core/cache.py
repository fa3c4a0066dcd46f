"""Content-addressed compile cache (DESIGN.md §Cache) — the port of the
JAX package's ``core/cache.py``.

The per-layer block bodies compiled by ``models/_forge.forge_body`` and
the serve fronts' bucket programs are structurally identical across
layers and across server restarts of the same shape: building Phase 4
for them again is waste.  This module fingerprints the *lowered* RGIR
program — opcodes, device tags, register topology, output shapes and
dtypes, the frozen argument templates, params, and constant values —
and memoizes the backend build keyed by ``(backend, reorder, bucket,
fingerprint)``.

The fingerprint hashes constant *values* (not just shapes): a program
with different baked constants is a different program.  Weights passed
as program *inputs* (the normal per-layer case) do not enter the key, so
identical layer topologies hit regardless of their parameter values.

Two tiers: :class:`CompileCache` is the in-memory LRU of built
executors; :class:`DiskCacheStore` persists each build's analysis
products (schedule, liveness, allocation) under ``--cache-dir``, so a
restarted process rebuilds executors from disk against a freshly
lowered program of the same fingerprint.  Phases 1-3 still run on a
restart (the key is the lowered program's fingerprint, as in the JAX
package), and on the card ``segment_jit`` captures its CUDA graphs again
in Phase 4 of the compile that hits: a CUDA graph cannot be serialized.

On the card the memory tier pins each executor it holds, CUDA graph
pools included: a caller that drops a server frees that memory with
``get_compile_cache().clear()`` (or a bucket's program with
``BucketedModule.evict_cold``, the coherence drop).
"""
from __future__ import annotations

import hashlib
import os
import pickle
import sys
import tempfile
import threading
import weakref
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .lowering import RegRef, RGIRProgram


class UncacheableProgram(Exception):
    """The program embeds values that cannot be content-addressed.

    Raised when a constant is a ``FakeTensor`` (or another tensor
    subclass a tracer makes), or when the program is fingerprinted under
    an active dispatch mode — a block body compiled inside an enclosing
    ``torch.export``, whose closed-over activations become graph
    constants.  Such a value has no stable bytes to hash, and caching its
    executor would leak it past its trace, so such compiles bypass the
    cache entirely (the JAX package's tracer-constant case).
    """


#: per-constant digest memo keyed by tensor identity: fingerprinting runs
#: on *every* compile, hit or miss, and re-hashing a large baked constant
#: (plus the device-to-host copy it implies on the card) would dominate
#: the hit path.  The digest is content-stable, so it is memoized per
#: object; the weakref callback drops the entry when the tensor is
#: collected, *before* its ``id`` can be reused.  Caveat: in-place
#: mutation of a fingerprinted constant would go unnoticed — lowered
#: programs freeze constants at capture time, and nothing in the
#: pipeline mutates them.
_FP_MEMO: Dict[int, Tuple[Any, bytes]] = {}
#: tensors below this many bytes are cheaper to re-hash than to memoize
_FP_MEMO_MIN_BYTES = 1024


@dataclass
class FingerprintMemoStats:
    hits: int = 0
    misses: int = 0


fp_memo_stats = FingerprintMemoStats()


def _fp_remember(v: Any, digest: bytes) -> None:
    key = id(v)
    try:
        ref = weakref.ref(v, lambda _r, _k=key: _FP_MEMO.pop(_k, None))
    except TypeError:  # not weakref-able: never memoized
        return
    _FP_MEMO[key] = (ref, digest)


def _is_traced(v: torch.Tensor) -> bool:
    """A tensor with no stable bytes: a fake tensor, or a functional or
    other wrapper subclass that a trace makes."""
    from torch._subclasses.fake_tensor import FakeTensor

    return (isinstance(v, FakeTensor) or type(v) not in (torch.Tensor, torch.nn.Parameter)
            or torch._is_functional_tensor(v))


def _tensor_bytes(t: torch.Tensor) -> Tuple[str, str, bytes]:
    """(dtype, shape, raw bytes) of a tensor, on the host."""
    flat = t.detach().reshape(-1).contiguous().cpu()
    return str(t.dtype), str(tuple(t.shape)), flat.view(torch.uint8).numpy().tobytes()


def _hash_value(h: "hashlib._Hash", v: Any) -> None:
    """Feed one constant (or tensor-valued param) into the hasher."""
    if isinstance(v, torch.Tensor) and _is_traced(v):
        raise UncacheableProgram("traced tensor in program constants")
    entry = _FP_MEMO.get(id(v))
    if entry is not None and entry[0]() is v:
        fp_memo_stats.hits += 1
        h.update(b"fpd:")
        h.update(entry[1])
        return
    try:
        if isinstance(v, torch.Tensor):
            dtype, shape, raw = _tensor_bytes(v)
        else:
            a = np.asarray(v)
            if a.dtype == object:  # pointer-array tobytes is nondeterministic
                raise TypeError("object array")
            dtype, shape, raw = str(a.dtype), str(a.shape), a.tobytes()
    except Exception:  # not an array: fall back to repr
        h.update(repr(v).encode())
        return
    if len(raw) < _FP_MEMO_MIN_BYTES:
        # below the memo threshold the digest would be thrown away: feed
        # the hasher directly
        h.update(dtype.encode())
        h.update(shape.encode())
        h.update(raw)
        return
    sub = hashlib.sha256()
    sub.update(dtype.encode())
    sub.update(shape.encode())
    sub.update(raw)
    digest = sub.digest()
    # "fpd:" tells the 32-byte digest from a small tensor's raw bytes in
    # the parent hash stream
    h.update(b"fpd:")
    h.update(digest)
    fp_memo_stats.misses += 1
    _fp_remember(v, digest)


def _hash_obj(h: "hashlib._Hash", obj: Any) -> None:
    """Structural hash of op params (the ATen argument templates and the
    fusion params).

    Tensors are hashed by dtype / shape / bytes, never by repr, whose
    element elision on large tensors would let two different programs
    collide onto one key.  Containers recurse; everything else (ints,
    floats, strings, dtypes, devices, template ``Ref`` markers) falls
    back to repr, which is stable for all of them.
    """
    if isinstance(obj, (torch.Tensor, np.ndarray, np.generic)):
        _hash_value(h, obj)
    elif isinstance(obj, (tuple, list)):
        h.update(b"(")
        for x in obj:
            _hash_obj(h, x)
        h.update(b")")
    elif isinstance(obj, dict):
        h.update(b"{")
        for k in sorted(obj, key=repr):
            h.update(repr(k).encode())
            _hash_obj(h, obj[k])
        h.update(b"}")
    else:
        h.update(repr(obj).encode())


def _hash_aval(h: "hashlib._Hash", aval: Any) -> None:
    h.update(str(getattr(aval, "shape", None)).encode())
    h.update(str(getattr(aval, "dtype", None)).encode())


def fingerprint_program(prog: RGIRProgram) -> str:
    """Canonical RGIR fingerprint: the compile-cache key material.

    Raises :class:`UncacheableProgram` under an active dispatch mode (a
    compile inside an enclosing trace) or for a traced constant."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode

    if _get_current_dispatch_mode() is not None:
        raise UncacheableProgram("fingerprinted under an active dispatch mode")
    h = hashlib.sha256()
    h.update(f"v1|{prog.n_vregs}|{prog.input_regs}|{prog.output_regs}|".encode())
    for r in sorted(prog.constants):
        h.update(f"c{r}:".encode())
        _hash_value(h, prog.constants[r])
    for op in prog.ops:
        h.update(f"|{op.opcode}@{op.device}".encode())
        h.update(f"i{op.input_regs}o{op.output_regs}".encode())
        for a in op.frozen_args:
            if isinstance(a, RegRef):
                h.update(f"r{a.reg}".encode())
            else:
                _hash_value(h, a)
        for aval in op.out_avals:
            _hash_aval(h, aval)
        if op.params:
            for k in sorted(op.params):
                h.update(k.encode())
                _hash_obj(h, op.params[k])
    return h.hexdigest()


def make_cache_key(
    backend: str,
    reorder: bool,
    fingerprint: str,
    shape_key: Optional[Any] = None,
) -> str:
    """Compose the compile-cache key (DESIGN.md §Cache).

    ``shape_key`` is the canonical bucket ShapeKey of a bucketed compile:
    the program was captured at the *bucket* shapes, so every concrete
    shape that pads into the bucket produces this same key.  Multi-axis
    keys embed every axis (``bucket=pow2:B4xladder:S64`` for a 2-D
    prefill cell).  Exact-shape compiles omit the component.
    """
    sk = f"|bucket={shape_key}" if shape_key is not None else ""
    return f"{backend}|reorder={int(reorder)}{sk}|{fingerprint}"


#: on-disk schema version — bump on any change to the entry payload
#: layout; old entries then miss on salt and are lazily rewritten
DISK_SCHEMA = 1

#: file header; the trailing digest covers everything after it
_DISK_MAGIC = b"FORGEC01\n"


def _platform() -> str:
    if not torch.cuda.is_available():
        return "cpu"
    major, minor = torch.cuda.get_device_capability(0)
    return f"cuda:{torch.cuda.get_device_name(0)}:sm{major}{minor}"


def cache_salt() -> str:
    """Environment fingerprint folded into every on-disk address.

    A persisted entry holds analysis products pickled by this build of
    the port, against programs whose lowering depends on the torch build
    (ATen overloads, export's decompositions), the CUDA toolkit and the
    card — a restart under any different one must miss and rebuild, never
    deserialize a stale entry.
    """
    return "|".join((
        f"schema={DISK_SCHEMA}",
        f"torch={torch.__version__}",
        f"cuda={torch.version.cuda}",
        f"platform={_platform()}",
        f"py={sys.version_info.major}.{sys.version_info.minor}",
    ))


@dataclass
class DiskStoreStats:
    hits: int = 0           #: entries read, verified, and deserialized
    misses: int = 0         #: no file for the key
    writes: int = 0
    corrupt: int = 0        #: checksum/format failures (file unlinked)
    write_errors: int = 0
    bytes_written: int = 0


class DiskCacheStore:
    """Content-addressed persistent tier under one ``--cache-dir``.

    Entry files are named by ``sha256(salt | cache_key)``, fanned out
    under the digest's first two hex digits, and salted with
    :func:`cache_salt` so a torch/CUDA/card change invalidates the whole
    store by address (no scan, no version check on read).  Each file is
    ``MAGIC + sha256(payload) + payload``, the payload holding the key
    and the salt beside the entry; a truncated or bit-flipped entry fails
    the checksum, is counted, unlinked, and treated as a miss —
    corruption can cost a rebuild, never a wrong program.  Writes go
    through a same-directory temp file + ``os.replace`` so a crashed
    writer leaves either the old entry or none.
    """

    def __init__(self, root: str, salt: Optional[str] = None):
        self.root = os.path.abspath(root)
        self.salt = cache_salt() if salt is None else salt
        self.stats = DiskStoreStats()
        os.makedirs(self.root, exist_ok=True)

    def path_for(self, key: str) -> str:
        digest = hashlib.sha256(self.salt.encode() + b"\x00" + key.encode()).hexdigest()
        return os.path.join(self.root, digest[:2], f"{digest}.forgec")

    def load_entry(self, key: str) -> Optional[Dict[str, Any]]:
        from ..runtime import chaos

        path = self.path_for(key)
        try:
            if chaos.should_fault(chaos.SITE_DISK_READ):
                raise OSError("injected disk read error")
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            self.stats.misses += 1
            return None
        if chaos.should_fault(chaos.SITE_DISK_CORRUPT):
            # bit-rot in flight: the checksum below must catch it
            blob = blob[: max(len(_DISK_MAGIC), len(blob) // 2)]
        try:
            if not blob.startswith(_DISK_MAGIC):
                raise ValueError("bad magic")
            off = len(_DISK_MAGIC)
            digest, payload = blob[off: off + 32], blob[off + 32:]
            if hashlib.sha256(payload).digest() != digest:
                raise ValueError("checksum mismatch")
            wrapper = pickle.loads(payload)
            # a (vanishingly unlikely) path collision or a store re-rooted
            # onto foreign files must still miss
            if wrapper.get("key") != key or wrapper.get("salt") != self.salt:
                raise ValueError("key/salt mismatch")
            entry = wrapper["entry"]
        except Exception:
            self.stats.corrupt += 1
            try:
                os.unlink(path)
            except OSError:
                pass
            return None
        self.stats.hits += 1
        return entry

    def store_entry(self, key: str, entry: Dict[str, Any]) -> bool:
        from ..runtime import chaos

        path = self.path_for(key)
        try:
            if chaos.should_fault(chaos.SITE_DISK_WRITE):
                raise OSError("injected disk write error")
            payload = pickle.dumps({"key": key, "salt": self.salt, "entry": entry},
                                   protocol=pickle.HIGHEST_PROTOCOL)
            blob = _DISK_MAGIC + hashlib.sha256(payload).digest() + payload
            d = os.path.dirname(path)
            os.makedirs(d, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(blob)
                os.replace(tmp, path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        except Exception:
            self.stats.write_errors += 1
            return False
        self.stats.writes += 1
        self.stats.bytes_written += len(blob)
        return True

    def delete(self, key: str) -> bool:
        try:
            os.unlink(self.path_for(key))
            return True
        except OSError:
            return False

    def __len__(self) -> int:
        n = 0
        for _root, _dirs, files in os.walk(self.root):
            n += sum(1 for f in files if f.endswith(".forgec"))
        return n


@dataclass
class CacheStats:
    hits: int = 0                   #: in-memory hits
    misses: int = 0                 #: full backend builds required
    evictions: int = 0              #: LRU max_entries evictions
    disk_hits: int = 0              #: rebuilt from the persistent tier
    disk_rebuild_failures: int = 0  #: entry read ok but rebuild declined
    coherence_drops: int = 0        #: entries dropped by bucket eviction

    @property
    def hit_rate(self) -> float:
        """Fraction of lookups that avoided a full backend build."""
        total = self.hits + self.disk_hits + self.misses
        return (self.hits + self.disk_hits) / total if total else 0.0


class CompileCache:
    """Thread-safe LRU mapping fingerprint keys to built executors.

    With a :class:`DiskCacheStore` attached, lookups that miss memory
    consult the persistent tier: the caller supplies a ``loader`` that
    rebuilds an executor from the stored entry (the backend's
    ``build_from_entry``), and successful rebuilds are promoted into the
    memory LRU.  ``stats.misses`` then counts exactly the lookups that
    required a full Phase-4 build — the restart-replay gate is
    ``misses == 0`` on the second run.
    """

    def __init__(self, max_entries: int = 256, store: Optional[DiskCacheStore] = None):
        self.max_entries = max_entries
        self.store = store
        self._entries: "OrderedDict[str, Any]" = OrderedDict()
        self._lock = threading.Lock()
        self.stats = CacheStats()

    def get(self, key: str,
            loader: Optional[Callable[[Dict[str, Any]], Optional[Any]]] = None) -> Optional[Any]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.stats.hits += 1
                return entry
        if self.store is not None and loader is not None:
            # disk read + executor rebuild run outside the lock: they must
            # not serialize lookups
            payload = self.store.load_entry(key)
            if payload is not None:
                try:
                    value = loader(payload)
                except Exception:
                    value = None
                if value is not None:
                    with self._lock:
                        self.stats.disk_hits += 1
                        self._insert_locked(key, value)
                    return value
                with self._lock:
                    self.stats.disk_rebuild_failures += 1
        with self._lock:
            self.stats.misses += 1
        return None

    def put(self, key: str, value: Any, disk_entry: Optional[Dict[str, Any]] = None) -> None:
        with self._lock:
            self._insert_locked(key, value)
        if self.store is not None and disk_entry is not None:
            self.store.store_entry(key, disk_entry)

    def _insert_locked(self, key: str, value: Any) -> None:
        self._entries[key] = value
        self._entries.move_to_end(key)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
            self.stats.evictions += 1

    def drop(self, key: str, *, disk: bool = False) -> bool:
        """Coherence hook for ``BucketedModule.evict_cold``.

        Removes the retired bucket's memory entry so the LRU stops
        pinning a dead executor (on the card: its CUDA graphs and their
        pool).  The disk entry survives by default — it is the cold tier
        a re-discovered bucket replays from — and is unlinked only on
        explicit ``disk=True``.
        """
        dropped = False
        with self._lock:
            if key in self._entries:
                del self._entries[key]
                self.stats.coherence_drops += 1
                dropped = True
        if disk and self.store is not None:
            self.store.delete(key)
        return dropped

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.stats = CacheStats()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._entries


#: process-wide default cache shared by every ForgeCompiler instance
_GLOBAL_CACHE = CompileCache()


def get_compile_cache() -> CompileCache:
    return _GLOBAL_CACHE
