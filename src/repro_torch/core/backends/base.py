"""Backend protocol + registry (the paper's pluggable Phase-4 seam).

A *backend* owns everything after lowering: it consumes the typed RGIR
stream and produces an executor object.  The contract (``ExecutorLike``)
is small so backends can range from the per-op interpreted loop to
segment-at-a-time programs:

* ``execute(*flat_inputs) -> List[Any]`` — run on concrete flat inputs,
* ``as_fn() -> Callable`` — the same program as a plain callable,
* ``stats: ExecutorStats`` — the transparency counters.

``build`` takes the positions of the flat inputs that are parameters
(``static_inputs``, with their names): a backend that captures the
program on the card reads them at the caller's address.  ``reorder``
chooses between the device-affinity schedule and the program order.

Backends register themselves by name; ``get_backend`` resolves the name
given as ``ForgeCompiler(backend=...)``.

Persistence hooks for the compile cache's disk tier: ``export_entry``
turns a built executor into picklable analysis products, and
``build_from_entry`` rebuilds an executor from them against a freshly
lowered program of the same fingerprint.  ``adopt`` hands a memory-tier
hit to a new module (the executor itself, unless the backend holds
per-caller state that does not fit the new caller).
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import (Any, Callable, Dict, List, Optional, Protocol, Sequence, Type,
                    runtime_checkable)

from ..lowering import RGIRProgram


@runtime_checkable
class ExecutorLike(Protocol):
    """What the compiler needs back from a backend."""

    stats: Any

    def execute(self, *flat_inputs: Any) -> List[Any]:
        ...

    def as_fn(self) -> Callable:
        ...


class Backend(ABC):
    """One Phase-4 code generator.  Subclasses set ``name``."""

    #: registry key; also recorded in ``CompilationResult.backend``
    name: str = "?"

    @abstractmethod
    def build(self, prog: RGIRProgram, *, static_inputs: Sequence[int] = (),
              input_names: Optional[Sequence[str]] = None,
              reorder: bool = True) -> ExecutorLike:
        """Compile an RGIR program into an executor; ``reorder=False``
        keeps the program order (no device-affinity schedule)."""

    # -- persistence hooks (DESIGN.md §Async compilation & persistent
    # cache).  Both are best-effort: ``None`` means "this backend (or this
    # program) does not persist", and the compile cache falls back to a
    # full build.  An entry must be pure picklable data — RGIR itself is
    # not picklable (op targets are closures), so entries store analysis
    # products and are rehydrated against a freshly lowered program.

    def export_entry(self, prog: RGIRProgram, executor: ExecutorLike
                     ) -> Optional[Dict[str, Any]]:
        """Serialize ``executor`` into a picklable disk-cache entry."""
        return None

    def build_from_entry(self, prog: RGIRProgram, entry: Dict[str, Any], *,
                         static_inputs: Sequence[int] = (),
                         input_names: Optional[Sequence[str]] = None,
                         reorder: bool = True) -> Optional[ExecutorLike]:
        """Rebuild an executor from a disk entry + fresh RGIR, or None."""
        return None

    def adopt(self, executor: ExecutorLike, *, static_inputs: Sequence[int] = (),
              input_names: Optional[Sequence[str]] = None,
              flat_inputs: Sequence[Any] = ()) -> ExecutorLike:
        """The executor a compile-cache hit hands to a new caller with
        these parameter positions and example inputs: the cached one,
        shared, unless it cannot serve this caller."""
        return executor

    def __repr__(self) -> str:  # pragma: no cover
        return f"<backend {self.name!r}>"


_REGISTRY: Dict[str, Backend] = {}


def register_backend(backend_cls: Type[Backend]) -> Type[Backend]:
    """Class decorator: instantiate + register under ``backend_cls.name``."""
    inst = backend_cls()
    if inst.name in _REGISTRY:
        raise ValueError(f"backend {inst.name!r} already registered")
    _REGISTRY[inst.name] = inst
    return backend_cls


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown backend {name!r}; available: {available_backends()}") from None


def available_backends() -> List[str]:
    return sorted(_REGISTRY)
