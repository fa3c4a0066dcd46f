"""Phase-4 pluggable backends.

Importing this package registers the built-in backends:

* ``interpret`` — per-instruction Python dispatch (paper Listing 9),
* ``reference`` — unscheduled, unallocated fidelity oracle,
* ``segment_jit`` — one dispatch per device-affine segment: one CUDA
  graph replay each on the card.
"""
from .base import Backend, ExecutorLike, available_backends, get_backend, register_backend
from .interpret import InterpretBackend
from .reference import ReferenceBackend, ReferenceExecutor
from .segment_jit import SegmentExecutor, SegmentJitBackend

__all__ = [
    "Backend",
    "ExecutorLike",
    "available_backends",
    "get_backend",
    "register_backend",
    "InterpretBackend",
    "ReferenceBackend",
    "ReferenceExecutor",
    "SegmentExecutor",
    "SegmentJitBackend",
]
