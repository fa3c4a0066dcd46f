"""Phase-4 pluggable backends.

Importing this package registers the built-in backends:

* ``interpret`` — per-instruction Python dispatch (paper Listing 9),
* ``reference`` — unscheduled, unallocated fidelity oracle.

A segment backend (the counterpart of the JAX package's ``segment_jit``)
comes in a later slice.
"""
from .base import Backend, ExecutorLike, available_backends, get_backend, register_backend
from .interpret import InterpretBackend
from .reference import ReferenceBackend, ReferenceExecutor

__all__ = [
    "Backend",
    "ExecutorLike",
    "available_backends",
    "get_backend",
    "register_backend",
    "InterpretBackend",
    "ReferenceBackend",
    "ReferenceExecutor",
]
