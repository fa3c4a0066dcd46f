"""Token data pipeline: synthetic + memmap-backed corpora, per-host
sharding, deterministic resumable iteration.  A copy of the JAX
package's ``data/pipeline.py`` (numpy only): for the same ``(seed, step,
host_id)`` the batches are bitwise the reference's.

At fleet scale each host loads only its shard of the global batch
(``host_batch = global_batch // n_hosts``); the loader is stateless given
(seed, step) so restart-from-checkpoint replays the exact same stream —
the fault-tolerance contract used by ``runtime/failure.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    seed: int = 0
    corpus_path: Optional[str] = None  # None -> synthetic
    n_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0, \
            (self.global_batch, self.n_hosts)
        return self.global_batch // self.n_hosts


class TokenDataset:
    """Deterministic, seekable token batches.

    synthetic mode: Zipf-ish token stream (repeatable per (seed, step)).
    memmap mode: uint16/uint32 token file, sampled windows.
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._mm: Optional[np.memmap] = None
        if cfg.corpus_path:
            dtype = np.uint32 if cfg.vocab > 65535 else np.uint16
            self._mm = np.memmap(cfg.corpus_path, dtype=dtype, mode="r")
            if len(self._mm) < cfg.seq_len + 2:
                raise ValueError("corpus too small for seq_len")

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.cfg.seed * 1_000_003 + step) * 65_537 + self.cfg.host_id
        )

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """The (tokens, labels) pair for ``step`` on this host."""
        c = self.cfg
        rng = self._rng(step)
        B, S = c.host_batch, c.seq_len
        if self._mm is None:
            # synthetic Zipf-like stream: structured enough for loss to drop
            base = rng.zipf(1.3, size=(B, S + 1)).astype(np.int64)
            toks = np.minimum(base, c.vocab - 1).astype(np.int32)
        else:
            starts = rng.integers(0, len(self._mm) - S - 1, size=B)
            toks = np.stack(
                [np.asarray(self._mm[s:s + S + 1]) for s in starts]
            ).astype(np.int32)
            toks = np.minimum(toks, c.vocab - 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1


def write_synthetic_corpus(path: str, n_tokens: int, vocab: int,
                           seed: int = 0) -> str:
    """Materialize a synthetic corpus file (used by the examples/tests)."""
    rng = np.random.default_rng(seed)
    dtype = np.uint32 if vocab > 65535 else np.uint16
    toks = np.minimum(rng.zipf(1.3, size=n_tokens), vocab - 1).astype(dtype)
    toks.tofile(path)
    return path
