"""Batched greedy serving — the port of ``repro.launch.serve``.

The three modes of the JAX server, under its names:

* ``BatchedServer(mode="jit")`` (the default, as in the JAX package):
  the serve step compiled whole, the paper's compile-then-run baseline.
  The JAX server runs it under ``jax.jit(serve_step, donate_argnums=(1,))``;
  here ``torch.compile(..., fullgraph=True, dynamic=False)`` compiles the
  step ``interpret`` runs (Forge-compiled block bodies included: their
  RGIR ops, the kernels' custom ops among them, are traced into the one
  graph) once per batch extent, and the step writes the new K/V into the
  cache it was given (the donation analogue: the cache stays in place).
  On the card the compiled step runs as one CUDA graph
  (:class:`JitServeStep`).
* ``BatchedServer(mode="interpret")``: the same step run op by op
  (PyTorch executes eagerly); when ``cfg.fuse == "forge"`` every block
  body inside it is Forge-compiled once per shape through all four
  phases, so the fused ``forge.linear_act`` and ``forge.sdpa`` nodes
  reach the CUDA kernels.

Both prefill the prompt token by token through the decode step, as the
JAX server does in these modes.

``BatchedServer(mode="forge")`` with the contiguous cache serves groups
through two multi-program fronts: the whole decode step (embedding,
every layer, LM head, greedy argmax) compiled through Phases 1-4 once
per batch bucket with the slot signature (per-row ``pos`` and
``slot_mask``), and the whole-prompt prefill once per (batch × sequence)
grid cell.  The dense decoder writes the whole prompt block into its KV
cache in one dispatch (``last_prefill_mode == "batched"``); the
recurrent families (recurrentgemma, xLSTM) prefill through the chunked
state scan, one dispatch per prompt block (``"chunked"``;
recurrentgemma's RG-LRU recurrence launches the hand-written scan
kernel); ``prefill="sequential"`` replays the prompt through the decode
program instead.  Every program runs on the Phase-4 backend named by
``backend``: ``segment_jit`` (the default, as in the JAX package) replays
each device-affine segment as one CUDA graph on the card.

:class:`SlotScheduler` is slot-level continuous batching: every tick
advances each active slot at its own position.  Over
``BatchedServer(mode="forge", paged=True)`` the KV cache is a shared
page pool with per-slot page tables, a refcounted allocator and a
shared-prefix tree (``core/paging.py``); with ``cfg.kv_kernel ==
"pallas"`` decode attention runs the hand-written paged-attention kernel.
Over the contiguous fronts a swapped-in row is prefilled through the
slot-masked grid (or the in-loop fill path) — a recurrent row is reset
to its init state first, a dense row's stale keys are hidden by the
length mask — and a rung resize gathers the active rows.

Compile cost (DESIGN.md §Async compilation): ``async_compile=True``
compiles cold buckets on a :class:`~repro_torch.core.CompileService`
while dispatches pad into the nearest warm dominating bucket (the
scheduler's rung choice, :meth:`SlotScheduler._target_rung`, and the
group fronts' batch and sequence extents); ``cache_dir`` attaches a
:class:`~repro_torch.core.DiskCacheStore` so a restarted process
rebuilds its programs' Phase 4 from disk (the forge block bodies' too,
through the process-global cache).  The contiguous fronts park each
generation's cache in the decode front's
:class:`~repro_torch.core.BufferPool` and reuse it, reset in place, at
the next admission to the same bucket.

Fault tolerance and SLO scheduling (DESIGN.md §Fault tolerance, §SLO-aware
scheduling): no single request, compile, page, dispatch or logits fault
may take down the slot scheduler's loop.  Every request ends with a
typed outcome, every fault is contained at the narrowest boundary that
can absorb it (dispatch retry, row quarantine, admission fallback or
undo, degraded mode, abort), and requests a fault did not touch produce
the tokens of a fault-free run, bitwise.  A fault path mints no new
program shape: the admission gather is a fixed ``(extent,)`` shape and
the ``logits.nan`` poison is injected on the host.  Under ``slo=True``
admission is deadline-aware (EDF, shed-on-hopeless, page-parking
preemption whose resume replays nothing), and ``refit_interval`` re-fits
the decode ladder to the observed batch sizes.  ``--chaos`` arms a
seeded ``runtime/chaos.py`` plan around the measured ``--continuous``
run only.

CLI (runs on the CUDA device unless ``--device cpu``)::

    python -m repro_torch.launch.serve --arch forge-125m [--smoke] [--mode jit|interpret]
    python -m repro_torch.launch.serve --arch forge-125m --mode forge \\
        [--backend segment_jit|interpret|reference] [--continuous 8 --max-slots 4]
    python -m repro_torch.launch.serve --arch xlstm-350m --mode forge \\
        [--prefill auto|batched|sequential] [--continuous 8 --max-slots 4]
    python -m repro_torch.launch.serve --arch forge-125m --mode forge \\
        --continuous 12 --max-slots 4 --paged --kv-kernel pallas
    python -m repro_torch.launch.serve --arch forge-125m --mode forge \\
        --sweep 1,3,8 --prompt-sweep 17,48 [--async-compile] \\
        [--cache-dir DIR [--assert-no-builds]]
    python -m repro_torch.launch.serve --arch forge-125m --mode forge \\
        --continuous 12 --paged --chaos page.alloc=0.2,dispatch=0.05 --chaos-seed 3
"""
from __future__ import annotations

import argparse
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..configs import ARCH_IDS, get_config
from ..core.paging import TRASH_PAGE, build_row_table, pages_for
from ..core.shapekey import flatten_axes, get_bucket_policy
from ..device import resolve_device
from ..models import get_model
from ..runtime import chaos
from ..runtime.chaos import SystemError_
from .steps import (POISON_TOKEN, blend_cache_rows, gather_cache_rows, guarded_argmax,
                    make_serve_step, supports_slot_decode)

PREFILL_POLICIES = ("auto", "batched", "sequential")


class RequestError(ValueError):
    """A request-level failure (malformed prompt array)."""


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class BatchedServer:
    """Batch server with greedy decoding.

    ``impl`` is forwarded into every fused node and kernel call: None
    dispatches by device (the CUDA kernels on the card), ``"ref"`` runs
    the kernels' plain versions — the oracle a kernel run is held against.

    ``mode="jit"``: group admission, sequential prefill through the
    decode step compiled whole per batch extent (:class:`JitServeStep`,
    which owns the extent's cache and updates it in place).

    ``mode="interpret"``: the same, with the decode step run op by op.

    ``mode="forge"``: the decode step compiled through Phases 1-4 behind
    a :class:`~repro_torch.core.compiler.BucketedModule` (one program per
    ``bucket_policy`` batch bucket), and the whole-prompt prefill behind a
    2-D (batch × ``seq_bucket_policy`` sequence) one.

    * contiguous cache (default): :meth:`generate` edge-pads a prompt
      group to its buckets and runs the slot-signature decode program in
      lockstep; the cache (per-leaf batch axes from
      :func:`~repro_torch.core.shapekey.infer_poly_axes`) comes from the
      decode front's buffer pool, reset in place, and returns to it when
      the generation ends.  ``prefill``: ``"auto"``/``"batched"`` take
      the prefill grid when the prompt fits it, ``"sequential"`` replays
      it through the decode program (read at each call, so one server
      can time both on the same warmed decode program).
    * ``paged=True``: the fronts for :class:`SlotScheduler` — every
      program reads and returns the one server-resident page store
      (``kv_pages`` pages of ``kv_page_size`` tokens, page 0 the trash
      page; default eight full-length slots' worth); only the page table,
      tokens, positions and slot mask are bucket-shaped.

    ``async_compile`` (``compile_workers`` threads): cold buckets compile
    in the background; a dispatch pads into the nearest warm dominating
    bucket and blocks only when none exists (the first program).
    ``cache_dir``: the persistent compile tier (fronts and, through the
    process-global cache, the block bodies).  The contiguous cache of a
    generation is pooled per bucket (``bucketed.pool``) and reset in
    place at its next admission.
    """

    MODES = ("jit", "interpret", "forge")

    def __init__(self, cfg, params, max_len: int = 256, mode: str = "jit",
                 impl: Optional[str] = None, *, backend: str = "segment_jit",
                 bucket_policy: str = "pow2",
                 seq_bucket_policy: str = "ladder:16,32,64,128,256",
                 prefill: str = "auto", paged: bool = False, kv_page_size: int = 16,
                 kv_pages: Optional[int] = None, async_compile: bool = False,
                 compile_workers: int = 2, cache_dir: Optional[str] = None):
        if mode not in self.MODES:
            raise ValueError(f"mode {mode!r} not supported; the port serves {self.MODES}")
        if prefill not in PREFILL_POLICIES:
            raise ValueError(f"prefill {prefill!r} not in {PREFILL_POLICIES}")
        if paged and mode != "forge":
            raise ValueError("paged KV serving needs mode='forge'")
        self.cfg = cfg
        self.params = params
        self.model = get_model(cfg)
        self.max_len = max_len
        self.mode = mode
        self.impl = impl
        self.device = params["embed"].device
        self.serve_step = make_serve_step(cfg, impl=impl)
        #: "auto" | "batched" (the prefill grid when the prompt fits it) |
        #: "sequential" (replay through the decode program: the TTFT
        #: baseline); read at each prefill
        self.prefill_policy = prefill
        #: how the most recent prefill ran: "chunked" (recurrent state
        #: scan) | "batched" (KV chunk write) | "sequential" (decode loop)
        self.last_prefill_mode = None
        self.backend = backend
        self.bucket_policy = bucket_policy
        self.seq_bucket_policy = seq_bucket_policy
        self.slot_capable = supports_slot_decode(cfg)
        self.paged = bool(paged)
        self.kv_page_size = int(kv_page_size)
        self.kv_pages = kv_pages
        #: the decode and prefill multi-program fronts (mode="forge")
        self.bucketed = None
        self.prefill_bucketed = None
        #: per-leaf batch axes of the contiguous cache (None when paged)
        self.cache_axes = None
        self.page_pool = None
        self.prefix_tree = None
        #: server-resident {k_pages, v_pages} store (no batch axis)
        self.page_store = None
        self.max_pages_per_slot = 0
        #: most recently resolved bucket program (transparency)
        self.forge_module = None
        #: mode="jit": the compiled step of each batch size served
        self.jit_steps: Dict[int, JitServeStep] = {}
        if mode == "forge":
            from ..core.backends import get_backend

            get_backend(backend)  # fail fast on unknown names
            get_bucket_policy(bucket_policy)
            get_bucket_policy(seq_bucket_policy)
        if self.paged:
            from .steps import supports_paged_decode

            if not supports_paged_decode(cfg):
                raise ValueError(f"family {cfg.family!r} has no paged decode path")
            if max_len % self.kv_page_size:
                raise ValueError(f"max_len={max_len} must be a multiple of "
                                 f"kv_page_size={self.kv_page_size}")
        if (async_compile or cache_dir is not None) and mode != "forge":
            raise ValueError("async_compile / cache_dir act on the bucketed fronts: "
                             "they need mode='forge'")
        self.async_compile = bool(async_compile)
        self.compile_service = None
        if self.async_compile:
            from ..core import CompileService

            self.compile_service = CompileService(workers=compile_workers)
        #: the persistent compile tier (``cache_dir``): the fronts' bucket
        #: programs and, through the process-global cache, the forge block
        #: bodies rebuild Phase 4 from disk after a restart
        self.cache_dir = cache_dir
        self.compile_cache = None
        if cache_dir is not None:
            from ..core import CompileCache, DiskCacheStore, get_compile_cache

            store = DiskCacheStore(cache_dir)
            self.compile_cache = CompileCache(store=store)
            g = get_compile_cache()
            if g.store is None:
                g.store = store
        self._front_lock = threading.Lock()
        #: per-leaf init values of a one-row cache for the pooled-cache
        #: reset (None: the leaf's init is all zeros); set with the fronts
        self._init_leaves: List[Optional[torch.Tensor]] = []

    def _build_cache(self, batch: int):
        return self.model.init_cache(self.cfg, batch, self.max_len, device=self.device)

    def _check_prompts(self, prompts: np.ndarray) -> None:
        if prompts.ndim != 2 or prompts.shape[0] == 0 or prompts.shape[1] == 0:
            raise RequestError(f"prompts must be a non-empty (B, P) array, got "
                               f"shape {prompts.shape}")
        if prompts.min() < 0 or prompts.max() >= self.cfg.vocab:
            raise RequestError("prompt token ids out of vocabulary range")

    # -- bucketed fronts (mode="forge") ----------------------------------

    def _ensure_bucketed(self) -> None:
        """Build the fronts (and the pool state when paged) once."""
        with self._front_lock:
            if self.bucketed is not None:
                return
            if self.paged:
                self._build_paged_front()
            else:
                self._build_contiguous_front()

    def _compiler(self):
        from ..core import ForgeCompiler

        return ForgeCompiler(impl=self.impl, backend=self.backend, cache=self.compile_cache)

    def _build_contiguous_front(self) -> None:
        """The decode front (one program per batch bucket, slot signature
        ``(params, cache, token, pos(B,), mask(B,))``; the lockstep
        ``(params, cache, token, pos)`` for a family without slot decode)
        and the 2-D prefill front ``(params, cache, tokens(B,S), pos,
        mask(B,)[, length(B,)])`` with a scalar start position; only
        tokens carry the sequence axis — the cache is ``max_len``-resident
        on both sides.  A family without batched prefill (MoE capacity
        routing; the VLM) gets no prefill front: its prompts replay
        through the decode program."""
        from ..core import PolyAxis
        from ..core.shapekey import infer_poly_axes
        from ..models.transformer import FAMILIES as TRANSFORMER_FAMILIES
        from .steps import make_slot_prefill_step, make_slot_serve_step

        # per-leaf cache batch axes differ across families (transformer:
        # axis 1 under the layer dim; recurrent states: axis 0): infer
        # them from two cache builds on the meta device (no allocation)
        cache_axes = infer_poly_axes(
            lambda b: self.model.init_cache(self.cfg, b, self.max_len, device="meta"))
        self.cache_axes = cache_axes
        # the pool's reset template, read here once (it syncs the device)
        row = self.model.init_cache(self.cfg, 1, self.max_len, device=self.device)
        self._init_leaves = [leaf if bool(leaf.any()) else None
                             for leaf in pytree.tree_leaves(row)]
        compiler = self._compiler()
        # the transformer backbones' steps (dense, moe, vlm) call
        # Forge-compiled block bodies, which compile at their first call
        # and cannot inside the front's capture: prime each cell first
        # (see BucketedModule).  Every step takes params first: the
        # parameters (static_argnums)
        prime = self.cfg.family in TRANSFORMER_FAMILIES and self.cfg.fuse == "forge"
        pstep = make_slot_prefill_step(self.cfg, impl=self.impl)
        if pstep is not None:
            b_in, s_in = (None, cache_axes, 0, None, 0), (None, None, 1, None, None)
            if self.model.prefill_takes_length:
                b_in, s_in = b_in + (0,), s_in + (None,)
            self.prefill_bucketed = compiler.compile_bucketed(
                pstep,
                axes=(PolyAxis(in_axes=b_in, out_axes=(0, cache_axes),
                               policy=self.bucket_policy, label="B"),
                      PolyAxis(in_axes=s_in, out_axes=(1, None),
                               policy=self.seq_bucket_policy, label="S")),
                prime=prime, static_argnums=(0,), async_compile=self.async_compile,
                service=self.compile_service,
            )
        if self.slot_capable:
            step = make_slot_serve_step(self.cfg, impl=self.impl)
            in_axes = (None, cache_axes, 0, 0, 0)
        else:  # every row at the one position (the VLM's M-RoPE streams)
            step = make_serve_step(self.cfg, impl=self.impl)
            in_axes = (None, cache_axes, 0, None)
        self.bucketed = compiler.compile_bucketed(
            step, in_axes=in_axes, out_axes=(0, cache_axes),
            policy=self.bucket_policy, prime=prime, static_argnums=(0,),
            async_compile=self.async_compile, service=self.compile_service,
        )

    def _build_paged_front(self) -> None:
        """The paged-KV fronts + pool state.

        The KV store carries no batch axis — ``in_axes`` marks it None on
        both sides, so every bucket program reads and returns the one
        server-resident page store.  Only the page table, tokens, pos and
        mask are bucket-shaped, which makes swap-in and rung resizes
        O(table): the pages never move.
        """
        from ..core import PolyAxis
        from ..core.paging import PagePool, PrefixTree
        from ..models.transformer import paged_body_compiled
        from .steps import dealias_tree, make_paged_prefill_step, make_paged_serve_step

        ps = self.kv_page_size
        self.max_pages_per_slot = self.max_len // ps
        num_pages = int(self.kv_pages or 8 * self.max_pages_per_slot + 1)
        self.page_pool = PagePool(num_pages, ps)
        self.prefix_tree = PrefixTree(self.page_pool)
        full = self.model.init_paged_cache(self.cfg, 1, self.max_len, num_pages=num_pages,
                                           page_size=ps, device=self.device)
        self.page_store = dealias_tree({"k_pages": full["k_pages"],
                                        "v_pages": full["v_pages"]})
        compiler = self._compiler()
        # Forge-compiled block bodies compile at their first call, which
        # cannot happen inside the front's capture: prime each cell first
        prime = paged_body_compiled(self.cfg)
        # (params, store, page_table(B,MP), tokens(B,S), pos(B,), mask(B,)):
        # per-row pos lets prefix-hit rows anchor their chunk at the skip
        # offset in the same dispatch as cold rows.  None for MoE: its
        # slots fill through the decode program
        pstep = make_paged_prefill_step(self.cfg, impl=self.impl)
        if pstep is not None:
            self.prefill_bucketed = compiler.compile_bucketed(
                pstep,
                axes=(
                    PolyAxis(in_axes=(None, None, 0, 0, 0, 0), out_axes=(0, None),
                             policy=self.bucket_policy, label="B"),
                    PolyAxis(in_axes=(None, None, None, 1, None, None), out_axes=(1, None),
                             policy=self.seq_bucket_policy, label="S"),
                ),
                prime=prime, static_argnums=(0,), async_compile=self.async_compile,
                service=self.compile_service,
            )
        self.bucketed = compiler.compile_bucketed(
            make_paged_serve_step(self.cfg, impl=self.impl),
            in_axes=(None, None, 0, 0, 0, 0), out_axes=(0, None), policy=self.bucket_policy,
            prime=prime, static_argnums=(0,), async_compile=self.async_compile,
            service=self.compile_service,
        )

    def _bucket_extent(self, B: int) -> int:
        """Decode bucket extent of a batch size.

        Inline: the policy's bucket (its program compiles at the first
        dispatch).  Async: the bucket when its program is warm; otherwise
        the bucket goes to the compile service and the smallest warm
        bucket that dominates ``B`` serves the group padded up — the call
        blocks only when no warm bucket can hold the batch."""
        self._ensure_bucketed()
        exact = self.bucketed.policy.bucket(B)
        if not self.async_compile:
            return exact
        return self._async_extent(exact)

    def _async_extent(self, exact: int) -> int:
        """Warm-fallback extent selection of the decode front."""
        front = self.bucketed
        key = front.key_for_extents(exact)
        if front.lookup_program(key) is not None:
            return exact
        fut = front.submit_key(key, args_fn=lambda e=exact: self._decode_example_args(e),
                               foreground=True)
        warm = front.nearest_warm(exact)
        if warm is not None:
            # fallback premium: the extra padded rows over the exact rung
            front.stats.note_fallback(warm.extents[0] - exact)
            return warm.extents[0]
        # nothing dominates: the very first program must block
        t0 = time.perf_counter()
        self.compile_service.result(fut)
        front.stats.note_wait(time.perf_counter() - t0)
        return exact

    def _decode_example_args(self, extent: int):
        """Bucket-shaped example arguments of a background decode compile,
        built in the service worker (``submit_key(args_fn=...)``) so that
        submission stays cheap; the throwaway cache is never served."""
        if self.paged:
            return (self.params, self.page_store) + self._paged_args(extent, 1)
        tok = torch.zeros((extent, 1), dtype=torch.int32, device=self.device)
        return (self.params, self._build_cache(extent)) + self._decode_args(extent, tok, 0)

    def _prefill_example_args(self, extent: int, s_ext: int):
        """Example arguments of a background (extent x s_ext) cell compile."""
        if self.paged:
            return (self.params, self.page_store) + self._paged_args(extent, s_ext)
        tokens = torch.zeros((extent, s_ext), dtype=torch.int32, device=self.device)
        return (self.params, self._build_cache(extent)) + self._prefill_args(extent, tokens, 0)

    def _seq_bucket_extent(self, P: int, extent: Optional[int] = None) -> Optional[int]:
        """Sequence bucket of a prompt length, or None when the ladder
        rejects it or the bucket would not fit ``max_len``.

        Async, with the batch ``extent`` known: a cold cell goes to the
        compile service and the smallest warm cell at the same batch
        extent with ``s' >= s`` serves the prompt edge-padded further
        right; with no such cell the result is None (the prompt takes the
        sequential path — the decode program is warm, so nothing stalls).
        """
        if self.prefill_bucketed is None:
            return None
        try:
            s = self.prefill_bucketed.axes[1].policy.bucket(P)
        except ValueError:
            return None
        if s > self.max_len:
            return None
        if not self.async_compile or extent is None:
            return s
        return self._async_cell_extent(extent, s)

    def _async_cell_extent(self, extent: int, s_ext: int) -> Optional[int]:
        """Warm-fallback sequence extent at a fixed batch extent."""
        front = self.prefill_bucketed
        key = front.key_for_extents((extent, s_ext))
        if front.lookup_program(key) is not None:
            return s_ext
        front.submit_key(key, args_fn=lambda e=extent, s=s_ext: self._prefill_example_args(e, s),
                         foreground=True)
        # the batch extent is pinned by the decode bucket (the cache is
        # built at it), so only same-extent cells are legal pad targets
        best = None
        for k in front.warm_keys():
            e, s = k.extents
            if e == extent and s_ext <= s <= self.max_len and (best is None or s < best):
                best = s
        if best is not None:
            front.stats.note_fallback(extent * (best - s_ext))
        return best

    # -- the contiguous cache's buffer pool -------------------------------

    def _cache_reset(self, cache):
        """Reset a pooled cache to its init values in place (the
        counterpart of the JAX server's donating zero-fill): ``zero_()``
        where the init is zeros, else a broadcast copy of a one-row init
        cache (xLSTM's stabilizer starts at -1e30)."""
        for leaf, ini in zip(pytree.tree_leaves(cache), self._init_leaves):
            if ini is None:
                leaf.zero_()
            else:
                leaf.copy_(ini)
        return cache

    def _acquire_cache(self, extent: int):
        """A bucket-extent contiguous cache: pooled on the forge fronts
        (keyed by the bare extent — ``compiler.bucket_pool_key`` of a 1-D
        ShapeKey — so ``BucketedModule.evict_cold`` releases what this
        parks), fresh otherwise."""
        if self.bucketed is None or self.paged:
            return self._build_cache(extent)
        return self.bucketed.pool.acquire(extent, lambda: self._build_cache(extent),
                                          reset=self._cache_reset)

    def _release_cache(self, extent: int, cache) -> None:
        """Park a finished generation's cache for the next admission."""
        if self.bucketed is not None and not self.paged and cache is not None:
            self.bucketed.pool.release(extent, cache)

    def _decode_args(self, extent: int, tok: torch.Tensor, pos: int):
        """The decode program's argument tail for group admission: the
        token column, the position broadcast to a per-row int32 vector and
        an all-true slot mask (a lockstep front: the 0-d int32 position)."""
        dev = self.device
        if not self.slot_capable:
            return (tok, torch.tensor(int(pos), dtype=torch.int32, device=dev))
        return (tok, torch.full((extent,), int(pos), dtype=torch.int32, device=dev),
                torch.ones((extent,), dtype=torch.bool, device=dev))

    def _prefill_args(self, extent: int, tokens: torch.Tensor, pos: int,
                      lengths: Optional[np.ndarray] = None,
                      active: Optional[np.ndarray] = None):
        """The prefill program's argument tail: tokens, the 0-d int32 start
        position and the slot mask (default all true: group admission);
        recurrent fronts append per-row ``lengths`` (default: the full
        chunk width — every token real) bounding each row's state scan."""
        dev = self.device
        mask = (torch.ones((extent,), dtype=torch.bool, device=dev) if active is None
                else torch.as_tensor(active, dtype=torch.bool, device=dev))
        tail = (tokens, torch.tensor(int(pos), dtype=torch.int32, device=dev), mask)
        if self.model.prefill_takes_length:
            if lengths is None:
                lengths = np.full((extent,), tokens.shape[1], np.int32)
            tail = tail + (torch.as_tensor(lengths, dtype=torch.int32, device=dev),)
        return tail

    def _paged_args(self, extent: int, width: int):
        """All-trash page table, zero tokens (width columns), zero pos and
        an all-false mask at a bucket extent: every write of a dispatch
        with these goes to the trash page."""
        dev = self.device
        return (torch.zeros((extent, self.max_pages_per_slot), dtype=torch.int32, device=dev),
                torch.zeros((extent, width), dtype=torch.int32, device=dev),
                torch.zeros((extent,), dtype=torch.int32, device=dev),
                torch.zeros((extent,), dtype=torch.bool, device=dev))

    @torch.no_grad()
    def warmup(self, batch_sizes: Sequence[int],
               prompt_lens: Optional[Sequence[int]] = None) -> float:
        """Precompile the decode buckets of ``batch_sizes`` and the prefill
        grid cells of ``batch_sizes`` × ``prompt_lens`` (no cells for a
        contiguous server under ``prefill="sequential"``); returns the
        seconds spent.  Each program's compile time is in
        ``stats.per_bucket_compile_s`` of its front.

        Contiguous fronts run each program once on a throwaway cache, then
        park it in the pool (the first served admission per bucket is a
        pool hit).  Paged fronts use all-false slot masks and trash-only
        page tables, which route every throwaway write to the trash page,
        so the warmed store and the pool state are untouched.

        Async: every program is first queued on the compile service
        (speculative priority) and the call waits for the workers; the
        loop below then only runs the warm programs.

        ``mode="jit"`` builds the compiled step of each batch size (one
        step on a zero token at position 0; the next prefill resets the
        cache); ``mode="interpret"`` has nothing to warm.
        """
        if self.mode == "jit":
            t0 = time.perf_counter()
            for B in sorted(set(int(b) for b in batch_sizes)):
                step = self.jit_step(B)
                if step.calls == 0:
                    tok = torch.zeros((B, 1), dtype=torch.int64, device=self.device)
                    step(self.params, step.cache, tok, 0)
            return time.perf_counter() - t0
        if self.mode != "forge":
            return 0.0
        self._ensure_bucketed()
        t0 = time.perf_counter()
        extents = sorted({self.bucketed.policy.bucket(int(B)) for B in batch_sizes})
        # a contiguous server under prefill="sequential" prefills through
        # the decode program only (the JAX server builds no prefill front)
        lens = () if not self.paged and self.prefill_policy == "sequential" else prompt_lens
        cells = sorted({(e, s) for e in extents for s in map(self._seq_bucket_extent, lens or ())
                        if s is not None})
        if self.async_compile:
            self._submit_warmup(extents, cells)
        store = self.page_store
        for extent in extents:
            if self.paged:
                args = (store,) + self._paged_args(extent, 1)
            else:
                tok = torch.zeros((extent, 1), dtype=torch.int32, device=self.device)
                args = (self._acquire_cache(extent),) + self._decode_args(extent, tok, 0)
            mod, key, _ = self.bucketed.program_for(self.params, *args)
            _, out_state = mod(self.params, *args)
            if self.paged:
                store = out_state
            else:
                self._release_cache(extent, out_state)
            # throwaway rows are all padding: none are served requests
            self.bucketed.stats.note_dispatch(key, 0, extent)
            self.forge_module = mod
        for extent, s_ext in cells:
            if self.paged:
                pargs = (store,) + self._paged_args(extent, s_ext)
            else:
                tokens = torch.zeros((extent, s_ext), dtype=torch.int32, device=self.device)
                pargs = (self._acquire_cache(extent),) + self._prefill_args(extent, tokens, 0)
            pmod, pkey, _ = self.prefill_bucketed.program_for(self.params, *pargs)
            _, out_state = pmod(self.params, *pargs)
            if self.paged:
                store = out_state
            else:
                self._release_cache(extent, out_state)
            self.prefill_bucketed.stats.note_dispatch(pkey, (0, 0), pkey.extents)
        self.page_store = store
        _sync(self.device)
        return time.perf_counter() - t0

    def _submit_warmup(self, extents: Sequence[int], cells: Sequence[Any]) -> None:
        """Queue every decode bucket and prefill cell on the compile
        service at speculative priority (a foreground request finding a
        cold bucket meanwhile jumps the queue) and wait for the workers.
        Against a populated ``cache_dir`` the workers replay disk entries
        instead of full builds."""
        front, pf = self.bucketed, self.prefill_bucketed
        for extent in extents:
            front.submit_key(front.key_for_extents(extent),
                             args_fn=lambda e=extent: self._decode_example_args(e),
                             foreground=False)
        for extent, s_ext in cells:
            pf.submit_key(pf.key_for_extents((extent, s_ext)),
                          args_fn=lambda e=extent, s=s_ext: self._prefill_example_args(e, s),
                          foreground=False)
        self.compile_service.wait_idle()

    # -- group serving (jit, interpret and the contiguous forge fronts) ----

    @torch.no_grad()
    def prefill(self, prompts: np.ndarray):
        """Prefill the cache for a prompt group.

        Forge mode: the whole-prompt program of the group's grid cell
        when the policy and the ladder allow it, else the decode program
        replayed token by token; the state is bucket-shaped (the first
        ``B`` rows are the real requests).  Jit and interpret modes: token
        by token through the decode step (jit: the batch's compiled step
        and the cache it owns, reset first).  Returns ``(cache, next_tok,
        pos, step_fn, key)``, ``key`` the decode program's ShapeKey (None
        outside forge mode)."""
        if self.cfg.family == "encdec":
            raise NotImplementedError("use examples/ for enc-dec serving")
        if self.paged:
            raise NotImplementedError("paged KV serving is slot-scheduled: drive it "
                                      "through SlotScheduler.run")
        self._check_prompts(prompts)
        B, P = prompts.shape
        if self.mode == "forge":
            # the batch extent first: in async mode the sequence cell's
            # probe needs the batch rung the group runs on
            extent = self._bucket_extent(B)
            s_ext = (None if self.prefill_policy == "sequential"
                     else self._seq_bucket_extent(P, extent=extent))
            if s_ext is not None:
                return self._prefill_batched(prompts, s_ext, extent)
            return self._prefill_sequential(prompts, extent)
        tokens = torch.as_tensor(prompts, dtype=torch.int64, device=self.device)
        if self.mode == "jit":
            step = self.jit_step(B)
            cache = step.reset()
        else:
            step, cache = self.serve_step, self._build_cache(B)
        next_tok = None
        for i in range(P):
            next_tok, cache = step(self.params, cache, tokens[:, i:i + 1], i)
        self.last_prefill_mode = "sequential"
        return cache, next_tok, P, step, None

    def jit_step(self, batch: int) -> "JitServeStep":
        """The compiled step of a ``batch``-row group (``mode="jit"``),
        built at its first use."""
        step = self.jit_steps.get(batch)
        if step is None:
            step = self.jit_steps[batch] = JitServeStep(self, batch)
        return step

    def _group_step(self, mod, extent: int):
        """Adapt a slot-signature bucket program to the lockstep loop of
        :meth:`generate`: one scalar position broadcast to every row and
        an all-true slot mask (group admission is the slot schedule where
        every slot shares one request lifetime).  A lockstep program takes
        the position as a 0-d tensor."""
        if not self.slot_capable:
            def lockstep(params, cache, tok, pos):
                return mod(params, cache, tok,
                           torch.tensor(int(pos), dtype=torch.int32, device=self.device))

            return lockstep
        ones = torch.ones((extent,), dtype=torch.bool, device=self.device)

        def step(params, cache, tok, pos):
            pos_vec = torch.full((extent,), int(pos), dtype=torch.int32, device=self.device)
            return mod(params, cache, tok, pos_vec, ones)

        return step

    def _prefill_batched(self, prompts: np.ndarray, s_ext: int, extent: int):
        """Whole-prompt prefill on the (batch × sequence) grid cell.

        The prompt block is edge-padded on both axes; the cell's program
        folds it into a fresh cache in one dispatch (recurrent rows stop
        their scan at ``P`` through ``lengths``; padded rows are edge
        replicas), and the first token is read from the last real
        column's logits."""
        B, P = prompts.shape
        prompts_b = np.pad(prompts, ((0, extent - B), (0, s_ext - P)), mode="edge")
        cache = self._acquire_cache(extent)
        tokens = torch.as_tensor(prompts_b, dtype=torch.int32, device=self.device)
        pargs = self._prefill_args(extent, tokens, 0,
                                   lengths=np.full((extent,), P, np.int32))
        pmod, pkey, _ = self.prefill_bucketed.program_for(self.params, cache, *pargs)
        logits, cache = pmod(self.params, cache, *pargs)
        self.prefill_bucketed.stats.note_dispatch(pkey, (B, P), pkey.extents)
        tok = torch.argmax(logits[:, P - 1, :], dim=-1).to(torch.int32)[:, None]
        mod, key, _ = self.bucketed.program_for(self.params, cache,
                                                *self._decode_args(extent, tok, P))
        self.forge_module = mod
        self.last_prefill_mode = "chunked" if self.model.stateful_decode else "batched"
        return cache, tok, P, self._group_step(mod, extent), key

    def _prefill_sequential(self, prompts: np.ndarray, extent: int):
        """Token-at-a-time prefill through the decode bucket program."""
        B, P = prompts.shape
        prompts_b = np.pad(prompts, ((0, extent - B), (0, 0)), mode="edge")
        tokens = torch.as_tensor(prompts_b, dtype=torch.int32, device=self.device)
        cache = self._acquire_cache(extent)
        mod, key, _ = self.bucketed.program_for(self.params, cache,
                                                *self._decode_args(extent, tokens[:, :1], 0))
        self.forge_module = mod
        step = self._group_step(mod, extent)
        next_tok = None
        for i in range(P):
            next_tok, cache = step(self.params, cache, tokens[:, i:i + 1], i)
            self.bucketed.stats.note_dispatch(key, B, extent)
        self.last_prefill_mode = "sequential"
        return cache, next_tok, P, step, key

    def prefill_compiles(self) -> int:
        """Programs the prefill front compiled (0 without one)."""
        return 0 if self.prefill_bucketed is None else self.prefill_bucketed.stats.compiles

    def _compile_s_total(self) -> float:
        """Compile seconds accumulated: Phases 1-4 across both forge
        fronts, or the jit steps' builds."""
        return (sum(f.stats.compile_s for f in (self.bucketed, self.prefill_bucketed)
                    if f is not None)
                + sum(j.compile_s for j in self.jit_steps.values()))

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, n_new: int) -> Dict[str, Any]:
        B, P = prompts.shape
        if P + n_new - 1 > self.max_len:
            raise RequestError(f"prompt {P} + {n_new} new tokens exceed max_len "
                               f"{self.max_len}")
        compile_s0 = self._compile_s_total()
        t0 = time.perf_counter()
        cache, tok, pos0, step, key = self.prefill(prompts)
        _sync(self.device)  # TTFT: the first token is real here
        t_prefill = time.perf_counter() - t0
        out: List[torch.Tensor] = [tok]
        lat: List[float] = []
        try:
            for i in range(n_new - 1):
                t1 = time.perf_counter()
                tok, cache = step(self.params, cache, tok, pos0 + i)
                _sync(self.device)
                lat.append(time.perf_counter() - t1)
                out.append(tok)
                if key is not None:
                    self.bucketed.stats.note_dispatch(key, B, tok.shape[0])
        finally:
            # park the bucket-sized cache even after a failed step: the
            # reset at its next acquisition makes any state reusable
            if key is not None:
                self._release_cache(key.extent, cache)
        # slice the bucket's padded rows off the emitted token stream
        toks = torch.cat(out, dim=1)[:B].cpu().numpy().astype(np.int32)
        lat_ms = np.asarray(lat) * 1e3
        return {
            "tokens": toks,
            "prefill_s": t_prefill,
            "ttft_s": t_prefill,  # time to first token (prefill wall)
            "prefill_mode": self.last_prefill_mode,
            "compile_s": self._compile_s_total() - compile_s0,  # Phase 1-4 in this call
            "decode_ms_mean": float(lat_ms.mean()) if len(lat_ms) else 0.0,
            "decode_ms_p50": float(np.percentile(lat_ms, 50)) if len(lat_ms) else 0.0,
            "decode_ms_p99": float(np.percentile(lat_ms, 99)) if len(lat_ms) else 0.0,
            "tok_per_s": B * max(len(lat), 1) / max(sum(lat), 1e-9),
        }

    def run_workload(self, groups: Sequence[np.ndarray], n_new: int
                     ) -> List[Dict[str, Any]]:
        """Serve a FIFO stream of request groups, one group at a time.

        Error isolation: a group that fails completes with a typed error
        outcome (``{"error", "error_type"}``) instead of killing the
        stream; the remaining groups are still served.
        """
        out: List[Dict[str, Any]] = []
        for g in groups:
            try:
                out.append(self.generate(np.asarray(g), n_new))
            except Exception as e:  # noqa: BLE001 — isolation boundary
                kind = ("RequestError" if isinstance(e, (RequestError, ValueError,
                                                         TypeError))
                        else "SystemError")
                out.append({"tokens": np.zeros((0, 0), np.int32), "error": str(e),
                            "error_type": kind})
                if self.bucketed is not None:
                    self.bucketed.stats.note_fault(request_failed=True)
        return out


class JitServeStep:
    """``mode="jit"``: the serve step compiled whole for one batch size.

    ``torch.compile(fullgraph=True, dynamic=False)`` of the step
    ``mode="interpret"`` runs (``make_serve_step``, its last-position
    logits kept as a second output: :meth:`last_logits`), which writes
    its new cache into the cache it was given (``copy_``): the
    counterpart of the JAX server's ``jax.jit(serve_step,
    donate_argnums=(1,))``.  The step owns that cache (:attr:`cache`;
    :meth:`reset` puts its init values back in place), so no step
    allocates a cache and its storage never moves.  Inductor rounds where
    the op-by-op step rounds (``emulate_precision_casts``), but its
    reductions and transcendentals are its own: in bf16 a greedy token
    can part from ``interpret``'s at a near-tie.  The block bodies
    compile once eagerly first (a traced call finds them compiled);
    ``fullgraph=True`` makes a graph break an error, never a quiet eager
    fallback.  Positions enter as a tensor, so one graph serves every
    position.

    On the card the compiled step runs as one CUDA graph (what
    ``torch.compile``'s ``mode="reduce-overhead"`` adds), captured here so
    that the kernels' launches are recorded at capture and added at each
    replay (``_build.recording``), and the warm runs and the capture share
    a side stream and a kernel-scratch scope of their own; each call
    copies the token and the position into the graph's inputs, replays
    it and clones the token out (the next replay overwrites it).

    ``graphs`` counts the graphs Dynamo handed to Inductor (1 unless a
    guard failed), ``kernel_nodes`` the kernel custom-op nodes in them,
    ``compile_s`` the seconds of priming, compiling and capturing
    (``compile_split`` divides them).
    """

    def __init__(self, server: "BatchedServer", batch: int):
        self.device = server.device
        self.batch = int(batch)
        self.serve_step = make_serve_step(server.cfg, impl=server.impl, logits=True)
        self._init_cache = lambda: server._build_cache(self.batch)
        self.cache = self._init_cache()
        self.graphs = 0
        self.graph_nodes = 0
        self.kernel_nodes: Dict[str, int] = {}
        self.compile_s = 0.0
        #: seconds of the build: the eager step (the block bodies'
        #: compiles), Dynamo's trace, Inductor, and the rest (Triton's
        #: lazy kernel loads, the warm runs and the CUDA graph capture)
        self.compile_split: Dict[str, float] = {}
        self.calls = 0
        self._fn = None
        self._t_trace = 0.0  # when the first traced call started
        #: the step's own token column and position (filled per call)
        self._tok: Optional[torch.Tensor] = None
        self._pos: Optional[torch.Tensor] = None
        #: the CUDA graph, its outputs and its recorded launches (the card)
        self._replay = None
        #: the latest step's logits (in the graph's pool on the card)
        self._logits: Optional[torch.Tensor] = None

    def reset(self):
        """The owned cache, set back to its init values in place."""
        for dst, src in zip(pytree.tree_leaves(self.cache),
                            pytree.tree_leaves(self._init_cache())):
            dst.copy_(src)
        return self.cache

    def _step(self, params, cache, tok, pos):
        next_tok, new_cache, logits = self.serve_step(params, cache, tok, pos)
        for dst, src in zip(pytree.tree_leaves(cache), pytree.tree_leaves(new_cache)):
            dst.copy_(src)
        return next_tok, logits

    def last_logits(self) -> torch.Tensor:
        """The most recent step's last-position logits (B, vocab), a copy."""
        if self._logits is None:
            raise RuntimeError("the jit step has not run")
        return self._logits.clone()

    def _backend(self, gm: torch.fx.GraphModule, example_inputs):
        from torch._inductor.compile_fx import compile_fx

        t0 = time.perf_counter()
        self.compile_split["trace"] = self.compile_split.get("trace", 0.0) + t0 - self._t_trace
        self.graphs += 1
        self.graph_nodes += len(gm.graph.nodes)
        for node in gm.graph.nodes:
            name = str(node.target)
            if node.op == "call_function" and name.startswith("repro_torch."):
                op = name.split(".")[1]
                self.kernel_nodes[op] = self.kernel_nodes.get(op, 0) + 1
        with torch._inductor.config.patch(emulate_precision_casts=True):
            out = compile_fx(gm, example_inputs)
        self.compile_split["inductor"] = (self.compile_split.get("inductor", 0.0)
                                          + time.perf_counter() - t0)
        return out

    def _build(self, params) -> None:
        t0 = time.perf_counter()
        # the build runs the step more than once on the first token: a
        # K/V write is idempotent, a recurrent state's update is not, so
        # the cache is put back as it was before the call runs the step
        leaves = pytree.tree_leaves(self.cache)
        saved = [t.clone() for t in leaves]
        # the eager step compiles the Forge block bodies the trace finds
        self.serve_step(params, self.cache, self._tok, self._pos)
        self.compile_split["eager"] = time.perf_counter() - t0
        fn = torch.compile(self._step, fullgraph=True, dynamic=False, backend=self._backend)
        self._t_trace = time.perf_counter()
        if self.device.type == "cuda":
            self._capture(fn, params)
        else:  # compiles
            fn(params, self.cache, self._tok, self._pos)
        for dst, src in zip(leaves, saved):
            dst.copy_(src)
        self._fn = fn  # only a step that built and captured serves
        self.compile_s += time.perf_counter() - t0
        split = self.compile_split
        split["rest"] = self.compile_s - split["eager"] - split["trace"] - split["inductor"]

    def _capture(self, fn, params) -> None:
        from ..core.backends.segment_jit import capture_graph, capture_scope, count_capture

        t0 = time.perf_counter()
        with capture_scope(self.device, id(self)) as stream:
            # warm runs: Inductor's kernels load, the kernels' libraries
            # and per-stream scratch exist before the capture
            for _ in range(2):
                fn(params, self.cache, self._tok, self._pos)
            stream.synchronize()
            self._replay = capture_graph(lambda: fn(params, self.cache, self._tok, self._pos))
        count_capture(1, time.perf_counter() - t0)

    def __call__(self, params, cache, tok: torch.Tensor, pos):
        """``(next_tok, cache)`` after one step; ``cache`` must be the
        owned one (it is updated in place and returned).  ``tok`` and
        ``pos`` are copied into the step's own input tensors, so every
        call meets the graph's guards (no recompile for a strided token
        column or another integer type)."""
        if cache is not self.cache:
            raise ValueError("a jit step updates the cache it owns: pass JitServeStep.cache")
        if self._tok is None:
            self._tok = torch.zeros((self.batch, 1), dtype=torch.int64, device=self.device)
            self._pos = torch.zeros((), dtype=torch.int64, device=self.device)
        self._tok.copy_(tok)
        if isinstance(pos, torch.Tensor):
            self._pos.copy_(pos)
        else:
            self._pos.fill_(int(pos))
        if self._fn is None:
            self._build(params)
        self.calls += 1
        if self._replay is None:
            next_tok, self._logits = self._fn(params, cache, self._tok, self._pos)
            return next_tok, cache
        from ..kernels import _build

        graph, (next_tok, self._logits), launches = self._replay
        graph.replay()
        if launches:
            _build.add_launches(launches)
        return next_tok.clone(), cache


# --------------------------------------------------------------------------
# slot-level continuous batching (paged KV pool or contiguous cache)
# --------------------------------------------------------------------------


@dataclass
class Request:
    """One generation request (the slot scheduler's admission unit)."""

    rid: int
    prompt: np.ndarray  # (P,) int32
    max_new: int  # tokens to emit (the first comes from the prompt's last logits)
    arrival: int = 0  # decode-step tick at which the request may be admitted
    # -- SLO fields (DESIGN.md §SLO-aware scheduling) ----------------------
    #: open-loop arrival offset in seconds from the run's start; when every
    #: request sets it the run clocks arrivals and budgets against the wall
    arrival_s: Optional[float] = None
    #: time-to-first-token budget: admission is EDF-ordered by
    #: ``arrival + ttft_budget_s``, and a request whose deadline passed
    #: while it queued is shed with a typed RequestError (None: no deadline)
    ttft_budget_s: Optional[float] = None
    #: end-to-end budget: a slot running past it becomes a preemption
    #: victim under queue pressure (None: no budget)
    latency_budget_s: Optional[float] = None
    #: higher wins: an arrival may preempt (park) a running slot of
    #: strictly lower priority when no slot is free
    priority: int = 0


@dataclass
class _Slot:
    """Mutable per-slot serving state (one bucket row)."""

    req: Request
    pos: int = 0  # next cache write position == tokens consumed so far
    #: prompt tokens still to consume through masked decode replay (the
    #: fill path); None once the prompt is in the cache
    fill: Optional[np.ndarray] = None
    remaining: int = 0  # decode steps left after the first emitted token
    cur_tok: int = 0  # last emitted token (next decode input)
    tokens: List[int] = field(default_factory=list)
    admitted_tick: int = 0
    #: tick at which the fill path emitted the first token (None: the
    #: admission prefill emitted it at admitted_tick)
    first_tick: Optional[int] = None
    swapped_in: bool = False  # admitted while other slots were mid-generation
    #: page-pool pages this slot references (freed at retire; shared
    #: prefix pages survive on the prefix tree's own references)
    pages: List[int] = field(default_factory=list)
    #: prompt tokens whose prefill was skipped via shared-prefix pages
    skip: int = 0
    #: the row emitted POISON_TOKEN (non-finite logits): quarantined at the
    #: next boundary with a typed error
    poisoned: bool = False
    #: wall clock of the request's arrival (the TTFT / latency origin)
    arrival_wall: float = 0.0
    #: wall clock at which the first token reached the host
    first_wall: Optional[float] = None
    #: times this slot was preempted (KV parked) and later resumed
    preempted: int = 0


class SlotScheduler:
    """Slot-level continuous batching over a ``mode="forge"``
    :class:`BatchedServer`.

    A request queue, per-slot state (position, remaining budget) and one
    decode dispatch per tick advancing every active slot at its own
    position (``pos: int32[B]`` + ``slot_mask: bool[B]`` through the
    bucket program).  When a slot finishes, the next queued request is
    swapped in mid-generation; every other slot's state stays untouched.

    * Paged server (``paged=True``): the prompt is matched against the
      prefix tree, pages are allocated for the prompt and budget, its
      page-table row is written and its (suffix) prompt prefilled through
      the slot-masked prefill grid in one dispatch.  A prompt the grid
      does not cover (or, async, with no warm cell) takes the fill path:
      no prefix match, no prefill; the decode loop replays the prompt
      through the paged decode program, which writes each token's K/V
      through the table.  A rung resize edits the page table; no KV moves.
    * Contiguous server: a swapped-in row of a stateful family is first
      reset to ``init_cache`` values (:meth:`_reset_rows`; a dense row's
      old keys need no reset: the per-row length mask hides every slot
      past the new request's position until it is rewritten), then every
      admitted prompt is prefilled through the slot-masked grid in one
      dispatch with per-row ``length`` (:meth:`_admit`).  A prompt the
      grid does not cover, or every prompt under ``prefill="sequential"``,
      takes the fill path while the other slots keep generating.  A rung
      resize gathers the active rows into a fresh cache of the new bucket
      (:meth:`_gather_rows`).

    Admission is pad-waste-aware: queued requests fill the bucket exactly,
    and the bucket is resized only when the active-slot count crosses a
    rung.  With every rung and grid cell warmed, scheduling runs zero
    Phase 1-4 compiles.  The clock is the decode-dispatch counter
    (``tick``); ``Request.arrival`` is in ticks, unless every request sets
    ``arrival_s`` (open-loop wall-clock mode).

    Async compile (``BatchedServer(async_compile=True)``): a cold rung
    compiles in the background while the tick runs on a warm rung
    (:meth:`_target_rung`, counted in ``warm_fallbacks``).

    Fault tolerance (DESIGN.md §Fault tolerance; sites in
    ``runtime/chaos.py``).  Every tick runs inside containment:

    * a failed decode dispatch is retried in the tick up to
      ``max_dispatch_retries`` times: the programs read the cache and the
      page store and return new ones (``segment_jit`` copies inputs in and
      outputs out), so a call that failed after segment *k* left the
      caller's state untouched;
    * a row whose logits are non-finite emits ``POISON_TOKEN`` and is
      quarantined with a typed error; the other rows' tokens stay bitwise;
    * a failed contiguous prefill falls back to the fill path (the rows
      are the slot's own); a failed paged prefill undoes the admission
      (frees the rows' page refs, vacates, requeues), because prefix-hit
      rows hold shared pages a replay from position 0 would overwrite;
    * a tick that still fails, or one that runs past ``tick_deadline_s``
      (timed to a device sync: the watchdog never times the enqueue
      alone), enters degraded mode for ``degraded_cooldown`` ticks:
      admissions are shed while anything is active and rung selection is
      pinned to warm programs;
    * after ``max_consec_failures`` consecutive failed ticks the run
      aborts, and every live, queued and parked request ends with a typed
      ``SystemError`` outcome: the loop returns, it never hangs, and page
      and slot accounting are left clean.

    SLO scheduling (``slo=True``, DESIGN.md §SLO-aware scheduling):
    admission is EDF-ordered by ``(arrival + ttft_budget, -priority,
    arrival, rid)``, which is arrival order when no request sets a budget
    or a priority, so the default is backwards compatible; a queued
    request whose TTFT deadline passed is shed; under EDF overflow a
    mid-decode slot of strictly lower priority, or past its own latency
    budget, is preempted: its KV is parked (the paged pool's parked
    registry and a trash table row; the contiguous row gathered into the
    bucket :class:`~repro_torch.core.BufferPool` under ``("parked",
    rid)``) and resumed later with no replay, so its tokens are bitwise
    an unpreempted run's.  Resumes and admissions compete in one EDF
    order.  ``slo=False`` is the throughput-only FIFO baseline.

    Ladder re-fit (``refit_interval`` ticks): :meth:`refit` fits the
    decode ladder to the recent batch extents.
    """

    def __init__(self, server: BatchedServer, max_slots: int = 16, *,
                 max_dispatch_retries: int = 2, degraded_cooldown: int = 8,
                 max_consec_failures: int = 6, tick_deadline_s: Optional[float] = None,
                 slo: bool = True, refit_interval: int = 0, refit_max_rungs: int = 4,
                 refit_max_programs: Optional[int] = None):
        if server.mode != "forge":
            raise ValueError("SlotScheduler needs BatchedServer(mode='forge')")
        if not server.slot_capable:
            raise ValueError(f"family {server.cfg.family!r} has no slot-level decode")
        server._ensure_bucketed()
        self.server = server
        self.paged = server.paged
        self.max_slots = int(max_slots)
        # raises if the ladder cannot admit the slot cap
        self.top_extent = server.bucketed.policy.bucket(self.max_slots)
        #: one-row init_cache template for stateful-decode swap-ins (built
        #: lazily; KV-only families never need it)
        self._init_row = None
        #: re-dispatches of one tick before the failure escalates
        self.max_dispatch_retries = int(max_dispatch_retries)
        #: ticks of degraded mode after a tick failure or a watchdog trip
        self.degraded_cooldown = int(degraded_cooldown)
        #: consecutive failed ticks before the run aborts
        self.max_consec_failures = int(max_consec_failures)
        #: per-tick wall deadline of the watchdog (None: off)
        self.tick_deadline_s = tick_deadline_s
        #: degraded-mode flag read by _target_rung (pin to warm rungs)
        self._degraded = False
        self.slo = bool(slo)
        #: re-fit the decode ladder every this many ticks (0: off)
        self.refit_interval = int(refit_interval)
        self.refit_max_rungs = int(refit_max_rungs)
        #: program-table budget handed to evict_cold after a re-fit
        #: (default: one more than the proposed rung count)
        self.refit_max_programs = refit_max_programs
        self.metrics: Dict[str, Any] = {}
        self._reset_metrics()

    def _reset_metrics(self) -> None:
        self.metrics = {
            "decode_dispatches": 0,
            "occupied_row_steps": 0,
            "capacity_row_steps": 0,
            "prefill_dispatches": 0,
            "swaps": 0,
            "resizes": 0,
            "idle_ticks": 0,
            #: admissions bounced back to the queue because the page pool
            #: was exhausted even after LRU prefix-tree reclaim
            "deferrals": 0,
            #: boundaries that ran a warm rung while the exact rung
            #: compiled in the background (async compile)
            "warm_fallbacks": 0,
            # -- fault tolerance ------------------------------------------
            #: requests rejected at validation with a typed RequestError
            "requests_rejected": 0,
            #: requests that ended with any typed error outcome
            "requests_failed": 0,
            #: slot rows quarantined by the non-finite logits tripwire
            "rows_quarantined": 0,
            #: tick dispatches re-run after a contained dispatch fault
            "dispatch_retries": 0,
            #: ticks whose body failed past the dispatch-retry budget
            "tick_failures": 0,
            #: ticks served in degraded mode
            "ticks_degraded": 0,
            #: admission prefills that failed and were contained
            "admission_failures": 0,
            #: ticks that ran past tick_deadline_s
            "watchdog_trips": 0,
            #: faults the installed FaultPlan fired during this run
            "faults_injected": 0,
            #: the run hit max_consec_failures and failed what was left
            "aborted": False,
            # -- SLO-aware scheduling -------------------------------------
            #: slots preempted (KV parked) for higher-priority or
            #: tighter-deadline arrivals
            "preemptions": 0,
            #: parked slots swapped back in
            "resumes": 0,
            #: queued requests shed because their TTFT deadline passed
            "shed": 0,
            #: ladder re-fits applied from the recency trail
            "refits": 0,
            #: bucket programs retired by evict_cold after a re-fit
            "refit_evictions": 0,
        }

    def rungs(self) -> List[int]:
        """Every bucket extent the scheduler can resize through."""
        policy = self.server.bucketed.policy
        return sorted({policy.bucket(n) for n in range(1, self.max_slots + 1)})

    def warmup(self, prompt_lens: Optional[Sequence[int]] = None) -> float:
        """Precompile every reachable rung (and prefill grid cells)."""
        return self.server.warmup(self.rungs(), prompt_lens=prompt_lens)

    def refit(self) -> Optional[tuple]:
        """Re-fit the decode bucket ladder to the observed batch sizes.

        :func:`~repro_torch.core.shapekey.propose_rungs` over the decode
        front's ``recent_extents`` (capped so the top rung still admits
        ``max_slots``), installed with ``BucketedModule.refit_policy``
        (the policy name pinned: same-extent programs, pools and cache
        entries stay addressable).  With async compile, each cold new
        rung is submitted speculatively; then ``evict_cold`` retires the
        programs beyond ``refit_max_programs`` (the serving rung is the
        most recently dispatched, so it stays).  Returns the installed
        rungs, or None when the trail is empty or already fits."""
        from ..core.shapekey import LadderPolicy, propose_rungs

        srv = self.server
        front = srv.bucketed
        observed = [t[0] for t in list(front.stats.recent_extents)]
        if not observed:
            return None
        rungs = propose_rungs(observed, self.refit_max_rungs, cap=self.max_slots)
        old = front.policy
        if isinstance(old, LadderPolicy) and tuple(old.rungs) == rungs:
            return None
        front.refit_policy(LadderPolicy(rungs=rungs))
        self.top_extent = front.policy.bucket(self.max_slots)
        self.metrics["refits"] += 1
        if srv.async_compile and srv.compile_service is not None:
            # speculative: warm the new rungs off the request path
            for r in rungs:
                k = front.key_for_extents(r)
                if front.lookup_program(k) is None:
                    front.submit_key(k, args_fn=lambda e=r: srv._decode_example_args(e),
                                     foreground=False)
        budget = (self.refit_max_programs if self.refit_max_programs is not None
                  else len(rungs) + 1)
        evicted = front.evict_cold(budget)
        self.metrics["refit_evictions"] += len(evicted)
        return rungs

    def _target_rung(self, exact: int) -> int:
        """Rung selection at a scheduling boundary.

        Degraded mode: the exact rung when warm, else the smallest warm
        rung that dominates it, else the largest warm rung: no compile,
        inline or background, starts while the loop recovers.  Inline:
        the exact rung (resolving its program compiles it at the
        boundary, stalling the tick).  Async: a cold exact rung compiles
        in the background while this tick runs on the smallest warm rung
        that dominates it; once the exact program lands, a later boundary
        picks it.  When no warm rung dominates (growth past the warm top)
        the tick serves what fits in the largest warm rung — the excess
        requests stay queued — and only the very first rung, with nothing
        warm at all, blocks.
        """
        srv = self.server
        front = srv.bucketed
        if self._degraded:
            if front.lookup_program(front.key_for_extents(exact)) is not None:
                return exact
            warm = [k.extents[0] for k in front.warm_keys()]
            dominating = [w for w in warm if w >= exact]
            if dominating:
                return min(dominating)
            if warm:
                return max(warm)
            # nothing warm at all: no choice but the normal path
        if not srv.async_compile:
            return exact
        key = front.key_for_extents(exact)
        if front.lookup_program(key) is not None:
            return exact
        fut = front.submit_key(key, args_fn=lambda e=exact: srv._decode_example_args(e),
                               foreground=True)
        warm = [k.extents[0] for k in front.warm_keys()]
        dominating = [w for w in warm if w >= exact]
        if dominating:
            target = min(dominating)
            front.stats.note_fallback(target - exact)
        elif warm:
            # capacity-capped: no pad premium, the rung is smaller
            target = max(warm)
            front.stats.note_fallback(0)
        else:
            t0 = time.perf_counter()
            srv.compile_service.result(fut)
            front.stats.note_wait(time.perf_counter() - t0)
            return exact
        self.metrics["warm_fallbacks"] += 1
        return target

    def _gather_rows(self, old_cache, new_cache, src_rows: List[int]):
        """Move the active slots' contiguous cache rows into the new
        bucket's cache: row ``src_rows[j]`` of every batch-polymorphic leaf
        lands in row ``j``; the other rows keep the new cache's init
        values.  The new cache was just acquired for this resize (built or
        reset), so the copy writes into it in place."""
        srv = self.server
        flat_old, _ = pytree.tree_flatten(old_cache)
        flat_new, spec = pytree.tree_flatten(new_cache)
        src = torch.as_tensor(src_rows, dtype=torch.long, device=srv.device)
        for o, nw, ax in zip(flat_old, flat_new, flatten_axes(srv.cache_axes, old_cache)):
            if ax is not None:
                nw.narrow(ax, 0, len(src_rows)).copy_(torch.index_select(o, ax, src))
        return pytree.tree_unflatten(flat_new, spec)

    def _reset_rows(self, cache, rows: List[int], extent: int):
        """Re-initialize the admitted rows of a stateful-decode cache.

        Recurrent states fold every past token in: without this reset a
        swapped-in request would continue the PREVIOUS occupant's state.
        Blends the one-row ``init_cache`` template into the admitted rows
        only (a ``torch.where`` select), so every other slot's state
        survives bitwise."""
        srv = self.server
        if self._init_row is None:
            self._init_row = srv.model.init_cache(srv.cfg, 1, srv.max_len, device=srv.device)
        mask = torch.zeros((extent,), dtype=torch.bool, device=srv.device)
        mask[rows] = True
        flat, spec = pytree.tree_flatten(cache)
        flat_init, _ = pytree.tree_flatten(self._init_row)
        out = []
        for leaf, ini, ax in zip(flat, flat_init, flatten_axes(srv.cache_axes, cache)):
            if ax is None:
                out.append(leaf)
                continue
            shape = [1] * leaf.dim()
            shape[ax] = extent
            out.append(torch.where(mask.view(shape), ini, leaf))  # ini broadcasts (1 at ax)
        return pytree.tree_unflatten(out, spec)

    def _validate(self, r: Request) -> Optional[str]:
        """Admission-time validation; a non-None return rejects the request
        with a typed RequestError outcome instead of failing the run."""
        srv = self.server
        try:
            plen = len(r.prompt)
        except TypeError:
            return "prompt must be an array of token ids"
        if plen < 1:
            return "prompt must be non-empty"
        if r.max_new < 1:
            return "max_new must be >= 1"
        if plen + r.max_new > srv.max_len:
            return f"prompt {plen} + budget {r.max_new} exceeds max_len={srv.max_len}"
        if self.paged:
            need = pages_for(plen + r.max_new, srv.page_pool.page_size)
            if need > srv.page_pool.capacity:
                return f"needs {need} KV pages, pool capacity is {srv.page_pool.capacity}"
        if r.ttft_budget_s is not None and r.ttft_budget_s <= 0:
            return "ttft_budget_s must be > 0"
        if r.latency_budget_s is not None and r.latency_budget_s <= 0:
            return "latency_budget_s must be > 0"
        if np.min(r.prompt) < 0 or np.max(r.prompt) >= srv.cfg.vocab:
            return "prompt token ids out of vocabulary range"
        return None

    @torch.no_grad()
    def run(self, requests: Sequence[Request]) -> Dict[str, Any]:
        """Serve ``requests`` to completion; returns results + metrics.

        The clock is the decode-dispatch counter (``tick``): a tick with
        no runnable slot fast-forwards to the next arrival.  When every
        request sets ``arrival_s`` the run is open-loop: arrivals are
        clocked against the wall (seconds since the run's start), which
        is what TTFT and latency budgets are measured against.  A TTFT or
        a latency is stamped when its token has reached the host.
        """
        srv = self.server
        params = srv.params
        dev = srv.device
        paged = self.paged
        stats = srv.bucketed.stats
        self._reset_metrics()
        compiles0 = stats.compiles + srv.prefill_compiles()
        results: Dict[int, Dict[str, Any]] = {}
        plan = chaos.current_plan()
        faults0 = plan.faults_injected if plan is not None else 0

        def fail_request(req: Request, why: str, kind: str = "RequestError") -> None:
            """Terminate an un-admitted request with a typed outcome."""
            results[req.rid] = {"tokens": np.zeros((0,), np.int32), "admitted_tick": -1,
                                "finished_tick": -1, "swapped_in": False, "error": why,
                                "error_type": kind}
            stats.note_fault(request_failed=True)
            self.metrics["requests_failed"] += 1

        valid: List[Request] = []
        for r in requests:
            why = self._validate(r)
            if why is not None:
                fail_request(r, why)
                self.metrics["requests_rejected"] += 1
            else:
                valid.append(r)
        n_requests = len(valid)

        pool = srv.page_pool
        MP = srv.max_pages_per_slot
        #: host-side page table (extent, MP); the device copy is refreshed
        #: at resize/admission boundaries — retired rows go stale on the
        #: device, which is inert (their mask is False, writes go to trash)
        pt_host = np.full((0, MP), TRASH_PAGE, np.int32)
        pt_dev = None
        #: open-loop wall-clock arrivals iff every request carries one
        wall_mode = bool(valid) and all(r.arrival_s is not None for r in valid)
        pendreq = deque(sorted(valid, key=(lambda r: (r.arrival_s, r.rid)) if wall_mode
                               else (lambda r: (r.arrival, r.rid))))
        queue: deque = deque()
        #: preempted slots awaiting resume, by rid; their KV lives in the
        #: page pool's parked registry (paged) or the bucket BufferPool
        #: under ("parked", rid) (contiguous)
        parked: Dict[int, _Slot] = {}
        #: wall clock of each request's arrival (the TTFT / latency origin)
        arr_wall: Dict[int, float] = {}
        slots: List[Optional[_Slot]] = []
        extent = 0
        #: the paged store (server-resident), or the contiguous cache of
        #: the current rung (built at the first rung)
        cache = srv.page_store if paged else None
        mod = key = None
        cur_tok = np.zeros((0, 1), np.int32)
        cur_pos = np.zeros((0,), np.int32)
        tick = 0
        #: device-resident (tok, pos, mask) for the steady-state fast path;
        #: None whenever host state changed since the last dispatch
        dev_args = None
        #: token columns not yet copied to the host: steady-state ticks
        #: defer the device-to-host sync to the next boundary (harvest)
        pending: List[torch.Tensor] = []
        #: per-tick host wall seconds (admission + resize + dispatch)
        tick_s: List[float] = []
        t0 = time.perf_counter()

        def to_dev(a: np.ndarray) -> torch.Tensor:
            # a copy on the CPU too: the host arrays are edited later
            # (a retired row's table goes to trash), which must not reach
            # the tensors the device already holds, as on the card
            return torch.from_numpy(np.array(a)).to(dev)

        def active_count() -> int:
            return sum(s is not None for s in slots)

        def req_arrival_wall(req: Request) -> float:
            """Wall clock at which ``req`` arrived: its scheduled offset in
            wall mode, else the moment the tick clock surfaced it."""
            if req.rid in arr_wall:
                return arr_wall[req.rid]
            return t0 + (req.arrival_s or 0.0) if wall_mode else t0

        def ttft_deadline(req: Request) -> float:
            if req.ttft_budget_s is None:
                return float("inf")
            return req_arrival_wall(req) + req.ttft_budget_s

        def edf_key(req: Request):
            """Earliest deadline first, priority tiebreak; with no budgets
            and priorities this is arrival order."""
            arrival = (req.arrival_s or 0.0) if wall_mode else req.arrival
            return (ttft_deadline(req), -req.priority, arrival, req.rid)

        def resolve_program():
            nonlocal mod, key
            args = (to_dev(cur_tok), to_dev(cur_pos),
                    torch.zeros((extent,), dtype=torch.bool, device=dev))
            if paged:
                args = (to_dev(pt_host),) + args
            mod, key, _ = srv.bucketed.program_for(params, cache, *args)
            srv.forge_module = mod

        def entry_of(s: _Slot, now: float) -> Dict[str, Any]:
            return {
                "tokens": np.asarray(s.tokens, np.int32),
                "admitted_tick": s.admitted_tick,
                "finished_tick": tick,
                "swapped_in": s.swapped_in,
                "preempted": s.preempted,
                "priority": s.req.priority,
                "ttft_ticks": (s.admitted_tick if s.first_tick is None else s.first_tick)
                - s.req.arrival,
                "ttft_s": s.first_wall - s.arrival_wall if s.first_wall is not None else None,
                "latency_s": now - s.arrival_wall,
            }

        def retire(i: int, s: _Slot, error: Optional[str] = None,
                   error_type: str = "RequestError") -> None:
            entry = entry_of(s, time.perf_counter())
            if error is not None:
                entry["error"] = error
                entry["error_type"] = error_type
                stats.note_fault(request_failed=True)
                self.metrics["requests_failed"] += 1
            results[s.req.rid] = entry
            slots[i] = None
            if s.pages:
                # the slot's refs drop; pages shared through the prefix
                # tree stay live on the tree's own refs
                pool.free(s.pages)
                s.pages = []
                pt_host[i, :] = TRASH_PAGE

        def quarantine(i: int, s: _Slot) -> None:
            """The row's logits went non-finite: a typed error, tokens up
            to the last finite one; every other row is untouched."""
            self.metrics["rows_quarantined"] += 1
            retire(i, s, error="non-finite logits in decode row (quarantined)")

        def emit(s: _Slot, t: int) -> bool:
            """Append a decode output to the slot's stream; False (and the
            slot flagged) when it is POISON_TOKEN."""
            if t == POISON_TOKEN:
                s.poisoned = True
                return False
            s.cur_tok = t
            s.tokens.append(t)
            if s.first_wall is None:
                s.first_wall = time.perf_counter()
            return True

        def harvest() -> None:
            """Copy the deferred token columns to the host, in tick order
            (one sync).  The active set cannot have changed while ticks
            were pending (any change is a boundary that harvests first).
            A row that emitted POISON_TOKEN stops there and is
            quarantined."""
            nonlocal dev_args
            if not pending:
                return
            cols = torch.cat(pending, dim=1).cpu().numpy()
            pending.clear()
            rows = [i for i, s in enumerate(slots) if s is not None]
            for c in range(cols.shape[1]):
                for i in rows:
                    if not slots[i].poisoned:
                        emit(slots[i], int(cols[i, c]))
            for i in rows:
                s = slots[i]
                if s is not None and s.poisoned:
                    quarantine(i, s)
                    dev_args = None  # the active set shrank: rebuild the mask

        def park_slot(i: int, s: _Slot) -> None:
            """Preempt a mid-decode slot by parking its KV: the paged chain
            keeps its refcounts in the pool's parked registry and the table
            row is trashed (no KV moves); the contiguous row is gathered
            into a one-row tree that owns its storage and parked in the
            bucket pool.  The fault site fires before any state moves, so
            an injected fault is an ordinary tick failure."""
            nonlocal cache, dev_args, pt_dev
            chaos.maybe_fault(chaos.SITE_PREEMPT)
            rid = s.req.rid
            if paged:
                pool.park(rid, s.pages)
                pt_host[i, :] = TRASH_PAGE
                pt_dev = to_dev(pt_host)
            else:
                srv.bucketed.pool.release(("parked", rid),
                                          gather_cache_rows(cache, srv.cache_axes, [i]))
            s.preempted += 1
            parked[rid] = s
            slots[i] = None
            dev_args = None
            self.metrics["preemptions"] += 1

        def resume_slot(i: int, s: _Slot) -> None:
            """Swap a parked slot back in (a table row write, or a masked
            row blend) and restore its host decode state.  No prefill: the
            KV is what the slot parked, and decode is row- and
            extent-invariant, so its tokens are an unpreempted run's."""
            nonlocal cache, dev_args, pt_dev
            rid = s.req.rid
            parked.pop(rid)
            if paged:
                s.pages = pool.unpark(rid)
                pt_host[i] = build_row_table(s.pages, MP)
                pt_dev = to_dev(pt_host)
            else:
                def missing():
                    raise SystemError_(f"parked rows for rid {rid} missing from pool")

                row = srv.bucketed.pool.acquire(("parked", rid), missing)
                srv.bucketed.pool.drop(("parked", rid))
                cache = blend_cache_rows(cache, srv.cache_axes, row, [i])
            slots[i] = s
            cur_tok[i, 0] = s.cur_tok
            cur_pos[i] = s.pos
            dev_args = None
            self.metrics["resumes"] += 1

        def abort_run(err: BaseException) -> None:
            """Containment exhausted: every live, parked, queued and
            pending request ends with a typed SystemError outcome."""
            why = (f"serving loop aborted after {self.max_consec_failures} consecutive "
                   f"tick failures: {err}")
            for i, s in enumerate(slots):
                if s is not None:
                    retire(i, s, error=why, error_type="SystemError")
            # parked slots release their KV and keep the tokens they made
            for rid, s in list(parked.items()):
                if paged:
                    pool.unpark(rid)
                    if s.pages:
                        pool.free(s.pages)
                        s.pages = []
                else:
                    srv.bucketed.pool.drop(("parked", rid))
                entry = entry_of(s, time.perf_counter())
                entry.update(error=why, error_type="SystemError")
                results[rid] = entry
                stats.note_fault(request_failed=True)
                self.metrics["requests_failed"] += 1
            parked.clear()
            for req in list(queue) + list(pendreq):
                fail_request(req, why, kind="SystemError")
            queue.clear()
            pendreq.clear()

        def tick_once() -> Optional[str]:
            """One tick: arrivals, SLO admission, preemption, admission and
            resize, one decode dispatch and its bookkeeping.  Returns a
            loop directive ('continue' | 'stalled' | 'break' | 'deadline')
            or None."""
            nonlocal slots, cur_tok, cur_pos, cache, extent, mod, key
            nonlocal dev_args, pt_dev, pt_host, tick
            now = time.perf_counter()
            if wall_mode:
                while pendreq and t0 + (pendreq[0].arrival_s or 0.0) <= now:
                    req = pendreq.popleft()
                    arr_wall[req.rid] = t0 + (req.arrival_s or 0.0)
                    queue.append(req)
            else:
                while pendreq and pendreq[0].arrival <= tick:
                    req = pendreq.popleft()
                    arr_wall.setdefault(req.rid, now)
                    queue.append(req)

            # ---- SLO admission: shed the hopeless, then EDF order -------
            if self.slo and queue:
                kept: List[Request] = []
                for req in queue:
                    if req.ttft_budget_s is not None and now > ttft_deadline(req):
                        fail_request(req, f"shed: TTFT deadline exceeded while queued "
                                          f"(budget {req.ttft_budget_s:.3f}s)")
                        self.metrics["shed"] += 1
                    else:
                        kept.append(req)
                kept.sort(key=edf_key)
                queue.clear()
                queue.extend(kept)

            # ---- preemption under EDF overflow (never in degraded mode):
            # a victim is mid-decode and of strictly lower priority than
            # the incoming request, or past its own latency budget
            if self.slo and not self._degraded and queue:
                overflow = list(queue)[max(self.max_slots - active_count() - len(parked), 0):]
                harvested = False
                for req in overflow:
                    cands = [(s.req.priority, -s.remaining, i)
                             for i, s in enumerate(slots)
                             if s is not None and s.fill is None and not s.poisoned
                             and (s.req.priority < req.priority
                                  or (s.req.latency_budget_s is not None
                                      and now > s.arrival_wall + s.req.latency_budget_s))]
                    if not cands:
                        continue
                    _, _, vi = min(cands)
                    if not harvested:
                        # sync the pending token columns before slot state
                        # moves (the same boundary rule as a resize)
                        harvest()
                        harvested = True
                    victim = slots[vi]
                    if victim is None or victim.poisoned:
                        continue  # the harvest quarantined it
                    park_slot(vi, victim)

            # ---- pad-waste-aware admission + rung resize ----------------
            active = active_count()
            want = min(active + len(queue) + len(parked), self.max_slots)
            t_tick = time.perf_counter()
            # degraded mode sheds admissions unless nothing is active (then
            # an admission is the only way to make progress)
            if want > 0 and not (self._degraded and active > 0):
                # the policy is read through the front at every boundary,
                # so a re-fit takes effect at the next rung selection
                target = self._target_rung(srv.bucketed.policy.bucket(want))
                if target != extent or ((queue or parked) and any(s is None for s in slots)):
                    # a boundary: sync the pending token columns before slot
                    # rows move or dev_args is rebuilt from host state
                    harvest()
                if target != extent:
                    keep = [(i, s) for i, s in enumerate(slots) if s is not None]
                    if paged:
                        # O(table) resize: surviving rows' page-table entries
                        # move; the KV pages themselves do not
                        new_pt = np.full((target, MP), TRASH_PAGE, np.int32)
                        for dst, (i, _) in enumerate(keep):
                            new_pt[dst] = pt_host[i]
                        pt_host = new_pt
                        if extent > 0:
                            self.metrics["resizes"] += 1
                    else:
                        new_cache = srv._acquire_cache(target)
                        if keep and cache is not None:
                            new_cache = self._gather_rows(cache, new_cache,
                                                          [i for i, _ in keep])
                        if cache is not None:
                            srv._release_cache(extent, cache)
                            self.metrics["resizes"] += 1
                        cache = new_cache
                    new_tok = np.zeros((target, 1), np.int32)
                    new_pos = np.zeros((target,), np.int32)
                    new_slots: List[Optional[_Slot]] = [None] * target
                    for dst, (i, s) in enumerate(keep):
                        new_slots[dst] = s
                        new_tok[dst] = cur_tok[i]
                        new_pos[dst] = cur_pos[i]
                    slots, cur_tok, cur_pos = new_slots, new_tok, new_pos
                    extent = target
                    dev_args = None
                    if paged:
                        pt_dev = to_dev(pt_host)
                    # a failed resolve leaves mod None: the dispatch below
                    # resolves again rather than run a stale program
                    mod = None
                    resolve_program()
                # pack queued requests and parked resumes into every free
                # slot, in one EDF order (a parked slot keeps its arrival
                # and deadline); without SLO mode nothing is ever parked
                mid_generation = active > 0
                admitted: List[int] = []
                cand = [("resume", s.req) for s in parked.values()]
                cand += [("new", r) for r in queue]
                if self.slo and parked:
                    cand.sort(key=lambda kr: edf_key(kr[1]))
                cand = deque(cand)
                for i in range(extent):
                    if not cand:
                        break
                    if slots[i] is not None:
                        continue
                    kind, req = cand.popleft()
                    if kind == "resume":
                        resume_slot(i, parked[req.rid])
                        continue
                    slots[i] = _Slot(req=req, admitted_tick=tick, swapped_in=mid_generation,
                                     fill=np.asarray(req.prompt, np.int32),
                                     arrival_wall=req_arrival_wall(req))
                    if mid_generation:
                        self.metrics["swaps"] += 1
                    admitted.append(i)
                # requests not packed go back to the queue in order
                # (resumes not packed stay parked)
                queue.clear()
                queue.extend(r for kind, r in cand if kind == "new")
                if admitted:
                    if paged:
                        cache = self._admit_paged(admitted, slots, cache, extent, cur_tok,
                                                  cur_pos, pt_host, queue)
                        pt_dev = to_dev(pt_host)
                    else:
                        cache = self._admit(admitted, slots, cache, extent, cur_tok, cur_pos)
                    dev_args = None
                    # 1-token budgets finish at admission (a deferral leaves
                    # slots[i] None); a poisoned first token quarantines
                    for i in admitted:
                        s = slots[i]
                        if s is None:
                            continue
                        if s.poisoned:
                            quarantine(i, s)
                        elif s.fill is None and s.remaining <= 0:
                            retire(i, s)

            if not any(s is not None for s in slots):
                if pendreq:
                    # nothing runnable until the next arrival
                    self.metrics["idle_ticks"] += 1
                    if wall_mode:
                        # open loop: sleep toward the next arrival
                        wait = t0 + (pendreq[0].arrival_s or 0.0) - time.perf_counter()
                        if wait > 0:
                            time.sleep(min(wait, 0.025))
                        tick += 1
                    else:
                        tick = max(tick + 1, pendreq[0].arrival)
                    return "continue"
                if queue or parked:
                    # admission itself kept failing with nothing active
                    # (pool exhaustion, prefill faults): escalates like a
                    # failure, so the loop cannot spin
                    tick += 1
                    return "stalled"
                return "break"

            # ---- one decode dispatch advances every active slot ---------
            if dev_args is None:
                mask_np = np.array([s is not None for s in slots])
                for i, s in enumerate(slots):
                    if s is not None:
                        cur_pos[i] = s.pos
                        cur_tok[i, 0] = s.fill[s.pos] if s.fill is not None else s.cur_tok
                tok_dev, pos_dev, mask_dev = to_dev(cur_tok), to_dev(cur_pos), to_dev(mask_np)
            else:
                # steady state (same active set, no prompt being consumed):
                # the previous dispatch's output is this dispatch's input,
                # no host round trip
                tok_dev, pos_dev, mask_dev = dev_args
            if mod is None:
                resolve_program()
            # bounded retry: the program reads the cache and the store and
            # returns new ones, so re-dispatching the tick is state-safe
            attempt = 0
            while True:
                try:
                    if paged:
                        out_tok, cache = mod(params, cache, pt_dev, tok_dev, pos_dev, mask_dev)
                        # pool invariant after every tick: every page is
                        # referenced or free, never both
                        pool.check()
                    else:
                        out_tok, cache = mod(params, cache, tok_dev, pos_dev, mask_dev)
                    break
                except Exception:
                    attempt += 1
                    self.metrics["dispatch_retries"] += 1
                    stats.note_fault(retries=1)
                    if attempt > self.max_dispatch_retries:
                        raise
            if chaos.should_fault(chaos.SITE_LOGITS_NAN):
                # fault model: one active row's logits went non-finite, so
                # guarded_argmax would emit POISON_TOKEN for that row;
                # injected on the host at the token block (a device-side
                # edit would mint a program per victim index)
                victim = next(i for i, s in enumerate(slots) if s is not None)
                poked = out_tok.cpu().numpy().copy()
                poked[victim, 0] = POISON_TOKEN
                out_tok = to_dev(poked)
            n_act = active_count()
            stats.note_dispatch(key, n_act, extent)
            self.metrics["decode_dispatches"] += 1
            self.metrics["occupied_row_steps"] += n_act
            self.metrics["capacity_row_steps"] += extent
            tick += 1
            if wall_mode:
                arrival_due = (bool(pendreq)
                               and t0 + (pendreq[0].arrival_s or 0.0) <= time.perf_counter())
            else:
                arrival_due = bool(pendreq) and pendreq[0].arrival <= tick
            if any(s is not None and s.fill is not None for s in slots):
                # prompt-consuming rows need this tick's tokens now (a fill
                # ending switches the row's input to the program output);
                # fills start at a boundary, so nothing is pending here
                harvest()
                out_np = out_tok.cpu().numpy()
                changed = False
                for i, s in enumerate(slots):
                    if s is None:
                        continue
                    s.pos += 1
                    if s.fill is not None:
                        if s.pos < len(s.fill):
                            changed = True  # mid-prompt rows feed host prompt tokens
                            continue
                        # prompt consumed: this dispatch emitted the first
                        # token (the row's next input is the program output)
                        s.fill = None
                        s.first_tick = tick
                        s.remaining = s.req.max_new
                    if not emit(s, int(out_np[i, 0])):
                        quarantine(i, s)
                        changed = True
                        continue
                    s.remaining -= 1
                    if s.remaining <= 0:
                        retire(i, s)
                        changed = True  # the active set shrank: rebuild the mask
                dev_args = (None if changed or arrival_due
                            else (out_tok, pos_dev + 1, mask_dev))
            else:
                # budgets are host-side counters, so retirement needs no
                # token values: defer the sync until a boundary (a retire,
                # or an arrival that may admit)
                pending.append(out_tok)
                boundary = arrival_due
                for s in slots:
                    if s is None:
                        continue
                    s.pos += 1
                    s.remaining -= 1
                    if s.remaining <= 0:
                        boundary = True
                if boundary:
                    harvest()
                    for i, s in enumerate(slots):
                        if s is not None and s.remaining <= 0:
                            retire(i, s)
                    dev_args = None
                else:
                    # a poisoned row's POISON_TOKEN must not reach the
                    # embedding (it indexes the table; JAX's take wraps it
                    # to the last row): the row reads token 0 until the
                    # harvest quarantines it, and its outputs are dropped
                    dev_args = (out_tok.clamp_min(0), pos_dev + 1, mask_dev)
            if self.tick_deadline_s is not None:
                # the watchdog times the tick's device work, not its enqueue
                _sync(dev)
            dt = time.perf_counter() - t_tick
            tick_s.append(dt)
            if self.tick_deadline_s is not None and dt > self.tick_deadline_s:
                return "deadline"
            return None

        # ---- the run loop: every tick runs inside containment -------------
        consec_failures = 0
        degraded_until = 0
        next_refit = self.refit_interval
        while pendreq or queue or parked or any(s is not None for s in slots):
            self._degraded = tick < degraded_until
            if self.refit_interval and tick >= next_refit and not self._degraded:
                next_refit = tick + self.refit_interval
                try:
                    self.refit()
                except Exception:  # noqa: BLE001 — a re-fit is advisory
                    pass
            if self._degraded:
                stats.note_fault(tick_degraded=True)
                self.metrics["ticks_degraded"] += 1
            try:
                directive = tick_once()
            except Exception as e:  # noqa: BLE001 — the tick's containment boundary
                consec_failures += 1
                self.metrics["tick_failures"] += 1
                # keep what the tick's completed dispatches produced
                try:
                    harvest()
                except Exception:  # noqa: BLE001
                    pending.clear()
                dev_args = None
                degraded_until = max(degraded_until, tick + self.degraded_cooldown)
                tick += 1
                if consec_failures > self.max_consec_failures:
                    self.metrics["aborted"] = True
                    abort_run(e)
                    break
                continue
            if directive == "stalled":
                consec_failures += 1
                self.metrics["tick_failures"] += 1
                if consec_failures > self.max_consec_failures:
                    self.metrics["aborted"] = True
                    abort_run(RuntimeError("admission made no progress"))
                    break
                continue
            consec_failures = 0
            if directive == "deadline":
                # the tick finished but blew its deadline: stay on warm
                # rungs for the cooldown
                self.metrics["watchdog_trips"] += 1
                degraded_until = max(degraded_until, tick + self.degraded_cooldown)
            elif directive == "break":
                break

        self._degraded = False
        harvest()
        _sync(dev)
        wall = time.perf_counter() - t0
        if plan is not None:
            injected = plan.faults_injected - faults0
            self.metrics["faults_injected"] = injected
            if injected:
                stats.note_fault(injected=injected)
        if paged:
            # the store is server-resident: the next run (and the prefix
            # tree's cached pages) continue from it
            srv.page_store = cache
        elif cache is not None:
            srv._release_cache(extent, cache)
        compiles = stats.compiles + srv.prefill_compiles() - compiles0
        m = self.metrics
        cap = max(m["capacity_row_steps"], 1)
        real_tokens = sum(len(r["tokens"]) for r in results.values())
        tick_ms = np.asarray(tick_s) * 1e3
        ttfts = [r["ttft_s"] for r in results.values() if r.get("ttft_s") is not None]
        lats = [r["latency_s"] for r in results.values()
                if r.get("latency_s") is not None and "error" not in r]
        ttft_ticks = [r["ttft_ticks"] for r in results.values() if "ttft_ticks" in r]
        out = {
            "results": results,
            "wall_s": wall,
            "tok_per_s": real_tokens / max(wall, 1e-9),
            "real_tokens": real_tokens,
            "occupancy": m["occupied_row_steps"] / cap,
            "pad_decode_fraction": 1.0 - m["occupied_row_steps"] / cap,
            "compiles": compiles,  # 0 after a warmup covering the rungs
            "tick_ms_p50": float(np.percentile(tick_ms, 50)) if len(tick_ms) else 0.0,
            "tick_ms_p99": float(np.percentile(tick_ms, 99)) if len(tick_ms) else 0.0,
            "tick_ms_max": float(tick_ms.max()) if len(tick_ms) else 0.0,
            "ttft_p50_s": float(np.percentile(ttfts, 50)) if ttfts else 0.0,
            "ttft_p99_s": float(np.percentile(ttfts, 99)) if ttfts else 0.0,
            "latency_p99_s": float(np.percentile(lats, 99)) if lats else 0.0,
            "shed_rate": m["shed"] / n_requests if n_requests else 0.0,
            "ttft_p50_ticks": float(np.percentile(ttft_ticks, 50)) if ttft_ticks else 0.0,
            **m,
        }
        if paged:
            ps_ = pool.stats
            page_bytes = (sum(v.numel() * v.element_size() for v in cache.values())
                          // pool.num_pages)
            out.update(
                kv_pages_in_use=pool.pages_in_use,
                kv_pages_capacity=pool.capacity,
                kv_peak_pages_in_use=ps_.peak_pages_in_use,
                kv_page_bytes=page_bytes,
                kv_bytes_resident_peak=ps_.peak_pages_in_use * page_bytes,
                prefix_hits=ps_.prefix_hits,
                prefix_misses=ps_.prefix_misses,
                prefix_hit_rate=ps_.prefix_hit_rate,
                prefill_skip_rate=ps_.prefill_skip_rate,
                tokens_reused=ps_.tokens_reused,
                pages_allocated=ps_.pages_allocated,
                pages_reused=ps_.pages_reused,
                pages_reclaimed=ps_.pages_reclaimed,
            )
            # the pool counters on the decode front, for bucket_report
            stats.kv_pages_in_use = pool.pages_in_use
            stats.kv_pages_capacity = pool.capacity
            stats.kv_peak_pages_in_use = ps_.peak_pages_in_use
            stats.kv_prefix_hits = ps_.prefix_hits
            stats.kv_tokens_reused = ps_.tokens_reused
        return out

    def _first_tokens(self, logits: torch.Tensor, rows: List[int], cols: List[int],
                      extent: int) -> np.ndarray:
        """Guarded argmax of each admitted row's last real column, gathered
        on the device at a fixed ``(extent,)`` shape whatever the wave's
        size: only those tokens cross to the host."""
        rows_p = np.zeros((extent,), np.int64)
        cols_p = np.zeros((extent,), np.int64)
        rows_p[:len(rows)] = rows
        cols_p[:len(cols)] = cols
        dev = self.server.device
        gathered = logits[torch.from_numpy(rows_p).to(dev), torch.from_numpy(cols_p).to(dev)]
        return guarded_argmax(gathered).cpu().numpy()[:len(rows)]

    def _admit(self, admitted: List[int], slots: List[Optional[_Slot]], cache, extent: int,
               cur_tok: np.ndarray, cur_pos: np.ndarray):
        """Prefill newly admitted slots through the slot-masked grid
        (contiguous cache).

        Swapped-in rows of a stateful family are reset to init state
        first.  One ``prefill_step`` dispatch writes every admitted prompt
        into its slot's rows at position 0, with per-row ``length`` (the
        other rows get 1: their state is slot-gated back anyway), while
        every other slot's rows stay bitwise untouched; the first token is
        read from each row's last real prompt column.  When the grid does
        not cover the longest admitted prompt, under
        ``prefill="sequential"``, or when the prefill dispatch fails (the
        rows are the slot's own, so nothing else was touched), the slots
        keep their ``fill`` buffers and consume the prompt inside the
        decode loop instead.
        """
        srv = self.server
        if srv.model.stateful_decode:
            cache = self._reset_rows(cache, admitted, extent)
        Ps = [len(slots[i].req.prompt) for i in admitted]
        s_ext = (None if srv.prefill_policy == "sequential"
                 else srv._seq_bucket_extent(max(Ps), extent=extent))
        if s_ext is None:
            return cache
        tokens = np.zeros((extent, s_ext), np.int32)
        mask = np.zeros((extent,), bool)
        lengths = np.ones((extent,), np.int32)
        for i, P in zip(admitted, Ps):
            prompt = slots[i].req.prompt
            tokens[i, :P] = prompt
            tokens[i, P:] = prompt[-1]  # edge pad
            mask[i] = True
            lengths[i] = P
        dev = srv.device
        pargs = srv._prefill_args(extent, torch.from_numpy(tokens).to(dev), 0,
                                  lengths=lengths, active=mask)
        try:
            pmod, pkey, _ = srv.prefill_bucketed.program_for(srv.params, cache, *pargs)
            logits, cache = pmod(srv.params, cache, *pargs)
        except Exception:  # noqa: BLE001 — contained: the slots take the fill path
            self.metrics["admission_failures"] += 1
            return cache
        srv.prefill_bucketed.stats.note_dispatch(pkey, (len(admitted), max(Ps)), pkey.extents)
        self.metrics["prefill_dispatches"] += 1
        firsts = self._first_tokens(logits, admitted, [P - 1 for P in Ps], extent)
        for i, P, first in zip(admitted, Ps, firsts):
            s = slots[i]
            s.fill = None
            s.pos = P
            cur_pos[i] = P
            if int(first) == POISON_TOKEN:
                s.poisoned = True  # quarantined at the admission boundary
                continue
            s.cur_tok = int(first)
            s.tokens.append(s.cur_tok)
            if s.first_wall is None:
                s.first_wall = time.perf_counter()
            s.remaining = s.req.max_new - 1
            cur_tok[i, 0] = s.cur_tok
        return cache

    def _admit_paged(self, admitted: List[int], slots: List[Optional[_Slot]], store,
                     extent: int, cur_tok: np.ndarray, cur_pos: np.ndarray,
                     pt_host: np.ndarray, queue: deque):
        """Admit into the page pool: prefix match, alloc, masked prefill.

        ``grid_ok``: the prefill grid covers the longest admitted prompt
        (async: with a warm cell).  Per admitted slot: when ``grid_ok``,
        match the prompt's leading full-page blocks in the prefix tree
        (matched pages are forked — a refcount bump, no prefill, no copy);
        allocate fresh pages for the rest of the prompt and the budget,
        and write the slot's page-table row.  Pool exhaustion first
        reclaims LRU tree-only pages; if the pool is still short the
        request goes back to the queue (the missing pages are held by
        mid-generation slots and free at their retirement).

        Without ``grid_ok`` nothing is prefilled: the slots keep their
        ``fill`` buffers and the decode loop writes every prompt position
        through the table (no prefix was matched, so every page is the
        slot's own).  Otherwise one prefill dispatch, anchored per row (a
        prefix-hit row's chunk starts at its skip offset), and each
        prompt's full pages go into the tree.  A failed prefill undoes the
        admission: the rows' page refs are freed, the slots vacated and
        the requests requeued (a fill-path replay would write into shared
        prefix pages).
        """
        srv = self.server
        pool = srv.page_pool
        tree = srv.prefix_tree
        ps = pool.page_size
        MP = srv.max_pages_per_slot
        Ps = [len(slots[i].req.prompt) for i in admitted]
        # prefix reuse is sound on the grid path only: matched pages skip
        # prefill, but a fill-path admission writes every position itself
        grid_ok = srv._seq_bucket_extent(max(Ps), extent=extent) is not None
        live: List[int] = []
        deferred: List[Request] = []
        for i in list(admitted):
            s = slots[i]
            prompt = np.asarray(s.req.prompt, np.int32)
            P = len(prompt)
            total = pages_for(P + s.req.max_new, ps)
            shared: List[int] = []
            skip = 0
            if grid_ok:
                # the last real prompt token must prefill — its logits
                # emit the first token — so the match stops one token short
                shared, skip = tree.match(prompt, max_tokens=((P - 1) // ps) * ps)
            try:
                if shared:
                    pool.fork(shared)  # the slot's own refs on the chain
                try:
                    fresh = pool.alloc(total - len(shared))
                except MemoryError:
                    tree.reclaim(total - len(shared) - pool.pages_free)
                    fresh = pool.alloc(total - len(shared))
            except MemoryError:
                if shared:
                    pool.free(shared)
                slots[i] = None
                deferred.append(s.req)
                self.metrics["deferrals"] += 1
                if s.swapped_in:
                    self.metrics["swaps"] -= 1
                continue
            s.pages = list(shared) + list(fresh)
            s.skip = skip
            pt_host[i] = build_row_table(s.pages, MP)
            live.append(i)
        if deferred:
            queue.extendleft(reversed(deferred))
        if not live or not grid_ok:
            return store
        Ls = [len(slots[i].req.prompt) - slots[i].skip for i in live]
        # suffixes never exceed their prompts, so the cell that covers
        # max(Ps) covers max(Ls) too
        s_ext = srv._seq_bucket_extent(max(Ls), extent=extent)
        tokens = np.zeros((extent, s_ext), np.int32)
        mask = np.zeros((extent,), bool)
        pos_np = np.zeros((extent,), np.int32)
        for i, L in zip(live, Ls):
            s = slots[i]
            suffix = np.asarray(s.req.prompt[s.skip:], np.int32)
            tokens[i, :L] = suffix
            tokens[i, L:] = suffix[-1]  # edge pad
            mask[i] = True
            pos_np[i] = s.skip
        dev = srv.device
        pargs = tuple(torch.from_numpy(a).to(dev) for a in (pt_host, tokens, pos_np, mask))
        try:
            pmod, pkey, _ = srv.prefill_bucketed.program_for(srv.params, store, *pargs)
            logits, store = pmod(srv.params, store, *pargs)
        except Exception:  # noqa: BLE001 — contained: undo the admission
            self.metrics["admission_failures"] += 1
            for i in live:
                s = slots[i]
                if s.pages:
                    pool.free(s.pages)
                    s.pages = []
                pt_host[i] = TRASH_PAGE
                slots[i] = None
                if s.swapped_in:
                    self.metrics["swaps"] -= 1
                queue.append(s.req)
            return store
        srv.prefill_bucketed.stats.note_dispatch(pkey, (len(live), max(Ls)), pkey.extents)
        self.metrics["prefill_dispatches"] += 1
        pool.stats.tokens_prefilled += sum(Ls)
        firsts = self._first_tokens(logits, live, [L - 1 for L in Ls], extent)
        for i, first in zip(live, firsts):
            s = slots[i]
            P = len(s.req.prompt)
            s.fill = None
            s.pos = P
            cur_pos[i] = P
            if int(first) == POISON_TOKEN:
                # non-finite prefill logits: quarantined at the admission
                # boundary, and its pages stay out of the prefix tree
                s.poisoned = True
                continue
            s.cur_tok = int(first)
            s.tokens.append(s.cur_tok)
            if s.first_wall is None:
                s.first_wall = time.perf_counter()
            s.remaining = s.req.max_new - 1
            cur_tok[i, 0] = s.cur_tok
            # register the prompt's full pages; decode writes start at P,
            # past every registered page, so cached pages never change
            nfull = P // ps
            if nfull:
                tree.insert(s.req.prompt[:nfull * ps], s.pages[:nfull])
        return store

    def report(self) -> str:
        m = self.metrics
        cap = max(m["capacity_row_steps"], 1)
        return (f"slots: dispatches={m['decode_dispatches']} "
                f"occupancy={m['occupied_row_steps'] / cap:.1%} "
                f"pad_decode={1 - m['occupied_row_steps'] / cap:.1%} "
                f"swaps={m['swaps']} resizes={m['resizes']} "
                f"prefills={m['prefill_dispatches']}"
                + (f" preempts={m['preemptions']} resumes={m['resumes']} shed={m['shed']}"
                   if m["preemptions"] or m["shed"] else "")
                + (f" deferrals={m['deferrals']}" if self.paged else "")
                + (f" warm_fallbacks={m['warm_fallbacks']}" if self.server.async_compile else ""))


def _prefill_programs(server: BatchedServer) -> int:
    return 0 if server.prefill_bucketed is None else len(server.prefill_bucketed.programs)


def _compile_epilogue(server: BatchedServer, args) -> int:
    """CLI report of the async and persistent compile tiers, and the
    restart-replay gate (``--assert-no-builds``)."""
    rc = 0
    if server.compile_cache is not None:
        from ..core import get_compile_cache

        cs = server.compile_cache.stats
        ds = server.compile_cache.store.stats
        g = get_compile_cache().stats
        # bucket-front builds + the forge block bodies that compile through
        # the process-global cache (same disk tier): every full Phase-4 build
        builds = cs.misses + g.misses
        print(f"[serve] disk cache: builds={builds} disk_hits={cs.disk_hits + g.disk_hits} "
              f"mem_hits={cs.hits} writes={ds.writes} corrupt={ds.corrupt} "
              f"bytes_written={ds.bytes_written}")
        if args.assert_no_builds and builds > 0:
            print(f"[serve] ASSERT FAILED: {builds} full builds ran against "
                  f"--cache-dir={args.cache_dir} (expected a pure disk replay)")
            rc = 1
    if server.compile_service is not None:
        ss = server.compile_service.stats.snapshot()
        extra = ""
        if server.bucketed is not None:
            bs = server.bucketed.stats
            extra = (f" wait_s={bs.compile_wait_s:.2f} bg_s={bs.compile_background_s:.2f} "
                     f"fallbacks={bs.fallback_calls}(+{bs.fallback_cells_padded} cells)")
        print(f"[serve] compile service: submitted={ss['submitted']} "
              f"completed={ss['completed']} dedup={ss['dedup_hits']} "
              f"promoted={ss['promoted']} failed={ss['failed']} "
              f"busy_s={ss['busy_s']:.2f}" + extra)
        server.compile_service.shutdown()
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="forge-125m", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--mode", choices=list(BatchedServer.MODES), default="jit")
    ap.add_argument("--backend", default="segment_jit",
                    help="Phase-4 backend of the --mode forge programs (segment_jit: each "
                         "device-affine segment one CUDA graph on the card | interpret | "
                         "reference)")
    ap.add_argument("--bucket-policy", default="pow2",
                    help="batch-axis bucket policy for --mode forge "
                         "(exact | pow2 | ladder:<r1,r2,...>)")
    ap.add_argument("--seq-bucket-policy", default="ladder:16,32,64,128,256",
                    help="sequence-axis bucket policy of the whole-prompt prefill grid")
    ap.add_argument("--prefill", default="auto", choices=list(PREFILL_POLICIES),
                    help="prefill strategy of the contiguous --mode forge fronts: auto / "
                         "batched = whole-prompt (the chunked state scan for the "
                         "recurrent family), sequential = token-at-a-time baseline")
    ap.add_argument("--sweep", default=None,
                    help="comma-separated batch sizes to serve as a workload sweep, e.g. "
                         "1,2,3,5,8,13 (default: --batch)")
    ap.add_argument("--prompt-sweep", default=None,
                    help="comma-separated prompt lengths to cross with --sweep, e.g. "
                         "17,32,48,100 (default: --prompt-len)")
    ap.add_argument("--continuous", type=int, default=0, metavar="N",
                    help="serve N mixed-length requests through the slot scheduler "
                         "(--mode forge; over the paged KV pool with --paged, else over "
                         "the contiguous cache)")
    ap.add_argument("--max-slots", type=int, default=8,
                    help="slot-scheduler bucket cap (--continuous)")
    ap.add_argument("--paged", action="store_true",
                    help="serve the KV cache from a shared page pool with prefix reuse "
                         "(--mode forge --continuous)")
    ap.add_argument("--kv-page-size", type=int, default=16,
                    help="tokens per KV page (--paged; must divide --max-len)")
    ap.add_argument("--kv-pages", type=int, default=0,
                    help="page-pool size incl. the reserved trash page "
                         "(--paged; 0 = eight full-length slots' worth)")
    ap.add_argument("--kv-kernel", default="ref", choices=["ref", "pallas"],
                    help="paged attend implementation (--paged): ref = page gather + "
                         "unfused sdpa, pallas = the hand-written paged-attention "
                         "kernel (its plain version on the CPU)")
    ap.add_argument("--async-compile", action="store_true",
                    help="compile cold buckets on a background worker pool; dispatches "
                         "pad into the nearest warm dominating bucket instead of "
                         "blocking (--mode forge)")
    ap.add_argument("--compile-workers", type=int, default=2,
                    help="background compile worker threads (--async-compile)")
    ap.add_argument("--cache-dir", default=None,
                    help="persistent on-disk compile cache: the programs' Phase-4 "
                         "analysis replays across process restarts (--mode forge)")
    ap.add_argument("--assert-no-builds", action="store_true",
                    help="exit nonzero if any full build ran (compile-cache misses > 0): "
                         "the restart-replay gate against a populated --cache-dir")
    ap.add_argument("--chaos", default=None, metavar="SITE=RATE[,..]",
                    help="arm a seeded fault plan around the measured --continuous run, "
                         "e.g. 'page.alloc=0.2,dispatch=0.05' or 'all=0.05' (sites: "
                         + ", ".join(chaos.ALL_SITES) + "); the loop must finish with "
                         "typed per-request outcomes, never crash")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="seed of the --chaos plan (per-site streams: the same seed gives "
                         "the same fault schedule)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a CUDA device) or cpu")
    args = ap.parse_args(argv)

    if (args.paged or args.continuous) and args.mode != "forge":
        ap.error("--paged / --continuous need --mode forge")
    if args.paged and not args.continuous:
        ap.error("--paged needs --continuous N: the paged KV pool is served through the "
                 "slot scheduler (the contiguous fronts also serve groups)")
    if (args.async_compile or args.cache_dir) and args.mode != "forge":
        ap.error("--async-compile / --cache-dir need --mode forge "
                 "(they act on the bucketed fronts)")
    if args.assert_no_builds and not args.cache_dir:
        ap.error("--assert-no-builds needs --cache-dir (it gates the restart-replay path)")
    plan = None
    if args.chaos:
        if not args.continuous:
            ap.error("--chaos needs --continuous N (fault containment lives in the "
                     "slot-scheduler loop)")
        try:
            plan = chaos.plan_from_spec(args.chaos, seed=args.chaos_seed)
        except ValueError as e:
            ap.error(str(e))
    try:
        sweep = [int(x) for x in args.sweep.split(",")] if args.sweep else [args.batch]
        prompt_sweep = ([int(x) for x in args.prompt_sweep.split(",")] if args.prompt_sweep
                        else [args.prompt_len])
    except ValueError as e:
        ap.error(f"--sweep / --prompt-sweep take comma-separated integers: {e}")
    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family == "encdec":
        raise SystemExit("use examples/ for enc-dec serving")
    if args.mode == "forge":
        from ..core.backends import get_backend

        try:  # fail fast, before paying model init
            get_backend(args.backend)
            policy = get_bucket_policy(args.bucket_policy)
            for B in ([args.max_slots] if args.continuous else sweep):
                policy.bucket(B)  # admission bounds (e.g. ladder overflow)
            get_bucket_policy(args.seq_bucket_policy)
        except ValueError as e:
            ap.error(str(e))

    device = resolve_device(args.device)
    if args.paged:
        cfg = cfg.with_(kv_kernel=args.kv_kernel)
    model = get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(cfg, gen, device)
    rng = np.random.default_rng(args.seed)
    compile_kw = dict(async_compile=args.async_compile, compile_workers=args.compile_workers,
                      cache_dir=args.cache_dir)

    if args.continuous:
        server = BatchedServer(cfg, params, max_len=args.max_len, mode="forge",
                               backend=args.backend, bucket_policy=args.bucket_policy,
                               seq_bucket_policy=args.seq_bucket_policy, prefill=args.prefill,
                               paged=args.paged, kv_page_size=args.kv_page_size,
                               kv_pages=args.kv_pages or None, **compile_kw)
        lens = sorted({max(2, p // (2 ** k)) for p in prompt_sweep for k in range(2)})
        reqs = [
            Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab,
                                        (int(rng.choice(lens)),)).astype(np.int32),
                    max_new=int(rng.integers(2, args.gen + 1)),
                    arrival=int(i // args.max_slots))
            for i in range(args.continuous)
        ]
        sched = SlotScheduler(server, max_slots=args.max_slots)
        warmup_s = sched.warmup(lens)
        # armed for the serving loop only: warmup is not a containment
        # domain, the scheduler tick is
        prev = chaos.install_plan(plan) if plan is not None else None
        try:
            res = sched.run(reqs)
        finally:
            if plan is not None:
                chaos.install_plan(prev)
        print(f"[serve] {cfg.name} continuous n={args.continuous} "
              f"tok/s={res['tok_per_s']:.0f} occupancy={res['occupancy']:.1%} "
              f"pad_decode={res['pad_decode_fraction']:.1%} swaps={res['swaps']} "
              f"resizes={res['resizes']} compiles_post_warmup={res['compiles']} "
              f"(warmup={warmup_s:.2f}s) device={device}")
        print(f"[serve] {sched.report()}")
        failed = [rid for rid, r in res["results"].items() if "error" in r]
        if plan is not None:
            print(f"[serve] chaos: faults_injected={plan.faults_injected} "
                  f"requests_ok={len(res['results']) - len(failed)} "
                  f"requests_failed={len(failed)} degraded_ticks={res['ticks_degraded']} "
                  f"aborted={res['aborted']}")
        if args.paged:
            print(f"[serve] pages: in_use={res['kv_pages_in_use']}/{res['kv_pages_capacity']} "
                  f"peak={res['kv_peak_pages_in_use']} (page={args.kv_page_size}tok) "
                  f"prefix hit_rate={res['prefix_hit_rate']:.1%} "
                  f"skip_rate={res['prefill_skip_rate']:.1%} "
                  f"tokens_reused={res['tokens_reused']} reclaimed={res['pages_reclaimed']}")
        print(f"[serve] decode programs={len(server.bucketed.programs)} "
              f"prefill programs={_prefill_programs(server)} "
              f"compile_s={server._compile_s_total():.2f} "
              f"tick p50={res['tick_ms_p50']:.1f}ms p99={res['tick_ms_p99']:.1f}ms "
              + (f"kv_kernel={cfg.kv_kernel}" if args.paged else "cache=contiguous"))
        if args.paged:
            from ..core.metrics import bucket_report

            print(f"[serve] decode {bucket_report(server.bucketed.stats)}")
        rc = _compile_epilogue(server, args)
        # under --chaos a typed per-request failure is the contained
        # outcome; without it any failure is a fault of the run
        if failed and (plan is None or len(res["results"]) != len(reqs)):
            raise SystemExit(f"requests failed: {failed}")
        return rc

    server = BatchedServer(cfg, params, max_len=args.max_len, mode=args.mode,
                           backend=args.backend, bucket_policy=args.bucket_policy,
                           seq_bucket_policy=args.seq_bucket_policy, prefill=args.prefill,
                           **(compile_kw if args.mode == "forge" else {}))
    warmup_s = server.warmup(sweep, prompt_sweep)
    compile_after = 0.0
    for B in sweep:
        for P in prompt_sweep:
            prompts = rng.integers(0, cfg.vocab, (B, P)).astype(np.int32)
            res = server.generate(prompts, args.gen)
            compile_after += res["compile_s"]
            print(f"[serve] {cfg.name} batch={B} prompt={P} "
                  f"ttft={res['ttft_s'] * 1e3:.1f}ms (prefill={res['prefill_mode']}) "
                  f"compile={res['compile_s']:.2f}s "
                  f"decode mean={res['decode_ms_mean']:.1f}ms p50={res['decode_ms_p50']:.1f} "
                  f"p99={res['decode_ms_p99']:.1f} ({res['tok_per_s']:.0f} tok/s "
                  f"steady-state) device={device}")
            if res["tokens"].shape != (B, args.gen):
                raise SystemExit(f"unexpected token shape {res['tokens'].shape}")
    if args.mode == "jit":
        for B, step in sorted(server.jit_steps.items()):
            print(f"[serve] jit batch={B}: graphs={step.graphs} nodes={step.graph_nodes} "
                  f"kernel nodes={step.kernel_nodes} compile_s={step.compile_s:.2f} "
                  f"({', '.join(f'{k}={v:.2f}' for k, v in step.compile_split.items())}; "
                  f"warmup={warmup_s:.2f}s)")
    if args.mode == "forge":
        from ..core.metrics import bucket_report

        print(f"[serve] decode programs={len(server.bucketed.programs)} "
              f"prefill programs={_prefill_programs(server)} "
              f"warmup={warmup_s:.2f}s compile_s_after_warmup={compile_after:.2f}")
        print(f"[serve] decode {bucket_report(server.bucketed.stats)}")
        if server.prefill_bucketed is not None:
            print(f"[serve] prefill grid {bucket_report(server.prefill_bucketed.stats)}")
        return _compile_epilogue(server, args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
