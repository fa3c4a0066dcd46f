"""The paper's evaluation metrics (§5) and the fidelity protocol (§6.5).

* **per-pass profiling** — τ(p_k); produced by the pipeline itself
  (``CompilationResult.pass_table``).
* **FGR** (Eq. 22) — CostModel(α=0) / CostModel(α=1): a cost-model-
  internal diagnostic of fusion impact.  NOT a latency ratio (the
  paper's caveat retained).
* **CEI** (Eq. 23) — (L_baseline / L_forge) / T_compile_seconds:
  latency speedup delivered per second of compile time.
* **fidelity** — max-abs logit difference and KL divergence between
  pre- and post-compilation outputs (paper Table 6 protocol), and the
  same between every Phase-4 backend and the ``reference`` oracle;
  bucketed pad-and-mask calls against exact-shape compiles, whole-prompt
  prefill against sequential decode, ragged slot decode against per-row
  decode.
* ``bucket_report`` — the one-line summary of a front's BucketStats.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence

import torch
from torch.utils import _pytree as pytree

from .capture import trace_to_graph
from .compiler import ForgeCompiler
from .shapekey import PolyAxis
from .cost_model import score_graph
from .passes import PipelineConfig, run_forge_passes

#: the paper's reported fidelity bounds (Table 6)
PAPER_MAX_ABS = 2.1e-5
PAPER_MAX_KL = 8.4e-9


# --------------------------------------------------------------------------
# FGR
# --------------------------------------------------------------------------


def fusion_gain_ratio(
    fn: Callable,
    *example_args: Any,
    config: Optional[PipelineConfig] = None,
) -> Dict[str, float]:
    """FGR = Score(α=0) / Score(α=1)  (paper Eq. 22): two captures of
    ``fn``, one through the pipeline without fusion, one with all of it."""
    base = config or PipelineConfig()

    def _score(alpha: float) -> float:
        cfg = dataclasses.replace(base, alpha=alpha, enable=dict(base.enable))
        g = trace_to_graph(fn, *example_args).graph
        run_forge_passes(g, cfg=cfg)
        return score_graph(g, cfg.precision).score

    s0 = _score(0.0)
    s1 = _score(1.0)
    return {"score_alpha0": s0, "score_alpha1": s1, "fgr": s0 / max(s1, 1e-12)}


# --------------------------------------------------------------------------
# CEI
# --------------------------------------------------------------------------


def compilation_efficiency_index(
    latency_baseline_ms: float,
    latency_forge_ms: float,
    compile_time_ms: float,
) -> float:
    """CEI_B = (L_B / L_forge) / T_compile^(s)  (paper Eq. 23)."""
    speedup = latency_baseline_ms / max(latency_forge_ms, 1e-12)
    return speedup / max(compile_time_ms / 1e3, 1e-12)


# --------------------------------------------------------------------------
# Numerical fidelity (paper §6.5 protocol, Table 6)
# --------------------------------------------------------------------------


@dataclass
class FidelityReport:
    max_abs_diff: float
    kl_divergence: float
    n_elements: int

    def ok(self, max_abs: float = PAPER_MAX_ABS, max_kl: float = PAPER_MAX_KL) -> bool:
        """Check against the paper's reported bounds (Table 6)."""
        return self.max_abs_diff <= max_abs and self.kl_divergence <= max_kl


def _kl(p_logits: torch.Tensor, q_logits: torch.Tensor) -> float:
    """Mean KL(P‖Q) over the last axis of logits."""
    p = torch.log_softmax(p_logits.float(), dim=-1)
    q = torch.log_softmax(q_logits.float(), dim=-1)
    return float((p.exp() * (p - q)).sum(-1).mean())


def fidelity(pre_outputs: Any, post_outputs: Any, *,
             logits_are_last_axis: bool = True) -> FidelityReport:
    """Compare pre- vs post-compilation outputs (logit-level, Table 6)."""
    pre_flat = pytree.tree_leaves(pre_outputs)
    post_flat = pytree.tree_leaves(post_outputs)
    if len(pre_flat) != len(post_flat):
        raise ValueError(f"output arity mismatch: {len(pre_flat)} vs {len(post_flat)}")
    max_abs = kl = 0.0
    n = 0
    for a, b in zip(pre_flat, post_flat):
        a, b = a.detach().float(), b.detach().float()
        if a.numel():
            max_abs = max(max_abs, float((a - b).abs().max()))
        if logits_are_last_axis and a.dim() >= 1 and a.shape[-1] > 1:
            kl = max(kl, _kl(a, b))
        n += a.numel()
    return FidelityReport(max_abs_diff=max_abs, kl_divergence=kl, n_elements=n)


def check_compilation_fidelity(
    fn: Callable,
    *concrete_args: Any,
    config: Optional[PipelineConfig] = None,
) -> FidelityReport:
    """End-to-end protocol: run ``fn`` raw vs Forge-compiled, compare."""
    with torch.no_grad():
        pre = fn(*concrete_args)
        mod = ForgeCompiler(config or PipelineConfig()).compile(fn, *concrete_args)
        post = mod(*concrete_args)
    return fidelity(pre, post)


def check_bucketed_fidelity(
    fn: Callable,
    *concrete_args: Any,
    in_axes: Any = 0,
    out_axes: Any = 0,
    policy: Any = "pow2",
    axes: Optional[Sequence[PolyAxis]] = None,
    config: Optional[PipelineConfig] = None,
    backend: Optional[str] = None,
) -> FidelityReport:
    """Bucketed pad-and-mask execution vs exact-shape compilation.

    Compiles ``fn`` twice — once specialised to the concrete shapes, once
    through the ShapeKey bucketing front (``axes=(PolyAxis, ...)`` for
    multi-axis fronts, the 1-D kwargs otherwise) — and compares outputs.
    Any divergence means the padded rows or columns were not inert (some
    op coupled rows along a polymorphic axis) or the output mask sliced
    the wrong axis.  Private caches keep the two compiles from sharing
    executors.
    """
    from .cache import CompileCache

    cfg = config or PipelineConfig()
    with torch.no_grad():
        exact = ForgeCompiler(cfg, backend=backend, cache=CompileCache()).compile(
            fn, *concrete_args)
        bucketed = ForgeCompiler(cfg, backend=backend, cache=CompileCache()).compile_bucketed(
            fn, axes=axes, in_axes=in_axes, out_axes=out_axes, policy=policy)
        return fidelity(exact(*concrete_args), bucketed(*concrete_args))


def check_prefill_fidelity(cfg: Any, params: Any, prompts: Any, *,
                           max_len: int = 64) -> FidelityReport:
    """Whole-prompt batched prefill vs sequential decode-step replay.

    Runs the model's ``prefill_step`` once on the (B, P) prompt block and
    ``decode_step`` P times on the same prompts, then compares the
    per-position logits and the resulting caches — the acceptance bound
    of the 2-D serve front is 1e-5 max-abs (a divergence means the
    chunk-causal length mask let a future token leak into a past
    position, or the cache write strided wrong).
    """
    import numpy as np

    from ..models import get_model

    model = get_model(cfg)
    if model.prefill_step is None:
        raise ValueError(f"family {cfg.family!r} has no batched prefill")
    dev = params["embed"].device
    prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int32, device=dev)
    B, P = prompts.shape
    with torch.no_grad():
        cache_seq = model.init_cache(cfg, B, max_len, device=dev)
        logits_seq = []
        for i in range(P):
            lg, cache_seq = model.decode_step(params, cache_seq, prompts[:, i:i + 1],
                                              torch.tensor(i, dtype=torch.int32, device=dev),
                                              cfg)
            logits_seq.append(lg[:, -1, :])
        cache_b = model.init_cache(cfg, B, max_len, device=dev)
        logits_b, cache_b = model.prefill_step(
            params, cache_b, prompts, torch.tensor(0, dtype=torch.int32, device=dev), cfg)
    return fidelity((torch.stack(logits_seq, dim=1), cache_seq), (logits_b, cache_b))


def check_ragged_decode_fidelity(cfg: Any, params: Any, prompts: Sequence[Any], *,
                                 n_new: int = 3, max_len: int = 32) -> FidelityReport:
    """Vectorized per-row-position decode vs per-row sequential decode.

    ``prompts`` is a list of 1-D token arrays of different lengths.  The
    reference decodes each row alone (batch 1, scalar positions); the
    candidate runs all rows in one batch through slot-masked ragged
    decode — each prompt consumed through masked decode steps (rows
    whose prompt is exhausted are frozen by ``slot_mask``), then
    ``n_new`` greedy steps with a per-row position vector.  A divergence
    means a per-row RoPE / KV write / mask strayed from its row's
    position, or a masked slot leaked state — the acceptance bound of
    slot-level continuous batching is 1e-5 max-abs.
    """
    import numpy as np

    from ..models import get_model

    model = get_model(cfg)
    dev = params["embed"].device
    B = len(prompts)
    prompts = [np.asarray(p, np.int32) for p in prompts]
    plens = [len(p) for p in prompts]

    def greedy(lg):
        return torch.argmax(lg[:, -1, :], dim=-1).to(torch.int32)[:, None]

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    with torch.no_grad():
        solo_logits = []  # per row: (n_new, vocab)
        for r in range(B):
            cache = model.init_cache(cfg, 1, max_len, device=dev)
            lg = None
            for i in range(plens[r]):
                lg, cache = model.decode_step(params, cache, t(prompts[r][i:i + 1][None]),
                                              t(i), cfg)
            tok = greedy(lg)
            outs = []
            for j in range(n_new):
                lg, cache = model.decode_step(params, cache, tok, t(plens[r] + j), cfg)
                outs.append(lg[0, -1, :])
                tok = greedy(lg)
            solo_logits.append(torch.stack(outs))

        cache = model.init_cache(cfg, B, max_len, device=dev)
        tok_col = np.zeros((B, 1), np.int32)
        first = np.zeros((B, 1), np.int32)
        for i in range(max(plens)):
            active = np.asarray([i < p for p in plens])
            for r in range(B):
                tok_col[r, 0] = prompts[r][min(i, plens[r] - 1)]
            lg, cache = model.decode_step(params, cache, t(tok_col),
                                          t(np.full((B,), i, np.int32)), cfg,
                                          slot_mask=t(active, torch.bool))
            g = greedy(lg).cpu().numpy()
            for r in range(B):
                if plens[r] == i + 1:
                    first[r] = g[r]
        tok = t(first)
        pos = np.asarray(plens, np.int32)
        ragged = []
        for j in range(n_new):
            lg, cache = model.decode_step(params, cache, tok, t(pos + j), cfg,
                                          slot_mask=torch.ones((B,), dtype=torch.bool,
                                                               device=dev))
            ragged.append(lg[:, -1, :])
            tok = greedy(lg)
    return fidelity(torch.stack(solo_logits), torch.stack(ragged, dim=1))


def bucket_report(stats: Any) -> str:
    """One-line summary of a BucketedModule's BucketStats (the JAX
    package's line, given equal stats)."""
    per = ", ".join(f"{k}:{v}" for k, v in sorted(stats.per_bucket_calls.items()))
    pool = ""
    if stats.pool_hits or stats.pool_misses:
        pool = (f" pool={stats.pool_hits}h/{stats.pool_misses}m "
                f"(hit_rate={stats.pool_hit_rate:.1%}, "
                f"reused={stats.pool_bytes_reused / 1e6:.1f}MB)")
    evic = f" evictions={stats.evictions}" if stats.evictions else ""
    # async-compile split: request-visible stall vs worker-absorbed time
    async_note = ""
    if stats.compile_background_s or stats.fallback_calls:
        async_note = (f" wait_s={stats.compile_wait_s:.2f}"
                      f" bg_s={stats.compile_background_s:.2f}"
                      f" fallbacks={stats.fallback_calls}"
                      f" (+{stats.fallback_cells_padded} padded cells)")
    pages = ""
    if stats.kv_pages_capacity:
        pages = (f" kv_pages={stats.kv_pages_in_use}/{stats.kv_pages_capacity}"
                 f" (peak={stats.kv_peak_pages_in_use},"
                 f" prefix_hits={stats.kv_prefix_hits},"
                 f" tokens_reused={stats.kv_tokens_reused})")
    faults = ""
    if (stats.faults_injected or stats.requests_failed or stats.ticks_degraded
            or stats.dispatch_retries):
        faults = (f" faults={stats.faults_injected}"
                  f" req_failed={stats.requests_failed}"
                  f" degraded_ticks={stats.ticks_degraded}"
                  f" retries={stats.dispatch_retries}")
    return (f"buckets: compiles={stats.compiles} hits={stats.bucket_hits} "
            f"(hit_rate={stats.hit_rate:.1%}) calls={stats.calls} "
            f"pad_waste={stats.pad_waste:.1%} compile_s={stats.compile_s:.2f}"
            f"{async_note}{evic}{pool}{pages}{faults} [{per}]")


def check_backend_fidelity(
    fn: Callable,
    *concrete_args: Any,
    backends: Sequence[str] = ("interpret", "segment_jit"),
    config: Optional[PipelineConfig] = None,
) -> Dict[str, FidelityReport]:
    """Compare every Phase-4 backend against the ``reference`` oracle.

    The reference backend executes the same lowered program with no
    scheduling and no buffer sharing, so any divergence here isolates a
    Phase-4 (backend-layer) bug from a Phase-1..3 one."""
    cfg = config or PipelineConfig()
    with torch.no_grad():
        oracle = ForgeCompiler(cfg, backend="reference").compile(fn, *concrete_args)
        ref_out = oracle(*concrete_args)
        reports: Dict[str, FidelityReport] = {}
        for name in backends:
            mod = ForgeCompiler(cfg, backend=name).compile(fn, *concrete_args)
            reports[name] = fidelity(ref_out, mod(*concrete_args))
    return reports
