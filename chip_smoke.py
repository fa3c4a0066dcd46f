#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port: the quickest proof that the
port starts on the GPU and goes through its own kernels.

Run from the repository root, with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Device and build: the card's name and power limit, then both CUDA
   kernels built with nvcc for sm_90a from ``src/repro_torch/kernels/csrc``.
2. Each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it (f32: rtol 2e-4, atol 2e-5; bf16: 3e-2,
   the JAX package's kernel tolerances; bf16 flash attention also within
   a bound from bf16 rounding, on inputs whose softmax is peaky;
   whole-model bf16 logits 6e-2), with its time, the plain version's
   time, one PyTorch library call's time and the card's bound.
3. Serve forge-125m at full width (12 layers, d 768, vocab 50257, bf16,
   random weights from seed 0) with the serve CLI's defaults through
   ``BatchedServer(mode="eager")``: Forge-compiled block bodies, 36
   fused-linear launches per decode step; the prefilled caches and the
   first generated step's logits and greedy tokens against the same
   server with ``impl="ref"``.
4. The full-sequence forward ``apply`` at B=4, S=1024: 12 flash-attention
   and 36 fused-linear launches, logits against the plain path.

Each path's launch counts are zeroed just before it and read just after.
The line before the last is one JSON object with a row per kernel (its
launches and times also split by path); the last line is
``{"ok": true, "device": {...}}``.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL_F32 = dict(rtol=2e-4, atol=2e-5)
TOL_BF16 = dict(rtol=3e-2, atol=3e-2)
# whole-model bf16 logits, kernels against the plain path: each kernel
# rounds its fp32 result once where the plain path rounds the product,
# the bias add and the activation separately, and the differences
# compound through 12 residual layers (measured on the H100: 2 of 206M
# apply logits between 3e-2 and 3.4e-2), so twice the kernel bound
TOL_MODEL_BF16 = dict(rtol=6e-2, atol=6e-2)
# bf16 flash attention, element by element, from bf16's unit roundoff
# u = 2^-8: the kernel rounds its unnormalised probabilities and the
# plain version its normalised ones, each term p_j*v_j by at most u, and
# both round the output once, so they differ by at most
# 2u*sum_j p_j|v_j| + 2u*|out|; the check allows 3u times that sum
BF16_U = 2.0 ** -8
# flash inputs: q and k with std 1.5 give scores of std 2.25 after the
# 1/sqrt(D) scale, so the softmax is peaky and each output row is O(1)
QK_STD = 1.5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak
ACTS = (None, "relu", "silu", "gelu", "gelu_exact", "tanh")


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def tol_for(dtype):
    import torch

    return TOL_BF16 if dtype == torch.bfloat16 else TOL_F32


def assert_close(got, want, dtype, what, tol=None):
    """Hold a result against its plain version; returns the max abs error."""
    import torch

    t = tol or tol_for(dtype)
    g, w = got.float(), want.float()
    check(torch.isfinite(g).all().item(), f"{what}: non-finite values")
    err = (g - w).abs()
    bad = err > t["atol"] + t["rtol"] * w.abs()
    check(not bad.any().item(),
          f"{what}: {int(bad.sum())} elements beyond rtol={t['rtol']} atol={t['atol']} "
          f"(max abs err {err.max().item():.3e})")
    return err.max().item()


def assert_flash_rounding(got, want, q, k, v, scale, causal, what):
    """Hold a bf16 flash result within 3u*(sum_j p_j|v_j| + |out|) of its
    plain version; returns the largest error-to-bound ratio."""
    from repro_torch.kernels import flash_attention as FA

    mass = FA.flash_attention_plain(q, k, v.abs(), scale=scale, causal=causal).float()
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bound = 3 * BF16_U * (mass + w.abs())
    worst = (err / bound).max().item()
    check(not (err > bound).any().item(),
          f"{what}: {int((err > bound).sum())} elements beyond 3u(sum p|v| + |out|) "
          f"(worst err/bound {worst:.3e})")
    return worst


def flash_inputs(g, dev, dtype, B, H, KVH, Sq, Sk, D=64):
    import torch

    q = (torch.randn(B, H, Sq, D, generator=g, device=dev) * QK_STD).to(dtype)
    k = (torch.randn(B, KVH, Sk, D, generator=g, device=dev) * QK_STD).to(dtype)
    v = torch.randn(B, KVH, Sk, D, generator=g, device=dev).to(dtype)
    return q, k, v


class Timer:
    """Device time of one call's kernels with a cold L2, from
    ``torch.profiler``: every call follows a 128 MB memset (2.5x the L2),
    and the kernels the call launched are summed, the memset's fill
    kernel excluded.  Host submission time, which exceeds a decode-size
    kernel's own time in the Python wrappers, stays out.  Returns the
    mean over ``iters`` calls."""

    FLUSH_KERNEL = "FillFunctor"

    def __init__(self, device):
        import torch

        self.torch = torch
        self.flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=device)

    def ms(self, fn, iters=20, warmup=3):
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
            for _ in range(iters):
                self.flush.zero_()
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if "CUDA" in str(getattr(e, "device_type", ""))
                 and self.FLUSH_KERNEL not in e.key)
        check(us > 0, "the profiler recorded no device time")
        return us / 1e3 / iters


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    for name in _build.SOURCES:
        path = _build.library_path(name)
        check(path.exists(), f"{name}: library missing after the build")
        log(f"built {path.relative_to(ROOT)}")
    for name, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas[{name}] {line.strip()}")
    log(f"nvcc (sm_90a) built {len(logs)} libraries in {time.perf_counter() - t0:.1f}s")


def phase_fused_linear(dev, timer):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import fused_linear as FL

    g = torch.Generator(device=dev).manual_seed(1)
    n_checks = 0
    for dtype in (torch.float32, torch.bfloat16):
        for M in (4, 4096):
            for K, N in ((768, 3072), (3072, 768), (768, 768)):
                x = (torch.randn(M, K, generator=g, device=dev) * 0.5).to(dtype)
                w = (torch.randn(K, N, generator=g, device=dev) / K ** 0.5).to(dtype)
                b = (torch.randn(N, generator=g, device=dev) * 0.1).to(dtype)
                for act in ACTS:
                    for bias in (b, None):
                        got = FL.fused_linear_cuda(x, w, bias, act=act)
                        want = FL.fused_linear_plain(x, w, bias, act=act)
                        assert_close(got, want, dtype,
                                     f"fused_linear {dtype} M={M} K={K} N={N} act={act} "
                                     f"bias={bias is not None}")
                        n_checks += 1
    torch.cuda.synchronize()
    log(f"fused_linear: {n_checks} cases within tolerance of the plain version")

    # timing at the main path's shapes and dtype: one layer's three
    # launches (o-proj, FFN up + gelu, FFN down), at decode (M=4) and in
    # the full-sequence forward (M=4096)
    rows = {}
    for M in (4, 4096):
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, flops=0.0, bytes=0.0,
                   err=0.0)
        for K, N, act, has_b in ((768, 768, None, False), (768, 3072, "gelu", True),
                                 (3072, 768, None, True)):
            dt = torch.bfloat16
            x = (torch.randn(M, K, generator=g, device=dev) * 0.5).to(dt)
            w = (torch.randn(K, N, generator=g, device=dev) / K ** 0.5).to(dt)
            b = (torch.randn(N, generator=g, device=dev) * 0.1).to(dt) if has_b else None
            err = assert_close(FL.fused_linear_cuda(x, w, b, act=act),
                               FL.fused_linear_plain(x, w, b, act=act), dt, "timing input")
            ms = timer.ms(lambda: FL.fused_linear_cuda(x, w, b, act=act))
            plain = timer.ms(lambda: FL.fused_linear_plain(x, w, b, act=act))
            if has_b and act == "gelu":
                lib_fn = lambda: F.gelu(torch.addmm(b, x, w), approximate="tanh")  # noqa: E731
            elif has_b:
                lib_fn = lambda: torch.addmm(b, x, w)  # noqa: E731
            else:
                lib_fn = lambda: torch.mm(x, w)  # noqa: E731
            lib = timer.ms(lib_fn)
            nbytes = 2 * (M * K + K * N + M * N + (N if has_b else 0))
            flops = 2.0 * M * K * N
            bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
            log(f"fused_linear bf16 M={M} K={K} N={N} act={act} bias={has_b}: "
                f"kernel {ms:.4f} ms, plain {plain:.4f} ms, library {lib:.4f} ms, "
                f"bound {bound:.5f} ms ({'bytes' if nbytes / HBM_BYTES_PER_S > flops / BF16_FLOPS else 'operations'}), "
                f"max abs err {err:.3e}")
            for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bound_ms", bound), ("flops", flops), ("bytes", nbytes)):
                tot[k] += v
            tot["err"] = max(tot["err"], err)
        rows[M] = tot
        log(f"fused_linear one layer (3 launches) M={M}: kernel {tot['ms']:.4f} ms, "
            f"plain {tot['plain_ms']:.4f} ms, library {tot['library_ms']:.4f} ms, "
            f"bound {tot['bound_ms']:.5f} ms")
    return rows


def phase_flash(dev, timer):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA

    g = torch.Generator(device=dev).manual_seed(2)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for S in (256, 1024):
            for causal in (True, False):
                cases.append((dtype, 4, 12, 12, S, S, causal))
        cases.append((dtype, 4, 12, 4, 256, 256, True))  # GQA, 3 groups
        cases.append((dtype, 4, 12, 12, 256, 1024, True))  # Sq < Sk, offset Sk-Sq
    worst = 0.0
    for dtype, B, H, KVH, Sq, Sk, causal in cases:
        q, k, v = flash_inputs(g, dev, dtype, B, H, KVH, Sq, Sk)
        scale = 1.0 / 8.0
        got = FA.flash_attention_cuda(q, k, v, scale=scale, causal=causal)
        want = FA.flash_attention_plain(q, k, v, scale=scale, causal=causal)
        what = f"flash {dtype} B={B} H={H} KVH={KVH} Sq={Sq} Sk={Sk} causal={causal}"
        assert_close(got, want, dtype, what)
        if dtype == torch.bfloat16:
            worst = max(worst, assert_flash_rounding(got, want, q, k, v, scale, causal, what))
    # a strided (transposed-view) input, as the model hands over v
    x = (torch.randn(4, 256, 12, 64, generator=g, device=dev) * QK_STD).to(torch.bfloat16)
    qs = x.transpose(1, 2)
    got = FA.flash_attention_cuda(qs, qs, qs, scale=0.125, causal=True)
    want = FA.flash_attention_plain(qs, qs, qs, scale=0.125, causal=True)
    assert_close(got, want, torch.bfloat16, "flash strided views")
    worst = max(worst, assert_flash_rounding(got, want, qs, qs, qs, 0.125, True,
                                             "flash strided views"))
    torch.cuda.synchronize()
    log(f"flash_attention: {len(cases) + 1} cases within tolerance of the plain version "
        f"(inputs q, k std {QK_STD}, v std 1; bf16: worst error / rounding bound "
        f"{worst:.3e}, limit 1)")

    # timing at the full-sequence forward's shape: B=4, H=12, S=1024, D=64, causal, bf16
    B, H, S, D = 4, 12, 1024, 64
    dt = torch.bfloat16
    q, k, v = flash_inputs(g, dev, dt, B, H, H, S, S, D)
    got = FA.flash_attention_cuda(q, k, v, scale=0.125, causal=True)
    want = FA.flash_attention_plain(q, k, v, scale=0.125, causal=True)
    err = assert_close(got, want, dt, "timing input")
    assert_flash_rounding(got, want, q, k, v, 0.125, True, "timing input")
    ms = timer.ms(lambda: FA.flash_attention_cuda(q, k, v, scale=0.125, causal=True))
    plain = timer.ms(lambda: FA.flash_attention_plain(q, k, v, scale=0.125, causal=True))
    lib = timer.ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                          scale=0.125))
    pairs = S * (S + 1) / 2  # visible (query, key) pairs of one causal head
    flops = 4.0 * B * H * D * pairs
    nbytes = 2 * 4 * B * H * S * D  # q, k, v read once, out written once
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    log(f"flash_attention bf16 B={B} H={H} S={S} D={D} causal: kernel {ms:.4f} ms, "
        f"plain {plain:.4f} ms, library {lib:.4f} ms, bound {bound:.5f} ms "
        f"({'bytes' if nbytes / HBM_BYTES_PER_S > flops / BF16_FLOPS else 'operations'}), "
        f"max abs err {err:.3e}")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, flops=flops,
                bytes=nbytes, err=err)


def phase_main_path(dev):
    """Serve, then ``apply``: each path's counts are zeroed just before it
    and read just after; the comparisons with the plain path come
    afterwards.  Returns the launches per path and kernel."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_linear as FL
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import get_model

    cfg = get_config("forge-125m")  # full width: 12 layers, d 768, vocab 50257, bf16
    check(cfg.fuse == "forge" and cfg.dtype == "bfloat16", "forge-125m defaults changed")
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    B, P, n_new, max_len = 4, 32, 32, 256  # the serve CLI's defaults
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (B, P)).astype(np.int32)
    Ba, S = 4, 1024  # the full-sequence forward
    tokens = torch.randint(0, cfg.vocab, (Ba, S), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(3))
    server = BatchedServer(cfg, params, max_len=max_len, mode="eager")

    def counts():
        return {"fused_linear": FL.LAUNCHES.n, "flash_attention": FA.LAUNCHES.n}

    FL.LAUNCHES.reset()
    FA.LAUNCHES.reset()
    res = server.generate(prompts, n_new)
    serve = counts()
    FL.LAUNCHES.reset()
    FA.LAUNCHES.reset()
    with torch.no_grad():
        t0 = time.perf_counter()
        logits_apply = model.apply(params, tokens, cfg)
        torch.cuda.synchronize()
        apply_first_ms = (time.perf_counter() - t0) * 1e3
    applied = counts()

    steps = P + n_new - 1
    check(res["tokens"].shape == (B, n_new), f"token shape {res['tokens'].shape}")
    check(serve["fused_linear"] == 3 * cfg.n_layers * steps,
          f"fused_linear launches {serve['fused_linear']} != 36 per decode step x {steps} steps")
    check(serve["flash_attention"] == 0,
          f"masked decode attention launched flash {serve['flash_attention']} times")
    check(applied["flash_attention"] == cfg.n_layers,
          f"apply: flash launches {applied['flash_attention']} != {cfg.n_layers}")
    check(applied["fused_linear"] == 3 * cfg.n_layers,
          f"apply: fused_linear launches {applied['fused_linear']} != {3 * cfg.n_layers}")
    check(tuple(logits_apply.shape) == (Ba, S, cfg.vocab),
          f"apply logits shape {tuple(logits_apply.shape)}")
    check(torch.isfinite(logits_apply).all().item(), "non-finite apply logits")
    log(f"serve {cfg.name} (bf16, {cfg.n_layers} layers) batch={B} prompt={P} gen={n_new}: "
        f"ttft {res['ttft_s'] * 1e3:.1f} ms (sequential prefill, first compile included), "
        f"decode p50 {res['decode_ms_p50']:.2f} ms p99 {res['decode_ms_p99']:.2f} ms, "
        f"{res['tok_per_s']:.0f} tok/s; fused_linear launches {serve['fused_linear']} = "
        f"{serve['fused_linear'] // steps} per decode step over {steps} steps, "
        f"flash {serve['flash_attention']}")
    log(f"apply B={Ba} S={S}: flash launches {applied['flash_attention']}, fused_linear "
        f"launches {applied['fused_linear']}, first call {apply_first_ms:.1f} ms "
        f"(compile included)")
    from repro_torch.models import _forge

    bodies = _forge.compiled_bodies()
    check(len(bodies) == 2, f"expected the decode and apply bodies compiled, got {len(bodies)}")
    for r in bodies:
        check(r.attention_fused == 1 and r.fused_ops == 4,
              f"a block body fused {r.fused_ops} ops ({r.attention_fused} attention)")
        s = r.executor_stats
        log(f"Forge-compiled block body: nodes {r.nodes_before} -> {r.nodes_after}, "
            f"fused ops {r.fused_ops} (1 forge.sdpa, 3 forge.linear_act), "
            f"{s.n_instructions} RGIR ops, delta {s.delta_before} -> {s.delta_after}, "
            f"{s.n_segments} segments, vregs {s.n_vregs} -> buffers {s.n_buffers}, "
            f"Phases 1-4 {r.total_ms:.0f} ms (capture {r.capture_ms:.0f} ms)")

    # comparisons with the plain path (their launches do not count)
    compare_served_step(model, cfg, server, prompts, BatchedServer)
    with torch.no_grad():
        t0 = time.perf_counter()
        model.apply(params, tokens, cfg)
        torch.cuda.synchronize()
        apply_ms = (time.perf_counter() - t0) * 1e3
        FL.LAUNCHES.reset()
        FA.LAUNCHES.reset()
        logits_apply_ref = model.apply(params, tokens, cfg, impl="ref")
        check(counts() == {"fused_linear": 0, "flash_attention": 0},
              "the impl='ref' apply launched a kernel")
        err = assert_close(logits_apply, logits_apply_ref, torch.bfloat16, "apply logits",
                           TOL_MODEL_BF16)
        log(f"apply logits within bf16 tolerance of the plain path (max abs err "
            f"{err:.3e}, {rel_l2(logits_apply, logits_apply_ref):.3e} relative L2); "
            f"steady call {apply_ms:.1f} ms host wall")
    busy_share(dev, server, prompts)
    return {"serve": serve, "apply": applied}


def rel_l2(got, want):
    g, w = got.float(), want.float()
    return ((g - w).norm() / w.norm()).item()


def compare_served_step(model, cfg, server, prompts, server_cls):
    """The kernel server against the same server with ``impl="ref"``:
    each prefills the prompts into its own cache, then both run the first
    generated step (at position P, on a filled cache) from the same token.
    The caches, the step's logits and its greedy tokens are held against
    each other."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_linear as FL

    ref_server = server_cls(cfg, server.params, max_len=server.max_len, mode="eager",
                            impl="ref")
    with torch.no_grad():
        cache, tok, pos, _ = server.prefill(prompts)
        FL.LAUNCHES.reset()
        FA.LAUNCHES.reset()
        cache_ref, tok_ref, _, _ = ref_server.prefill(prompts)
        logits_ref, _ = model.decode_step(server.params, cache_ref, tok, pos, cfg, impl="ref")
        check(FL.LAUNCHES.n == 0 and FA.LAUNCHES.n == 0,
              "the impl='ref' server launched a kernel")
        logits, _ = model.decode_step(server.params, cache, tok, pos, cfg)
    P = prompts.shape[1]
    for name in ("k", "v"):
        err = assert_close(cache[name][:, :, :, :P], cache_ref[name][:, :, :, :P],
                           torch.bfloat16, f"prefilled {name} cache", TOL_MODEL_BF16)
        log(f"prefilled {name} cache ({P} positions) within bf16 tolerance of impl='ref' "
            f"(max abs err {err:.3e}, {rel_l2(cache[name], cache_ref[name]):.3e} relative L2)")
    check(torch.isfinite(logits).all().item(), "non-finite decode logits")
    err = assert_close(logits, logits_ref, torch.bfloat16, f"decode logits at pos {pos}",
                       TOL_MODEL_BF16)
    # greedy tokens: the kernel's choice must be a top choice of the
    # plain path, within twice the elementwise tolerance of its best logit
    last, last_ref = logits[:, -1].float(), logits_ref[:, -1].float()
    pick = last.argmax(-1)
    best = last_ref.max(-1).values
    slack = 2 * (TOL_MODEL_BF16["atol"] + TOL_MODEL_BF16["rtol"] * best.abs())
    check(bool((last_ref.gather(-1, pick[:, None])[:, 0] >= best - slack).all()),
          "a greedy token of the kernel server is no top choice of the plain path")
    same = int((pick == last_ref.argmax(-1)).sum())
    same_prefill = int((tok == tok_ref).sum())
    log(f"served step at pos {pos} logits {tuple(logits.shape)} within bf16 tolerance of "
        f"BatchedServer(impl='ref') (max abs err {err:.3e}, "
        f"{rel_l2(logits, logits_ref):.3e} relative L2); greedy tokens equal in "
        f"{same}/{len(pick)} rows at pos {pos} and {same_prefill}/{len(pick)} after the "
        f"prefill")


def busy_share(dev, server, prompts, steps=8):
    """Device busy share of steady decode steps: kernel time summed by
    ``torch.profiler`` over the host wall of the same steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        cache, tok, pos, step = server.prefill(prompts)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                tok, cache = step(server.params, cache, tok, pos + i)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and "CUDA" in str(e.device_type)]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    if device_ms <= 0:
        log("decode busy share: not measured (the profiler recorded no device time)")
        return
    log(f"decode busy share over {steps} steps under the profiler: device kernels "
        f"{device_ms / steps:.3f} ms per step of {wall_ms / steps:.3f} ms host wall "
        f"({100 * device_ms / wall_ms:.1f}% busy)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3 / steps:.4f} ms/step, {e.count // steps} "
            f"launches/step: {e.key[:90]}")


def main():
    if not (ROOT / "src" / "repro_torch").is_dir():
        log("FAIL: src/repro_torch is not beside this script; run it from the repository")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        log("FAIL: no CUDA device")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 results are compared
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    phase_build()
    timer = Timer(dev)
    fl_rows = phase_fused_linear(dev, timer)
    fa_row = phase_flash(dev, timer)
    launches = phase_main_path(dev)
    log(f"all phases passed in {time.perf_counter() - t0:.1f}s")

    def timing(t):
        return {"max_abs_err": t["err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"],
                "bound_by": "bytes" if t["bytes"] / HBM_BYTES_PER_S > t["flops"] / BF16_FLOPS
                else "operations",
                "library_ms": t["library_ms"]}

    def row(name, replaces, head, per_path):
        """The kernel's row: ``launches`` sums the two paths' counted runs;
        the top-level times are those of ``per_path[head]``; ``per_path``
        keeps each path's launches beside the times taken at its shapes."""
        n = {path: launches[path][name] for path in launches}
        out = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{name}.cu",
               "replaces": replaces, "launches": sum(n.values())}
        out.update(timing(per_path[head]))
        out["per_path"] = {path: dict({"launches": n[path]},
                                      **(timing(per_path[path]) if path in per_path else {}))
                           for path in n}
        return out

    # fused_linear times are one layer's three launches at the path's M
    # (4 at decode, B*S = 4096 in apply); flash runs in apply only
    kernels = [
        row("fused_linear", "src/repro/kernels/fused_linear.py:134", "serve",
            {"serve": fl_rows[4], "apply": fl_rows[4096]}),
        row("flash_attention", "src/repro/kernels/flash_attention.py:167", "apply",
            {"apply": fa_row}),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
