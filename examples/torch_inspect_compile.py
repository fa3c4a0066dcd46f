"""Compile every assigned architecture's block through Forge-UGC on the
PyTorch/CUDA port and print the per-arch fusion report — the paper's
Table 5 (node reduction) on the model zoo (the twin of
``inspect_compile.py``).  The capture is ``torch.export`` at the ATen
level, so node counts are not the JAX example's; the fused ops and the
attention fusions are.  It runs on the card unless ``--device cpu`` is
given.

Run:  PYTHONPATH=src python examples/torch_inspect_compile.py [--device cpu]
"""
import argparse
import sys

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import ForgeCompiler, PipelineConfig
from repro_torch.device import resolve_device
from repro_torch.models import get_model, layers as L
from repro_torch.models import transformer as T


def compile_arch(arch, device):
    """The arch's smoke block (dense, MoE, VLM) or whole model (the other
    families) compiled by the default pipeline; its ``CompilationResult``."""
    cfg = get_config(arch, smoke=True).with_(fuse="none")
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator(device=device).manual_seed(0), device)
    tokens = torch.zeros((2, 16), dtype=torch.int32, device=device)
    dtype = getattr(torch, cfg.dtype)
    if cfg.family in ("dense", "moe", "vlm"):
        x = torch.zeros((2, 16, cfg.d_model), dtype=dtype, device=device)
        cos, sin = L.rope_tables(torch.arange(16, device=device), cfg.head_dim_, cfg.rope_theta)
        fn = lambda p, x, c, s: T.block_apply(p, x, c, s, cfg)  # noqa: E731
        args = (params["blocks"][0], x, cos, sin)
    elif cfg.family == "encdec":  # whole-model capture for the other families
        frames = torch.zeros((2, 16, cfg.d_model), dtype=dtype, device=device)
        fn = lambda p, f, t: model.apply(p, f, t, cfg)  # noqa: E731
        args = (params, frames, tokens)
    else:
        fn = lambda p, t: model.apply(p, t, cfg)  # noqa: E731
        args = (params, tokens)
    return ForgeCompiler(PipelineConfig()).compile(fn, *args).result


def main(argv=None, *, out=None):
    """``out`` receives each arch's ``CompilationResult``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu; no fallback between them")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(f"{'arch':30s} {'nodes':>12s} {'red%':>6s} {'fused':>6s} "
          f"{'attn':>5s} {'rho_buf':>8s} {'delta':>10s}")
    for arch in ARCH_IDS:
        r = compile_arch(arch, device)
        s = r.executor_stats
        print(f"{arch:30s} {r.nodes_before:5d}->{r.nodes_after:5d} "
              f"{100*r.node_reduction:5.1f}% {r.fused_ops:6d} "
              f"{r.attention_fused:5d} {s.rho_buf:7.1%} "
              f"{s.delta_before:4d}->{s.delta_after:<4d}")
        if out is not None:
            out[arch] = r
    print("\n(xlstm shows attention_fused=0: documented inapplicability — "
          "no softmax-attention subgraph exists in that family)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
