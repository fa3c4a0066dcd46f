"""Quickstart on the PyTorch/CUDA port: compile a transformer block with
Forge-UGC and inspect every phase (the twin of ``quickstart.py``).

The block is the same unfused GQA block, written with torch ops; the
compiler captures it with ``torch.export`` at the ATen level, so node
counts are not the JAX example's, the fused ops are.  It runs on the
card unless ``--device cpu`` is given.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import math
import sys

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import ForgeCompiler, PipelineConfig
from repro_torch.core.metrics import fidelity, fusion_gain_ratio
from repro_torch.device import resolve_device


def gqa_block(x, wq, wk, wv, wo, w_gate, w_up, w_down):
    """An unfused GQA transformer block (what the compiler sees)."""
    B, S, E = x.shape
    H, KVH = 8, 2
    D = E // H
    q = (x @ wq).reshape(B, S, H, D).transpose(1, 2)
    k = (x @ wk).reshape(B, S, KVH, D).transpose(1, 2)
    v = (x @ wv).reshape(B, S, KVH, D).transpose(1, 2)
    g = H // KVH
    k = k.unsqueeze(2).expand(B, KVH, g, S, D).reshape(B, H, S, D)
    v = v.unsqueeze(2).expand(B, KVH, g, S, D).reshape(B, H, S, D)
    s = torch.matmul(q, k.transpose(-2, -1)) * (1.0 / math.sqrt(D))
    row = torch.arange(S, device=x.device).view(S, 1)
    col = torch.arange(S, device=x.device).view(1, S)
    s = torch.where(row >= col, s, torch.finfo(s.dtype).min)
    o = torch.matmul(torch.softmax(s, dim=-1), v)
    x = x + o.transpose(1, 2).reshape(B, S, E) @ wo
    h = F.silu(x @ w_gate) * (x @ w_up)  # SwiGLU, unfused
    return x + h @ w_down


def make_args(device="cpu"):
    """The JAX example's inputs: numpy normals from seed 0, times 0.1."""
    rng = np.random.default_rng(0)
    B, S, E, F_ = 2, 64, 64, 128
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.1).to(device)
            for s in [(B, S, E), (E, E), (E, E // 4), (E, E // 4), (E, E),
                      (E, F_), (E, F_), (F_, E)]]


def main(argv=None, *, out=None):
    """``out`` receives the compiled module, the block's output before and
    after compilation, the fidelity report and the FGR."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu; no fallback between them")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    block_args = make_args(device)

    # four phases: capture -> passes -> RGIR -> scheduled executor
    mod = ForgeCompiler(PipelineConfig()).compile(gqa_block, *block_args)

    print("=== CompilationResult (paper Limitation 2: full transparency) ===")
    print(mod.result.summary())
    print("\n=== per-pass profile (paper Table 10) ===")
    for row in mod.result.pass_table():
        print(f"  {row['pass']:20s} {row['time_ms']:8.2f} ms "
              f"delta_nodes={row['delta_nodes']:+4d}  {row['detail']}")

    print("\n=== fused graph ===")
    for node in mod.graph.nodes.values():
        if node.is_fused:
            print(f"  {node.op}  params={ {k: v for k, v in node.params.items() if k != 'impl'} }")

    # numerical fidelity (paper Table 6 protocol)
    pre = gqa_block(*block_args)
    post = mod(*block_args)
    rep = fidelity(pre, post)
    print(f"\nfidelity: max-abs={rep.max_abs_diff:.2e} KL={rep.kl_divergence:.2e}")

    fgr = fusion_gain_ratio(gqa_block, *block_args)
    print(f"FGR (Eq. 22): {fgr['fgr']:.1f}")
    print(f"output shape: {tuple(post.shape)} on {post.device} — OK")
    if out is not None:
        out.update(module=mod, pre=pre, post=post, fidelity=rep, fgr=fgr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
