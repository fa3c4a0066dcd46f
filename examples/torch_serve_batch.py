"""Batched serving on the PyTorch/CUDA port: prefill + decode with the
compiled executor, in the two execution modes the paper contrasts (the
twin of ``serve_batch.py``):

* ``jit``       — the decode step compiled whole (one CUDA graph on the card)
* ``interpret`` — per-instruction flat dispatch (the per-op NPU world)

Smoke size by default, as the JAX example; ``--full`` serves the config
at full width.  It runs on the card unless ``--device cpu`` is given.

Run:  PYTHONPATH=src python examples/torch_serve_batch.py [--arch xlstm-350m] [--full]
"""
import argparse
import sys

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve import BatchedServer
from repro_torch.models import get_model

MODES = ("jit", "interpret")


def serve(cfg, params, prompts, n_new, modes=MODES, max_len=64):
    """``{mode: BatchedServer(cfg, params, max_len=max_len, mode=mode)
    .generate(prompts, n_new)}``."""
    return {mode: BatchedServer(cfg, params, max_len=max_len, mode=mode).generate(
        prompts, n_new) for mode in modes}


def main(argv=None, *, params=None, out=None):
    """``params`` replaces the seeded random init (weights made
    elsewhere, in the config's layout); ``out`` receives each mode's
    ``generate`` result and the ``prompts``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b", choices=ARCH_IDS + ["forge-125m"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--max-len", type=int, default=64, help="the KV cache's length")
    ap.add_argument("--full", action="store_true",
                    help="the config at full width (the default is the smoke config)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu; no fallback between them")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=not args.full)
    if cfg.family == "encdec":
        raise SystemExit("enc-dec serving: see repro_torch/models/encdec.py decode")
    device = resolve_device(args.device)
    if params is None:
        params = get_model(cfg).init(cfg, torch.Generator(device=device).manual_seed(0), device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (args.batch, 16)).astype(np.int32)

    results = serve(cfg, params, prompts, args.gen, max_len=args.max_len)
    for mode, res in results.items():
        print(f"[{mode:9s}] decode mean={res['decode_ms_mean']:7.2f} ms  "
              f"p99={res['decode_ms_p99']:7.2f} ms  "
              f"{res['tok_per_s']:.0f} tok/s")
    same = np.array_equal(results["jit"]["tokens"], results["interpret"]["tokens"])
    print(f"greedy tokens jit == interpret: {same}")
    print("note: jit amortizes dispatch; interpret mode exposes the "
          "per-instruction overhead the paper's scheduler minimizes.")
    if out is not None:
        out.update(results, prompts=prompts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
