"""End-to-end training on the PyTorch/CUDA port (the twin of
``train_lm.py``): train a ~100M-param LM for a few hundred steps.

This drives the real stack — Forge-compiled blocks, AdamW, the
deterministic data pipeline, async checkpointing, the fault-tolerant
supervisor — through ``repro_torch.launch.train``, on the smoke config
unless ``--full`` (the true 125M layout).  It runs on the card unless
``--device cpu`` is given.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] [--full]
"""
import argparse
import os
import sys
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None, *, params=None, out=None):
    """``params`` and ``out`` pass through to ``launch.train.main``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true", help="true 125M config")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "forge_train_lm"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu; no fallback between them")
    args = ap.parse_args(argv)

    train_argv = [
        "--arch", "forge-125m",
        "--steps", str(args.steps),
        "--batch", "8", "--seq", "128",
        "--ckpt-dir", args.ckpt_dir,
        "--ckpt-every", "50",
        "--device", args.device,
    ]
    if not args.full:
        train_argv.append("--smoke")
    return train_main(train_argv, params=params, out=out)


if __name__ == "__main__":
    sys.exit(main())
