"""Collective profile of a dry-run cell: a port of the JAX package's
``launch/hloprof.py``.

The reference reads its profile out of the optimized HLO; the port's is
the list of collectives one device issues in the cell's step
(``dryrun.StepCounter.collectives``: kind, output shape, output bytes):
the top collectives by payload and the count and bytes of each kind.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.hloprof --arch qwen2.5-14b \\
      --shape train_4k --layers 1
"""
from __future__ import annotations

import argparse
from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

Record = Tuple[str, Tuple[int, ...], int]  # (kind, output shape, output bytes)


def top_collectives(records: Iterable[Record], n: int = 15) -> List[Tuple[int, str, str]]:
    """The ``n`` largest collectives: (bytes, kind, shape)."""
    rows = sorted(((size, kind, "x".join(map(str, shape)) or "scalar")
                   for kind, shape, size in records), reverse=True)
    return rows[:n]


def summarize(records: Iterable[Record]) -> Dict[str, Tuple[int, float]]:
    """Per kind: (count, bytes per device)."""
    agg: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for kind, _, size in records:
        agg[kind][0] += 1
        agg[kind][1] += size
    return {k: (int(v[0]), v[1]) for k, v in agg.items()}


def main(argv=None) -> int:
    from ..configs import get_config
    from .dryrun import _run, _with_layers
    from .mesh import fake_world, make_production_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--fsdp", choices=["auto", "on", "off"], default="auto")
    ap.add_argument("--act-shard", choices=["off", "tp", "sp", "logits"], default="off")
    ap.add_argument("--moe-fsdp-dim", choices=["contract", "output"], default="contract")
    ap.add_argument("--vocab-fsdp", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)

    cfg = _with_layers(get_config(args.arch), args.layers)
    fsdp = {"auto": None, "on": True, "off": False}[args.fsdp]
    with fake_world(512 if args.multi_pod else 256):
        mesh = make_production_mesh(multi_pod=args.multi_pod)
        r = _run(cfg, args.shape, mesh, fsdp=fsdp, seq_shard_cache=True,
                 act_shard=args.act_shard, moe_fsdp_dim=args.moe_fsdp_dim,
                 vocab_fsdp=args.vocab_fsdp)
    records = r["collectives"]
    print(f"== {args.arch} {args.shape} layers={args.layers} "
          f"mesh={'2x16x16' if args.multi_pod else '16x16'} ==")
    print("-- totals per kind (count, bytes/device) --")
    for kind, (cnt, byt) in sorted(summarize(records).items(), key=lambda kv: -kv[1][1]):
        print(f"  {kind:20s} n={cnt:4d}  {byt / 2**30:10.3f} GiB")
    print(f"-- top {args.top} by payload --")
    for size, kind, shape in top_collectives(records, args.top):
        print(f"  {size / 2**30:10.3f} GiB  {kind:18s} {shape}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
