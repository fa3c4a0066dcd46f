"""Assigned input-shape sets + ``input_specs`` meta-tensor factories: a
port of the JAX package's ``configs/shapes.py``.

LM shapes are (seq_len × global_batch); ``decode_*`` / ``long_*`` drive
``serve_step`` (one new token against a seq_len KV cache), NOT
``train_step``.  ``long_500k`` needs sub-quadratic attention: it RUNS for
recurrentgemma-2b (bounded window + O(1) LRU state) and xlstm-350m (O(1)
state) and is SKIPPED for the pure full-attention archs.

Where the reference returns ``jax.ShapeDtypeStruct`` stand-ins, these
return tensors on the ``meta`` device: a shape and a dtype, no storage
(the dry run turns them into fake tensors placed by a sharding plan).
``cache_specs`` keeps the reference's trees (they equal the port's
``init_cache`` for the dense, MoE and VLM families); ``params_specs``
runs the port's own ``init`` on the meta device, so its tree is the
port's (per-layer lists where the reference stacks layers).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from .base import ModelConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

#: archs allowed to run long_500k (sub-quadratic decode state)
SUBQUADRATIC = ("recurrentgemma-2b", "xlstm-350m")

#: stub-frontend patch count for the VLM train/prefill cells
VLM_N_PATCHES = 64
#: encoder frame count = seq_len for the enc-dec cells (audio frames)


def sds(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in: a tensor on the meta device."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def shape_applicable(cfg: ModelConfig, shape_name: str) -> Tuple[bool, str]:
    """(runs?, reason)."""
    base = cfg.name.replace("-smoke", "")
    if shape_name == "long_500k" and base not in SUBQUADRATIC:
        return False, ("full-attention arch: 500k dense-KV decode is "
                       "quadratic-history; shape reserved for sub-quadratic "
                       "archs (DESIGN §Arch-applicability)")
    return True, ""


def input_specs(
    cfg: ModelConfig,
    shape_name: str,
    *,
    seq_len: Optional[int] = None,
    global_batch: Optional[int] = None,
) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every model input of the step.

    train  -> the batch of ``train_step``  (tokens, labels, extras)
    prefill-> the batch of ``prefill_step`` (tokens, extras)
    decode -> the arguments of ``serve_step`` (cache, token, pos)
    """
    spec = SHAPES[shape_name]
    S = seq_len if seq_len is not None else spec.seq_len
    B = global_batch if global_batch is not None else spec.global_batch
    dt = _dtype(cfg)
    tok = torch.int32

    if spec.kind in ("train", "prefill"):
        out: Dict[str, Any] = {}
        if cfg.family == "encdec":
            out["frames"] = sds((B, S, cfg.d_model), dt)
            out["tokens"] = sds((B, S), tok)
        elif cfg.family == "vlm":
            n_p = min(VLM_N_PATCHES, S // 2)
            out["tokens"] = sds((B, S - n_p), tok)
            out["patches"] = sds((B, n_p, cfg.d_model), dt)
        else:
            out["tokens"] = sds((B, S), tok)
        if spec.kind == "train":
            out["labels"] = sds((B, S), tok)
        return out

    # decode: one new token against a seq_len-sized state
    return {
        "token": sds((B, 1), tok),
        "pos": sds((), torch.int32),
        "cache": cache_specs(cfg, B, S),
    }


def cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    """Meta-tensor tree matching each family's ``init_cache`` in the
    JAX package."""
    dt = _dtype(cfg)
    hd = cfg.head_dim_
    if cfg.family in ("dense", "moe", "vlm"):
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, hd)
        return {"k": sds(shape, dt), "v": sds(shape, dt)}
    if cfg.family == "encdec":
        n_dec = cfg.n_dec_layers or cfg.n_layers
        kv = (n_dec, batch, cfg.n_kv_heads, max_len, hd)
        # cross K/V over the encoder frames (= max_len stand-in)
        cr = (n_dec, batch, cfg.n_kv_heads, max_len, hd)
        return {
            "self_k": sds(kv, dt), "self_v": sds(kv, dt),
            "cross_k": sds(cr, dt), "cross_v": sds(cr, dt),
        }
    if cfg.family == "hybrid":
        lru = cfg.lru_dim or cfg.d_model
        window = min(cfg.window or max_len, max_len)
        layers = []
        pat = cfg.block_pattern or ("rec", "rec", "attn")
        for i in range(cfg.n_layers):
            if pat[i % len(pat)] == "attn":
                layers.append({
                    "k": sds((batch, cfg.n_kv_heads, window, hd), dt),
                    "v": sds((batch, cfg.n_kv_heads, window, hd), dt),
                })
            else:
                layers.append({
                    "h": sds((batch, lru), torch.float32),
                    "conv": sds((batch, cfg.conv_width - 1, lru), dt),
                })
        return {"layers": layers}
    if cfg.family == "ssm":
        inner = 2 * cfg.d_model
        H = cfg.n_heads
        hd_m = inner // H
        hd_s = cfg.d_model // H
        layers = []
        for i in range(cfg.n_layers):
            if cfg.slstm_every and (i + 1) % cfg.slstm_every == 0:
                z = sds((batch, H, hd_s), torch.float32)
                layers.append({"c": z, "n": z, "h": z, "m": z})
            else:
                layers.append({
                    "conv": sds((batch, cfg.conv_width - 1, inner), dt),
                    "cell": {
                        "C": sds((batch, H, hd_m, hd_m), torch.float32),
                        "n": sds((batch, H, hd_m), torch.float32),
                        "m": sds((batch, H), torch.float32),
                    },
                })
        return {"layers": layers}
    raise ValueError(cfg.family)


def params_specs(cfg: ModelConfig):
    """The port's parameter tree on the meta device (no allocation): the
    family's ``init`` run there, as ``jax.eval_shape`` runs the
    reference's."""
    from ..models import get_model

    return get_model(cfg).init(cfg, None, "meta")
