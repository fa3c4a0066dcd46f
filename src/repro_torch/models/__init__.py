"""Model zoo: one module per architecture family, uniform API.

``get_model(cfg)`` returns a :class:`ModelAPI` with

* ``init(cfg, generator, device)``              parameter dict
* ``apply(params, tokens, cfg)``                full-sequence logits
* ``init_cache(cfg, batch, max_len, device)``   decode state
* ``decode_step(params, cache, tok, pos, cfg)`` one-token serve step
* ``prefill_step(params, cache, tokens, pos, cfg)`` whole-prompt prefill
* ``paged_decode_step`` / ``paged_prefill_step`` / ``init_paged_cache``
  the same against a flat page pool (continuous batching)

The port carries every family of the JAX package: the dense and MoE
decoders (``transformer``), the VLM backbone (``vlm``), the RG-LRU hybrid
(``rglru``), the xLSTM family (``ssm``: ``xlstm``) and the
encoder-decoder family (``encdec``), whose ``apply(params, frames,
tokens, cfg)`` and ``init_cache(params, frames, cfg, max_len)`` take the
frame embeddings, as the reference's do.  An unknown family raises
``ValueError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

from ..configs.base import ModelConfig
from . import attention, encdec, layers, losses, moe, rglru, transformer, vlm, xlstm


@dataclass(frozen=True)
class ModelAPI:
    family: str
    init: Callable
    apply: Callable
    decode_step: Callable
    #: whole-prompt batched prefill — (params, cache, tokens(B,S), pos)
    #: -> ((B,S,V) logits, cache); the recurrent families fold the chunk
    #: into state through a scan (see prefill_takes_length); None where a
    #: family cannot reproduce sequential decode in one pass (MoE
    #: capacity routing): those prefill sequentially
    prefill_step: Optional[Callable]
    init_cache: Callable
    module: Any
    #: True when the decode cache carries non-positional state (recurrent
    #: families): a swapped-in slot must be reset first.  The dense
    #: decoder's KV cache is positional.
    stateful_decode: bool = False
    #: paged-KV entry points: decode/prefill against a flat page pool and
    #: a per-slot page table (see core/paging.py);
    #: init_paged_cache(cfg, batch, max_len, *, num_pages, page_size)
    paged_decode_step: Optional[Callable] = None
    paged_prefill_step: Optional[Callable] = None
    init_paged_cache: Optional[Callable] = None
    #: True when ``prefill_step`` accepts a per-row ``length=`` kwarg:
    #: recurrent state consumes every chunk token (no positional mask
    #: can hide padding afterwards), so the serve fronts must tell the
    #: scan where each row's real prompt ends
    prefill_takes_length: bool = False


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family in ("dense", "moe"):
        m = transformer
    elif cfg.family == "hybrid":
        m = rglru
    elif cfg.family == "ssm":
        m = xlstm
    elif cfg.family == "encdec":
        m = encdec
    elif cfg.family == "vlm":
        m = vlm
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    # a family module owns the knowledge of when a whole-block prefill
    # pass reproduces sequential decode; the registry stays family-agnostic
    prefill = getattr(m, "prefill_step", None)
    supports = getattr(m, "supports_batched_prefill", None)
    if prefill is not None and supports is not None and not supports(cfg):
        prefill = None
    paged_prefill = getattr(m, "paged_prefill_step", None)
    if paged_prefill is not None and supports is not None and not supports(cfg):
        paged_prefill = None
    return ModelAPI(
        family=cfg.family,
        init=m.init,
        apply=m.apply,
        decode_step=m.decode_step,
        prefill_step=prefill,
        init_cache=m.init_cache,
        module=m,
        stateful_decode=getattr(m, "STATEFUL_DECODE", False),
        paged_decode_step=getattr(m, "paged_decode_step", None),
        paged_prefill_step=paged_prefill,
        init_paged_cache=getattr(m, "init_paged_cache", None),
        prefill_takes_length=(prefill is not None
                              and getattr(m, "PREFILL_TAKES_LENGTH", False)),
    )


__all__ = ["ModelAPI", "get_model", "attention", "encdec", "layers", "losses", "moe", "rglru",
           "transformer", "vlm", "xlstm"]
