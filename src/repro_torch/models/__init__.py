"""Model zoo: one module per architecture family, uniform API.

``get_model(cfg)`` returns a :class:`ModelAPI` with

* ``init(cfg, generator, device)``              parameter dict
* ``apply(params, tokens, cfg)``                full-sequence logits
* ``init_cache(cfg, batch, max_len, device)``   decode state
* ``decode_step(params, cache, tok, pos, cfg)`` one-token serve step
* ``paged_decode_step`` / ``paged_prefill_step`` / ``init_paged_cache``
  the same against a flat page pool (continuous batching)

The port carries the dense family so far.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

from ..configs.base import ModelConfig
from . import attention, layers, transformer


@dataclass(frozen=True)
class ModelAPI:
    family: str
    init: Callable
    apply: Callable
    decode_step: Callable
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


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r}: the port carries the dense "
                                  f"decoder so far")
    m = transformer
    return ModelAPI(family=cfg.family, init=m.init, apply=m.apply,
                    decode_step=m.decode_step, init_cache=m.init_cache, module=m,
                    paged_decode_step=m.paged_decode_step,
                    paged_prefill_step=m.paged_prefill_step,
                    init_paged_cache=m.init_paged_cache)


__all__ = ["ModelAPI", "get_model", "attention", "layers", "transformer"]
