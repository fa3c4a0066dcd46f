"""Qwen2-VL-72B backbone: decoder-only transformer with M-RoPE.

A port of the JAX package's ``models/vlm.py``.  The vision frontend is a
stub, as there: callers hand precomputed patch embeddings (B, N_patches,
d_model), which :func:`merge_patches` puts ahead of the text-token
embeddings; this module is the LM backbone with multimodal rotary
positions (three streams, temporal / height / width, whose sections sum
to head_dim/2).

Decode takes one shared position (the serve CLI's group lockstep): the
reference broadcasts it to all three streams, so the VLM has no
slot-level decode and no paged path.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..configs.base import ModelConfig
from . import layers as L
from . import transformer as T

Params = Dict[str, Any]

init = T.init  # the dense transformer's parameter layout
init_cache = T.init_cache


def text_mrope_positions(B: int, S: int, offset: int = 0,
                         device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """Text-only M-RoPE: all three streams share the sequence index."""
    p = torch.arange(offset, offset + S, dtype=torch.int32, device=device)[None].repeat(B, 1)
    return torch.stack([p, p, p])  # (3, B, S)


def merge_patches(params: Params, tokens: torch.Tensor, patch_embeds: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stub frontend: prepend the patch embeddings to the text embeddings
    and build the (3, B, S) position streams: patches on a 2-D grid of
    side ⌊√N⌋ at time 0, text from 1 on in every stream."""
    B, N, _ = patch_embeds.shape
    text = L.embed(tokens, params["embed"])
    x = torch.cat([patch_embeds.to(text.dtype), text], dim=1)
    S = x.shape[1]
    side = max(int(N ** 0.5), 1)
    dev = x.device
    grid = torch.arange(N, dtype=torch.int32, device=dev)
    text_pos = torch.arange(1, S - N + 1, dtype=torch.int32, device=dev)
    t_pos = torch.cat([torch.zeros((N,), dtype=torch.int32, device=dev), text_pos])
    h_pos = torch.cat([grid // side, text_pos])
    w_pos = torch.cat([grid % side, text_pos])
    pos = torch.stack([t_pos, h_pos, w_pos])[:, None].repeat(1, B, 1)  # (3, B, S)
    return x, pos


def apply(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
          patch_embeds: Optional[torch.Tensor] = None,
          impl: Optional[str] = None) -> torch.Tensor:
    if patch_embeds is not None:
        embeds, pos = merge_patches(params, tokens, patch_embeds)
        return T.apply(params, None, cfg, embeds=embeds, mrope_positions=pos, impl=impl)
    B, S = tokens.shape
    pos = text_mrope_positions(B, S, device=tokens.device)
    return T.apply(params, tokens, cfg, mrope_positions=pos, impl=impl)


def decode_step(params: Params, cache: Dict[str, torch.Tensor], token: torch.Tensor,
                pos: Union[int, torch.Tensor], cfg: ModelConfig, *,
                impl: Optional[str] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One serve step at one shared position, broadcast to the three
    M-RoPE streams (3, B, 1)."""
    B = token.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int64, device=token.device)
    mpos = pos.reshape(1, 1, 1).expand(3, B, 1).to(torch.int32)
    return T.decode_step(params, cache, token, pos, cfg, mrope_positions=mpos, impl=impl)
