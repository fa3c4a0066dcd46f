"""Parameters from the JAX package's layout, as numpy, into the port's.

``params_from_numpy(tree, device)`` takes the JAX model's parameter
pytree with its leaves already converted to numpy (``np.asarray`` on
each ``jax.Array``; bfloat16 leaves arrive as ``ml_dtypes.bfloat16``)
and returns the port's parameter dict:

* layer-stacked ``blocks`` (a leading ``n_layers`` axis on every leaf,
  the JAX package's ``scan_layers`` layout) or a list of per-layer dicts
  become a list of per-layer dicts; so do the encoder-decoder family's
  ``enc_blocks`` and ``dec_blocks``;
* every other leaf converts as is: among them the MoE family's fp32
  ``router``, its (E, d, f) / (E, f, d) expert stacks and kimi-k2's
  ``shared`` SwiGLU, which keep their dtypes and shapes;
* leaves that are one numpy object (a tied embedding / LM head) become
  ONE tensor, so the tie survives into Phase-1 capture.

Optimizer states: ``adamw_state_from_numpy`` takes the JAX package's
``AdamWState`` (``mu`` and ``nu`` are laid out like the params, so they
unstack as the params do); ``adafactor_state_from_numpy`` its
``AdafactorState``, whose ``vr`` / ``vc`` / ``v`` keep the JAX package's
stacked layer lists, the layout the port's Adafactor keeps its state in
(see ``optim/adafactor.py``).

The port imports no JAX: callers hand over numpy, never jax arrays.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from .device import resolve_device


def _to_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    # np.ascontiguousarray gives a 0-d array one dimension
    return t.reshape(a.shape).to(device)


#: the layer lists: the decoder-only families' ``blocks``, the
#: encoder-decoder family's ``enc_blocks`` and ``dec_blocks``
LAYER_KEYS = ("blocks", "enc_blocks", "dec_blocks")


def params_from_numpy(tree: Dict[str, Any],
                      device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    device = resolve_device(device)
    memo: Dict[int, torch.Tensor] = {}

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        t = memo.get(id(x))
        if t is None:
            t = memo[id(x)] = _to_tensor(x, device)
        return t

    out = {k: conv(v) for k, v in tree.items() if k not in LAYER_KEYS}
    for key in LAYER_KEYS:
        if key not in tree:
            continue
        blocks = tree[key]
        if isinstance(blocks, dict):  # layer-stacked leaves
            stacked = conv(blocks)
            n = len(next(iter(_leaves(stacked))))
            out[key] = [_index(stacked, i) for i in range(n)]
        else:
            out[key] = [conv(b) for b in blocks]
    return out


def _leaves(d):
    for v in d.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _index(d, i):
    return {k: (_index(v, i) if isinstance(v, dict) else v[i].contiguous())
            for k, v in d.items()}


def adamw_state_from_numpy(state: Any, device: Union[str, torch.device] = "cuda"):
    """The JAX package's ``AdamWState`` (numpy leaves) as the port's."""
    from .optim import AdamWState

    device = resolve_device(device)
    return AdamWState(step=_to_tensor(state.step, device),
                      mu=params_from_numpy(state.mu, device),
                      nu=params_from_numpy(state.nu, device))


def adafactor_state_from_numpy(state: Any, device: Union[str, torch.device] = "cuda"):
    """The JAX package's ``AdafactorState`` (numpy leaves) as the port's:
    the same tree, stacked layer lists included."""
    from .optim import AdafactorState

    device = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return _to_tensor(x, device)

    return AdafactorState(step=_to_tensor(state.step, device), vr=conv(state.vr),
                          vc=conv(state.vc), v=conv(state.v))
