"""Post-init weight transforms (counterpart of
``gigapath_tpu/architecture/init.py``), on a module's parameters (in
place) or on a ``state_dict`` (a new dict):

- :func:`apply_init_scaling`: sub-LN multiplies the ``fc1`` / ``fc2`` /
  ``out_proj`` / ``v_proj`` matrices by ``sqrt(log(2L))`` (encoder-decoder
  ``sqrt(log(3 L_dec) * log(2 L_enc) / 3)``); deepnorm divides them by
  ``(8L) ** 0.25`` (encoder-decoder ``(L_enc^4 L_dec) ** (1/16) / 1.15``),
  torchscale's post-init rescaling;
- :func:`init_bert_params`: BERT's re-init, every matrix and embedding
  table redrawn from a normal truncated at +-2 (std 0.02, q/k/v
  ``0.02/sqrt(2)``), divided by the truncated unit normal's std so that the
  delivered std is exactly the target; vectors (biases, norms) kept.

A matrix is a ``weight`` of two or more dims (the JAX package's
``kernel`` and ``embedding``; stacked experts included).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Union

import torch
from torch import nn

_SCALED = ("fc1", "fc2", "out_proj", "v_proj")
_TRUNC_STD = 0.87962566103423978  # std of the unit normal truncated at +-2

Params = Union[nn.Module, Mapping[str, torch.Tensor]]


def subln_init_scale(num_layers: int, is_encoder_decoder: bool = False, decoder_layers: int = 0) -> float:
    if is_encoder_decoder:
        return math.sqrt(math.log(3 * decoder_layers) * math.log(2 * num_layers) / 3)
    return math.sqrt(math.log(num_layers * 2))


def deepnorm_init_scale(num_layers: int, is_encoder_decoder: bool = False, decoder_layers: int = 0) -> float:
    if is_encoder_decoder:
        return math.pow(math.pow(num_layers, 4) * decoder_layers, 0.0625) / 1.15
    return math.pow(8.0 * num_layers, 0.25)


def _is_matrix(name: str, tensor: torch.Tensor) -> bool:
    return name.rsplit(".", 1)[-1] == "weight" and tensor.dim() >= 2


def _transform(params: Params, fn) -> Params:
    """``fn(name, tensor)`` -> a new tensor or None (kept), over a module's
    parameters in place or into a copy of a state dict."""
    if isinstance(params, nn.Module):
        with torch.no_grad():
            for name, p in params.named_parameters():
                new = fn(name, p)
                if new is not None:
                    p.copy_(new)
        return params
    out: Dict[str, torch.Tensor] = {}
    for name, t in params.items():
        new = fn(name, t)
        out[name] = t if new is None else new.to(t.dtype)
    return out


def apply_init_scaling(params: Params, *, subln: bool, deepnorm: bool, num_layers: int,
                       is_encoder_decoder: bool = False, decoder_layers: int = 0) -> Params:
    """Torchscale's sub-LN or deepnorm rescaling of the FFN and attention
    value/output matrices."""
    if subln:
        factor = subln_init_scale(num_layers, is_encoder_decoder, decoder_layers)
    elif deepnorm:
        factor = 1.0 / deepnorm_init_scale(num_layers, is_encoder_decoder, decoder_layers)
    else:
        return params

    def scale(name, t):
        if _is_matrix(name, t) and any(part in _SCALED for part in name.split(".")):
            return t * factor
        return None

    return _transform(params, scale)


def init_bert_params(params: Params, generator: Optional[torch.Generator] = None, std: float = 0.02) -> Params:
    """BERT's re-init of every matrix and embedding table (the generator's
    draws, torch's default generator when None)."""

    def redraw(name, t):
        if not _is_matrix(name, t):
            return None
        scale = std / math.sqrt(2) if any(p in ("q_proj", "k_proj", "v_proj") for p in name.split(".")) else std
        draw = torch.empty(t.shape, dtype=torch.float32)
        torch.nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return (draw * (scale / _TRUNC_STD)).to(device=t.device, dtype=t.dtype)

    return _transform(params, redraw)
