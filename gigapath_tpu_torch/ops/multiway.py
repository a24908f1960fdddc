"""Multiway (BEiT-3) two-branch modules (counterpart of
``gigapath_tpu/ops/multiway.py``).

:class:`MultiwayNetwork` holds two copies of a module, ``A`` and ``B``
(torchscale's keys): tokens before ``split_position`` go through A, the rest
through B; ``-1`` sends every token through A, ``0`` every token through B.
torchscale sets the split on the modules before a call; here, as in the
JAX package, it is an argument of each call. :func:`call` gives one call
surface for a module that may or may not be multiway.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn


class MultiwayNetwork(nn.Module):
    def __init__(self, module_fn: Callable[[], nn.Module], dim: int = 1):
        super().__init__()
        self.dim = dim
        self.A = module_fn()
        self.B = module_fn()

    def forward(self, x: torch.Tensor, *args, split_position: int = -1, **kwargs):
        if split_position == -1:
            return self.A(x, *args, **kwargs)
        if split_position == 0:
            return self.B(x, *args, **kwargs)
        x1, x2 = torch.split(x, [split_position, x.shape[self.dim] - split_position], dim=self.dim)
        return torch.cat([self.A(x1, *args, **kwargs), self.B(x2, *args, **kwargs)], dim=self.dim)


def maybe_multiway(multiway: bool, module_fn: Callable[[], nn.Module], dim: int = 1) -> nn.Module:
    """A :class:`MultiwayNetwork` of ``module_fn`` when ``multiway``, else
    one ``module_fn()``."""
    return MultiwayNetwork(module_fn, dim=dim) if multiway else module_fn()


def multiway_layernorm(multiway: bool, dim: int, eps: float) -> nn.Module:
    """The LayerNorm of every norm site of the encoder and attention stack,
    multiway-split when ``multiway``."""
    return maybe_multiway(multiway, lambda: nn.LayerNorm(dim, eps=eps))


def call(module: nn.Module, x: torch.Tensor, *args, split_position: int = -1, **kwargs):
    """``module(x, ...)``, routed by ``split_position`` when the module is
    multiway (the split is ignored otherwise)."""
    if isinstance(module, MultiwayNetwork):
        return module(x, *args, split_position=split_position, **kwargs)
    return module(x, *args, **kwargs)
