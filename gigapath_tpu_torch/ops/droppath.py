"""Stochastic depth (counterpart of ``gigapath_tpu/ops/droppath.py``).

Per-sample Bernoulli keep on the batch axis, the kept rows rescaled by the
keep probability, in training mode; identity in eval mode. The keep mask
draws from ``generator`` when the caller passes one, else from torch's
default generator (the two packages draw different bits from one seed).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class DropPath(nn.Module):
    def __init__(self, drop_prob: float = 0.0):
        super().__init__()
        self.drop_prob = drop_prob

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.drop_prob == 0.0 or not self.training:
            return x
        keep_prob = 1.0 - self.drop_prob
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        keep = torch.rand(shape, generator=generator, device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))

    def extra_repr(self) -> str:
        return f"p={self.drop_prob}"
