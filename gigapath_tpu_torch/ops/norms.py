"""Normalization layers (counterpart of ``gigapath_tpu/ops/norms.py``).

LayerNorm is ``torch.nn.LayerNorm``. :class:`RMSNorm` has parity with the
reference ``torchscale/component/rms_norm.py`` and the JAX package's:
fp32 accumulation, the normalized value rounded to the input dtype before
the optional affine ``weight`` (the torchscale key, which is also the flax
parameter's name, so ``state_dict_from_flax_params`` carries it as it is).
"""

from __future__ import annotations

import torch
from torch import nn


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, elementwise_affine: bool = True):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim)) if elementwise_affine else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        normed = (x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + self.eps)).to(x.dtype)
        if self.weight is not None:
            normed = normed * self.weight.to(normed.dtype)
        return normed
