"""Stochastic depth (counterpart of ``gigapath_tpu/ops/droppath.py``).

Identity in eval mode, the only mode the port runs so far: training waits
for the backward slice (``ROADMAP.md``), so a training-mode call with a
nonzero rate raises instead of silently keeping every path.
"""

from __future__ import annotations

import torch
from torch import nn


class DropPath(nn.Module):
    def __init__(self, drop_prob: float = 0.0):
        super().__init__()
        self.drop_prob = drop_prob

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.drop_prob > 0.0:
            raise NotImplementedError("DropPath in training mode is not ported yet (ROADMAP.md)")
        return x

    def extra_repr(self) -> str:
        return f"p={self.drop_prob}"
