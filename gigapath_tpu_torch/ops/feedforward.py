"""Feed-forward block (counterpart of ``gigapath_tpu/ops/feedforward.py``):
fc1 -> activation -> [sub-LN] -> fc2.

The JAX package's ``gelu`` is flax's default, the tanh approximation, so
the port uses ``approximate="tanh"`` (torchscale itself uses exact GELU).
The activation takes ``fc1``'s output in its own dtype: PyTorch computes a
bf16 GELU in fp32 internally and rounds once, so the result equals that of
an explicit fp32 round trip, without the two fp32 ``[L, ffn_dim]`` copies
(nor the fp32 tensor autograd would save for the backward).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _activation(name: str):
    if name == "relu":
        return F.relu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "swish":
        return F.silu
    raise NotImplementedError(f"unknown activation: {name}")


class FeedForwardNetwork(nn.Module):
    def __init__(
        self,
        embed_dim: int,
        ffn_dim: int,
        activation_fn: str = "gelu",
        dropout: float = 0.0,
        activation_dropout: float = 0.0,
        layernorm_eps: float = 1e-5,
        subln: bool = False,
    ):
        super().__init__()
        self.act = _activation(activation_fn)
        self.fc1 = nn.Linear(embed_dim, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, embed_dim)
        self.activation_dropout = nn.Dropout(activation_dropout)
        self.dropout = nn.Dropout(dropout)
        self.ffn_layernorm = nn.LayerNorm(ffn_dim, eps=layernorm_eps) if subln else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        h = self.act(h)
        h = self.activation_dropout(h)
        if self.ffn_layernorm is not None:
            h = self.ffn_layernorm(h)
        return self.dropout(self.fc2(h))
