"""Feed-forward blocks (counterpart of ``gigapath_tpu/ops/feedforward.py``):
fc1 -> activation -> [sub-LN] -> fc2, and RetNet's bias-free :class:`GLU`.

The JAX package's ``gelu`` is flax's default, the tanh approximation, so
the port uses ``approximate="tanh"`` (torchscale itself uses exact GELU).
The activation takes ``fc1``'s output in its own dtype: PyTorch computes a
bf16 GELU in fp32 internally and rounds once, so the result equals that of
an explicit fp32 round trip, without the two fp32 ``[L, ffn_dim]`` copies
(nor the fp32 tensor autograd would save for the backward).

With a ``model_group`` of T ranks (:mod:`gigapath_tpu_torch.parallel.tensor`)
``fc1`` is column-parallel (``[ffn_dim/T, E]``), the activation dropout and
the sub-LN act on the rank's slice of ``ffn_dim`` (the whole width's mask,
sliced; the statistics all-reduced), ``fc2`` is row-parallel (``[E,
ffn_dim/T]``) and the output dropout acts on the replicated sum.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gigapath_tpu_torch.parallel.tensor import (
    ShardedLayerNorm,
    copy_to_group,
    rank_and_world,
    row_parallel_linear,
    sharded_dropout,
)


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
        model_group=None,
    ):
        super().__init__()
        world = rank_and_world(model_group)[1]
        if ffn_dim % world:
            raise ValueError(f"tensor parallelism over {world} ranks needs ffn_dim {ffn_dim} divisible by it")
        self.model_group = model_group if world > 1 else None
        local = ffn_dim // world
        self.act = _activation(activation_fn)
        self.fc1 = nn.Linear(embed_dim, local)
        self.fc2 = nn.Linear(local, embed_dim)
        self.activation_dropout = nn.Dropout(activation_dropout)
        self.dropout = nn.Dropout(dropout)
        if not subln:
            self.ffn_layernorm = None
        elif self.model_group is not None:
            self.ffn_layernorm = ShardedLayerNorm(local, self.model_group, eps=layernorm_eps)
        else:
            self.ffn_layernorm = nn.LayerNorm(ffn_dim, eps=layernorm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.model_group is None:
            h = self.activation_dropout(self.act(self.fc1(x)))
        else:
            h = self.act(self.fc1(copy_to_group(x, self.model_group)))
            h = sharded_dropout(h, self.activation_dropout.p, self.training, self.model_group)
        if self.ffn_layernorm is not None:
            h = self.ffn_layernorm(h)
        return self.dropout(row_parallel_linear(h, self.fc2, self.model_group))


class GLU(nn.Module):
    """Gated linear unit (torchscale's ``GLU``, the JAX package's ``GLU``):
    ``fc2(act(fc1(x)) * gate(x))``, all three bias-free, with activation and
    output dropout."""

    def __init__(self, embed_dim: int, ffn_dim: int, activation_fn: str = "gelu", dropout: float = 0.0,
                 activation_dropout: float = 0.0):
        super().__init__()
        self.act = _activation(activation_fn)
        self.fc1 = nn.Linear(embed_dim, ffn_dim, bias=False)
        self.gate = nn.Linear(embed_dim, ffn_dim, bias=False)
        self.fc2 = nn.Linear(ffn_dim, embed_dim, bias=False)
        self.activation_dropout = nn.Dropout(activation_dropout)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.activation_dropout(self.act(self.fc1(x)) * self.gate(x))
        return self.dropout(self.fc2(h))
