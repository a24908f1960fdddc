"""T5-style bucketed relative position bias (counterpart of
``gigapath_tpu/ops/relative_position_bias.py``).

Relative distances fall into log-spaced buckets (half the buckets exact
for small offsets, half log-spaced up to ``max_distance``); an embedding
maps a bucket to a bias per head, returned as ``[batch*heads, qlen,
klen]`` additive logits. The table's key is torchscale's,
``relative_attention_bias.weight``.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def relative_position_bucket(
    relative_position: torch.Tensor,
    bidirectional: bool = True,
    num_buckets: int = 32,
    max_distance: int = 128,
) -> torch.Tensor:
    ret = torch.zeros_like(relative_position)
    n = -relative_position
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(ret.dtype) * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    # log(0) is -inf at n = 0, where the exact bucket is taken instead
    large = torch.log(n.float() / max_exact) / math.log(max_distance / max_exact) * (num_buckets - max_exact)
    val_if_large = max_exact + torch.nan_to_num(large, neginf=0.0).to(n.dtype)
    val_if_large = val_if_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


class RelativePositionBias(nn.Module):
    def __init__(self, bidirectional: bool = True, num_buckets: int = 32, max_distance: int = 128,
                 n_heads: int = 12):
        super().__init__()
        self.bidirectional = bidirectional
        self.num_buckets = num_buckets
        self.max_distance = max_distance
        self.n_heads = n_heads
        self.relative_attention_bias = nn.Embedding(num_buckets, n_heads)

    def forward(self, batch_size: int, qlen: int, klen: int, step: int = 0) -> torch.Tensor:
        device = self.relative_attention_bias.weight.device
        context = torch.arange(step, step + qlen, device=device)[:, None]
        memory = torch.arange(klen, device=device)[None, :]
        buckets = relative_position_bucket(
            memory - context, bidirectional=self.bidirectional, num_buckets=self.num_buckets,
            max_distance=self.max_distance,
        )
        values = self.relative_attention_bias(buckets)  # [qlen, klen, heads]
        values = values.permute(2, 0, 1)[None]  # [1, heads, qlen, klen]
        return values.expand(batch_size, -1, -1, -1).reshape(-1, qlen, klen)
