"""Multi-head attention with log-sum-exp output (counterpart of
``gigapath_tpu/ops/attention.py``).

``attention_with_lse`` is plain softmax attention on ``[B, L, H, D]``
tensors returning ``(out, lse [B, H, L])``; :func:`combine_partials` (the
counterpart of ``gigapath_tpu/ops/flash_attention.py:combine_partials``,
kept here beside the attention that emits the ``(out, lse)`` contract it
merges) folds two such partials over disjoint key sets into one;
:class:`MultiheadAttention` holds the q/k/v/out projections and the
sub-LayerNorm, with ``_attend`` as the hook
:class:`~gigapath_tpu_torch.ops.dilated_attention.DilatedAttention`
overrides; with a ``model_group`` it runs tensor-parallel on the rank's own
heads (:mod:`gigapath_tpu_torch.parallel.tensor`). ``flash_attention`` and ``partial_attention`` (on the
segment-flash kernel) are in :mod:`~gigapath_tpu_torch.ops.flash_attention`,
which re-exports :func:`combine_partials`. xPos, multiway and the decode
cache are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from gigapath_tpu_torch.parallel.tensor import (
    ShardedLayerNorm,
    copy_to_group,
    local_heads,
    rank_and_world,
    row_parallel_linear,
)

# Large-but-finite mask value: fully masked rows stay NaN-free.
NEG_INF = -1e8


def attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
    key_padding_mask: Optional[torch.Tensor] = None,
    kv_valid_len=None,
    is_causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax attention returning ``(out [B,Lq,H,D], lse [B,H,Lq])``.

    Statistics are fp32 whatever the input dtype; ``out`` has q's dtype.

    - ``bias``: additive logits bias broadcastable to ``[B, H, Lq, Lk]``.
    - ``key_padding_mask``: ``[B, Lk]`` bool, True = padding.
    - ``kv_valid_len``: ``[B, H]`` valid key counts; keys at index >= count
      are masked, and a row with no valid key gives out = 0.
    - ``is_causal``: query i attends keys <= i (ends aligned when Lq != Lk).
    """
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    if scale is None:
        scale = D**-0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    kv_mask = None
    if kv_valid_len is not None:
        lens = torch.as_tensor(kv_valid_len, dtype=torch.int64, device=q.device)
        lens = lens.reshape(B, H)[:, :, None, None]
        kv_mask = torch.arange(Lk, device=q.device)[None, None, None, :] >= lens
        logits = logits.masked_fill(kv_mask, NEG_INF)
    pad_mask = None
    if key_padding_mask is not None:
        pad_mask = key_padding_mask.to(torch.bool)[:, None, None, :]
        logits = logits.masked_fill(pad_mask, NEG_INF)
    if is_causal:
        qi = torch.arange(Lq, device=q.device)[:, None] + (Lk - Lq)
        ki = torch.arange(Lk, device=q.device)[None, :]
        logits = logits.masked_fill(ki > qi, NEG_INF)

    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None])
    if kv_mask is not None:
        probs = probs.masked_fill(kv_mask, 0.0)
    if pad_mask is not None:
        probs = probs.masked_fill(pad_mask, 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype), lse


def combine_partials(
    out_a: torch.Tensor,
    lse_a: torch.Tensor,
    out_b: torch.Tensor,
    lse_b: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two partial-softmax results by their stored log-sum-exps.

    ``out_*`` are ``[B, L, H, D]`` outputs each normalized over its own key
    set, ``lse_*`` the matching ``[B, H, L]`` log-sum-exps; returns the pair
    normalized over the union of the key sets. A fully masked partial
    (large negative lse) folds in with weight 0. Accumulates in fp32 and
    returns ``out`` in ``out_a``'s dtype.
    """
    lse = torch.logaddexp(lse_a, lse_b)

    def w4(w):  # [B, H, L] -> broadcastable [B, L, H, 1]
        return w.transpose(1, 2)[..., None]

    out = out_a.float() * w4(torch.exp(lse_a - lse)) + out_b.float() * w4(torch.exp(lse_b - lse))
    return out.to(out_a.dtype), lse


class MultiheadAttention(nn.Module):
    """Self-attention block: q/k/v/out projections around ``_attend``, with
    ``inner_attn_ln`` on the attention output when ``subln``. Key names
    follow torchscale (``q_proj``, ``k_proj``, ``v_proj``, ``out_proj``,
    ``inner_attn_ln``).

    ``model_group`` (the process group of a mesh's ``model`` dim, T ranks)
    makes it tensor-parallel: rank j holds heads ``[j*H/T, (j+1)*H/T)``,
    q/k/v are column-parallel (``[E/T, E]`` weights), ``out_proj``
    row-parallel (``[E, E/T]``), the sub-LN a
    :class:`~gigapath_tpu_torch.parallel.tensor.ShardedLayerNorm`; load a
    rank's weights with ``parallel.tensor.shard_state_dict``."""

    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        subln: bool = False,
        layernorm_eps: float = 1e-5,
        model_group=None,
    ):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.model_group = model_group if rank_and_world(model_group)[1] > 1 else None
        self.local_heads, self.head_offset = local_heads(num_heads, self.model_group)
        local = self.local_heads * self.head_dim
        self.q_proj = nn.Linear(embed_dim, local)
        self.k_proj = nn.Linear(embed_dim, local)
        self.v_proj = nn.Linear(embed_dim, local)
        self.out_proj = nn.Linear(local, embed_dim)
        if not subln:
            self.inner_attn_ln = None
        elif self.model_group is not None:
            self.inner_attn_ln = ShardedLayerNorm(local, self.model_group, eps=layernorm_eps)
        else:
            self.inner_attn_ln = nn.LayerNorm(embed_dim, eps=layernorm_eps)

    def _attend(self, q, k, v, *, key_padding_mask=None, is_causal=False):
        """Inner attention on [B, L, H, D] tensors (this rank's heads) ->
        [B, Lq, H*D]."""
        out, _ = attention_with_lse(
            q, k, v, key_padding_mask=key_padding_mask, is_causal=is_causal
        )
        return out.reshape(out.shape[0], out.shape[1], -1)

    def forward(
        self,
        query: torch.Tensor,
        key: torch.Tensor,
        value: torch.Tensor,
        *,
        key_padding_mask: Optional[torch.Tensor] = None,
        is_causal: bool = False,
    ) -> torch.Tensor:
        B, Lq, _ = query.shape
        H, Dh = self.local_heads, self.head_dim
        if self.model_group is not None:
            # one copy for self-attention: its gradient is all-reduced once
            same_k, same_v = key is query, value is query
            query = copy_to_group(query, self.model_group)
            key = query if same_k else copy_to_group(key, self.model_group)
            value = query if same_v else copy_to_group(value, self.model_group)
        q = self.q_proj(query).view(B, Lq, H, Dh)
        k = self.k_proj(key).view(B, key.shape[1], H, Dh)
        v = self.v_proj(value).view(B, value.shape[1], H, Dh)
        attn = self._attend(q, k, v, key_padding_mask=key_padding_mask, is_causal=is_causal)
        if self.inner_attn_ln is not None:
            attn = self.inner_attn_ln(attn)
        return row_parallel_linear(attn, self.out_proj, self.model_group)
