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
which re-exports :func:`combine_partials`.

:class:`MultiheadAttention` follows the JAX module's contract: self- or
cross-attention (``encoder_decoder_attention``), ``attn_mask`` and
``rel_pos`` as additive logits, xPos on self-attention, multiway (BEiT-3)
projections and inner LN split per call at ``multiway_split_position``,
attention-probability dropout in training mode drawn from a
``torch.Generator``, and the decode cache: an explicit ``incremental_state``
dict (``prev_key`` / ``prev_value`` ``[B, L, H, D]`` and ``index``, the
positions already cached), torchscale's idiom in place of flax's ``cache``
collection.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from gigapath_tpu_torch.ops import multiway as mw
from gigapath_tpu_torch.ops.multiway import maybe_multiway, multiway_layernorm
from gigapath_tpu_torch.ops.xpos import apply_xpos
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
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax attention returning ``(out [B,Lq,H,D], lse [B,H,Lq])``.

    Statistics are fp32 whatever the input dtype; ``out`` has q's dtype.

    - ``bias``: additive logits bias broadcastable to ``[B, H, Lq, Lk]``.
    - ``key_padding_mask``: ``[B, Lk]`` bool, True = padding.
    - ``kv_valid_len``: ``[B, H]`` valid key counts; keys at index >= count
      are masked, and a row with no valid key gives out = 0.
    - ``is_causal``: query i attends keys <= i (ends aligned when Lq != Lk).
    - ``dropout_rate``: above 0, each probability is kept with ``1 -
      dropout_rate`` (a draw from ``generator``, torch's default generator
      of q's device when None) and the kept ones scaled by its inverse.
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
    if dropout_rate > 0.0:
        keep = torch.rand(probs.shape, generator=generator, device=probs.device) < 1.0 - dropout_rate
        probs = probs * keep / (1.0 - dropout_rate)
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
    """Self- or cross-attention: q/k/v/out projections around ``_attend``,
    with ``inner_attn_ln`` on a self-attention's output when ``subln``. Key
    names follow torchscale (``q_proj``, ``k_proj``, ``v_proj``,
    ``out_proj``, ``inner_attn_ln``; ``.A`` / ``.B`` under each when
    ``multiway``).

    ``dropout`` acts on the attention probabilities in training mode.
    ``xpos_rel_pos`` applies xPos to a self-attention's queries and keys
    (refused with the decode cache, as in the JAX package).

    ``model_group`` (the process group of a mesh's ``model`` dim, T ranks)
    makes it tensor-parallel: rank j holds heads ``[j*H/T, (j+1)*H/T)``,
    q/k/v are column-parallel (``[E/T, E]`` weights), ``out_proj``
    row-parallel (``[E, E/T]``), the sub-LN a
    :class:`~gigapath_tpu_torch.parallel.tensor.ShardedLayerNorm`; load a
    rank's weights with ``parallel.tensor.shard_state_dict``. It does not
    combine with ``multiway`` (``ValueError``)."""

    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        subln: bool = False,
        layernorm_eps: float = 1e-5,
        model_group=None,
        *,
        dropout: float = 0.0,
        self_attention: bool = True,
        encoder_decoder_attention: bool = False,
        xpos_rel_pos: bool = False,
        xpos_scale_base: int = 512,
        multiway: bool = False,
    ):
        super().__init__()
        if self_attention == encoder_decoder_attention:
            raise ValueError("exactly one of self_attention and encoder_decoder_attention must be set")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.self_attention = self_attention
        self.encoder_decoder_attention = encoder_decoder_attention
        self.xpos_rel_pos = xpos_rel_pos
        self.xpos_scale_base = xpos_scale_base
        self.model_group = model_group if rank_and_world(model_group)[1] > 1 else None
        if multiway and self.model_group is not None:
            raise ValueError("multiway attention does not run tensor-parallel: pass no model_group")
        self.local_heads, self.head_offset = local_heads(num_heads, self.model_group)
        local = self.local_heads * self.head_dim

        def linear(fan_in, fan_out):
            return maybe_multiway(multiway, lambda: nn.Linear(fan_in, fan_out))

        self.q_proj = linear(embed_dim, local)
        self.k_proj = linear(embed_dim, local)
        self.v_proj = linear(embed_dim, local)
        self.out_proj = linear(local, embed_dim)
        if not (subln and self_attention):
            self.inner_attn_ln = None
        elif self.model_group is not None:
            self.inner_attn_ln = ShardedLayerNorm(local, self.model_group, eps=layernorm_eps)
        else:
            self.inner_attn_ln = multiway_layernorm(multiway, embed_dim, layernorm_eps)

    def _attend(self, q, k, v, *, key_padding_mask=None, attn_mask=None, rel_pos=None, is_causal=False,
                offset: int = 0, generator=None):
        """Inner attention on [B, L, H, D] tensors (this rank's heads) ->
        [B, Lq, H*D]. ``offset`` is the decode position of the first query
        row, which only a subclass that takes the cache by position
        (:class:`~gigapath_tpu_torch.ops.dilated_attention.DilatedAttention`)
        receives; this class takes the cache through its bias."""
        if offset:
            raise ValueError("the base attention takes the decode cache through its bias, never an offset")
        bias = attn_mask
        if rel_pos is not None:
            rel = rel_pos.reshape(q.shape[0], self.num_heads, q.shape[1], k.shape[1])
            rel = rel[:, self.head_offset:self.head_offset + self.local_heads]
            bias = rel if bias is None else bias + rel
        out, _ = attention_with_lse(
            q, k, v, bias=bias, key_padding_mask=key_padding_mask, is_causal=is_causal,
            dropout_rate=self.dropout if self.training else 0.0, generator=generator,
        )
        return out.reshape(out.shape[0], out.shape[1], -1)

    def _cached_attend_inputs(self, k, v, cur: int, Lq: int, attn_mask, is_causal):
        """The cached keys and values as ``_attend``'s inputs: ``(k, v,
        attn_mask, is_causal, offset)``. This class attends the whole
        buffer under a per-query bias: query row i (position cur + i) sees
        keys <= cur + i, right for single-token steps and for chunks of
        several tokens; the bias supersedes the causal flag."""
        qi = torch.arange(Lq, device=k.device)[:, None]
        ki = torch.arange(k.shape[1], device=k.device)[None, :]
        cache_bias = torch.where(ki <= cur + qi, 0.0, NEG_INF)[None, None]
        attn_mask = cache_bias if attn_mask is None else attn_mask + cache_bias
        return k, v, attn_mask, False, 0

    def forward(
        self,
        query: torch.Tensor,
        key: torch.Tensor,
        value: torch.Tensor,
        *,
        key_padding_mask: Optional[torch.Tensor] = None,
        attn_mask: Optional[torch.Tensor] = None,
        rel_pos: Optional[torch.Tensor] = None,
        is_causal: bool = False,
        incremental_state: Optional[Dict[str, Any]] = None,
        multiway_split_position: int = -1,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """``incremental_state`` (a self-attention's decode cache): a dict,
        empty before the first call, holding ``prev_key`` / ``prev_value``
        and ``index`` after it; each call appends its keys and values and
        attends the cache through ``_cached_attend_inputs``. A
        cross-attention ignores it and projects ``key`` / ``value`` anew, as
        the JAX package does."""
        B, Lq, _ = query.shape
        H, Dh = self.local_heads, self.head_dim
        split = multiway_split_position
        if self.model_group is not None:
            # one copy for self-attention: its gradient is all-reduced once
            same_k, same_v = key is query, value is query
            query = copy_to_group(query, self.model_group)
            key = query if same_k else copy_to_group(key, self.model_group)
            value = query if same_v else copy_to_group(value, self.model_group)
        q = mw.call(self.q_proj, query, split_position=split).view(B, Lq, H, Dh)
        k = mw.call(self.k_proj, key, split_position=split).view(B, key.shape[1], H, Dh)
        v = mw.call(self.v_proj, value, split_position=split).view(B, value.shape[1], H, Dh)
        if self.xpos_rel_pos and self.self_attention:
            if incremental_state is not None:
                raise ValueError("xPos with incremental decoding is not supported (as in the JAX package)")
            k = apply_xpos(k, scale_base=self.xpos_scale_base, downscale=True)
            q = apply_xpos(q, scale_base=self.xpos_scale_base, downscale=False)
        offset = 0
        if incremental_state is not None and self.self_attention:
            cur = incremental_state.get("index", 0)
            if "prev_key" in incremental_state:
                k = torch.cat([incremental_state["prev_key"], k], dim=1)
                v = torch.cat([incremental_state["prev_value"], v], dim=1)
            incremental_state.update(prev_key=k, prev_value=v, index=cur + Lq)
            k, v, attn_mask, is_causal, offset = self._cached_attend_inputs(k, v, cur, Lq, attn_mask, is_causal)
        attn = self._attend(
            q, k, v, key_padding_mask=key_padding_mask, attn_mask=attn_mask, rel_pos=rel_pos,
            is_causal=is_causal, offset=offset, generator=generator,
        )
        if self.inner_attn_ln is not None:
            attn = mw.call(self.inner_attn_ln, attn, split_position=split)
        if self.model_group is not None:
            return row_parallel_linear(attn, self.out_proj, self.model_group)
        return mw.call(self.out_proj, attn, split_position=split)
