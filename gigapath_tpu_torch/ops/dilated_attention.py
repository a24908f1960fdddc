"""Dilated attention (LongNet), counterpart of
``gigapath_tpu/ops/dilated_attention.py`` on its single-device fused route.

For each branch ``(segment length sl, ratio r)`` the sequence is cut into
segments of ``min(sl, L)``; within a segment head band ``p`` attends only
the positions ``p, p+r, ...``. Each branch runs the phase-major kernels of
:mod:`gigapath_tpu_torch.ops.dilated_kernels`, and the branch outputs are
fused by a softmax over their log-sum-exps.

:func:`dilated_attention` resolves its dispatch flags once per call through
the plan seam (:func:`gigapath_tpu_torch.plan.resolve_plan`: environment,
then a blessed plan, then the defaults) and routes as the JAX package's
``dilated_attention_fused`` does:

- ``stream_fusion`` (``GIGAPATH_STREAM_FUSION``): the branches stay packed
  and one epilogue kernel fuses them
  (:func:`~gigapath_tpu_torch.ops.dilated_kernels.dilated_attention_stream_fused`);
- ``streaming_fusion`` (``GIGAPATH_STREAMING_FUSION``): each branch's dense
  ``(out, lse)`` folds into a running ``(acc, m, l)`` before the next
  branch runs (plain PyTorch, as the JAX package left it to XLA);
- otherwise every branch's dense output is stacked and fused by one
  softmax (plain PyTorch).

``pack_direct`` (``GIGAPATH_PACK_DIRECT``) swaps the single-segment
branches' pack and unpack kernels on every route. The fusion weights take
no gradient (the lse is detached, as the JAX package stops it and the
reference computes them under ``torch.no_grad``), so the backward flows
through each branch's output into its kernels.

Only schedules whose every ratio divides the head count take this route,
which covers every LongNet configuration of the registry. The head-major
fallback for other ratios, the pipelined kernels (``GIGAPATH_PIPELINED_*``
raise), sequence parallelism, attention-probability dropout and decoding
are not ported yet (``ROADMAP.md``).
"""

from __future__ import annotations

import numbers
import warnings
from typing import Optional, Sequence

import torch

from gigapath_tpu_torch.ops.attention import MultiheadAttention
from gigapath_tpu_torch.ops.dilated_kernels import (
    MAX_FUSED_BRANCHES,
    PipelineFlags,
    check_not_pipelined,
    dilated_attention_stream_fused,
    dilated_branch_attention,
    plan_stream_fusion,
)


def _normalize_valid_len(valid_len, B: int, L: int):
    """(real_len int, valid_dyn [B] tensor or None) from the public
    ``valid_len``: None = all valid, int = one suffix bound for every row,
    tensor = per-row suffix valid lengths."""
    if valid_len is None:
        return L, None
    if isinstance(valid_len, numbers.Integral):
        return min(int(valid_len), L), None
    return L, torch.as_tensor(valid_len).reshape(B)


def dilated_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_lengths: Sequence[int],
    dilated_ratios: Sequence[int],
    *,
    is_causal: bool = False,
    valid_len=None,
    flags: Optional[PipelineFlags] = None,
    streaming_fusion: Optional[bool] = None,
) -> torch.Tensor:
    """Multi-branch dilated self-attention on [B, L, H, D] -> [B, L, H, D].

    ``valid_len``: keys at positions ``>= valid_len`` are excluded from
    every branch; an int bounds every row, a [B] tensor each row.
    ``flags`` pins the dispatch (None: resolved once here through the plan
    seam under the name ``"dilated_attention"``); ``streaming_fusion``
    pins the online branch fold (None: ``flags.streaming_fusion``).
    """
    if len(segment_lengths) != len(dilated_ratios):
        raise ValueError("segment_lengths and dilated_ratios differ in length")
    if not (q.shape == k.shape == v.shape):
        raise ValueError(f"self-attention needs equal q/k/v shapes; got {q.shape}, {k.shape}, {v.shape}")
    B, L, H, Dh = q.shape
    E = H * Dh
    for r in dilated_ratios:
        if H % int(r):
            raise NotImplementedError(
                f"dilated ratio {r} does not divide H={H}: the head-major "
                "fallback branch is not ported yet (ROADMAP.md, Queue B)"
            )
    if flags is None:
        from gigapath_tpu_torch.plan import resolve_plan

        flags = resolve_plan("dilated_attention", (q, k, v))
    check_not_pipelined(flags, segment_lengths, dilated_ratios, is_causal)
    if streaming_fusion is None:
        streaming_fusion = flags.streaming_fusion
    real_len, valid_dyn = _normalize_valid_len(valid_len, B, L)
    qE, kE, vE = (x.reshape(B, L, E) for x in (q, k, v))
    multi = len(segment_lengths) > 1

    if flags.stream_fusion and multi:
        if plan_stream_fusion(L, E, H, segment_lengths, dilated_ratios) is not None:
            out = dilated_attention_stream_fused(
                qE, kE, vE, segment_lengths, dilated_ratios, H, real_len=real_len,
                valid_len_dyn=valid_dyn, is_causal=is_causal, flags=flags,
            )
            return out.reshape(B, L, H, Dh)
        # as the JAX package: visible (once per message), then the dense fusion
        warnings.warn(
            f"GIGAPATH_STREAM_FUSION requested but schedule {list(segment_lengths)}/"
            f"{list(dilated_ratios)} has more branches than the fusion epilogue takes "
            f"({MAX_FUSED_BRANCHES}): using the dense fusion"
        )

    def branch(sl, r):
        return dilated_branch_attention(
            qE, kE, vE, int(sl), int(r), H,
            real_len=real_len, valid_len_dyn=valid_dyn, is_causal=is_causal, flags=flags,
        )

    if streaming_fusion and multi:
        # online softmax over the branch axis, weights constant in the
        # backward: each branch's dense output dies before the next branch
        # runs; the [B, H, L] stats broadcast as [B, L, H, 1]
        acc = m_run = l_run = None
        for sl, r in zip(segment_lengths, dilated_ratios):
            o, lse = branch(sl, r)
            o = o.reshape(B, L, H, Dh).float()
            lse = lse.detach().transpose(1, 2)[..., None]
            if acc is None:
                acc, m_run, l_run = o, lse, torch.ones_like(lse)
            else:
                m_new = torch.maximum(m_run, lse)
                a, b = torch.exp(m_run - m_new), torch.exp(lse - m_new)
                acc = acc * a + o * b
                l_run = l_run * a + b
                m_run = m_new
        return (acc / l_run).to(q.dtype)

    outs, lses = [], []
    for sl, r in zip(segment_lengths, dilated_ratios):
        o, l = branch(sl, r)
        outs.append(o)
        lses.append(l)
    if not multi:
        return outs[0].reshape(B, L, H, Dh)

    # LSE-softmax fusion across branches: [n, B, H, L] weights, constant in
    # the backward, each broadcast over its head's Dh lanes as [B, L, H, 1]
    weights = torch.softmax(torch.stack(lses).detach(), dim=0)
    acc = None
    for o, w in zip(outs, weights):
        term = o.reshape(B, L, H, Dh).float() * w.transpose(1, 2)[..., None]
        acc = term if acc is None else acc + term
    return acc.to(q.dtype)


class DilatedAttention(MultiheadAttention):
    """LongNet attention module: the MultiheadAttention projections and
    sub-LN around :func:`dilated_attention`. ``dropout`` (on the attention
    probabilities) must be 0: every registry configuration trains with
    ``attention_dropout = 0``, and the kernels never form the probabilities
    a dropout would act on."""

    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        segment_length: Sequence[int],
        dilated_ratio: Sequence[int],
        subln: bool = False,
        layernorm_eps: float = 1e-5,
        dropout: float = 0.0,
    ):
        if dropout > 0.0:
            raise NotImplementedError(
                f"attention-probability dropout ({dropout}) is not ported yet (ROADMAP.md)"
            )
        super().__init__(embed_dim, num_heads, subln=subln, layernorm_eps=layernorm_eps)
        self.segment_length = tuple(int(x) for x in segment_length)
        self.dilated_ratio = tuple(int(x) for x in dilated_ratio)

    def _attend(self, q, k, v, *, key_padding_mask=None, is_causal=False):
        # key_padding_mask (True = pad) is a suffix pad (data collate
        # convention): one count shared by every row becomes a static int,
        # per-row counts a [B] tensor
        valid_len = None
        if key_padding_mask is not None:
            counts = (~key_padding_mask.to(torch.bool)).sum(dim=-1).to(torch.int32)
            if bool((counts == counts[0]).all()):
                valid_len = int(counts[0])
            else:
                valid_len = counts
        out = dilated_attention(
            q, k, v, self.segment_length, self.dilated_ratio,
            is_causal=is_causal, valid_len=valid_len,
        )
        return out.reshape(out.shape[0], out.shape[1], self.embed_dim)
