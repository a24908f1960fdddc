"""Dilated attention (LongNet), counterpart of
``gigapath_tpu/ops/dilated_attention.py`` on its single-device fused route.

For each branch ``(segment length sl, ratio r)`` the sequence is cut into
segments of ``min(sl, L)``; within a segment head band ``p`` attends only
the positions ``p, p+r, ...``. Each branch runs the phase-major kernels of
:mod:`gigapath_tpu_torch.ops.dilated_kernels`, and the branch outputs are
fused by a softmax over their log-sum-exps (plain PyTorch, as the JAX
package left it to XLA).

The fusion weights take no gradient (the lse is detached, as the JAX
package stops it and the reference computes them under ``torch.no_grad``),
so the backward flows through each branch's output into its kernels.

Only schedules whose every ratio divides the head count take this route,
which covers every LongNet configuration of the registry. The head-major
fallback for other ratios, sequence parallelism, attention-probability
dropout and decoding are not ported yet (``ROADMAP.md``).
"""

from __future__ import annotations

import numbers
from typing import Sequence

import torch

from gigapath_tpu_torch.ops.attention import MultiheadAttention
from gigapath_tpu_torch.ops.dilated_kernels import dilated_branch_attention


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
) -> torch.Tensor:
    """Multi-branch dilated self-attention on [B, L, H, D] -> [B, L, H, D].

    ``valid_len``: keys at positions ``>= valid_len`` are excluded from
    every branch; an int bounds every row, a [B] tensor each row.
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
    real_len, valid_dyn = _normalize_valid_len(valid_len, B, L)
    qE, kE, vE = (x.reshape(B, L, E) for x in (q, k, v))

    outs, lses = [], []
    for sl, r in zip(segment_lengths, dilated_ratios):
        o, l = dilated_branch_attention(
            qE, kE, vE, int(sl), int(r), H,
            real_len=real_len, valid_len_dyn=valid_dyn, is_causal=is_causal,
        )
        outs.append(o)
        lses.append(l)
    if len(outs) == 1:
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
