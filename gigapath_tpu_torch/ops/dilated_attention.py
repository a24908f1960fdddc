"""Dilated attention (LongNet), counterpart of
``gigapath_tpu/ops/dilated_attention.py`` on its single-device routes.

For each branch ``(segment length sl, ratio r)`` the sequence is cut into
segments of ``min(sl, L)``; within a segment head band ``p`` attends only
the positions ``p, p+r, ...``. The branch outputs are fused by a softmax
over their log-sum-exps.

:func:`dilated_attention` resolves its dispatch flags once per call through
the plan seam (:func:`gigapath_tpu_torch.plan.resolve_plan`: environment,
then a blessed plan, then the defaults) and routes as the JAX package's
``dilated_attention`` does on the TPU:

- a schedule whose every ratio divides the head count (every LongNet
  configuration of the registry) takes the phase-major route of
  ``dilated_attention_fused``, each branch on the kernels of
  :mod:`gigapath_tpu_torch.ops.dilated_kernels`:

  - ``stream_fusion`` (``GIGAPATH_STREAM_FUSION``): the branches stay packed
    and one epilogue kernel fuses them
    (:func:`~gigapath_tpu_torch.ops.dilated_kernels.dilated_attention_stream_fused`);
  - ``streaming_fusion`` (``GIGAPATH_STREAMING_FUSION``): each branch's dense
    ``(out, lse)`` folds into a running ``(acc, m, l)`` before the next
    branch runs (plain PyTorch, as the JAX package left it to XLA);
  - otherwise every branch's dense output is stacked and fused by one
    softmax (plain PyTorch).

  ``pack_direct`` (``GIGAPATH_PACK_DIRECT``) swaps the single-segment
  branches' pack and unpack kernels on every route;
- a schedule with a ratio that does not divide the head count (or the
  width) warns once and takes the head-major route,
  :func:`dilated_attention_bhld`: ``[B, H, L, D]`` throughout, each branch
  dilated by static phase slices and run on the segment-flash kernels of
  :mod:`gigapath_tpu_torch.ops.flash_kernels` (an undilated branch whose
  segment the flat kernel takes reads the flat arrays directly), the
  branches fused by the stacked softmax or, with ``streaming_fusion``,
  online.

The fusion weights take no gradient (the lse is detached, as the JAX
package stops it and the reference computes them under ``torch.no_grad``),
so the backward flows through each branch's output into its kernels.

The pipelined kernels (``GIGAPATH_PIPELINED_*`` raise), sequence
parallelism, attention-probability dropout and decoding are not ported yet
(``ROADMAP.md``).
"""

from __future__ import annotations

import numbers
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gigapath_tpu_torch.ops import flash_kernels as fk
from gigapath_tpu_torch.ops.attention import NEG_INF, MultiheadAttention
from gigapath_tpu_torch.ops.common import round_up
from gigapath_tpu_torch.ops.dilated_kernels import (
    MAX_FUSED_BRANCHES,
    PipelineFlags,
    check_not_pipelined,
    dilated_attention_stream_fused,
    dilated_branch_attention,
    dyn_sparse_counts,
    plan_stream_fusion,
)

_WARNED: set = set()


def _warn_once(msg: str) -> None:
    """One warning per distinct message per process, as the JAX package's
    dispatch gives it."""
    if msg not in _WARNED:
        _WARNED.add(msg)
        warnings.warn(msg, stacklevel=3)


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
    pins the online branch fold (None: ``flags.streaming_fusion``). A
    ratio that does not divide H (or H*D) sends the whole call to
    :func:`dilated_attention_bhld`, with one warning per schedule.
    """
    if len(segment_lengths) != len(dilated_ratios):
        raise ValueError("segment_lengths and dilated_ratios differ in length")
    if not (q.shape == k.shape == v.shape):
        raise ValueError(f"self-attention needs equal q/k/v shapes; got {q.shape}, {k.shape}, {v.shape}")
    B, L, H, Dh = q.shape
    E = H * Dh
    if flags is None:
        from gigapath_tpu_torch.plan import resolve_plan

        flags = resolve_plan("dilated_attention", (q, k, v))
    if streaming_fusion is None:
        streaming_fusion = flags.streaming_fusion
    if any(H % int(r) or E % int(r) for r in dilated_ratios):
        # visible, once per schedule, as in the JAX package: the head-major
        # route re-tiles the activations per branch
        _warn_once(
            f"dilated-attention schedule {list(segment_lengths)}/{list(dilated_ratios)} has a ratio "
            f"not dividing H={H} (or H*Dh={E}): falling back from the fused phase-major path to "
            "the head-major path"
        )
        return dilated_attention_bhld(
            q, k, v, segment_lengths, dilated_ratios, is_causal=is_causal, valid_len=valid_len,
            streaming_fusion=streaming_fusion,
        )
    check_not_pipelined(flags, segment_lengths, dilated_ratios, is_causal)
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



# ---------------------------------------------------------------------------
# the head-major route (the JAX package's dilated_attention_bhld)
# ---------------------------------------------------------------------------


def _phase_head_ranges(num_heads: int, ratio: int):
    """(phase, head_start, head_end) triples: heads [hs, he) share ``phase``
    (phases are contiguous head ranges, ``arange(H) // ceil(H/r)``; where r
    does not divide H the last phases may hold fewer heads or none)."""
    heads_per_group = -(-num_heads // ratio)
    ranges = []
    for p in range(ratio):
        hs = p * heads_per_group
        if hs >= num_heads:
            break
        ranges.append((p, hs, min((p + 1) * heads_per_group, num_heads)))
    return ranges


def _branch_kvlen_bhld(num_heads: int, n_seg: int, g: int, ratio: int, m: int, real_len: int):
    """[H, n_seg] valid sparse-key counts of a head-major branch, or None
    when every slot is valid: slot j of segment s and head h is dense
    position ``s*g + phase(h) + r*j``, valid iff it is a real token and
    inside the segment's own g positions."""
    phases = np.arange(num_heads) // -(-num_heads // ratio)
    in_seg = np.clip(real_len - np.arange(n_seg)[None, :] * g, 0, g)
    counts = np.clip(np.ceil((in_seg - phases[:, None]) / ratio), 0, m).astype(np.int32)
    return None if (counts == m).all() else counts


def _dilate_bhld(x: torch.Tensor, ratio: int) -> torch.Tensor:
    """[B, H, n, gp, D] -> [B, H, n, gp/r, D]: each head keeps its phase's
    positions (static slices of the [.., m, r, D] view)."""
    if ratio == 1:
        return x
    B, H, n, gp, D = x.shape
    x6 = x.reshape(B, H, n, gp // ratio, ratio, D)
    parts = [x6[:, hs:he, :, :, p, :] for p, hs, he in _phase_head_ranges(H, ratio)]
    return torch.cat(parts, dim=1)


def _undilate_bhld(out_s: torch.Tensor, lse_s: torch.Tensor, ratio: int):
    """Inverse of :func:`_dilate_bhld`: sparse [B, H, n, m, D] (lse [B, H,
    n, m]) back to [B, H, n, m*r, D], the positions a head does not cover 0
    with lse ``NEG_INF`` (the plain attention's -1e8, as in the JAX
    package)."""
    if ratio == 1:
        return out_s, lse_s
    B, H, n, m, D = out_s.shape
    h_idx = torch.arange(H, device=out_s.device)[:, None]
    mask = (h_idx // -(-H // ratio)) == torch.arange(ratio, device=out_s.device)[None, :]  # [H, r]
    out_d = torch.where(mask[None, :, None, None, :, None], out_s[:, :, :, :, None, :], 0)
    lse_d = torch.where(mask[None, :, None, None, :], lse_s[..., None], NEG_INF)
    return out_d.reshape(B, H, n, m * ratio, D), lse_d.reshape(B, H, n, m * ratio)


def _segment_attention_plain(q5, k5, v5, kvlen, is_causal: bool):
    """Dense ``(out, lse)`` on the segment-batched [B, H, S, M, D] layout:
    the ``use_pallas=False`` tier (the JAX package's
    ``_segment_attention_jnp``), fp32 softmax, masked keys at -1e8, a row
    with no valid key giving out = 0."""
    Dh, Mk = q5.shape[-1], k5.shape[3]
    s = torch.einsum("bhsqd,bhskd->bhsqk", q5.float(), k5.float()) * Dh**-0.5
    mask = None
    if kvlen is not None:
        mask = torch.arange(Mk, device=q5.device) >= kvlen.to(torch.int64)[..., None, None]
        s = s.masked_fill(mask, NEG_INF)
    if is_causal:
        qi = torch.arange(q5.shape[3], device=q5.device)[:, None] + (Mk - q5.shape[3])
        s = s.masked_fill(torch.arange(Mk, device=q5.device)[None, :] > qi, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    if mask is not None:
        p = p.masked_fill(mask, 0.0)
    out = torch.einsum("bhsqk,bhskd->bhsqd", p.to(v5.dtype).float(), v5.float())
    return out.to(q5.dtype), lse


def _bhld_geom(L: int, sl: int, r: int) -> Tuple[int, int, int, int, int]:
    """(g, Lp, n, gp, m) of one head-major branch: segment length, the
    sequence padded to whole segments and their count, the segment padded
    to a multiple of r, and its sparse length. The JAX package's sixth
    value, the TPU kernel block, has no counterpart."""
    g = min(sl, L)
    Lp = round_up(L, g)
    gp = round_up(g, r)
    return g, Lp, Lp // g, gp, gp // r


def _seg_dilate(x: torch.Tensor, g: int, Lp: int, n: int, gp: int, r: int) -> torch.Tensor:
    """[B, H, L, D] -> the dilated segment view [B, H, n, m, D], contiguous."""
    B, H, L, D = x.shape
    x = torch.nn.functional.pad(x, (0, 0, 0, Lp - L)).reshape(B, H, n, g, D)
    x = torch.nn.functional.pad(x, (0, 0, 0, gp - g))
    return _dilate_bhld(x, r).contiguous()


def _undilate_to_dense(out_s, lse_s, r: int, g: int, Lp: int, L: int):
    """Sparse ``(out [B, H, n, m, D], lse [B, H, n, m])`` -> dense ``(out
    [B, H, L, D], lse [B, H, L])``."""
    B, H = out_s.shape[:2]
    D = out_s.shape[-1]
    out_d, lse_d = _undilate_bhld(out_s, lse_s, r)
    out = out_d[:, :, :, :g].reshape(B, H, Lp, D)[:, :, :L]
    lse = lse_d[:, :, :, :g].reshape(B, H, Lp)[:, :, :L]
    return out, lse


def _bhld_kvlen(B: int, H: int, n: int, g: int, r: int, m: int, real_len: int,
                valid_len_dyn: Optional[torch.Tensor], device) -> Optional[torch.Tensor]:
    """[B, H, n] int32 valid sparse-key counts on ``device``, or None when
    every slot is valid: :func:`_branch_kvlen_bhld`'s table (decided on the
    host) combined by minimum with the per-row valid lengths. The table is
    counted on the device by
    :func:`~gigapath_tpu_torch.ops.dilated_kernels.dyn_sparse_counts` at the
    head-major phases ``arange(H) // ceil(H/r)`` with each row bounded by
    ``min(real_len, valid_len_dyn)`` (the counts grow with the bound, so
    that is the minimum of the two tables): a table copied from host memory
    would make the stream wait for the device once per branch."""
    if valid_len_dyn is None and _branch_kvlen_bhld(H, n, g, r, m, real_len) is None:
        return None
    bound = torch.full((B,), real_len, dtype=torch.int64, device=device)
    if valid_len_dyn is not None:
        bound = torch.minimum(bound, valid_len_dyn.to(device=device, dtype=torch.int64))
    phases = torch.arange(H, device=device) // -(-H // r)
    return dyn_sparse_counts(bound, g, r, m, phases, n).contiguous()


def _flat_eligible(g: int, r: int) -> bool:
    """True when an undilated branch takes the flat kernel on the [B, H, L,
    D] arrays instead of the segmented one (the JAX package's predicate)."""
    return r == 1 and g % 8 == 0 and g <= fk.FLAT_MAX_SEGMENT


class _BranchFlash(torch.autograd.Function):
    """One head-major branch on the segment-flash kernels: [B, H, L, D]
    q/k/v -> dense ``(out [B, H, L, D], lse [B, H, L])``; the counterpart of
    ``_branch_pallas``'s custom VJP. It saves the undilated q/k/v (one copy
    shared by every branch of the op) and this branch's dense out and lse,
    never the dilated copies: the backward re-dilates them, and the lse
    output takes no gradient. Autocast is off, as for the other kernels."""

    @staticmethod
    def forward(ctx, qh, kh, vh, kvlen, sl, r, is_causal):
        geom = _bhld_geom(qh.shape[2], sl, r)
        g, Lp, n, gp, m = geom
        with torch.autocast(qh.device.type, enabled=False):
            q5, k5, v5 = (_seg_dilate(x, g, Lp, n, gp, r) for x in (qh, kh, vh))
            out_s, lse_s = fk.flash_fwd(q5, k5, v5, kvlen, is_causal)
            out, lse = _undilate_to_dense(out_s, lse_s, r, g, Lp, qh.shape[2])
        ctx.save_for_backward(qh, kh, vh, kvlen, out, lse)
        ctx.geom, ctx.r, ctx.is_causal = geom, r, is_causal
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):  # no gradient flows through the lse output
        qh, kh, vh, kvlen, out, lse = ctx.saved_tensors
        g, Lp, n, gp, m = ctx.geom
        r, L = ctx.r, qh.shape[2]
        with torch.autocast(qh.device.type, enabled=False):
            do = do.to(qh.dtype)
            q5, k5, v5, do5 = (_seg_dilate(x, g, Lp, n, gp, r) for x in (qh, kh, vh, do))
            delta = (do.float() * out.float()).sum(dim=-1)
            delta5, lse5 = (_seg_dilate(x[..., None], g, Lp, n, gp, r)[..., 0].contiguous()
                            for x in (delta, lse))
            dq5 = fk.flash_bwd_dq(q5, k5, v5, do5, lse5, delta5, kvlen, ctx.is_causal)
            dk5, dv5 = fk.flash_bwd_dkv(q5, k5, v5, do5, lse5, delta5, kvlen, ctx.is_causal)
            grads = [_undilate_to_dense(x5, x5.new_zeros(x5.shape[:-1], dtype=torch.float32), r, g, Lp, L)[0]
                     for x5 in (dq5, dk5, dv5)]
        return (*grads, None, None, None, None)


def _branch_bhld(
    qh: torch.Tensor,
    kh: torch.Tensor,
    vh: torch.Tensor,
    sl: int,
    r: int,
    *,
    is_causal: bool,
    real_len: int,
    use_pallas: Optional[bool],
    valid_len_dyn: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One dilated branch in [B, H, L, D] -> ``(out [B, H, L, D], lse [B,
    H, L])``: the flat kernel for an undilated branch it takes (no per-row
    valid lengths), else the segmented kernel on the dilated view, or (with
    ``use_pallas=False``) the plain tier."""
    B, H, L, Dh = qh.shape
    g, Lp, n, gp, m = _bhld_geom(L, sl, r)
    if use_pallas is None:
        use_pallas = True  # the kernels at every length (the JAX package's PALLAS_MIN_SEQ is a TPU tuning)
    if use_pallas and valid_len_dyn is None and _flat_eligible(g, r):
        return fk.flat_segment_flash(qh, kh, vh, segment_len=g, real_len=real_len, is_causal=is_causal)
    kvlen = _bhld_kvlen(B, H, n, g, r, m, real_len, valid_len_dyn, qh.device)
    if use_pallas:
        return _BranchFlash.apply(qh, kh, vh, kvlen, sl, r, is_causal)
    q5, k5, v5 = (_seg_dilate(x, g, Lp, n, gp, r) for x in (qh, kh, vh))
    out_s, lse_s = _segment_attention_plain(q5, k5, v5, kvlen, is_causal)
    return _undilate_to_dense(out_s, lse_s, r, g, Lp, L)


def dilated_attention_bhld(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_lengths: Sequence[int],
    dilated_ratios: Sequence[int],
    *,
    is_causal: bool = False,
    valid_len=None,
    use_pallas: Optional[bool] = None,
    streaming_fusion: bool = False,
) -> torch.Tensor:
    """Multi-branch dilated self-attention on [B, L, H, D] -> [B, L, H, D]
    through the head-major route: one relayout to [B, H, L, D] at entry,
    one back at exit, each branch on the segment-flash kernels, the
    branches fused by the softmax of their lse (weights constant in the
    backward). Any ratio works, including ones that do not divide H.

    ``valid_len`` as :func:`dilated_attention` (a [B] tensor's counts are
    formed on the device). ``use_pallas``: None or True runs the kernels;
    False the plain tier (``_segment_attention_plain``), used by the tests
    and never by default. ``streaming_fusion`` folds each branch into a
    running ``(acc, m, l)`` so its dense output dies before the next branch
    runs, instead of stacking them all.
    """
    if len(segment_lengths) != len(dilated_ratios):
        raise ValueError("segment_lengths and dilated_ratios differ in length")
    B, L, H, Dh = q.shape
    real_len, valid_dyn = _normalize_valid_len(valid_len, B, L)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def branch(sl, r):
        return _branch_bhld(qh, kh, vh, int(sl), int(r), is_causal=is_causal, real_len=real_len,
                            use_pallas=use_pallas, valid_len_dyn=valid_dyn)

    if streaming_fusion and len(segment_lengths) > 1:
        acc = m_run = l_run = None
        for sl, r in zip(segment_lengths, dilated_ratios):
            o, lse = branch(sl, r)
            lse = lse.detach()[..., None]  # [B, H, L, 1]
            if acc is None:
                acc, m_run, l_run = o.float(), lse, torch.ones_like(lse)
            else:
                m_new = torch.maximum(m_run, lse)
                a, b = torch.exp(m_run - m_new), torch.exp(lse - m_new)
                acc = acc * a + o.float() * b
                l_run = l_run * a + b
                m_run = m_new
        return (acc / l_run).to(q.dtype).transpose(1, 2).contiguous()

    outs, lses = [], []
    for sl, r in zip(segment_lengths, dilated_ratios):
        o, lse = branch(sl, r)
        outs.append(o)
        lses.append(lse)
    if len(outs) == 1:
        out = outs[0]
    else:
        weights = torch.softmax(torch.stack(lses).detach(), dim=0)[..., None]
        out = sum(o.float() * w for o, w in zip(outs, weights))
    return out.to(q.dtype).transpose(1, 2).contiguous()

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
