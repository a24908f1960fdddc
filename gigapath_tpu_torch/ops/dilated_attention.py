"""Dilated attention (LongNet), counterpart of
``gigapath_tpu/ops/dilated_attention.py`` on its single-device and
sequence-parallel routes.

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

On both phase-major routes a non-causal branch takes the pipelined
kernels where the flags or a blessed plan's branch variant select them
(``GIGAPATH_PIPELINED_ATTN``, ``GIGAPATH_PIPELINED_BWD``;
``dilated_kernels._branch_pipelined``); the head-major route and causal
calls stay on their serial kernels, as in the JAX package.

Sequence parallelism (``seq_group=``, the process group of a mesh's
``seq`` dim): each rank holds ``L`` consecutive tokens of the sequence,
rank ``w`` of the group tokens ``[w*L, (w+1)*L)``. A branch whose segment
fits the shard (``sl <= L``) is, per rank, a single-device branch and runs
the phase-major kernels as on one device (``H % r == 0``), else the
generic branch on the segment-flash kernel. A branch with ``sl > L``
spans ``rps = sl / L`` ranks: its sparse queries stay local and its
sparse keys and values come from the segment's ranks, either

- **gathered** (:class:`_GatherKV`): an all-gather over the group, of
  which the segment's ``rps`` chunks are kept, then ``flash_attention``
  (row 11 forward, row 12 backward) at ``Lk = rps * Lq``; its backward is
  the all-gather's adjoint, a reduce-scatter. A causal branch masks the
  segment's later ranks through an additive bias, so it runs the plain
  ``attention_with_lse``, as in the JAX package; or
- **ringed** (:class:`_RingAttention`, ``flags.ring_attn`` /
  ``GIGAPATH_RING_ATTN``): the local chunk rotates around the segment's
  sub-ring, each step's ``partial_attention`` (row 11) folded by
  ``combine_partials`` into an fp32 accumulator, the next chunk's exchange
  issued before the resident chunk's compute. The backward replays the
  rotation with the dK/dV accumulators travelling with their chunk, in
  plain PyTorch (the JAX package has no kernel for it).

Every collective takes CUDA tensors under both gloo and NCCL
(``all_gather``, ``reduce_scatter``, ``all_to_all_single``). The ring's
exchange is an all-to-all whose one non-empty split goes to the next rank
of the sub-ring, so it is addressed by group ranks. Point-to-point
``isend`` / ``irecv`` would not do: gloo refuses CUDA tensors there
(``scripts/torch_gloo_cuda_probe.py``, PyTorch 2.11 on an NVIDIA H100 80GB
HBM3). So the transport is one and the same whatever
``dist.get_backend(group)`` says. The ranks' valid counts of a ragged
batch are all-gathered once per call and shared by every sharded branch.

Where the JAX package asserts, the port raises ``ValueError``: a sharded
branch needs ``sl % L == 0``, ``rps <= W`` and ``W % rps == 0``, and
decoding (``offset``) does not combine with sequence parallelism. It also
refuses three cases that the JAX package runs to another function than
its single-device op: a sharded branch whose ratio does not divide ``L``
(the ranks' phases shift), a gathered branch whose ``rps`` does not divide
``W`` (the last segment's slice of the gathered ranks is clamped) and a
local branch whose segment does not divide ``L`` (the segment edges move
to the rank edges). The branches' fusion is the
stacked softmax of their lse; ``stream_fusion`` and ``streaming_fusion``
act on one device only, as in the JAX package.

The kernel routes above take self-attention with equal q/k/v shapes, no
decoding offset, no attention dropout and the default ``attn_fn``: the JAX
package's ``kernels_eligible``. Any other call runs the **generic route**
on one device, :func:`_dilated_branch` per branch (the JAX package's
``_dilated_branch``): dilated segments gathered by static phase slices,
each branch's ``attn_fn`` on the sparse segments (``flash_attention``,
row 11, by default), the branches fused by the stacked softmax.

- Decoding (``offset > 0``): q holds the rows at positions ``[offset,
  offset + Lq)`` and k / v the whole cache, ``Lk == offset + Lq``. A
  branch drops the keys before its query segment's start and front-pads q
  by ``offset % sl``, so that queries and keys share the segment's
  coordinates with ``Lq == Lk`` (the causal flag's alignment is then the
  same on the kernel and on the plain path).
- Attention dropout (``dropout_rate > 0``): each branch runs the plain
  :func:`~gigapath_tpu_torch.ops.attention.attention_with_lse` with
  dropout, drawn from a generator of its own (seeded from ``generator``),
  as the JAX package splits its key per branch; a custom ``attn_fn`` with
  dropout raises ``NotImplementedError``, as there. This is the JAX
  package's dispatch rule, not a fallback: with dropout 0 a CUDA tensor
  always reaches the kernels. Under sequence parallelism such a call takes
  the generic local and gathered branches (no phase-major kernel, no ring),
  as in the JAX package.
"""

from __future__ import annotations

import contextlib
import functools
import numbers
import operator
import threading
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gigapath_tpu_torch.ops import flash_kernels as fk
from gigapath_tpu_torch.ops.attention import NEG_INF, MultiheadAttention, attention_with_lse, combine_partials
from gigapath_tpu_torch.ops.common import round_up
from gigapath_tpu_torch.ops.dilated_kernels import (
    MAX_FUSED_BRANCHES,
    PipelineFlags,
    dilated_attention_stream_fused,
    dilated_branch_attention,
    dyn_sparse_counts,
    plan_stream_fusion,
)
from gigapath_tpu_torch.ops.flash_attention import flash_attention, partial_attention

_WARNED: set = set()
_PER_ROW = threading.local()


@contextlib.contextmanager
def per_row_valid_len():
    """In this thread, the masked forward keeps the per-row ``[B]`` valid
    lengths on the device whatever the counts (:class:`DilatedAttention`
    reads no count on the host). The CUDA-graph cache
    (:mod:`gigapath_tpu_torch.serve.aot`) runs its warm-up and its capture
    under this: a host read of the counts is an error while a stream
    captures, and would bake the capture batch's arm into the graph."""
    prev = getattr(_PER_ROW, "on", False)
    _PER_ROW.on = True
    try:
        yield
    finally:
        _PER_ROW.on = prev


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
    seq_group=None,
    offset: int = 0,
    head_offset: int = 0,
    num_heads: Optional[int] = None,
    attn_fn=None,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Multi-branch dilated self-attention on [B, L, H, D] -> [B, L, H, D].

    ``valid_len``: keys at positions ``>= valid_len`` are excluded from
    every branch; an int bounds every row, a [B] tensor each row.
    ``flags`` pins the dispatch (None: resolved once here through the plan
    seam under the name ``"dilated_attention"``); ``streaming_fusion``
    pins the online branch fold (None: ``flags.streaming_fusion``). A
    ratio that does not divide H (or H*D) sends the whole call to
    :func:`dilated_attention_bhld`, with one warning per schedule.

    ``seq_group``: a process group of more than one rank makes this call
    sequence-parallel (the module docstring): L is the local shard, and
    ``valid_len`` each rank's own suffix count of a suffix-padded batch, a
    [B] tensor wherever a branch spans ranks.

    ``offset`` (decoding): q holds the rows at positions ``[offset, offset +
    Lq)``, k and v the whole cache (``Lk == offset + Lq``, else
    ``ValueError``); not with ``seq_group`` (``ValueError``). ``attn_fn(q,
    k, v, is_causal=, kv_valid_len=) -> (out, lse)`` replaces
    ``flash_attention`` on the generic route. ``dropout_rate`` above 0 drops
    attention probabilities in every branch, each branch drawing from a
    generator seeded from ``generator``. An offset, dropout, a custom
    ``attn_fn`` or unequal q/k/v shapes take the generic route (the module
    docstring).

    ``head_offset`` and ``num_heads``: the H heads of q/k/v are the global
    heads ``[head_offset, head_offset + H)`` of ``num_heads`` (a
    tensor-parallel rank's, :class:`DilatedAttention` with a
    ``model_group``). A dilated branch's phase depends on the global head
    index, ``h // ceil(num_heads / r)``, so a call on a proper subset of the
    heads takes the **tensor-parallel route**: the head-major route
    (:func:`dilated_attention_bhld`, rows 11-14) at the global phases,
    whatever the flags. It does not combine with ``seq_group``
    (``ValueError``).
    """
    if len(segment_lengths) != len(dilated_ratios):
        raise ValueError("segment_lengths and dilated_ratios differ in length")
    seq_world = 1 if seq_group is None else dist.get_world_size(seq_group)
    if offset:
        if seq_world > 1:
            raise ValueError("offset decoding and sequence parallelism are not supported together")
        if k.shape[1] != offset + q.shape[1]:
            # q holds the rows at [offset, offset + Lq), k/v the whole cache
            raise ValueError(
                f"offset={offset} decoding requires Lk == offset + Lq (the whole KV cache); "
                f"got Lq={q.shape[1]}, Lk={k.shape[1]}"
            )
    if dropout_rate > 0.0 and attn_fn is not None:
        raise NotImplementedError("attention dropout is not supported with a custom attn_fn")
    kernels_eligible = attn_fn is None and dropout_rate <= 0.0 and not offset and q.shape == k.shape == v.shape
    if seq_world > 1 and not (q.shape == k.shape == v.shape):
        raise ValueError(f"sequence-parallel self-attention needs equal q/k/v shapes; got {q.shape}, {k.shape}")
    B, L, H, Dh = q.shape
    E = H * Dh
    total = H if num_heads is None else int(num_heads)
    if head_offset or total != H:
        if seq_world > 1:
            raise ValueError(
                "a tensor-parallel rank's heads (head_offset/num_heads) and sequence parallelism "
                "(seq_group) are not supported together"
            )
        if not kernels_eligible:
            raise ValueError(
                "a tensor-parallel rank's heads (head_offset/num_heads) take no decoding offset, attention "
                "dropout, custom attn_fn or unequal q/k/v shapes"
            )
        if head_offset < 0 or head_offset + H > total:
            raise ValueError(f"heads [{head_offset}, {head_offset + H}) are not inside the {total} global heads")
        return dilated_attention_bhld(
            q, k, v, segment_lengths, dilated_ratios, is_causal=is_causal, valid_len=valid_len,
            heads=(int(head_offset), total),
        )
    attn_fns = None
    if not kernels_eligible:
        attn_fns = _branch_attn_fns(len(segment_lengths), attn_fn, dropout_rate, generator, q.device)
    if seq_world > 1:
        routes = _seq_routes(segment_lengths, dilated_ratios, L, H, E, seq_world)
    elif not kernels_eligible:
        return _dilated_attention_generic(
            q, k, v, segment_lengths, dilated_ratios, is_causal=is_causal, offset=int(offset),
            attn_fns=attn_fns, valid_len=valid_len,
        )
    if flags is None:
        from gigapath_tpu_torch.plan import resolve_plan

        flags = resolve_plan("dilated_attention", (q, k, v))
    if seq_world > 1:
        return _dilated_attention_seq_parallel(
            q, k, v, routes, is_causal=is_causal, valid_len=valid_len, flags=flags, seq_group=seq_group,
            attn_fns=attn_fns,
        )
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
        outs.append(o.reshape(B, L, H, Dh))
        lses.append(l)
    if not multi:
        return outs[0]
    return _stacked_fusion(outs, lses, q.dtype)


def _stacked_fusion(outs, lses, dtype: torch.dtype) -> torch.Tensor:
    """LSE-softmax fusion across branches: the dense outputs [B, L, H, D]
    weighted by the softmax of their lse [B, H, L] over the branch axis,
    constant in the backward, each broadcast over its head's Dh lanes as
    [B, L, H, 1]."""
    weights = torch.softmax(torch.stack(lses).detach(), dim=0)
    acc = None
    for o, w in zip(outs, weights):
        term = o.float() * w.transpose(1, 2)[..., None]
        acc = term if acc is None else acc + term
    return acc.to(dtype)



# ---------------------------------------------------------------------------
# the generic route (the JAX package's _dilated_branch on one device)
# ---------------------------------------------------------------------------


def _branch_attn_fns(n: int, attn_fn, dropout_rate: float, generator: Optional[torch.Generator], device):
    """The attention function of each of ``n`` branches on the generic
    route: with dropout, the plain ``attention_with_lse`` drawing from a
    generator of its own on ``device`` (seeded by draws from ``generator``,
    torch's default CPU generator when None), as the JAX package splits its
    key per branch; else ``attn_fn``, ``flash_attention`` by default."""
    if dropout_rate <= 0.0:
        return [attn_fn or flash_attention] * n
    seeds = torch.randint(0, 2**62, (n,), generator=generator,
                          device=generator.device if generator is not None else "cpu").tolist()
    gens = [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]
    return [functools.partial(attention_with_lse, dropout_rate=dropout_rate, generator=g) for g in gens]


def _dilated_branch(q, k, v, sl: int, r: int, *, is_causal: bool, offset: int, attn_fn,
                    valid_len=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One branch on the generic route -> ``(out [B, L, H, D], lse [B, H,
    L])``: q and k/v cut into segments of ``min(sl, len)``, dilated by
    static phase slices, ``attn_fn`` on the sparse segments, the result
    undilated. With ``offset`` (decoding) the keys before the query
    segment's start are dropped and q is front-padded by ``offset % sl``:
    a query at position t attends only keys of its own segment ``t // sl``,
    so queries and keys then share the segment's coordinates with ``Lq ==
    Lk``, and the causal mask and the tail counts of the cut cache are the
    decode step's."""
    B, L, H, Dh = q.shape
    if offset > 0:
        s0 = (offset // sl) * sl
        if s0 > 0:
            k, v = k[:, s0:], v[:, s0:]
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, offset % sl, 0))
    Lq = q.shape[1]
    g_q = min(sl, Lq)
    qp = _pad_to_multiple(q, g_q, axis=1)
    n_seg = qp.shape[1] // g_q
    qs = dense_to_sparse(qp.reshape(B * n_seg, g_q, H, Dh), r)
    g_k = min(sl, k.shape[1])
    kp = _pad_to_multiple(k, g_k, axis=1).reshape(-1, g_k, H, Dh)
    vp = _pad_to_multiple(v, g_k, axis=1).reshape(-1, g_k, H, Dh)
    ks, vs = dense_to_sparse(kp, r), dense_to_sparse(vp, r)
    n_seg_k, m = kp.shape[0] // B, ks.shape[1]
    # the JAX package's _kv_valid_lengths, each row's valid length in place
    # of the real length where that is smaller: slot j of segment s and
    # head phase p is position s*g + p + r*j, a key while below that
    # length, the pad that makes a segment a multiple of r included
    real_len, valid_dyn = _normalize_valid_len(valid_len, B, k.shape[1])
    kv_valid_len = _bhld_kvlen(B, H, n_seg_k, g_k, r, m, real_len, valid_dyn, q.device, span=m * r)
    if kv_valid_len is not None:
        kv_valid_len = kv_valid_len.transpose(1, 2).reshape(B * n_seg_k, H)
    out_s, lse_s = attn_fn(qs, ks, vs, is_causal=is_causal, kv_valid_len=kv_valid_len)
    out_d, lse_d = sparse_to_dense(out_s, lse_s, r, g_q)
    out = out_d.reshape(B, n_seg * g_q, H, Dh)
    lse = lse_d.reshape(B, n_seg, H, g_q).transpose(1, 2).reshape(B, H, -1)
    start = offset % sl if offset > 0 else 0
    return out[:, start:start + L], lse[..., start:start + L]


def _dilated_attention_generic(q, k, v, segment_lengths, dilated_ratios, *, is_causal: bool, offset: int,
                               attn_fns, valid_len) -> torch.Tensor:
    """Every branch on :func:`_dilated_branch` with its ``attn_fns`` entry,
    fused by the stacked softmax of their lse."""
    outs, lses = [], []
    for sl, r, fn in zip(segment_lengths, dilated_ratios, attn_fns):
        o, lse = _dilated_branch(q, k, v, int(sl), int(r), is_causal=is_causal, offset=offset, attn_fn=fn,
                                 valid_len=valid_len)
        outs.append(o)
        lses.append(lse)
    if len(outs) == 1:
        return outs[0]
    return _stacked_fusion(outs, lses, q.dtype)


# ---------------------------------------------------------------------------
# the head-major route (the JAX package's dilated_attention_bhld)
# ---------------------------------------------------------------------------


def _head_base(num_heads: int, heads) -> Tuple[int, int]:
    """(the first local head's global index, the global head count) of a
    call on ``num_heads`` local heads; ``heads`` is None (the local heads
    are all the heads) or that pair (a tensor-parallel rank's)."""
    return (0, num_heads) if heads is None else (int(heads[0]), int(heads[1]))


def _head_phases(num_heads: int, ratio: int, heads=None, device=None):
    """The phase of each local head: its global index ``// ceil(H/r)`` over
    the global head count H; a numpy array, or with ``device`` a tensor
    made there (no host copy: a captured CUDA graph may run it)."""
    offset, total = _head_base(num_heads, heads)
    per = -(-total // ratio)
    if device is None:
        return (offset + np.arange(num_heads)) // per
    return (offset + torch.arange(num_heads, device=device)) // per


def _phase_head_ranges(num_heads: int, ratio: int, heads=None):
    """(phase, head_start, head_end) triples over the local heads: heads
    [hs, he) share ``phase`` (phases are contiguous head ranges, the global
    ``arange(H) // ceil(H/r)``; where r does not divide H the last phases
    may hold fewer heads or none). ``heads`` as :func:`_head_base`: a
    tensor-parallel rank's heads may start inside a phase and span
    several."""
    offset, total = _head_base(num_heads, heads)
    heads_per_group = -(-total // ratio)
    ranges = []
    h = 0
    while h < num_heads:
        p = (offset + h) // heads_per_group
        he = min((p + 1) * heads_per_group - offset, num_heads)
        ranges.append((p, h, he))
        h = he
    return ranges


def _branch_kvlen_bhld(num_heads: int, n_seg: int, g: int, ratio: int, m: int, real_len: int, heads=None):
    """[H, n_seg] valid sparse-key counts of a head-major branch, or None
    when every slot is valid: slot j of segment s and head h is dense
    position ``s*g + phase(h) + r*j``, valid iff it is a real token and
    inside the segment's own g positions."""
    phases = _head_phases(num_heads, ratio, heads)
    in_seg = np.clip(real_len - np.arange(n_seg)[None, :] * g, 0, g)
    counts = np.clip(np.ceil((in_seg - phases[:, None]) / ratio), 0, m).astype(np.int32)
    return None if (counts == m).all() else counts


def _dilate_bhld(x: torch.Tensor, ratio: int, heads=None) -> torch.Tensor:
    """[B, H, n, gp, D] -> [B, H, n, gp/r, D]: each head keeps its phase's
    positions (static slices of the [.., m, r, D] view)."""
    if ratio == 1:
        return x
    B, H, n, gp, D = x.shape
    x6 = x.reshape(B, H, n, gp // ratio, ratio, D)
    parts = [x6[:, hs:he, :, :, p, :] for p, hs, he in _phase_head_ranges(H, ratio, heads)]
    return torch.cat(parts, dim=1)


def _undilate_bhld(out_s: torch.Tensor, lse_s: torch.Tensor, ratio: int, heads=None):
    """Inverse of :func:`_dilate_bhld`: sparse [B, H, n, m, D] (lse [B, H,
    n, m]) back to [B, H, n, m*r, D], the positions a head does not cover 0
    with lse ``NEG_INF`` (the plain attention's -1e8, as in the JAX
    package)."""
    if ratio == 1:
        return out_s, lse_s
    B, H, n, m, D = out_s.shape
    phases = _head_phases(H, ratio, heads, out_s.device)[:, None]
    mask = phases == torch.arange(ratio, device=out_s.device)[None, :]  # [H, r]
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


def _seg_dilate(x: torch.Tensor, g: int, Lp: int, n: int, gp: int, r: int, heads=None) -> torch.Tensor:
    """[B, H, L, D] -> the dilated segment view [B, H, n, m, D], contiguous."""
    B, H, L, D = x.shape
    x = torch.nn.functional.pad(x, (0, 0, 0, Lp - L)).reshape(B, H, n, g, D)
    x = torch.nn.functional.pad(x, (0, 0, 0, gp - g))
    return _dilate_bhld(x, r, heads).contiguous()


def _undilate_to_dense(out_s, lse_s, r: int, g: int, Lp: int, L: int, heads=None):
    """Sparse ``(out [B, H, n, m, D], lse [B, H, n, m])`` -> dense ``(out
    [B, H, L, D], lse [B, H, L])``."""
    B, H = out_s.shape[:2]
    D = out_s.shape[-1]
    out_d, lse_d = _undilate_bhld(out_s, lse_s, r, heads)
    out = out_d[:, :, :, :g].reshape(B, H, Lp, D)[:, :, :L]
    lse = lse_d[:, :, :, :g].reshape(B, H, Lp)[:, :, :L]
    return out, lse


def _bhld_kvlen(B: int, H: int, n: int, g: int, r: int, m: int, real_len: int,
                valid_len_dyn: Optional[torch.Tensor], device, heads=None,
                span: Optional[int] = None) -> Optional[torch.Tensor]:
    """[B, H, n] int32 valid sparse-key counts on ``device``, or None when
    every slot is valid: :func:`_branch_kvlen_bhld`'s table (decided on the
    host) combined by minimum with the per-row valid lengths. The table is
    counted on the device by
    :func:`~gigapath_tpu_torch.ops.dilated_kernels.dyn_sparse_counts` at the
    head-major phases ``arange(H) // ceil(H/r)`` with each row bounded by
    ``min(real_len, valid_len_dyn)`` (the counts grow with the bound, so
    that is the minimum of the two tables): a table copied from host memory
    would make the stream wait for the device once per branch. ``span`` as
    ``dyn_sparse_counts``'s (a table it makes all ``m`` is no table here)."""
    if valid_len_dyn is None and _branch_kvlen_bhld(H, n, g, r, m, real_len, heads) is None:
        return None
    bound = torch.full((B,), real_len, dtype=torch.int64, device=device)
    if valid_len_dyn is not None:
        bound = torch.minimum(bound, valid_len_dyn.to(device=device, dtype=torch.int64))
    phases = _head_phases(H, r, heads, device)
    return dyn_sparse_counts(bound, g, r, m, phases, n, span).contiguous()


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
    def forward(ctx, qh, kh, vh, kvlen, sl, r, is_causal, heads):
        geom = _bhld_geom(qh.shape[2], sl, r)
        g, Lp, n, gp, m = geom
        with torch.autocast(qh.device.type, enabled=False):
            q5, k5, v5 = (_seg_dilate(x, g, Lp, n, gp, r, heads) for x in (qh, kh, vh))
            out_s, lse_s = fk.flash_fwd(q5, k5, v5, kvlen, is_causal)
            out, lse = _undilate_to_dense(out_s, lse_s, r, g, Lp, qh.shape[2], heads)
        ctx.save_for_backward(qh, kh, vh, kvlen, out, lse)
        ctx.geom, ctx.r, ctx.is_causal, ctx.heads = geom, r, is_causal, heads
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):  # no gradient flows through the lse output
        qh, kh, vh, kvlen, out, lse = ctx.saved_tensors
        g, Lp, n, gp, m = ctx.geom
        r, L, heads = ctx.r, qh.shape[2], ctx.heads
        with torch.autocast(qh.device.type, enabled=False):
            do = do.to(qh.dtype)
            q5, k5, v5, do5 = (_seg_dilate(x, g, Lp, n, gp, r, heads) for x in (qh, kh, vh, do))
            delta = (do.float() * out.float()).sum(dim=-1)
            delta5, lse5 = (_seg_dilate(x[..., None], g, Lp, n, gp, r, heads)[..., 0].contiguous()
                            for x in (delta, lse))
            dq5 = fk.flash_bwd_dq(q5, k5, v5, do5, lse5, delta5, kvlen, ctx.is_causal)
            dk5, dv5 = fk.flash_bwd_dkv(q5, k5, v5, do5, lse5, delta5, kvlen, ctx.is_causal)
            grads = [_undilate_to_dense(x5, x5.new_zeros(x5.shape[:-1], dtype=torch.float32), r, g, Lp, L,
                                        heads)[0]
                     for x5 in (dq5, dk5, dv5)]
        return (*grads, None, None, None, None, None)


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
    heads=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One dilated branch in [B, H, L, D] -> ``(out [B, H, L, D], lse [B,
    H, L])``: the flat kernel for an undilated branch it takes (no per-row
    valid lengths), else the segmented kernel on the dilated view, or (with
    ``use_pallas=False``) the plain tier. ``heads``: (first global head,
    global head count) of a tensor-parallel rank's heads, or None."""
    B, H, L, Dh = qh.shape
    g, Lp, n, gp, m = _bhld_geom(L, sl, r)
    if use_pallas is None:
        use_pallas = True  # the kernels at every length (the JAX package's PALLAS_MIN_SEQ is a TPU tuning)
    if use_pallas and valid_len_dyn is None and _flat_eligible(g, r):
        return fk.flat_segment_flash(qh, kh, vh, segment_len=g, real_len=real_len, is_causal=is_causal)
    kvlen = _bhld_kvlen(B, H, n, g, r, m, real_len, valid_len_dyn, qh.device, heads)
    if use_pallas:
        return _BranchFlash.apply(qh, kh, vh, kvlen, sl, r, is_causal, heads)
    q5, k5, v5 = (_seg_dilate(x, g, Lp, n, gp, r, heads) for x in (qh, kh, vh))
    out_s, lse_s = _segment_attention_plain(q5, k5, v5, kvlen, is_causal)
    return _undilate_to_dense(out_s, lse_s, r, g, Lp, L, heads)


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
    heads=None,
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
    runs, instead of stacking them all. ``heads``: None, or (the first
    local head's global index, the global head count) of a tensor-parallel
    rank, whose heads take the phases of their global indices.
    """
    if len(segment_lengths) != len(dilated_ratios):
        raise ValueError("segment_lengths and dilated_ratios differ in length")
    B, L, H, Dh = q.shape
    real_len, valid_dyn = _normalize_valid_len(valid_len, B, L)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def branch(sl, r):
        return _branch_bhld(qh, kh, vh, int(sl), int(r), is_causal=is_causal, real_len=real_len,
                            use_pallas=use_pallas, valid_len_dyn=valid_dyn, heads=heads)

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


# ---------------------------------------------------------------------------
# sequence parallelism (the JAX package's gathered and ring branches)
# ---------------------------------------------------------------------------


def _pad_to_multiple(x: torch.Tensor, mult: int, axis: int) -> torch.Tensor:
    rem = x.shape[axis] % mult
    if rem == 0:
        return x
    pad = [0, 0] * (x.dim() - 1 - axis) + [0, mult - rem]
    return torch.nn.functional.pad(x, pad)


def dense_to_sparse(x: torch.Tensor, ratio: int) -> torch.Tensor:
    """Dilated subsample of segments: [b, g, H, D] -> [b, m, H, D], m =
    ceil(g/r); head ``h`` keeps positions ``phase(h) + r*j`` (static phase
    slices of the [b, m, r, H, D] view, concatenated over heads)."""
    if ratio == 1:
        return x
    b, _, H, Dh = x.shape
    x = _pad_to_multiple(x, ratio, axis=1)
    x5 = x.reshape(b, x.shape[1] // ratio, ratio, H, Dh)
    parts = [x5[:, :, p, hs:he, :] for p, hs, he in _phase_head_ranges(H, ratio)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)


def sparse_to_dense(
    out_s: torch.Tensor, lse_s: torch.Tensor, ratio: int, seg_len: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inverse of :func:`dense_to_sparse` for a branch's results:
    ``out_s`` [b, m, H, D], ``lse_s`` [b, H, m] -> (out [b, g, H, D], lse
    [b, H, g]), the positions a head does not cover 0 with lse
    ``NEG_INF`` (zero weight in the branches' fusion)."""
    if ratio == 1:
        return out_s[:, :seg_len], lse_s[..., :seg_len]
    b, m, H, Dh = out_s.shape
    dev = out_s.device
    own = (torch.arange(H, device=dev) // -(-H // ratio))[None, :] == torch.arange(ratio, device=dev)[:, None]
    out_d = torch.where(own[None, None, :, :, None], out_s[:, :, None], 0)  # [b, m, r, H, D]
    lse_d = torch.where(own.T[None, :, None, :], lse_s[..., None], NEG_INF)  # [b, H, m, r]
    return out_d.reshape(b, m * ratio, H, Dh)[:, :seg_len], lse_d.reshape(b, H, m * ratio)[..., :seg_len]


def _seq_routes(segment_lengths, dilated_ratios, L: int, H: int, E: int, world: int):
    """Each branch's ``(sl, r, route, rps)`` on a seq group of ``world``
    ranks holding ``L`` tokens each: ``"fused"`` (the phase-major kernels,
    as on one device), ``"local"`` (the generic branch) or ``"sharded"``
    (keys from ``rps`` ranks). Raises ``ValueError`` where the JAX package
    asserts, and where its sharded op is not its single-device op."""
    routes = []
    for sl, r in zip(segment_lengths, dilated_ratios):
        sl, r = int(sl), int(r)
        if sl <= L:
            if L % sl:
                raise ValueError(
                    f"a local branch's segment {sl} must divide the shard length {L}: otherwise its "
                    "segments start at the rank edges, not at the sequence's"
                )
            routes.append((sl, r, "fused" if H % r == 0 and E % r == 0 else "local", 1))
            continue
        if sl % L:
            raise ValueError(f"a sharded branch's segment {sl} must be a multiple of the shard length {L}")
        rps = sl // L
        if rps > world:
            raise ValueError(f"gathered branch needs {rps} ranks but the seq group has {world}")
        if world % rps:
            raise ValueError(f"a sharded branch's {rps} ranks must divide the seq group's {world}")
        if L % r:
            raise ValueError(
                f"a sharded branch's ratio {r} must divide the shard length {L}: otherwise each rank's "
                "phases shift against the sequence's"
            )
        routes.append((sl, r, "sharded", rps))
    return routes


def _gather_counts(valid_dyn: torch.Tensor, group) -> torch.Tensor:
    """Every rank's [B] valid counts -> [W, B] int32 (one all-gather)."""
    mine = valid_dyn.to(torch.int32).contiguous()
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, mine, group=group)
    return torch.stack(parts)


class _GatherKV(torch.autograd.Function):
    """All-gather a rank's sparse K or V chunk [b, m, H, D] over the seq
    group and keep the ``rps`` chunks of its own segment -> [b, rps*m, H,
    D] (the JAX package's ``_gather_kv_seq_parallel``). The backward is the
    all-gather's adjoint: the segment's gradient placed at its ranks in a
    [W] list of zero chunks and reduce-scattered, so each rank gets the sum
    of every rank's gradient for its own chunk."""

    @staticmethod
    def forward(ctx, x, group, rps):
        x = x.contiguous()
        start = dist.get_rank(group) // rps * rps
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        ctx.group, ctx.rps, ctx.start = group, rps, start
        return torch.cat(parts[start:start + rps], dim=1)

    @staticmethod
    def backward(ctx, grad):
        chunks = [c.contiguous() for c in grad.chunk(ctx.rps, dim=1)]
        zero = torch.zeros_like(chunks[0])
        inputs = [zero] * dist.get_world_size(ctx.group)
        inputs[ctx.start:ctx.start + ctx.rps] = chunks
        out = torch.empty_like(zero)
        dist.reduce_scatter(out, inputs, group=ctx.group)
        return out, None, None


def _ring_perm(world: int, rps: int) -> Tuple[Tuple[int, int], ...]:
    """(src, dst) pairs rotating every ``rps``-sized sub-ring of the group
    by one: rank r sends to the next rank of its own segment's ring. After
    s rotations rank r holds the chunk of rank ``(r // rps) * rps + (r % rps
    - s) % rps``."""
    if world % rps:
        raise ValueError(f"the sub-ring size {rps} must divide the group size {world}")
    return tuple((src, (src // rps) * rps + ((src % rps) + 1) % rps) for src in range(world))


def _ring_shift(x: torch.Tensor, group, rps: int):
    """Start one rotation of ``x`` around the sub-rings: ``(received,
    work)``, the received buffer valid after ``work.wait()``. One
    ``all_to_all_single`` whose only non-empty splits are this rank's
    next (send) and previous (receive) rank of its sub-ring."""
    world, me = dist.get_world_size(group), dist.get_rank(group)
    perm = _ring_perm(world, rps)
    dst = perm[me][1]
    src = next(s for s, d in perm if d == me)
    n = x.shape[0]
    send, recv = [0] * world, [0] * world
    send[dst], recv[src] = n, n
    out = torch.empty_like(x)
    work = dist.all_to_all_single(out, x.contiguous(), recv, send, group=group, async_op=True)
    return out, work


def _ring_partial_bwd(qs, k_c, v_c, do, lse, delta, cnt, scale):
    """One ring step's (dq, dk, dv) of the local queries against the
    resident chunk: the chunk's probabilities recomputed from the logits
    and the combined lse (so no per-step softmax state is kept), masked
    keys at ``NEG_INF`` before the subtraction and zeroed after, all fp32
    (the JAX package's ``_ring_partial_bwd``)."""
    q32, k32, v32, do32 = qs.float(), k_c.float(), v_c.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", q32, k32) * scale
    col_ok = None
    if cnt is not None:
        col_ok = torch.arange(k_c.shape[1], device=qs.device)[None, None, None, :] < cnt.to(torch.int64)[:, :, None, None]
        s = s.masked_fill(~col_ok, NEG_INF)
    p = torch.exp(s - lse[..., None])
    if col_ok is not None:
        p = p.masked_fill(~col_ok, 0.0)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do32)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do32, v32) - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k32) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q32) * scale
    return dq, dk, dv


class _RingAttention(torch.autograd.Function):
    """Local sparse queries ``qs`` [B, mq, H, D] against the segment's
    rotating sparse K/V chunks (``ks``, ``vs`` [B, mk, H, D], the local
    chunk) -> ``(out [B, mq, H, D], lse [B, H, mq])``: the JAX package's
    ``_ring_attention`` with its custom VJP. ``counts``: None, or the [rps,
    B, H] valid sparse-key counts per origin rank of the sub-ring. The lse
    output takes no gradient.

    Forward: each step's ``partial_attention`` (row 11) folds into an fp32
    accumulator by ``combine_partials``; the next chunk's exchange is
    started before the resident chunk's compute and awaited after it. K
    and V travel as one stacked buffer, one all-to-all a step. Backward:
    the same rotation replays, each rank adds its contribution to the
    resident chunk's dK/dV into fp32 accumulators that rotate with the
    chunk and arrive home after ``rps`` steps; only the local inputs and
    the combined ``(out, lse)`` are saved."""

    @staticmethod
    def forward(ctx, qs, ks, vs, counts, group, rps):
        from gigapath_tpu_torch.obs.spans import ring_step

        my_rel = dist.get_rank(group) % rps
        kv = torch.stack((ks, vs))
        comm_bytes = kv.numel() * kv.element_size()
        out = lse = None
        for s in range(rps):
            with ring_step(s, rps, comm_bytes if s + 1 < rps else 0):
                nxt, work = _ring_shift(kv, group, rps) if s + 1 < rps else (None, None)
                cnt = None if counts is None else counts[(my_rel - s) % rps]
                o_s, l_s = partial_attention(qs, kv[0], kv[1], kv_valid_len=cnt)
                if out is None:
                    out, lse = o_s.float(), l_s
                else:
                    out, lse = combine_partials(out, lse, o_s, l_s)
                if work is not None:
                    work.wait()
                    kv = nxt
        out = out.to(qs.dtype)
        ctx.save_for_backward(qs, ks, vs, counts, out, lse)
        ctx.group, ctx.rps = group, rps
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):  # no gradient flows through the lse output
        from gigapath_tpu_torch.obs.spans import ring_step

        qs, ks, vs, counts, out, lse = ctx.saved_tensors
        group, rps = ctx.group, ctx.rps
        my_rel = dist.get_rank(group) % rps
        scale = qs.shape[-1] ** -0.5
        delta = torch.einsum("bqhd,bqhd->bhq", do.float(), out.float())
        dq = torch.zeros(qs.shape, dtype=torch.float32, device=qs.device)
        acc = torch.zeros((2,) + tuple(ks.shape), dtype=torch.float32, device=ks.device)  # dK, dV
        kv = torch.stack((ks, vs))
        kv_bytes = kv.numel() * kv.element_size()
        acc_bytes = acc.numel() * acc.element_size()
        for s in range(rps):
            with ring_step(s, rps, acc_bytes + (kv_bytes if s + 1 < rps else 0)):
                nxt, work = _ring_shift(kv, group, rps) if s + 1 < rps else (None, None)
                cnt = None if counts is None else counts[(my_rel - s) % rps]
                dq_s, dk_s, dv_s = _ring_partial_bwd(qs, kv[0], kv[1], do, lse, delta, cnt, scale)
                dq += dq_s
                acc, acc_work = _ring_shift(acc + torch.stack((dk_s, dv_s)), group, rps)
                acc_work.wait()
                if work is not None:
                    work.wait()
                    kv = nxt
        return dq.to(qs.dtype), acc[0].to(ks.dtype), acc[1].to(vs.dtype), None, None, None


def _sharded_branch(q, k, v, sl: int, r: int, rps: int, *, is_causal: bool,
                    counts: Optional[torch.Tensor], ring: bool, group,
                    attn_fn=flash_attention) -> Tuple[torch.Tensor, torch.Tensor]:
    """A branch whose segment spans ``rps`` ranks (the JAX package's
    gathered ``_dilated_branch``): local sparse queries against the
    segment's sparse keys, gathered (then ``attn_fn``, ``flash_attention``
    by default) or ringed. ``counts`` is the call's [W, B] all-gather of the
    ranks' valid counts (None: every key valid). Returns the dense ``(out
    [B, L, H, D], lse [B, H, L])``."""
    B, L, H, Dh = q.shape
    qs, ks, vs = (dense_to_sparse(x, r) for x in (q, k, v))
    m = ks.shape[1]
    rank = dist.get_rank(group)
    use_ring = ring and not is_causal
    if ring and is_causal:
        # visible, once: silently taking the gather path would make the
        # flag look broken exactly where memory matters most
        _warn_once(
            "GIGAPATH_RING_ATTN requested on a CAUSAL gathered branch: the ring schedule has no "
            "rank-bias construction yet; using the all-gather path for this branch"
        )
    kv_valid_len = ring_counts = bias = None
    if counts is not None:
        # global suffix padding: every rank before the cut is full, so the
        # per-origin counts sum to a prefix count of the concatenated keys
        seg_counts = counts[rank // rps * rps: rank // rps * rps + rps].to(torch.int64)  # [rps, B]
        phases = torch.arange(H, device=q.device) // -(-H // r)
        num = seg_counts[:, :, None] - phases[None, None, :]
        per_rank = (-torch.div(-num, r, rounding_mode="floor")).clamp(0, m).to(torch.int32)  # [rps, B, H]
        if use_ring:
            ring_counts = per_rank
        else:
            kv_valid_len = per_rank.sum(dim=0).to(torch.int32)
    if use_ring:
        out_s, lse_s = _RingAttention.apply(qs, ks, vs, ring_counts, group, rps)
    else:
        ks, vs = _GatherKV.apply(ks, group, rps), _GatherKV.apply(vs, group, rps)
        if is_causal:
            # key (rank block w', slot j) is visible to query (w, i) of the
            # same phase iff j_cat <= w_rel*m + i on the concatenated axis:
            # earlier ranks whole, the own rank causally, later ones not
            qi = torch.arange(m, device=q.device)[:, None]
            kj = torch.arange(rps * m, device=q.device)[None, :]
            bias = torch.where(kj <= qi + (rank % rps) * m, 0.0, NEG_INF)[None, None]
            out_s, lse_s = attn_fn(qs, ks, vs, is_causal=False, kv_valid_len=None, bias=bias)
        else:
            out_s, lse_s = attn_fn(qs, ks, vs, is_causal=False, kv_valid_len=kv_valid_len)
    return sparse_to_dense(out_s, lse_s, r, L)


def _dilated_attention_seq_parallel(q, k, v, routes, *, is_causal: bool, valid_len, flags: PipelineFlags,
                                    seq_group, attn_fns=None) -> torch.Tensor:
    """The sequence-parallel dispatch over the branches' ``routes``
    (:func:`_seq_routes`), fused by the stacked softmax of their lse.
    ``attn_fns`` (the generic route's, one a branch: dropout or a custom
    ``attn_fn``) sends every local branch to :func:`_dilated_branch` and every
    sharded one to the gather, each on its function, as the JAX package
    does outside ``kernels_eligible``."""
    B, L, H, Dh = q.shape
    E = H * Dh
    real_len, valid_dyn = _normalize_valid_len(valid_len, B, L)
    counts = None
    if valid_len is not None and any(route == "sharded" for _, _, route, _ in routes):
        if is_causal:
            raise NotImplementedError("causal + padding masks + sequence parallelism are not supported together yet")
        if valid_dyn is None:
            # one partial count on every rank is not a contiguous prefix of
            # the concatenated keys, which a prefix count would mis-mask
            raise NotImplementedError(
                "a static-int valid_len on a gathered sequence-parallel branch would mask the same "
                "suffix on every shard, not a contiguous prefix of the concatenated key axis; pass "
                "the per-shard counts of a suffix-padded batch (a [B] tensor) instead"
            )
        counts = _gather_counts(valid_dyn, seq_group)  # once per call, shared by every sharded branch
    qE, kE, vE = (x.reshape(B, L, E) for x in (q, k, v))
    outs, lses = [], []
    for i, (sl, r, route, rps) in enumerate(routes):
        if attn_fns is not None:
            if route == "sharded":
                o, lse = _sharded_branch(q, k, v, sl, r, rps, is_causal=is_causal, counts=counts, ring=False,
                                         group=seq_group, attn_fn=attn_fns[i])
            else:
                o, lse = _dilated_branch(q, k, v, sl, r, is_causal=is_causal, offset=0, attn_fn=attn_fns[i],
                                         valid_len=valid_len)
        elif route == "fused":
            o, lse = dilated_branch_attention(
                qE, kE, vE, sl, r, H, real_len=real_len, valid_len_dyn=valid_dyn, is_causal=is_causal,
                flags=flags,
            )
            o = o.reshape(B, L, H, Dh)
        elif route == "local":
            o, lse = _dilated_branch(q, k, v, sl, r, is_causal=is_causal, offset=0, attn_fn=flash_attention,
                                     valid_len=valid_len)
        else:
            o, lse = _sharded_branch(q, k, v, sl, r, rps, is_causal=is_causal, counts=counts,
                                     ring=flags.ring_attn, group=seq_group)
        outs.append(o)
        lses.append(lse)
    if len(outs) == 1:
        return outs[0].to(q.dtype)
    return _stacked_fusion(outs, lses, q.dtype)


class DilatedAttention(MultiheadAttention):
    """LongNet attention module: the MultiheadAttention projections and
    sub-LN around :func:`dilated_attention`. ``dropout`` (on the attention
    probabilities, in training mode) sends the call to the generic route,
    each branch on the plain attention with dropout; every registry
    configuration trains with ``attention_dropout = 0``, which keeps the
    kernels. ``attn_fn`` replaces ``flash_attention`` on the generic route.

    The decode cache (``incremental_state``) is taken by position: the
    segment structure depends on absolute positions, so the cache enters
    :func:`dilated_attention` as ``offset = index`` and the live prefix of
    the keys, not as a mask over the buffer. The index must be a concrete
    integer (an eager generation loop), else ``NotImplementedError``, as in
    the JAX package.

    ``seq_parallel`` with a ``seq_group`` makes the attention
    sequence-parallel: each rank passes its own slice of the tokens (and of
    ``key_padding_mask``). ``model_group`` makes it tensor-parallel
    (:class:`~gigapath_tpu_torch.ops.attention.MultiheadAttention`): each
    rank attends over its own heads on the tensor-parallel route of
    :func:`dilated_attention`. The two do not combine (``ValueError``)."""

    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        segment_length: Sequence[int],
        dilated_ratio: Sequence[int],
        subln: bool = False,
        layernorm_eps: float = 1e-5,
        dropout: float = 0.0,
        seq_parallel: bool = False,
        seq_group=None,
        model_group=None,
        *,
        xpos_rel_pos: bool = False,
        xpos_scale_base: int = 512,
        multiway: bool = False,
        attn_fn=None,
    ):
        if seq_parallel and seq_group is not None and model_group is not None:
            raise ValueError(
                "DilatedAttention: a model_group (tensor parallelism) and a seq_group (sequence "
                "parallelism) are not supported together; make_train_step gathers a seq dim's tokens "
                "at its entry instead"
            )
        super().__init__(embed_dim, num_heads, subln=subln, layernorm_eps=layernorm_eps, model_group=model_group,
                         dropout=dropout, xpos_rel_pos=xpos_rel_pos, xpos_scale_base=xpos_scale_base,
                         multiway=multiway)
        self.segment_length = tuple(int(x) for x in segment_length)
        self.dilated_ratio = tuple(int(x) for x in dilated_ratio)
        self.seq_group = seq_group if seq_parallel else None
        self.attn_fn = attn_fn

    def _cached_attend_inputs(self, k, v, cur, Lq: int, attn_mask, is_causal):
        try:
            off = operator.index(cur)
        except TypeError as e:
            raise NotImplementedError(
                "DilatedAttention incremental decode requires a concrete cache index (run the generation "
                "loop eagerly): segment boundaries are position-dependent shapes"
            ) from e
        return k[:, :off + Lq], v[:, :off + Lq], attn_mask, is_causal, off

    def _attend(self, q, k, v, *, key_padding_mask=None, attn_mask=None, rel_pos=None, is_causal=False,
                offset: int = 0, generator=None):
        if rel_pos is not None or attn_mask is not None:
            raise ValueError("dilated attention takes neither a rel_pos bias nor an attn_mask")
        # key_padding_mask (True = pad) is a suffix pad (data collate
        # convention): one count shared by every row becomes a static int,
        # per-row counts a [B] tensor (always under per_row_valid_len: the
        # JAX service's jitted forward traces it so). Under sequence
        # parallelism the counts are each rank's own and stay a [B] tensor,
        # as JAX's traced mask does inside shard_map: equal counts on every
        # row are still a per-rank count, which a static int would apply to
        # every rank's suffix
        valid_len = None
        if key_padding_mask is not None:
            counts = (~key_padding_mask.to(torch.bool)).sum(dim=-1).to(torch.int32)
            per_row = getattr(_PER_ROW, "on", False) or self.seq_group is not None
            if not per_row and bool((counts == counts[0]).all()):
                valid_len = int(counts[0])
            else:
                valid_len = counts
        heads = {}
        if self.model_group is not None:
            heads = dict(head_offset=self.head_offset, num_heads=self.num_heads)
        out = dilated_attention(
            q, k, v, self.segment_length, self.dilated_ratio,
            is_causal=is_causal, valid_len=valid_len, seq_group=self.seq_group, offset=offset,
            attn_fn=self.attn_fn, dropout_rate=self.dropout if self.training else 0.0, generator=generator, **heads,
        )
        return out.reshape(out.shape[0], out.shape[1], -1)
