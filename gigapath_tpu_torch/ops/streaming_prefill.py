"""Streaming chunked prefill: fold tile chunks into dilated attention
without building the slide sequence (counterpart of
``gigapath_tpu/ops/streaming_prefill.py``).

Tile chunks arrive one at a time; each new chunk is attended against every
resident chunk it shares a dilated segment with, and the chunk-normalized
partials fold into running per-branch ``(out, lse)`` accumulators through
:func:`~gigapath_tpu_torch.ops.attention.combine_partials`. Attention
temporaries are O(chunk^2) whatever the slide length; the only O(L) state is
the accumulators.

Semantics (those of ``ops/dilated_attention.py``, which stays the dense
oracle):

- a branch ``(segment length sl, ratio r)`` cuts the sequence into segments
  of ``g = min(sl, L)``; within a segment, head ``h`` of phase ``p = h //
  ceil(H/r)`` covers the positions with ``(pos % g) % r == p``, as queries
  and as keys. Uncovered query rows carry a large negative lse, so the
  branch fusion gives them weight 0;
- partials over disjoint key chunks of one branch merge exactly through the
  stored lse;
- branches fuse by an online softmax over the branch axis, the fusion
  weights detached (the JAX package's ``stop_gradient``).

One fold is :func:`pair_partial_attention`: the chunk-pair op of
:mod:`~gigapath_tpu_torch.ops.streaming_kernels`, whose CUDA kernel runs on
a CUDA tensor and whose plain version (the JAX package's jnp tier) runs on a
CPU tensor. There is no switch between them.

Bit-exactness: :class:`StreamingPrefillState` folds chunks in strict index
order (``ingest`` checks it), and every kernel writes each output element
from one thread with no atomics, so callers that receive chunks out of
order and hold them until their turn (the session's frontier buffer)
execute the identical op sequence and get bit-identical results.

:func:`full_length_avals` is the guard that a fold never materializes the
sequence: it lists every tensor of one call that carries the slide's
length. Left out: the JAX ``jit_pairs`` switch (PyTorch runs eagerly);
``fold_fn`` stays as an injectable callable.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gigapath_tpu_torch.ops.attention import NEG_INF, combine_partials
from gigapath_tpu_torch.ops.streaming_kernels import pair_partial as pair_partial_attention

# ---------------------------------------------------------------------------
# the static chunk-fold plan
# ---------------------------------------------------------------------------


def chunk_bounds(n_tokens: int, chunk_tokens: int) -> Tuple[Tuple[int, int], ...]:
    """``((start, stop), ...)`` covering ``[0, n_tokens)`` in order, the
    final chunk ragged."""
    if n_tokens < 1 or chunk_tokens < 1:
        raise ValueError(f"need n_tokens/chunk_tokens >= 1, got {n_tokens}/{chunk_tokens}")
    return tuple(
        (start, min(start + chunk_tokens, n_tokens))
        for start in range(0, n_tokens, chunk_tokens)
    )


def _branch_geometry(
    total_len: int, segment_lengths: Sequence[int], dilated_ratios: Sequence[int]
) -> Tuple[Tuple[int, int], ...]:
    """Per-branch ``(g, r)`` with the dense path's ``g = min(sl, L)`` clamp.
    A multi-segment branch whose segment is not a multiple of its ratio is
    refused: the dense JAX path zero-pads each segment to a ratio multiple
    there, a key set this masked formulation cannot express."""
    if len(segment_lengths) != len(dilated_ratios):
        raise ValueError("segment_lengths and dilated_ratios differ in length")
    branches = []
    for sl, r in zip(segment_lengths, dilated_ratios):
        g, r = min(int(sl), total_len), int(r)
        if total_len > g and g % r != 0:
            raise NotImplementedError(
                f"streaming prefill: branch (sl={sl}, r={r}) has {g} % {r} != 0 with "
                "multiple segments; the dense path's zero-pad key slots have no "
                "streaming counterpart"
            )
        branches.append((g, r))
    return tuple(branches)


def fold_plan(
    bounds: Sequence[Tuple[int, int]], segment_len: int
) -> Tuple[Tuple[int, ...], ...]:
    """For each chunk index ``i``: the sorted chunk indices ``j`` whose token
    range shares at least one ``segment_len``-segment with chunk ``i``,
    exactly the (query chunk, key chunk) pairs one branch must fold."""
    seg = [(start // segment_len, (stop - 1) // segment_len) for start, stop in bounds]
    return tuple(
        tuple(j for j, (lo_j, hi_j) in enumerate(seg) if not (hi_i < lo_j or hi_j < lo_i))
        for lo_i, hi_i in seg
    )


# ---------------------------------------------------------------------------
# one fold and the branch fusion
# ---------------------------------------------------------------------------


def fold_pair(
    acc_out: torch.Tensor,
    acc_lse: torch.Tensor,
    q_blk: torch.Tensor,
    k_blk: torch.Tensor,
    v_blk: torch.Tensor,
    q0: int,
    k0: int,
    valid_len: Optional[int],
    *,
    segment_len: int,
    ratio: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fold step: the pair's partial merged into the running branch
    accumulator through the stored-lse combine (``acc_out`` stays fp32)."""
    out, lse = pair_partial_attention(
        q_blk, k_blk, v_blk, q0, k0,
        segment_len=segment_len, ratio=ratio, valid_len=valid_len,
    )
    return combine_partials(acc_out, acc_lse, out, lse)


def fuse_branch_partials(
    outs: Sequence[torch.Tensor], lses: Sequence[torch.Tensor], out_dtype: torch.dtype,
) -> torch.Tensor:
    """Fold per-branch ``(out [B, c, H, D], lse [B, H, c])`` partials of one
    chunk into the fused output block: an online softmax over the branch
    axis, the weights detached."""

    def bch1(x):  # [B, H, c] -> broadcastable [B, c, H, 1]
        return x.transpose(1, 2)[..., None]

    acc = m_run = l_run = None
    for o, l in zip(outs, lses):
        l = l.detach()
        if acc is None:
            m_run, l_run, acc = l, torch.ones_like(l), o.float()
        else:
            m_new = torch.maximum(m_run, l)
            a = torch.exp(m_run - m_new)
            b = torch.exp(l - m_new)
            l_run = l_run * a + b
            acc = acc * bch1(a) + o.float() * bch1(b)
            m_run = m_new
    return (acc / bch1(l_run)).to(out_dtype)


# ---------------------------------------------------------------------------
# the streaming state
# ---------------------------------------------------------------------------


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy that shares no memory with ``t``; bf16 goes to fp32
    (exact), numpy having no bf16."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


class StreamingPrefillState:
    """Running per-branch ``(out, lse)`` partials over an ingest stream.

    Construction fixes the geometry (chunk bounds, branch schedule, total
    length), so the fold schedule is a function of the slide alone.
    ``ingest(i, q, k, v)`` takes chunk ``i``'s projected ``[B, c, H, D]``
    blocks in strict index order and folds every newly completable pair:
    chunk ``i``'s queries against each resident key chunk sharing a segment,
    and each resident query chunk against chunk ``i``'s keys. Blocks are kept
    only while a later chunk still needs them. ``finalize()`` fuses the
    branch partials per chunk and returns the per-chunk output blocks, never
    a concatenated sequence.
    """

    def __init__(
        self,
        bounds: Sequence[Tuple[int, int]],
        segment_lengths: Sequence[int],
        dilated_ratios: Sequence[int],
        *,
        total_len: Optional[int] = None,
        valid_len: Optional[int] = None,
        fold_fn=None,
    ):
        """``fold_fn``: an optional replacement for the per-pair fold
        callable (the signature of :func:`fold_pair`), e.g. to count or time
        the folds."""
        self.bounds = tuple((int(a), int(b)) for a, b in bounds)
        if not self.bounds or not all(a < b for a, b in self.bounds):
            raise ValueError(f"chunk bounds must be non-empty ranges, got {self.bounds}")
        self.total_len = int(total_len or self.bounds[-1][1])
        self.branches = _branch_geometry(self.total_len, segment_lengths, dilated_ratios)
        self.plans = tuple(fold_plan(self.bounds, g) for g, _ in self.branches)
        self._valid = valid_len
        n = len(self.bounds)
        # last chunk index that still interacts with chunk j, any branch:
        # past it, chunk j's q/k/v blocks are dropped
        self._last_use = [max(max(plan[j]) for plan in self.plans) for j in range(n)]
        self._qkv: Dict[int, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}
        # _acc[branch][chunk] = (out fp32, lse) or None until the first fold
        self._acc: List[List[Optional[Tuple[torch.Tensor, torch.Tensor]]]] = [
            [None] * n for _ in self.branches
        ]
        self._next = 0
        self._fold_fn = fold_fn or fold_pair
        self.folds = 0

    @property
    def n_chunks(self) -> int:
        return len(self.bounds)

    @property
    def next_index(self) -> int:
        return self._next

    def _seed(self, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
        q = self._qkv[i][0]
        B, c, H, D = q.shape
        out = torch.zeros((B, c, H, D), dtype=torch.float32, device=q.device)
        lse = torch.full((B, H, c), NEG_INF, dtype=torch.float32, device=q.device)
        return out, lse

    def _fold(self, b: int, qi: int, kj: int) -> None:
        g, r = self.branches[b]
        acc = self._acc[b][qi]
        if acc is None:
            acc = self._seed(qi)
        q_blk = self._qkv[qi][0]
        _, k_blk, v_blk = self._qkv[kj]
        valid = self.total_len if self._valid is None else int(self._valid)
        self._acc[b][qi] = self._fold_fn(
            acc[0], acc[1], q_blk, k_blk, v_blk,
            self.bounds[qi][0], self.bounds[kj][0], valid,
            segment_len=g, ratio=r,
        )
        self.folds += 1

    def ingest(self, idx: int, q_blk: torch.Tensor, k_blk: torch.Tensor,
               v_blk: torch.Tensor) -> None:
        """Fold chunk ``idx``. Strict in-order contract: callers that see
        out-of-order arrivals hold them until their turn, so every run
        executes the identical fold sequence."""
        if idx != self._next:
            raise ValueError(
                f"streaming prefill folds chunks in index order: got chunk {idx}, "
                f"expected {self._next} (hold out-of-order arrivals at the caller)"
            )
        start, stop = self.bounds[idx]
        if q_blk.shape[1] != stop - start:
            raise ValueError(f"chunk {idx}: block rows {q_blk.shape[1]} != token range [{start}, {stop})")
        self._qkv[idx] = (q_blk, k_blk, v_blk)
        for b, plan in enumerate(self.plans):
            for a in plan[idx]:
                if a > idx or a not in self._qkv:
                    continue
                self._fold(b, a, idx)  # resident queries vs the new keys...
                if a != idx:
                    self._fold(b, idx, a)  # ...and the new queries vs the resident keys
        self._next += 1
        for j in [j for j in self._qkv if self._last_use[j] < self._next]:
            del self._qkv[j]

    def export_state(self) -> dict:
        """The fold's recovery state as a string-keyed dict of host numpy
        arrays: the frontier, the resident q/k/v blocks (their dtype under
        ``qkv_dtype``; bf16 travels as fp32, exactly) and every branch's
        running ``(out, lse)``. Geometry is not exported: a state built with
        the same geometry and given this dict by :meth:`restore_state`
        finishes bit-exact."""
        state: dict = {"next": np.int64(self._next), "folds": np.int64(self.folds)}
        for i, (q, k, v) in self._qkv.items():
            state[f"qkv_{i}"] = {"q": _to_host(q), "k": _to_host(k), "v": _to_host(v)}
            state["qkv_dtype"] = str(q.dtype).replace("torch.", "")
        for b, per_chunk in enumerate(self._acc):
            for i, acc in enumerate(per_chunk):
                if acc is not None:
                    state[f"acc_{b}_{i}"] = {"out": _to_host(acc[0]), "lse": _to_host(acc[1])}
        return state

    def restore_state(self, state: dict, *, device=None) -> None:
        """Inverse of :meth:`export_state` (same geometry required), the
        arrays placed on ``device`` (the CPU if None)."""
        qkv_dtype = getattr(torch, str(state.get("qkv_dtype", "float32")))

        def place(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dtype)

        self._next = int(state["next"])
        self.folds = int(state["folds"])
        self._qkv = {}
        self._acc = [[None] * self.n_chunks for _ in self.branches]
        for key, value in state.items():
            if key.startswith("qkv_") and key != "qkv_dtype":
                i = int(key[len("qkv_"):])
                self._qkv[i] = tuple(place(value[n], qkv_dtype) for n in ("q", "k", "v"))
            elif key.startswith("acc_"):
                b, i = (int(p) for p in key[len("acc_"):].split("_"))
                self._acc[b][i] = (place(value["out"]), place(value["lse"]))

    def _fused_blocks(self, n: int) -> List[torch.Tensor]:
        blocks = []
        for i in range(n):
            accs = [self._acc[b][i] for b in range(len(self.branches))]
            blocks.append(fuse_branch_partials([a[0] for a in accs], [a[1] for a in accs], torch.float32))
        return blocks

    def finalize(self) -> List[torch.Tensor]:
        """Per-chunk fused output blocks ``[B, c, H, D]`` (fp32) in chunk
        order: the dense oracle's rows, cut at the same bounds."""
        if self._next != self.n_chunks:
            raise RuntimeError(
                f"finalize before the stream completed: folded {self._next}/{self.n_chunks} chunks"
            )
        return self._fused_blocks(self.n_chunks)

    def peek_blocks(self) -> List[torch.Tensor]:
        """Fused output blocks of every chunk folded so far, without
        completing or changing the stream. Every such chunk has folded its
        own ``(i, i)`` pair in every branch, and the partials are the exact
        attention over the keys folded so far: later chunks only extend the
        key set."""
        if self._next < 1:
            raise RuntimeError("peek before any chunk folded")
        return self._fused_blocks(self._next)

    def lse_spread(self) -> float:
        """Spread (max - min over branches) of each branch's mean finite lse
        across the folded chunks: a branch whose log-sum-exp mass drifts far
        from its siblings. Synchronises with the device."""
        if self._next < 1:
            return 0.0
        means = []
        for b in range(len(self.branches)):
            total, count = 0.0, 0.0
            for i in range(self._next):
                acc = self._acc[b][i]
                if acc is None:
                    continue
                lse = acc[1]
                finite = lse > NEG_INF * 0.5
                total += float(torch.where(finite, lse, torch.zeros((), device=lse.device)).sum())
                count += float(finite.sum())
            means.append(total / max(count, 1.0))
        return float(max(means) - min(means)) if means else 0.0


def streaming_dilated_attention(
    q_blocks: Sequence[torch.Tensor],
    k_blocks: Sequence[torch.Tensor],
    v_blocks: Sequence[torch.Tensor],
    bounds: Sequence[Tuple[int, int]],
    segment_lengths: Sequence[int],
    dilated_ratios: Sequence[int],
    *,
    total_len: Optional[int] = None,
    valid_len: Optional[int] = None,
) -> List[torch.Tensor]:
    """Drive a :class:`StreamingPrefillState` over in-memory blocks; returns
    the fp32 fused output blocks in chunk order. Differentiable in the
    blocks (the dense ``dilated_attention`` is the oracle)."""
    state = StreamingPrefillState(
        bounds, segment_lengths, dilated_ratios, total_len=total_len, valid_len=valid_len,
    )
    for i, (q, k, v) in enumerate(zip(q_blocks, k_blocks, v_blocks)):
        state.ingest(i, q, k, v)
    return state.finalize()


def full_length_avals(fn, *args, full_len: int) -> List[str]:
    """Run ``fn(*args)`` once under the ledger's op counter
    (``obs/ledger.py``) and list every op input or output, every
    hand-written kernel's argument or result, and every input or output of
    the call itself whose shape carries a ``full_len`` axis: empty for a
    program that never holds the whole sequence. A fold must give ``[]``
    while the dense forward (the negative control) gives many; choose
    ``full_len`` distinct from every chunk, head and feature width."""
    from gigapath_tpu_torch.obs.ledger import op_counter, tensor_leaves

    with op_counter(full=False, full_len=int(full_len)) as counter:
        out = fn(*args)
    io = [f"io: {tuple(t.shape)}" for t in tensor_leaves((args, out)) if full_len in tuple(t.shape)]
    return counter.full_length + io


def assemble_dense_fallback(blocks: Sequence[torch.Tensor], axis: int = 1) -> torch.Tensor:
    """The one sanctioned reassembly of chunk blocks into the dense sequence,
    for the oracle and fallback path only."""
    return torch.cat(list(blocks), dim=axis)
