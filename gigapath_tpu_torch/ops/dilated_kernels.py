"""Phase-major dilated-branch kernels (counterpart of
``gigapath_tpu/ops/pallas_dilated.py``).

One dilated branch ``(segment length sl, ratio r)`` on dense ``[B, L, E]``
activations runs three CUDA kernels (``csrc/``) forward:

1. :func:`pack_phases` packs q, k and v into the diagonal-only phase-major
   layout ``[B, S, r, hb, Mp, Dh]``: head band ``p`` (heads ``p*hb ..
   (p+1)*hb - 1``, ``hb = H/r``) of segment ``s`` holds the phase-``p``
   tokens ``s*g + p + r*j``, 1/r of the dense volume.
2. :func:`dilated_branch_fwd` attends each (segment, phase, head) cell
   with an fp32 online softmax (bf16 tensors on the tensor cores, with the
   Pallas kernel's bf16 roundings), masking keys at or past the ``[B, S,
   r]`` valid-count table, and returns ``(out6, lse [B, S, r, hb, Mp])``.
3. :func:`unpack_phases` writes ``out6`` back to dense ``[B, L, E]`` with
   exact zeros on the lanes the branch does not cover.

and, backward, two more: :func:`dilated_branch_bwd_dq` and
:func:`dilated_branch_bwd_dkv` recompute the probabilities from the saved
lse and return the packed dq and (dk, dv) (bf16 tensors on the tensor
cores, sharing ``csrc/bwd_mma.cuh`` with the segment-flash backward),
between a pack of the output cotangent and q/k/v and an unpack of the
three gradients.

Each wrapper runs its ``*_reference`` plain PyTorch version when its tensor
lies on the CPU, launches its kernel on a CUDA tensor (or raises), and
counts its launches in :data:`LAUNCHES`. :func:`dilated_branch_attention`
is the differentiable branch op (the counterpart of ``_dilated_branch``'s
custom VJP): it strings the kernels together with the lse scatter and keeps
the JAX op's contract: off-band lanes are exact 0, uncovered (token, head)
pairs have lse = -1e30, and no gradient flows through the lse output.

Two more routes, chosen by a :class:`PipelineFlags` snapshot (the JAX
package's, resolved once per public call through
:func:`gigapath_tpu_torch.plan.resolve_plan`):

- ``pack_direct``: a single-segment branch with ``r > 1`` packs and unpacks
  through :func:`pack_phases_direct` (q, k and v in one launch, each
  16-byte unit copied straight to its packed place) and
  :func:`unpack_phases_direct` (whole row-blocks of ``[B, L, E]`` staged in
  shared memory);
- ``stream_fusion``: :func:`dilated_attention_stream_fused` keeps every
  branch's ``(out6, lse5)`` packed (:func:`dilated_branch_attention_packed`)
  and folds them in one :func:`fusion_epilogue_fwd` launch into the fused
  ``[B, L, E]``; its backward (:func:`fusion_epilogue_bwd`, one launch per
  layer) hands each branch its cotangent already packed, so no dense
  per-branch ``out``/``lse`` exists in either direction.

On either route a non-causal branch takes the pipelined kernels where the
JAX package takes them (:func:`_branch_pipelined`): the forward
:func:`dilated_branch_fwd_pipe` under ``pipelined_fwd``
(``GIGAPATH_PIPELINED_ATTN``) or a plan's ``"pipelined"`` variant for the
branch, the backward :func:`dilated_branch_bwd_dq_pipe` and
:func:`dilated_branch_bwd_dkv_pipe` under ``pipelined_bwd``
(``GIGAPATH_PIPELINED_BWD``). The pipelined forward computes the serial
forward's function (the two Pallas forwards round alike in bf16), issuing
the next key tile's scores before the current tile's softmax; the
pipelined backward differs from the serial one in bf16 by rounding the
logits' q*scale*log2(e), as the Pallas kernels do. A causal call runs the
serial kernels whatever the flags say, as in the JAX package.

The port's packed row count ``Mp`` is ``m`` rounded up to the kernel's
64-row tile; the TPU's VMEM caps and 128-lane quantum do not apply.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from gigapath_tpu_torch.ops.common import check_cuda, cuda_stream, env_flag, kernel_wrapper, raise_on, round_up

NEG_INF = -1e30  # lse of a (token, head) pair the branch does not cover
M_FLOOR = -1e20  # running-max floor: masked keys underflow to exactly 0
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
ROW_TILE = 64  # query/key rows per tile of the branch kernel
KEY_TILE = 64  # keys per step of the bf16 forward kernels' online softmax
MAX_HEAD_DIM = 128  # the branch kernels take head widths that are multiples of 4 (bf16: 8) up to this

# Launches of each CUDA kernel in this process. A wrapper adds one where it
# launches its kernel and nowhere else; callers reset and read it.
LAUNCHES = {
    "pack_phases": 0, "dilated_branch_fwd": 0, "unpack_phases": 0,
    "dilated_branch_bwd_dq": 0, "dilated_branch_bwd_dkv": 0,
    "pack_phases_direct": 0, "unpack_phases_direct": 0,
    "fusion_epilogue_fwd": 0, "fusion_epilogue_bwd": 0,
    "dilated_branch_fwd_pipe": 0, "dilated_branch_bwd_dq_pipe": 0, "dilated_branch_bwd_dkv_pipe": 0,
}
MAX_FUSED_BRANCHES = 8  # branches one fusion_epilogue_fwd or fusion_epilogue_bwd launch takes
PACK_DIRECT_MAX_TENSORS = 3  # tensors one pack_phases_direct launch packs


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# the dispatch-flag snapshot
# ---------------------------------------------------------------------------


class PipelineFlags(NamedTuple):
    """One snapshot of the kernel-dispatch flags, with the JAX package's
    field names and defaults (``gigapath_tpu/ops/pallas_dilated.py``).

    Resolved once per public ``dilated_attention`` call and handed to every
    branch and, through ``ctx``, to the backward, so the two passes of one
    call never see different flags. The port acts on ``pack_direct``,
    ``stream_fusion``, ``streaming_fusion``, ``pipelined_fwd``,
    ``pipelined_bwd``, ``ring_attn`` (the sequence-parallel ring schedule)
    and the variant of ``branch_plans`` (:func:`_branch_pipelined`); the tile encoder's factory reads
    ``quant_tile`` (``GIGAPATH_QUANT_TILE`` as written, or a blessed plan's
    tier; the factory normalizes it). The other fields are carried so that
    a plan or a caller can set them, and are unused here: ``pipe_block_k``,
    ``pipe_bwd_block_k`` (the pipelined kernels' TPU key blocks; the CUDA
    kernels stage 64 keys, the fp32 ones 32 above a head width of 64), the branch
    ``block`` of ``branch_plans`` and the fold blocks are TPU VMEM tiling;
    ``quant_pallas`` picks the TPU's Pallas or XLA quantized matmul (the
    port always runs its kernels); ``chunked_prefill`` is read by the
    disaggregated consumer where its plan does not set it; the port's
    streaming fold always runs its kernels (``fold_pallas``)."""

    pipelined_fwd: bool = False
    pipelined_bwd: bool = False
    pipe_block_k: Optional[int] = None
    pipe_bwd_block_k: Optional[int] = None
    pack_direct: bool = False
    stream_fusion: bool = False
    ring_attn: bool = False
    chunked_prefill: bool = False
    quant_tile: str = ""
    quant_pallas: bool = False
    # the online dense fold over branches (not the packed epilogue)
    streaming_fusion: bool = False
    # (segment_length, ratio, variant, block) per branch class; only a plan
    # fills it
    branch_plans: Tuple[Tuple[int, int, str, int], ...] = ()
    fold_pallas: bool = False
    fold_block_q: Optional[int] = None
    fold_block_k: Optional[int] = None
    fold_branches: Tuple[Tuple[int, int, int, int], ...] = ()


# field -> its environment variable: the plan resolver lets a blessed plan
# fill only the fields whose variable is unset
FLAG_ENV = {
    "pipelined_fwd": "GIGAPATH_PIPELINED_ATTN",
    "pipelined_bwd": "GIGAPATH_PIPELINED_BWD",
    "pipe_block_k": "GIGAPATH_PIPE_BLOCK_K",
    "pipe_bwd_block_k": "GIGAPATH_PIPE_BWD_BLOCK_K",
    "pack_direct": "GIGAPATH_PACK_DIRECT",
    "stream_fusion": "GIGAPATH_STREAM_FUSION",
    "streaming_fusion": "GIGAPATH_STREAMING_FUSION",
    "ring_attn": "GIGAPATH_RING_ATTN",
    "chunked_prefill": "GIGAPATH_CHUNKED_PREFILL",
    "quant_tile": "GIGAPATH_QUANT_TILE",
    "quant_pallas": "GIGAPATH_QUANT_PALLAS",
    "fold_pallas": "GIGAPATH_FOLD_PALLAS",
    "fold_block_q": "GIGAPATH_FOLD_BLOCK_Q",
    "fold_block_k": "GIGAPATH_FOLD_BLOCK_K",
}


def snapshot_flags() -> PipelineFlags:
    """Read the dispatch flags the port acts on from the environment, once:
    GIGAPATH_PIPELINED_ATTN/_BWD, GIGAPATH_PIPE(_BWD)_BLOCK_K,
    GIGAPATH_PACK_DIRECT, GIGAPATH_STREAM_FUSION,
    GIGAPATH_STREAMING_FUSION, GIGAPATH_RING_ATTN, GIGAPATH_CHUNKED_PREFILL,
    GIGAPATH_QUANT_TILE and GIGAPATH_QUANT_PALLAS. The other fields keep
    their defaults."""

    def _int(name: str) -> Optional[int]:
        raw = os.environ.get(name, "").strip()
        return int(raw) if raw else None

    return PipelineFlags(
        pipelined_fwd=env_flag("GIGAPATH_PIPELINED_ATTN"),
        pipelined_bwd=env_flag("GIGAPATH_PIPELINED_BWD"),
        pipe_block_k=_int("GIGAPATH_PIPE_BLOCK_K"),
        pipe_bwd_block_k=_int("GIGAPATH_PIPE_BWD_BLOCK_K"),
        pack_direct=env_flag("GIGAPATH_PACK_DIRECT"),
        stream_fusion=env_flag("GIGAPATH_STREAM_FUSION"),
        streaming_fusion=env_flag("GIGAPATH_STREAMING_FUSION"),
        ring_attn=env_flag("GIGAPATH_RING_ATTN"),
        chunked_prefill=env_flag("GIGAPATH_CHUNKED_PREFILL"),
        quant_tile=os.environ.get("GIGAPATH_QUANT_TILE", "").strip(),
        quant_pallas=env_flag("GIGAPATH_QUANT_PALLAS"),
    )


def _branch_pipelined(flags: PipelineFlags, sl: int, r: int) -> Tuple[bool, bool]:
    """(forward pipelined?, backward pipelined?) for one branch, as the JAX
    package's ``_branch_pipelined``: a plan's variant for the branch's own
    ``(sl, r)`` pins the forward (``"serial"``/``"pipelined"``; ``""``
    takes ``pipelined_fwd``), and the backward always follows the global
    ``pipelined_bwd``. The caller runs the serial kernels on a causal call
    whatever this says."""
    variant = ""
    for entry in flags.branch_plans:
        if int(entry[0]) == int(sl) and int(entry[1]) == int(r):
            variant = str(entry[2])
            break
    if variant == "serial":
        return False, bool(flags.pipelined_bwd)
    if variant == "pipelined":
        return True, bool(flags.pipelined_bwd)
    return bool(flags.pipelined_fwd), bool(flags.pipelined_bwd)


# ---------------------------------------------------------------------------
# geometry and valid-key counts
# ---------------------------------------------------------------------------


def _branch_geometry(L: int, sl: int, r: int) -> Tuple[int, int, int, int]:
    """(g, S, m, Mp): segment length and count, sparse (per-phase) length
    of a segment, and ``m`` padded to the kernel's row tile."""
    g = min(sl, L)
    S = round_up(L, g) // g
    m = round_up(g, r) // r
    return g, S, m, round_up(m, ROW_TILE)


def _phase_kvlen(S: int, g: int, r: int, m: int, real_len: int) -> np.ndarray:
    """[S, r] valid sparse keys per (segment, phase): position
    ``s*g + p + r*j`` must be a real token and inside its segment."""
    seg = np.arange(S)[:, None]
    phase = np.arange(r)[None, :]
    in_seg = np.clip(real_len - seg * g, 0, g)
    counts = np.ceil((in_seg - phase) / r)
    return np.clip(counts, 0, m).astype(np.int32)


def dyn_sparse_counts(
    valid_dyn: torch.Tensor, g: int, r: int, m: int, phases: torch.Tensor, n_seg: int,
    span: Optional[int] = None,
) -> torch.Tensor:
    """[B, len(phases), n_seg] valid sparse-key counts from per-batch valid
    lengths ``valid_dyn`` [B]: slot j of phase p is valid iff dense position
    ``seg*g + p + r*j`` lies inside both the segment's first ``span``
    positions (default g; ``m*r`` also counts the pad that makes a segment
    a multiple of r, as the JAX package's generic branch does) and the
    valid prefix."""
    seg = torch.arange(n_seg, device=valid_dyn.device)
    in_seg = (valid_dyn.reshape(-1, 1).to(torch.int64) - seg[None] * g).clamp(0, g if span is None else span)
    num = in_seg[:, None, :] - phases.to(torch.int64)[None, :, None]
    counts = -torch.div(-num, r, rounding_mode="floor")  # exact integer ceil
    return counts.clamp(0, m).to(torch.int32)


def _branch_kvlen(
    B: int, S: int, g: int, r: int, m: int, real_len: int,
    vl_dyn: Optional[torch.Tensor], device: torch.device,
) -> torch.Tensor:
    """[B, S, r] int32 valid sparse-key counts of the valid length
    ``min(real_len, vl_dyn[b])`` per row (``vl_dyn`` None: ``real_len``),
    counted on ``device``: nothing is copied from the host, so a CUDA
    caller's stream never waits for the card here."""
    valid = torch.full((B,), int(real_len), dtype=torch.int64, device=device)
    if vl_dyn is not None:
        valid = torch.minimum(valid, vl_dyn.reshape(B).to(device=device, dtype=torch.int64))
    counts = dyn_sparse_counts(valid, g, r, m, torch.arange(r, device=device), S)  # [B, r, S]
    return counts.transpose(1, 2).contiguous()


def _scatter_lse(lse5: torch.Tensor, L: int, H: int, g: int, r: int, m: int) -> torch.Tensor:
    """Kernel lse [B, S, r, hb, Mp] -> dense [B, H, L], NEG_INF at the
    (token, head) pairs the branch does not cover."""
    B, S, _, hb, _ = lse5.shape
    lse = lse5[..., :m]  # [B, S, r(phase), hb, m]
    dense = lse.new_full((B, S, r, hb, m, r), NEG_INF)  # [.., band, t, j, phase]
    # token s*g + j*r + p is covered by head p*hb + t: the band == phase diagonal
    dense.diagonal(dim1=2, dim2=5).copy_(lse.permute(0, 1, 3, 4, 2))
    dense = dense.reshape(B, S, H, m * r)[..., :g]  # head h = band*hb + t
    return dense.permute(0, 2, 1, 3).reshape(B, H, S * g)[..., :L]


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def pack_phases_reference(
    x: torch.Tensor, g: int, S: int, r: int, Mp: int, num_heads: int
) -> torch.Tensor:
    """[B, L, E] -> packed [B, S, r, hb, Mp, Dh]; slots past the segment or
    the sequence are exact zeros."""
    B, L, E = x.shape
    hb, Dh = num_heads // r, E // num_heads
    xp = torch.nn.functional.pad(x, (0, 0, 0, S * g - L)).reshape(B, S, g, E)
    xp = torch.nn.functional.pad(xp, (0, 0, 0, Mp * r - g))
    x7 = xp.reshape(B, S, Mp, r, r, hb, Dh)  # [.., j, phase, band, t, d]
    diag = x7.diagonal(dim1=3, dim2=4)  # [B, S, Mp, hb, Dh, r]
    return diag.permute(0, 1, 5, 3, 2, 4).contiguous()


def unpack_phases_reference(
    p6: torch.Tensor, L: int, E: int, g: int, S: int, r: int
) -> torch.Tensor:
    """Packed [B, S, r, hb, Mp, Dh] -> dense [B, L, E], off-band lanes 0."""
    B, _, _, hb, Mp, Dh = p6.shape
    x7 = p6.new_zeros((B, S, Mp, r, r, hb, Dh))  # [.., j, phase, band, t, d]
    x7.diagonal(dim1=3, dim2=4).copy_(p6.permute(0, 1, 4, 3, 5, 2))
    x = x7.reshape(B, S, Mp * r, E)[:, :, :g]
    return x.reshape(B, S * g, E)[:, :L]


def _check_direct(name: str, L: int, g: int, S: int, r: int) -> None:
    if S != 1 or g != L or r < 2:
        raise ValueError(f"{name}: takes one segment covering the sequence and r > 1; got L={L}, g={g}, S={S}, r={r}")


def pack_phases_direct_reference(
    x: torch.Tensor, g: int, S: int, r: int, Mp: int, num_heads: int
) -> torch.Tensor:
    """Single-segment pack read off ``[B, L, E]`` in row-blocks of r tokens:
    dense row ``j*r + p`` gives packed row j of phase p. Rows >= L (and so
    every packed row past the dense extent) are exact zeros."""
    B, L, E = x.shape
    _check_direct("pack_phases_direct", L, g, S, r)
    hb, Dh = num_heads // r, E // num_heads
    x6 = torch.nn.functional.pad(x, (0, 0, 0, Mp * r - L)).reshape(B, Mp, r, r, hb, Dh)
    diag = x6.diagonal(dim1=2, dim2=3)  # [B, Mp, hb, Dh, r(phase == band)]
    return diag.permute(0, 4, 2, 1, 3).unsqueeze(1).contiguous()


def unpack_phases_direct_reference(
    p6: torch.Tensor, L: int, E: int, g: int, S: int, r: int
) -> torch.Tensor:
    """Inverse of :func:`pack_phases_direct_reference`: packed [B, 1, r, hb,
    Mp, Dh] -> dense [B, L, E], off-band lanes exact 0."""
    B, _, _, hb, Mp, Dh = p6.shape
    _check_direct("unpack_phases_direct", L, g, S, r)
    x6 = p6.new_zeros((B, Mp, r, r, hb, Dh))  # [b, j, phase, band, t, d]
    x6.diagonal(dim1=2, dim2=3).copy_(p6[:, 0].permute(0, 3, 2, 4, 1))
    return x6.reshape(B, Mp * r, E)[:, :L]


def _round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp32 ``x`` rounded to ``dtype`` and widened back (a no-op in fp32):
    the Pallas kernels' ``.astype`` before a matmul."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def dilated_branch_fwd_reference(
    q6: torch.Tensor, k6: torch.Tensor, v6: torch.Tensor, kvlen: torch.Tensor,
    is_causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed q/k/v [B, S, r, hb, Mp, Dh] + kvlen [B, S, r] ->
    ``(out6, lse [B, S, r, hb, Mp] fp32)``, the kernel's math in plain
    PyTorch: an fp32 base-2 online softmax over key tiles of
    :data:`KEY_TILE`, masked keys by select, a row with no valid key gives
    out = 0 and lse ~ -6.9e19. It rounds where the Pallas ``_fwd_kernel``
    (and ``_fwd_kernel_pipe``) round in the input dtype: q*scale*log2(e)
    before QK^T and the probabilities before PV, the denominator summing
    them unrounded; in fp32 both roundings are no-ops. All cells at once:
    the largest temporary is one [B, S, r, hb, Mp, KEY_TILE] fp32 score
    block.

    Which function this is in bf16: p is rounded relative to the running
    max, so where the max sits decides the rounding. The port computes the
    running max over its kernels' 64-key tiles (this function and the
    tensor-core kernels alike, so a bf16 comparison on the card measures
    the kernel and not the blocking). The JAX kernels take it over their
    own blocks: one block per cell up to m = 1024 in the serial forward,
    512-key blocks in the pipelined one. Their placement would need each
    row's max over a whole JAX block before any PV, a second Q.K^T pass; so
    past one key tile the two packages differ by a few bf16 roundings of p
    (read up to 4.7e-3 of out's max at m = 512, and a mean error against
    the fp32 answer no larger than JAX's:
    ``tests/test_torch_dilated.py::test_serial_bf16_multi_tile_matches_jax``).
    In fp32 the two are one function."""
    B, S, r, hb, Mp, Dh = q6.shape
    dev = q6.device
    qh = _round_to(q6.float() * (Dh**-0.5 * LOG2E), q6.dtype)
    kf, vf = k6.float(), v6.float()
    rows = torch.arange(Mp, device=dev)[:, None]
    kv = kvlen.to(device=dev, dtype=torch.int64)[:, :, :, None, None, None]  # [B, S, r, 1, 1, 1]
    m_run = torch.full((B, S, r, hb, Mp, 1), M_FLOOR, dtype=torch.float32, device=dev)
    l_run = torch.zeros_like(m_run)
    acc = torch.zeros((B, S, r, hb, Mp, Dh), dtype=torch.float32, device=dev)
    for j0 in range(0, Mp, KEY_TILE):
        cols = torch.arange(j0, min(j0 + KEY_TILE, Mp), device=dev)[None, :]
        mask = cols >= kv  # [B, S, r, 1, 1, width]
        if is_causal:
            mask = mask | (cols > rows)
        sc = (qh @ kf[..., j0:j0 + KEY_TILE, :].transpose(-1, -2)).masked_fill(mask, NEG_INF)
        m_new = torch.maximum(m_run, sc.amax(dim=-1, keepdim=True))
        pr = torch.exp2(sc - m_new)
        alpha = torch.exp2(m_run - m_new)
        l_run = l_run * alpha + pr.sum(dim=-1, keepdim=True)
        acc = acc * alpha + _round_to(pr, q6.dtype) @ vf[..., j0:j0 + KEY_TILE, :]
        m_run = m_new
    safe_l = l_run.clamp_min(1e-30)
    return (acc / safe_l).to(q6.dtype), ((m_run + torch.log2(safe_l)) * LN2)[..., 0]


def dilated_branch_bwd_reference(
    q6: torch.Tensor, k6: torch.Tensor, v6: torch.Tensor, do6: torch.Tensor,
    lse5: torch.Tensor, delta: torch.Tensor, kvlen: torch.Tensor,
    is_causal: bool = False, *, dq: bool = True, dkv: bool = True,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Packed q/k/v and output cotangent ``do6`` [B, S, r, hb, Mp, Dh], the
    forward's ``lse5`` and ``delta = rowsum(do6 * out6)`` (fp32 [B, S, r,
    hb, Mp]) -> ``(dq6, dk6, dv6)``, the kernels' math in plain PyTorch:
    fp32 probabilities recomputed in base 2 from the lse, masked keys by a
    select of -1e30 before the exponent (a cell with no valid key has lse ~
    -6.9e19, and its gradients come out exactly 0), ds rounded to the input
    dtype before ``ds @ k`` (dQ), as the Pallas ``_dq_kernel``. ``dq``/``dkv`` pick
    which gradients to compute (the others are None). Chunked over (s, p,
    t), as :func:`dilated_branch_fwd_reference`."""
    B, S, r, hb, Mp, Dh = q6.shape
    scale = Dh**-0.5
    dq6 = torch.empty_like(q6) if dq else None
    dk6 = torch.empty_like(k6) if dkv else None
    dv6 = torch.empty_like(v6) if dkv else None
    cols = torch.arange(Mp, device=q6.device)
    causal_mask = cols[None, :] > cols[:, None] if is_causal else None
    for s in range(S):
        for p in range(r):
            key_mask = cols[None, None, :] >= kvlen[:, s, p].to(torch.int64)[:, None, None]
            if causal_mask is not None:
                key_mask = key_mask | causal_mask[None]
            for t in range(hb):
                qf, kf, vf, dof = (x[:, s, p, t].float() for x in (q6, k6, v6, do6))
                sc = (qf * (scale * LOG2E)) @ kf.transpose(1, 2)  # [B, Mp, Mp]
                sc = sc.masked_fill(key_mask, NEG_INF)
                pr = torch.exp2(sc - lse5[:, s, p, t, :, None] * LOG2E)
                ds = pr * (dof @ vf.transpose(1, 2) - delta[:, s, p, t, :, None])
                if dq:
                    dq6[:, s, p, t] = ((_round_to(ds, q6.dtype) @ kf) * scale).to(q6.dtype)
                if dkv:
                    dk6[:, s, p, t] = ((ds.transpose(1, 2) @ qf) * scale).to(k6.dtype)
                    dv6[:, s, p, t] = (pr.transpose(1, 2) @ dof).to(v6.dtype)
    return dq6, dk6, dv6


def dilated_branch_fwd_pipe_reference(
    q6: torch.Tensor, k6: torch.Tensor, v6: torch.Tensor, kvlen: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pipelined forward's math in plain PyTorch (non-causal): the
    serial kernel's function, :func:`dilated_branch_fwd_reference`, since
    the serial and the pipelined Pallas forwards round alike (their outputs
    are bit-identical). In bf16 that is the port's 64-key running max, not
    the JAX pipelined kernel's 512-key blocks (see
    :func:`dilated_branch_fwd_reference`; held against JAX past one block
    by ``tests/test_torch_pipelined.py::test_pipelined_bf16_multi_block_matches_jax``)."""
    return dilated_branch_fwd_reference(q6, k6, v6, kvlen)


def dilated_branch_bwd_pipe_reference(
    q6: torch.Tensor, k6: torch.Tensor, v6: torch.Tensor, do6: torch.Tensor,
    lse5: torch.Tensor, delta: torch.Tensor, kvlen: torch.Tensor,
    *, dq: bool = True, dkv: bool = True,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The pipelined backward's math in plain PyTorch (non-causal):
    ``(dq6, dk6, dv6)`` from the arguments of
    :func:`dilated_branch_bwd_reference`, with the pipelined Pallas
    kernels' roundings: the logits from q*scale*log2(e) rounded to the input
    dtype, ds rounded to it before ``ds @ k`` (dQ), p and ds fp32 against
    fp32 dout and unscaled q (dK/dV). Chunked over (s, p, t), as
    :func:`dilated_branch_bwd_reference`."""
    B, S, r, hb, Mp, Dh = q6.shape
    scale = Dh**-0.5
    dq6 = torch.empty_like(q6) if dq else None
    dk6 = torch.empty_like(k6) if dkv else None
    dv6 = torch.empty_like(v6) if dkv else None
    cols = torch.arange(Mp, device=q6.device)
    for s in range(S):
        for p in range(r):
            key_mask = cols[None, None, :] >= kvlen[:, s, p].to(torch.int64)[:, None, None]
            for t in range(hb):
                qf, kf, vf, dof = (x[:, s, p, t].float() for x in (q6, k6, v6, do6))
                qh = _round_to(qf * (scale * LOG2E), q6.dtype)
                sc = (qh @ kf.transpose(1, 2)).masked_fill(key_mask, NEG_INF)  # [B, Mp, Mp]
                pr = torch.exp2(sc - lse5[:, s, p, t, :, None] * LOG2E)
                ds = pr * (dof @ vf.transpose(1, 2) - delta[:, s, p, t, :, None])
                if dq:
                    dq6[:, s, p, t] = ((_round_to(ds, q6.dtype) @ kf) * scale).to(q6.dtype)
                if dkv:
                    dk6[:, s, p, t] = ((ds.transpose(1, 2) @ qf) * scale).to(k6.dtype)
                    dv6[:, s, p, t] = (pr.transpose(1, 2) @ dof).to(v6.dtype)
    return dq6, dk6, dv6


def fusion_epilogue_fwd_reference(
    outs: Sequence[torch.Tensor], lses: Sequence[torch.Tensor], plan: "EpiloguePlan"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every branch's packed ``(out6, lse5)`` -> ``(out [B, L, E] in out6's
    dtype, fused_lse [B, L, H] fp32)``: the kernel's fp32 online softmax
    over the branches in plain PyTorch, its running max floored at
    ``M_FLOOR``. A branch weighs exactly 0 at a (token, head) it does not
    cover (lse -1e30 there); a pair no branch covers gives out 0 and
    ``fused_lse = NEG_INF``."""
    L, E, H = plan.L, plan.E, plan.H
    B, dev = outs[0].shape[0], outs[0].device
    m_run = torch.full((B, L, H, 1), M_FLOOR, dtype=torch.float32, device=dev)
    l_run = torch.zeros_like(m_run)
    acc = torch.zeros((B, L, H, E // H), dtype=torch.float32, device=dev)
    for o6, l5, (g, S, r, m, _) in zip(outs, lses, plan.branches):
        o = unpack_phases_reference(o6.float(), L, E, g, S, r).reshape(acc.shape)
        lse = _scatter_lse(l5, L, H, g, r, m).transpose(1, 2)[..., None]
        m_new = torch.maximum(m_run, lse)
        a, w = torch.exp(m_run - m_new), torch.exp(lse - m_new)
        acc = acc * a + o * w
        l_run = l_run * a + w
        m_run = m_new
    covered = l_run > 0
    l_safe = torch.where(covered, l_run, torch.ones_like(l_run))
    out = torch.where(covered, acc / l_safe, torch.zeros_like(acc)).reshape(B, L, E)
    fused = torch.where(covered, m_run + torch.log(l_safe), torch.full_like(m_run, NEG_INF))
    return out.to(outs[0].dtype), fused[..., 0]


def fusion_epilogue_bwd_reference(
    dy: torch.Tensor, fused_lse: torch.Tensor, lses: Sequence[torch.Tensor], plan: "EpiloguePlan"
) -> list:
    """Every branch's packed output cotangent, in plan order: ``d_out6 =
    exp(lse_branch - fused_lse) * dY`` in fp32, stored in dY's dtype in the
    branch's packed layout ``[B, S, r, hb, Mp, Dh]``, exact zeros at every
    slot outside the segment or the sequence. ``dy`` is ``[B, L, E]``,
    ``fused_lse`` ``[B, L, H]`` fp32 (the forward's), ``lses`` each
    branch's ``lse5``."""
    B, L, E = dy.shape
    H = plan.H
    d6s = []
    for lse5, (g, S, r, m, Mp) in zip(lses, plan.branches):
        w = torch.exp(_scatter_lse(lse5, L, H, g, r, m) - fused_lse.transpose(1, 2))  # [B, H, L]
        x = dy.float().reshape(B, L, H, E // H) * w.transpose(1, 2)[..., None]
        d6s.append(pack_phases_reference(x.reshape(B, L, E).to(dy.dtype), g, S, r, Mp, H))
    return d6s


# ---------------------------------------------------------------------------
# the kernels' declared work (the compile-side profile's counts)
# ---------------------------------------------------------------------------


def _branch_work(q6: torch.Tensor, kvlen: torch.Tensor, is_causal: bool):
    """(pairs, rows, keys) of one branch call, summed over its heads: each
    (segment, phase) cell's valid keys are its real tokens, so its real
    query rows too (self-attention), and the masks admit every (query, key)
    pair of them, or the lower triangle when causal."""
    hb = q6.shape[3]
    kv = kvlen.detach().to("cpu", torch.float64)
    pairs = kv * (kv + 1) / 2 if is_causal else kv * kv
    return hb * float(pairs.sum()), hb * float(kv.sum()), hb * float(kv.sum())


def _attention_cost(per_pair: int, row_tensors: int, key_tensors: int, row_vectors: int):
    """``cost`` of a branch attention kernel: ``per_pair * Dh`` operations
    per admitted pair (4: q.k and p.v; 6 for dq; 8 for dkv); the bytes of
    ``row_tensors`` query-row and ``key_tensors`` key-row tensors of width
    Dh plus ``row_vectors`` fp32 values per row (lse, delta)."""

    def cost(q6, kvlen, is_causal, **_):
        pairs, rows, keys = _branch_work(q6, kvlen, bool(is_causal))
        Dh, es = q6.shape[-1], q6.element_size()
        return (per_pair * Dh * pairs,
                (row_tensors * rows + key_tensors * keys) * Dh * es + row_vectors * rows * 4)

    return cost


def _pack_cost(x, S, r, Mp, **_):
    B, L, E = x.shape
    return 0.0, float(B * L * E // r + B * S * Mp * E) * x.element_size()


def _pack_direct_cost(xs, S, r, Mp, **_):
    return 0.0, float(sum(_pack_cost(x, S, r, Mp)[1] for x in xs))


def _unpack_cost(p6, L, E, r, **_):
    B = p6.shape[0]
    return 0.0, float(B * L * E // r + B * L * E) * p6.element_size()


def _epilogue_fwd_cost(outs, plan, **_):
    """Every covered packed element and its lse read once, out and
    fused_lse written once."""
    B, es = outs[0].shape[0], outs[0].element_size()
    L, E, H = plan.L, plan.E, plan.H
    nbytes = B * L * E * es + B * L * H * 4
    for g, S, r, m, Mp in plan.branches:
        nbytes += B * L * E // r * es + B * L * H // r * 4
    return 0.0, float(nbytes)


def _epilogue_bwd_cost(dy, plan, **_):
    """dY and fused_lse read once, each branch's covered lse read, every
    branch's whole packed cotangent written."""
    B, L, E = dy.shape
    H, es = plan.H, dy.element_size()
    nbytes = B * L * E * es + B * L * H * 4
    for g, S, r, m, Mp in plan.branches:
        nbytes += B * L * H // r * 4 + B * S * Mp * E * es
    return 0.0, float(nbytes)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


@kernel_wrapper("pack_phases", _pack_cost)
def pack_phases(
    x: torch.Tensor, g: int, S: int, r: int, Mp: int, num_heads: int
) -> torch.Tensor:
    """Dense [B, L, E] -> packed [B, S, r, hb, Mp, Dh] (``csrc/pack_phases.cu``:
    a block per 16 or fewer packed rows of every phase of one segment, each
    row's band loaded into shared memory and each (phase, head)'s strip
    written whole, in 16-byte units where Dh and both pointers allow)."""
    if x.device.type == "cpu":
        return pack_phases_reference(x, g, S, r, Mp, num_heads)
    from gigapath_tpu_torch.ops import _build

    check_cuda("pack_phases", x)
    B, L, E = x.shape
    hb, Dh = num_heads // r, E // num_heads
    out = torch.empty((B, S, r, hb, Mp, Dh), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _build.library("pack_phases").gp_pack_phases(
            x.data_ptr(), out.data_ptr(), x.element_size(),
            B, L, E, g, S, r, hb, Dh, Mp, cuda_stream(x),
        )
    raise_on(rc, "pack_phases")
    LAUNCHES["pack_phases"] += 1
    return out


@kernel_wrapper("unpack_phases", _unpack_cost)
def unpack_phases(p6: torch.Tensor, L: int, E: int, g: int, S: int, r: int) -> torch.Tensor:
    """Packed [B, S, r, hb, Mp, Dh] -> dense [B, L, E], off-band lanes exact
    0 (``csrc/unpack_phases.cu``: the pack's blocks in reverse, the real
    rows' strips into shared memory, then each dense row written whole, in
    16-byte units where Dh and both pointers allow)."""
    if p6.device.type == "cpu":
        return unpack_phases_reference(p6, L, E, g, S, r)
    from gigapath_tpu_torch.ops import _build

    check_cuda("unpack_phases", p6)
    B, S_, r_, hb, Mp, Dh = p6.shape
    if (S_, r_, r_ * hb * Dh) != (S, r, E):
        raise ValueError(f"unpack_phases: packed shape {tuple(p6.shape)} does not fit S={S}, r={r}, E={E}")
    out = torch.empty((B, L, E), dtype=p6.dtype, device=p6.device)
    with torch.cuda.device(p6.device):
        rc = _build.library("unpack_phases").gp_unpack_phases(
            p6.data_ptr(), out.data_ptr(), p6.element_size(),
            B, L, E, g, S, r, hb, Dh, Mp, cuda_stream(p6),
        )
    raise_on(rc, "unpack_phases")
    LAUNCHES["unpack_phases"] += 1
    return out


def _check_tensor_core_inputs(name: str, Dh: int, *tensors: torch.Tensor) -> None:
    """bf16 tensors go to the branch kernels' tensor-core versions (the
    serial and the pipelined forward, dq and dkv), which take head widths
    that are multiples of 8 and 16-byte aligned tensors (their 16-byte
    copies and stores of 8 elements); fp32 tensors go to the FMA kernels."""
    if tensors[0].dtype == torch.bfloat16 and (Dh % 8 or any(t.data_ptr() % 16 for t in tensors)):
        raise ValueError(f"{name}: bf16 tensors need a head width that is a multiple of 8 and 16-byte "
                         f"aligned tensors (the tensor-core kernel's copies); got Dh={Dh}")


@kernel_wrapper("dilated_branch_fwd", _attention_cost(4, 2, 2, 1))
def dilated_branch_fwd(
    q6: torch.Tensor, k6: torch.Tensor, v6: torch.Tensor, kvlen: torch.Tensor,
    is_causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed branch attention -> ``(out6, lse [B, S, r, hb, Mp] fp32)``
    (``csrc/dilated_branch_fwd.cu``: bf16 on the tensor cores, fp32 on the
    FMA pipes)."""
    if q6.device.type == "cpu":
        return dilated_branch_fwd_reference(q6, k6, v6, kvlen, is_causal)
    from gigapath_tpu_torch.ops import _build

    for name, t in (("q6", q6), ("k6", k6), ("v6", v6)):
        check_cuda(f"dilated_branch_fwd {name}", t)
        if t.shape != q6.shape or t.dtype != q6.dtype or t.device != q6.device:
            raise ValueError("dilated_branch_fwd: q6, k6, v6 must share shape, dtype and device")
    check_cuda("dilated_branch_fwd kvlen", kvlen, (torch.int32,))
    B, S, r, hb, Mp, Dh = q6.shape
    if tuple(kvlen.shape) != (B, S, r) or kvlen.device != q6.device:
        raise ValueError(f"dilated_branch_fwd: kvlen must be [B, S, r] = {(B, S, r)} on {q6.device}")
    blocks = B * S * r * hb * (Mp // ROW_TILE)
    if Dh % 4 or Dh > MAX_HEAD_DIM or Mp <= 0 or Mp % ROW_TILE or blocks >= 2**31:
        raise ValueError(
            f"dilated_branch_fwd: needs Dh % 4 == 0, Dh <= {MAX_HEAD_DIM}, Mp a positive multiple "
            f"of {ROW_TILE} and fewer than 2^31 query tiles; got Dh={Dh}, Mp={Mp}, tiles={blocks}"
        )
    _check_tensor_core_inputs("dilated_branch_fwd", Dh, q6, k6, v6)
    out = torch.empty_like(q6)
    lse = torch.empty((B, S, r, hb, Mp), dtype=torch.float32, device=q6.device)
    with torch.cuda.device(q6.device):
        rc = _build.library("dilated_branch_fwd", GP_HEAD_DIM=Dh).gp_dilated_branch_fwd(
            q6.data_ptr(), k6.data_ptr(), v6.data_ptr(), kvlen.data_ptr(),
            out.data_ptr(), lse.data_ptr(), int(q6.dtype == torch.bfloat16),
            B * S * r * hb, hb, Mp, Dh, int(is_causal), Dh**-0.5 * LOG2E,
            cuda_stream(q6),
        )
    raise_on(rc, "dilated_branch_fwd")
    LAUNCHES["dilated_branch_fwd"] += 1
    return out, lse


def _check_bwd_inputs(name: str, q6, k6, v6, do6, lse5, delta, kvlen) -> None:
    for arg, t in (("q6", q6), ("k6", k6), ("v6", v6), ("do6", do6)):
        check_cuda(f"{name} {arg}", t)
        if t.shape != q6.shape or t.dtype != q6.dtype or t.device != q6.device:
            raise ValueError(f"{name}: q6, k6, v6, do6 must share shape, dtype and device")
    B, S, r, hb, Mp, Dh = q6.shape
    for arg, t in (("lse5", lse5), ("delta", delta)):
        check_cuda(f"{name} {arg}", t, (torch.float32,))
        if tuple(t.shape) != (B, S, r, hb, Mp) or t.device != q6.device:
            raise ValueError(f"{name}: {arg} must be [B, S, r, hb, Mp] = {(B, S, r, hb, Mp)} on {q6.device}")
    check_cuda(f"{name} kvlen", kvlen, (torch.int32,))
    if tuple(kvlen.shape) != (B, S, r) or kvlen.device != q6.device:
        raise ValueError(f"{name}: kvlen must be [B, S, r] = {(B, S, r)} on {q6.device}")
    blocks = B * S * r * hb * (Mp // ROW_TILE)
    if Dh % 4 or Dh > MAX_HEAD_DIM or Mp <= 0 or Mp % ROW_TILE or blocks >= 2**31:
        raise ValueError(
            f"{name}: needs Dh % 4 == 0, Dh <= {MAX_HEAD_DIM}, Mp a positive multiple "
            f"of {ROW_TILE} and fewer than 2^31 row tiles; got Dh={Dh}, Mp={Mp}, tiles={blocks}"
        )


@kernel_wrapper("dilated_branch_bwd_dq", _attention_cost(6, 3, 2, 2))
def dilated_branch_bwd_dq(
    q6: torch.Tensor, k6: torch.Tensor, v6: torch.Tensor, do6: torch.Tensor,
    lse5: torch.Tensor, delta: torch.Tensor, kvlen: torch.Tensor, is_causal: bool = False,
) -> torch.Tensor:
    """Packed dq of the branch attention (``csrc/dilated_branch_bwd_dq.cu``:
    bf16 on the tensor cores, fp32 on the FMA pipes); arguments as
    :func:`dilated_branch_bwd_reference`."""
    if q6.device.type == "cpu":
        return dilated_branch_bwd_reference(q6, k6, v6, do6, lse5, delta, kvlen, is_causal, dkv=False)[0]
    from gigapath_tpu_torch.ops import _build

    _check_bwd_inputs("dilated_branch_bwd_dq", q6, k6, v6, do6, lse5, delta, kvlen)
    B, S, r, hb, Mp, Dh = q6.shape
    dq6 = torch.empty_like(q6)
    _check_tensor_core_inputs("dilated_branch_bwd_dq", Dh, q6, k6, v6, do6, dq6)
    with torch.cuda.device(q6.device):
        rc = _build.library("dilated_branch_bwd_dq", GP_HEAD_DIM=Dh).gp_dilated_branch_bwd_dq(
            q6.data_ptr(), k6.data_ptr(), v6.data_ptr(), do6.data_ptr(), lse5.data_ptr(),
            delta.data_ptr(), kvlen.data_ptr(), dq6.data_ptr(), int(q6.dtype == torch.bfloat16),
            B * S * r * hb, hb, Mp, Dh, int(is_causal), Dh**-0.5 * LOG2E, Dh**-0.5,
            cuda_stream(q6),
        )
    raise_on(rc, "dilated_branch_bwd_dq")
    LAUNCHES["dilated_branch_bwd_dq"] += 1
    return dq6


@kernel_wrapper("dilated_branch_bwd_dkv", _attention_cost(8, 2, 4, 2))
def dilated_branch_bwd_dkv(
    q6: torch.Tensor, k6: torch.Tensor, v6: torch.Tensor, do6: torch.Tensor,
    lse5: torch.Tensor, delta: torch.Tensor, kvlen: torch.Tensor, is_causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed ``(dk, dv)`` of the branch attention
    (``csrc/dilated_branch_bwd_dkv.cu``: bf16 on the tensor cores, fp32 on
    the FMA pipes); arguments as :func:`dilated_branch_bwd_reference`."""
    if q6.device.type == "cpu":
        return dilated_branch_bwd_reference(q6, k6, v6, do6, lse5, delta, kvlen, is_causal, dq=False)[1:]
    from gigapath_tpu_torch.ops import _build

    _check_bwd_inputs("dilated_branch_bwd_dkv", q6, k6, v6, do6, lse5, delta, kvlen)
    B, S, r, hb, Mp, Dh = q6.shape
    dk6, dv6 = torch.empty_like(k6), torch.empty_like(v6)
    _check_tensor_core_inputs("dilated_branch_bwd_dkv", Dh, q6, k6, v6, do6, dk6, dv6)
    with torch.cuda.device(q6.device):
        rc = _build.library("dilated_branch_bwd_dkv", GP_HEAD_DIM=Dh).gp_dilated_branch_bwd_dkv(
            q6.data_ptr(), k6.data_ptr(), v6.data_ptr(), do6.data_ptr(), lse5.data_ptr(),
            delta.data_ptr(), kvlen.data_ptr(), dk6.data_ptr(), dv6.data_ptr(),
            int(q6.dtype == torch.bfloat16), B * S * r * hb, hb, Mp, Dh, int(is_causal),
            Dh**-0.5 * LOG2E, Dh**-0.5, cuda_stream(q6),
        )
    raise_on(rc, "dilated_branch_bwd_dkv")
    LAUNCHES["dilated_branch_bwd_dkv"] += 1
    return dk6, dv6


def _check_pipe(name: str, is_causal: bool, *tensors: torch.Tensor) -> None:
    """The pipelined kernels take non-causal calls and 16-byte aligned
    tensors (their ring's ``cp.async`` copies)."""
    if is_causal:
        raise ValueError(f"{name}: the pipelined kernels are non-causal only (a causal call runs the serial kernels)")
    for t in tensors:
        if t.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned for the cp.async ring")


@kernel_wrapper("dilated_branch_fwd_pipe", _attention_cost(4, 2, 2, 1))
def dilated_branch_fwd_pipe(
    q6: torch.Tensor, k6: torch.Tensor, v6: torch.Tensor, kvlen: torch.Tensor,
    is_causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pipelined packed branch attention -> ``(out6, lse [B, S, r, hb, Mp]
    fp32)`` (``csrc/dilated_branch_fwd_pipe.cu``: bf16 on the tensor cores,
    fp32 on the FMA pipes); arguments as :func:`dilated_branch_fwd`,
    non-causal only."""
    _check_pipe("dilated_branch_fwd_pipe", is_causal, q6, k6, v6)
    if q6.device.type == "cpu":
        return dilated_branch_fwd_pipe_reference(q6, k6, v6, kvlen)
    from gigapath_tpu_torch.ops import _build

    for name, t in (("q6", q6), ("k6", k6), ("v6", v6)):
        check_cuda(f"dilated_branch_fwd_pipe {name}", t)
        if t.shape != q6.shape or t.dtype != q6.dtype or t.device != q6.device:
            raise ValueError("dilated_branch_fwd_pipe: q6, k6, v6 must share shape, dtype and device")
    check_cuda("dilated_branch_fwd_pipe kvlen", kvlen, (torch.int32,))
    B, S, r, hb, Mp, Dh = q6.shape
    if tuple(kvlen.shape) != (B, S, r) or kvlen.device != q6.device:
        raise ValueError(f"dilated_branch_fwd_pipe: kvlen must be [B, S, r] = {(B, S, r)} on {q6.device}")
    blocks = B * S * r * hb * (Mp // ROW_TILE)
    if Dh % 4 or Dh > MAX_HEAD_DIM or Mp <= 0 or Mp % ROW_TILE or blocks >= 2**31:
        raise ValueError(
            f"dilated_branch_fwd_pipe: needs Dh % 4 == 0, Dh <= {MAX_HEAD_DIM}, Mp a positive multiple "
            f"of {ROW_TILE} and fewer than 2^31 query tiles; got Dh={Dh}, Mp={Mp}, tiles={blocks}"
        )
    _check_tensor_core_inputs("dilated_branch_fwd_pipe", Dh, q6, k6, v6)
    out = torch.empty_like(q6)
    lse = torch.empty((B, S, r, hb, Mp), dtype=torch.float32, device=q6.device)
    with torch.cuda.device(q6.device):
        rc = _build.library("dilated_branch_fwd_pipe", GP_HEAD_DIM=Dh).gp_dilated_branch_fwd_pipe(
            q6.data_ptr(), k6.data_ptr(), v6.data_ptr(), kvlen.data_ptr(),
            out.data_ptr(), lse.data_ptr(), int(q6.dtype == torch.bfloat16),
            B * S * r * hb, hb, Mp, Dh, Dh**-0.5 * LOG2E, cuda_stream(q6),
        )
    raise_on(rc, "dilated_branch_fwd_pipe")
    LAUNCHES["dilated_branch_fwd_pipe"] += 1
    return out, lse


@kernel_wrapper("dilated_branch_bwd_dq_pipe", _attention_cost(6, 3, 2, 2))
def dilated_branch_bwd_dq_pipe(
    q6: torch.Tensor, k6: torch.Tensor, v6: torch.Tensor, do6: torch.Tensor,
    lse5: torch.Tensor, delta: torch.Tensor, kvlen: torch.Tensor, is_causal: bool = False,
) -> torch.Tensor:
    """Pipelined packed dq of the branch attention
    (``csrc/dilated_branch_bwd_dq_pipe.cu``: bf16 on the tensor cores, fp32
    on the FMA pipes); arguments as
    :func:`dilated_branch_bwd_pipe_reference`, non-causal only."""
    _check_pipe("dilated_branch_bwd_dq_pipe", is_causal, k6, v6)
    if q6.device.type == "cpu":
        return dilated_branch_bwd_pipe_reference(q6, k6, v6, do6, lse5, delta, kvlen, dkv=False)[0]
    from gigapath_tpu_torch.ops import _build

    _check_bwd_inputs("dilated_branch_bwd_dq_pipe", q6, k6, v6, do6, lse5, delta, kvlen)
    B, S, r, hb, Mp, Dh = q6.shape
    dq6 = torch.empty_like(q6)
    _check_tensor_core_inputs("dilated_branch_bwd_dq_pipe", Dh, q6, k6, v6, do6, dq6)
    with torch.cuda.device(q6.device):
        rc = _build.library("dilated_branch_bwd_dq_pipe", GP_HEAD_DIM=Dh).gp_dilated_branch_bwd_dq_pipe(
            q6.data_ptr(), k6.data_ptr(), v6.data_ptr(), do6.data_ptr(), lse5.data_ptr(),
            delta.data_ptr(), kvlen.data_ptr(), dq6.data_ptr(), int(q6.dtype == torch.bfloat16),
            B * S * r * hb, hb, Mp, Dh, Dh**-0.5 * LOG2E, Dh**-0.5, cuda_stream(q6),
        )
    raise_on(rc, "dilated_branch_bwd_dq_pipe")
    LAUNCHES["dilated_branch_bwd_dq_pipe"] += 1
    return dq6


@kernel_wrapper("dilated_branch_bwd_dkv_pipe", _attention_cost(8, 2, 4, 2))
def dilated_branch_bwd_dkv_pipe(
    q6: torch.Tensor, k6: torch.Tensor, v6: torch.Tensor, do6: torch.Tensor,
    lse5: torch.Tensor, delta: torch.Tensor, kvlen: torch.Tensor, is_causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pipelined packed ``(dk, dv)`` of the branch attention
    (``csrc/dilated_branch_bwd_dkv_pipe.cu``: bf16 on the tensor cores,
    fp32 on the FMA pipes); arguments as
    :func:`dilated_branch_bwd_pipe_reference`, non-causal only."""
    _check_pipe("dilated_branch_bwd_dkv_pipe", is_causal, q6, do6, lse5, delta)
    if q6.device.type == "cpu":
        return dilated_branch_bwd_pipe_reference(q6, k6, v6, do6, lse5, delta, kvlen, dq=False)[1:]
    from gigapath_tpu_torch.ops import _build

    _check_bwd_inputs("dilated_branch_bwd_dkv_pipe", q6, k6, v6, do6, lse5, delta, kvlen)
    B, S, r, hb, Mp, Dh = q6.shape
    dk6, dv6 = torch.empty_like(k6), torch.empty_like(v6)
    _check_tensor_core_inputs("dilated_branch_bwd_dkv_pipe", Dh, q6, k6, v6, do6, dk6, dv6)
    with torch.cuda.device(q6.device):
        rc = _build.library("dilated_branch_bwd_dkv_pipe", GP_HEAD_DIM=Dh).gp_dilated_branch_bwd_dkv_pipe(
            q6.data_ptr(), k6.data_ptr(), v6.data_ptr(), do6.data_ptr(), lse5.data_ptr(),
            delta.data_ptr(), kvlen.data_ptr(), dk6.data_ptr(), dv6.data_ptr(),
            int(q6.dtype == torch.bfloat16), B * S * r * hb, hb, Mp, Dh,
            Dh**-0.5 * LOG2E, Dh**-0.5, cuda_stream(q6),
        )
    raise_on(rc, "dilated_branch_bwd_dkv_pipe")
    LAUNCHES["dilated_branch_bwd_dkv_pipe"] += 1
    return dk6, dv6


@kernel_wrapper("pack_phases_direct", _pack_direct_cost)
def pack_phases_direct(
    xs: Sequence[torch.Tensor], g: int, S: int, r: int, Mp: int, num_heads: int
) -> Tuple[torch.Tensor, ...]:
    """Single-segment dense [B, L, E] tensors (1 to
    :data:`PACK_DIRECT_MAX_TENSORS` of one shape and dtype: a branch's q, k
    and v) -> each packed [B, 1, r, hb, Mp, Dh], in order, in one launch
    (``csrc/pack_phases_direct.cu``: each 16-byte unit copied straight to
    its packed place, no shared memory)."""
    if isinstance(xs, torch.Tensor):
        raise TypeError("pack_phases_direct: takes a sequence of tensors, e.g. (q, k, v) or (x,)")
    xs = tuple(xs)
    if not 1 <= len(xs) <= PACK_DIRECT_MAX_TENSORS:
        raise ValueError(f"pack_phases_direct: takes 1 to {PACK_DIRECT_MAX_TENSORS} tensors; got {len(xs)}")
    if xs[0].device.type == "cpu":
        return tuple(pack_phases_direct_reference(x, g, S, r, Mp, num_heads) for x in xs)
    from gigapath_tpu_torch.ops import _build

    for i, x in enumerate(xs):
        check_cuda(f"pack_phases_direct xs[{i}]", x)
        if x.shape != xs[0].shape or x.dtype != xs[0].dtype or x.device != xs[0].device:
            raise ValueError("pack_phases_direct: the tensors of one call must share shape, dtype and device")
    B, L, E = xs[0].shape
    _check_direct("pack_phases_direct", L, g, S, r)
    hb, Dh = num_heads // r, E // num_heads
    outs = tuple(torch.empty((B, 1, r, hb, Mp, Dh), dtype=x.dtype, device=x.device) for x in xs)
    n = len(xs)
    with torch.cuda.device(xs[0].device):
        rc = _build.library("pack_phases_direct").gp_pack_phases_direct(
            (ctypes.c_longlong * n)(*(x.data_ptr() for x in xs)),
            (ctypes.c_longlong * n)(*(o.data_ptr() for o in outs)),
            n, xs[0].element_size(), B, L, E, r, hb, Dh, Mp, cuda_stream(xs[0]),
        )
    raise_on(rc, "pack_phases_direct")
    LAUNCHES["pack_phases_direct"] += 1
    return outs


@kernel_wrapper("unpack_phases_direct", _unpack_cost)
def unpack_phases_direct(p6: torch.Tensor, L: int, E: int, g: int, S: int, r: int) -> torch.Tensor:
    """Packed [B, 1, r, hb, Mp, Dh] -> dense [B, L, E], off-band lanes exact
    0, through shared-memory row-blocks (``csrc/unpack_phases_direct.cu``)."""
    if p6.device.type == "cpu":
        return unpack_phases_direct_reference(p6, L, E, g, S, r)
    from gigapath_tpu_torch.ops import _build

    check_cuda("unpack_phases_direct", p6)
    _check_direct("unpack_phases_direct", L, g, S, r)
    B, S_, r_, hb, Mp, Dh = p6.shape
    if (S_, r_, r_ * hb * Dh) != (1, r, E) or Mp * r < L:
        raise ValueError(f"unpack_phases_direct: packed shape {tuple(p6.shape)} does not fit L={L}, r={r}, E={E}")
    out = torch.empty((B, L, E), dtype=p6.dtype, device=p6.device)
    with torch.cuda.device(p6.device):
        rc = _build.library("unpack_phases_direct").gp_unpack_phases_direct(
            p6.data_ptr(), out.data_ptr(), p6.element_size(), B, L, E, r, hb, Dh, Mp, cuda_stream(p6),
        )
    raise_on(rc, "unpack_phases_direct")
    LAUNCHES["unpack_phases_direct"] += 1
    return out


@kernel_wrapper("fusion_epilogue_fwd", _epilogue_fwd_cost)
def fusion_epilogue_fwd(
    outs: Sequence[torch.Tensor], lses: Sequence[torch.Tensor], plan: "EpiloguePlan"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every branch's packed ``(out6, lse5)`` -> ``(out [B, L, E], fused_lse
    [B, L, H] fp32)`` in one launch (``csrc/fusion_epilogue_fwd.cu``);
    arguments as :func:`fusion_epilogue_fwd_reference`."""
    if outs[0].device.type == "cpu":
        return fusion_epilogue_fwd_reference(outs, lses, plan)
    from gigapath_tpu_torch.ops import _build

    L, E, H = plan.L, plan.E, plan.H
    Dh, n = E // H, len(plan.branches)
    B, dtype, dev = outs[0].shape[0], outs[0].dtype, outs[0].device
    if not 1 <= n <= MAX_FUSED_BRANCHES or len(outs) != n or len(lses) != n or Dh % 4:
        raise ValueError(f"fusion_epilogue_fwd: needs 1..{MAX_FUSED_BRANCHES} branches and Dh % 4 == 0; "
                         f"got {len(outs)} outs, {len(lses)} lses, {n} planned, Dh={Dh}")
    for i, (o6, l5, (g, S, r, m, Mp)) in enumerate(zip(outs, lses, plan.branches)):
        check_cuda(f"fusion_epilogue_fwd out6[{i}]", o6)
        check_cuda(f"fusion_epilogue_fwd lse5[{i}]", l5, (torch.float32,))
        if (o6.shape != (B, S, r, H // r, Mp, Dh) or l5.shape != (B, S, r, H // r, Mp)
                or o6.dtype != dtype or o6.device != dev or l5.device != dev):
            raise ValueError(f"fusion_epilogue_fwd: branch {i} tensors {tuple(o6.shape)}, {tuple(l5.shape)} "
                             f"do not fit (B, S, r, hb, Mp, Dh) = {(B, S, r, H // r, Mp, Dh)} in {dtype}")
    out = torch.empty((B, L, E), dtype=dtype, device=dev)
    fused = torch.empty((B, L, H), dtype=torch.float32, device=dev)
    out_ptrs = (ctypes.c_longlong * n)(*(o6.data_ptr() for o6 in outs))
    lse_ptrs = (ctypes.c_longlong * n)(*(l5.data_ptr() for l5 in lses))
    geo = (ctypes.c_int * (4 * n))(*(v for g, S, r, _, Mp in plan.branches for v in (g, S, r, Mp)))
    with torch.cuda.device(dev):
        rc = _build.library("fusion_epilogue_fwd").gp_fusion_epilogue_fwd(
            out_ptrs, lse_ptrs, geo, n, out.data_ptr(), fused.data_ptr(),
            int(dtype == torch.bfloat16), B, L, H, Dh, cuda_stream(out),
        )
    raise_on(rc, "fusion_epilogue_fwd")
    LAUNCHES["fusion_epilogue_fwd"] += 1
    return out, fused


@kernel_wrapper("fusion_epilogue_bwd", _epilogue_bwd_cost)
def fusion_epilogue_bwd(
    dy: torch.Tensor, fused_lse: torch.Tensor, lses: Sequence[torch.Tensor], plan: "EpiloguePlan"
) -> list:
    """Every branch's packed output cotangent in one launch
    (``csrc/fusion_epilogue_bwd.cu``); arguments as
    :func:`fusion_epilogue_bwd_reference`."""
    if dy.device.type == "cpu":
        return fusion_epilogue_bwd_reference(dy, fused_lse, lses, plan)
    from gigapath_tpu_torch.ops import _build

    B, L, E = dy.shape
    H, n = plan.H, len(plan.branches)
    Dh = E // H
    check_cuda("fusion_epilogue_bwd dy", dy)
    check_cuda("fusion_epilogue_bwd fused_lse", fused_lse, (torch.float32,))
    if not 1 <= n <= MAX_FUSED_BRANCHES or len(lses) != n or Dh % 4:
        raise ValueError(f"fusion_epilogue_bwd: needs 1..{MAX_FUSED_BRANCHES} branches and Dh % 4 == 0; "
                         f"got {len(lses)} lses, {n} planned, Dh={Dh}")
    if (L, E) != (plan.L, plan.E) or fused_lse.shape != (B, L, H) or fused_lse.device != dy.device:
        raise ValueError(f"fusion_epilogue_bwd: dy {tuple(dy.shape)}, fused_lse {tuple(fused_lse.shape)} do not "
                         f"fit L={plan.L}, E={plan.E}, H={H}")
    for i, (l5, (g, S, r, m, Mp)) in enumerate(zip(lses, plan.branches)):
        check_cuda(f"fusion_epilogue_bwd lse5[{i}]", l5, (torch.float32,))
        if l5.shape != (B, S, r, H // r, Mp) or l5.device != dy.device:
            raise ValueError(f"fusion_epilogue_bwd: branch {i} lse5 {tuple(l5.shape)} does not fit "
                             f"(B, S, r, hb, Mp) = {(B, S, r, H // r, Mp)}")
    d6s = [torch.empty((B, S, r, H // r, Mp, Dh), dtype=dy.dtype, device=dy.device)
           for g, S, r, m, Mp in plan.branches]
    d6_ptrs = (ctypes.c_longlong * n)(*(d6.data_ptr() for d6 in d6s))
    lse_ptrs = (ctypes.c_longlong * n)(*(l5.data_ptr() for l5 in lses))
    geo = (ctypes.c_int * (4 * n))(*(v for g, S, r, _, Mp in plan.branches for v in (g, S, r, Mp)))
    with torch.cuda.device(dy.device):
        rc = _build.library("fusion_epilogue_bwd").gp_fusion_epilogue_bwd(
            d6_ptrs, lse_ptrs, geo, n, dy.data_ptr(), fused_lse.data_ptr(),
            int(dy.dtype == torch.bfloat16), B, L, H, Dh, cuda_stream(dy),
        )
    raise_on(rc, "fusion_epilogue_bwd")
    LAUNCHES["fusion_epilogue_bwd"] += 1
    return d6s


# ---------------------------------------------------------------------------
# the branch ops
# ---------------------------------------------------------------------------


def _pack(xs, g, S, r, Mp, num_heads, pack_direct: bool) -> Tuple[torch.Tensor, ...]:
    """The dense tensors ``xs`` packed: by row 4's direct pack, all in one
    launch, where the JAX package takes it (one segment, ``r > 1``,
    ``pack_direct``; it packs them one call each), else by row 2's pack,
    one launch each."""
    if pack_direct and S == 1 and r > 1:
        return pack_phases_direct(xs, g, S, r, Mp, num_heads)
    return tuple(pack_phases(x, g, S, r, Mp, num_heads) for x in xs)


def _unpack(p6, L, E, g, S, r, pack_direct: bool) -> torch.Tensor:
    """Row 5's direct unpack where :func:`_pack` takes row 4, else row 3's."""
    if pack_direct and S == 1 and r > 1:
        return unpack_phases_direct(p6, L, E, g, S, r)
    return unpack_phases(p6, L, E, g, S, r)


def _branch_packed_fwd(q, k, v, kvlen, geometry, num_heads, is_causal, pack_direct, pipe_fwd):
    """Dense q/k/v -> the branch's packed ``(out6, lse5)``; the counterpart
    of ``_branch_packed_fwd_impl``: row 6's pipelined kernel when
    ``pipe_fwd`` and not causal, else row 1's."""
    L, E, g, S, r, m, Mp = geometry
    q6, k6, v6 = _pack((q, k, v), g, S, r, Mp, num_heads, pack_direct)
    if pipe_fwd and not is_causal:
        return dilated_branch_fwd_pipe(q6, k6, v6, kvlen)
    return dilated_branch_fwd(q6, k6, v6, kvlen, is_causal)


def _branch_bwd(q, k, v, kvlen, do6, out6, lse5, geometry, num_heads, is_causal, pack_direct, pipe_bwd):
    """The packed output cotangent ``do6`` (and the forward's packed
    results) -> dense ``(dq, dk, dv)``; the counterpart of
    ``_branch_bwd_core``: row 8's pipelined kernels when ``pipe_bwd`` and
    not causal, else row 7's. Off-band lanes come back exact 0: the branch
    never reads them."""
    L, E, g, S, r, m, Mp = geometry
    q6, k6, v6 = _pack((q, k, v), g, S, r, Mp, num_heads, pack_direct)
    # delta = rowsum(do * out) per (token, head), in the lse layout
    delta = (do6.float() * out6.float()).sum(dim=-1)
    if pipe_bwd and not is_causal:
        dq6 = dilated_branch_bwd_dq_pipe(q6, k6, v6, do6, lse5, delta, kvlen)
        dk6, dv6 = dilated_branch_bwd_dkv_pipe(q6, k6, v6, do6, lse5, delta, kvlen)
    else:
        dq6 = dilated_branch_bwd_dq(q6, k6, v6, do6, lse5, delta, kvlen, is_causal)
        dk6, dv6 = dilated_branch_bwd_dkv(q6, k6, v6, do6, lse5, delta, kvlen, is_causal)
    return [_unpack(x6, L, E, g, S, r, pack_direct) for x6 in (dq6, dk6, dv6)]


class _DilatedBranch(torch.autograd.Function):
    """Dense q/k/v [B, L, E] -> ``(out [B, L, E], lse [B, H, L])`` of one
    branch; the counterpart of ``_dilated_branch``'s custom VJP.

    It saves the dense q/k/v (one copy shared by every branch of a layer)
    and this branch's packed ``out6``/``lse5``, never the packed q6/k6/v6:
    the backward re-packs them. The lse output takes no gradient. Both
    passes run with autocast off: the kernels (and their plain versions)
    compute in fp32 from the inputs' dtype. ``pack_direct`` and
    ``pipe_bwd`` are the forward's flags, kept on ``ctx`` for the
    backward, which never reads the flags afresh."""

    @staticmethod
    def forward(ctx, q, k, v, kvlen, geometry, num_heads, is_causal, pack_direct, pipe_fwd, pipe_bwd):
        L, E, g, S, r, m, Mp = geometry
        with torch.autocast(q.device.type, enabled=False):
            out6, lse5 = _branch_packed_fwd(q, k, v, kvlen, geometry, num_heads, is_causal, pack_direct, pipe_fwd)
            out = _unpack(out6, L, E, g, S, r, pack_direct)
            lse = _scatter_lse(lse5, L, num_heads, g, r, m)
        ctx.save_for_backward(q, k, v, kvlen, out6, lse5)
        ctx.geometry, ctx.num_heads, ctx.is_causal = geometry, num_heads, is_causal
        ctx.pack_direct, ctx.pipe_bwd = pack_direct, pipe_bwd
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):  # no gradient flows through the lse output
        q, k, v, kvlen, out6, lse5 = ctx.saved_tensors
        L, E, g, S, r, m, Mp = ctx.geometry
        with torch.autocast(q.device.type, enabled=False):
            (do6,) = _pack((dout.to(q.dtype).contiguous(),), g, S, r, Mp, ctx.num_heads, ctx.pack_direct)
            grads = _branch_bwd(q, k, v, kvlen, do6, out6, lse5, ctx.geometry, ctx.num_heads,
                                ctx.is_causal, ctx.pack_direct, ctx.pipe_bwd)
        return (*grads, None, None, None, None, None, None, None)


class _DilatedBranchPacked(torch.autograd.Function):
    """Dense q/k/v [B, L, E] -> the branch's packed ``(out6, lse5)``; the
    counterpart of ``_dilated_branch_packed``'s custom VJP. Its backward
    takes the output cotangent already packed (the fusion epilogue's
    backward writes it so) and skips the pack of ``do``. Saves and runs as
    :class:`_DilatedBranch`."""

    @staticmethod
    def forward(ctx, q, k, v, kvlen, geometry, num_heads, is_causal, pack_direct, pipe_fwd, pipe_bwd):
        with torch.autocast(q.device.type, enabled=False):
            out6, lse5 = _branch_packed_fwd(q, k, v, kvlen, geometry, num_heads, is_causal, pack_direct, pipe_fwd)
        ctx.save_for_backward(q, k, v, kvlen, out6, lse5)
        ctx.geometry, ctx.num_heads, ctx.is_causal = geometry, num_heads, is_causal
        ctx.pack_direct, ctx.pipe_bwd = pack_direct, pipe_bwd
        ctx.mark_non_differentiable(lse5)
        return out6, lse5

    @staticmethod
    def backward(ctx, do6, _dlse5):  # no gradient flows through the lse output
        q, k, v, kvlen, out6, lse5 = ctx.saved_tensors
        with torch.autocast(q.device.type, enabled=False):
            grads = _branch_bwd(q, k, v, kvlen, do6.to(q.dtype).contiguous(), out6, lse5, ctx.geometry,
                                ctx.num_heads, ctx.is_causal, ctx.pack_direct, ctx.pipe_bwd)
        return (*grads, None, None, None, None, None, None, None)


def _branch_args(q, k, v, sl, r, num_heads, real_len, valid_len_dyn, flags):
    """(geometry, kvlen, (pack_direct, pipe_fwd, pipe_bwd)) of one branch
    call: the flags resolved through the plan seam when the caller holds
    none, read once here for both passes."""
    B, L, E = q.shape
    if E % num_heads or num_heads % r:
        raise ValueError(f"dilated branch: needs E % H == 0 and H % r == 0; got E={E}, H={num_heads}, r={r}")
    if flags is None:
        from gigapath_tpu_torch.plan import resolve_plan

        flags = resolve_plan("dilated_branch", (q, k, v))
    rl = L if real_len is None else min(int(real_len), L)
    g, S, m, Mp = _branch_geometry(L, int(sl), int(r))
    kvlen = _branch_kvlen(B, S, g, int(r), m, rl, valid_len_dyn, q.device)
    return (L, E, g, S, int(r), m, Mp), kvlen, (bool(flags.pack_direct), *_branch_pipelined(flags, sl, r))


def dilated_branch_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    sl: int,
    r: int,
    num_heads: int,
    *,
    real_len: Optional[int] = None,
    valid_len_dyn: Optional[torch.Tensor] = None,
    is_causal: bool = False,
    flags: Optional[PipelineFlags] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One dilated-attention branch on dense [B, L, E] activations.

    Returns ``(out [B, L, E], lse [B, H, L])``: lanes and (token, head)
    pairs the branch does not cover hold 0 / NEG_INF, ready for the
    cross-branch LSE-softmax fusion. Keys at positions ``>= real_len``
    (static) or ``>= valid_len_dyn[b]`` (per batch row) are masked.
    Differentiable in q, k and v; the lse output takes no gradient.
    Requires ``num_heads % r == 0``. ``flags`` pins the dispatch (None:
    resolved once through the plan seam): the pack kernels, and the
    pipelined kernels where :func:`_branch_pipelined` takes them.
    """
    geometry, kvlen, dispatch = _branch_args(q, k, v, sl, r, num_heads, real_len, valid_len_dyn, flags)
    return _DilatedBranch.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), kvlen, geometry, num_heads, is_causal, *dispatch,
    )


def dilated_branch_attention_packed(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    sl: int,
    r: int,
    num_heads: int,
    *,
    real_len: Optional[int] = None,
    valid_len_dyn: Optional[torch.Tensor] = None,
    is_causal: bool = False,
    flags: Optional[PipelineFlags] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One dilated branch returning its packed results ``(out6 [B, S, r,
    hb, Mp, Dh], lse5 [B, S, r, hb, Mp] fp32)``, the fusion epilogue's
    input; arguments as :func:`dilated_branch_attention`."""
    geometry, kvlen, dispatch = _branch_args(q, k, v, sl, r, num_heads, real_len, valid_len_dyn, flags)
    return _DilatedBranchPacked.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), kvlen, geometry, num_heads, is_causal, *dispatch,
    )


# ---------------------------------------------------------------------------
# the stream-fusion epilogue
# ---------------------------------------------------------------------------


class EpiloguePlan(NamedTuple):
    """Static geometry of one fusion epilogue: ``branches`` holds each
    branch's ``(g, S, r, m, Mp)`` in the port's packed layout."""

    L: int
    E: int
    H: int
    branches: Tuple[Tuple[int, int, int, int, int], ...]


def plan_stream_fusion(
    L: int, E: int, H: int, segment_lengths: Sequence[int], dilated_ratios: Sequence[int]
) -> Optional[EpiloguePlan]:
    """The epilogue's plan, or None where it does not apply: one branch
    (nothing to fuse), more than :data:`MAX_FUSED_BRANCHES`, or a ratio that
    does not divide H and E. The JAX package also refuses schedules whose
    branches cannot share a TPU block alignment and splits the rest into
    alignment classes chained through HBM; the kernel here reads any
    branch at any token, so it has neither, and where the JAX package
    falls back to the dense fusion the results are equal."""
    n = len(segment_lengths)
    if n < 2 or n > MAX_FUSED_BRANCHES or len(dilated_ratios) != n:
        return None
    branches = []
    for sl, r in zip(segment_lengths, dilated_ratios):
        sl, r = int(sl), int(r)
        if H % r or E % r:
            return None
        g, S, m, Mp = _branch_geometry(L, sl, r)
        branches.append((g, S, r, m, Mp))
    return EpiloguePlan(L=L, E=E, H=H, branches=tuple(branches))


class _FusionEpilogue(torch.autograd.Function):
    """Packed ``(out6, lse5)`` of every branch -> the fused [B, L, E]; the
    counterpart of ``_fusion_epilogue``'s custom VJP. It saves only the
    branches' lse tables (the branch ops hold them already) and the
    compact ``fused_lse [B, L, H]``. The fusion weights are constants in the
    backward, so no cotangent reaches the lse tables. Autocast is off: the
    kernel reads the packed results in their dtype and writes ``out`` in
    it."""

    @staticmethod
    def forward(ctx, plan, *packed):
        outs, lses = packed[0::2], packed[1::2]
        with torch.autocast(outs[0].device.type, enabled=False):
            out, fused = fusion_epilogue_fwd(outs, lses, plan)
        ctx.save_for_backward(fused, *lses)
        ctx.plan = plan
        return out

    @staticmethod
    def backward(ctx, dy):
        fused, *lses = ctx.saved_tensors
        with torch.autocast(dy.device.type, enabled=False):
            d6s = fusion_epilogue_bwd(dy.contiguous(), fused, lses, ctx.plan)
        return (None, *(x for d6 in d6s for x in (d6, None)))


def dilated_attention_stream_fused(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_lengths: Sequence[int],
    dilated_ratios: Sequence[int],
    num_heads: int,
    *,
    real_len: Optional[int] = None,
    valid_len_dyn: Optional[torch.Tensor] = None,
    is_causal: bool = False,
    flags: Optional[PipelineFlags] = None,
) -> torch.Tensor:
    """Multi-branch dilated attention on dense [B, L, E] through the fusion
    epilogue: every branch runs :func:`dilated_branch_attention_packed` and
    the packed results go straight into :class:`_FusionEpilogue`, so no
    dense per-branch out/lse exists, forward or backward. Needs a schedule
    :func:`plan_stream_fusion` accepts. ``flags`` as
    :func:`dilated_branch_attention` (None: resolved once here)."""
    B, L, E = q.shape
    if flags is None:
        from gigapath_tpu_torch.plan import resolve_plan

        flags = resolve_plan("dilated_stream", (q, k, v))
    plan = plan_stream_fusion(L, E, num_heads, segment_lengths, dilated_ratios)
    if plan is None:
        raise ValueError(f"dilated_attention_stream_fused: schedule {list(segment_lengths)}/"
                         f"{list(dilated_ratios)} at L={L}, E={E}, H={num_heads} has no epilogue plan")
    packed = []
    for sl, r in zip(segment_lengths, dilated_ratios):
        packed += dilated_branch_attention_packed(
            q, k, v, int(sl), int(r), num_heads, real_len=real_len,
            valid_len_dyn=valid_len_dyn, is_causal=is_causal, flags=flags,
        )
    return _FusionEpilogue.apply(plan, *packed)
