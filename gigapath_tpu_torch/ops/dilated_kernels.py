"""Phase-major dilated-branch kernels (counterpart of
``gigapath_tpu/ops/pallas_dilated.py``).

One dilated branch ``(segment length sl, ratio r)`` on dense ``[B, L, E]``
activations runs three CUDA kernels (``csrc/``) forward:

1. :func:`pack_phases` packs q, k and v into the diagonal-only phase-major
   layout ``[B, S, r, hb, Mp, Dh]``: head band ``p`` (heads ``p*hb ..
   (p+1)*hb - 1``, ``hb = H/r``) of segment ``s`` holds the phase-``p``
   tokens ``s*g + p + r*j``, 1/r of the dense volume.
2. :func:`dilated_branch_fwd` attends each (segment, phase, head) cell
   with a fp32 online softmax, masking keys at or past the ``[B, S, r]``
   valid-count table, and returns ``(out6, lse [B, S, r, hb, Mp])``.
3. :func:`unpack_phases` writes ``out6`` back to dense ``[B, L, E]`` with
   exact zeros on the lanes the branch does not cover.

and, backward, two more: :func:`dilated_branch_bwd_dq` and
:func:`dilated_branch_bwd_dkv` recompute the probabilities from the saved
lse and return the packed dq and (dk, dv), between a pack of the output
cotangent and q/k/v and an unpack of the three gradients.

Each wrapper runs its ``*_reference`` plain PyTorch version when its tensor
lies on the CPU, launches its kernel on a CUDA tensor (or raises), and
counts its launches in :data:`LAUNCHES`. :func:`dilated_branch_attention`
is the differentiable branch op (the counterpart of ``_dilated_branch``'s
custom VJP): it strings the kernels together with the lse scatter and keeps
the JAX op's contract: off-band lanes are exact 0, uncovered (token, head)
pairs have lse = -1e30, and no gradient flows through the lse output.

The port's packed row count ``Mp`` is ``m`` rounded up to the kernel's
64-row tile; the TPU's VMEM caps and 128-lane quantum do not apply.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gigapath_tpu_torch.ops.common import check_cuda, cuda_stream, raise_on, round_up

NEG_INF = -1e30  # lse of a (token, head) pair the branch does not cover
M_FLOOR = -1e20  # running-max floor: masked keys underflow to exactly 0
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
ROW_TILE = 64  # query/key rows per tile of the branch kernel
MAX_HEAD_DIM = 128  # the branch kernel takes head widths that are multiples of 4 up to this

# Launches of each CUDA kernel in this process. A wrapper adds one where it
# launches its kernel and nowhere else; callers reset and read it.
LAUNCHES = {
    "pack_phases": 0, "dilated_branch_fwd": 0, "unpack_phases": 0,
    "dilated_branch_bwd_dq": 0, "dilated_branch_bwd_dkv": 0,
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
    valid_dyn: torch.Tensor, g: int, r: int, m: int, phases: torch.Tensor, n_seg: int
) -> torch.Tensor:
    """[B, len(phases), n_seg] valid sparse-key counts from per-batch valid
    lengths ``valid_dyn`` [B]: slot j of phase p is valid iff dense position
    ``seg*g + p + r*j`` lies inside both the segment and the valid prefix."""
    seg = torch.arange(n_seg, device=valid_dyn.device)
    in_seg = (valid_dyn.reshape(-1, 1).to(torch.int64) - seg[None] * g).clamp(0, g)
    num = in_seg[:, None, :] - phases.to(torch.int64)[None, :, None]
    counts = -torch.div(-num, r, rounding_mode="floor")  # exact integer ceil
    return counts.clamp(0, m).to(torch.int32)


def _branch_kvlen(
    B: int, S: int, g: int, r: int, m: int, real_len: int,
    vl_dyn: Optional[torch.Tensor], device: torch.device,
) -> torch.Tensor:
    """[B, S, r] int32 valid sparse-key counts: the static table from
    ``real_len`` combined by minimum with the optional per-batch valid
    lengths ``vl_dyn``."""
    static = torch.from_numpy(_phase_kvlen(S, g, r, m, real_len)).to(device)
    static = static[None].expand(B, S, r)
    if vl_dyn is None:
        return static.contiguous()
    counts = dyn_sparse_counts(vl_dyn, g, r, m, torch.arange(r, device=device), S)
    return torch.minimum(static, counts.transpose(1, 2)).contiguous()


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


def dilated_branch_fwd_reference(
    q6: torch.Tensor, k6: torch.Tensor, v6: torch.Tensor, kvlen: torch.Tensor,
    is_causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed q/k/v [B, S, r, hb, Mp, Dh] + kvlen [B, S, r] ->
    ``(out6, lse [B, S, r, hb, Mp] fp32)``, the kernel's math in plain
    PyTorch: fp32 base-2 softmax, masked keys by select, a row with no
    valid key gives out = 0 and lse ~ -6.9e19. Chunked over (s, p, t), so
    the largest temporary is one [B, Mp, Mp] score matrix."""
    B, S, r, hb, Mp, Dh = q6.shape
    qscale = Dh**-0.5 * LOG2E
    out = torch.empty_like(q6)
    lse = torch.empty((B, S, r, hb, Mp), dtype=torch.float32, device=q6.device)
    cols = torch.arange(Mp, device=q6.device)
    causal_mask = cols[None, :] > cols[:, None] if is_causal else None
    for s in range(S):
        for p in range(r):
            key_mask = cols[None, None, :] >= kvlen[:, s, p].to(torch.int64)[:, None, None]
            if causal_mask is not None:
                key_mask = key_mask | causal_mask[None]
            for t in range(hb):
                qf = q6[:, s, p, t].float() * qscale
                sc = qf @ k6[:, s, p, t].float().transpose(1, 2)  # [B, Mp, Mp]
                sc = sc.masked_fill(key_mask, NEG_INF)
                m_row = sc.amax(dim=-1, keepdim=True).clamp_min(M_FLOOR)
                pr = torch.exp2(sc - m_row)
                l_row = pr.sum(dim=-1, keepdim=True).clamp_min(1e-30)
                out[:, s, p, t] = ((pr @ v6[:, s, p, t].float()) / l_row).to(q6.dtype)
                lse[:, s, p, t] = ((m_row + torch.log2(l_row)) * LN2)[..., 0]
    return out, lse


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
    -6.9e19, and its gradients come out exactly 0). ``dq``/``dkv`` pick
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
                    dq6[:, s, p, t] = ((ds @ kf) * scale).to(q6.dtype)
                if dkv:
                    dk6[:, s, p, t] = ((ds.transpose(1, 2) @ qf) * scale).to(k6.dtype)
                    dv6[:, s, p, t] = (pr.transpose(1, 2) @ dof).to(v6.dtype)
    return dq6, dk6, dv6


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def pack_phases(
    x: torch.Tensor, g: int, S: int, r: int, Mp: int, num_heads: int
) -> torch.Tensor:
    """Dense [B, L, E] -> packed [B, S, r, hb, Mp, Dh] (``csrc/pack_phases.cu``)."""
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


def unpack_phases(p6: torch.Tensor, L: int, E: int, g: int, S: int, r: int) -> torch.Tensor:
    """Packed [B, S, r, hb, Mp, Dh] -> dense [B, L, E], off-band lanes exact
    0 (``csrc/unpack_phases.cu``)."""
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


def dilated_branch_fwd(
    q6: torch.Tensor, k6: torch.Tensor, v6: torch.Tensor, kvlen: torch.Tensor,
    is_causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed branch attention -> ``(out6, lse [B, S, r, hb, Mp] fp32)``
    (``csrc/dilated_branch_fwd.cu``)."""
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


def dilated_branch_bwd_dq(
    q6: torch.Tensor, k6: torch.Tensor, v6: torch.Tensor, do6: torch.Tensor,
    lse5: torch.Tensor, delta: torch.Tensor, kvlen: torch.Tensor, is_causal: bool = False,
) -> torch.Tensor:
    """Packed dq of the branch attention (``csrc/dilated_branch_bwd_dq.cu``);
    arguments as :func:`dilated_branch_bwd_reference`."""
    if q6.device.type == "cpu":
        return dilated_branch_bwd_reference(q6, k6, v6, do6, lse5, delta, kvlen, is_causal, dkv=False)[0]
    from gigapath_tpu_torch.ops import _build

    _check_bwd_inputs("dilated_branch_bwd_dq", q6, k6, v6, do6, lse5, delta, kvlen)
    B, S, r, hb, Mp, Dh = q6.shape
    dq6 = torch.empty_like(q6)
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


def dilated_branch_bwd_dkv(
    q6: torch.Tensor, k6: torch.Tensor, v6: torch.Tensor, do6: torch.Tensor,
    lse5: torch.Tensor, delta: torch.Tensor, kvlen: torch.Tensor, is_causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed ``(dk, dv)`` of the branch attention
    (``csrc/dilated_branch_bwd_dkv.cu``); arguments as
    :func:`dilated_branch_bwd_reference`."""
    if q6.device.type == "cpu":
        return dilated_branch_bwd_reference(q6, k6, v6, do6, lse5, delta, kvlen, is_causal, dq=False)[1:]
    from gigapath_tpu_torch.ops import _build

    _check_bwd_inputs("dilated_branch_bwd_dkv", q6, k6, v6, do6, lse5, delta, kvlen)
    B, S, r, hb, Mp, Dh = q6.shape
    dk6, dv6 = torch.empty_like(k6), torch.empty_like(v6)
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


# ---------------------------------------------------------------------------
# the branch op
# ---------------------------------------------------------------------------


class _DilatedBranch(torch.autograd.Function):
    """Dense q/k/v [B, L, E] -> ``(out [B, L, E], lse [B, H, L])`` of one
    branch; the counterpart of ``_dilated_branch``'s custom VJP.

    It saves the dense q/k/v (one copy shared by every branch of a layer)
    and this branch's packed ``out6``/``lse5``, never the packed q6/k6/v6:
    the backward re-packs them. The lse output takes no gradient. Both
    passes run with autocast off: the kernels (and their plain versions)
    compute in fp32 from the inputs' dtype."""

    @staticmethod
    def forward(ctx, q, k, v, kvlen, geometry, num_heads, is_causal):
        L, E, g, S, r, m, Mp = geometry
        with torch.autocast(q.device.type, enabled=False):
            q6, k6, v6 = (pack_phases(x, g, S, r, Mp, num_heads) for x in (q, k, v))
            out6, lse5 = dilated_branch_fwd(q6, k6, v6, kvlen, is_causal)
            out = unpack_phases(out6, L, E, g, S, r)
            lse = _scatter_lse(lse5, L, num_heads, g, r, m)
        ctx.save_for_backward(q, k, v, kvlen, out6, lse5)
        ctx.geometry, ctx.num_heads, ctx.is_causal = geometry, num_heads, is_causal
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):  # no gradient flows through the lse output
        q, k, v, kvlen, out6, lse5 = ctx.saved_tensors
        L, E, g, S, r, m, Mp = ctx.geometry
        H, causal = ctx.num_heads, ctx.is_causal
        with torch.autocast(q.device.type, enabled=False):
            do6 = pack_phases(dout.to(q.dtype).contiguous(), g, S, r, Mp, H)
            q6, k6, v6 = (pack_phases(x, g, S, r, Mp, H) for x in (q, k, v))
            # delta = rowsum(do * out) per (token, head), in the lse layout
            delta = (do6.float() * out6.float()).sum(dim=-1)
            dq6 = dilated_branch_bwd_dq(q6, k6, v6, do6, lse5, delta, kvlen, causal)
            dk6, dv6 = dilated_branch_bwd_dkv(q6, k6, v6, do6, lse5, delta, kvlen, causal)
            # off-band lanes come back exact 0: the branch never reads them
            grads = [unpack_phases(x6, L, E, g, S, r) for x6 in (dq6, dk6, dv6)]
        return (*grads, None, None, None, None)


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One dilated-attention branch on dense [B, L, E] activations.

    Returns ``(out [B, L, E], lse [B, H, L])``: lanes and (token, head)
    pairs the branch does not cover hold 0 / NEG_INF, ready for the
    cross-branch LSE-softmax fusion. Keys at positions ``>= real_len``
    (static) or ``>= valid_len_dyn[b]`` (per batch row) are masked.
    Differentiable in q, k and v; the lse output takes no gradient.
    Requires ``num_heads % r == 0``.
    """
    B, L, E = q.shape
    if E % num_heads or num_heads % r:
        raise ValueError(f"dilated_branch_attention: needs E % H == 0 and H % r == 0; got E={E}, H={num_heads}, r={r}")
    rl = L if real_len is None else min(int(real_len), L)
    g, S, m, Mp = _branch_geometry(L, int(sl), int(r))
    kvlen = _branch_kvlen(B, S, g, r, m, rl, valid_len_dyn, q.device)
    return _DilatedBranch.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), kvlen,
        (L, E, g, S, int(r), m, Mp), num_heads, is_causal,
    )
