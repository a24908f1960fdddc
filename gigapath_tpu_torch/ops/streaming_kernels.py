"""Streaming chunk-pair kernels (counterpart of
``gigapath_tpu/ops/pallas_streaming.py``).

One fold of the streaming chunked prefill attends a query block against one
resident key block under one dilated branch ``(segment length g, ratio r)``:
head ``h`` of phase ``p = h // ceil(H/r)`` sees key ``u`` from query ``t``
iff both sit on phase ``p``'s lattice (``(pos % g) % r == p``), share a
segment (``t // g == u // g``) and ``u < valid_len``. Three CUDA kernels
(``csrc/``) compute it from the blocks' global offsets, with no mask tensor:

- :func:`stream_pair_fwd` -> ``(out [B, cq, H, D] in q's dtype, lse [B, H,
  cq] fp32)``, the pair's chunk-normalized partial;
- :func:`stream_pair_bwd_dq` and :func:`stream_pair_bwd_dkv`, its backward
  from the stored lse, with the lse cotangent folded into the delta term
  (``delta' = rowsum(dout * out) - dlse``).

All three run bf16 blocks on the tensor cores (16-byte aligned pointers and
strides, else the wrappers raise) and fp32 blocks on the FMA pipes. Each
wrapper runs its ``*_reference`` plain PyTorch version when its tensor lies
on the CPU, launches its kernel on a CUDA tensor (or raises), and counts its
launches in :data:`LAUNCHES`. The plain versions compute the JAX package's
Pallas tier (``pallas_streaming.py``), forward and backward, so the bf16
gradient is the derivative of the bf16 forward under one tier. The forward:
``q * Dh^-1/2 * log2(e)`` rounded to the inputs' dtype once, fp32 scores,
masked scores selected to -1e30, a base-2 online softmax whose running max
(floored at ``M_FLOOR``) moves per tile of 64 keys of the head's key lattice
(the kernels' tiles; JAX's moves per key block), p rounded to v's dtype
before ``p @ v`` and l summing the unrounded p. In fp32 that is the jnp
tier's softmax up to the order of sums. A fully masked row gives out = 0
and lse ~ :data:`KERNEL_LSE_SENTINEL` (~-6.9e19; the jnp tier's is ~-1e8 +
log(ck)); either weighs 0 in every downstream combine, so compare lse on
covered rows only. The backward's plain version rounds ds to the inputs'
dtype before ``ds @ k``, as the Pallas ``_dq_kernel`` does.

:func:`pair_partial` is the differentiable op (``_PairPartial``, the
counterpart of ``_pair_with_lse``'s custom VJP) with
``pallas_pair_partial``'s contract: ``[B, c, H, D]`` blocks in, offsets as
Python ints. The kernels fix their own tiles: there are no block-size knobs
and no plan lookup. They take the blocks through their strides (no
transposes), and a ratio that does not divide H needs nothing special.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from gigapath_tpu_torch.ops.common import check_cuda, cuda_stream, kernel_wrapper, raise_on

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NO_VALID = 2**31 - 1  # valid_len=None: no key is past the valid bound
M_FLOOR = -1e20  # the kernels' running-max floor
MASKED_SCORE = -1e30  # a masked score, selected before the running max
# lse of a row with no visible key in the kernels (and of the rows off the
# phase lattice, which the wrapper fills)
KERNEL_LSE_SENTINEL = (M_FLOOR + math.log2(1e-30)) * LN2
ROW_TILE = 64  # lattice rows per block of the forward and dq kernels
KEY_ROWS_DKV = 32  # lattice keys per block of the fp32 dkv kernel (FMA pipes)
KEY_ROWS_DKV_BF16 = 64  # lattice keys per block of the bf16 dkv kernel (tensor cores)
MAX_HEAD_DIM = 128  # the kernels take head widths that are multiples of 8 up to this

# Launches of each CUDA kernel in this process. A wrapper adds one where it
# launches its kernel and nowhere else; callers reset and read it.
LAUNCHES = {"stream_pair_fwd": 0, "stream_pair_bwd_dq": 0, "stream_pair_bwd_dkv": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# masks and lattices
# ---------------------------------------------------------------------------


def pair_mask(
    q0: int, cq: int, k0: int, ck: int, segment_len: int, ratio: int,
    valid_len: Optional[int], num_heads: int, device=None,
) -> torch.Tensor:
    """The ``[H, cq, ck]`` bool mask of one pair: ``(h, i, j)`` is True iff
    query ``q0 + i`` of head ``h`` sees key ``k0 + j``."""
    t = q0 + torch.arange(cq, device=device)
    u = k0 + torch.arange(ck, device=device)
    phases = torch.arange(num_heads, device=device) // -(-num_heads // ratio)
    same_seg = (t[:, None] // segment_len) == (u[None, :] // segment_len)
    k_ok = ((u % segment_len) % ratio)[None, :] == phases[:, None]
    q_ok = ((t % segment_len) % ratio)[None, :] == phases[:, None]
    mask = same_seg[None] & k_ok[:, None, :] & q_ok[:, :, None]
    if valid_len is not None:
        mask = mask & (u < valid_len)[None, None, :]
    return mask


def lattice(off: int, c: int, segment_len: int, ratio: int) -> Tuple[int, int]:
    """``(step, shift)`` of a block's phase lattice: every row ``i`` of the
    ``c``-row block at global offset ``off`` that phase ``p`` can see has
    ``(off + i) % step == (p + shift) % step``. ``step = r`` when the segment
    length is a multiple of r, or when the block lies in one segment ``s``
    (then ``shift = s*g % r``); else ``step = 1``, every row."""
    g, r = segment_len, ratio
    if g % r == 0:
        return r, 0
    seg = off // g
    if (off + c - 1) // g == seg:
        return r, (seg * g) % r
    return 1, 0


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp32 ``x`` rounded to ``dtype`` and widened back (a no-op in fp32):
    the Pallas kernels' ``.astype`` before a matmul."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def stream_pair_fwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q0: int, k0: int,
    segment_len: int, ratio: int, valid_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [B, cq, H, D] in q's dtype, lse [B, H, cq] fp32)`` of one pair:
    the kernels' function, the Pallas ``_fwd_kernel``'s with the kernels'
    key tiles. ``q * Dh^-1/2 * log2(e)`` is rounded to q's dtype once; the
    scores are fp32 sums of its products with k; masked scores are selected
    to ``MASKED_SCORE`` (-1e30) before the max; a base-2 online softmax runs
    over tiles of the head's key lattice (lattice keys ``[64n, 64n + 64)``,
    the lattice cut at ``valid_len``; 32 in fp32 above a head width of 64,
    the FMA kernel's), its running max floored at ``M_FLOOR`` (-1e20), so
    masked keys underflow to an exact 0; p = exp2(s - m) is rounded to v's
    dtype before ``p @ v`` and l sums the unrounded fp32 p; out = acc /
    max(l, 1e-30) and lse = (m + log2 max(l, 1e-30)) ln 2. A fully masked
    row gives out = 0 and lse ~ ``KERNEL_LSE_SENTINEL``. In fp32 the
    roundings are no-ops and this is the one-shot softmax up to the order of
    sums. In bf16 p's rounding follows the running max, which moves per key
    block of 1024 rows in JAX: one key tile, or JAX blocks that hold the
    same lattice keys (r = 2 and 128-row blocks), agree bit for bit but for
    the order of sums, and past one tile the two differ by a few bf16
    roundings of p (``tests/test_torch_streaming.py::
    test_pair_fwd_bf16_matches_jax_fwd_impl`` reads 99.98 % and 100 % of
    out bit-equal on one tile and on matching tiles, 93.7 % with four tiles
    in one block, lse on covered rows within 1.9e-6). The largest temporary is one [B, H, cq,
    tile] fp32 score block."""
    B, cq, H, D = q.shape
    ck = k.shape[1]
    g, r, dev = segment_len, ratio, q.device
    tile = 32 if D > 64 and q.dtype == torch.float32 else ROW_TILE  # csrc/stream_pair_fwd.cu's key tiles
    # each head's key lattice (step, shift as the kernels'): block rows
    # start + step * n; rows past the block are masked
    step, shift = lattice(k0, ck, g, r)
    phases = torch.arange(H, device=dev) // -(-H // r)
    rows = (phases + shift - k0) % step
    rows = rows[:, None] + step * torch.arange(-(-ck // step), device=dev)  # [H, nk]
    u = k0 + rows
    k_ok = (rows < ck) & ((u % g) % r == phases[:, None])
    if valid_len is not None:
        k_ok &= u < valid_len
    rows, heads = rows.clamp(max=ck - 1), torch.arange(H, device=dev)[:, None]
    kl, vl = k[:, rows, heads].float(), v[:, rows, heads].float()  # [B, H, nk, D]
    t = q0 + torch.arange(cq, device=dev)
    q_ok = ((t % g) % r)[None, :] == phases[:, None]  # [H, cq]
    qs = _round_to(q.float() * (D**-0.5 * LOG2E), q.dtype).transpose(1, 2)  # [B, H, cq, D], base-2 units
    m_run = torch.full((B, H, cq, 1), M_FLOOR, dtype=torch.float32, device=dev)
    l_run = torch.zeros_like(m_run)
    acc = torch.zeros((B, H, cq, D), dtype=torch.float32, device=dev)
    for n0 in range(0, rows.shape[1], tile):
        n1 = n0 + tile
        seen = q_ok[:, :, None] & k_ok[:, None, n0:n1] & ((t // g)[None, :, None] == (u[:, None, n0:n1] // g))
        sc = (qs @ kl[:, :, n0:n1].transpose(-1, -2)).masked_fill(~seen, MASKED_SCORE)
        m_new = torch.maximum(m_run, sc.amax(dim=-1, keepdim=True))
        p = torch.exp2(sc - m_new)
        alpha = torch.exp2(m_run - m_new)
        l_run = l_run * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + _round_to(p, v.dtype) @ vl[:, :, n0:n1]
        m_run = m_new
    l_row = l_run.clamp_min(1e-30)
    out = (acc / l_row).to(q.dtype).transpose(1, 2).contiguous()
    return out, ((m_run + torch.log2(l_row)) * LN2)[..., 0]


def stream_pair_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, q0: int, k0: int, segment_len: int,
    ratio: int, valid_len: Optional[int] = None, *, dq: bool = True, dkv: bool = True,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The kernels' backward in plain PyTorch: from q/k/v and the output
    cotangent ``dout`` [B, c, H, D], the forward's ``lse`` and ``delta' =
    rowsum(dout * out) - dlse`` (fp32 [B, H, cq]) -> ``(dq, dk, dv)`` in
    the inputs' dtype. The probabilities are recomputed from the lse and
    selected to 0 where the pair is masked, whatever the row's lse. ds is
    rounded to q's dtype before ``ds @ k`` (dQ), as the Pallas
    ``_dq_kernel`` casts it to k's dtype; dK and dV keep p and ds in fp32,
    as its ``_dkv_kernel`` (in fp32 both are the same function).
    ``dq``/``dkv`` pick which gradients to compute (the others are None)."""
    B, cq, H, D = q.shape
    ck = k.shape[1]
    scale = D**-0.5
    qf, kf, vf, dof = (x.float() for x in (q, k, v, dout))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    mask = pair_mask(q0, cq, k0, ck, segment_len, ratio, valid_len, H, q.device)
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros((), device=q.device))
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - delta[..., None])
    dq_ = dk_ = dv_ = None
    if dq:
        dq_ = (torch.einsum("bhqk,bkhd->bqhd", _round_to(ds, q.dtype), kf) * scale).to(q.dtype)
    if dkv:
        dk_ = (torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale).to(k.dtype)
        dv_ = torch.einsum("bhqk,bqhd->bkhd", p, dof).to(v.dtype)
    return dq_, dk_, dv_


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _geometry(H: int, q0: int, cq: int, k0: int, ck: int, g: int, r: int, valid: int):
    """The kernels' int32 geometry array (``PairGeom`` in
    ``csrc/stream_common.cuh``) and their lattice row counts."""
    qstep, qshift = lattice(q0, cq, g, r)
    kstep, kshift = lattice(k0, ck, g, r)
    geo = (ctypes.c_int * 13)(
        H, -(-H // r), g, r, q0, cq, qstep, qshift, k0, ck, kstep, kshift, valid,
    )
    return geo, -(-cq // qstep), -(-ck // kstep)


def _strides(*tensors: torch.Tensor):
    """(batch, row, head) element strides of each [B, c, H, D] tensor."""
    flat = [s for t in tensors for s in (t.stride(0), t.stride(1), t.stride(2))]
    return (ctypes.c_longlong * len(flat))(*flat)


def _check(name: str, q, k, v, q0, k0, segment_len, ratio, valid, dout=None) -> None:
    """Raise unless the blocks are CUDA [B, c, H, D] tensors of one dtype on
    one device, the head width contiguous and taken by the kernels, and the
    geometry fits the kernels' int32 arithmetic."""
    blocks = (("q", q), ("k", k), ("v", v)) + ((("dout", dout),) if dout is not None else ())
    for arg, t in blocks:
        if t.device.type != "cuda" or t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{name} {arg}: needs a CUDA fp32 or bf16 tensor, got {t.dtype} on {t.device}")
        if t.dim() != 4 or t.stride(3) != 1 or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} {arg}: needs [B, c, H, D] with D contiguous, of q's dtype and device")
    B, cq, H, D = q.shape
    ck = k.shape[1]
    if k.shape != (B, ck, H, D) or v.shape != k.shape or (dout is not None and dout.shape != q.shape):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    if D % 8 or D > MAX_HEAD_DIM or min(B, cq, ck, H) < 1:
        raise ValueError(f"{name}: needs D % 8 == 0, D <= {MAX_HEAD_DIM} and non-empty blocks; got {tuple(q.shape)}")
    if segment_len < 1 or ratio < 1 or min(q0, k0) < 0 or max(q0 + cq, k0 + ck, valid) > NO_VALID:
        raise ValueError(f"{name}: geometry out of range (q0={q0}, k0={k0}, g={segment_len}, r={ratio})")


def _check_tensor_cores(name: str, **tensors: torch.Tensor) -> None:
    """The bf16 kernels load and store 16-byte pieces: raise unless
    every pointer and every (batch, row, head) stride in bytes is a
    multiple of 16."""
    for arg, t in tensors.items():
        if t.dtype != torch.bfloat16:
            continue
        es = t.element_size()
        if t.data_ptr() % 16 or any(t.stride(i) * es % 16 for i in range(3)):
            raise ValueError(f"{name} {arg}: the bf16 kernel needs a 16-byte aligned pointer and (batch, row, "
                             f"head) strides of whole 16 bytes, got strides {tuple(t.stride())}")


def _phase_run(lo: int, hi: int, p: int, r: int) -> int:
    """Offsets j in [lo, hi) of a segment with j % r == p."""
    return max(0, -(-(hi - p) // r)) - max(0, -(-(lo - p) // r))


def pair_count(H: int, q0: int, cq: int, k0: int, ck: int, segment_len: int, ratio: int,
               valid_len: Optional[int]) -> int:
    """The (head, query, key) triples :func:`pair_mask` admits, counted per
    segment and head without building the mask."""
    k_end = k0 + ck if valid_len is None else min(k0 + ck, int(valid_len))
    per = -(-H // ratio)
    total = 0
    for s in range(q0 // segment_len, (q0 + cq - 1) // segment_len + 1):
        base = s * segment_len
        qa, qb = max(q0, base) - base, min(q0 + cq, base + segment_len) - base
        ka, kb = max(k0, base) - base, min(k_end, base + segment_len) - base
        if qb <= qa or kb <= ka:
            continue
        for h in range(H):
            total += _phase_run(qa, qb, h // per, ratio) * _phase_run(ka, kb, h // per, ratio)
    return total


def _pair_cost(per_pair: int, row_tensors: int, key_tensors: int, row_vectors: int):
    """``cost`` of a chunk-pair kernel: ``per_pair * D`` operations per
    admitted (head, query, key) triple (4 forward, 6 dq, 8 dkv), each block
    of width D and ``row_vectors`` fp32 [B, H, cq] vectors moved once."""

    def cost(q, k, q0, k0, segment_len, ratio, valid_len, **_):
        B, cq, H, D = q.shape
        ck = k.shape[1]
        pairs = B * pair_count(H, q0, cq, k0, ck, segment_len, ratio, valid_len)
        es = q.element_size()
        return (float(per_pair * D * pairs),
                float(B * ((row_tensors * cq + key_tensors * ck) * H * D * es + row_vectors * cq * H * 4)))

    return cost


@kernel_wrapper("stream_pair_fwd", _pair_cost(4, 2, 2, 1))
def stream_pair_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q0: int, k0: int,
    segment_len: int, ratio: int, valid_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pair's ``(out, lse)`` (``csrc/stream_pair_fwd.cu``: bf16 on the
    tensor cores, fp32 on the FMA pipes); arguments as
    :func:`stream_pair_fwd_reference`."""
    if q.device.type == "cpu":
        return stream_pair_fwd_reference(q, k, v, q0, k0, segment_len, ratio, valid_len)
    from gigapath_tpu_torch.ops import _build

    valid = NO_VALID if valid_len is None else int(valid_len)
    _check("stream_pair_fwd", q, k, v, q0, k0, segment_len, ratio, valid)
    _check_tensor_cores("stream_pair_fwd", q=q, k=k, v=v)
    B, cq, H, D = q.shape
    geo, q_rows, _ = _geometry(H, q0, cq, k0, k.shape[1], segment_len, ratio, valid)
    n_qtiles = -(-q_rows // ROW_TILE)
    if B * H * n_qtiles >= 2**31:
        raise ValueError(f"stream_pair_fwd: {B * H * n_qtiles} blocks do not fit one grid")
    # rows off the phase lattice are never touched by the kernel: zeros and
    # the fully-masked sentinel
    out = torch.zeros((B, cq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.full((B, H, cq), KERNEL_LSE_SENTINEL, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _build.library("stream_pair_fwd", GP_HEAD_DIM=D).gp_stream_pair_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            int(q.dtype == torch.bfloat16), B, D, geo, n_qtiles, _strides(q, k, v, out),
            D**-0.5 * LOG2E, cuda_stream(q),
        )
    raise_on(rc, "stream_pair_fwd")
    LAUNCHES["stream_pair_fwd"] += 1
    return out, lse


def _check_vectors(name: str, q: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor) -> None:
    B, cq, H, _ = q.shape
    for arg, t in (("lse", lse), ("delta", delta)):
        check_cuda(f"{name} {arg}", t, (torch.float32,))
        if tuple(t.shape) != (B, H, cq) or t.device != q.device:
            raise ValueError(f"{name}: {arg} must be [B, H, cq] = {(B, H, cq)} on {q.device}")


@kernel_wrapper("stream_pair_bwd_dq", _pair_cost(6, 3, 2, 2))
def stream_pair_bwd_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, q0: int, k0: int, segment_len: int,
    ratio: int, valid_len: Optional[int] = None,
) -> torch.Tensor:
    """One pair's dq (``csrc/stream_pair_bwd_dq.cu``); arguments as
    :func:`stream_pair_bwd_reference`."""
    if q.device.type == "cpu":
        return stream_pair_bwd_reference(
            q, k, v, dout, lse, delta, q0, k0, segment_len, ratio, valid_len, dkv=False)[0]
    from gigapath_tpu_torch.ops import _build

    valid = NO_VALID if valid_len is None else int(valid_len)
    _check("stream_pair_bwd_dq", q, k, v, q0, k0, segment_len, ratio, valid, dout)
    _check_vectors("stream_pair_bwd_dq", q, lse, delta)
    _check_tensor_cores("stream_pair_bwd_dq", q=q, k=k, v=v, dout=dout)
    B, cq, H, D = q.shape
    geo, q_rows, _ = _geometry(H, q0, cq, k0, k.shape[1], segment_len, ratio, valid)
    n_qtiles = -(-q_rows // ROW_TILE)
    if B * H * n_qtiles >= 2**31:
        raise ValueError(f"stream_pair_bwd_dq: {B * H * n_qtiles} blocks do not fit one grid")
    dq = torch.zeros((B, cq, H, D), dtype=q.dtype, device=q.device)  # rows off the lattice: 0
    with torch.cuda.device(q.device):
        rc = _build.library("stream_pair_bwd_dq", GP_HEAD_DIM=D).gp_stream_pair_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), int(q.dtype == torch.bfloat16), B, D, geo,
            n_qtiles, _strides(q, k, v, dout, dq), D**-0.5 * LOG2E, D**-0.5, cuda_stream(q),
        )
    raise_on(rc, "stream_pair_bwd_dq")
    LAUNCHES["stream_pair_bwd_dq"] += 1
    return dq


@kernel_wrapper("stream_pair_bwd_dkv", _pair_cost(8, 2, 4, 2))
def stream_pair_bwd_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, q0: int, k0: int, segment_len: int,
    ratio: int, valid_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pair's ``(dk, dv)`` (``csrc/stream_pair_bwd_dkv.cu``); arguments
    as :func:`stream_pair_bwd_reference`."""
    if q.device.type == "cpu":
        return stream_pair_bwd_reference(
            q, k, v, dout, lse, delta, q0, k0, segment_len, ratio, valid_len, dq=False)[1:]
    from gigapath_tpu_torch.ops import _build

    valid = NO_VALID if valid_len is None else int(valid_len)
    _check("stream_pair_bwd_dkv", q, k, v, q0, k0, segment_len, ratio, valid, dout)
    _check_vectors("stream_pair_bwd_dkv", q, lse, delta)
    _check_tensor_cores("stream_pair_bwd_dkv", q=q, k=k, v=v, dout=dout)
    B, cq, H, D = q.shape
    ck = k.shape[1]
    geo, _, k_rows = _geometry(H, q0, cq, k0, ck, segment_len, ratio, valid)
    n_ktiles = -(-k_rows // (KEY_ROWS_DKV_BF16 if q.dtype == torch.bfloat16 else KEY_ROWS_DKV))
    if B * H * n_ktiles >= 2**31:
        raise ValueError(f"stream_pair_bwd_dkv: {B * H * n_ktiles} blocks do not fit one grid")
    # keys off the lattice or past the valid bound: 0
    dk = torch.zeros((B, ck, H, D), dtype=k.dtype, device=k.device)
    dv = torch.zeros((B, ck, H, D), dtype=v.dtype, device=v.device)
    with torch.cuda.device(q.device):
        rc = _build.library("stream_pair_bwd_dkv", GP_HEAD_DIM=D).gp_stream_pair_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), int(q.dtype == torch.bfloat16), B, D,
            geo, n_ktiles, _strides(q, k, v, dout, dk, dv), D**-0.5 * LOG2E, D**-0.5,
            cuda_stream(q),
        )
    raise_on(rc, "stream_pair_bwd_dkv")
    LAUNCHES["stream_pair_bwd_dkv"] += 1
    return dk, dv


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------


class _PairPartial(torch.autograd.Function):
    """``(q, k, v)`` blocks -> ``(out, lse)`` of one pair; the counterpart of
    ``_pair_with_lse``'s custom VJP. The forward saves q, k, v, out and lse;
    the backward takes the cotangents of both outputs (the lse is
    differentiated downstream: ``combine_partials`` merges through it), a
    missing dlse counting as zeros. Both passes run with autocast off: the
    kernels and their plain versions compute in fp32 from the inputs'
    dtype."""

    @staticmethod
    def forward(ctx, q, k, v, geometry):
        with torch.autocast(q.device.type, enabled=False):
            out, lse = stream_pair_fwd(q, k, v, *geometry)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.geometry = geometry
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        with torch.autocast(q.device.type, enabled=False):
            if dout is None:
                dout = torch.zeros_like(out)
            dout = dout.to(q.dtype).contiguous()
            delta = (dout.float() * out.float()).sum(dim=-1).transpose(1, 2)
            if dlse is not None:
                delta = delta - dlse.float()
            delta = delta.contiguous()
            dq = stream_pair_bwd_dq(q, k, v, dout, lse, delta, *ctx.geometry)
            dk, dv = stream_pair_bwd_dkv(q, k, v, dout, lse, delta, *ctx.geometry)
        return dq, dk, dv, None


def pair_partial(
    q_blk: torch.Tensor,
    k_blk: torch.Tensor,
    v_blk: torch.Tensor,
    q0: int,
    k0: int,
    *,
    segment_len: int,
    ratio: int,
    valid_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk-normalized ``(out [B, cq, H, D] in q's dtype, lse [B, H, cq]
    fp32)`` of one dilated branch restricted to one resident key block,
    ``q_blk`` [B, cq, H, D] at global token offset ``q0`` against
    ``k_blk``/``v_blk`` [B, ck, H, D] at ``k0``; keys at global positions
    ``>= valid_len`` are masked. Differentiable in the three blocks, through
    both outputs."""
    geometry = (int(q0), int(k0), int(segment_len), int(ratio),
                None if valid_len is None else int(valid_len))
    return _PairPartial.apply(q_blk, k_blk, v_blk, geometry)
