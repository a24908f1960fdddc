"""Segment-batched flash attention with log-sum-exp output (counterpart of
``gigapath_tpu/ops/pallas_flash.py``).

Three CUDA kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd_dq.cu``,
``csrc/flash_bwd_dkv.cu``) each read two layouts:

- **segmented** ``[B, H, S, M, D]``: each of the ``S`` segments attends
  within itself, keys at or past ``kvlen [B, H, S]`` masked (rows 11 and 12
  of ``PERF.md``: the JAX package's ``_fwd_impl`` and ``_bwd_impl``);
- **flat** ``[B, H, L, D]``: segment ``s`` is rows ``[s*g, (s+1)*g)``, the
  last one ragged, and its valid keys are ``clip(real_len - s*g, 0, g)``
  (rows 13 and 14: ``_flat_fwd_impl`` and ``_flat_bwd_impl``). No pad,
  reshape or copy is made, and no row at or past ``L`` is read or written.

Both run the Pallas kernels' arithmetic: an fp32 online softmax in base 2
(``log2(e)`` folded into the q scale, the running max floored at
``M_FLOOR``), masked logits selected to ``NEG_INF`` before the max, so a
row with no valid key gives ``out = 0`` and ``lse ~ -6.9e19``; in bf16,
``q * scale * log2(e)`` and the forward's probabilities are rounded to bf16
before their products, and dQ rounds ``ds`` to bf16 before ``ds @ k``,
where the Pallas kernels cast to the input dtype. The backward recomputes
the probabilities from the saved lse with ``delta = rowsum(dO * O)``. In
the flat layout the query rows at or past a segment's count add nothing to
dK/dV (``flat=True`` in the Pallas kernels), at every ``g``; their dQ is
unspecified, as there.

Every kernel takes one of two paths by the tensors' dtype: bf16 runs on
the tensor cores (``mma.sync``; the forward on the dilated branch forward's
tile steps, ``csrc/branch_mma.cuh``, with its running max per 64-key tile;
dK/dV's fp32 ``p`` and ``ds`` each split into two bf16 values, so the
products keep the Pallas kernels' fp32 operands to about 16 bits), fp32 on
the fp32 FMA pipes, where a tensor-core product would be TF32. The bf16
path needs a head width that is a multiple of 8 and 16-byte aligned
tensors, and the wrappers raise otherwise. There is no switch between
them.

Each wrapper runs its ``*_reference`` plain PyTorch version when its tensor
lies on the CPU, launches its kernel on a CUDA tensor (or raises), and
counts its launches in :data:`LAUNCHES`, one counter per Pallas row and
direction (the flat and segmented wrappers share a kernel source).

``bwd_blocks`` and ``_BWD_LOGITS_BUDGET`` of the JAX module size TPU VMEM
blocks and have no counterpart here: the kernels tile rows by 64 whatever
the segment length.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gigapath_tpu_torch.ops.common import check_cuda, cuda_stream, kernel_wrapper, raise_on

NEG_INF = -1e30  # masked logit
M_FLOOR = -1e20  # running-max floor: exp2(NEG_INF - m) is exactly 0 in fp32
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
# the longest segment the JAX package's flat path takes (a TPU VMEM cap the
# head-major dispatch keys on; the CUDA kernels take any length)
FLAT_MAX_SEGMENT = 1408
ROW_TILE = 64  # query/key rows per block of the kernels
MAX_HEAD_DIM = 128  # head widths: multiples of 4 up to this

# Launches of each CUDA kernel in this process. A wrapper adds one where it
# launches its kernel and nowhere else; callers reset and read it.
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "flat_fwd": 0, "flat_bwd_dq": 0, "flat_bwd_dkv": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def flat_kvlen(S: int, g: int, real_len: int) -> list:
    """Valid keys of each flat segment: ``clip(real_len - s*g, 0, g)``."""
    return [max(0, min(g, real_len - s * g)) for s in range(S)]


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def flash_fwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kvlen: Optional[torch.Tensor] = None,
    is_causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segmented q [B, H, S, Mq, D], k/v [B, H, S, Mk, D] and the valid-key
    counts ``kvlen`` [B, H, S] (None: every key) -> ``(out [B, H, S, Mq, D]
    in q's dtype, lse [B, H, S, Mq] fp32)``: the kernel's arithmetic, all
    segments and heads at once (the largest temporary is one [B, H, S, Mq,
    tile] fp32 score block). Causal masks key ``j > i`` within a segment.

    The kernel's function: an fp32 online softmax in base 2 over the
    kernel's key tiles, the running max floored at ``M_FLOOR``, with
    ``q * scale * log2(e)`` and the probabilities rounded to the input dtype
    before their products and ``l`` summing the unrounded probabilities. In
    bf16 the tiles are the tensor-core kernel's 64 keys at every head width,
    so this is ``dilated_branch_fwd_reference``'s function on each segment.
    In fp32 (the FMA kernel's 64 keys, 32 above a head width of 64) the
    roundings are no-ops and this is the one-shot softmax up to the order of
    sums. In bf16 p's rounding depends on the running max, so past
    one key tile this is the kernel's function and not the JAX kernel's,
    whose running max moves per key block (1024 keys; a whole segment in
    the flat layout): rounding as it does would take each row's max over a
    whole block before any P.V, a second Q.K^T pass. The two differ by a
    few bf16 roundings of p
    (``tests/test_torch_flash.py::test_segmented_autograd_matches_jax_bf16_past_one_key_tile``)."""
    B, H, S, Mq, D = q.shape
    Mk = k.shape[3]
    tile = 32 if D > 64 and q.dtype == torch.float32 else 64  # csrc/flash_fwd.cu's key tile
    dev = q.device
    qs = (q.float() * (D**-0.5 * LOG2E)).to(q.dtype).float()
    kf, vf = k.float(), v.float()
    rows = torch.arange(Mq, device=dev)[:, None]
    kv = Mk if kvlen is None else kvlen.to(device=dev, dtype=torch.int64)[..., None, None]  # [B, H, S, 1, 1]
    m_run = torch.full((B, H, S, Mq, 1), M_FLOOR, dtype=torch.float32, device=dev)
    l_run = torch.zeros_like(m_run)
    acc = torch.zeros((B, H, S, Mq, D), dtype=torch.float32, device=dev)
    for j0 in range(0, Mk, tile):
        cols = torch.arange(j0, min(j0 + tile, Mk), device=dev)[None, :]
        mask = cols >= kv
        if is_causal:
            mask = mask | (cols > rows)
        sc = (qs @ kf[..., j0:j0 + tile, :].transpose(-1, -2)).masked_fill(mask, NEG_INF)  # base-2 units
        m_new = torch.maximum(m_run, sc.amax(dim=-1, keepdim=True))
        p = torch.exp2(sc - m_new)
        alpha = torch.exp2(m_run - m_new)
        l_run = l_run * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).float() @ vf[..., j0:j0 + tile, :]
        m_run = m_new
    l_row = l_run.clamp_min(1e-30)
    return (acc / l_row).to(q.dtype), ((m_run + torch.log2(l_row)) * LN2)[..., 0]


def flash_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, kvlen: Optional[torch.Tensor] = None, is_causal: bool = False, *,
    flat: bool = False, dq: bool = True, dkv: bool = True,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Segmented q/do [B, H, S, Mq, D], k/v [B, H, S, Mk, D], the forward's
    ``lse`` and ``delta = rowsum(do * out)`` (fp32 [B, H, S, Mq]) ->
    ``(dq, dk, dv)``: the probabilities recomputed in base 2 from the lse,
    masked keys selected to ``NEG_INF`` before the exponent (a row with no
    valid key takes no gradient). ``flat``: query rows at or past their
    segment's count add nothing to dk/dv (the flat layout's rule). ``dq`` /
    ``dkv`` pick what to compute (the others are None)."""
    B, H, S, Mq, D = q.shape
    Mk = k.shape[3]
    scale = D**-0.5
    dq_out = torch.empty_like(q) if dq else None
    dk_out = torch.empty_like(k) if dkv else None
    dv_out = torch.empty_like(v) if dkv else None
    cols = torch.arange(Mk, device=q.device)
    rows = torch.arange(Mq, device=q.device)
    causal_mask = cols[None, :] > rows[:, None] if is_causal else None
    for s in range(S):
        for h in range(H):
            qf, dof = q[:, h, s].float(), do[:, h, s].float()
            kf, vf = k[:, h, s].float(), v[:, h, s].float()
            sc = (qf @ kf.transpose(1, 2)) * (scale * LOG2E)  # [B, Mq, Mk]
            mask = torch.zeros((B, 1, Mk), dtype=torch.bool, device=q.device)
            if kvlen is not None:
                mask = cols[None, None, :] >= kvlen[:, h, s].to(torch.int64)[:, None, None]
            if causal_mask is not None:
                mask = mask | causal_mask[None]
            p = torch.exp2(sc.masked_fill(mask, NEG_INF) - lse[:, h, s, :, None] * LOG2E)
            ds = p * (dof @ vf.transpose(1, 2) - delta[:, h, s, :, None])
            if dq:
                dq_out[:, h, s] = ((ds.to(k.dtype).float() @ kf) * scale).to(q.dtype)
            if dkv:
                if flat:
                    n = Mk if kvlen is None else kvlen[:, h, s].to(torch.int64)
                    row_out = (rows[None, :] >= torch.as_tensor(n, device=q.device).reshape(-1, 1))[..., None]
                    p, ds = p.masked_fill(row_out, 0.0), ds.masked_fill(row_out, 0.0)
                dk_out[:, h, s] = ((ds.transpose(1, 2) @ qf) * scale).to(k.dtype)
                dv_out[:, h, s] = (p.transpose(1, 2) @ dof).to(v.dtype)
    return dq_out, dk_out, dv_out


def _segments(x: torch.Tensor, g: int) -> torch.Tensor:
    """[B, H, L, ...] -> [B, H, S, g, ...], the tail zero-padded."""
    B, H, L = x.shape[:3]
    S = -(-L // g)
    pad = [0, 0] * (x.dim() - 3) + [0, S * g - L]
    return torch.nn.functional.pad(x, pad).reshape(B, H, S, g, *x.shape[3:])


def _flat_counts(B: int, H: int, L: int, g: int, real_len: int, device) -> torch.Tensor:
    S = -(-L // g)
    counts = torch.tensor(flat_kvlen(S, g, real_len), dtype=torch.int32, device=device)
    return counts.expand(B, H, S)


def flat_fwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: int, real_len: int, is_causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat q/k/v [B, H, L, D] in segments of ``g`` rows, keys at or past
    ``real_len`` masked -> ``(out [B, H, L, D], lse [B, H, L])``."""
    B, H, L, D = q.shape
    kvlen = _flat_counts(B, H, L, g, real_len, q.device)
    out, lse = flash_fwd_reference(_segments(q, g), _segments(k, g), _segments(v, g), kvlen, is_causal)
    return out.reshape(B, H, -1, D)[:, :, :L], lse.reshape(B, H, -1)[:, :, :L]


def flat_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, g: int, real_len: int, is_causal: bool = False, *,
    dq: bool = True, dkv: bool = True,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Flat backward: arguments as :func:`flat_fwd_reference` plus the
    output cotangent ``do`` [B, H, L, D], ``lse`` and ``delta`` [B, H, L];
    query rows at or past ``real_len`` add nothing to dk/dv."""
    B, H, L, D = q.shape
    kvlen = _flat_counts(B, H, L, g, real_len, q.device)
    grads = flash_bwd_reference(
        *(_segments(x, g) for x in (q, k, v, do, lse, delta)), kvlen, is_causal, flat=True, dq=dq, dkv=dkv,
    )
    return tuple(None if x is None else x.reshape(B, H, -1, D)[:, :, :L] for x in grads)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_inputs(name: str, qs, ks, dtype_of) -> None:
    for arg, t in qs + ks:
        check_cuda(f"{name} {arg}", t)
        if t.dtype != dtype_of.dtype or t.device != dtype_of.device:
            raise ValueError(f"{name}: {arg} must share q's dtype and device")
    for group in (qs, ks):
        for arg, t in group:
            if t.shape != group[0][1].shape:
                raise ValueError(f"{name}: {arg} shape {tuple(t.shape)} != {tuple(group[0][1].shape)}")


def _check_rows(name: str, t: torch.Tensor, shape, like: torch.Tensor) -> None:
    check_cuda(name, t, (torch.float32,))
    if tuple(t.shape) != tuple(shape) or t.device != like.device:
        raise ValueError(f"{name} must be {tuple(shape)} fp32 on {like.device}; got {tuple(t.shape)}")


def _check_layout(name: str, D: int, n_bh: int, S: int, M: int) -> None:
    tiles = n_bh * S * -(-M // ROW_TILE)
    if D % 4 or D > MAX_HEAD_DIM or M <= 0 or S <= 0 or tiles >= 2**31:
        raise ValueError(
            f"{name}: needs D % 4 == 0, D <= {MAX_HEAD_DIM}, segments of at least one row and "
            f"fewer than 2^31 row tiles; got D={D}, S={S}, M={M}, tiles={tiles}"
        )


def _kvlen_arg(name: str, kvlen: Optional[torch.Tensor], B: int, H: int, S: int, like: torch.Tensor):
    """The count table's pointer (0 for None: every key valid)."""
    if kvlen is None:
        return 0
    check_cuda(f"{name} kvlen", kvlen, (torch.int32,))
    if tuple(kvlen.shape) != (B, H, S) or kvlen.device != like.device:
        raise ValueError(f"{name}: kvlen must be [B, H, S] = {(B, H, S)} on {like.device}")
    return kvlen.data_ptr()


def _segmented_layout(q: torch.Tensor, k: torch.Tensor):
    """(n_bh, S, Mq, Mk, Lq, Lk, real_len) of the segmented layout."""
    B, H, S, Mq, D = q.shape
    Mk = k.shape[3]
    if k.shape[:3] != (B, H, S) or k.shape[4] != D:
        raise ValueError(f"flash: k {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    return B * H, S, Mq, Mk, S * Mq, S * Mk, S * Mk


def _flat_layout(name: str, q: torch.Tensor, g: int, real_len: int):
    B, H, L, D = q.shape
    if g <= 0 or not 0 <= real_len <= L:
        raise ValueError(f"{name}: needs g > 0 and 0 <= real_len <= L; got g={g}, real_len={real_len}, L={L}")
    return B * H, -(-L // g), g, g, L, L, real_len


def _pairs(Mq: int, Mk: int, kv: torch.Tensor, is_causal: bool):
    """(pairs, rows, keys) the masks admit over cells of ``kv`` valid keys
    each (fp64 on the CPU): a self-attention cell (Mq == Mk) has as many
    real query rows as valid keys, another cell all Mq rows; causal rows
    see the keys up to their own position, the last query row aligned with
    the last key."""
    kv = kv.to(torch.float64)
    rows = kv if Mq == Mk else torch.full_like(kv, Mq)
    if not is_causal:
        pairs = rows * kv
    else:
        i = torch.arange(Mq, dtype=torch.float64)
        seen = torch.minimum(kv[..., None], i + (Mk - Mq) + 1).clamp_min(0)
        pairs = torch.where(i < rows[..., None], seen, 0.0).sum(-1)
    return float(pairs.sum()), float(rows.sum()), float(kv.sum())


def _flash_cost(per_pair: int, row_tensors: int, key_tensors: int, row_vectors: int):
    """``cost`` of a segment-flash kernel: ``per_pair * D`` operations per
    admitted pair (4 forward, 6 dq, 8 dkv), the bytes of its query-row and
    key-row tensors of width D and ``row_vectors`` fp32 values a row. A
    flat call (``g``, ``real_len``) has segments of ``g`` rows, the last
    ``real_len`` ones valid; a segmented one ``kvlen`` valid keys a cell."""

    def cost(q, k, is_causal, kvlen=None, g=None, real_len=None, **_):
        if g is not None:
            B, H, L, D = q.shape
            seg = torch.arange(-(-L // g), dtype=torch.float64)
            kv = (real_len - seg * g).clamp(0, g).expand(B * H, -1)
            pairs, rows, keys = _pairs(g, g, kv, bool(is_causal))
        else:
            B, H, S, Mq, D = q.shape
            Mk = k.shape[3]
            kv = torch.full((B, H, S), float(Mk)) if kvlen is None else kvlen.detach().to("cpu")
            pairs, rows, keys = _pairs(Mq, Mk, kv, bool(is_causal))
        es = q.element_size()
        return (per_pair * D * pairs,
                (row_tensors * rows + key_tensors * keys) * D * es + row_vectors * rows * 4)

    return cost


@kernel_wrapper("flash_fwd", _flash_cost(4, 2, 2, 1))
def flash_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kvlen: Optional[torch.Tensor] = None,
    is_causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segmented forward (``csrc/flash_fwd.cu``); arguments as
    :func:`flash_fwd_reference`."""
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, kvlen, is_causal)
    _check_inputs("flash_fwd", [("q", q)], [("k", k), ("v", v)], q)
    B, H, S, Mq, D = q.shape
    layout = _segmented_layout(q, k)
    _check_layout("flash_fwd", D, B * H, S, Mq)
    kv_ptr = _kvlen_arg("flash_fwd", kvlen, B, H, S, q)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S, Mq), dtype=torch.float32, device=q.device)
    _launch_fwd("flash_fwd", q, k, v, kv_ptr, out, lse, layout, is_causal)
    return out, lse


@kernel_wrapper("flat_fwd", _flash_cost(4, 2, 2, 1))
def flat_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: int, real_len: int, is_causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat forward on [B, H, L, D] (``csrc/flash_fwd.cu`` in its flat
    layout); arguments as :func:`flat_fwd_reference`."""
    if q.device.type == "cpu":
        return flat_fwd_reference(q, k, v, g, real_len, is_causal)
    _check_inputs("flat_fwd", [("q", q), ("k", k), ("v", v)], [], q)
    B, H, L, D = q.shape
    layout = _flat_layout("flat_fwd", q, g, real_len)
    _check_layout("flat_fwd", D, B * H, layout[1], g)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    _launch_fwd("flat_fwd", q, k, v, 0, out, lse, layout, is_causal)
    return out, lse


def _check_tensor_cores(name, q, tensors) -> None:
    """bf16 tensors run on the tensor-core kernels, which need a head width
    that is a multiple of 8 and 16-byte aligned tensors: raise otherwise
    (no fall-back to another kernel or to the plain version)."""
    D = q.shape[-1]
    if q.dtype == torch.bfloat16 and (D % 8 or any(t.data_ptr() % 16 for t in tensors)):
        raise ValueError(f"{name}: the bf16 (tensor-core) kernel needs a head width that is a multiple of 8 "
                         f"and 16-byte aligned tensors; got D={D}")


def _launch_fwd(name, q, k, v, kv_ptr, out, lse, layout, is_causal) -> None:
    from gigapath_tpu_torch.ops import _build

    n_bh, S, Mq, Mk, Lq, Lk, real_len = layout
    D = q.shape[-1]
    _check_tensor_cores(name, q, (q, k, v, out))
    with torch.cuda.device(q.device):
        rc = _build.library("flash_fwd", GP_HEAD_DIM=D).gp_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_ptr, out.data_ptr(), lse.data_ptr(),
            int(q.dtype == torch.bfloat16), n_bh, S, Mq, Mk, Lq, Lk, real_len, int(is_causal),
            D**-0.5 * LOG2E, cuda_stream(q),
        )
    raise_on(rc, name)
    LAUNCHES[name] += 1


def _launch_bwd(name, source, q, k, v, do, lse, delta, kv_ptr, outs, layout, is_causal, flat=None) -> None:
    from gigapath_tpu_torch.ops import _build

    n_bh, S, Mq, Mk, Lq, Lk, real_len = layout
    D = q.shape[-1]
    _check_tensor_cores(name, q, (q, k, v, do, *outs))
    lib = _build.library(source, GP_HEAD_DIM=D)
    extra = () if flat is None else (int(flat),)
    with torch.cuda.device(q.device):
        rc = getattr(lib, "gp_" + source)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            kv_ptr, *(t.data_ptr() for t in outs), int(q.dtype == torch.bfloat16), n_bh, S, Mq, Mk, Lq, Lk,
            real_len, int(is_causal), *extra, D**-0.5 * LOG2E, D**-0.5, cuda_stream(q),
        )
    raise_on(rc, name)
    LAUNCHES[name] += 1


def _check_bwd(name, q, k, v, do, lse, delta, rows_shape):
    _check_inputs(name, [("q", q), ("do", do)], [("k", k), ("v", v)], q)
    _check_rows(f"{name} lse", lse, rows_shape, q)
    _check_rows(f"{name} delta", delta, rows_shape, q)


@kernel_wrapper("flash_bwd_dq", _flash_cost(6, 3, 2, 2))
def flash_bwd_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, kvlen: Optional[torch.Tensor] = None, is_causal: bool = False,
) -> torch.Tensor:
    """Segmented dq (``csrc/flash_bwd_dq.cu``); arguments as
    :func:`flash_bwd_reference`."""
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, do, lse, delta, kvlen, is_causal, dkv=False)[0]
    B, H, S, Mq, D = q.shape
    _check_bwd("flash_bwd_dq", q, k, v, do, lse, delta, (B, H, S, Mq))
    layout = _segmented_layout(q, k)
    _check_layout("flash_bwd_dq", D, B * H, S, Mq)
    kv_ptr = _kvlen_arg("flash_bwd_dq", kvlen, B, H, S, q)
    dq = torch.empty_like(q)
    _launch_bwd("flash_bwd_dq", "flash_bwd_dq", q, k, v, do, lse, delta, kv_ptr, (dq,), layout, is_causal)
    return dq


@kernel_wrapper("flash_bwd_dkv", _flash_cost(8, 2, 4, 2))
def flash_bwd_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, kvlen: Optional[torch.Tensor] = None, is_causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segmented ``(dk, dv)`` (``csrc/flash_bwd_dkv.cu``); arguments as
    :func:`flash_bwd_reference`."""
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, do, lse, delta, kvlen, is_causal, dq=False)[1:]
    B, H, S, Mq, D = q.shape
    _check_bwd("flash_bwd_dkv", q, k, v, do, lse, delta, (B, H, S, Mq))
    layout = _segmented_layout(q, k)
    _check_layout("flash_bwd_dkv", D, B * H, S, k.shape[3])
    kv_ptr = _kvlen_arg("flash_bwd_dkv", kvlen, B, H, S, q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("flash_bwd_dkv", "flash_bwd_dkv", q, k, v, do, lse, delta, kv_ptr, (dk, dv), layout,
                is_causal, flat=False)
    return dk, dv


@kernel_wrapper("flat_bwd_dq", _flash_cost(6, 3, 2, 2))
def flat_bwd_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, g: int, real_len: int, is_causal: bool = False,
) -> torch.Tensor:
    """Flat dq (``csrc/flash_bwd_dq.cu`` in its flat layout); arguments as
    :func:`flat_bwd_reference`. Rows at or past ``real_len`` are
    unspecified."""
    if q.device.type == "cpu":
        return flat_bwd_reference(q, k, v, do, lse, delta, g, real_len, is_causal, dkv=False)[0]
    B, H, L, D = q.shape
    _check_bwd("flat_bwd_dq", q, k, v, do, lse, delta, (B, H, L))
    layout = _flat_layout("flat_bwd_dq", q, g, real_len)
    _check_layout("flat_bwd_dq", D, B * H, layout[1], g)
    dq = torch.empty_like(q)
    _launch_bwd("flat_bwd_dq", "flash_bwd_dq", q, k, v, do, lse, delta, 0, (dq,), layout, is_causal)
    return dq


@kernel_wrapper("flat_bwd_dkv", _flash_cost(8, 2, 4, 2))
def flat_bwd_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, g: int, real_len: int, is_causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat ``(dk, dv)`` (``csrc/flash_bwd_dkv.cu`` in its flat layout);
    arguments as :func:`flat_bwd_reference`."""
    if q.device.type == "cpu":
        return flat_bwd_reference(q, k, v, do, lse, delta, g, real_len, is_causal, dq=False)[1:]
    B, H, L, D = q.shape
    _check_bwd("flat_bwd_dkv", q, k, v, do, lse, delta, (B, H, L))
    layout = _flat_layout("flat_bwd_dkv", q, g, real_len)
    _check_layout("flat_bwd_dkv", D, B * H, layout[1], g)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("flat_bwd_dkv", "flash_bwd_dkv", q, k, v, do, lse, delta, 0, (dk, dv), layout, is_causal,
                flat=True)
    return dk, dv


# ---------------------------------------------------------------------------
# differentiable ops
# ---------------------------------------------------------------------------


class _FlashWithLse(torch.autograd.Function):
    """Segmented ``(out, lse)`` with the kernels' backward; the counterpart
    of ``_flash_with_lse``'s custom VJP. The lse output takes no gradient.
    Autocast is off: the kernels compute in fp32 from the inputs' dtype."""

    @staticmethod
    def forward(ctx, q, k, v, kvlen, is_causal):
        with torch.autocast(q.device.type, enabled=False):
            out, lse = flash_fwd(q, k, v, kvlen, is_causal)
        ctx.save_for_backward(q, k, v, kvlen, out, lse)
        ctx.is_causal = is_causal
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):  # no gradient flows through the lse output
        q, k, v, kvlen, out, lse = ctx.saved_tensors
        with torch.autocast(q.device.type, enabled=False):
            delta = (do.float() * out.float()).sum(dim=-1)
            do = do.to(q.dtype).contiguous()
            dq = flash_bwd_dq(q, k, v, do, lse, delta, kvlen, ctx.is_causal)
            dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, kvlen, ctx.is_causal)
        return dq, dk, dv, None, None


class _FlatWithLse(torch.autograd.Function):
    """Flat ``(out, lse)`` with the kernels' backward; the counterpart of
    ``_flat_with_lse``'s custom VJP."""

    @staticmethod
    def forward(ctx, q, k, v, g, real_len, is_causal):
        with torch.autocast(q.device.type, enabled=False):
            out, lse = flat_fwd(q, k, v, g, real_len, is_causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.g, ctx.real_len, ctx.is_causal = g, real_len, is_causal
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):  # no gradient flows through the lse output
        q, k, v, out, lse = ctx.saved_tensors
        args = (ctx.g, ctx.real_len, ctx.is_causal)
        with torch.autocast(q.device.type, enabled=False):
            delta = (do.float() * out.float()).sum(dim=-1)
            do = do.to(q.dtype).contiguous()
            dq = flat_bwd_dq(q, k, v, do, lse, delta, *args)
            dk, dv = flat_bwd_dkv(q, k, v, do, lse, delta, *args)
        return dq, dk, dv, None, None, None


def flash_segments(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kvlen: Optional[torch.Tensor] = None,
    is_causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable segmented flash attention on [B, H, S, M, D] ->
    ``(out, lse [B, H, S, Mq])``; ``kvlen`` [B, H, S] int32 (a tensor on
    q's device, e.g. counts computed there) or None."""
    return _FlashWithLse.apply(q.contiguous(), k.contiguous(), v.contiguous(), kvlen, is_causal)


def flat_segment_flash(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    segment_len: int,
    real_len: Optional[int] = None,
    is_causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segmented flash attention on flat [B, H, L, D] -> ``(out [B, H, L,
    D], lse [B, H, L])``: each ``segment_len`` rows attend within
    themselves, keys at or past ``real_len`` masked; no pad or reshape.
    Requires ``segment_len % 8 == 0`` and ``segment_len <=
    FLAT_MAX_SEGMENT``, as the JAX package's flat path does."""
    L = q.shape[2]
    if segment_len % 8 or not 0 < segment_len <= FLAT_MAX_SEGMENT:
        raise ValueError(f"flat_segment_flash: segment_len {segment_len} must be a multiple of 8 "
                         f"in (0, {FLAT_MAX_SEGMENT}]")
    rl = L if real_len is None else min(int(real_len), L)
    return _FlatWithLse.apply(q.contiguous(), k.contiguous(), v.contiguous(), int(segment_len), rl, is_causal)


def cuda_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    is_causal: bool = False,
    kv_len=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention on [B, L, H, D] -> ``(out [B, L, H, D], lse [B, H,
    L])``: the counterpart of ``pallas_flash_attention``. ``kv_len``:
    optional [B, H] valid-key counts (a tensor, which may live on the
    device, or an array-like). The kernels run on one segment of the
    head-major ``[B, H, 1, L, D]`` layout; the wrapper transposes."""
    B, Lq, H, D = q.shape
    kvlen = None
    if kv_len is not None:
        kvlen = torch.as_tensor(kv_len, device=q.device).to(torch.int32).reshape(B, H, 1).contiguous()
    q5, k5, v5 = (x.transpose(1, 2).unsqueeze(2) for x in (q, k, v))
    out, lse = flash_segments(q5, k5, v5, kvlen, is_causal)
    return out[:, :, 0].transpose(1, 2), lse[:, :, 0]

