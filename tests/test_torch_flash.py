"""The port's segment-flash kernels, flash entry points and RMSNorm held
against the JAX package.

Inputs come from a numpy seed and go through both sides. On the CPU each
port kernel wrapper runs its plain PyTorch version; the JAX side runs
``pallas_flash`` in interpret mode, as ``tests/test_pallas_flash.py`` does.
fp32: forward 1e-5 and gradients 1e-4 (the same fp32 arithmetic, sums in
another order). bf16: both sides round q * scale and the probabilities to
bf16 at the same places; the tolerance allows a few bf16 ulps for roundings
that fall on the other side of a tie after sums in another order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test process)

from gigapath_tpu.ops import flash_attention as jfa
from gigapath_tpu.ops import pallas_flash as pf
from gigapath_tpu.ops.norms import RMSNorm as JaxRMSNorm
from gigapath_tpu_torch.ops import attention as port_attention
from gigapath_tpu_torch.ops import flash_attention as port_fa
from gigapath_tpu_torch.ops import flash_kernels as fk
from gigapath_tpu_torch.ops.norms import RMSNorm
from gigapath_tpu_torch.utils.convert import state_dict_from_flax_params

FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def _data(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) else x.detach().float().numpy()


@functools.partial(jax.jit, static_argnums=(4, 5))
def _jax_segmented(q, k, v, kvlen, causal, with_bwd, do):
    D = q.shape[-1]
    out, lse = pf._fwd_impl(q, k, v, kvlen, causal, D**-0.5, 1024, 1024, True)
    if not with_bwd:
        return out, lse, None
    delta = jnp.sum(do.astype(jnp.float32) * out.astype(jnp.float32), axis=-1)
    return out, lse, pf._bwd_impl(q, k, v, lse, delta, do, kvlen, causal, D**-0.5, 1024, 1024, True)


# (B, H, S, Mq, Mk, D, kvlen pattern, causal): unaligned lengths, a ragged
# count per (batch, head, segment) with empty segments, causal
SEGMENTED_CASES = [
    (1, 2, 3, 40, 40, 8, "full", False),
    (2, 3, 2, 77, 77, 16, "ragged", False),
    (1, 2, 2, 65, 65, 8, "ragged", True),
    (2, 2, 1, 33, 90, 8, "ragged", False),
]


def _kvlen(pattern, B, H, S, Mk, seed=5):
    if pattern == "full":
        return None
    counts = np.random.default_rng(seed).integers(0, Mk + 1, size=(B, H, S)).astype(np.int32)
    counts.flat[0] = 0  # one segment with no valid key
    counts.flat[-1] = Mk
    return counts


@pytest.mark.parametrize("B,H,S,Mq,Mk,D,pattern,causal", SEGMENTED_CASES)
def test_segmented_fwd_bwd_match_jax_fp32(B, H, S, Mq, Mk, D, pattern, causal):
    q, do = _data(1, B, H, S, Mq, D), _data(4, B, H, S, Mq, D)
    k, v = _data(2, B, H, S, Mk, D), _data(3, B, H, S, Mk, D)
    kvlen = _kvlen(pattern, B, H, S, Mk)
    if kvlen is not None:
        # masked keys are large real values, excluded by select
        cols = np.arange(Mk)[None, None, None, :, None] >= kvlen[..., None, None]
        k, v = np.where(cols, 1e3 * k, k), np.where(cols, 1e3 * v, v)
    out_j, lse_j, (dq_j, dk_j, dv_j) = _jax_segmented(
        *(jnp.asarray(x) for x in (q, k, v)), None if kvlen is None else jnp.asarray(kvlen), causal, True,
        jnp.asarray(do))
    kv_t = None if kvlen is None else torch.from_numpy(kvlen)
    out, lse = fk.flash_fwd(_t(q), _t(k), _t(v), kv_t, causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=1e-5, rtol=1e-6)
    delta = (torch.from_numpy(do) * out).sum(-1)
    args = (_t(q), _t(k), _t(v), _t(do), lse, delta, kv_t, causal)
    dq = fk.flash_bwd_dq(*args)
    dk, dv = fk.flash_bwd_dkv(*args)
    for name, a, b in (("dq", dq, dq_j), ("dk", dk, dk_j), ("dv", dv, dv_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD_TOL)
    if kvlen is not None:  # no gradient reaches a masked key
        masked = (np.arange(Mk)[None, None, None, :] >= kvlen[..., None])
        assert not dk.numpy()[masked].any() and not dv.numpy()[masked].any()


def test_segmented_autograd_matches_jax_bf16():
    """The differentiable op in bf16: forward, lse and gradients within a
    few bf16 ulps of the JAX kernels."""
    B, H, S, M, D = 1, 2, 2, 72, 16
    q, k, v, do = (_data(10 + i, B, H, S, M, D) for i in range(4))
    kvlen = _kvlen("ragged", B, H, S, M, seed=11)
    qj, kj, vj, doj = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    out_j, lse_j, grads_j = _jax_segmented(qj, kj, vj, jnp.asarray(kvlen), False, True, doj)
    qt, kt, vt = (_t(x, torch.bfloat16).requires_grad_() for x in (q, k, v))
    out, lse = fk.flash_segments(qt, kt, vt, torch.from_numpy(kvlen))
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32 and not lse.requires_grad
    out.backward(_t(do, torch.bfloat16))
    np.testing.assert_allclose(_np(out), _np(out_j), **BF16_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=2e-2, rtol=1e-3)
    for name, a, b in zip(("dq", "dk", "dv"), (qt.grad, kt.grad, vt.grad), grads_j):
        scale = float(np.abs(_np(b)).max())
        np.testing.assert_allclose(_np(a), _np(b), atol=3e-2 * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize("D", [16, 96])
def test_segmented_autograd_matches_jax_bf16_past_one_key_tile(D):
    """Segments of 200 keys: four of the bf16 forward kernel's 64-key tiles
    at both widths (the tensor-core kernel's tile at every D), one JAX
    block. The port's bf16 forward takes its running max per tile and JAX
    per block, so p rounds against another max on some rows
    (``flash_fwd_reference``'s docstring says why the port keeps its
    tiles); out, lse and the gradients stay within the tolerances of
    ``test_segmented_autograd_matches_jax_bf16`` (read: out 1.6e-3 / 2.3e-3
    of its max, lse 9.5e-7, gradients at most 2.5e-3 / 1.4e-3 of their max
    at D = 16 / 96)."""
    B, H, S, M = 1, 2, 2, 200
    q, k, v, do = (_data(10 + i, B, H, S, M, D) for i in range(4))
    kvlen = _kvlen("ragged", B, H, S, M, seed=11)
    qj, kj, vj, doj = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    out_j, lse_j, grads_j = _jax_segmented(qj, kj, vj, jnp.asarray(kvlen), False, True, doj)
    qt, kt, vt = (_t(x, torch.bfloat16).requires_grad_() for x in (q, k, v))
    out, lse = fk.flash_segments(qt, kt, vt, torch.from_numpy(kvlen))
    out.backward(_t(do, torch.bfloat16))
    np.testing.assert_allclose(_np(out), _np(out_j), **BF16_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=2e-2, rtol=1e-3)
    for name, a, b in zip(("dq", "dk", "dv"), (qt.grad, kt.grad, vt.grad), grads_j):
        scale = float(np.abs(_np(b)).max())
        np.testing.assert_allclose(_np(a), _np(b), atol=3e-2 * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize("D,causal", [(16, False), (96, False), (96, True)], ids=["d16", "d96", "d96_causal"])
def test_flash_fwd_reference_bf16_is_the_64_key_online_softmax(D, causal):
    """In bf16 the plain forward is the tensor-core kernel's function at
    every head width: the online softmax over 64-key tiles that the
    dilated branch forward's plain version computes (the two kernels share
    their tile steps), bit for bit on the same cells, above D = 64 too,
    where the fp32 FMA kernel takes 32-key tiles (with 32-key tiles p
    rounds against another running max and out moves by a bf16 ulp)."""
    from gigapath_tpu_torch.ops import dilated_kernels as dk

    B, H, S, M = 1, 3, 2, 150
    q, k, v = (torch.from_numpy(_data(30 + i, B, H, S, M, D, scale=3.0)).to(torch.bfloat16) for i in range(3))
    kvlen = torch.from_numpy(_kvlen("ragged", B, H, S, M, seed=12))
    out, lse = fk.flash_fwd_reference(q, k, v, kvlen, causal)
    packed = lambda x: x.permute(0, 2, 1, 3, 4).unsqueeze(3)  # noqa: E731  [B, S, r = H, hb = 1, M, D]
    out6, lse5 = dk.dilated_branch_fwd_reference(packed(q), packed(k), packed(v), kvlen.permute(0, 2, 1), causal)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, out6[:, :, :, 0].permute(0, 2, 1, 3, 4))
    assert torch.equal(lse, lse5[:, :, :, 0].permute(0, 2, 1, 3))


def _one_shot_flash_fwd(q, k, v, kvlen, causal):
    """The segmented forward as one fp32 softmax over all of a segment's
    keys (no key tiles, no rounding)."""
    B, H, S, Mq, D = q.shape
    Mk = k.shape[3]
    cols = torch.arange(Mk)
    mask = cols[None, None, None, None, :] >= kvlen.to(torch.int64)[..., None, None]
    if causal:
        mask = mask | (cols[None, :] > torch.arange(Mq)[:, None])
    sc = ((q * (D**-0.5 * fk.LOG2E)) @ k.transpose(-1, -2)).masked_fill(mask, fk.NEG_INF)
    m_row = sc.amax(dim=-1, keepdim=True).clamp_min(fk.M_FLOOR)
    p = torch.exp2(sc - m_row)
    l_row = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return (p @ v) / l_row, ((m_row + torch.log2(l_row)) * fk.LN2)[..., 0]


@pytest.mark.parametrize("D,causal", [(16, False), (16, True), (96, False)], ids=["d16", "d16_causal", "d96"])
def test_flash_fwd_reference_is_the_one_shot_softmax_in_fp32(D, causal):
    """In fp32 the plain forward's online softmax over the kernel's key
    tiles (64 keys, 32 above D = 64; its roundings no-ops) is the one-shot
    softmax up to the order of sums: within the fp32 tolerances held
    against the JAX package (out 1e-5, lse atol 1e-5 / rtol 1e-6), over
    segments of 150 keys with ragged and empty counts."""
    B, H, S, M = 2, 2, 2, 150
    q, k, v = (torch.from_numpy(_data(30 + i, B, H, S, M, D, scale=3.0)) for i in range(3))
    kvlen = torch.from_numpy(_kvlen("ragged", B, H, S, M, seed=12))
    out, lse = fk.flash_fwd_reference(q, k, v, kvlen, causal)
    ref_out, ref_lse = _one_shot_flash_fwd(q, k, v, kvlen, causal)
    torch.testing.assert_close(out, ref_out, **FWD_TOL)
    covered = ref_lse > -1e19
    torch.testing.assert_close(lse[covered], ref_lse[covered], atol=1e-5, rtol=1e-6)
    assert (lse[~covered] <= -1e19).all() and not out[0, 0, 0].any()


@functools.partial(jax.jit, static_argnums=(3, 4, 5))
def _jax_flat(q, k, v, g, rl, causal, do):
    def f(a, b, c):
        return pf.flat_segment_flash(a, b, c, segment_len=g, real_len=rl, is_causal=causal, interpret=True)

    (out, lse), vjp = jax.vjp(f, q, k, v)
    return out, lse, vjp((do, jnp.zeros_like(lse)))


@pytest.mark.parametrize("L,g,rl,causal", [(37, 16, 37, False), (37, 16, 30, False), (70, 24, 41, True)])
def test_flat_segment_flash_matches_jax(L, g, rl, causal):
    """Ragged last segment, keys past real_len masked (empty segments too);
    dq is compared on rows [0, real_len) only, where it is specified, and
    dk/dv everywhere: rows at or past real_len add nothing to them."""
    B, H, D = 2, 2, 8
    q, k, v, do = (_data(20 + i, B, H, L, D) for i in range(4))
    out_j, lse_j, (dq_j, dk_j, dv_j) = _jax_flat(
        *(jnp.asarray(x) for x in (q, k, v)), g, rl, causal, jnp.asarray(do))
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    out, lse = fk.flat_segment_flash(qt, kt, vt, segment_len=g, real_len=rl, is_causal=causal)
    out.backward(_t(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(qt.grad.numpy()[:, :, :rl], np.asarray(dq_j)[:, :, :rl], **GRAD_TOL)
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(dk_j), **GRAD_TOL)
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(dv_j), **GRAD_TOL)


@pytest.mark.parametrize("D", [24, 48])
@pytest.mark.parametrize("causal", [False, True])
def test_flat_autograd_matches_jax_bf16(D, causal):
    """The flat op in bf16 (the dtype whose CUDA backward runs on the tensor
    cores): a ragged last segment and keys past real_len masked; forward,
    lse and gradients within a few bf16 ulps of the JAX kernels, dq on rows
    [0, real_len), dk/dv everywhere."""
    B, H, L, g, rl = 1, 2, 70, 24, 41
    q, k, v, do = (_data(80 + i, B, H, L, D) for i in range(4))
    qj, kj, vj, doj = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    out_j, lse_j, grads_j = _jax_flat(qj, kj, vj, g, rl, causal, doj)
    qt, kt, vt = (_t(x, torch.bfloat16).requires_grad_() for x in (q, k, v))
    out, lse = fk.flat_segment_flash(qt, kt, vt, segment_len=g, real_len=rl, is_causal=causal)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    out.backward(_t(do, torch.bfloat16))
    np.testing.assert_allclose(_np(out), _np(out_j), **BF16_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=2e-2, rtol=1e-3)
    rows = (slice(None), slice(None), slice(0, rl))
    for name, a, b in zip(("dq", "dk", "dv"), (qt.grad, kt.grad, vt.grad), grads_j):
        a, b = _np(a), _np(b)
        if name == "dq":
            a, b = a[rows], b[rows]
        np.testing.assert_allclose(a, b, atol=3e-2 * float(np.abs(b).max()), rtol=0, err_msg=name)
    # keys past real_len are masked: no gradient reaches them
    assert not _np(kt.grad)[:, :, rl:].any() and not _np(vt.grad)[:, :, rl:].any()


@pytest.mark.parametrize("causal", [False, True])
def test_flat_bf16_ragged_query_tile_matches_jax(causal):
    """Flat segments of g = 80 rows (one whole 64-row query tile and a
    ragged one of 16) over L = 170 (a ragged last segment of 10 rows) with
    keys at or past real_len = 150 masked, D = 48, bf16: forward, lse and
    gradients against ``pf.flat_segment_flash`` (interpret mode) within the
    tolerances of ``test_flat_autograd_matches_jax_bf16``, dq on rows [0,
    real_len), dk/dv everywhere."""
    B, H, L, g, rl, D = 1, 2, 170, 80, 150, 48
    q, k, v, do = (_data(100 + i, B, H, L, D) for i in range(4))
    qj, kj, vj, doj = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    out_j, lse_j, grads_j = _jax_flat(qj, kj, vj, g, rl, causal, doj)
    qt, kt, vt = (_t(x, torch.bfloat16).requires_grad_() for x in (q, k, v))
    out, lse = fk.flat_segment_flash(qt, kt, vt, segment_len=g, real_len=rl, is_causal=causal)
    assert out.shape == (B, H, L, D) and lse.shape == (B, H, L)
    out.backward(_t(do, torch.bfloat16))
    np.testing.assert_allclose(_np(out), _np(out_j), **BF16_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=2e-2, rtol=1e-3)
    for name, a, b in zip(("dq", "dk", "dv"), (qt.grad, kt.grad, vt.grad), grads_j):
        a, b = _np(a), _np(b)
        if name == "dq":
            a, b = a[:, :, :rl], b[:, :, :rl]
        np.testing.assert_allclose(a, b, atol=3e-2 * float(np.abs(b).max()), rtol=0, err_msg=name)
    assert not _np(kt.grad)[:, :, rl:].any() and not _np(vt.grad)[:, :, rl:].any()


@pytest.mark.parametrize("operand", ["p", "ds"])
def test_dkv_split_operand_keeps_fp32_products(operand):
    """Why the bf16 dK/dV kernel splits its fp32 operand: with hi = bf16(x)
    and lo = bf16(x - hi), (hi + lo)^T . y stays within 2^-15 (relative to
    the largest entry) of the fp32 operand's product, as the Pallas kernel
    computes it; bf16(x)^T . y alone does not."""
    rng = np.random.default_rng(90)
    x = rng.uniform(0.0, 1.0, size=(64, 64)) if operand == "p" else rng.normal(size=(64, 64))
    x = torch.from_numpy(x.astype(np.float32))  # [queries, keys]: p or ds of one tile
    y = torch.from_numpy(rng.normal(size=(64, 48)).astype(np.float32)).to(torch.bfloat16)  # dO or q
    ref = x.double().T @ y.double()
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    split = hi.float().T @ y.float() + lo.float().T @ y.float()
    alone = hi.float().T @ y.float()
    scale = float(ref.abs().max())
    assert float((split.double() - ref).abs().max()) / scale <= 2.0**-15
    assert float((alone.double() - ref).abs().max()) / scale > 2.0**-15


def test_tensor_core_flash_inputs_are_checked():
    """The check every segment-flash wrapper (forward, dq, dkv) makes before
    a CUDA launch: bf16 tensors go to the tensor-core kernels, which need a
    head width that is a multiple of 8 and 16-byte aligned tensors; fp32
    tensors (the FMA kernels) take any width the kernels are built for."""
    fits = torch.zeros(1, 1, 1, 64, 48, dtype=torch.bfloat16)
    fk._check_tensor_cores("flash_fwd", fits, (fits, fits, fits, fits))
    narrow = torch.zeros(1, 1, 1, 64, 20)
    fk._check_tensor_cores("flash_fwd", narrow, (narrow,) * 4)
    with pytest.raises(ValueError, match="multiple of 8"):
        fk._check_tensor_cores("flat_fwd", narrow.to(torch.bfloat16), (narrow.to(torch.bfloat16),) * 4)
    shifted = torch.zeros(64 * 48 + 1, dtype=torch.bfloat16)[1:].view(fits.shape)
    with pytest.raises(ValueError, match="aligned"):
        fk._check_tensor_cores("flash_fwd", shifted, (shifted, fits, fits, fits))


def test_flat_segment_flash_rejects_segments_the_flat_path_does_not_take():
    x = torch.zeros(1, 1, 64, 8)
    for g in (12, fk.FLAT_MAX_SEGMENT + 8):
        with pytest.raises(ValueError, match="segment_len"):
            fk.flat_segment_flash(x, x, x, segment_len=g)


def test_flat_wrappers_equal_the_segmented_ones_on_whole_segments():
    """With L a multiple of g and no real_len cut, the flat layout is the
    segmented one seen flat: the two wrapper families agree exactly."""
    B, H, S, g, D = 1, 2, 3, 16, 8
    q, k, v, do = (_t(_data(30 + i, B, H, S * g, D)) for i in range(4))
    out, lse = fk.flat_fwd(q, k, v, g, S * g)
    seg = lambda x: x.reshape(B, H, S, g, D)  # noqa: E731
    out5, lse5 = fk.flash_fwd(seg(q), seg(k), seg(v))
    torch.testing.assert_close(out, out5.reshape(out.shape), rtol=0, atol=0)
    torch.testing.assert_close(lse, lse5.reshape(lse.shape), rtol=0, atol=0)
    delta = (do * out).sum(-1)
    flat = (fk.flat_bwd_dq(q, k, v, do, lse, delta, g, S * g), *fk.flat_bwd_dkv(q, k, v, do, lse, delta, g, S * g))
    segd = (fk.flash_bwd_dq(seg(q), seg(k), seg(v), seg(do), lse5, delta.reshape(B, H, S, g)),
            *fk.flash_bwd_dkv(seg(q), seg(k), seg(v), seg(do), lse5, delta.reshape(B, H, S, g)))
    for a, b in zip(flat, segd):
        torch.testing.assert_close(a, b.reshape(a.shape), rtol=0, atol=0)


def _kv_valid(B, H, L, seed=40):
    counts = np.random.default_rng(seed).integers(1, L + 1, size=(B, H)).astype(np.int32)
    counts[0, 0] = 0
    return counts


@pytest.mark.parametrize("causal,valid", [(False, False), (False, True), (True, False)])
def test_flash_attention_matches_jax(causal, valid):
    """The [B, L, H, D] entry against the JAX kernel entry (interpret mode)
    and the JAX plain path, forward and gradients."""
    B, L, H, D = 2, 50, 3, 16
    q, k, v, do = (_data(41 + i, B, L, H, D) for i in range(4))
    kv = _kv_valid(B, H, L) if valid else None

    def jax_loss(use_kernel):
        def f(a, b, c):
            if use_kernel:
                out, _ = pf.pallas_flash_attention(a, b, c, is_causal=causal, kv_len=kv, interpret=True)
            else:
                out, _ = jfa.flash_attention(a, b, c, is_causal=causal, kv_valid_len=kv, use_pallas=False)
            return (out * jnp.asarray(do)).sum()
        return f

    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    out, lse = port_fa.flash_attention(qt, kt, vt, is_causal=causal,
                                       kv_valid_len=None if kv is None else torch.from_numpy(kv))
    (out * _t(do)).sum().backward()
    ours = (qt.grad.numpy(), kt.grad.numpy(), vt.grad.numpy())
    for use_kernel in (True, False):
        ref_out, ref_lse = (pf.pallas_flash_attention(*(jnp.asarray(x) for x in (q, k, v)), is_causal=causal,
                                                      kv_len=kv, interpret=True) if use_kernel else
                            jfa.flash_attention(*(jnp.asarray(x) for x in (q, k, v)), is_causal=causal,
                                                kv_valid_len=kv, use_pallas=False))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), **FWD_TOL)
        covered = np.asarray(ref_lse) > -1e7  # the two JAX tiers' sentinels differ
        np.testing.assert_allclose(lse.numpy()[covered], np.asarray(ref_lse)[covered], atol=1e-5, rtol=1e-6)
        grads = jax.jit(jax.grad(jax_loss(use_kernel), argnums=(0, 1, 2)))(*(jnp.asarray(x) for x in (q, k, v)))
        for name, a, b in zip(("dq", "dk", "dv"), ours, grads):
            np.testing.assert_allclose(a, np.asarray(b), err_msg=f"{name} kernel={use_kernel}", **GRAD_TOL)


def test_flash_attention_bias_takes_the_plain_path():
    B, L, H, D = 1, 20, 2, 8
    q, k, v = (_data(50 + i, B, L, H, D) for i in range(3))
    bias = _data(53, B, H, L, L)
    out, lse = port_fa.flash_attention(_t(q), _t(k), _t(v), bias=_t(bias))
    ref_out, ref_lse = jfa.flash_attention(*(jnp.asarray(x) for x in (q, k, v)), bias=jnp.asarray(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **FWD_TOL)
    with pytest.raises(ValueError, match="bias"):
        port_fa.flash_attention(_t(q), _t(k), _t(v), bias=_t(bias), use_pallas=True)


def test_flash_attention_counts_kernel_calls(monkeypatch):
    """Without a bias the entry goes through the kernel wrapper at every
    length (no TPU minimum), with one it does not."""
    calls = []
    real = fk.flash_fwd
    monkeypatch.setattr(fk, "flash_fwd", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    x = torch.randn(1, 4, 2, 8)
    port_fa.flash_attention(x, x, x)
    port_fa.partial_attention(x, x, x)
    port_fa.flash_attention(x, x, x, bias=torch.zeros(1, 2, 4, 4))
    assert len(calls) == 2


def test_partial_attention_and_combine_partials_match_jax():
    """Two partials over disjoint key chunks, each against the JAX entry,
    merged by the re-exported combine_partials into the full softmax."""
    B, L, H, D = 1, 24, 2, 8
    q, k, v = (_data(60 + i, B, L, H, D) for i in range(3))
    kv = _kv_valid(1, H, 12, seed=61)
    halves = []
    for lo, counts in ((0, kv), (12, None)):
        ks, vs = k[:, lo:lo + 12], v[:, lo:lo + 12]
        ours = port_fa.partial_attention(_t(q), _t(ks), _t(vs),
                                         kv_valid_len=None if counts is None else torch.from_numpy(counts))
        ref = jfa.partial_attention(*(jnp.asarray(x) for x in (q, ks, vs)), kv_valid_len=counts, use_pallas=False)
        np.testing.assert_allclose(ours[0].numpy(), np.asarray(ref[0]), **FWD_TOL)
        halves.append(ours)
    assert port_fa.combine_partials is port_attention.combine_partials
    out, lse = port_fa.combine_partials(*halves[0], *halves[1])
    key_ok = np.ones((B, H, L), bool)
    key_ok[:, :, :12] = np.arange(12)[None, None, :] < kv[..., None]
    bias = np.where(key_ok[:, :, None, :], 0.0, -1e30).astype(np.float32)
    full = jfa.flash_attention(*(jnp.asarray(x) for x in (q, k, v)), bias=jnp.asarray(np.broadcast_to(
        bias, (B, H, L, L))))
    np.testing.assert_allclose(out.numpy(), np.asarray(full[0]), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(full[1]), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("dtype,affine", [("float32", True), ("bfloat16", True), ("float32", False)])
def test_rmsnorm_matches_jax(dtype, affine):
    dim = 24
    x = _data(70, 3, 5, dim)
    jmodel = JaxRMSNorm(dim=dim, elementwise_affine=affine)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    params = jmodel.init(jax.random.PRNGKey(0), xj)
    if affine:
        params = {"params": {"weight": jnp.asarray(1.0 + _data(71, dim))}}
    ref = jmodel.apply(params, xj)
    norm = RMSNorm(dim, elementwise_affine=affine)
    if affine:
        norm.load_state_dict(state_dict_from_flax_params(params["params"]), strict=True)
        assert list(norm.state_dict()) == ["weight"]
    out = norm(_t(x, getattr(torch, dtype)))
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(out.detach()), _np(ref), **(FWD_TOL if dtype == "float32" else BF16_TOL))
