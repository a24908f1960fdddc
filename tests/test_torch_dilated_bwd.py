"""The port's dilated-branch backward held against the JAX package.

dq/dk/dv of the port's branch op (the backward kernels' plain versions,
through autograd) against ``jax.vjp`` of the JAX branch op with its Pallas
kernels in interpret mode. Inputs and cotangents come from a numpy seed.
fp32 tolerance 1e-4: both sides compute in fp32 and differ in the order of
sums.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test process)

from gigapath_tpu.ops import pallas_dilated as jpd
from gigapath_tpu_torch.ops import dilated_kernels as dk
from gigapath_tpu_torch.ops.dilated_attention import DilatedAttention, dilated_attention

from test_torch_dilated import BRANCH_CASES, DH, E, FLAGS, H, SCHEDULE, _data

TOL = dict(atol=1e-4, rtol=1e-4)


def _jax_branch_grads(q, k, v, do, sl, r, valid_len_dyn=None, **kw):
    """dq, dk, dv of the JAX branch op (interpret mode), lse cotangent 0."""

    def f(a, b, c):
        return jpd.dilated_branch_attention(
            a, b, c, sl=sl, r=r, num_heads=H, interpret=True, flags=FLAGS,
            valid_len_dyn=valid_len_dyn, **kw,
        )

    @jax.jit
    def grads(a, b, c, d):
        (out, lse), vjp = jax.vjp(f, a, b, c)
        return vjp((d, jnp.zeros_like(lse)))

    return [np.asarray(g) for g in grads(*(jnp.asarray(x) for x in (q, k, v, do)))]


def _port_branch_grads(q, k, v, do, sl, r, valid_len_dyn=None, **kw):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = dk.dilated_branch_attention(
        qt, kt, vt, sl, r, H,
        valid_len_dyn=None if valid_len_dyn is None else torch.from_numpy(valid_len_dyn), **kw,
    )
    assert not lse.requires_grad  # the lse output takes no gradient
    out.backward(torch.from_numpy(do))
    return [t.grad.numpy() for t in (qt, kt, vt)]


def _assert_grads_close(ours, ref):
    for name, a, b in zip(("dq", "dk", "dv"), ours, ref):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)


@pytest.mark.parametrize("L,sl,r,rl", BRANCH_CASES)
def test_branch_grads_match_jax(L, sl, r, rl):
    q, k, v, do = (_data(s, 2, L, E) for s in (20, 21, 22, 23))
    ours = _port_branch_grads(q, k, v, do, sl, r, real_len=rl)
    ref = _jax_branch_grads(q, k, v, do, sl, r, real_len=rl)
    _assert_grads_close(ours, ref)
    # lanes the branch does not cover get exact-zero gradients
    g = min(sl, L)
    off_band = ((np.arange(L) % g) % r)[:, None] != (np.arange(E) // DH // (H // r))[None, :]
    for grad in ours:
        assert not grad[:, off_band].any()


def test_branch_grads_causal_match_jax():
    L, sl, r = 300, 128, 2
    q, k, v, do = (_data(s, 1, L, E) for s in (24, 25, 26, 27))
    ours = _port_branch_grads(q, k, v, do, sl, r, real_len=280, is_causal=True)
    ref = _jax_branch_grads(q, k, v, do, sl, r, real_len=280, is_causal=True)
    _assert_grads_close(ours, ref)


@pytest.mark.parametrize("vl", [[300, 157], [211, 0]], ids=["ragged", "fully_masked_row"])
def test_branch_grads_per_row_valid_len_match_jax(vl):
    """Per-row valid lengths; a row with no valid key at all (every cell's
    kvlen 0, lse at the sentinel) gets exact-zero dk and dv and finite dq."""
    L, sl, r = 300, 64, 2
    q, k, v, do = (_data(s, 2, L, E) for s in (28, 29, 30, 31))
    vl = np.array(vl, np.int32)
    ours = _port_branch_grads(q, k, v, do, sl, r, valid_len_dyn=vl)
    ref = _jax_branch_grads(q, k, v, do, sl, r, valid_len_dyn=jnp.asarray(vl))
    _assert_grads_close(ours, ref)
    for grad in ours:
        assert np.isfinite(grad).all()
    if vl[1] == 0:
        assert not ours[0][1].any() and not ours[1][1].any() and not ours[2][1].any()


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_reference_matches_autograd_of_fwd_reference(causal):
    """The packed backward's plain version equals autograd through the
    forward's plain version, cells with kvlen 0 and partial tiles included."""
    B, S, r, hb, Mp, Dh = 2, 2, 2, 3, 64, 8
    q6, k6, v6, do6 = (torch.from_numpy(_data(s, B, S, r, hb, Mp, Dh)) for s in (32, 33, 34, 35))
    kvlen = torch.tensor([[[0, 17], [64, 40]], [[5, 0], [33, 64]]], dtype=torch.int32)
    leaves = [x.clone().requires_grad_() for x in (q6, k6, v6)]
    out6, lse5 = dk.dilated_branch_fwd_reference(*leaves, kvlen, causal)
    out6.backward(do6)
    delta = (do6 * out6.detach()).sum(-1)
    dq = dk.dilated_branch_bwd_dq(q6, k6, v6, do6, lse5.detach(), delta, kvlen, causal)
    dk6, dv6 = dk.dilated_branch_bwd_dkv(q6, k6, v6, do6, lse5.detach(), delta, kvlen, causal)
    for ours, leaf in zip((dq, dk6, dv6), leaves):
        torch.testing.assert_close(ours, leaf.grad, atol=1e-5, rtol=1e-5)
    # cells without a valid key: exact zeros; keys past kvlen: exact zeros
    assert not dq[0, 0, 0].any() and not dk6[1, 0, 1].any() and not dv6[1, 0, 1].any()
    assert not dk6[0, 0, 1, :, 17:].any() and not dv6[0, 0, 1, :, 17:].any()


def test_bwd_wrappers_take_the_plain_version_only_on_the_cpu():
    """A tensor on any other device goes to the kernel path, which refuses
    what is not a CUDA tensor instead of computing it in plain PyTorch."""
    shape = (1, 1, 1, 2, 64, 8)
    q6 = torch.empty(shape, device="meta")
    lse = torch.empty(shape[:-1], device="meta")
    kvlen = torch.empty((1, 1, 1), dtype=torch.int32, device="meta")
    before = dict(dk.LAUNCHES)
    for fn in (dk.dilated_branch_bwd_dq, dk.dilated_branch_bwd_dkv):
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            fn(q6, q6, q6, q6, lse, lse, kvlen)
    assert dk.LAUNCHES == before


def test_dilated_attention_grads_match_jax_with_detached_fusion_weights():
    """The multi-branch op's gradients: the fusion softmax weights are
    constants of the backward on both sides."""
    from gigapath_tpu.ops.dilated_attention import dilated_attention as jax_dilated_attention

    L = 300
    q, k, v, do = (_data(s, 1, L, H, DH) for s in (36, 37, 38, 39))
    vl = 250
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    dilated_attention(*leaves, *SCHEDULE, valid_len=vl).backward(torch.from_numpy(do))

    @jax.jit
    def grads(a, b, c, d):
        _, vjp = jax.vjp(lambda x, y, z: jax_dilated_attention(x, y, z, *SCHEDULE, valid_len=vl), a, b, c)
        return vjp(d)

    ref = grads(*(jnp.asarray(x) for x in (q, k, v, do)))
    for name, a, b in zip(("dq", "dk", "dv"), leaves, ref):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), err_msg=name, **TOL)


def test_attention_dropout_is_refused():
    """Attention dropout routes as in the JAX package: with the default
    attention function each branch runs the plain attention with dropout
    in training mode; a custom ``attn_fn`` with dropout is refused."""
    x = torch.randn(1, 32, E)
    layer = DilatedAttention(E, H, [32], [1], dropout=0.1).train()
    assert layer(x, x, x).shape == x.shape
    custom = DilatedAttention(E, H, [32], [1], dropout=0.1, attn_fn=lambda *a, **kw: None).train()
    with pytest.raises(NotImplementedError, match="custom attn_fn"):
        custom(x, x, x)


def _lanes(x: torch.Tensor):
    """[B, S, r, hb, M] -> JAX's [B, S, r, M, LANES], band head t in lane t."""
    hb = x.shape[3]
    x = x.permute(0, 1, 2, 4, 3).numpy()
    return jnp.asarray(np.pad(x, ((0, 0),) * 4 + ((0, jpd.LANES - hb),)))


@functools.partial(jax.jit, static_argnums=(7, 8, 9))
def _jax_bwd_impl(q6, k6, v6, do6, lse, delta, kvlen, causal, hb, block):
    Dh = q6.shape[-1]
    return jpd._bwd_impl(q6, k6, v6, do6, lse, delta, kvlen, causal, Dh**-0.5, hb, Dh, block, block, True)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_serial_bwd_bf16_matches_jax_bwd_impl(causal):
    """Row 7's function past one key tile, the one the tensor-core dq and
    dkv are held to on the card: ``dilated_branch_bwd_reference`` and JAX's
    serial ``_bwd_impl`` (interpret mode, 128-row blocks) on the same packed
    bf16 q, k, v, dO and the same lse and delta (from one forward; JAX's
    lse and delta are [B, S, r, M, LANES] with band head t in lane t), at m
    = 256 (four 64-key tiles) with ragged counts and an empty cell. Both
    recompute p in fp32 from the lse with unrounded q, round ds to bf16
    before ds.K and keep p and ds fp32 for dK and dV, so they differ only in
    the order of fp32 sums and the last bf16 rounding: dq, dk and dv agree
    to 5e-3 of their max (read: at most 1.5e-3 full, 1.7e-3 causal, under
    one bf16 ulp at the max). The forward's key-tile placement is kept out
    of the comparison."""
    B, S, r, hb, M, Dh = 2, 1, 2, 4, 256, 16
    q6, k6, v6, do6 = (torch.from_numpy(2 * _data(s, B, S, r, hb, M, Dh)).to(torch.bfloat16)
                       for s in (90, 91, 92, 93))
    kvlen = torch.tensor([[[256, 200]], [[131, 0]]], dtype=torch.int32)
    out6, lse5 = dk.dilated_branch_fwd_reference(q6, k6, v6, kvlen, causal)
    delta = (do6.float() * out6.float()).sum(-1)
    ours = dk.dilated_branch_bwd_reference(q6, k6, v6, do6, lse5, delta, kvlen, causal)

    bf = [jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q6, k6, v6, do6)]
    ref = _jax_bwd_impl(*bf, _lanes(lse5), _lanes(delta), jnp.asarray(kvlen.numpy()), causal, hb, 128)
    for name, a, b in zip(("dq", "dk", "dv"), ours, ref):
        b = np.asarray(b.astype(jnp.float32))
        err = float(np.abs(a.float().numpy() - b).max() / np.abs(b).max())
        assert err <= 5e-3, (name, err)
    assert not any(g[1, 0, 1].any() for g in ours)  # the cell with no valid key


@functools.partial(jax.jit, static_argnums=(7, 8))
def _jax_bwd_impl_pipe(q6, k6, v6, do6, lse, delta, kvlen, hb, block):
    Dh = q6.shape[-1]
    return jpd._bwd_impl_pipe(q6, k6, v6, do6, lse, delta, kvlen, Dh**-0.5, hb, Dh, block, block, True)


def _max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_pipe_bwd_bf16_matches_jax_bwd_impl_pipe():
    """Row 8's function past one key tile, the one the pipelined tensor-core
    dq and dkv are held to on the card: ``dilated_branch_bwd_pipe_reference``
    and JAX's ``_bwd_impl_pipe`` (interpret mode, 128-row blocks) on the same
    packed bf16 q, k, v, dO and the same lse and delta (from one forward, in
    JAX's [B, S, r, M, LANES] lane layout), at m = 256 (four 64-key tiles)
    with ragged counts and an empty cell, non-causal. Both form the logits
    from bf16(q*scale*log2(e)), round ds to bf16 before ds.K and keep p and
    ds fp32 against unscaled q and fp32 dO for dK and dV, so they differ
    only in the order of fp32 sums and the last bf16 rounding: dq, dk and dv
    agree to 3e-3 of their max (read: 2.7e-4, 7.3e-5 and 1.1e-6). The
    forward's key-tile placement is kept out of the comparison. The serial
    plain backward, whose logits take q unrounded, differs from it on these
    inputs by a few bf16 ulps at the max (read: 1.5e-2, 1.6e-2 and 2.6e-2 of
    the max), where on fp32 copies of the same inputs, on which the rounding
    is a no-op, the two agree to the order of fp32 sums (read: bit-equal)."""
    B, S, r, hb, M, Dh = 2, 1, 2, 4, 256, 16
    q6, k6, v6, do6 = (torch.from_numpy(2 * _data(s, B, S, r, hb, M, Dh)).to(torch.bfloat16)
                       for s in (94, 95, 96, 97))
    kvlen = torch.tensor([[[256, 200]], [[131, 0]]], dtype=torch.int32)
    out6, lse5 = dk.dilated_branch_fwd_pipe_reference(q6, k6, v6, kvlen)
    delta = (do6.float() * out6.float()).sum(-1)
    ours = dk.dilated_branch_bwd_pipe_reference(q6, k6, v6, do6, lse5, delta, kvlen)

    bf = [jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q6, k6, v6, do6)]
    ref = _jax_bwd_impl_pipe(*bf, _lanes(lse5), _lanes(delta), jnp.asarray(kvlen.numpy()), hb, 128)
    errs = {name: _max_rel(a.float(), b.astype(jnp.float32)) for name, a, b in zip(("dq", "dk", "dv"), ours, ref)}
    assert max(errs.values()) <= 3e-3, errs
    assert not any(g[1, 0, 1].any() for g in ours)  # the cell with no valid key

    # the rounded-q logits are exercised: pipelined vs serial plain backward
    # in bf16, against the same pair on fp32 copies of the inputs
    serial = dk.dilated_branch_bwd_reference(q6, k6, v6, do6, lse5, delta, kvlen)
    f32 = [x.float() for x in (q6, k6, v6, do6)]
    f32_pair = (dk.dilated_branch_bwd_pipe_reference(*f32, lse5, delta, kvlen),
                dk.dilated_branch_bwd_reference(*f32, lse5, delta, kvlen))
    bf16_diff = min(_max_rel(a.float(), b.float()) for a, b in zip(ours, serial))
    f32_diff = max(_max_rel(a, b) for a, b in zip(*f32_pair))
    assert f32_diff <= 1e-6 and bf16_diff >= 1e-3, (bf16_diff, f32_diff)
