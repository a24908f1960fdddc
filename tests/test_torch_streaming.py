"""The port's streaming chunked prefill held against the JAX package on the
CPU.

The port's chunk-pair op runs its plain version here (the CUDA kernels run
only on the card, where ``chip_smoke.py`` holds them against it). Inputs
come from numpy seeds; weights from the JAX model's init, handed to the port
through ``state_dict_from_flax_params``. Tolerances (fp32): the pair partial
1e-5 against both JAX tiers (the jnp tier and the Pallas kernel in
interpret mode), lse on covered rows only (the tiers' fully-masked
sentinels differ); gradients 1e-4; the streaming session 1e-5 against the
JAX session and the port's dense model. Out-of-order delivery and
export/restore are bit-exact.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test process)

from gigapath_tpu.models.slide_encoder import LongNetViT as JaxLongNetViT
from gigapath_tpu.models.streaming_encoder import streaming_forward as jax_streaming_forward
from gigapath_tpu.ops.flash_attention import combine_partials as jax_combine_partials
from gigapath_tpu.ops import pallas_streaming as jps
from gigapath_tpu.ops.pallas_streaming import pallas_pair_partial
from gigapath_tpu.ops import streaming_prefill as jsp
from gigapath_tpu_torch.models import slide_encoder as port_se
from gigapath_tpu_torch.models.streaming_encoder import StreamingEncoderSession, check_streamable, streaming_forward
from gigapath_tpu_torch.ops import streaming_kernels as sk
from gigapath_tpu_torch.ops import streaming_prefill as psp
from gigapath_tpu_torch.ops.attention import combine_partials
from gigapath_tpu_torch.ops.dilated_attention import dilated_attention
from gigapath_tpu_torch.utils.convert import state_dict_from_flax_params

COVERED = -5e7  # a real lse is O(10); both tiers' fully-masked sentinels lie far below

# (g, r, q0, k0, cq, ck, valid, H): the mask regimes of
# tests/test_pallas_streaming.py (local, offset with a ragged valid tail,
# uneven H % r, ragged cq != ck, disjoint segments), a ratio that does not
# divide H, and a block inside one segment of a g % r != 0 branch (the
# kernels' shifted phase lattice). Most share one shape: each new shape
# costs the JAX side a compile.
PAIR_CASES = [
    (64, 1, 0, 0, 64, 64, None, 4),
    (128, 2, 64, 0, 64, 64, 100, 4),
    (64, 2, 0, 64, 64, 64, None, 6),
    (128, 4, 128, 0, 48, 64, 150, 4),
    (64, 1, 0, 64, 64, 64, None, 4),
    (64, 3, 0, 16, 64, 64, 50, 4),
    (30, 4, 35, 30, 20, 25, None, 4),
]


def _blk(rng, c, H, D=8):
    return rng.normal(size=(1, c, H, D)).astype(np.float32)


def _t(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


def _j(*xs):
    return tuple(jnp.asarray(x) for x in xs)


@pytest.mark.parametrize("g,r,q0,k0,cq,ck,valid,H", PAIR_CASES)
def test_pair_partial_matches_both_jax_tiers(g, r, q0, k0, cq, ck, valid, H):
    rng = np.random.default_rng(0)
    q, k, v = _blk(rng, cq, H), _blk(rng, ck, H), _blk(rng, ck, H)
    out, lse = sk.pair_partial(*_t(q, k, v), q0, k0, segment_len=g, ratio=r, valid_len=valid)
    out, lse = out.numpy(), lse.numpy()
    o_jnp, l_jnp = jsp.pair_partial_attention(
        *_j(q, k, v), jnp.int32(q0), jnp.int32(k0), segment_len=g, ratio=r, valid_len=valid)
    o_pl, l_pl = pallas_pair_partial(
        *_j(q, k, v), jnp.int32(q0), jnp.int32(k0), segment_len=g, ratio=r, valid_len=valid,
        interpret=True)
    covered = np.asarray(l_jnp) > COVERED
    assert ((lse > COVERED) == covered).all() and ((np.asarray(l_pl) > COVERED) == covered).all()
    for o_ref, l_ref in ((o_jnp, l_jnp), (o_pl, l_pl)):
        np.testing.assert_allclose(out, np.asarray(o_ref), atol=1e-5, rtol=0)
        np.testing.assert_allclose(lse[covered], np.asarray(l_ref)[covered], atol=1e-5, rtol=0)
    # a fully masked row: out exactly 0, the lse far below any real one
    assert not out.transpose(0, 2, 1, 3)[~covered].any()
    # the kernels' phase lattice holds every row and key the mask admits
    mask = sk.pair_mask(q0, cq, k0, ck, g, r, valid, H).numpy()
    for off, c, rows_seen in ((q0, cq, mask.any(axis=2)), (k0, ck, mask.any(axis=1))):
        step, shift = sk.lattice(off, c, g, r)
        for h in range(H):
            phase = h // -(-H // r)
            rows = np.nonzero(rows_seen[h])[0]
            assert ((off + rows - phase - shift) % step == 0).all()


@pytest.mark.parametrize("case", [0, 1, 5])
def test_pair_grads_through_the_fold_match_jax(case):
    """Gradients through one fold step (combine_partials differentiates
    through the pair's lse, so the dlse path of the backward is exercised),
    against jax.grad of the JAX fold's jnp tier, 1e-4; the first case also
    against the Pallas tier's custom VJP in interpret mode."""
    g, r, q0, k0, cq, ck, valid, H = PAIR_CASES[case]
    rng = np.random.default_rng(1)
    q, k, v = _blk(rng, cq, H), _blk(rng, ck, H), _blk(rng, ck, H)
    acc_o = 0.1 * _blk(rng, cq, H)
    acc_l = rng.normal(size=(1, H, cq)).astype(np.float32)  # a live accumulator
    valid_int = valid if valid is not None else q0 + k0 + 512

    def jax_grads(flags):
        def f(q_, k_, v_):
            o, l = jsp.fold_pair(
                jnp.asarray(acc_o), jnp.asarray(acc_l), q_, k_, v_, jnp.int32(q0), jnp.int32(k0),
                jnp.int32(valid_int), segment_len=g, ratio=r, flags=flags)
            return (o.astype(jnp.float32) ** 2).sum() + (l ** 2).sum()

        return jax.grad(f, argnums=(0, 1, 2))(*_j(q, k, v))

    qt, kt, vt = (x.requires_grad_() for x in _t(q, k, v))
    o, l = psp.fold_pair(*_t(acc_o, acc_l), qt, kt, vt, q0, k0, valid_int, segment_len=g, ratio=r)
    ((o.float() ** 2).sum() + (l ** 2).sum()).backward()
    refs = [jax_grads(None)]
    if case == 0:
        from gigapath_tpu.ops.pallas_dilated import PipelineFlags

        refs.append(jax_grads(PipelineFlags(fold_pallas=True)))
    for ref in refs:
        for name, ours, want in zip("qkv", (qt.grad, kt.grad, vt.grad), ref):
            np.testing.assert_allclose(ours.numpy(), np.asarray(want), atol=1e-4, rtol=0, err_msg=f"d{name}")


def test_backward_plain_version_matches_autograd_of_the_forward():
    """The backward's plain version (the kernels' spec) against autograd of
    the forward's plain version, with a nonzero dlse and a fully masked
    row range (its gradients exactly 0)."""
    g, r, q0, k0, cq, ck, valid, H = 32, 2, 20, 0, 24, 40, 35, 4
    rng = np.random.default_rng(2)
    q, k, v, do = (torch.from_numpy(x) for x in (_blk(rng, cq, H), _blk(rng, ck, H), _blk(rng, ck, H),
                                                 _blk(rng, cq, H)))
    dlse = torch.from_numpy(rng.normal(size=(1, H, cq)).astype(np.float32))
    qa, ka, va = (x.clone().requires_grad_() for x in (q, k, v))
    out, lse = sk.stream_pair_fwd_reference(qa, ka, va, q0, k0, g, r, valid)
    torch.autograd.backward((out, lse), (do, dlse))
    delta = (do * out.detach()).sum(-1).transpose(1, 2) - dlse
    dq, dk, dv = sk.stream_pair_bwd_reference(q, k, v, do, lse.detach(), delta, q0, k0, g, r, valid)
    for name, ours, want in (("dq", dq, qa.grad), ("dk", dk, ka.grad), ("dv", dv, va.grad)):
        torch.testing.assert_close(ours, want, atol=1e-5, rtol=1e-5, msg=name)
    covered = (lse > COVERED).transpose(1, 2)  # [1, cq, H]
    assert not dq[~covered].any()


@functools.partial(jax.jit, static_argnums=(7, 8))
def _jax_pair_bwd_impl(info, q, k, v, lse, delta, do, g, r):
    return jps._bwd_impl(info, q, k, v, lse, delta, do, g, r, 128, 128, True)


# (g, r, q0, k0, valid): segment boundaries inside 64-row and 64-key tiles;
# a g % r != 0 branch with both blocks inside segment 1 (a shifted phase
# lattice) and a ragged valid bound
BF16_PAIR_CASES = [(96, 1, 0, 0, None), (301, 2, 301, 301, 501)]


@pytest.mark.parametrize("g,r,q0,k0,valid", BF16_PAIR_CASES, ids=["seg_in_tile", "shift_ragged"])
def test_pair_bwd_bf16_matches_jax_bwd_impl(g, r, q0, k0, valid):
    """The function the tensor-core dq and dkv are held to on the card:
    ``stream_pair_bwd_reference`` against the Pallas ``_bwd_impl``
    (interpret mode, 128-row blocks) on the same bf16 q, k, v and dO and the
    same lse and delta (from one plain forward, a nonzero dlse folded in),
    past one 64-row and one 64-key tile (cq = ck = 256). Both recompute p in
    fp32 from the lse with unrounded q, round ds to bf16 before ds.K and
    keep p and ds fp32 for dK and dV, so dq, dk and dv agree to 5e-3 of
    their max and at least 99 % of dq's elements are bit-equal (read: dq
    2.0e-4 and 1.3e-3 of its max, 99.98 % and 99.99 % bit-equal; without
    the rounding of ds, and lse and delta from the jnp tier's forward,
    3.1e-3 and 5.4e-3, 60 % and 80 %)."""
    H, D, c = 4, 16, 256
    rng = np.random.default_rng(7)
    q, k, v, do = (torch.from_numpy(2 * _blk(rng, c, H, D)).to(torch.bfloat16) for _ in range(4))
    dlse = torch.from_numpy(rng.normal(size=(1, H, c)).astype(np.float32))
    out, lse = sk.stream_pair_fwd_reference(q, k, v, q0, k0, g, r, valid)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2) - dlse
    ours = sk.stream_pair_bwd_reference(q, k, v, do, lse, delta, q0, k0, g, r, valid)

    info = jnp.asarray([q0, k0, valid if valid is not None else 2**31 - 1, c, c], jnp.int32)
    bf = [jnp.asarray(x.float().numpy(), jnp.bfloat16).transpose(0, 2, 1, 3) for x in (q, k, v, do)]
    ref = _jax_pair_bwd_impl(info, *bf[:3], jnp.asarray(lse.numpy()), jnp.asarray(delta.numpy()), bf[3], g, r)
    for name, a, b in zip(("dq", "dk", "dv"), ours, ref):
        a = a.float().numpy()
        b = np.asarray(b.astype(jnp.float32)).transpose(0, 2, 1, 3)
        err = float(np.abs(a - b).max() / np.abs(b).max())
        assert err <= 5e-3, (name, err)
        if name == "dq":
            assert (a == b).mean() >= 0.99, float((a == b).mean())


@functools.partial(jax.jit, static_argnums=(4, 5, 6))
def _jax_pair_fwd_impl(info, q, k, v, g, r, block_k):
    return jps._fwd_impl(info, q, k, v, g, r, 128, block_k, True)


# (g, r, q0, k0, valid, c, block_k): one 64-key tile; four key tiles against
# one JAX block, segment boundaries inside them; a g % r != 0 branch with
# both blocks inside segment 1 (a shifted phase lattice) and a ragged valid
# bound, whose 128-row JAX blocks hold the port's 64-key lattice tiles
BF16_FWD_CASES = [(96, 1, 0, 0, None, 64, 128), (96, 1, 0, 0, None, 256, 1024), (301, 2, 301, 301, 501, 256, 128)]


@pytest.mark.parametrize("g,r,q0,k0,valid,c,block_k", BF16_FWD_CASES, ids=["one_tile", "seg_in_tile", "shift_ragged"])
def test_pair_fwd_bf16_matches_jax_fwd_impl(g, r, q0, k0, valid, c, block_k):
    """The function the tensor-core forward is held to on the card:
    ``stream_pair_fwd_reference`` against the Pallas ``_fwd_impl``
    (interpret mode) on the same bf16 q, k and v. Both round q * scale *
    log2(e) and p to bf16 and run a base-2 online softmax; the running max
    moves per 64-key lattice tile here and per JAX key block there. Where
    the two visit the same keys together (``one_tile``, ``shift_ragged``)
    at least 99 % of out is bit-equal and the rest within 1e-6 of its max
    (read: 99.98 % and 100 %, 1.1e-9 and 0); where four tiles meet one
    block (``seg_in_tile``) out is within 5e-3 of its max and at least 90 %
    bit-equal (read: 2.0e-3, 93.7 %), and its mean error against the fp32
    answer is within 1.05 times JAX's (read: 0.9994 times). lse on covered
    rows within 1e-5 (read: 1.9e-6). The jnp tier's rounding (fp32 logits,
    the normalized p rounded), the plain version before this test, fails
    it: 46.8 %, 47.3 % and 74.4 % of out bit-equal, lse off by up to
    3.9e-2."""
    H, D = 4, 16
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(2 * _blk(rng, c, H, D)).to(torch.bfloat16) for _ in range(3))
    out, lse = sk.stream_pair_fwd_reference(q, k, v, q0, k0, g, r, valid)
    exact, _ = sk.stream_pair_fwd_reference(q.float(), k.float(), v.float(), q0, k0, g, r, valid)

    info = jnp.asarray([q0, k0, valid if valid is not None else 2**31 - 1, c, c], jnp.int32)
    bf = [jnp.asarray(x.float().numpy(), jnp.bfloat16).transpose(0, 2, 1, 3) for x in (q, k, v)]
    o_pl, l_pl = _jax_pair_fwd_impl(info, *bf, g, r, block_k)
    ours, want = out.float().numpy(), np.asarray(o_pl.astype(jnp.float32)).transpose(0, 2, 1, 3)
    err = float(np.abs(ours - want).max() / np.abs(want).max())
    equal = float((ours == want).mean())
    if block_k == 1024:
        assert err <= 5e-3 and equal >= 0.90, (err, equal)
        exact = exact.numpy()
        ratio = float(np.abs(ours - exact).mean() / np.abs(want - exact).mean())
        assert ratio <= 1.05, ratio
    else:
        assert err <= 1e-6 and equal >= 0.99, (err, equal)
    l_pl = np.asarray(l_pl)
    covered = l_pl > COVERED
    assert covered.any() and ((lse.numpy() > COVERED) == covered).all()
    np.testing.assert_allclose(lse.numpy()[covered], l_pl[covered], atol=1e-5, rtol=0)


def test_wrappers_refuse_tensors_off_the_cpu_and_the_card():
    """On a tensor that is not on the CPU, a wrapper launches its kernel or
    raises: a meta tensor is refused before any build."""
    q = torch.empty((1, 8, 2, 8), device="meta")
    lse = torch.empty((1, 2, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        sk.stream_pair_fwd(q, q, q, 0, 0, 8, 1)
    with pytest.raises(ValueError, match="CUDA"):
        sk.stream_pair_bwd_dq(q, q, q, q, lse, lse, 0, 0, 8, 1)
    with pytest.raises(ValueError, match="CUDA"):
        sk.stream_pair_bwd_dkv(q, q, q, q, lse, lse, 0, 0, 8, 1)
    assert all(n == 0 for n in sk.LAUNCHES.values())


def test_combine_partials_fold_plan_and_chunk_bounds_match_jax():
    rng = np.random.default_rng(3)
    oa, ob = rng.normal(size=(2, 2, 5, 3, 4)).astype(np.float32)
    la, lb = rng.normal(size=(2, 2, 3, 5)).astype(np.float32) * 3
    la[0, 1, 2] = -1e8  # a fully masked partial folds in with weight 0
    out, lse = combine_partials(*_t(oa, la, ob, lb))
    j_out, j_lse = jax_combine_partials(*_j(oa, la, ob, lb))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=1e-6, rtol=1e-6)
    assert out.dtype == torch.float32
    for n, c in ((67, 24), (64, 16), (1, 5), (10241, 2048)):
        bounds = psp.chunk_bounds(n, c)
        assert bounds == jsp.chunk_bounds(n, c)
        for g in (1, 16, 24, 1024, 5792, 10241):
            assert psp.fold_plan(bounds, g) == jsp.fold_plan(bounds, g)
    with pytest.raises(NotImplementedError):
        psp._branch_geometry(100, [30], [4])
    assert psp._branch_geometry(100, [30, 128], [2, 3]) == jsp._branch_geometry(100, [30, 128], [2, 3])


SCHED = ([16, 32, 128], [1, 2, 4])


@pytest.mark.parametrize("L,chunk", [(67, 24), (40, 40)], ids=["ragged_tail", "single_chunk"])
def test_streaming_dilated_attention_matches_jax_and_dense(L, chunk):
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(1, L, 4, 8)).astype(np.float32) for _ in range(3))
    bounds = psp.chunk_bounds(L, chunk)
    blocks = psp.streaming_dilated_attention(
        *([x[:, a:b] for a, b in bounds] for x in _t(q, k, v)), bounds, *SCHED)
    j_blocks = jsp.streaming_dilated_attention(
        *([x[:, a:b] for a, b in bounds] for x in _j(q, k, v)), bounds, *SCHED)
    assert [b.shape[1] for b in blocks] == [b - a for a, b in bounds]
    for ours, want in zip(blocks, j_blocks):
        np.testing.assert_allclose(ours.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    dense = dilated_attention(*_t(q, k, v), *SCHED)
    np.testing.assert_allclose(psp.assemble_dense_fallback(blocks).numpy(), dense.numpy(), atol=1e-5, rtol=0)


def test_streaming_grads_match_the_dense_path():
    """Gradients through the whole fold (the fusion weights detached)
    against the port's dense dilated attention, whose gradients
    tests/test_torch_dilated_bwd.py holds against the JAX package."""
    L, sls, drs = 48, [8, 64], [1, 2]
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(1, L, 2, 8)).astype(np.float32) for _ in range(3))
    bounds = psp.chunk_bounds(L, 16)
    ts = [x.requires_grad_() for x in _t(q, k, v)]
    blocks = psp.streaming_dilated_attention(*([x[:, a:b] for a, b in bounds] for x in ts), bounds, sls, drs)
    sum((blk ** 2).sum() for blk in blocks).backward()
    td = [x.detach().clone().requires_grad_() for x in ts]
    (dilated_attention(*td, sls, drs).float() ** 2).sum().backward()
    for name, ours, dense in zip("qkv", ts, td):
        np.testing.assert_allclose(ours.grad.numpy(), dense.grad.numpy(), atol=1e-4, rtol=0, err_msg=f"d{name}")


# the geometry of tests/test_streaming_prefill.py's model-parity tests
MODEL = dict(in_chans=48, embed_dim=96, depth=2, slide_ngrids=100, segment_length=[16, 32],
             dilated_ratio="[1, 2]", dropout=0.0, drop_path_rate=0.0)


@pytest.fixture(scope="module")
def weights():
    model = JaxLongNetViT(**MODEL)
    return jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4, 48)), jnp.zeros((1, 4, 2)))["params"]


def _port(weights, **kw):
    model = port_se.LongNetViT(**{**MODEL, **kw}).eval()
    model.load_state_dict(state_dict_from_flax_params(weights), strict=True)
    return model


def _slide(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 48)).astype(np.float32),
            rng.uniform(0, 100 * 256, (n, 2)).astype(np.float32))


@pytest.mark.parametrize("global_pool", [False, True], ids=["cls", "global_pool"])
def test_streaming_forward_matches_jax_session_and_port_dense(weights, global_pool):
    x, coords = _slide(6, 37)
    model = _port(weights, global_pool=global_pool)
    ours = streaming_forward(model, x, coords, chunk_tiles=16, all_layer_embed=True)
    want = jax_streaming_forward(JaxLongNetViT(**MODEL, global_pool=global_pool), weights, x, coords,
                                 chunk_tiles=16, all_layer_embed=True)
    with torch.no_grad():
        dense = model(*_t(x[None], coords[None]), all_layer_embed=True)
    assert len(ours) == len(want) == len(dense) == 3
    for i, (o, w, d) in enumerate(zip(ours, want, dense)):
        np.testing.assert_allclose(o.numpy(), np.asarray(w), atol=1e-5, rtol=0, err_msg=f"layer {i} vs JAX")
        np.testing.assert_allclose(o.numpy(), d.numpy(), atol=1e-5, rtol=0, err_msg=f"layer {i} vs dense")
    # the final-LN readout of the last layer
    last = streaming_forward(model, x, coords, chunk_tiles=16)[0]
    with torch.no_grad():
        np.testing.assert_allclose(last.numpy(), model(*_t(x[None], coords[None]))[0].numpy(), atol=1e-5, rtol=0)


def test_out_of_order_restore_and_peek_are_bit_exact(weights):
    x, coords = _slide(7, 41)
    model = _port(weights)

    def session():
        return StreamingEncoderSession(model, 41, chunk_tiles=8, all_layer_embed=True)

    def feed(s, order):
        for i in order:
            a, b = s.tile_bounds[i]
            s.feed(i, x[a:b], coords[a:b])

    base = session()
    feed(base, range(6))
    want = [e.numpy() for e in base.finalize()]
    assert base.folds == sum(sum(len(p) for p in plan)
                             for plan in (psp.fold_plan(base.token_bounds, g) for g in (16, 32))) * 2

    perm = session()
    feed(perm, [4, 1, 5, 0, 3, 2, 2, 0])  # permuted, with duplicates
    assert perm.pending() == []
    for a, b in zip(want, perm.finalize()):
        assert np.array_equal(a, b.numpy())

    first = session()
    feed(first, [0, 3, 1])  # chunk 3 held ahead of the frontier
    assert first.pending() == [2, 4, 5, 3]
    resumed = session()
    resumed.restore_state(first.export_state())
    feed(resumed, [2, 4, 5])
    peek = resumed.peek()
    for a, b, c in zip(want, resumed.finalize(), peek):
        assert np.array_equal(a, b.numpy()) and np.array_equal(a, c.numpy())
    with pytest.raises(RuntimeError, match="missing"):
        session().finalize()


def test_check_streamable_refuses_multiway_and_takes_the_registry():
    cfg = types.SimpleNamespace(multiway=True, extras={})
    with pytest.raises(NotImplementedError, match="multiway"):
        check_streamable(cfg)
    for arch in ("gigapath_slide_enc12l768d", "gigapath_slide_enc_tiny"):
        check_streamable(port_se.create_model_from_registry(arch).encoder.args)


def _head():
    from gigapath_tpu_torch.models.classification_head import get_model

    return get_model(input_dim=24, latent_dim=32, feat_layer="1", n_classes=3,
                     model_arch="gigapath_slide_enc_tiny", device="cpu").eval()


def test_serve_submitter_and_pipeline_entry_match_the_dense_entry():
    from gigapath_tpu_torch.pipeline import (
        run_inference_with_slide_encoder,
        run_inference_with_slide_encoder_streaming,
    )
    from gigapath_tpu_torch.serve.streaming import head_streaming_submitter, streaming_head_logits

    head = _head()
    rng = np.random.default_rng(8)
    n = 45
    feats = rng.normal(size=(n, 24)).astype(np.float32)
    coords = rng.uniform(0, 5000, (n, 2)).astype(np.float32)
    with torch.no_grad():
        dense = head(*_t(feats[None], coords[None])).numpy()
    submitter = head_streaming_submitter(head, chunk_tiles=16)
    submitter.peek_every = 1
    session = submitter.open("s0", n)
    for i, (a, b) in enumerate(session.session.tile_bounds):
        session.feed(i, feats[a:b], coords[a:b])
    logits = streaming_head_logits(head, session.result())
    np.testing.assert_allclose(logits, dense, atol=1e-5, rtol=0)
    assert submitter.served == 1
    assert [p["frontier"] for p in session.peeks] == [1, 2]  # the last chunk is the final result
    assert all(0.0 < p["confidence"] <= 1.0 + 1e-9 for p in session.peeks)

    encoder = head.slide_encoder
    chunks = [types.SimpleNamespace(chunk_id=i, payload=feats[a:b], coords=coords[a:b])
              for i, (a, b) in enumerate(psp.chunk_bounds(n, 8))]
    stream = run_inference_with_slide_encoder_streaming(reversed(chunks), n, encoder, chunk_tiles=8)
    want = run_inference_with_slide_encoder(feats, coords, encoder)
    assert stream.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(stream[key], want[key], atol=1e-5, rtol=0, err_msg=key)
    served = head_streaming_submitter(head, chunk_tiles=8).stream_slide("s1", chunks[::-1], n)
    np.testing.assert_allclose(streaming_head_logits(head, served), logits, atol=1e-5, rtol=0)


def test_submitter_events_trace_spans_and_drift(tmp_path):
    """The submitter's obs wiring: ``stream_open`` / ``stream_peek`` /
    ``stream_result`` events, ``fold`` and ``finalize`` spans on the
    slide's trace context, the confidence histogram, and every final
    embedding folded into the drift sentinel."""
    import json

    from gigapath_tpu_torch.obs.drift import DriftSentinel, EmbeddingSketch
    from gigapath_tpu_torch.obs.metrics import MetricsRegistry
    from gigapath_tpu_torch.obs.reqtrace import RequestTrace, TraceContext
    from gigapath_tpu_torch.obs.runlog import RunLog
    from gigapath_tpu_torch.serve.streaming import StreamingSubmitter

    head = _head()
    rng = np.random.default_rng(10)
    n = 45
    feats = rng.normal(size=(n, 24)).astype(np.float32)
    coords = rng.uniform(0, 5000, (n, 2)).astype(np.float32)
    log = RunLog(str(tmp_path / "run.jsonl"), driver="t", echo=False)
    metrics = MetricsRegistry()
    drift = DriftSentinel(EmbeddingSketch(32), log, every=1, min_count=1)
    submitter = StreamingSubmitter(head.slide_encoder, chunk_tiles=16, runlog=log, drift=drift,
                                   peek_every=1, metrics=metrics)
    trace = RequestTrace("tr-s0", 1, "s0", 0.0)
    ctx = TraceContext(trace, "consumer")
    session = submitter.open("s0", n, trace=ctx)
    for i in (0, 0, 1, 2):  # a duplicate delivery folds once
        a, b = session.session.tile_bounds[i]
        session.feed(i, feats[a:b], coords[a:b])
    session.result()
    log.close()
    events = [json.loads(line) for line in open(log.path)]
    (opened,) = [e for e in events if e["kind"] == "stream_open"]
    assert (opened["slide"], opened["n_tiles"], opened["n_chunks"], opened["chunk_tiles"]) == ("s0", n, 3, 16)
    peeks = [e for e in events if e["kind"] == "stream_peek"]
    assert [p["frontier"] for p in peeks] == [1, 2] and peeks[0]["cos_prev"] is None
    (result,) = [e for e in events if e["kind"] == "stream_result"]
    assert result["peeks"] == 2 and result["confidence_last"] == round(session.peeks[-1]["confidence"], 6)
    assert metrics.snapshot()["histograms"]["serve.stream_confidence"]["count"] == 2
    assert drift.current.count == 1
    names = sorted(sp.name for sp in trace.spans)
    assert names == ["finalize", "fold", "fold", "fold"]


def test_inference_stream_and_exact_paths_write_the_same_verdicts(tmp_path):
    import pandas as pd

    from gigapath_tpu_torch import inference

    rng = np.random.default_rng(9)
    for i in range(2):
        torch.save({"features": torch.from_numpy(rng.normal(size=(10, 24)).astype(np.float32)),
                    "coords": torch.from_numpy(rng.uniform(0, 5000, (10, 2)).astype(np.float32))},
                   tmp_path / f"slide{i}_features.pt")
    head = _head()
    exact = inference.run_inference(head, str(tmp_path), str(tmp_path / "exact.csv"), use_buckets=False)
    stream = inference.run_inference(head, str(tmp_path), str(tmp_path / "stream.csv"), stream=True,
                                     stream_chunk=4)
    assert list(stream["slide_id"]) == list(exact["slide_id"]) == ["slide0", "slide1"]
    assert list(stream["predicted_label"]) == list(exact["predicted_label"])
    np.testing.assert_allclose(stream["confidence"], exact["confidence"], atol=1e-5)
    bucketed = inference.run_inference(head, str(tmp_path), str(tmp_path / "b.csv"), batch_size=2)
    assert list(bucketed["slide_id"]) == list(exact["slide_id"])
    assert list(bucketed["predicted_label"]) == list(exact["predicted_label"])
    np.testing.assert_allclose(bucketed["confidence"], exact["confidence"], atol=1e-5)
    # --prefetch 2 (a loader thread through the dist boundary's memory
    # channel) gives the synchronous loads' verdicts, bit for bit
    prefetched = inference.run_inference(head, str(tmp_path), str(tmp_path / "p.csv"), stream=True,
                                         stream_chunk=4, prefetch=2)
    assert prefetched.equals(stream)

    # the CLI on the flagship head (random weights), --stream, on the CPU
    flagship = tmp_path / "flagship"
    flagship.mkdir()
    for i in range(2):
        torch.save(torch.from_numpy(rng.normal(size=(6 + i, 1536)).astype(np.float32)),
                   flagship / f"big{i}_features.pt")
    out_csv = tmp_path / "cli.csv"
    inference.main(["--model_path", "", "--feature_dir", str(flagship), "--output_file", str(out_csv),
                    "--stream", "--stream-chunk", "4", "--device", "cpu"])
    df = pd.read_csv(out_csv)
    assert list(df["slide_id"]) == ["big0", "big1"]
    assert ((df["confidence"] >= 0.5) & (df["confidence"] <= 1.0)).all()


def test_predict_loads_port_and_reference_checkpoints_and_writes_csv(tmp_path):
    import h5py
    import pandas as pd

    from gigapath_tpu_torch.finetune.predict import _load_params_into_model, predict
    from gigapath_tpu_torch.utils.checkpoint import save_checkpoint

    rng = np.random.default_rng(10)
    root = tmp_path / "h5_files"
    root.mkdir()
    rows = []
    for i in range(3):
        with h5py.File(root / f"s{i}.h5", "w") as f:
            f.create_dataset("features", data=rng.normal(size=(12 + i, 16)).astype(np.float32))
            f.create_dataset("coords", data=rng.integers(0, 2000, (12 + i, 2)).astype(np.float32))
        rows.append({"slide_id": f"s{i}.svs", "label": ["neg", "pos"][i % 2]})
    pd.DataFrame(rows).to_csv(tmp_path / "dataset.csv", index=False)
    (tmp_path / "task.yaml").write_text(
        "name: toy\nsetting: multi_class\nlabel_dict:\n  neg: 0\n  pos: 1\nmax_tiles: 64\nshuffle_tiles: false\n")

    from gigapath_tpu_torch.models.classification_head import get_model

    kw = dict(input_dim=16, latent_dim=32, feat_layer="1", n_classes=2, model_arch="gigapath_slide_enc_tiny",
              device="cpu")
    trained = get_model(seed=3, **kw)
    ckpt = tmp_path / "checkpoint.pt"
    save_checkpoint(str(ckpt), {"params": trained.state_dict()})
    # a reference-style .pt: slide_encoder.* and classifier.* keys, plus one
    # the head lacks
    ref = tmp_path / "reference.pt"
    torch.save({**trained.state_dict(), "slide_encoder.extra": torch.zeros(1)}, ref)
    for path in (ckpt, ref):
        loaded = _load_params_into_model(str(path), get_model(seed=4, **kw))
        for key, value in trained.state_dict().items():
            assert torch.equal(loaded.state_dict()[key], value), key

    df = predict(str(ckpt), str(tmp_path / "dataset.csv"), str(root), str(tmp_path / "task.yaml"),
                 str(tmp_path / "out"), "exp", argv=[
                     "--model_arch", "gigapath_slide_enc_tiny", "--input_dim", "16", "--latent_dim", "32",
                     "--feat_layer", "1", "--device", "cpu", "--dropout", "0.0", "--drop_path_rate", "0.0"])
    written = pd.read_csv(tmp_path / "out" / "toy" / "exp" / "predictions" / "predictions.csv")
    assert list(written["slide_id"]) == list(df["slide_id"]) == ["s0.svs", "s1.svs", "s2.svs"]
    probs = np.stack(df["probabilities"].to_list())
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-6)


def test_guard_no_full_length_tensors():
    """``full_length_avals``, as the JAX guard test: a fold holds no tensor
    carrying the slide length (ops, kernel calls and its own inputs and
    outputs), while the dense forward (the positive control) holds many;
    the JAX guard agrees on the JAX fold."""
    L, cq, H, D = 1027, 128, 4, 8  # L collides with no block, head or feature width
    acc_out, acc_lse = torch.zeros(1, cq, H, D), torch.full((1, H, cq), -1e30)
    q = torch.randn(1, cq, H, D)
    fold = functools.partial(psp.fold_pair, segment_len=L, ratio=2)
    assert psp.full_length_avals(fold, acc_out, acc_lse, q, q, q, 0, 0, L, full_len=L) == []
    jfold = functools.partial(jsp.fold_pair, segment_len=L, ratio=2)
    jq = jnp.zeros((1, cq, H, D), jnp.float32)
    assert jsp.full_length_avals(jfold, jnp.zeros((1, cq, H, D)), jnp.zeros((1, H, cq)), jq, jq, jq,
                                 jnp.int32(0), jnp.int32(0), jnp.int32(L), full_len=L) == []
    qf = torch.randn(1, L, H, D)
    dense = psp.full_length_avals(lambda q, k, v: dilated_attention(q, k, v, [64, L], [1, 2]), qf, qf, qf,
                                  full_len=L)
    assert dense and any(line.startswith("io: ") for line in dense)
    assert any(line.startswith(("pack_phases", "dilated_branch_fwd")) for line in dense)  # kernel calls too
