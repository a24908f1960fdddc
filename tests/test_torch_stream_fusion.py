"""The port's stream-fusion route held against the JAX package on the CPU.

The direct pack/unpack (``pack_direct``), the packed branch op with the
fusion epilogue (``stream_fusion``) and the online dense branch fold
(``streaming_fusion``). Inputs come from a numpy seed; the JAX side runs its
Pallas kernels in interpret mode, the port's wrappers their plain PyTorch
versions. fp32 tolerances: 1e-5 forward and 1e-4 gradients (both sides
compute in fp32 and sum in another order); 1e-6 between the epilogue's
plain version and the port's own dense fusion (the same softmax written
online).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test process)

from gigapath_tpu.models.slide_encoder import LongNetViT as JaxLongNetViT
from gigapath_tpu.ops import pallas_dilated as jpd
from gigapath_tpu.ops.dilated_attention import dilated_attention_fused as jax_dilated_attention_fused
from gigapath_tpu_torch.models.classification_head import get_model
from gigapath_tpu_torch.ops import dilated_kernels as dk
from gigapath_tpu_torch.ops.dilated_attention import dilated_attention

from test_torch_dilated import DH, E, H, _data
from test_torch_finetune import HEAD_KW, SLIDE_KW
from test_torch_slide_encoder import SMALL, _port, inputs, weights  # noqa: F401  (fixtures)

FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
FLAG_ENV = {"GIGAPATH_STREAM_FUSION": "1", "GIGAPATH_PACK_DIRECT": "1"}

# (L, sl, r): single-segment branches (the only ones the direct kernels
# take) with ragged tails, r = 4, 8, 16
DIRECT_CASES = [(300, 512, 4), (300, 300, 8), (211, 1024, 16), (100, 128, 4)]

SCH2 = ([64, 300], [1, 4])
SCH3 = ([32, 128, 512], [1, 2, 8])
SCH5 = ([32, 64, 128, 512, 1024], [1, 2, 4, 8, 16])
ROUTES = {
    "stream_direct": (dk.PipelineFlags(stream_fusion=True, pack_direct=True),
                      jpd.PipelineFlags(stream_fusion=True, pack_direct=True)),
    "stream": (dk.PipelineFlags(stream_fusion=True), jpd.PipelineFlags(stream_fusion=True)),
    "streaming": (dk.PipelineFlags(streaming_fusion=True), jpd.PipelineFlags(streaming_fusion=True)),
}
# (route, schedule, valid_len): 2, 3 and 5 branches, no / a static / a
# per-row valid length, spread over the routes (each case traces the JAX
# route's Pallas kernels in interpret mode, 10-35 s)
ROUTE_CASES = [
    ("stream_direct", SCH5, "per_row"),
    # g = 40 and 96: segment ends off any 16- or 32-token tile of the epilogue
    ("stream_direct", ([40, 96, 512], [1, 2, 4]), "per_row"),
    ("stream_direct", SCH3, 250),
    ("stream", SCH2, None),
    ("streaming", SCH3, "per_row"),
    ("streaming", SCH2, 250),
]
PER_ROW = np.array([300, 157], np.int32)


def _jax_geometry(L, sl, r):
    g, S, _, m, jMp, _ = jpd._branch_geometry(L, E, sl, r)
    return g, S, m, jMp


@pytest.mark.parametrize("L,sl,r", DIRECT_CASES)
def test_pack_phases_direct_matches_jax(L, sl, r):
    x = _data(30, 2, L, E)
    g, S, m, Mp = dk._branch_geometry(L, sl, r)
    assert S == 1
    jMp = _jax_geometry(L, sl, r)[3]
    (ours,) = dk.pack_phases_direct((torch.from_numpy(x),), g, S, r, Mp, H)
    ours = ours.numpy()
    ref = np.asarray(jpd._pack_phases(jnp.asarray(x), g, S, r, jMp, H, True, pack_direct=True))
    assert ours.shape == (2, 1, r, H // r, Mp, DH)
    np.testing.assert_array_equal(ours[:, :, :, :, :m], ref[:, :, :, :, :m])
    assert not ours[:, :, :, :, m:].any()  # packed rows past the dense extent are exact zeros
    # the same function as the row-2 pack
    np.testing.assert_array_equal(ours, dk.pack_phases(torch.from_numpy(x), g, S, r, Mp, H).numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,sl,r", DIRECT_CASES)
def test_pack_phases_direct_three_tensors_match_jax(L, sl, r, dtype):
    """q, k and v packed in one call (one launch on the card) each equal
    the JAX package's direct pack of that tensor alone (it packs them one
    call each); the three differ in content."""
    xs = [_data(seed, 2, L, E) for seed in (41, 42, 43)]
    g, S, m, Mp = dk._branch_geometry(L, sl, r)
    jMp = _jax_geometry(L, sl, r)[3]
    tdtype, jdtype = getattr(torch, dtype), getattr(jnp, dtype)
    ours = dk.pack_phases_direct(tuple(torch.from_numpy(x).to(tdtype) for x in xs), g, S, r, Mp, H)
    assert isinstance(ours, tuple) and len(ours) == 3
    for x, x6 in zip(xs, ours):
        ref = jpd._pack_phases(jnp.asarray(x, jdtype), g, S, r, jMp, H, True, pack_direct=True)
        assert x6.shape == (2, 1, r, H // r, Mp, DH) and x6.dtype == tdtype
        np.testing.assert_array_equal(x6.float().numpy()[..., :m, :], np.asarray(ref.astype(jnp.float32))[..., :m, :])
        assert not x6[..., m:, :].any()
    assert not torch.equal(ours[0], ours[1]) and not torch.equal(ours[1], ours[2])


def test_pack_phases_direct_tensors_keep_their_order():
    """A call's tensors come back packed in the order given, each as its
    own one-tensor call packs it: inputs x, 0 and -x (the pad rows of all
    three are zeros). A bare tensor is refused."""
    L, sl, r = 300, 512, 4
    x = torch.from_numpy(_data(44, 2, L, E))
    g, S, _, Mp = dk._branch_geometry(L, sl, r)
    ins = (x, torch.zeros_like(x), -x)
    ours = dk.pack_phases_direct(ins, g, S, r, Mp, H)
    for t, t6 in zip(ins, ours):
        assert torch.equal(t6, dk.pack_phases_direct((t,), g, S, r, Mp, H)[0])
    assert torch.equal(ours[2], -ours[0]) and not ours[1].any() and ours[0].any()
    with pytest.raises(TypeError):  # a bare tensor would iterate over its batch rows
        dk.pack_phases_direct(x, g, S, r, Mp, H)


@pytest.mark.parametrize("L,sl,r", DIRECT_CASES)
def test_unpack_phases_direct_matches_jax(L, sl, r):
    g, S, m, Mp = dk._branch_geometry(L, sl, r)
    jMp = _jax_geometry(L, sl, r)[3]
    p6 = np.zeros((2, 1, r, H // r, max(Mp, jMp), DH), np.float32)
    p6[:, :, :, :, :m] = _data(31, 2, 1, r, H // r, m, DH)
    ours = dk.unpack_phases_direct(torch.from_numpy(p6[:, :, :, :, :Mp]), L, E, g, S, r).numpy()
    ref = np.asarray(jpd._unpack_phases(jnp.asarray(p6[:, :, :, :, :jMp]), L, E, g, S, r, True, pack_direct=True))
    np.testing.assert_array_equal(ours, ref)
    off_band = (np.arange(L) % r)[:, None] != np.arange(E) // DH // (H // r)
    assert not ours[:, off_band].any()
    np.testing.assert_array_equal(ours, dk.unpack_phases(torch.from_numpy(p6[:, :, :, :, :Mp]), L, E, g, S, r).numpy())


def test_direct_pack_fully_out_of_bounds_tail_block():
    """The geometry of the JAX package's tail-block regression (r = 16,
    L = 2064, E = 768 in fp32: a row-block of the padded tail starts past
    L): the direct pack and unpack still equal the JAX package's and the
    padded-view kernels'."""
    h, dh, r, L, sl = 16, 48, 16, 2064, 4096
    e = h * dh
    x = _data(32, 1, L, e)
    g, S, m, Mp = dk._branch_geometry(L, sl, r)
    _, _, _, jm, jMp, _ = jpd._branch_geometry(L, e, sl, r)
    (p6,) = dk.pack_phases_direct((torch.from_numpy(x),), g, S, r, Mp, h)
    ref6 = np.asarray(jpd._pack_phases(jnp.asarray(x), g, S, r, jMp, h, True, pack_direct=True))
    np.testing.assert_array_equal(p6.numpy()[..., :m, :], ref6[..., :m, :])
    dense = dk.unpack_phases_direct(p6, L, e, g, S, r).numpy()
    padded = np.zeros((1, 1, r, h // r, jMp, dh), np.float32)
    padded[..., :m, :] = p6.numpy()[..., :m, :]
    ref = np.asarray(jpd._unpack_phases(jnp.asarray(padded), L, e, g, S, r, True, pack_direct=True))
    np.testing.assert_array_equal(dense, ref)
    np.testing.assert_array_equal(dense, dk.unpack_phases(p6, L, e, g, S, r).numpy())


def _jax_route(route, schedule, valid):
    """Output and (dq, dk, dv) of JAX ``dilated_attention_fused`` on the
    route's flags, interpret mode, jitted."""
    flags = ROUTES[route][1]
    q, k, v, do = (jnp.asarray(_data(s, 2, 300, H, DH)) for s in (33, 34, 35, 36))

    def run(a, b, c, d, vl):
        def f(a_, b_, c_):
            return jax_dilated_attention_fused(a_, b_, c_, *schedule, valid_len=vl, interpret=True, flags=flags)

        out, vjp = jax.vjp(f, a, b, c)
        return out, vjp(d)

    if valid == "per_row":
        out, grads = jax.jit(run)(q, k, v, do, jnp.asarray(PER_ROW))
    else:  # a static bound (or none) stays a Python value
        out, grads = jax.jit(functools.partial(run, vl=valid))(q, k, v, do)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_route(flags, schedule, valid):
    q, k, v, do = (_data(s, 2, 300, H, DH) for s in (33, 34, 35, 36))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    vl = torch.from_numpy(PER_ROW) if valid == "per_row" else valid
    out = dilated_attention(qt, kt, vt, *schedule, valid_len=vl, flags=flags)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [t.grad.numpy() for t in (qt, kt, vt)]


@pytest.mark.parametrize(
    "route,schedule,valid", ROUTE_CASES,
    ids=[f"{r}-{len(s[0])}br-{v}" for r, s, v in ROUTE_CASES],
)
def test_route_matches_jax(route, schedule, valid):
    ref_out, ref_grads = _jax_route(route, schedule, valid)
    out, grads = _port_route(ROUTES[route][0], schedule, valid)
    np.testing.assert_allclose(out, ref_out, **FWD_TOL)
    for name, a, b in zip(("dq", "dk", "dv"), grads, ref_grads):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)


def _dense_fusion(outs, lses, plan):
    """The default route's stacked fusion of the same packed results."""
    B = outs[0].shape[0]
    dense = [dk.unpack_phases_reference(o6, plan.L, plan.E, g, S, r) for o6, (g, S, r, m, Mp) in zip(outs, plan.branches)]
    lse = torch.stack([dk._scatter_lse(l5, plan.L, plan.H, g, r, m) for l5, (g, S, r, m, Mp) in zip(lses, plan.branches)])
    weights = torch.softmax(lse, dim=0)
    out = sum(o.reshape(B, plan.L, plan.H, -1) * w.transpose(1, 2)[..., None] for o, w in zip(dense, weights))
    return out.reshape(B, plan.L, plan.E), weights


def test_epilogue_reference_matches_dense_fusion():
    """The epilogue's plain forward and backward against the port's own
    dense fusion of the same packed branch results (ragged rows)."""
    L = 300
    q, k, v = (torch.from_numpy(_data(s, 2, L, E)) for s in (37, 38, 39))
    plan = dk.plan_stream_fusion(L, E, H, *SCH5)
    packed = [dk.dilated_branch_attention_packed(q, k, v, sl, r, H, valid_len_dyn=torch.from_numpy(PER_ROW),
                                                 flags=dk.PipelineFlags())
              for sl, r in zip(*SCH5)]
    outs, lses = [o for o, _ in packed], [l for _, l in packed]
    out, fused = dk.fusion_epilogue_fwd(outs, lses, plan)
    ref, weights = _dense_fusion(outs, lses, plan)
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=1e-6)
    dy = torch.from_numpy(_data(40, 2, L, E))
    d6s = dk.fusion_epilogue_bwd(dy, fused, lses, plan)
    for l5, w, branch, d6 in zip(lses, weights, plan.branches, d6s):
        g, S, r, m, Mp = branch
        scaled = dy.reshape(2, L, H, DH) * w.transpose(1, 2)[..., None]
        ref6 = dk.pack_phases_reference(scaled.reshape(2, L, E), g, S, r, Mp, H)
        # a row with no valid key in the branch (lse ~-6.9e19) takes no
        # gradient through it (its probabilities are 0); where every
        # covering branch has such a row, fp32 m + log(l) absorbs log(n)
        # (as in the JAX epilogue), so compare the other rows
        live = (l5 > -1e19)[..., None].expand_as(d6)
        torch.testing.assert_close(d6[live], ref6[live], atol=1e-6, rtol=1e-6)
        assert torch.isfinite(d6).all() and not d6[ref6 == 0].any()


# (schedule, dtype) of the epilogue backward against the JAX package's VJP:
# ragged per-row valid lengths; the second schedule's segment ends (g = 40,
# 96) fall inside the kernel's 16-token tiles
EPILOGUE_BWD_CASES = [(sch, dtype) for sch in (SCH5, ([40, 96, 512], [1, 2, 4]))
                      for dtype in ("float32", "bfloat16")]


@functools.lru_cache(maxsize=None)
def _packed_branches(segment_lengths, dilated_ratios, L=300):
    """Every branch's packed ``(out6, lse5)`` in the port's layout, from the
    plain branch op on seeded q, k, v with the per-row valid lengths (shared
    by the cases: callers do not write to them)."""
    schedule = (segment_lengths, dilated_ratios)
    q, k, v = (torch.from_numpy(_data(s, 2, L, E)) for s in (46, 47, 48))
    packed = [dk.dilated_branch_attention_packed(q, k, v, sl, r, H, valid_len_dyn=torch.from_numpy(PER_ROW),
                                                 flags=dk.PipelineFlags())
              for sl, r in zip(*schedule)]
    return [o for o, _ in packed], [l for _, l in packed]


def _to_jax_lse(lse5, m, jMp):
    """The port's ``[B, S, r, hb, Mp]`` lse -> the JAX package's ``[B, S, r,
    jMp, LANES]`` (head t of the band on lane t); rows m..jMp and lanes past
    hb hold 0."""
    B, S, r, hb, _ = lse5.shape
    lse = np.zeros((B, S, r, jMp, 128), np.float32)
    lse[..., :m, :hb] = lse5[..., :m].numpy().transpose(0, 1, 2, 4, 3)
    return lse


@pytest.mark.parametrize("schedule,dtype", EPILOGUE_BWD_CASES,
                         ids=[f"{len(s[0])}br-{d}" for s, d in EPILOGUE_BWD_CASES])
def test_epilogue_bwd_matches_jax_vjp(schedule, dtype):
    """Every branch's packed cotangent from the port's one backward call
    against the JAX package's VJP of ``_fusion_epilogue`` (its Pallas
    backward in interpret mode) on the same packed results, dY and
    fused_lse. Rows below m compare: fp32 1e-6 (exp in another library),
    bf16 one bf16 rounding of the same fp32 product (|a - b| <= one ulp of
    b, 2^-7 |b|). Rows m..Mp and every slot off the segment or the
    sequence are exact zeros on both sides."""
    L = 300
    tdtype, jdtype = getattr(torch, dtype), getattr(jnp, dtype)
    outs, lses = _packed_branches(*map(tuple, schedule), L)
    plan = dk.plan_stream_fusion(L, E, H, *schedule)
    jplan = jpd.plan_stream_fusion(L, E, H, *schedule, interpret=True)
    jlses = []
    for l5, (g, S, r, m, Mp), jbranch in zip(lses, plan.branches, jplan.branches):
        assert jbranch[:4] == (r, H // r, S, g)
        jlses.append(jnp.asarray(_to_jax_lse(l5, m, jbranch[4])))
    jlses = tuple(jlses)
    dy = _data(49, 2, L, E)
    _, fused = dk.fusion_epilogue_fwd([o.to(tdtype) for o in outs], lses, plan)
    # the backward rule of the custom VJP, on the residuals its forward saves
    ref, _ = jpd._fusion_epilogue_bwd(jplan, (jlses, jnp.asarray(fused.numpy())), jnp.asarray(dy, jdtype))
    ours = dk.fusion_epilogue_bwd(torch.from_numpy(dy).to(tdtype), fused, lses, plan)
    tol = dict(atol=1e-6, rtol=1e-6) if dtype == "float32" else dict(atol=0, rtol=2 ** -7)
    for d6, jd6, (g, S, r, m, Mp) in zip(ours, ref, plan.branches):
        assert d6.shape == (2, S, r, H // r, Mp, DH) and d6.dtype == tdtype
        a, b = d6.float().numpy(), np.asarray(jd6.astype(jnp.float32))
        np.testing.assert_allclose(a[..., :m, :], b[..., :m, :], err_msg=f"r={r}", **tol)
        inside = dk.pack_phases_reference(torch.ones(1, L, E), g, S, r, Mp, H)[0].numpy() > 0
        assert not inside[..., m:, :].any()
        assert not a[:, ~inside].any() and not b[..., :m, :][:, ~inside[..., :m, :]].any()
        assert not b[..., m:, :].any() and np.isfinite(a).all()


def test_epilogue_bwd_one_call_per_layer(monkeypatch):
    """One backward of the fusion makes one ``fusion_epilogue_bwd`` call
    (one launch on the card) that returns one tensor per branch, in plan
    order, each equal to that branch alone in a one-branch plan."""
    L = 300
    outs, lses = _packed_branches(*map(tuple, SCH3), L)
    plan = dk.plan_stream_fusion(L, E, H, *SCH3)
    leaves = [o.clone().requires_grad_() for o in outs]
    calls = []
    real = dk.fusion_epilogue_bwd

    def counting(*a, **kw):
        calls.append(real(*a, **kw))
        return calls[-1]

    monkeypatch.setattr(dk, "fusion_epilogue_bwd", counting)
    out = dk._FusionEpilogue.apply(plan, *(x for pair in zip(leaves, lses) for x in pair))
    dy = torch.from_numpy(_data(50, 2, L, E))
    out.backward(dy)
    assert len(calls) == 1 and len(calls[0]) == len(plan.branches)
    _, fused = dk.fusion_epilogue_fwd(outs, lses, plan)
    for i, (leaf, l5, branch) in enumerate(zip(leaves, lses, plan.branches)):
        g, S, r, m, Mp = branch
        assert calls[0][i].shape == (2, S, r, H // r, Mp, DH)
        one = dk.EpiloguePlan(L=L, E=E, H=H, branches=(branch,))
        (alone,) = real(dy, fused, [l5], one)
        assert torch.equal(calls[0][i], alone) and torch.equal(leaf.grad, alone)


def test_uncovered_and_fully_masked_tokens():
    """A (token, head) no branch covers gives out exactly 0 and fused_lse
    at the sentinel; a row with no valid key in any branch gives 0 out and
    0 gradients; the route's gradients equal the default route's."""
    L, schedule = 100, ([64, 128], [2, 4])  # token 1, head 0: phase 1, band 0 in both
    plan = dk.plan_stream_fusion(L, E, H, *schedule)
    q, k, v = (torch.from_numpy(_data(s, 2, L, E)) for s in (41, 42, 43))
    valid = torch.tensor([L, 0])
    packed = [dk.dilated_branch_attention_packed(q, k, v, sl, r, H, valid_len_dyn=valid, flags=dk.PipelineFlags())
              for sl, r in zip(*schedule)]
    out, fused = dk.fusion_epilogue_fwd([o for o, _ in packed], [l for _, l in packed], plan)
    assert not out[0, 1, :DH].any() and float(fused[0, 1, 0]) <= -1e29
    assert (fused[0, 0, :H // 2] > -1e19).all()  # token 0 (phase 0): band 0 of r = 2 covers heads 0-7
    assert not out[1].any()  # no valid key anywhere in row 1

    grads = []
    for flags in (dk.PipelineFlags(), dk.PipelineFlags(stream_fusion=True, pack_direct=True)):
        leaves = [t.reshape(2, L, H, DH).clone().requires_grad_() for t in (q, k, v)]
        o = dilated_attention(*leaves, *schedule, valid_len=valid, flags=flags)
        o.backward(torch.from_numpy(_data(44, 2, L, H, DH)))
        grads.append([t.grad for t in leaves])
        assert all(torch.isfinite(g).all() for g in grads[-1])
        assert not any(g[1].any() for g in grads[-1][:2])  # dq, dk of the fully masked row
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_slide_encoder_with_flags_matches_jax(weights, inputs, monkeypatch):  # noqa: F811
    """The 2-layer slide encoder with GIGAPATH_STREAM_FUSION=1 and
    GIGAPATH_PACK_DIRECT=1 (ragged batch) against the JAX model: 1e-4."""
    for key, value in FLAG_ENV.items():
        monkeypatch.setenv(key, value)
    x, coords, pad_mask = inputs
    jmodel = JaxLongNetViT(**SMALL)
    ref = jax.jit(lambda p, a, c, m: jmodel.apply({"params": p}, a, c, all_layer_embed=True, pad_mask=m))(
        weights, jnp.asarray(x), jnp.asarray(coords), jnp.asarray(pad_mask))
    model = _port(weights)
    calls = {"n": 0}
    real = dk.fusion_epilogue_fwd

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(dk, "fusion_epilogue_fwd", counting)
    with torch.no_grad():
        ours = model(torch.from_numpy(x), torch.from_numpy(coords), all_layer_embed=True,
                     pad_mask=torch.from_numpy(pad_mask))
    assert calls["n"] == SMALL["depth"]  # the epilogue ran once per layer
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)


def test_head_step_gradients_with_and_without_flags(monkeypatch):
    """One ClassificationHead loss's gradients with the flags on against
    the flags off: 1e-4."""
    rng = np.random.default_rng(45)
    x = torch.from_numpy(rng.normal(size=(2, 150, 32)).astype(np.float32))
    coords = torch.from_numpy(rng.integers(0, 40 * 256, size=(2, 150, 2)).astype(np.float32))
    pad_mask = torch.ones(2, 150, dtype=torch.bool)
    pad_mask[1, 97:] = False
    grads = []
    for on in (False, True):
        for key, value in FLAG_ENV.items():
            if on:
                monkeypatch.setenv(key, value)
            else:
                monkeypatch.delenv(key, raising=False)
        model = get_model(**HEAD_KW, feat_layer="2", device="cpu", seed=0, **SLIDE_KW)
        logits = model(x, coords, pad_mask=pad_mask)
        torch.nn.functional.cross_entropy(logits, torch.tensor([1, 2])).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None})
    assert set(grads[0]) == set(grads[1])
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, msg=name, **GRAD_TOL)
