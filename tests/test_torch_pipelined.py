"""The port's pipelined dilated-branch kernels (rows 6 and 8) held against
the JAX package on the CPU, with the plan registry's write side.

On the CPU the port's pipelined wrappers run their plain versions
(``dilated_branch_fwd_pipe_reference``, ``dilated_branch_bwd_pipe_reference``);
the JAX side runs its pipelined Pallas kernels in interpret mode, jitted once
per case. Inputs come from numpy seeds. fp32 tolerances: out and lse (covered
slots) atol 2e-6 / rtol 1e-5 and gradients 2e-6 of their max, as the JAX
package's own pipelined-vs-serial tests (both sides compute in fp32 and sum
in another order; the JAX pipelined forward blocks its keys by 128 or 512,
the port's by 64); 1e-5 / 1e-4 for the multi-branch routes and 1e-4 for the
slide encoder, as the earlier route tests.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigapath_tpu.models.slide_encoder import LongNetViT as JaxLongNetViT
from gigapath_tpu.ops import pallas_dilated as jpd
from gigapath_tpu.ops.dilated_attention import dilated_attention_fused as jax_dilated_attention_fused
from gigapath_tpu.plan import executionplan as jep
from gigapath_tpu_torch import plan as tplan
from gigapath_tpu_torch.models.classification_head import get_model
from gigapath_tpu_torch.ops import dilated_kernels as dk
from gigapath_tpu_torch.ops.dilated_attention import dilated_attention

from test_torch_dilated import _data
from test_torch_finetune import HEAD_KW, SLIDE_KW
from test_torch_slide_encoder import SMALL, _port, inputs, weights  # noqa: F401  (fixtures)

H, DH = 8, 16
E = H * DH
OUT_TOL = dict(atol=2e-6, rtol=1e-5)
GRAD_MAX_TOL = 2e-6
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
PIPE_ENV = {"GIGAPATH_PIPELINED_ATTN": "1", "GIGAPATH_PIPELINED_BWD": "1"}
PIPE_VARS = sorted(set(dk.FLAG_ENV.values()) | {"GIGAPATH_PLAN", "GIGAPATH_PLAN_REGISTRY"})

# (L, sl, r, real_len, per-row valid lengths, JAX pipe block_k): one key
# block (nk == 1), a multi-phase ragged branch, nk > 1 in the JAX kernels
# (block 256 at m = 150, key blocks of 128), per-row valid lengths
PIPE_CASES = [
    (300, 64, 1, 300, None, None),
    (300, 64, 2, 277, None, None),
    (300, 512, 2, 300, None, 128),
    (300, 64, 2, None, (300, 157), None),
]
PIPE_IDS = ["nk1", "ragged_r2", "nk2", "per_row"]


@functools.lru_cache(maxsize=None)
def _jax_pipe(case):
    """Out, lse and the gradients of (o*o).sum() of the JAX branch op with
    both pipelined flags, interpret mode, jitted."""
    L, sl, r, rl, vl, bk = case
    flags = jpd.PipelineFlags(pipelined_fwd=True, pipelined_bwd=True, pipe_block_k=bk, pipe_bwd_block_k=bk)
    kw = {} if rl is None else {"real_len": rl}
    if bk is not None:  # the case exists to run more than one JAX key block
        assert jpd._branch_geometry(L, E, sl, r)[5] // bk > 1

    def run(q, k, v, vld):
        def loss(q_, k_, v_):
            o, l = jpd.dilated_branch_attention(q_, k_, v_, sl, r, H, interpret=True, flags=flags,
                                                valid_len_dyn=vld, **kw)
            return (o * o).sum(), (o, l)

        (_, (o, l)), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
        return o, l, grads

    vld = None if vl is None else jnp.asarray(np.array(vl, np.int32))
    o, l, grads = jax.jit(run)(*(jnp.asarray(_data(s, 2, L, E)) for s in (60, 61, 62)), vld)
    return np.asarray(o), np.asarray(l), [np.asarray(g) for g in grads]


def _port_pipe(case, flags):
    L, sl, r, rl, vl, _ = case
    q, k, v = (torch.from_numpy(_data(s, 2, L, E)).requires_grad_() for s in (60, 61, 62))
    o, l = dk.dilated_branch_attention(q, k, v, sl, r, H, real_len=rl, flags=flags,
                                       valid_len_dyn=None if vl is None else torch.tensor(vl))
    (o * o).sum().backward()
    return o.detach().numpy(), l.numpy(), [t.grad.numpy() for t in (q, k, v)]


@pytest.mark.parametrize("case", PIPE_CASES, ids=PIPE_IDS)
def test_pipelined_forward_matches_jax(case):
    """Row 6: the pipelined forward against JAX's _fwd_kernel_pipe."""
    ref_o, ref_l, _ = _jax_pipe(case)
    o, l, _ = _port_pipe(case, dk.PipelineFlags(pipelined_fwd=True, pipelined_bwd=True))
    np.testing.assert_allclose(o, ref_o, **OUT_TOL)
    covered = ref_l > -1e19
    np.testing.assert_allclose(l[covered], ref_l[covered], **OUT_TOL)
    assert (l[~covered] <= -1e19).all()


@pytest.mark.parametrize("case", PIPE_CASES, ids=PIPE_IDS)
def test_pipelined_backward_matches_jax(case):
    """Row 8: the gradients through the pipelined dq and dkv against JAX's
    _dq_kernel_pipe and _dkv_kernel_pipe, to 2e-6 of each gradient's max."""
    _, _, ref_grads = _jax_pipe(case)
    _, _, grads = _port_pipe(case, dk.PipelineFlags(pipelined_fwd=True, pipelined_bwd=True))
    for name, a, b in zip(("dq", "dk", "dv"), grads, ref_grads):
        scale = max(float(np.abs(b).max()), 1e-12)
        np.testing.assert_allclose(a / scale, b / scale, atol=GRAD_MAX_TOL, err_msg=name)


@pytest.mark.parametrize("L,sl,r", [(64, 64, 1), (120, 128, 2)])
def test_pipelined_bf16_roundings_match_jax(L, sl, r):
    """In bf16 the pipelined kernels round q*scale*log2(e), the forward's
    probabilities and dQ's ds to the input dtype, where the serial kernels
    keep them fp32. With one key block on both sides (kvlen <= 64) the
    port's plain versions reproduce JAX's pipelined kernels but for rare
    one-ulp flips where the fp32 sums round apart (read: at most 8.7e-4 of
    a tensor's max, 3e-6 of its mean magnitude on average), while the
    serial route differs everywhere by about one bf16 rounding (2.4e-3 to
    6.1e-3 on average)."""
    q, k, v, do = (2 * _data(s, 2, L, E) for s in (63, 64, 65, 66))
    flags = jpd.PipelineFlags(pipelined_fwd=True, pipelined_bwd=True)

    def run(a, b, c, d):
        (o, l), vjp = jax.vjp(lambda a_, b_, c_: jpd.dilated_branch_attention(
            a_, b_, c_, sl, r, H, interpret=True, flags=flags), a, b, c)
        return o, vjp((d, jnp.zeros_like(l)))

    ref_o, ref_g = jax.jit(run)(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do)))
    ref_o = np.asarray(ref_o.astype(jnp.float32))
    ref_g = [np.asarray(g.astype(jnp.float32)) for g in ref_g]
    errs = {}
    for name, ours in (("pipe", dk.PipelineFlags(pipelined_fwd=True, pipelined_bwd=True)),
                       ("serial", dk.PipelineFlags())):
        qt, kt, vt = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_() for x in (q, k, v))
        o, _ = dk.dilated_branch_attention(qt, kt, vt, sl, r, H, flags=ours)
        o.backward(torch.from_numpy(do).to(torch.bfloat16))
        pairs = list(zip((o.detach(), qt.grad, kt.grad, vt.grad), (ref_o, *ref_g)))
        errs[name] = {
            "max": [float(np.abs(a.float().numpy() - b).max() / np.abs(b).max()) for a, b in pairs],
            "mean": [float(np.abs(a.float().numpy() - b).mean() / np.abs(b).mean()) for a, b in pairs],
        }
    assert max(errs["pipe"]["max"]) <= 2e-3, errs  # half a bf16 ulp at the max
    assert all(p * 100 <= s for p, s in zip(errs["pipe"]["mean"], errs["serial"]["mean"])), errs


def test_pipelined_wrappers_refuse_causal_calls():
    """The pipelined kernels are non-causal only; the dispatcher never
    sends them a causal call."""
    q6 = torch.from_numpy(_data(67, 1, 1, 1, 1, 64, 4))
    kvlen = torch.full((1, 1, 1), 64, dtype=torch.int32)
    lse = torch.zeros(1, 1, 1, 1, 64)
    with pytest.raises(ValueError, match="non-causal"):
        dk.dilated_branch_fwd_pipe(q6, q6, q6, kvlen, True)
    for fn in (dk.dilated_branch_bwd_dq_pipe, dk.dilated_branch_bwd_dkv_pipe):
        with pytest.raises(ValueError, match="non-causal"):
            fn(q6, q6, q6, q6, lse, lse, kvlen, True)


def test_fully_masked_cells_give_zero_out_and_gradients():
    """A cell with no valid key: out exactly 0, lse at the sentinel, and
    exact-zero gradients from both pipelined backward kernels."""
    B, S, r, hb, Mp, Dh = 1, 2, 2, 4, 64, 8
    q6, k6, v6, do6 = (torch.from_numpy(_data(s, B, S, r, hb, Mp, Dh)) for s in (68, 69, 70, 71))
    kvlen = torch.tensor([[[0, 5], [64, 0]]], dtype=torch.int32)
    out, lse = dk.dilated_branch_fwd_pipe(q6, k6, v6, kvlen)
    assert not out[:, 0, 0].any() and not out[:, 1, 1].any()
    assert (lse[:, 0, 0] <= -1e19).all() and (lse[:, 1, 1] <= -1e19).all()
    delta = (do6 * out).sum(-1)
    dq6 = dk.dilated_branch_bwd_dq_pipe(q6, k6, v6, do6, lse, delta, kvlen)
    dk6, dv6 = dk.dilated_branch_bwd_dkv_pipe(q6, k6, v6, do6, lse, delta, kvlen)
    for g in (dq6, dk6, dv6):
        assert torch.isfinite(g).all() and not g[:, 0, 0].any() and not g[:, 1, 1].any()
    assert not dk6[:, 0, 1, :, 5:].any() and not dv6[:, 0, 1, :, 5:].any()  # keys past kvlen
    # fp32: the same function as the serial kernels' plain versions
    ref_out, ref_lse = dk.dilated_branch_fwd_reference(q6, k6, v6, kvlen)
    torch.testing.assert_close(out, ref_out, atol=2e-6, rtol=1e-5)
    for a, b in zip((dq6, dk6, dv6), dk.dilated_branch_bwd_reference(q6, k6, v6, do6, lse, delta, kvlen)):
        torch.testing.assert_close(a, b, atol=2e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# both phase-major routes and the slide encoder
# ---------------------------------------------------------------------------

ROUTE_L, ROUTE_H, ROUTE_DH = 200, 8, 4
ROUTE_SCHEDULE = ([64, 200], [1, 4])  # r = 4 clamps to one segment: the direct kernels' branch
PER_ROW = np.array([200, 157], np.int32)
ROUTE_FLAGS = {
    "default": dict(pipelined_fwd=True, pipelined_bwd=True),
    "stream_direct": dict(pipelined_fwd=True, pipelined_bwd=True, stream_fusion=True, pack_direct=True),
}


@pytest.mark.parametrize("route", list(ROUTE_FLAGS))
def test_routes_with_pipelined_flags_match_jax(route):
    """The multi-branch op on both phase-major routes with both pipelined
    flags (per-row valid lengths) against JAX's dilated_attention_fused
    with the same flags, interpret mode: forward 1e-5, gradients 1e-4."""
    fields = ROUTE_FLAGS[route]
    q, k, v, do = (_data(s, 2, ROUTE_L, ROUTE_H, ROUTE_DH) for s in (72, 73, 74, 75))
    jflags = jpd.PipelineFlags(**fields)

    def run(a, b, c, d, vl):
        out, vjp = jax.vjp(lambda a_, b_, c_: jax_dilated_attention_fused(
            a_, b_, c_, *ROUTE_SCHEDULE, valid_len=vl, interpret=True, flags=jflags), a, b, c)
        return out, vjp(d)

    ref_out, ref_grads = jax.jit(run)(*(jnp.asarray(x) for x in (q, k, v, do)), jnp.asarray(PER_ROW))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = dilated_attention(*leaves, *ROUTE_SCHEDULE, valid_len=torch.from_numpy(PER_ROW),
                            flags=dk.PipelineFlags(**fields))
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), **FWD_TOL)
    for name, t, ref in zip(("dq", "dk", "dv"), leaves, ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), err_msg=name, **GRAD_TOL)


def _set_env(monkeypatch, on: bool):
    for key, value in PIPE_ENV.items():
        if on:
            monkeypatch.setenv(key, value)
        else:
            monkeypatch.delenv(key, raising=False)


def test_slide_encoder_with_pipelined_flags_matches_jax(weights, inputs, monkeypatch):  # noqa: F811
    """The 2-layer slide encoder with GIGAPATH_PIPELINED_ATTN=1 and
    GIGAPATH_PIPELINED_BWD=1 (ragged batch) against the JAX model under
    the same flags: 1e-4; every branch forward ran the pipelined kernel."""
    _set_env(monkeypatch, True)
    x, coords, pad_mask = inputs
    jmodel = JaxLongNetViT(**SMALL)
    ref = jax.jit(lambda p, a, c, m: jmodel.apply({"params": p}, a, c, all_layer_embed=True, pad_mask=m))(
        weights, jnp.asarray(x), jnp.asarray(coords), jnp.asarray(pad_mask))
    model = _port(weights)
    calls = {"pipe": 0, "serial": 0}
    for name, key in (("dilated_branch_fwd_pipe", "pipe"), ("dilated_branch_fwd", "serial")):
        real = getattr(dk, name)

        def counting(*a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(dk, name, counting)
    with torch.no_grad():
        ours = model(torch.from_numpy(x), torch.from_numpy(coords), all_layer_embed=True,
                     pad_mask=torch.from_numpy(pad_mask))
    assert calls == {"pipe": SMALL["depth"] * 5, "serial": 0}
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)


def test_head_step_gradients_with_and_without_pipelined_flags(monkeypatch):
    """One ClassificationHead loss's gradients with both pipelined flags
    on against both off (ragged batch): 1e-4."""
    rng = np.random.default_rng(76)
    x = torch.from_numpy(rng.normal(size=(2, 150, 32)).astype(np.float32))
    coords = torch.from_numpy(rng.integers(0, 40 * 256, size=(2, 150, 2)).astype(np.float32))
    pad_mask = torch.ones(2, 150, dtype=torch.bool)
    pad_mask[1, 97:] = False
    grads = []
    for on in (False, True):
        _set_env(monkeypatch, on)
        model = get_model(**HEAD_KW, feat_layer="2", device="cpu", seed=0, **SLIDE_KW)
        logits = model(x, coords, pad_mask=pad_mask)
        torch.nn.functional.cross_entropy(logits, torch.tensor([1, 2])).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None})
    assert set(grads[0]) == set(grads[1])
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, msg=name, **GRAD_TOL)


# ---------------------------------------------------------------------------
# the plan registry's write side
# ---------------------------------------------------------------------------


@pytest.fixture
def plan_env(monkeypatch, tmp_path):
    """No dispatch flag set, a registry path in tmp, fresh plan state in
    both packages."""
    for name in PIPE_VARS:
        monkeypatch.delenv(name, raising=False)
    path = str(tmp_path / "PLAN_REGISTRY.json")
    monkeypatch.setenv("GIGAPATH_PLAN_REGISTRY", path)
    tplan.reset_plan_state()
    jep.reset_plan_state()
    yield path
    tplan.reset_plan_state()
    jep.reset_plan_state()


def _key(dtype=torch.float32):
    q = torch.empty(1, 10241, 16, 48, dtype=dtype, device="meta")
    return tplan.geometry_key("dilated_attention", (q, q, q))


def test_bless_round_trips_and_refuses_a_hand_edit(plan_env):
    plan = tplan.ExecutionPlan(branches=((1024, 1, "pipelined", 0),), pipelined_bwd=True)
    assert plan.as_dict() == jep.ExecutionPlan(**plan._asdict()).as_dict()
    path = tplan.bless_plan(_key(), plan.as_dict(), provenance={"by": "test"})
    assert path == plan_env and not [f for f in os.listdir(os.path.dirname(path)) if f.startswith(".tmp-")]
    doc = tplan.load_registry(path)
    assert tplan.ExecutionPlan.from_dict(doc["entries"][_key()]) == plan
    assert doc["entries"][_key()]["provenance"] == {"by": "test"}
    # a second bless keeps the first entry
    tplan.bless_plan(_key(torch.bfloat16), {"fusion": "stream"})
    assert set(tplan.load_registry(path)["entries"]) == {_key(), _key(torch.bfloat16)}
    # a hand edit the digest does not cover is refused, on load and on bless
    doc = json.load(open(path))
    doc["entries"][_key()]["pipelined_bwd"] = False
    with open(path, "w") as fh:
        json.dump(doc, fh)
    with pytest.raises(tplan.CorruptPlanRegistry, match="digest mismatch"):
        tplan.load_registry(path)
    with pytest.raises(tplan.CorruptPlanRegistry):
        tplan.bless_plan(_key(), plan.as_dict())


def test_port_blessed_registry_resolves_alike_in_both_packages(plan_env, monkeypatch):
    q = torch.empty(1, 10241, 16, 48, device="meta")
    tplan.bless_plan(_key(), tplan.ExecutionPlan(branches=((1024, 1, "pipelined", 0),), fusion="stream").as_dict())
    jq = jax.ShapeDtypeStruct(tuple(q.shape), jnp.float32)
    for env in ({}, {"GIGAPATH_PIPELINED_BWD": "1"}, {"GIGAPATH_PIPELINED_ATTN": "0"}):
        for name, value in env.items():
            monkeypatch.setenv(name, value)
        ours = tplan.resolve_plan("dilated_attention", (q, q, q))
        ref = jep.resolve_plan("dilated_attention", (jq, jq, jq))
        assert ours._asdict() == ref._asdict()
        assert dk._branch_pipelined(ours, 1024, 1) == jpd._branch_pipelined(ref, 1024, 1)
        assert dk._branch_pipelined(ours, 5792, 2) == jpd._branch_pipelined(ref, 5792, 2)
    assert tplan.plan_registry_signature() == jep.plan_registry_signature() != "plan-none"


def test_plan_stats_count_as_jax(plan_env, monkeypatch):
    q = torch.empty(1, 10241, 16, 48, device="meta")
    jq = jax.ShapeDtypeStruct(tuple(q.shape), jnp.float32)
    other, jother = torch.empty(1, 99, 16, 48, device="meta"), jax.ShapeDtypeStruct((1, 99, 16, 48), jnp.float32)
    assert tplan.plan_registry_signature() == jep.plan_registry_signature() == "plan-none"
    tplan.bless_plan(_key(), {"pipelined_fwd": True})
    for _ in range(3):
        tplan.resolve_plan("dilated_attention", (q, q, q))
        jep.resolve_plan("dilated_attention", (jq, jq, jq))
    tplan.resolve_plan("dilated_attention", (other,) * 3)
    jep.resolve_plan("dilated_attention", (jother,) * 3)
    assert tplan.plan_stats() == jep.plan_stats() == {"lookups": 4, "hits": 3, "plan_hit_rate": 0.75}
    monkeypatch.setenv("GIGAPATH_PLAN", "off")  # no lookup, nothing counted
    tplan.resolve_plan("dilated_attention", (q, q, q))
    assert tplan.plan_stats()["lookups"] == 4 and tplan.plan_registry_signature() == "plan-none"
    tplan.reset_plan_state()
    assert tplan.plan_stats() == {"lookups": 0, "hits": 0, "plan_hit_rate": 0.0}
