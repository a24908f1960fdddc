"""The port's flag snapshot and plan seam held against the JAX package.

Registries are written with the JAX package's own writer, so each test also
shows that one ``PLAN_REGISTRY.json`` reads the same in both packages. The
dispatch is checked through the calls each kernel wrapper receives (on the
CPU a wrapper runs its plain version; on the card each call is one launch).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigapath_tpu.ops import pallas_dilated as jpd
from gigapath_tpu.plan import executionplan as jep
from gigapath_tpu.plan.registry import save_registry
from gigapath_tpu_torch import plan as tplan
from gigapath_tpu_torch.ops import dilated_kernels as dk
from gigapath_tpu_torch.ops.dilated_attention import dilated_attention

from test_torch_dilated import DH, H, _data

FLAG_VARS = sorted(set(dk.FLAG_ENV.values()) | {"GIGAPATH_PLAN", "GIGAPATH_PLAN_REGISTRY"})
SCHEDULE = ([32, 64, 128, 512, 1024], [1, 2, 4, 8, 16])  # at L = 300: r = 8, 16 have one segment
WRAPPERS = ("pack_phases", "dilated_branch_fwd", "unpack_phases", "dilated_branch_bwd_dq",
            "dilated_branch_bwd_dkv", "pack_phases_direct", "unpack_phases_direct",
            "fusion_epilogue_fwd", "fusion_epilogue_bwd", "dilated_branch_fwd_pipe",
            "dilated_branch_bwd_dq_pipe", "dilated_branch_bwd_dkv_pipe")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch, tmp_path):
    """No dispatch flag set, an empty registry path, fresh caches."""
    for name in FLAG_VARS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("GIGAPATH_PLAN_REGISTRY", str(tmp_path / "PLAN_REGISTRY.json"))
    tplan.reset_plan_state()
    jep.reset_plan_state()
    yield
    tplan.reset_plan_state()
    jep.reset_plan_state()


def _qkv(L=300, seed=50):
    return [torch.from_numpy(_data(seed + i, 2, L, H, DH)) for i in range(3)]


def _bless(entries: dict) -> str:
    return save_registry({"entries": entries}, os.environ["GIGAPATH_PLAN_REGISTRY"])


def _key(q):
    return tplan.geometry_key("dilated_attention", (q, q, q))


@pytest.fixture
def calls(monkeypatch):
    """Count the calls of each kernel wrapper (each one launch on the card)."""
    counts = dict.fromkeys(WRAPPERS, 0)
    for name in WRAPPERS:
        real = getattr(dk, name)

        def counting(*a, _name=name, _real=real, **kw):
            counts[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(dk, name, counting)
    return counts


@pytest.mark.parametrize(
    "env",
    [{}, {"GIGAPATH_PACK_DIRECT": "1", "GIGAPATH_STREAM_FUSION": "true"},
     {"GIGAPATH_STREAMING_FUSION": "yes", "GIGAPATH_PIPE_BLOCK_K": "256", "GIGAPATH_PIPE_BWD_BLOCK_K": " 128 "},
     {"GIGAPATH_PIPELINED_ATTN": "1", "GIGAPATH_PIPELINED_BWD": "0", "GIGAPATH_PACK_DIRECT": "no"}],
    ids=["unset", "stream", "streaming", "pipelined"],
)
def test_snapshot_matches_jax(env, monkeypatch):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    ours, ref = dk.snapshot_flags(), jpd.snapshot_flags()
    assert dk.PipelineFlags._fields == jpd.PipelineFlags._fields
    assert dk.PipelineFlags() == jpd.PipelineFlags()
    for field in ("pack_direct", "stream_fusion", "streaming_fusion", "pipelined_fwd", "pipelined_bwd",
                  "pipe_block_k", "pipe_bwd_block_k"):
        assert getattr(ours, field) == getattr(ref, field), field
    assert dk.FLAG_ENV == jpd.FLAG_ENV


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32", "bool"])
def test_geometry_key_matches_jax(dtype):
    shape = (1, 10241, 16, 48)
    ours = tplan.geometry_key("dilated_attention", tuple(
        torch.empty(shape, dtype=getattr(torch, dtype), device="meta") for _ in range(3)))
    ref = jep.geometry_key("dilated_attention", tuple(
        jax.ShapeDtypeStruct(shape, getattr(jnp, dtype)) for _ in range(3)))
    assert ours == ref
    assert ours.startswith(f"dilated_attention|{dtype}[1,10241,16,48];")
    assert tplan.shape_signature(({"a": np.zeros(2), "b": [1, 2]}, 3)) == "tree{3}"


@pytest.mark.parametrize(
    "env,expect",
    [
        ({}, dict(stream_fusion=True, pack_direct=True, streaming_fusion=False)),
        ({"GIGAPATH_PACK_DIRECT": "0"}, dict(stream_fusion=True, pack_direct=False)),
        ({"GIGAPATH_STREAM_FUSION": "0"}, dict(stream_fusion=False, pack_direct=True)),
        ({"GIGAPATH_STREAMING_FUSION": "1"}, dict(stream_fusion=True, streaming_fusion=True)),
    ],
    ids=["plan_fills", "env_zero_wins", "env_zero_wins_fusion", "env_sets_other"],
)
def test_env_beats_plan_beats_default(env, expect, monkeypatch):
    q = _qkv()[0]
    _bless({_key(q): {"fusion": "stream", "pack_direct": True, "pipe_block_k": 512}})
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    ours = tplan.resolve_plan("dilated_attention", (q, q, q))
    for field, value in expect.items():
        assert getattr(ours, field) == value, field
    assert ours.pipe_block_k == 512  # carried, unused by the port
    ref = jep.resolve_plan("dilated_attention", tuple(jnp.asarray(q.numpy()) for _ in range(3)))
    assert ours._asdict() == ref._asdict()
    # another geometry has no entry: the defaults
    other = _qkv(L=100)[0]
    assert tplan.resolve_plan("dilated_attention", (other, other, other)) == dk.snapshot_flags()


def test_explicit_flags_skip_resolution():
    q = _qkv()[0]
    _bless({_key(q): {"fusion": "stream"}})
    pinned = dk.PipelineFlags(pack_direct=True)
    assert tplan.resolve_plan("dilated_attention", (q, q, q), pinned) is pinned


def test_digest_mismatch_is_a_warned_empty_registry():
    q = _qkv()[0]
    path = _bless({_key(q): {"fusion": "stream"}})
    doc = json.load(open(path))
    doc["entries"][_key(q)]["pack_direct"] = True  # a hand edit the digest does not cover
    with open(path, "w") as fh:
        json.dump(doc, fh)
    with pytest.raises(tplan.CorruptPlanRegistry, match="digest mismatch"):
        tplan.load_registry(path)
    with pytest.warns(UserWarning, match="plan registry refused"):
        flags = tplan.resolve_plan("dilated_attention", (q, q, q))
    assert flags == dk.PipelineFlags()


@pytest.mark.parametrize("value", ["off", "0", "false", "no"])
def test_plan_off(value, monkeypatch):
    q = _qkv()[0]
    _bless({_key(q): {"fusion": "stream", "pack_direct": True}})
    monkeypatch.setenv("GIGAPATH_PLAN", value)
    assert not tplan.plan_enabled()
    assert tplan.resolve_plan("dilated_attention", (q, q, q)) == dk.PipelineFlags()


def test_from_dict_matches_jax():
    doc = {"branches": [[1024, 1, "serial", 256], [32768, 4, "", 0]], "fusion": "streaming",
           "pipelined_bwd": False, "pipe_block_k": 256, "pack_direct": True, "quant_tile": "INT8+attn",
           "fold_block_q": 64, "fold_branches": [[1024, 1, 128, 64]], "provenance": {"by": "autotune"}}
    assert tplan.ExecutionPlan.from_dict(doc)._asdict() == jep.ExecutionPlan.from_dict(doc)._asdict()
    with pytest.raises(ValueError, match="variant"):
        tplan.ExecutionPlan.from_dict({"branches": [[1, 1, "fast", 0]]})
    # a malformed entry is refused with a warning, never applied
    q = _qkv()[0]
    _bless({_key(q): {"fusion": "sideways"}})
    with pytest.warns(UserWarning, match="refused"):
        assert tplan.resolve_plan("dilated_attention", (q, q, q)) == dk.PipelineFlags()


def _branch_calls(calls):
    """The branch-kernel calls only (serial and pipelined)."""
    return {name: n for name, n in calls.items() if name.startswith("dilated_branch_")}


def _fwd_bwd(q, k, v, **kw):
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = dilated_attention(*leaves, *SCHEDULE, **kw)
    out.backward(torch.ones_like(out))
    return out


# branch-kernel calls of one forward + backward of the 5-branch SCHEDULE
SERIAL_CALLS = {"dilated_branch_fwd": 5, "dilated_branch_bwd_dq": 5, "dilated_branch_bwd_dkv": 5,
                "dilated_branch_fwd_pipe": 0, "dilated_branch_bwd_dq_pipe": 0, "dilated_branch_bwd_dkv_pipe": 0}
PIPE_FWD_CALLS = {**SERIAL_CALLS, "dilated_branch_fwd": 0, "dilated_branch_fwd_pipe": 5}
PIPE_BWD_CALLS = {**SERIAL_CALLS, "dilated_branch_bwd_dq": 0, "dilated_branch_bwd_dkv": 0,
                  "dilated_branch_bwd_dq_pipe": 5, "dilated_branch_bwd_dkv_pipe": 5}


def test_branch_variants_follow_env_precedence(calls, monkeypatch):
    """A blessed plan's "pipelined" variant pins its branch's forward to the
    pipelined kernel (it raised NotImplementedError before the kernels were
    ported); a present GIGAPATH_PIPELINED_ATTN strips the variant, and every
    branch runs serial again."""
    q = _qkv()[0]
    _bless({_key(q): {"branches": [[32, 1, "pipelined", 0]]}})
    flags = tplan.resolve_plan("dilated_attention", (q, q, q))
    assert flags.branch_plans == ((32, 1, "pipelined", 0),)
    assert dk._branch_pipelined(flags, 32, 1) == (True, False)
    assert _fwd_bwd(*_qkv()).shape == q.shape
    assert _branch_calls(calls) == {**SERIAL_CALLS, "dilated_branch_fwd": 4, "dilated_branch_fwd_pipe": 1}
    monkeypatch.setenv("GIGAPATH_PIPELINED_ATTN", "0")  # present: the variant is stripped
    assert tplan.resolve_plan("dilated_attention", (q, q, q)).branch_plans == ((32, 1, "", 0),)
    calls.update(dict.fromkeys(calls, 0))
    assert _fwd_bwd(*_qkv()).shape == q.shape
    assert _branch_calls(calls) == SERIAL_CALLS


@pytest.mark.parametrize("name", ["GIGAPATH_PIPELINED_ATTN", "GIGAPATH_PIPELINED_BWD"])
def test_pipelined_flags_raise(name, calls, monkeypatch):
    """Named for the refusal it replaced: the pipelined flags raised
    NotImplementedError until rows 6 and 8 were ported. Now each flag
    routes exactly the pass the JAX package routes (the forward, or both
    backward kernels) to the pipelined kernels, on the multi-branch op and
    on one branch alone; a causal call stays serial."""
    monkeypatch.setenv(name, "1")
    want = PIPE_FWD_CALLS if name == "GIGAPATH_PIPELINED_ATTN" else PIPE_BWD_CALLS
    q, k, v = _qkv()
    assert _fwd_bwd(q, k, v).shape == q.shape
    assert _branch_calls(calls) == want
    calls.update(dict.fromkeys(calls, 0))
    leaves = [t.reshape(2, 300, -1).clone().requires_grad_() for t in (q, k, v)]
    out, _ = dk.dilated_branch_attention(*leaves, 64, 2, H)
    out.backward(torch.ones_like(out))
    assert _branch_calls(calls) == {n: c // 5 for n, c in want.items()}
    # the JAX package runs its serial kernels for a causal call whatever the flag
    calls.update(dict.fromkeys(calls, 0))
    assert _fwd_bwd(q, k, v, is_causal=True).shape == q.shape
    assert _branch_calls(calls) == SERIAL_CALLS


# (environment, blessed branch plans, causal) -> branch-kernel calls of one
# forward + backward, the JAX package's dispatch (_branch_pipelined)
PIPE_ROUTING = {
    "env_attn": ({"GIGAPATH_PIPELINED_ATTN": "1"}, None, False, PIPE_FWD_CALLS),
    "env_bwd": ({"GIGAPATH_PIPELINED_BWD": "1"}, None, False, PIPE_BWD_CALLS),
    "plan_pipelined": ({}, [[32, 1, "pipelined", 0]], False,
                       {**SERIAL_CALLS, "dilated_branch_fwd": 4, "dilated_branch_fwd_pipe": 1}),
    "plan_serial_env_bwd": ({"GIGAPATH_PIPELINED_BWD": "1"}, [[32, 1, "serial", 0]], False, PIPE_BWD_CALLS),
    "plan_serial_global_fwd": ({}, [[32, 1, "serial", 0]], False,
                               {**PIPE_FWD_CALLS, "dilated_branch_fwd": 1, "dilated_branch_fwd_pipe": 4}),
    "causal": ({"GIGAPATH_PIPELINED_ATTN": "1", "GIGAPATH_PIPELINED_BWD": "1"}, None, True, SERIAL_CALLS),
}


@pytest.mark.parametrize("case", list(PIPE_ROUTING))
def test_pipelined_routing(case, calls, monkeypatch):
    """Environment flags, a blessed plan's per-branch variant (forward
    only), the backward on the global flag, and causal calls serial: the
    pipelined dispatch of the JAX package, counted in kernel calls."""
    env, branches, causal, want = PIPE_ROUTING[case]
    q = _qkv()[0]
    if branches is not None:
        doc = {"branches": branches}
        if case == "plan_serial_global_fwd":
            doc["pipelined_fwd"] = True  # the plan's own global opinion
        _bless({_key(q): doc})
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    _fwd_bwd(*_qkv(), is_causal=causal)
    assert _branch_calls(calls) == want
    ours = tplan.resolve_plan("dilated_attention", (q, q, q))
    ref = jep.resolve_plan("dilated_attention", tuple(jnp.asarray(q.numpy()) for _ in range(3)))
    for sl, r in zip(*SCHEDULE):
        assert dk._branch_pipelined(ours, sl, r) == jpd._branch_pipelined(ref, sl, r)


# wrapper calls of one forward + backward at L = 300: 5 branches, of which
# r = 8 and 16 have one segment (the direct kernels' branches)
ROUTE_CALLS = {
    "default": dict(pack_phases=15 + 20, dilated_branch_fwd=5, unpack_phases=5 + 15,
                    dilated_branch_bwd_dq=5, dilated_branch_bwd_dkv=5),
    "pack_direct": dict(pack_phases=9 + 12, pack_phases_direct=6 + 8, dilated_branch_fwd=5,
                        unpack_phases=3 + 9, unpack_phases_direct=2 + 6,
                        dilated_branch_bwd_dq=5, dilated_branch_bwd_dkv=5),
    "stream_direct": dict(pack_phases=9 + 9, pack_phases_direct=6 + 6, dilated_branch_fwd=5,
                          unpack_phases=9, unpack_phases_direct=6, fusion_epilogue_fwd=1,
                          fusion_epilogue_bwd=5, dilated_branch_bwd_dq=5, dilated_branch_bwd_dkv=5),
    "streaming": dict(pack_phases=15 + 20, dilated_branch_fwd=5, unpack_phases=5 + 15,
                      dilated_branch_bwd_dq=5, dilated_branch_bwd_dkv=5),
}
ROUTE_ENV = {"default": {}, "pack_direct": {"GIGAPATH_PACK_DIRECT": "1"},
             "stream_direct": {"GIGAPATH_STREAM_FUSION": "1", "GIGAPATH_PACK_DIRECT": "1"},
             "streaming": {"GIGAPATH_STREAMING_FUSION": "1"}}


@pytest.mark.parametrize("route", list(ROUTE_CALLS))
def test_route_kernel_calls(route, calls, monkeypatch):
    """With no flag set the dispatch is the dense route as before (its
    calls, and none of the direct, epilogue or pipelined kernels); each flag
    swaps exactly the kernels the JAX package swaps."""
    for name, value in ROUTE_ENV[route].items():
        monkeypatch.setenv(name, value)
    q, k, v = (t.requires_grad_() for t in _qkv())
    out = dilated_attention(q, k, v, *SCHEDULE)
    out.backward(torch.ones_like(out))
    assert calls == {**dict.fromkeys(WRAPPERS, 0), **ROUTE_CALLS[route]}


def test_plan_routes_through_the_seam(calls):
    """A blessed plan alone (no flag set) puts the call on the epilogue."""
    q, k, v = _qkv()
    _bless({_key(q): {"fusion": "stream"}})
    with torch.no_grad():
        dilated_attention(q, k, v, *SCHEDULE)
    assert calls["fusion_epilogue_fwd"] == 1 and calls["unpack_phases"] == 0


def test_stream_fusion_falls_back_past_the_branch_limit(calls, monkeypatch):
    """A schedule the epilogue cannot take (more branches than one launch
    holds) warns and runs the dense fusion, as the JAX package does for a
    schedule its epilogue cannot block."""
    n = dk.MAX_FUSED_BRANCHES + 1
    schedule = ([16 * (i + 1) for i in range(n)], [1] * (n - 1) + [2])
    q, k, v = _qkv(L=100)
    monkeypatch.setenv("GIGAPATH_STREAM_FUSION", "1")
    with pytest.warns(UserWarning, match="dense fusion"):
        out = dilated_attention(q, k, v, *schedule)
    assert calls["fusion_epilogue_fwd"] == 0 and calls["unpack_phases"] == n
    monkeypatch.delenv("GIGAPATH_STREAM_FUSION")
    torch.testing.assert_close(out, dilated_attention(q, k, v, *schedule), rtol=0, atol=0)
