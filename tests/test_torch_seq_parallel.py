"""The port's sequence-parallel dilated attention held against the JAX
package's ``shard_map`` on the CPU.

The JAX side runs on four of the conftest's eight virtual CPU devices, a
``seq`` mesh axis of 4; the port side runs in four rank processes
(``tests/torch_rank_bodies.py``) joined in one gloo group over a
``FileStore`` under the test's temporary directory, every case in that one
group. Same numpy-seeded inputs and the same encoder weights on both
sides. Tolerances are the JAX package's own: the gathered forward within
atol 2e-5 / rtol 1e-4 of the reference, the ring within 1e-5 of the gather
and of JAX's ring, gradients of ``(out**2).sum()`` within 1e-4. The
shard's 8 tokens against the schedule's 16- and 32-token segments give
both a two-rank sub-ring and the four-rank ring. The ragged cases cut the
sequence inside rank 2 (20 valid tokens of 32).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test process)
from jax.sharding import Mesh, PartitionSpec as P

import torch_rank_bodies as rb
from gigapath_tpu.models.longnet import make_longnet_from_name as jax_make_longnet
from gigapath_tpu.ops import dilated_attention as jda
from gigapath_tpu.ops.pallas_dilated import PipelineFlags as JaxFlags
from gigapath_tpu.ops.pallas_dilated import snapshot_flags as jax_snapshot_flags
from gigapath_tpu.parallel.sharding import shard_map_compat
from gigapath_tpu_torch.obs.spans import ring_step
from gigapath_tpu_torch.ops import dilated_attention as pda
from gigapath_tpu_torch.ops.dilated_kernels import snapshot_flags
from gigapath_tpu_torch.utils.convert import flax_params_from_state_dict

W, N, H, DH = rb.SEQ_WORLD, rb.SEQ_N, rb.SEQ_H, rb.SEQ_DH
FLAGSHIP = ([1024, 5792, 32768, 185363, 1048576], [1, 2, 4, 8, 16])
# where the JAX package's sharded op raises; the port raises there too
REFUSALS = [
    dict(name="flagship_w4", sls=FLAGSHIP[0], drs=FLAGSHIP[1], n=4 * 8192, heads=16, dh=48, meta=True),
    dict(name="segment_not_a_multiple_of_the_shard", sls=[4, 12], drs=[1, 2]),
    dict(name="ranks_above_the_group", sls=[4, 64], drs=[1, 2]),
    dict(name="ranks_above_the_group_ring", sls=[4, 64], drs=[1, 2], ring=True),
    dict(name="ranks_not_dividing_the_group_ring", sls=[4, 24], drs=[1, 2], ring=True),
    dict(name="offset", sls=[4, 16], drs=[1, 2], offset=8),
    dict(name="static_int_valid_len", sls=[4, 16], drs=[1, 2], valid_len=5),
    dict(name="causal_ragged", sls=[4, 16], drs=[1, 2], causal=True, valid_len=[8, 8, 4, 0]),
]
# where the JAX package's sharded op runs to another function than its
# single-device op; the port refuses them
PORT_ONLY = [
    dict(name="ratio_not_dividing_the_shard", sls=[6, 12], drs=[1, 4], n=24),
    dict(name="segment_not_dividing_the_shard", sls=[6, 16], drs=[1, 2]),
    dict(name="ranks_not_dividing_the_group", sls=[4, 24], drs=[1, 2]),
]
for _case in REFUSALS + PORT_ONLY:
    _case.setdefault("n", N)
    _case.setdefault("heads", H)
    _case.setdefault("dh", DH)
    _case["world"] = W


def _mesh():
    return Mesh(np.array(jax.devices()[:W]), ("seq",))


def _jax_sharded(sls, drs, *, flags=None, causal=False, ragged=False, offset=0, static_valid=None):
    """JAX's dilated_attention under shard_map over the seq axis; the
    per-shard valid counts come from the sharded pad mask, as
    ``DilatedAttention._attend`` derives them."""
    shard_map, check_kw = shard_map_compat()

    def local(q, k, v, pad):
        valid = (~pad).sum(axis=-1).astype(jnp.int32) if ragged else static_valid
        return jda.dilated_attention(q, k, v, sls, drs, is_causal=causal, offset=offset, valid_len=valid,
                                     seq_axis_name="seq", seq_axis_size=W, flags=flags or JaxFlags())

    return shard_map(local, mesh=_mesh(), in_specs=(P(None, "seq"),) * 4, out_specs=P(None, "seq"), **check_kw)


def _jax_refusal(case) -> str:
    n, hd = case["n"], (case["heads"], case["dh"])
    q = jax.ShapeDtypeStruct((1, n) + hd, jnp.float32)
    kv = jax.ShapeDtypeStruct((1, n + W * case.get("offset", 0)) + hd, jnp.float32)
    valid = case.get("valid_len")
    pad = jax.ShapeDtypeStruct((1, n), jnp.bool_)
    fn = _jax_sharded(case["sls"], case["drs"], flags=JaxFlags(ring_attn=case.get("ring", False)),
                      causal=case.get("causal", False), ragged=isinstance(valid, list),
                      offset=case.get("offset", 0), static_valid=valid if isinstance(valid, int) else None)
    try:
        jax.eval_shape(fn, q, kv, kv, pad)
    except Exception as e:  # the type is what the test compares
        return type(e).__name__
    return "ok"


def _jax_attention(q, k, v, pad, vmask):
    """Forward and gradients of every rank case on the JAX side (the
    causal ring case has none: JAX takes the gather path there too; the
    head-major case is held against the port's single-device op, whose
    route the head-major tests hold against JAX)."""
    out = {}
    for name, ((sls, drs), ring, causal, ragged) in rb.SEQ_CASES.items():
        if name in ("causal_ring", "headmajor_ragged"):
            continue
        fn = _jax_sharded(sls, drs, flags=JaxFlags(ring_attn=ring), causal=causal, ragged=ragged)
        weight = vmask if ragged else 1.0

        def loss(q, k, v, fn=fn, weight=weight):
            o = fn(q, k, v, pad)
            return ((o * weight) ** 2).sum(), o

        (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
        out[name] = o
        for g, x in zip(("dq", "dk", "dv"), grads):
            out[f"{name}_{g}"] = x
    return out


def _jax_encoder(x, params):
    shard_map, check_kw = shard_map_compat()
    sls, drs = rb.SEQ_SCHEDULE
    enc, _ = jax_make_longnet(
        f"LongNet_{rb.SEQ_ENCODER['layers']}_layers_{rb.SEQ_ENCODER['embed_dim']}_dim",
        dilated_ratio=drs, segment_length=sls, drop_path_rate=0.0, dropout=0.0, seq_parallel=True,
        seq_axis_name="seq", seq_axis_size=W, encoder_attention_heads=rb.SEQ_ENCODER["heads"],
        encoder_ffn_embed_dim=rb.SEQ_ENCODER["ffn"],
    )
    fn = shard_map(lambda p, x: enc.apply({"params": p}, token_embeddings=x)["encoder_out"], mesh=_mesh(),
                   in_specs=(P(), P(None, "seq")), out_specs=P(None, "seq"), **check_kw)
    return {"encoder_gather": fn(params, x)}


def _jax_port_only(inputs):
    """Per PORT_ONLY case, the largest difference between JAX's sharded op
    and its single-device op on the same inputs."""
    out = {}
    for case in PORT_ONLY:
        qq, kk, vv = inputs[case["name"]]
        sharded = _jax_sharded(case["sls"], case["drs"])(qq, kk, vv, jnp.zeros(qq.shape[:2], bool))
        single = jda.dilated_attention(qq, kk, vv, case["sls"], case["drs"])
        out[f"port_only_{case['name']}"] = jnp.abs(sharded - single).max()
    return out


def _encoder_state():
    """The port encoder's seeded weights with non-trivial norms and biases;
    JAX takes the same values through the inverse of the state-dict
    conversion."""
    from gigapath_tpu_torch.models.longnet import make_longnet_from_name

    sls, drs = rb.SEQ_SCHEDULE
    torch.manual_seed(0)
    model, _ = make_longnet_from_name(
        f"LongNet_{rb.SEQ_ENCODER['layers']}_layers_{rb.SEQ_ENCODER['embed_dim']}_dim",
        dilated_ratio=drs, segment_length=sls, drop_path_rate=0.0, dropout=0.0,
        encoder_attention_heads=rb.SEQ_ENCODER["heads"], encoder_ffn_embed_dim=rb.SEQ_ENCODER["ffn"],
    )
    rng = np.random.default_rng(1)
    return {k: v + torch.from_numpy(0.05 * rng.normal(size=tuple(v.shape)).astype(np.float32))
            for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's results (every rank's, in rank order) and the JAX
    side's, for every case. The ranks run while the JAX side computes."""
    work = str(tmp_path_factory.mktemp("seq_parallel"))
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(1, N, H, DH)).astype(np.float32) for _ in range(3))
    x = rng.normal(size=(1, N, rb.SEQ_ENCODER["embed_dim"])).astype(np.float32)
    np.savez(f"{work}/inputs.npz", q=q, k=k, v=v, x=x)
    state = _encoder_state()
    params = flax_params_from_state_dict(state)
    torch.save(state, f"{work}/encoder_state.pt")
    with open(f"{work}/refusals.json", "w") as f:
        json.dump(REFUSALS + PORT_ONLY, f)
    procs = rb.start_ranks(rb.seq_parallel_rank, W, work)
    try:
        pad = np.zeros((1, N), bool)
        pad[:, rb.SEQ_VALID:] = True
        vmask = (~pad).astype(np.float32)[:, :, None, None]
        port_only = {c["name"]: tuple(rng.normal(size=(1, c["n"], H, DH)).astype(np.float32) for _ in range(3))
                     for c in PORT_ONLY}

        def jax_side(q, k, v, x, params, port_only):  # one program: one trace, one compile
            return {**_jax_attention(q, k, v, pad, vmask), **_jax_encoder(x, params),
                    **_jax_port_only(port_only)}

        jax_out = jax.tree_util.tree_map(np.asarray, jax.jit(jax_side)(q, k, v, x, params, port_only))
        jax_out.update({f"refusal_{c['name']}": _jax_refusal(c) for c in REFUSALS})
    finally:
        ranks = rb.join_ranks(procs, work)
    port = {key: np.concatenate([r[key] for r in ranks], axis=1) for key in ranks[0]
            if not key.startswith(("single_", "refusal_"))}
    port.update({key: val for key, val in ranks[0].items() if key.startswith("single_")})
    port.update({key: [str(r[key]) for r in ranks] for key in ranks[0] if key.startswith("refusal_")})
    return port, jax_out, vmask


def _weight(case, vmask):
    return vmask if rb.SEQ_CASES[case][3] else 1.0


GRADS = ("dq", "dk", "dv")
JAX_CASES = [c for c in rb.SEQ_CASES if c not in ("causal_ring", "headmajor_ragged")]


@pytest.mark.parametrize("case", JAX_CASES)
def test_forward_matches_jax_shard_map(runs, case):
    port, jax_out, vmask = runs
    tol = dict(atol=1e-5, rtol=0) if rb.SEQ_CASES[case][1] else dict(atol=2e-5, rtol=1e-4)
    w = _weight(case, vmask)
    np.testing.assert_allclose(port[case] * w, jax_out[case] * w, **tol)


@pytest.mark.parametrize("case", JAX_CASES)
def test_gradients_match_jax_shard_map(runs, case):
    port, jax_out, _ = runs
    for g in GRADS:
        np.testing.assert_allclose(port[f"{case}_{g}"], jax_out[f"{case}_{g}"], atol=1e-4, rtol=1e-4,
                                   err_msg=g)


@pytest.mark.parametrize("case", list(rb.SEQ_CASES))
def test_matches_the_single_device_op(runs, case):
    """Every rank case against the port's own op on the whole sequence."""
    port, _, vmask = runs
    w = _weight(case, vmask)
    np.testing.assert_allclose(port[case] * w, port[f"single_{case}"] * w, atol=2e-5, rtol=1e-4)
    for g in GRADS:
        np.testing.assert_allclose(port[f"{case}_{g}"], port[f"single_{case}_{g}"], atol=1e-4, rtol=1e-4,
                                   err_msg=g)


@pytest.mark.parametrize("ring,gather", [("ring", "gather"), ("ragged_ring", "ragged_gather"),
                                         ("causal_ring", "causal_gather")])
def test_ring_matches_gather(runs, ring, gather):
    """The ring against the gather path; a causal call with the ring flag
    takes the gather path itself (one warning), so it is bit-equal."""
    port, _, vmask = runs
    w = _weight(ring, vmask)
    if ring == "causal_ring":
        for key in ("",) + tuple(f"_{g}" for g in GRADS):
            np.testing.assert_array_equal(port[ring + key], port[gather + key])
        return
    np.testing.assert_allclose(port[ring] * w, port[gather] * w, atol=1e-5, rtol=0)
    for g in GRADS:
        np.testing.assert_allclose(port[f"{ring}_{g}"], port[f"{gather}_{g}"], atol=1e-4, rtol=1e-4, err_msg=g)


def test_encoder_matches_jax_shard_map(runs):
    """The 2-layer LongNet encoder, seq-sharded on the gather path,
    against JAX's shard_map'd encoder on the same weights (fp32 1e-4, the
    encoder tests' tolerance)."""
    port, jax_out, _ = runs
    np.testing.assert_allclose(port["encoder_gather"], jax_out["encoder_gather"], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("case", list(rb.SEQ_ENCODER_CASES))
def test_encoder_matches_the_single_device_encoder(runs, case):
    """Both encoder cases against the port's encoder on one device. The
    ragged ring case passes each rank's slice of one pad mask whose counts
    are equal on every row: ``DilatedAttention`` keeps them a per-rank [B]
    tensor under sequence parallelism (a static int would be refused on
    the sharded branches)."""
    port, _, _ = runs
    np.testing.assert_allclose(port[case], port[f"single_{case}"], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("case", REFUSALS, ids=[c["name"] for c in REFUSALS])
def test_raises_where_jax_raises(runs, case):
    """Where the JAX package asserts (or fails to trace) the port raises
    ValueError; where it raises NotImplementedError, so does the port."""
    port, jax_out, _ = runs
    ref = jax_out[f"refusal_{case['name']}"]
    assert ref != "ok", ref
    want = "NotImplementedError" if ref == "NotImplementedError" else "ValueError"
    assert port[f"refusal_{case['name']}"] == [want] * W


@pytest.mark.parametrize("case", PORT_ONLY, ids=[c["name"] for c in PORT_ONLY])
def test_refuses_where_jax_differs_from_its_single_device_op(runs, case):
    port, jax_out, _ = runs
    assert float(jax_out[f"port_only_{case['name']}"]) > 1e-3
    assert port[f"refusal_{case['name']}"] == ["ValueError"] * W


@pytest.mark.parametrize("world,rps", [(4, 4), (4, 2), (8, 8), (8, 4), (8, 2), (6, 3)])
def test_ring_perm_matches_jax(world, rps):
    assert pda._ring_perm(world, rps) == jda._ring_perm(world, rps)


@pytest.mark.parametrize("g,r", [(16, 1), (16, 2), (16, 4), (10, 4), (12, 3)])
def test_dense_sparse_round_trip_matches_jax(g, r):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, g, 4, 8)).astype(np.float32)
    sparse = pda.dense_to_sparse(torch.from_numpy(x), r)
    lse = rng.normal(size=(2, 4, sparse.shape[1])).astype(np.float32)
    out, lse_d = pda.sparse_to_dense(sparse, torch.from_numpy(lse), r, g)
    ref_sparse, (ref_out, ref_lse) = jax.jit(
        lambda x, s, lse: (jda.dense_to_sparse(x, r), jda.sparse_to_dense(s, lse, r, g)))(x, sparse.numpy(), lse)
    np.testing.assert_array_equal(sparse.numpy(), np.asarray(ref_sparse))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out))
    np.testing.assert_array_equal(lse_d.numpy(), np.asarray(ref_lse))


@pytest.mark.parametrize("var,field", [("GIGAPATH_RING_ATTN", "ring_attn"),
                                       ("GIGAPATH_CHUNKED_PREFILL", "chunked_prefill")])
@pytest.mark.parametrize("value", ["1", "0"])
def test_flag_snapshot_matches_jax(monkeypatch, var, field, value):
    monkeypatch.setenv(var, value)
    assert getattr(snapshot_flags(), field) == getattr(jax_snapshot_flags(), field) == (value == "1")


def test_ring_step_names_a_profiler_region():
    """The JAX package's step name, on a ``torch.profiler`` region."""
    region = ring_step(0, 4, 128)
    assert isinstance(region, torch.profiler.record_function)
    assert region.name == "ring_step_1of4_comm128B"
