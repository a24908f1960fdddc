"""The port's head-major dilated route held against the JAX package.

``dilated_attention_bhld`` on the CPU (each kernel wrapper through its plain
version) against the JAX one with its Pallas kernels in interpret mode and
with its plain tier (``use_pallas=False``): the stacked and the streaming
fusion, a static and a per-row ``valid_len``, forward (fp32, 1e-5) and
gradients (1e-4). Then the dispatch of a ratio that does not divide H, the
tiny slide encoder on that route against the JAX model, the feed-forward
GELU's bit-equality with an explicit fp32 round trip, and the kernel calls
of the route. Inputs come from a numpy seed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test process)

from gigapath_tpu.models.slide_encoder import create_model as jax_create_model
from gigapath_tpu.ops import dilated_attention as jda
from gigapath_tpu_torch.models import slide_encoder as port_se
from gigapath_tpu_torch.ops import dilated_attention as pda
from gigapath_tpu_torch.ops import flash_kernels as fk
from gigapath_tpu_torch.ops.feedforward import FeedForwardNetwork
from gigapath_tpu_torch.utils.convert import state_dict_from_flax_params

FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
# H = 8: r = 3 and 6 do not divide it (phases of 3, 3, 2 heads; 4 of 6
# phases hold a head); r = 1 at g = 16 takes the flat kernel, r = 1 at g =
# 100 (L = 100) the segmented one
B, L, H, DH = 2, 100, 8, 8
SCHEDULE = ((16, 40, 128), (1, 3, 6))
SCHEDULE_SEGMENTED_R1 = ((100, 40), (1, 3))
VALID = np.array([100, 63], np.int32)


def _data(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _inputs(seed=0):
    return [_data(seed + i, B, L, H, DH) for i in range(4)]


@functools.partial(jax.jit, static_argnums=(5, 6, 7, 8, 9))
def _jax_bhld(q, k, v, do, valid, schedule, use_pallas, streaming, static_len, valid_is_none):
    vl = None if valid_is_none else (static_len if static_len is not None else valid)

    def f(a, b, c):
        return jda.dilated_attention_bhld(
            a, b, c, list(schedule[0]), list(schedule[1]), valid_len=vl, interpret=True,
            use_pallas=use_pallas, streaming_fusion=streaming)

    out, vjp = jax.vjp(f, q, k, v)
    return out, vjp(do)


def _port_bhld(q, k, v, do, schedule, valid_len, streaming, use_pallas=None):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = pda.dilated_attention_bhld(qt, kt, vt, *schedule, valid_len=valid_len, streaming_fusion=streaming,
                                     use_pallas=use_pallas)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [t.grad.numpy() for t in (qt, kt, vt)]


def _assert_close(ours, ref):
    out, grads = ours
    np.testing.assert_allclose(out, np.asarray(ref[0]), **FWD_TOL)
    for name, a, b in zip(("dq", "dk", "dv"), grads, ref[1]):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["kernels", "plain"])
@pytest.mark.parametrize("streaming", [False, True], ids=["stacked", "streaming"])
@pytest.mark.parametrize("valid", ["none", "static", "per_row"])
def test_bhld_matches_jax(use_pallas, streaming, valid):
    """The port's kernel route against the JAX kernel route (interpret
    mode), and the port's plain tier against the JAX plain tier."""
    q, k, v, do = _inputs()
    static_len = 71 if valid == "static" else None
    ref = _jax_bhld(*(jnp.asarray(x) for x in (q, k, v, do)), jnp.asarray(VALID), SCHEDULE, use_pallas,
                    streaming, static_len, valid == "none")
    valid_len = {"none": None, "static": static_len, "per_row": torch.from_numpy(VALID)}[valid]
    _assert_close(_port_bhld(q, k, v, do, SCHEDULE, valid_len, streaming,
                             use_pallas=None if use_pallas else False), ref)


def test_bhld_segmented_r1_branch_matches_jax():
    """An undilated branch the flat kernel does not take (g = L = 100, not a
    multiple of 8) runs the segmented kernel, as in the JAX package."""
    q, k, v, do = _inputs(10)
    assert not pda._flat_eligible(100, 1) and pda._flat_eligible(16, 1)
    ref = _jax_bhld(*(jnp.asarray(x) for x in (q, k, v, do)), jnp.asarray(VALID), SCHEDULE_SEGMENTED_R1, True,
                    False, None, True)
    _assert_close(_port_bhld(q, k, v, do, SCHEDULE_SEGMENTED_R1, None, False), ref)


@pytest.mark.parametrize("L_,sl,r,rl", [(100, 40, 3, 100), (100, 128, 6, 71), (37, 16, 3, 30)])
def test_bhld_kvlen_matches_jax(L_, sl, r, rl):
    """The count tables: static ones, and per-row ones counted on the
    device, as the JAX package's _bhld_kvlen."""
    g, Lp, n, gp, m = pda._bhld_geom(L_, sl, r)
    assert (g, Lp, n, gp, m) == jda._bhld_geom(L_, sl, r)[:5]
    for vdyn in (None, np.array([L_, 17], np.int32)):
        ours = pda._bhld_kvlen(2, H, n, g, r, m, rl, None if vdyn is None else torch.from_numpy(vdyn), "cpu")
        ref = jda._bhld_kvlen(2, H, n, g, r, m, rl, None if vdyn is None else jnp.asarray(vdyn))
        if ref is None:
            assert ours is None
        else:
            assert ours.dtype == torch.int32
            np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_ratio_not_dividing_heads_dispatches_to_bhld_once(monkeypatch):
    """The schedule of tests/test_dilated_attention.py's head-major
    fallback test ([8, 12] / [1, 3] at H = 4): the public dilated_attention
    warns once and matches the JAX package."""
    monkeypatch.setattr(pda, "_WARNED", set())
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(1, 24, 4, 8)).astype(np.float32) for _ in range(3))
    ref = jda.dilated_attention(*(jnp.asarray(x) for x in (q, k, v)), [8, 12], [1, 3])
    with pytest.warns(UserWarning, match="head-major") as record:
        out = pda.dilated_attention(*(torch.from_numpy(x) for x in (q, k, v)), [8, 12], [1, 3])
        again = pda.dilated_attention(*(torch.from_numpy(x) for x in (q, k, v)), [8, 12], [1, 3])
    assert sum("head-major" in str(w.message) for w in record) == 1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD_TOL)
    torch.testing.assert_close(out, again, rtol=0, atol=0)


WRAPPERS = tuple(fk.LAUNCHES)


@pytest.fixture
def calls(monkeypatch):
    """Count the calls of each segment-flash wrapper (each one launch on the
    card), which still run their plain versions here."""
    counts = dict.fromkeys(WRAPPERS, 0)
    for name in WRAPPERS:
        real = getattr(fk, name)

        def counting(*a, _name=name, _real=real, **kw):
            counts[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(fk, name, counting)
    return counts


@pytest.mark.parametrize("valid", ["none", "per_row"])
def test_route_kernel_calls(valid, calls):
    """The flat kernel takes the r = 1 branch at g = 16 unless rows carry
    their own valid lengths; every other branch takes the segmented one,
    forward and backward."""
    q, k, v, _ = _inputs(20)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = pda.dilated_attention_bhld(qt, kt, vt, *SCHEDULE,
                                     valid_len=torch.from_numpy(VALID) if valid == "per_row" else None)
    out.sum().backward()
    n_flat = 1 if valid == "none" else 0
    n_seg = len(SCHEDULE[0]) - n_flat
    assert calls == {"flash_fwd": n_seg, "flash_bwd_dq": n_seg, "flash_bwd_dkv": n_seg,
                     "flat_fwd": n_flat, "flat_bwd_dq": n_flat, "flat_bwd_dkv": n_flat}


def test_tiny_slide_encoder_on_the_head_major_route(calls):
    """gigapath_slide_enc_tiny (H = 16) with ratios 3 and 6, which do not
    divide its heads, against the JAX model through
    state_dict_from_flax_params, every layer's embedding at 1e-4; both
    layers run the route's kernels. On the CPU the JAX model takes its
    generic path, which agrees with its head-major route where every
    segment (L = 72 with the cls token) divides by its ratio; elsewhere the
    generic path also admits a segment's dilation padding as keys, and
    test_bhld_matches_jax holds the route against the JAX route itself."""
    kw = dict(segment_length=[16, 48, 96], dilated_ratio="[1, 3, 6]", dropout=0.0, drop_path_rate=0.0)
    jmodel, params = jax_create_model("", "gigapath_slide_enc_tiny", in_chans=24, **kw)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 71, 24)).astype(np.float32)
    coords = rng.integers(0, 40 * 256, size=(1, 71, 2)).astype(np.float32)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32), params)
    ref = jax.jit(lambda p, a, c: jmodel.apply({"params": p}, a, c, all_layer_embed=True))(
        params, jnp.asarray(x), jnp.asarray(coords))
    model = port_se.create_model("", "gigapath_slide_enc_tiny", in_chans=24, device="cpu", **kw)
    model.load_state_dict(state_dict_from_flax_params(params), strict=True)
    with pytest.warns(UserWarning, match="head-major"), torch.no_grad():
        pda._WARNED.clear()
        ours = model(torch.from_numpy(x), torch.from_numpy(coords), all_layer_embed=True)
    assert len(ours) == len(ref) == 3
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-4, rtol=1e-4)
    assert calls["flat_fwd"] == 2 and calls["flash_fwd"] == 4


@pytest.mark.parametrize("activation", ["gelu", "swish", "relu"])
def test_ffn_activation_in_its_dtype_is_bit_equal_to_the_fp32_round_trip(activation):
    """The feed-forward block applies its activation to the bf16 fc1 output
    directly; that equals the explicit fp32 round trip bit for bit."""
    torch.manual_seed(0)
    ffn = FeedForwardNetwork(64, 256, activation_fn=activation).to(torch.bfloat16).eval()
    x = torch.randn(3, 97, 64, dtype=torch.bfloat16) * 4
    h = ffn.fc1(x)
    explicit = ffn.fc2(ffn.act(h.float()).to(h.dtype))
    assert torch.equal(ffn.act(h), ffn.act(h.float()).to(h.dtype))
    assert torch.equal(ffn(x), explicit)


def test_slide_encoder_keeps_no_full_hidden_state(monkeypatch):
    """With all_layer_embed the encoder hands each state to the readout as
    its layer finishes and keeps only the [B, E] reductions; a caller that
    passes no readout still gets the full states."""
    model = port_se.create_model("", "gigapath_slide_enc_tiny", in_chans=24, device="cpu")
    x, coords = torch.randn(2, 30, 24), torch.rand(2, 30, 2) * 4096
    seen = []
    real = model.encoder.forward

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen.append([tuple(s.shape) for s in out["encoder_states"]])
        return out

    monkeypatch.setattr(model.encoder, "forward", spy)
    with torch.no_grad():
        embeds = model(x, coords, all_layer_embed=True)
        full = real(model.patch_embed(x), return_all_hiddens=True)["encoder_states"]
    assert seen == [[(2, 32)] * 3] and [tuple(s.shape) for s in full] == [(2, 30, 32)] * 3
    assert all(e.shape == (2, 32) for e in embeds)
