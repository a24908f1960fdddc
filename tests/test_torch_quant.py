"""The port's quantized tile tier held against the JAX package on the CPU.

Inputs come from numpy seeds and go to both packages as the same arrays.
On the CPU the port's ``q_matmul`` and ``q_flash_attention`` run their
plain versions; the JAX Pallas kernels run in interpret mode.

Tolerances: the quantized data and scales are bit-equal (both packages do
the same IEEE fp32 operations); the matmul 1e-5 (both sum exact fp32
products, in other orders), and bit-equal with QuantDense's scale, bias
and cast where the sums are exact in any order; the attention against the Pallas kernel 5e-3
on the output (the kernel rounds its unnormalized probabilities to bf16,
the reference its normalized ones) and 1e-4 on the lse, as the JAX
package's own tests; against the JAX reference 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from gigapath_tpu.quant import convert as jconvert
from gigapath_tpu.quant import parity as jparity
from gigapath_tpu.quant import qflash as jqflash
from gigapath_tpu.quant import qmatmul as jqmatmul
from gigapath_tpu.quant import qtensor as jqt
from gigapath_tpu_torch.quant import convert as pconvert
from gigapath_tpu_torch.quant import qflash as pqflash
from gigapath_tpu_torch.quant import qmatmul as pqmatmul
from gigapath_tpu_torch.quant import qtensor as pqt
from gigapath_tpu_torch.utils.convert import flax_params_from_state_dict, state_dict_from_flax_params

MODES = ["int8", "fp8_e4m3"]


def _bits(a) -> np.ndarray:
    """The raw bytes of a JAX or port quantized array (fp8 has no numpy
    dtype of its own on the port side)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy() if a.dtype == torch.float8_e4m3fn else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype != np.int8 else a


def _port_qt(jax_qt) -> pqt.QTensor:
    """A JAX [K, N] QTensor as the port's [N, K] one (same numbers)."""
    data = np.ascontiguousarray(_bits(jax_qt.data).T)
    data = torch.from_numpy(data)
    if jax_qt.mode == "fp8_e4m3":
        data = data.view(torch.float8_e4m3fn)
    return pqt.QTensor(data, torch.from_numpy(np.asarray(jax_qt.scale).reshape(-1, 1).copy()))


# ---------------------------------------------------------------------------
# qtensor
# ---------------------------------------------------------------------------


def test_normalize_mode_matches_jax():
    for spelling in ["", "0", "false", "No", "1", "true", "int8", " INT8 ", "fp8", "e4m3",
                     "float8_e4m3", "fp8_e4m3", "int8+attn", "fp8+attn", "0+attn"]:
        assert pqt.normalize_mode(spelling) == jqt.normalize_mode(spelling), spelling
        assert pqt.base_mode(spelling) == jqt.base_mode(spelling)
        assert pqt.quant_attn(spelling) == jqt.quant_attn(spelling)
    for bad in ["int4", "int8+kv", "bf16"]:
        with pytest.raises(ValueError):
            pqt.normalize_mode(bad)


@pytest.mark.parametrize("mode", MODES)
def test_quantize_per_channel_is_bit_equal_to_jax(mode):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((96, 80)) * rng.uniform(0.01, 3.0, size=(1, 80))).astype(np.float32)
    w[:, 5] = 0.0  # an all-zero channel keeps scale 1 and exact zeros
    ref = jqt.quantize_per_channel(w, mode)  # [K, N], scale [1, N]
    ours = pqt.quantize_per_channel(torch.from_numpy(w.T.copy()), mode, axis=0)  # [N, K], [N, 1]
    assert ours.mode == ref.mode == mode
    np.testing.assert_array_equal(_bits(ours.data).T, _bits(ref.data))  # bit-equal
    np.testing.assert_array_equal(ours.scale.numpy().reshape(-1), np.asarray(ref.scale).reshape(-1))
    # the same layout as the JAX kernel gives the same bits too
    same = pqt.quantize_per_channel(torch.from_numpy(w), mode, axis=-1)
    np.testing.assert_array_equal(_bits(same.data), _bits(ref.data))
    np.testing.assert_array_equal(pqt.dequantize(same).numpy(), np.asarray(jqt.dequantize(ref)))


@pytest.mark.parametrize("mode", MODES)
def test_requantization_is_idempotent(mode):
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((48, 32)).astype(np.float32))
    qt = pqt.quantize_per_channel(w, mode, axis=0)
    again = pqt.quantize_per_channel(pqt.dequantize(qt), mode, axis=0)
    np.testing.assert_array_equal(_bits(again.data), _bits(qt.data))
    np.testing.assert_array_equal(again.scale.numpy(), qt.scale.numpy())


def test_quantize_dynamic_is_bit_equal_to_jax():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 3, 37, 16)) * 4).astype(np.float32)
    x[1, 2] = 0.0  # an all-zero (batch, head) keeps scale 1
    ref = jqt.quantize_dynamic(jnp.asarray(x))
    ours = pqt.quantize_dynamic(torch.from_numpy(x))
    np.testing.assert_array_equal(ours.data.numpy(), np.asarray(ref.data))  # bit-equal
    np.testing.assert_array_equal(ours.scale.numpy(), np.asarray(ref.scale))


def test_bf16_round_trip_matches_jax():
    x = np.random.default_rng(3).standard_normal((16, 8)).astype(np.float32)
    np.testing.assert_array_equal(pqt.bf16_round_trip(x), jqt.bf16_round_trip(x))


# ---------------------------------------------------------------------------
# qmatmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_q_matmul_reference_matches_jax_pallas_and_reference(mode):
    rng = np.random.default_rng(4)
    w = rng.standard_normal((256, 128)).astype(np.float32)
    x = rng.standard_normal((2, 9, 256)).astype(np.float32)
    qt = jqt.quantize_per_channel(w, mode)
    pal = np.asarray(jqmatmul.q_matmul_pallas(jnp.asarray(x), qt, interpret=True))
    ref = np.asarray(jqmatmul.q_matmul_reference(jnp.asarray(x), qt))
    ours = pqmatmul.q_matmul(torch.from_numpy(x), _port_qt(qt))  # the CPU runs the plain version
    assert ours.dtype == torch.float32 and ours.shape == (2, 9, 128)
    np.testing.assert_allclose(ours.numpy(), pal, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_q_matmul_ragged_shape_matches_jax_reference(mode):
    """K and N that are no multiple of 128 (the JAX package keeps them on
    its reference tier; the port's kernel takes them)."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((96, 80)).astype(np.float32)
    x = rng.standard_normal((197, 96)).astype(np.float32)
    qt = jqt.quantize_per_channel(w, mode)
    ref = np.asarray(jqmatmul.q_matmul_reference(jnp.asarray(x), qt))
    pqmatmul.reset_launch_counts()
    ours = pqmatmul.q_matmul(torch.from_numpy(x), _port_qt(qt)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)
    assert pqmatmul.LAUNCHES["q_matmul"] == 0  # no kernel on the CPU


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_quant_linear_matches_quant_dense(mode, dtype):
    """QuantLinear holds nn.Linear's parameters and computes QuantDense's
    function from them (fp32 1e-5; bf16 output within one bf16 ulp)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    dense = jqmatmul.QuantDense(40, mode=mode, dtype=getattr(jnp, dtype), name="fc1")
    params = {"kernel": rng.standard_normal((48, 40)).astype(np.float32),
              "bias": rng.standard_normal(40).astype(np.float32)}
    ref = np.asarray(dense.apply({"params": params}, jnp.asarray(x, getattr(jnp, dtype))), np.float32)

    lin = pqmatmul.QuantLinear(48, 40, mode)
    assert set(lin.state_dict()) == set(torch.nn.Linear(48, 40).state_dict())
    lin.load_state_dict(state_dict_from_flax_params(params), strict=True)
    with torch.no_grad():
        out = lin(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert out.dtype == getattr(torch, dtype)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=1e-2, rtol=8e-3)
    np.testing.assert_allclose(out.float().numpy(), ref, **tol)


def test_quant_linear_requantizes_when_the_weight_changes():
    lin = pqmatmul.QuantLinear(16, 8, "int8")
    torch.nn.init.normal_(lin.weight)
    torch.nn.init.zeros_(lin.bias)
    first = lin.quantized_weight()
    assert lin.quantized_weight() is first  # kept while the weight is unchanged
    with torch.no_grad():
        lin.weight.mul_(2.0)
    second = lin.quantized_weight()
    assert second is not first
    np.testing.assert_array_equal(second.scale.numpy(), 2.0 * first.scale.numpy())
    with pytest.raises(ValueError):
        pqmatmul.QuantLinear(16, 8, "")


def _exact_sum_case(mode, K, N, rng):
    """A JAX kernel [K, N] whose quantized values are chosen integers (int8
    in [-127, 127]; fp8 the integers e4m3 holds, up to 448) times a random
    per-channel step, and x of small integers: every product and every
    partial sum of x . q is an integer below 2^24, exact in fp32 in any
    order, so the two packages' matmuls agree bit for bit and only the
    epilogue (scale, bias, cast) is left to compare."""
    if mode == "int8":
        q = rng.integers(-127, 128, size=(K, N)).astype(np.float32)
        q[rng.integers(0, K, size=N), np.arange(N)] = 127.0  # each channel's absmax
    else:
        e4m3 = torch.arange(256, dtype=torch.uint8).view(torch.float8_e4m3fn).float().numpy()
        ints = np.unique(e4m3[np.isfinite(e4m3) & (e4m3 == np.round(e4m3))])
        q = rng.choice(ints, size=(K, N)).astype(np.float32)
        q[rng.integers(0, K, size=N), np.arange(N)] = -448.0
    step = rng.uniform(1e-3, 0.1, size=(1, N)).astype(np.float32)
    return q, (q * step).astype(np.float32)


@pytest.mark.parametrize("K", [1536, 4096, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_q_matmul_fused_reference_is_bit_equal_to_quant_dense(mode, dtype, K):
    """q_matmul_reference(x, qt, bias, dtype) is QuantDense's output bit for
    bit: the product times the scale, plus the fp32 bias, cast (K = 100 goes
    through the zero-pad to 112). Sums exact in any order (see
    _exact_sum_case), so the order of the sums cannot hide a difference in
    the epilogue's roundings."""
    rng = np.random.default_rng(10)
    N = 48
    q, kernel = _exact_sum_case(mode, K, N, rng)
    x = rng.integers(-4, 5, size=(2, 5, K)).astype(np.float32)
    bias = rng.standard_normal(N).astype(np.float32)
    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
    dense = jqmatmul.QuantDense(N, mode=mode, dtype=jdtype)
    ref = np.asarray(dense.apply({"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x, jdtype)), np.float32)

    qt = pqt.quantize_per_channel(torch.from_numpy(kernel.T.copy()), mode, axis=0)
    np.testing.assert_array_equal(qt.data.float().numpy(), q.T)  # the chosen integers, exactly
    ours = pqmatmul.q_matmul_reference(torch.from_numpy(x).to(tdtype), qt, torch.from_numpy(bias), tdtype)
    assert ours.dtype == tdtype and ours.shape == (2, 5, N)
    np.testing.assert_array_equal(ours.float().numpy(), ref)  # bit-equal


@pytest.mark.parametrize("K", [96, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_q_matmul_fused_epilogue_is_the_three_step_sequence(mode, dtype, K):
    """The fused call equals the unfused sequence QuantLinear ran before:
    fp32 q_matmul, plus the fp32 bias, cast to the compute dtype."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((3, 7, K)).astype(np.float32)).to(getattr(torch, dtype))
    w = torch.from_numpy(rng.standard_normal((40, K)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(40).astype(np.float32))
    qt = pqt.quantize_per_channel(w, mode, axis=0)
    fused = pqmatmul.q_matmul(x, qt, bias, x.dtype)
    three_step = (pqmatmul.q_matmul(x, qt) + bias.float()).to(x.dtype)
    assert fused.dtype == x.dtype
    assert torch.equal(fused, three_step)
    # the fp32 product alone is unchanged by the new arguments' defaults
    assert torch.equal(pqmatmul.q_matmul(x, qt), pqmatmul.q_matmul(x, qt, None, torch.float32))


def test_one_rounding_epilogue_differs_from_two_roundings():
    """Why csrc/q_matmul.cu spells out __fmul_rn and __fadd_rn: one fused
    multiply-add (acc * s + b rounded once, here computed in float64 and
    rounded) differs from torch's and XLA's two fp32 roundings on some
    elements, in fp32 and after the bf16 cast."""
    rng = np.random.default_rng(12)
    acc = (rng.standard_normal(100_000) * 50).astype(np.float32)
    s = rng.uniform(1e-3, 1e-1, size=100_000).astype(np.float32)
    b = rng.standard_normal(100_000).astype(np.float32)
    two = (torch.from_numpy(acc) * torch.from_numpy(s)) + torch.from_numpy(b)
    np.testing.assert_array_equal(two.numpy(), (acc * s).astype(np.float32) + b)  # torch rounds twice
    one = torch.from_numpy((acc.astype(np.float64) * s + b).astype(np.float32))
    assert int((one != two).sum()) > 0
    assert int((one.bfloat16() != two.bfloat16()).sum()) > 0


def test_quant_linear_keeps_a_k_padded_kernel_weight():
    """in_features that is no multiple of 16: QuantLinear keeps the
    quantized weight as it is and a zero-padded copy for the kernel; the
    forward matches the unpadded product."""
    rng = np.random.default_rng(13)
    for in_features, width in ((100, 112), (96, 96)):
        lin = pqmatmul.QuantLinear(in_features, 24, "fp8")
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(rng.standard_normal((24, in_features)).astype(np.float32)))
            lin.bias.copy_(torch.from_numpy(rng.standard_normal(24).astype(np.float32)))
        qt, kt = lin.quantized_weight(), lin.kernel_weight()
        assert qt.data.shape == (24, in_features) and kt.data.shape == (24, width)
        assert (kt is qt) == (width == in_features)
        np.testing.assert_array_equal(_bits(kt.data)[:, :in_features], _bits(qt.data))
        assert not _bits(kt.data)[:, in_features:].any()
        x = torch.from_numpy(rng.standard_normal((5, in_features)).astype(np.float32))
        with torch.no_grad():
            out = lin(x)
        want = (pqmatmul.q_matmul_reference(x, qt) + lin.bias.detach()).numpy()
        np.testing.assert_allclose(out.numpy(), want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# qflash
# ---------------------------------------------------------------------------


def test_q_flash_reference_matches_jax_pallas_interpret():
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((1, 128, 2, 32)).astype(np.float32) for _ in range(3))
    out_p, lse_p = jqflash.q_flash_attention_pallas(*(jnp.asarray(t) for t in (q, k, v)), interpret=True)
    out, lse = pqflash.q_flash_attention(*(torch.from_numpy(t) for t in (q, k, v)))
    assert out.shape == (1, 128, 2, 32) and lse.shape == (1, 2, 128)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_p), atol=5e-3)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_p), atol=1e-4)


@pytest.mark.parametrize("L", [1, 65, 197])
def test_q_flash_reference_matches_jax_reference(L):
    """Any L, the tile encoder's 197 included (fp32 v: 1e-5)."""
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal((2, L, 3, 16)).astype(np.float32) for _ in range(3))
    out_r, lse_r = jqflash.q_flash_attention_reference(*(jnp.asarray(t) for t in (q, k, v)))
    pqflash.reset_launch_counts()
    out, lse = pqflash.q_flash_attention(*(torch.from_numpy(t) for t in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_r), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_r), atol=1e-5, rtol=1e-5)
    assert pqflash.LAUNCHES["q_flash_attention"] == 0  # no kernel on the CPU


def test_q_flash_reference_bf16_v_matches_jax_reference():
    """bf16 q/k/v: the probabilities are rounded to bf16 before PV and the
    output is bf16 in both packages (one bf16 ulp)."""
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal((2, 197, 4, 16)).astype(np.float32) for _ in range(3))
    out_r, lse_r = jqflash.q_flash_attention_reference(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)))
    out, lse = pqflash.q_flash_attention(*(torch.from_numpy(t).bfloat16() for t in (q, k, v)))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(out_r, np.float32), atol=8e-3, rtol=8e-3)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_r), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the artifact
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fixture_params():
    params, images, _ = jparity.load_fixture()
    return params, images


def _flat(tree, prefix=()):
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            yield from _flat(value, prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), value


def _assert_same_qtree(ours, ref):
    ours, ref = dict(_flat(ours)), dict(_flat(ref))
    assert set(ours) == set(ref)
    for key, leaf in ref.items():
        if isinstance(leaf, jqt.QTensor):
            assert isinstance(ours[key], pqt.QTensor), key
            np.testing.assert_array_equal(_bits(ours[key].data), _bits(leaf.data))  # bit-equal
            np.testing.assert_array_equal(ours[key].scale.numpy(), np.asarray(leaf.scale))
        else:
            np.testing.assert_array_equal(np.asarray(ours[key]), np.asarray(leaf))


@pytest.mark.parametrize("mode", MODES)
def test_artifact_saved_by_jax_loads_in_the_port(tmp_path, fixture_params, mode):
    params, _ = fixture_params
    qparams = jconvert.quantize_params(params, mode)
    path = jconvert.save_quantized(str(tmp_path / "jax_artifact"), qparams)
    ours, meta = pconvert.load_quantized(path)
    assert meta["mode"] == mode and meta["n_quantized"] == 8
    _assert_same_qtree(ours, qparams)
    # the port quantizes the same tree to the same bits
    _assert_same_qtree(pconvert.quantize_params(params, mode), qparams)
    deq = dict(_flat(pconvert.dequantize_params(ours)))
    for key, leaf in _flat(jconvert.dequantize_params(qparams)):
        np.testing.assert_array_equal(deq[key], np.asarray(leaf))


@pytest.mark.parametrize("mode", MODES)
def test_artifact_saved_by_the_port_loads_in_jax(tmp_path, fixture_params, mode):
    """The port quantizes its own state dict (through the flax-path tree)
    and saves; the JAX package loads the same tree it would have made."""
    params, _ = fixture_params
    state = state_dict_from_flax_params(params)
    tree = flax_params_from_state_dict(state)
    for key, leaf in _flat(params):
        np.testing.assert_array_equal(dict(_flat(tree))[key], leaf)  # the inverse is exact
    path = pconvert.save_quantized(str(tmp_path / "port_artifact"), pconvert.quantize_params(tree, mode))
    loaded, meta = jconvert.load_quantized(path)
    assert meta["mode"] == mode
    _assert_same_qtree(pconvert.quantize_params(tree, mode), loaded)
    _assert_same_qtree(pconvert.quantize_params(tree, mode), jconvert.quantize_params(params, mode))


def test_corrupt_missing_or_extra_artifact_is_refused(tmp_path, fixture_params):
    params, _ = fixture_params
    qparams = pconvert.quantize_params(params, "int8")
    corrupt = pconvert.save_quantized(str(tmp_path / "corrupt"), qparams)
    with open(os.path.join(corrupt, "arrays.npz"), "r+b") as fh:
        fh.seek(200)
        byte = fh.read(1)
        fh.seek(200)
        fh.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(pconvert.CorruptQuantArtifact):
        pconvert.load_quantized(corrupt)
    extra = pconvert.save_quantized(str(tmp_path / "extra"), qparams)
    with open(os.path.join(extra, "stray.bin"), "wb") as fh:
        fh.write(b"x")
    with pytest.raises(pconvert.CorruptQuantArtifact):
        pconvert.load_quantized(extra)
    missing = pconvert.save_quantized(str(tmp_path / "missing"), qparams)
    os.remove(os.path.join(missing, "meta.json"))
    with pytest.raises(pconvert.CorruptQuantArtifact):
        pconvert.load_quantized(missing)
    # and the JAX package refuses the port's corrupt artifact too
    with pytest.raises(jconvert.CorruptQuantArtifact):
        jconvert.load_quantized(corrupt)


def test_create_tile_encoder_loads_a_jax_artifact(tmp_path, fixture_params):
    """The port's factory loads a JAX-written artifact (verified, then
    dequantized) and embeds the fixture images as the JAX model does with
    the dequantized weights (fp32, 1e-5)."""
    from gigapath_tpu_torch.models.tile_encoder import create_tile_encoder

    params, images = fixture_params
    qparams = jconvert.quantize_params(params, "int8")
    path = jconvert.save_quantized(str(tmp_path / "artifact"), qparams)
    model = create_tile_encoder(path, "vit_tile_enc_test", device="cpu", quant="")
    jmodel = jparity.build_variant("vit_tile_enc_test", dtype_name="float32")
    ref = jparity.encode(jmodel, jconvert.dequantize_params(qparams), images[:8])
    with torch.no_grad():
        ours = model(torch.from_numpy(images[:8])).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)


def test_quant_dense_param_surface_is_nn_linear():
    """Both twins keep their unquantized layer's parameter surface."""
    x = jnp.ones((2, 16))
    p = jqmatmul.QuantDense(8, mode="int8", name="fc1").init(jax.random.PRNGKey(0), x)["params"]
    q = nn.Dense(8, name="fc1").init(jax.random.PRNGKey(0), x)["params"]
    assert {k: v.shape for k, v in p.items()} == {k: v.shape for k, v in q.items()}
    lin = pqmatmul.QuantLinear(16, 8, "fp8")
    assert {k: tuple(v.shape) for k, v in lin.state_dict().items()} == {
        k: tuple(v.shape) for k, v in state_dict_from_flax_params(q).items()}
