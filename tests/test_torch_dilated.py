"""The port's dilated-attention kernels and op held against the JAX package.

Inputs come from a numpy seed and go through both sides. On the CPU each
port kernel wrapper runs its plain PyTorch version; the JAX side runs its
Pallas kernels in interpret mode (as tests/test_dilated_attention.py does)
or its generic jnp path. Packed tensors are compared on rows [:m] only:
the two packages pad the packed row axis differently.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test process)

from gigapath_tpu.ops import pallas_dilated as jpd
from gigapath_tpu.ops.attention import attention_with_lse as jax_attention_with_lse
from gigapath_tpu.ops.dilated_attention import dilated_attention as jax_dilated_attention
from gigapath_tpu.ops.dilated_attention import dyn_sparse_counts as jax_dyn_sparse_counts
from gigapath_tpu_torch.ops import dilated_kernels as dk
from gigapath_tpu_torch.ops.attention import attention_with_lse
from gigapath_tpu_torch.ops.dilated_attention import dilated_attention

H, DH = 16, 4
E = H * DH
FLAGS = jpd.PipelineFlags()  # the default dispatch: serial kernel, padded pack

# (L, sl, r, real_len): ragged tails, S > 1, a segment not divisible by r,
# and every ratio of the LongNet schedule
BRANCH_CASES = [
    (300, 64, 1, 300),
    (300, 64, 2, 277),
    (300, 128, 4, 250),
    (100, 30, 4, 100),
    (300, 512, 8, 300),
    (300, 512, 16, 211),
]


def _data(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax_branch(q, k, v, sl, r, valid_len_dyn=None, **kw):
    """The JAX branch op in interpret mode, jitted (one compile instead of
    one per eager op)."""
    fn = jax.jit(functools.partial(
        jpd.dilated_branch_attention, sl=sl, r=r, num_heads=H,
        interpret=True, flags=FLAGS, **kw,
    ))
    return fn(*(jnp.asarray(x) for x in (q, k, v)), valid_len_dyn=valid_len_dyn)


def _dtype_cases(cases):
    """Each case in fp32 under its old id, then in bf16 (ids ending -bf16)."""
    ids = ["-".join(map(str, c)) for c in cases]
    return ([pytest.param(*c, torch.float32, id=i) for c, i in zip(cases, ids)]
            + [pytest.param(*c, torch.bfloat16, id=f"{i}-bf16") for c, i in zip(cases, ids)])


def _both(x: np.ndarray, dtype: torch.dtype):
    """The same values in the port's and JAX's ``dtype`` (one rounding of
    the fp32 draw each, to nearest even on both sides)."""
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return torch.from_numpy(x).to(dtype), jnp.asarray(x, dtype=jdtype)


def _f32(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a.astype(jnp.float32))


@pytest.mark.parametrize("L,sl,r,rl,dtype", _dtype_cases(BRANCH_CASES))
def test_pack_phases_matches_jax(L, sl, r, rl, dtype):
    x, jx = _both(_data(0, 2, L, E), dtype)
    g, S, m, Mp = dk._branch_geometry(L, sl, r)
    jg, jS, _, jm, jMp, _ = jpd._branch_geometry(L, E, sl, r)
    assert (g, S, m) == (jg, jS, jm)
    packed = dk.pack_phases(x, g, S, r, Mp, H)
    assert packed.dtype == dtype
    ours = _f32(packed)
    ref = _f32(jpd._pack_phases(jx, g, S, r, jMp, H, True))
    assert ours.shape == (2, S, r, H // r, Mp, DH)
    np.testing.assert_array_equal(ours[:, :, :, :, :m], ref[:, :, :, :, :m])
    assert not ours[:, :, :, :, m:].any()  # row padding is exact zeros


@pytest.mark.parametrize("L,sl,r,rl,dtype", _dtype_cases(BRANCH_CASES))
def test_unpack_phases_matches_jax(L, sl, r, rl, dtype):
    g, S, m, Mp = dk._branch_geometry(L, sl, r)
    jMp = jpd._branch_geometry(L, E, sl, r)[4]
    p6 = np.zeros((2, S, r, H // r, max(Mp, jMp), DH), np.float32)
    p6[:, :, :, :, :m] = _data(1, 2, S, r, H // r, m, DH)
    tp6, jp6 = _both(p6, dtype)
    dense = dk.unpack_phases(tp6[:, :, :, :, :Mp].contiguous(), L, E, g, S, r)
    assert dense.dtype == dtype
    ours = _f32(dense)
    ref = _f32(jpd._unpack_phases(jp6[:, :, :, :, :jMp], L, E, g, S, r, True))
    np.testing.assert_array_equal(ours, ref)
    # the cover pattern: token l (phase (l % g) % r) keeps only its band's lanes
    phase = (np.arange(L) % g) % r
    band = np.arange(E) // DH // (H // r)
    off_band = phase[:, None] != band[None, :]
    assert not ours[:, off_band].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_pack_then_unpack_round_trip_matches_jax(dtype):
    """B = 2, S = 4 segments of g = 30 (30 % 4 != 0), the last one ragged
    (10 tokens): the round trip gives back x on each row's band and exact 0
    elsewhere, equal to JAX's ``_unpack_phases(_pack_phases(x))``."""
    L, sl, r = 100, 30, 4
    x, jx = _both(_data(2, 2, L, E), dtype)
    g, S, m, Mp = dk._branch_geometry(L, sl, r)
    jMp = jpd._branch_geometry(L, E, sl, r)[4]
    assert (g, S, L - (S - 1) * g) == (30, 4, 10)
    ours = _f32(dk.unpack_phases(dk.pack_phases(x, g, S, r, Mp, H), L, E, g, S, r))
    ref = _f32(jpd._unpack_phases(jpd._pack_phases(jx, g, S, r, jMp, H, True), L, E, g, S, r, True))
    np.testing.assert_array_equal(ours, ref)
    phase = (np.arange(L) % g) % r
    on_band = phase[:, None] == np.arange(E)[None, :] // DH // (H // r)
    np.testing.assert_array_equal(ours, np.where(on_band[None], _f32(x), 0.0))


def _assert_branch_close(ours, ref):
    (o, l), (jo, jl) = ours, ref
    o, l = o.numpy(), l.numpy()
    jo, jl = np.asarray(jo), np.asarray(jl)
    np.testing.assert_allclose(o, jo, atol=2e-5, rtol=1e-5)
    covered = jl > -1e19
    np.testing.assert_allclose(l[covered], jl[covered], atol=2e-5, rtol=1e-5)
    assert (l[~covered] <= -1e19).all()


@pytest.mark.parametrize("L,sl,r,rl", BRANCH_CASES)
def test_branch_attention_matches_jax(L, sl, r, rl):
    q, k, v = (_data(s, 2, L, E) for s in (2, 3, 4))
    ours = dk.dilated_branch_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), sl, r, H, real_len=rl
    )
    ref = _jax_branch(q, k, v, sl, r, real_len=rl)
    _assert_branch_close(ours, ref)
    # off-band lanes of a branch are exact zeros
    g = min(sl, L)
    phase = (np.arange(L) % g) % r
    band = np.arange(E) // DH // (H // r)
    assert not ours[0].numpy()[:, phase[:, None] != band[None, :]].any()


@pytest.mark.parametrize("L,sl,r", [(300, 64, 2), (300, 512, 16)])
def test_branch_attention_per_row_valid_len_matches_jax(L, sl, r):
    q, k, v = (_data(s, 2, L, E) for s in (5, 6, 7))
    vl = np.array([300, 157], np.int32)
    ours = dk.dilated_branch_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), sl, r, H,
        valid_len_dyn=torch.from_numpy(vl),
    )
    ref = _jax_branch(q, k, v, sl, r, valid_len_dyn=jnp.asarray(vl))
    _assert_branch_close(ours, ref)


def test_branch_attention_causal_matches_jax():
    L, sl, r = 300, 128, 2
    q, k, v = (_data(s, 1, L, E) for s in (8, 9, 10))
    ours = dk.dilated_branch_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), sl, r, H, real_len=280, is_causal=True
    )
    ref = _jax_branch(q, k, v, sl, r, real_len=280, is_causal=True)
    _assert_branch_close(ours, ref)


@pytest.mark.parametrize("L,sl,r,causal,rl", [(64, 64, 1, False, None), (120, 128, 2, False, None),
                                              (300, 128, 2, True, 280)], ids=["r1", "r2", "causal"])
def test_serial_bf16_roundings_match_jax(L, sl, r, causal, rl):
    """In bf16 the serial Pallas kernels round q*scale*log2(e) and the
    forward's probabilities (before PV), and dQ's ds (before ds.K), to the
    input dtype; the port's serial route rounds at the same places. With
    one key tile on both sides (m <= 64) out, dq, dk and dv agree with
    JAX's serial route to 2e-3 of their max, half a bf16 ulp there (read:
    at most 8.6e-4; without the roundings up to 1.9e-2)."""
    h = 8
    q, k, v, do = (2 * _data(s, 2, L, h * 16) for s in (63, 64, 65, 66))
    kw = {} if rl is None else {"real_len": rl}

    def run(a, b, c, d):
        (o, l), vjp = jax.vjp(lambda a_, b_, c_: jpd.dilated_branch_attention(
            a_, b_, c_, sl, r, h, interpret=True, flags=FLAGS, is_causal=causal, **kw), a, b, c)
        return o, vjp((d, jnp.zeros_like(l)))

    ref_o, ref_g = jax.jit(run)(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do)))
    refs = [np.asarray(x.astype(jnp.float32)) for x in (ref_o, *ref_g)]
    qt, kt, vt = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_() for x in (q, k, v))
    o, _ = dk.dilated_branch_attention(qt, kt, vt, sl, r, h, is_causal=causal, flags=dk.PipelineFlags(), **kw)
    o.backward(torch.from_numpy(do).to(torch.bfloat16))
    errs = {name: float(np.abs(a.float().numpy() - b).max() / np.abs(b).max())
            for name, a, b in zip(("out", "dq", "dk", "dv"), (o.detach(), qt.grad, kt.grad, vt.grad), refs)}
    assert max(errs.values()) <= 2e-3, errs


def _bf16_branch_vs_jax(L, sl, r, h, jax_flags, port_flags, seeds=(63, 64, 65, 66)):
    """One branch in bf16 through JAX's branch op (interpret mode, the
    given dispatch flags) and the port's, and the port's in fp32 on the
    same inputs: (max error of out, dq, dk, dv against JAX over JAX's max;
    mean error of out against the fp32 answer over its mean magnitude, for
    the port and for JAX)."""
    q, k, v, do = (2 * _data(s, 2, L, h * 16) for s in seeds)

    def run(a, b, c, d):
        (o, l), vjp = jax.vjp(lambda a_, b_, c_: jpd.dilated_branch_attention(
            a_, b_, c_, sl, r, h, interpret=True, flags=jax_flags), a, b, c)
        return o, vjp((d, jnp.zeros_like(l)))

    ref_o, ref_g = jax.jit(run)(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do)))
    refs = [np.asarray(x.astype(jnp.float32)) for x in (ref_o, *ref_g)]
    qt, kt, vt = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_() for x in (q, k, v))
    o, _ = dk.dilated_branch_attention(qt, kt, vt, sl, r, h, flags=port_flags)
    o.backward(torch.from_numpy(do).to(torch.bfloat16))
    errs = {name: float(np.abs(a.float().numpy() - b).max() / np.abs(b).max())
            for name, a, b in zip(("out", "dq", "dk", "dv"), (o.detach(), qt.grad, kt.grad, vt.grad), refs)}
    exact, _ = dk.dilated_branch_attention(
        *(torch.from_numpy(x).to(torch.bfloat16).float() for x in (q, k, v)), sl, r, h, flags=port_flags)
    exact = exact.numpy()

    def mean_rel(x):
        return float(np.abs(x - exact).mean() / np.abs(exact).mean())

    return errs, mean_rel(o.detach().float().numpy()), mean_rel(refs[0])


@pytest.mark.parametrize("L,sl,r", [(512, 512, 1), (1024, 1024, 2)], ids=["r1", "r2"])
def test_serial_bf16_multi_tile_matches_jax(L, sl, r):
    """Past one key tile (m = 512: eight of the port's 64-key tiles, one
    JAX block) the two packages place the bf16 forward's running max
    differently (the port per 64-key tile, JAX per block; the plain
    forward's docstring says why), so p rounds against another max on some
    rows. out, dq, dk and dv still agree with JAX's serial route to 1e-2 of
    their max, about two bf16 ulps there (read: at most 4.6e-3 at r1,
    4.7e-3 at r2), and the port's out is no further from the fp32 answer on
    average than JAX's (mean error within 1.05 times JAX's; read 3.507e-3
    against 3.524e-3 at r1, 3.525e-3 against 3.541e-3 at r2)."""
    errs, port_mean, jax_mean = _bf16_branch_vs_jax(L, sl, r, 8, FLAGS, dk.PipelineFlags())
    assert max(errs.values()) <= 1e-2, errs
    assert port_mean <= 1.05 * jax_mean, (port_mean, jax_mean)


def _one_shot_fwd(q6, k6, v6, kvlen, is_causal):
    """The branch forward as one fp32 softmax over all of a cell's keys,
    one cell at a time (no rounding, no key tiles)."""
    B, S, r, hb, Mp, Dh = q6.shape
    out = torch.empty(q6.shape)
    lse = torch.empty((B, S, r, hb, Mp))
    cols = torch.arange(Mp)
    for s in range(S):
        for p in range(r):
            mask = cols[None, None, :] >= kvlen[:, s, p].to(torch.int64)[:, None, None]
            if is_causal:
                mask = mask | (cols[None, :] > cols[:, None])[None]
            for t in range(hb):
                sc = (q6[:, s, p, t].float() * (Dh**-0.5 * dk.LOG2E)) @ k6[:, s, p, t].float().transpose(1, 2)
                sc = sc.masked_fill(mask, dk.NEG_INF)
                m_row = sc.amax(dim=-1, keepdim=True).clamp_min(dk.M_FLOOR)
                pr = torch.exp2(sc - m_row)
                l_row = pr.sum(dim=-1, keepdim=True).clamp_min(1e-30)
                out[:, s, p, t] = (pr @ v6[:, s, p, t].float()) / l_row
                lse[:, s, p, t] = ((m_row + torch.log2(l_row)) * dk.LN2)[..., 0]
    return out, lse


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_fp32_online_forward_matches_one_shot_softmax(causal):
    """In fp32 the plain forward's online softmax over 64-key tiles (its
    roundings no-ops) is the one-shot softmax up to the order of sums:
    within the fp32 tolerances held against the JAX package (atol 2e-5,
    rtol 1e-5), over cells of 192 keys (three tiles) with ragged and empty
    counts."""
    B, S, r, hb, Mp, Dh = 2, 2, 2, 3, 192, 8
    q6, k6, v6 = (torch.from_numpy(3 * _data(s, B, S, r, hb, Mp, Dh)) for s in (27, 28, 29))
    kvlen = torch.tensor([[[192, 150], [70, 0]], [[1, 129], [192, 64]]], dtype=torch.int32)
    out, lse = dk.dilated_branch_fwd_reference(q6, k6, v6, kvlen, causal)
    ref_out, ref_lse = _one_shot_fwd(q6, k6, v6, kvlen, causal)
    torch.testing.assert_close(out, ref_out, atol=2e-5, rtol=1e-5)
    covered = ref_lse > -1e19
    torch.testing.assert_close(lse[covered], ref_lse[covered], atol=2e-5, rtol=1e-5)
    assert (lse[~covered] <= -1e19).all() and not out[0, 1, 1].any()


def test_fully_masked_rows_give_zero_out_and_sentinel_lse():
    """A cell with no valid key: out exactly 0, lse at or below -1e19."""
    B, S, r, hb, Mp, Dh = 1, 2, 2, 8, 64, 4
    q6, k6, v6 = (torch.from_numpy(_data(s, B, S, r, hb, Mp, Dh)) for s in (11, 12, 13))
    kvlen = torch.tensor([[[0, 5], [64, 0]]], dtype=torch.int32)
    out, lse = dk.dilated_branch_fwd(q6, k6, v6, kvlen)
    assert not out[:, 0, 0].any() and not out[:, 1, 1].any()
    assert (lse[:, 0, 0] <= -1e19).all() and (lse[:, 1, 1] <= -1e19).all()
    assert torch.isfinite(out).all() and (lse[:, 0, 1] > -1e19).all()


def test_tensor_core_forward_inputs_are_checked():
    """The check the branch forwards' wrappers make before a CUDA launch:
    bf16 tensors go to the tensor-core kernels, which need a head width
    that is a multiple of 8 and 16-byte aligned q6, k6, v6; fp32 tensors
    (the FMA kernels) take any width the kernels are built for."""
    fits = torch.zeros(1, 1, 1, 1, 64, 48, dtype=torch.bfloat16)
    dk._check_tensor_core_inputs("fwd", 48, fits, fits, fits)
    narrow = torch.zeros(1, 1, 1, 1, 64, 20)
    dk._check_tensor_core_inputs("fwd", 20, narrow, narrow, narrow)
    with pytest.raises(ValueError, match="multiple of 8"):
        dk._check_tensor_core_inputs("fwd", 20, *(narrow.to(torch.bfloat16),) * 3)
    shifted = torch.zeros(64 * 48 + 1, dtype=torch.bfloat16)[1:].view(fits.shape)
    with pytest.raises(ValueError, match="aligned"):
        dk._check_tensor_core_inputs("fwd", 48, fits, shifted, fits)


def test_dyn_sparse_counts_match_jax():
    vl = np.array([300, 211, 0, 17], np.int32)
    for g, r, m, n_seg in [(64, 1, 64, 5), (64, 2, 32, 5), (300, 16, 19, 1), (30, 4, 8, 4)]:
        ours = dk.dyn_sparse_counts(torch.from_numpy(vl), g, r, m, torch.arange(r), n_seg)
        ref = jax_dyn_sparse_counts(jnp.asarray(vl), g, r, m, jnp.arange(r), n_seg)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


FLAGSHIP_L = 10241
FLAGSHIP_BRANCHES = [(FLAGSHIP_L, sl, r, FLAGSHIP_L - 37)
                     for sl, r in zip([1024, 5792, 32768, 185363, 1048576], [1, 2, 4, 8, 16])]


@pytest.mark.parametrize("L,sl,r,rl", BRANCH_CASES + FLAGSHIP_BRANCHES)
@pytest.mark.parametrize("per_row", [False, True], ids=["static", "per_row"])
def test_branch_kvlen_counted_on_device_equals_numpy_table(L, sl, r, rl, per_row):
    """The [B, S, r] count table, now counted with torch on the tensors'
    device, is bit-equal to the numpy table of each row's valid length
    (``_phase_kvlen``): the static ``real_len``, or its minimum with a
    per-row length."""
    g, S, m, Mp = dk._branch_geometry(L, sl, r)
    rows = [0, L // 3, L - 1, L] if per_row else [L, L]
    vl = torch.tensor(rows, dtype=torch.int32) if per_row else None
    table = dk._branch_kvlen(len(rows), S, g, r, m, rl, vl, torch.device("cpu"))
    assert table.dtype == torch.int32 and table.shape == (len(rows), S, r) and table.is_contiguous()
    want = np.stack([dk._phase_kvlen(S, g, r, m, min(rl, n)) for n in rows])
    np.testing.assert_array_equal(table.numpy(), want)


SCHEDULE = ([32, 64, 128, 512, 1024], [1, 2, 4, 8, 16])


@pytest.mark.parametrize(
    "valid_len", [None, 250, np.array([300, 211], np.int32)], ids=["full", "static", "per_row"]
)
def test_dilated_attention_matches_jax_generic(valid_len):
    """Port (phase-major kernels' plain versions) vs the JAX package's
    generic CPU path, ratios [1, 2, 4, 8, 16]."""
    L = 300
    q, k, v = (_data(s, 2, L, H, DH) for s in (14, 15, 16))
    t_vl = torch.from_numpy(valid_len) if isinstance(valid_len, np.ndarray) else valid_len
    ours = dilated_attention(*(torch.from_numpy(x) for x in (q, k, v)), *SCHEDULE, valid_len=t_vl)
    if isinstance(valid_len, np.ndarray):  # per-row counts ride as a traced array
        fn = jax.jit(lambda a, b, c, vl: jax_dilated_attention(a, b, c, *SCHEDULE, valid_len=vl))
        ref = fn(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(valid_len))
    else:
        fn = jax.jit(lambda a, b, c: jax_dilated_attention(a, b, c, *SCHEDULE, valid_len=valid_len))
        ref = fn(*(jnp.asarray(x) for x in (q, k, v)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


def test_ratio_not_dividing_heads_raises():
    """A ratio that does not divide H no longer raises: the call warns and
    takes the head-major route (the segment-flash kernels), equal to the
    JAX package's head-major route (interpret mode)."""
    from gigapath_tpu.ops.dilated_attention import dilated_attention_bhld as jax_bhld
    from gigapath_tpu_torch.ops import dilated_attention as pda

    q, k, v = (_data(s, 1, 40, 6, 4) for s in (24, 25, 26))
    pda._WARNED.clear()
    with pytest.warns(UserWarning, match="head-major"):
        ours = dilated_attention(*(torch.from_numpy(x) for x in (q, k, v)), [16, 32], [1, 4])
    ref = jax_bhld(*(jnp.asarray(x) for x in (q, k, v)), [16, 32], [1, 4], interpret=True, use_pallas=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


def test_attention_with_lse_matches_jax():
    q, k, v = (_data(s, 2, 9, 4, 8) for s in (17, 18, 19))
    kvl = np.array([[9, 3, 0, 5], [1, 9, 9, 2]], np.int32)
    ours = attention_with_lse(*(torch.from_numpy(x) for x in (q, k, v)), kv_valid_len=kvl)
    ref = jax_attention_with_lse(*(jnp.asarray(x) for x in (q, k, v)), kv_valid_len=kvl)
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(ref[0]), atol=2e-6, rtol=1e-5)
    np.testing.assert_allclose(ours[1].numpy(), np.asarray(ref[1]), atol=2e-5, rtol=1e-5)
    assert not ours[0][0, :, 2].any()  # no valid key -> out 0
