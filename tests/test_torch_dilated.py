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


@pytest.mark.parametrize("L,sl,r,rl", BRANCH_CASES)
def test_pack_phases_matches_jax(L, sl, r, rl):
    x = _data(0, 2, L, E)
    g, S, m, Mp = dk._branch_geometry(L, sl, r)
    jg, jS, _, jm, jMp, _ = jpd._branch_geometry(L, E, sl, r)
    assert (g, S, m) == (jg, jS, jm)
    ours = dk.pack_phases(torch.from_numpy(x), g, S, r, Mp, H).numpy()
    ref = np.asarray(jpd._pack_phases(jnp.asarray(x), g, S, r, jMp, H, True))
    assert ours.shape == (2, S, r, H // r, Mp, DH)
    np.testing.assert_array_equal(ours[:, :, :, :, :m], ref[:, :, :, :, :m])
    assert not ours[:, :, :, :, m:].any()  # row padding is exact zeros


@pytest.mark.parametrize("L,sl,r,rl", BRANCH_CASES)
def test_unpack_phases_matches_jax(L, sl, r, rl):
    g, S, m, Mp = dk._branch_geometry(L, sl, r)
    jMp = jpd._branch_geometry(L, E, sl, r)[4]
    p6 = np.zeros((2, S, r, H // r, max(Mp, jMp), DH), np.float32)
    p6[:, :, :, :, :m] = _data(1, 2, S, r, H // r, m, DH)
    ours = dk.unpack_phases(torch.from_numpy(p6[:, :, :, :, :Mp]), L, E, g, S, r).numpy()
    ref = np.asarray(jpd._unpack_phases(jnp.asarray(p6[:, :, :, :, :jMp]), L, E, g, S, r, True))
    np.testing.assert_array_equal(ours, ref)
    # the cover pattern: token l (phase (l % g) % r) keeps only its band's lanes
    phase = (np.arange(L) % g) % r
    band = np.arange(E) // DH // (H // r)
    off_band = phase[:, None] != band[None, :]
    assert not ours[:, off_band].any()


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


def test_fully_masked_rows_give_zero_out_and_sentinel_lse():
    """A cell with no valid key: out exactly 0, lse at or below -1e19."""
    B, S, r, hb, Mp, Dh = 1, 2, 2, 8, 64, 4
    q6, k6, v6 = (torch.from_numpy(_data(s, B, S, r, hb, Mp, Dh)) for s in (11, 12, 13))
    kvlen = torch.tensor([[[0, 5], [64, 0]]], dtype=torch.int32)
    out, lse = dk.dilated_branch_fwd(q6, k6, v6, kvlen)
    assert not out[:, 0, 0].any() and not out[:, 1, 1].any()
    assert (lse[:, 0, 0] <= -1e19).all() and (lse[:, 1, 1] <= -1e19).all()
    assert torch.isfinite(out).all() and (lse[:, 0, 1] > -1e19).all()


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
