"""The port's decoder side of the torchscale family held against the JAX
package on the CPU: xPos, the relative-position buckets and bias, multiway
routing, ``MultiheadAttention`` (cross-attention, masks, xPos, the decode
cache), ``dilated_attention`` with a decoding offset and with attention
dropout, ``Decoder``, ``EncoderDecoder`` and ``LongNetDecoder`` (the whole
sequence and stepped), the encoder's token, position and rel-pos inputs,
``init_bert_params`` and ``apply_init_scaling``.

Weights come from the JAX modules' init, perturbed so that norms and biases
are not trivial, and reach the port through ``state_dict_from_flax_params``
(strict loads, or the keys torchscale has beyond the JAX tree named);
inputs from a numpy seed. Tolerances: forward 1e-5 (fp32), a stepped
decode against the whole sequence 2e-4 (``tests/test_dilated_attention.py``).
The JAX references are jitted and batched, except the LongNet decoder's
stepped decode, whose cache index must be concrete (it runs eagerly, as the
JAX package's own test does).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test process)
from flax import linen as fnn

from gigapath_tpu.architecture import init as jinit
from gigapath_tpu.architecture.config import DecoderConfig as JDecoderConfig
from gigapath_tpu.architecture.config import EncoderConfig as JEncoderConfig
from gigapath_tpu.architecture.config import EncoderDecoderConfig as JEncoderDecoderConfig
from gigapath_tpu.architecture.decoder import Decoder as JDecoder
from gigapath_tpu.architecture.encoder import Encoder as JEncoder
from gigapath_tpu.architecture.encoder_decoder import EncoderDecoder as JEncoderDecoder
from gigapath_tpu.models.longnet import LongNetDecoder as JLongNetDecoder
from gigapath_tpu.ops import dilated_attention as jda
from gigapath_tpu.ops import relative_position_bias as jrpb
from gigapath_tpu.ops import xpos as jxpos
from gigapath_tpu.ops.attention import MultiheadAttention as JMultiheadAttention
from gigapath_tpu.ops.multiway import MultiwayNetwork as JMultiwayNetwork
from gigapath_tpu_torch.architecture import config as pconfig
from gigapath_tpu_torch.architecture import init as pinit
from gigapath_tpu_torch.architecture.decoder import Decoder
from gigapath_tpu_torch.architecture.encoder import Encoder
from gigapath_tpu_torch.architecture.encoder_decoder import EncoderDecoder
from gigapath_tpu_torch.models.longnet import LongNetDecoder
from gigapath_tpu_torch.ops import dilated_attention as pda
from gigapath_tpu_torch.ops import relative_position_bias as prpb
from gigapath_tpu_torch.ops import xpos as pxpos
from gigapath_tpu_torch.ops.attention import MultiheadAttention
from gigapath_tpu_torch.ops.multiway import MultiwayNetwork
from gigapath_tpu_torch.utils.convert import state_dict_from_flax_params

FWD = dict(atol=1e-5, rtol=1e-5)
STEP = dict(atol=2e-4, rtol=0)
V, E, HEADS, FFN = 50, 32, 4, 64
SCHED = dict(segment_length=[4, 8, 16], dilated_ratio=[1, 2, 4])


def _perturbed(params, seed=1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32),
                                  params)


def _load(module, params, extra=()):
    """Load a JAX tree into ``module``: strict, or with exactly the keys in
    ``extra`` (torchscale's, which the JAX tree lacks) missing."""
    missing, unexpected = module.load_state_dict(state_dict_from_flax_params(params), strict=False)
    assert not unexpected and sorted(missing) == sorted(extra), (missing, unexpected)
    return module.eval()


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _n(x):
    return x.detach().numpy()


# ---------------------------------------------------------------------------
# xPos, relative positions, multiway
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,offset,down", [((2, 7, 3, 8), 0, False), ((2, 7, 3, 8), 5, True), ((1, 9, 16), 3, False)])
def test_xpos_matches_jax(shape, offset, down):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want = jxpos.apply_xpos(jnp.asarray(x), scale_base=64, offset=offset, downscale=down)
    got = pxpos.apply_xpos(_t(x), scale_base=64, offset=offset, downscale=down)
    np.testing.assert_allclose(_n(got), np.asarray(want), **FWD)
    np.testing.assert_allclose(_n(pxpos.xpos_scale(9, 8, 512, offset)), np.asarray(jxpos.xpos_scale(9, 8, 512, offset)),
                               **FWD)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_position_bucket_and_bias_match_jax(bidirectional):
    rel = np.arange(-300, 300)[None, :] - np.arange(0, 7)[:, None]
    for nb, md in ((32, 128), (16, 40)):
        want = jrpb.relative_position_bucket(jnp.asarray(rel), bidirectional, nb, md)
        got = prpb.relative_position_bucket(_t(rel), bidirectional, nb, md)
        np.testing.assert_array_equal(_n(got), np.asarray(want))
    jmod = jrpb.RelativePositionBias(bidirectional=bidirectional, num_buckets=16, max_distance=40, n_heads=3)
    params = jmod.init(jax.random.PRNGKey(0), 2, 5, 11)["params"]
    want = jmod.apply({"params": params}, 2, 5, 11, step=4)
    port = _load(prpb.RelativePositionBias(bidirectional, 16, 40, 3), params)
    np.testing.assert_allclose(_n(port(2, 5, 11, step=4)), np.asarray(want), **FWD)


@pytest.mark.parametrize("split", [-1, 0, 3, 7])
def test_multiway_split_routes_like_jax(split):
    jmod = JMultiwayNetwork(module_fn=lambda name: fnn.Dense(6, name=name))
    x = np.random.default_rng(0).normal(size=(2, 7, 5)).astype(np.float32)
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), split_position=3)["params"])
    port = _load(MultiwayNetwork(lambda: torch.nn.Linear(5, 6)), params)
    want = jmod.apply({"params": params}, jnp.asarray(x), split_position=split)
    np.testing.assert_allclose(_n(port(_t(x), split_position=split)), np.asarray(want), **FWD)


# ---------------------------------------------------------------------------
# MultiheadAttention
# ---------------------------------------------------------------------------


MHA_CASES = {
    "cross": dict(kw=dict(self_attention=False, encoder_decoder_attention=True, subln=True), lk=9),
    "masks": dict(kw=dict(subln=True), lk=7, mask=True, rel=True, pad=True),
    "xpos": dict(kw=dict(xpos_rel_pos=True, xpos_scale_base=32), lk=7, causal=True),
    "multiway": dict(kw=dict(multiway=True, subln=True), lk=7, split=3),
}


@pytest.mark.parametrize("case", list(MHA_CASES))
def test_multihead_attention_matches_jax(case):
    c = MHA_CASES[case]
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 7, E)).astype(np.float32)
    kv = rng.normal(size=(2, c["lk"], E)).astype(np.float32)
    call = dict(is_causal=c.get("causal", False))
    if c.get("mask"):
        call["attn_mask"] = np.where(rng.random((7, c["lk"])) < 0.2, -1e8, 0.0).astype(np.float32)
    if c.get("rel"):
        call["rel_pos"] = rng.normal(size=(2 * HEADS, 7, c["lk"])).astype(np.float32)
    if c.get("pad"):
        pad = np.zeros((2, c["lk"]), bool)
        pad[1, 5:] = True
        call["key_padding_mask"] = pad
    if "split" in c:
        call["multiway_split_position"] = c["split"]
    jmod = JMultiheadAttention(embed_dim=E, num_heads=HEADS, **c["kw"])
    jcall = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in call.items()}
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
                                  **jcall)["params"])
    want = jax.jit(lambda p, a, b: jmod.apply({"params": p}, a, b, b, **jcall))(params, q, kv)
    port = _load(MultiheadAttention(E, HEADS, **c["kw"]), params)
    pcall = {k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in call.items()}
    got = port(_t(q), _t(kv), _t(kv), **pcall)
    np.testing.assert_allclose(_n(got), np.asarray(want), **FWD)


def test_multihead_attention_decode_cache_matches_jax():
    """Chunks of 3, 1 and 2 rows through the decode cache against JAX's
    ``decode=True`` steps (a static buffer under a per-query bias), and
    against the port's whole causal call."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 6, E)).astype(np.float32)
    jmod = JMultiheadAttention(embed_dim=E, num_heads=HEADS, subln=True)
    variables = jmod.init(jax.random.PRNGKey(0), *(jnp.asarray(x),) * 3, is_causal=True, decode=True)
    params, cache = _perturbed(variables["params"]), variables["cache"]

    @jax.jit
    def step(cache, chunk):
        return jmod.apply({"params": params, "cache": cache}, chunk, chunk, chunk, is_causal=True, decode=True,
                          mutable=["cache"])

    port = _load(MultiheadAttention(E, HEADS, subln=True), params)
    state, outs = {}, []
    for lo, hi in ((0, 3), (3, 4), (4, 6)):
        want, mods = step(cache, jnp.asarray(x[:, lo:hi]))
        cache = mods["cache"]
        chunk = _t(x[:, lo:hi])
        got = port(chunk, chunk, chunk, is_causal=True, incremental_state=state)
        np.testing.assert_allclose(_n(got), np.asarray(want), **FWD)
        outs.append(got)
        assert state["index"] == hi and state["prev_key"].shape == (2, hi, HEADS, E // HEADS)
    full = port(_t(x), _t(x), _t(x), is_causal=True)
    np.testing.assert_allclose(_n(torch.cat(outs, 1)), _n(full), **STEP)
    xpos = MultiheadAttention(E, HEADS, xpos_rel_pos=True)
    with pytest.raises(ValueError, match="xPos"):
        xpos(_t(x), _t(x), _t(x), incremental_state={})


# ---------------------------------------------------------------------------
# dilated attention: decoding offset and dropout routing
# ---------------------------------------------------------------------------


def test_dilated_attention_offset_matches_jax():
    """Steps and chunks at offsets inside, at and past the segments against
    JAX's offset decoding, and against the port's whole causal call."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(2, 24, HEADS, 8)).astype(np.float32) for _ in range(3))
    sls, drs = SCHED["segment_length"], SCHED["dilated_ratio"]
    full = pda.dilated_attention(_t(q), _t(k), _t(v), sls, drs, is_causal=True)
    cases = [(0, 1), (1, 2), (3, 4), (4, 5), (7, 8), (15, 16), (16, 17), (23, 24), (3, 9), (9, 24)]

    @jax.jit
    def jax_steps(q, k, v):
        return [jda.dilated_attention(q[:, a:b], k[:, :b], v[:, :b], sls, drs, is_causal=True, offset=a)
                for a, b in cases]

    for (a, b), want in zip(cases, jax_steps(q, k, v)):
        got = pda.dilated_attention(_t(q[:, a:b]), _t(k[:, :b]), _t(v[:, :b]), sls, drs, is_causal=True, offset=a)
        np.testing.assert_allclose(_n(got), np.asarray(want), err_msg=f"[{a}, {b})", **FWD)
        np.testing.assert_allclose(_n(got), _n(full[:, a:b]), err_msg=f"[{a}, {b})", **STEP)
    with pytest.raises(ValueError, match="offset"):
        pda.dilated_attention(_t(q[:, :1]), _t(k), _t(v), sls, drs, is_causal=True, offset=3)


@pytest.mark.parametrize("valid", [None, 19, [24, 13]], ids=["all", "int", "per_row"])
def test_dilated_attention_custom_attn_fn_matches_jax(valid):
    """A custom ``attn_fn`` takes the generic route in both packages, with
    a shared suffix bound (an int) or per-row valid lengths."""
    from gigapath_tpu.ops.attention import attention_with_lse as jattn
    from gigapath_tpu_torch.ops.attention import attention_with_lse as pattn

    rng = np.random.default_rng(12)
    q, k, v = (rng.normal(size=(2, 24, HEADS, 8)).astype(np.float32) for _ in range(3))
    sls, drs = SCHED["segment_length"], SCHED["dilated_ratio"]
    jv = pv = valid
    if isinstance(valid, list):
        jv, pv = jnp.asarray(valid, jnp.int32), torch.tensor(valid)
    want = jax.jit(lambda a, b, c: jda.dilated_attention(a, b, c, sls, drs, attn_fn=jattn, valid_len=jv))(q, k, v)
    got = pda.dilated_attention(_t(q), _t(k), _t(v), sls, drs, attn_fn=pattn, valid_len=pv)
    np.testing.assert_allclose(_n(got), np.asarray(want), **FWD)


@pytest.mark.parametrize("valid", [None, 22, [24, 17]], ids=["all", "int", "per_row"])
def test_dilated_attention_generic_segment_pad_matches_jax(valid):
    """Segments that are no multiple of their ratio, several to the
    sequence: the generic route counts each segment's pad to a multiple of
    r as keys where the valid length passes it, as the JAX package's
    ``_kv_valid_lengths`` does; whole calls and decode steps."""
    from gigapath_tpu.ops.attention import attention_with_lse as jattn
    from gigapath_tpu_torch.ops.attention import attention_with_lse as pattn

    rng = np.random.default_rng(13)
    q, k, v = (rng.normal(size=(2, 24, HEADS, 8)).astype(np.float32) for _ in range(3))
    sls, drs = [6, 10], [4, 3]
    jv = pv = valid
    if isinstance(valid, list):
        jv, pv = jnp.asarray(valid, jnp.int32), torch.tensor(valid)
    want = jax.jit(lambda a, b, c: jda.dilated_attention(a, b, c, sls, drs, attn_fn=jattn, valid_len=jv))(q, k, v)
    got = pda.dilated_attention(_t(q), _t(k), _t(v), sls, drs, attn_fn=pattn, valid_len=pv)
    np.testing.assert_allclose(_n(got), np.asarray(want), **FWD)
    cases = [(0, 13), (13, 14), (20, 21), (21, 24)]

    @jax.jit
    def jax_steps(q, k, v):
        return [jda.dilated_attention(q[:, a:b], k[:, :b], v[:, :b], sls, drs, is_causal=True, offset=a)
                for a, b in cases]

    for (a, b), want in zip(cases, jax_steps(q, k, v)):
        got = pda.dilated_attention(_t(q[:, a:b]), _t(k[:, :b]), _t(v[:, :b]), sls, drs, is_causal=True, offset=a)
        np.testing.assert_allclose(_n(got), np.asarray(want), err_msg=f"[{a}, {b})", **FWD)


def test_dilated_attention_dropout_routing():
    """Dropout > 0 runs each branch's plain attention with dropout (the
    kernels' plain versions count nothing); the generators differ from
    JAX's, so the check is the shape, the keep rate of the probabilities
    and the mean, not the bits. A custom attn_fn with dropout raises, as in
    JAX; dropout 0 keeps the kernel route."""
    from gigapath_tpu_torch.ops import attention as pattn
    from gigapath_tpu_torch.ops import dilated_kernels as dk

    rng = np.random.default_rng(6)
    q, k, v = (_t(rng.normal(size=(2, 64, HEADS, 8)).astype(np.float32)) for _ in range(3))
    sls, drs = [16, 64], [1, 2]
    kept = []
    real = pattn.attention_with_lse

    def spy(*a, **kw):
        out = real(*a, **kw)
        kept.append(kw["dropout_rate"])
        return out

    gen = torch.Generator().manual_seed(0)
    pda.attention_with_lse, saved = spy, pda.attention_with_lse
    try:
        dk.reset_launch_counts()
        out = pda.dilated_attention(q, k, v, sls, drs, dropout_rate=0.5, generator=gen)
    finally:
        pda.attention_with_lse = saved
    assert kept == [0.5, 0.5] and out.shape == q.shape and torch.isfinite(out).all()
    plain = pda.dilated_attention(q, k, v, sls, drs)
    assert not torch.allclose(out, plain)
    # the keep rate of one branch's probabilities, through the same draw
    probs = torch.ones(2, HEADS, 256, 256)
    g = torch.Generator().manual_seed(1)
    keep = (torch.rand(probs.shape, generator=g) < 0.5).float().mean()
    assert abs(float(keep) - 0.5) < 0.01
    ones = torch.ones(1, 512, 1, 4)
    o, _ = pattn.attention_with_lse(ones, ones, ones, dropout_rate=0.25, generator=torch.Generator().manual_seed(2))
    assert abs(float(o.mean()) - 1.0) < 0.05  # kept / (1 - p) keeps the mean
    with pytest.raises(NotImplementedError, match="custom attn_fn"):
        pda.dilated_attention(q, k, v, sls, drs, dropout_rate=0.5, attn_fn=pattn.attention_with_lse)
    jq = jnp.asarray(q.numpy())
    with pytest.raises(NotImplementedError, match="custom attn_fn"):
        jda.dilated_attention(jq, jq, jq, sls, drs, dropout_rate=0.5, dropout_rng=jax.random.PRNGKey(0),
                              attn_fn=jda.attention_with_lse)
    layer = pda.DilatedAttention(E, HEADS, sls, drs, dropout=0.5).train()
    assert layer(*(_t(rng.normal(size=(2, 64, E)).astype(np.float32)),) * 3).shape == (2, 64, E)


# ---------------------------------------------------------------------------
# decoders
# ---------------------------------------------------------------------------


def _dec_cfg(cls, **kw):
    base = dict(decoder_embed_dim=E, decoder_attention_heads=HEADS, decoder_ffn_embed_dim=FFN, decoder_layers=2,
                vocab_size=V, dropout=0.0, drop_path_rate=0.0)
    return cls(**{**base, **kw})


DECODER_CASES = {
    "subln": dict(),
    "post_ln_deepnorm": dict(deepnorm=True, layernorm_embedding=True, no_scale_embedding=False),
    "rel_pos_shared": dict(rel_pos_buckets=16, max_rel_pos=32, share_decoder_input_output_embed=True),
    "moe": dict(moe_freq=2, moe_expert_count=2, moe_top1_expert=True),
}


@pytest.mark.parametrize("case", list(DECODER_CASES))
def test_decoder_matches_jax(case):
    kw = DECODER_CASES[case]
    tokens = np.random.default_rng(7).integers(0, V, (2, 9)).astype(np.int32)
    jdec = JDecoder(_dec_cfg(JDecoderConfig, **kw))
    params = _perturbed(jdec.init(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"])
    want = jax.jit(lambda p, t: jdec.apply({"params": p}, t, return_all_hiddens=True))(params, tokens)
    extra = ["output_projection.weight"] if kw.get("share_decoder_input_output_embed") else []
    port = _load(Decoder(_dec_cfg(pconfig.DecoderConfig, **kw)), params, extra)
    got = port(_t(tokens).long(), return_all_hiddens=True)
    np.testing.assert_allclose(_n(got["decoder_out"]), np.asarray(want["decoder_out"]), **FWD)
    for a, b in zip(got["inner_states"], want["inner_states"]):
        np.testing.assert_allclose(_n(a), np.asarray(b), **FWD)
    if case == "moe":
        assert got["l_aux"][1] is not None and port.moe_l_aux is not None
        np.testing.assert_allclose(float(got["l_aux"][1].detach()), float(want["l_aux"][1]), **FWD)


def test_decoder_stepped_matches_jax_and_full():
    """Token steps and a chunk through ``incremental_state`` against JAX's
    jitted ``decode=True`` steps and the port's whole-sequence call."""
    tokens = np.random.default_rng(8).integers(0, V, (2, 7)).astype(np.int32)
    jdec = JDecoder(_dec_cfg(JDecoderConfig))
    variables = jdec.init(jax.random.PRNGKey(0), jnp.asarray(tokens), decode=True)
    params, cache = _perturbed(variables["params"]), variables["cache"]

    @jax.jit
    def step(cache, t):
        return jdec.apply({"params": params, "cache": cache}, t, decode=True, mutable=["cache"])

    port = _load(Decoder(_dec_cfg(pconfig.DecoderConfig)), params)
    full = port(_t(tokens).long())["decoder_out"]
    state, outs = {}, []
    for lo, hi in ((0, 3), (3, 4), (4, 5), (5, 6), (6, 7)):
        (want, mods) = step(cache, jnp.asarray(tokens[:, lo:hi]))
        cache = mods["cache"]
        got = port(_t(tokens[:, lo:hi]).long(), incremental_state=state)["decoder_out"]
        np.testing.assert_allclose(_n(got), np.asarray(want["decoder_out"]), **FWD)
        outs.append(got)
    assert sorted(state) == [0, 1] and state[1]["index"] == 7
    np.testing.assert_allclose(_n(torch.cat(outs, 1)), _n(full), **STEP)


@pytest.mark.parametrize("model", ["decoder", "longnet"])
def test_decoder_checkpoint_replays_the_generator(model):
    """With ``checkpoint_activations`` the backward re-runs each layer; the
    re-run draws the forward's attention-dropout and drop-path masks from
    the caller's generator, so the gradients equal those of a run without
    checkpoints, and the generator ends where the forward left it."""
    kw = dict(dropout=0.1, attention_dropout=0.3, drop_path_rate=0.5, **(SCHED if model == "longnet" else {}))
    cls = LongNetDecoder if model == "longnet" else Decoder
    torch.manual_seed(0)
    ref = cls(_dec_cfg(pconfig.DecoderConfig, **kw)).train()
    remat = cls(_dec_cfg(pconfig.DecoderConfig, checkpoint_activations=True, **kw)).train()
    remat.load_state_dict(ref.state_dict())
    tokens = torch.randint(0, V, (2, 16), generator=torch.Generator().manual_seed(1))
    grads, states = [], []
    for module in (ref, remat):
        gen = torch.Generator().manual_seed(2)
        torch.manual_seed(3)  # the plain dropout draws from torch's default generator
        module(tokens, generator=gen)["decoder_out"].square().sum().backward()
        grads.append({n: p.grad for n, p in module.named_parameters() if p.grad is not None})
        states.append(gen.get_state())
    assert sorted(grads[0]) == sorted(grads[1])
    for name, g in grads[0].items():
        np.testing.assert_allclose(_n(grads[1][name]), _n(g), err_msg=name, **FWD)
    assert torch.equal(states[0], states[1])
    gen = torch.Generator().manual_seed(2)
    torch.manual_seed(3)
    out = remat(tokens, generator=gen)["decoder_out"]
    torch.manual_seed(3)
    assert not torch.allclose(out, ref(tokens, generator=torch.Generator().manual_seed(4))["decoder_out"])


def test_decoder_positions_continue_across_steps():
    """An ``embed_positions`` table (fairseq positions 2..) gives a stepped
    decode the whole sequence's positions."""
    from gigapath_tpu_torch.ops.embedding import PositionalEmbedding

    torch.manual_seed(0)
    port = Decoder(_dec_cfg(pconfig.DecoderConfig), embed_positions=PositionalEmbedding(32, E)).eval()
    tokens = torch.randint(0, V, (1, 6))
    full = port(tokens)["decoder_out"]
    state = {}
    stepped = torch.cat([port(tokens[:, :4], incremental_state=state)["decoder_out"]]
                        + [port(tokens[:, t:t + 1], incremental_state=state)["decoder_out"] for t in (4, 5)], 1)
    np.testing.assert_allclose(_n(stepped), _n(full), **STEP)
    rel = Decoder(_dec_cfg(pconfig.DecoderConfig, rel_pos_buckets=8, max_rel_pos=16))
    with pytest.raises(ValueError, match="relative position"):
        rel(tokens, incremental_state={})


@pytest.mark.parametrize("kw", [dict(rel_pos_buckets=16, max_rel_pos=32, deepnorm=True),
                                dict(share_all_embeddings=True)], ids=["rel_pos_deepnorm", "share_all_embeddings"])
def test_encoder_decoder_matches_jax(kw):
    """``share_all_embeddings`` ties the decoder's output projection to its
    table, the JAX tree's one table for both (the port's tied
    ``output_projection.weight`` is the key the tree lacks)."""
    cfg = dict(encoder_embed_dim=E, encoder_attention_heads=HEADS, encoder_ffn_embed_dim=FFN, encoder_layers=2,
               decoder_embed_dim=E, decoder_attention_heads=HEADS, decoder_ffn_embed_dim=48, decoder_layers=2,
               vocab_size=V, dropout=0.0, drop_path_rate=0.0, **kw)
    rng = np.random.default_rng(9)
    src = rng.integers(0, V, (2, 10)).astype(np.int32)
    tgt = rng.integers(0, V, (2, 6)).astype(np.int32)
    jmodel = JEncoderDecoder(JEncoderDecoderConfig(**cfg))
    params = _perturbed(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(src), jnp.asarray(tgt))["params"])
    want = jax.jit(lambda p, s, t: jmodel.apply({"params": p}, s, t)["decoder_out"])(params, src, tgt)
    pcfg = pconfig.EncoderDecoderConfig(**cfg)
    port = EncoderDecoder(pcfg, encoder_embed_tokens=torch.nn.Embedding(V, E))
    # torchscale's encoder builds an output projection the encoder-decoder
    # never applies (features_only); the JAX tree has none
    extra = ["encoder.output_projection.weight"]
    if kw.get("share_all_embeddings"):
        extra.append("decoder.output_projection.weight")
    port = _load(port, params, extra)
    got = port(_t(src).long(), _t(tgt).long())["decoder_out"]
    np.testing.assert_allclose(_n(got), np.asarray(want), **FWD)


LONGNET_DEC = dict(decoder_embed_dim=E, decoder_attention_heads=HEADS, decoder_ffn_embed_dim=FFN, decoder_layers=2,
                   dropout=0.0, drop_path_rate=0.0, no_output_layer=True, **SCHED)


def test_longnet_decoder_full_and_stepped_match_jax():
    """The slice's model, fed token embeddings (no output layer, as on the
    card): the whole causal sequence against JAX's jitted forward; a
    prefill of 11 rows then single steps and a chunk, at and across segment
    boundaries against JAX's eager ``decode=True`` steps; and the steps
    against the whole sequence."""
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, 17, E)).astype(np.float32)
    jdec = JLongNetDecoder(JDecoderConfig(**LONGNET_DEC))
    variables = jax.jit(lambda key, a: jdec.init(key, token_embeddings=a, decode=True))(jax.random.PRNGKey(0), x)
    params, cache = _perturbed(variables["params"]), variables["cache"]
    want_full = jax.jit(lambda p, a: jdec.apply({"params": p}, token_embeddings=a)["decoder_out"])(params, x)
    port = _load(LongNetDecoder(pconfig.DecoderConfig(**LONGNET_DEC)), params)
    full = port(token_embeddings=_t(x))["decoder_out"]
    np.testing.assert_allclose(_n(full), np.asarray(want_full), **FWD)
    state, outs = {}, []
    for lo, hi in ((0, 11), (11, 12), (12, 15), (15, 16), (16, 17)):
        want, mods = jdec.apply({"params": params, "cache": cache}, token_embeddings=jnp.asarray(x[:, lo:hi]),
                                decode=True, mutable=["cache"])
        cache = mods["cache"]
        got = port(token_embeddings=_t(x[:, lo:hi]), incremental_state=state)["decoder_out"]
        np.testing.assert_allclose(_n(got), np.asarray(want["decoder_out"]), err_msg=f"[{lo}, {hi})", **FWD)
        outs.append(got)
    np.testing.assert_allclose(_n(torch.cat(outs, 1)), _n(full), **STEP)


def test_longnet_decoder_refuses_a_traced_index():
    port = LongNetDecoder(pconfig.DecoderConfig(**LONGNET_DEC)).eval()
    x = torch.randn(1, 4, E)
    with pytest.raises(NotImplementedError, match="concrete"):
        port(token_embeddings=x, incremental_state={0: {"index": 1.5}})


# ---------------------------------------------------------------------------
# the encoder's inputs, the init transforms
# ---------------------------------------------------------------------------


def test_encoder_tokens_positions_and_rel_pos_match_jax():
    """``src_tokens`` through ``embed_tokens`` with the embedding scale, a
    positions module, ``layernorm_embedding``, the rel-pos bias, an
    ``attn_mask`` and the output projection."""
    from gigapath_tpu.ops.embedding import PositionalEmbedding as JPositionalEmbedding
    from gigapath_tpu_torch.ops.embedding import PositionalEmbedding

    cfg = dict(encoder_embed_dim=E, encoder_attention_heads=HEADS, encoder_ffn_embed_dim=FFN, encoder_layers=2,
               vocab_size=V, no_scale_embedding=False, layernorm_embedding=True, rel_pos_buckets=16,
               max_rel_pos=32, dropout=0.0, drop_path_rate=0.0)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, V, (2, 9)).astype(np.int32)
    mask = rng.random((9, 9)) < 0.2

    class WithPositions(fnn.Module):
        @fnn.compact
        def __call__(self, tokens, mask):
            pos = JPositionalEmbedding(16, E, name="embed_positions")
            enc = JEncoder(JEncoderConfig(**cfg), name="encoder")
            return enc(tokens, attn_mask=mask, embed_positions=lambda x, p, s: pos(x, p))

    jmod = WithPositions()
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), jnp.asarray(tokens), jnp.asarray(mask))["params"])
    want = jax.jit(lambda p, t, m: jmod.apply({"params": p}, t, m)["encoder_out"])(params, tokens, mask)
    port = Encoder(pconfig.EncoderConfig(**cfg), embed_tokens=torch.nn.Embedding(V, E),
                   embed_positions=PositionalEmbedding(16, E))
    tree = dict(params["encoder"], embed_positions=params["embed_positions"])
    port = _load(port, tree)
    got = port(src_tokens=_t(tokens).long(), attn_mask=_t(mask))["encoder_out"]
    np.testing.assert_allclose(_n(got), np.asarray(want), **FWD)


@pytest.mark.parametrize("kind", ["subln", "deepnorm", "encdec_subln", "encdec_deepnorm", "none"])
def test_apply_init_scaling_matches_jax(kind):
    cfg = dict(encoder_embed_dim=E, encoder_attention_heads=HEADS, encoder_ffn_embed_dim=FFN, encoder_layers=2,
               dropout=0.0, drop_path_rate=0.0)
    jenc = JEncoder(JEncoderConfig(**cfg))
    x = jnp.zeros((1, 4, E))
    params = _perturbed(jenc.init(jax.random.PRNGKey(0), token_embeddings=x)["params"])
    kw = dict(subln="subln" in kind, deepnorm="deepnorm" in kind, num_layers=2,
              is_encoder_decoder=kind.startswith("encdec"), decoder_layers=3)
    want = state_dict_from_flax_params(jinit.apply_init_scaling(params, **kw))
    got = pinit.apply_init_scaling(state_dict_from_flax_params(params), **kw)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(_n(got[key]), _n(want[key]), err_msg=key, **FWD)
    module = _load(Encoder(pconfig.EncoderConfig(**cfg)), params)
    pinit.apply_init_scaling(module, **kw)
    for key, value in module.state_dict().items():
        np.testing.assert_allclose(_n(value), _n(want[key]), err_msg=key, **FWD)


def test_init_bert_params_redraws_what_jax_redraws():
    """The same tensors redrawn (every matrix and table, no vector), the
    same delivered std (0.02, q/k/v 0.02/sqrt(2)), truncated at 2 std of
    the unit draw; the generators differ, so the bits do not."""
    cfg = dict(encoder_embed_dim=64, encoder_attention_heads=4, encoder_ffn_embed_dim=128, encoder_layers=1,
               vocab_size=300, dropout=0.0, drop_path_rate=0.0)
    jenc = JEncoder(JEncoderConfig(**cfg))
    tokens = jnp.zeros((1, 4), jnp.int32)
    params = _perturbed(jenc.init(jax.random.PRNGKey(0), tokens)["params"])
    before = state_dict_from_flax_params(params)
    want = state_dict_from_flax_params(jinit.init_bert_params(params, jax.random.PRNGKey(1)))
    got = pinit.init_bert_params(before, torch.Generator().manual_seed(1))
    for key in before:
        changed_j = not torch.equal(want[key], before[key])
        changed_p = not torch.equal(got[key], before[key])
        assert changed_j == changed_p, key
        if changed_p:
            std = 0.02 / np.sqrt(2) if any(p in key for p in ("q_proj", "k_proj", "v_proj")) else 0.02
            for t in (got[key], want[key]):
                assert abs(float(t.std()) / std - 1) < 0.15, key
                assert float(t.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6, key
    module = Encoder(pconfig.EncoderConfig(**cfg), embed_tokens=torch.nn.Embedding(300, 64))
    pinit.init_bert_params(module, torch.Generator().manual_seed(1))
    assert abs(float(module.output_projection.weight.detach().std()) / 0.02 - 1) < 0.15
