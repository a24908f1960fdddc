"""The port's RetNet (``ops/multiscale_retention.py``,
``architecture/retnet.py``) held against the JAX package on the CPU: the
relative-position constants of the three forms, ``MultiScaleRetention`` in
its parallel, chunkwise and recurrent forms, and ``RetNetDecoder`` (the
parallel form, the chunkwise form with its chunk padding, and recurrent
decoding step by step), each from the JAX init's parameters
(``state_dict_from_flax_params``), forward 1e-5 in fp32. The JAX
references are jitted (the recurrent steps with the position static).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test process)

from gigapath_tpu.architecture.config import RetNetConfig as JRetNetConfig
from gigapath_tpu.architecture.retnet import RetNetDecoder as JRetNetDecoder
from gigapath_tpu.ops import multiscale_retention as jmsr
from gigapath_tpu_torch.architecture.config import RetNetConfig
from gigapath_tpu_torch.architecture.retnet import RetNetDecoder
from gigapath_tpu_torch.ops import multiscale_retention as pmsr
from gigapath_tpu_torch.utils.convert import state_dict_from_flax_params

FWD = dict(atol=1e-5, rtol=1e-5)
E, VD, H, V = 32, 64, 4, 50


def _perturbed(params, seed=1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32),
                                  params)


def _load(module, params):
    module.load_state_dict(state_dict_from_flax_params(params), strict=True)
    return module.eval()


def _n(x):
    return x.detach().numpy()


def _flat(tree):
    return [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("form", ["parallel", "chunkwise", "recurrent"])
def test_rel_pos_constants_match_jax(form):
    kw = dict(chunkwise_recurrent=form == "chunkwise", recurrent_chunk_size=4, activate_recurrent=form == "recurrent")
    want = jmsr.retnet_rel_pos(12, E, H, **kw)
    got = pmsr.retnet_rel_pos(12, E, H, **kw)
    for a, b in zip(jax.tree_util.tree_leaves(got), _flat(want)):
        np.testing.assert_array_equal(a.numpy(), b)
    for a, b in zip(pmsr.retnet_angle_decay(E, H), jmsr.retnet_angle_decay(E, H)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def msr():
    x = np.random.default_rng(0).normal(size=(2, 16, E)).astype(np.float32)
    jmod = jmsr.MultiScaleRetention(embed_dim=E, value_dim=VD, num_heads=H)
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jmsr.retnet_rel_pos(16, E, H))["params"])
    return x, jmod, params, _load(pmsr.MultiScaleRetention(E, VD, H), params)


def test_retention_parallel_and_chunkwise_match_jax(msr):
    x, jmod, params, port = msr
    for chunk in (False, True):
        kw = dict(chunkwise_recurrent=chunk, recurrent_chunk_size=4)
        want = jax.jit(lambda p, a: jmod.apply({"params": p}, a, jmsr.retnet_rel_pos(16, E, H, **kw),
                                               chunkwise_recurrent=chunk))(params, x)
        got = port(torch.from_numpy(x), pmsr.retnet_rel_pos(16, E, H, **kw), chunkwise_recurrent=chunk)
        np.testing.assert_allclose(_n(got), np.asarray(want), err_msg=f"chunkwise={chunk}", **FWD)


def test_retention_recurrent_matches_jax(msr):
    x, jmod, params, port = msr
    T = 5
    cache = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x[:, :1]), jmsr.retnet_rel_pos(1, E, H, activate_recurrent=True),
                      decode=True)["cache"]

    @functools.partial(jax.jit, static_argnums=2)
    def step(cache, a, t):
        return jmod.apply({"params": params, "cache": cache}, a, jmsr.retnet_rel_pos(t + 1, E, H, activate_recurrent=True),
                          decode=True, mutable=["cache"])

    state = {}
    for t in range(T):
        want, mods = step(cache, x[:, t:t + 1], t)
        cache = mods["cache"]
        got = port(torch.from_numpy(x[:, t:t + 1]), pmsr.retnet_rel_pos(t + 1, E, H, activate_recurrent=True),
                   incremental_state=state)
        np.testing.assert_allclose(_n(got), np.asarray(want), err_msg=f"step {t}", **FWD)
        np.testing.assert_allclose(_n(state["prev_key_value"]), np.asarray(cache["prev_key_value"]), **FWD)


def _cfg(cls, **kw):
    base = dict(decoder_embed_dim=E, decoder_value_embed_dim=VD, decoder_retention_heads=H, decoder_ffn_embed_dim=48,
                decoder_layers=2, vocab_size=V, dropout=0.0, drop_path_rate=0.0)
    return cls(**{**base, **kw})


@pytest.fixture(scope="module")
def decoder():
    tokens = np.random.default_rng(2).integers(0, V, (2, 10)).astype(np.int32)
    jdec = JRetNetDecoder(_cfg(JRetNetConfig, layernorm_embedding=True, no_scale_embedding=False))
    params = _perturbed(jdec.init(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"])
    return tokens, params


@pytest.mark.parametrize("chunkwise", [False, True], ids=["parallel", "chunkwise_padded"])
def test_retnet_decoder_matches_jax(decoder, chunkwise):
    tokens, params = decoder
    kw = dict(layernorm_embedding=True, no_scale_embedding=False, chunkwise_recurrent=chunkwise,
              recurrent_chunk_size=4)  # 10 tokens: padded to 12 and cut back
    jdec = JRetNetDecoder(_cfg(JRetNetConfig, **kw))
    want = jax.jit(lambda p, t: jdec.apply({"params": p}, t, return_all_hiddens=True))(params, tokens)
    port = _load(RetNetDecoder(_cfg(RetNetConfig, **kw)), params)
    got = port(torch.from_numpy(tokens).long(), return_all_hiddens=True)
    np.testing.assert_allclose(_n(got["decoder_out"]), np.asarray(want["decoder_out"]), **FWD)
    for a, b in zip(got["inner_states"], want["inner_states"]):
        np.testing.assert_allclose(_n(a), np.asarray(b), **FWD)


def test_retnet_decoder_recurrent_steps_match_jax(decoder):
    tokens, params = decoder
    kw = dict(layernorm_embedding=True, no_scale_embedding=False)
    jdec = JRetNetDecoder(_cfg(JRetNetConfig, **kw))
    cache = jax.jit(lambda key, t: jdec.init(key, t, decode=True))(jax.random.PRNGKey(0), tokens[:, :1])["cache"]

    @functools.partial(jax.jit, static_argnums=2)
    def step(cache, t_tokens, t):
        return jdec.apply({"params": params, "cache": cache}, t_tokens, decode=True, decode_position=t,
                          mutable=["cache"])

    port = _load(RetNetDecoder(_cfg(RetNetConfig, **kw)), params)
    state = {}
    for t in range(4):
        want, mods = step(cache, tokens[:, t:t + 1], t)
        cache = mods["cache"]
        got = port(torch.from_numpy(tokens[:, t:t + 1]).long(), incremental_state=state)
        np.testing.assert_allclose(_n(got["decoder_out"]), np.asarray(want["decoder_out"]), err_msg=f"step {t}",
                                   **FWD)
    assert state["position"] == 4 and sorted(k for k in state if k != "position") == [0, 1]
    with pytest.raises(ValueError, match="one token"):
        port(torch.from_numpy(tokens[:, :2]).long(), incremental_state={})


def test_config_defaults_do_not_split_into_heads_in_either_package():
    """RetNetConfig's defaults (value width 1280, 3 heads) reshape v into
    426-wide heads: the JAX package fails there and the port refuses them
    when it builds the layer."""
    jcfg = JRetNetConfig(decoder_layers=1)
    x = jnp.zeros((1, 4, jcfg.decoder_embed_dim))
    with pytest.raises(TypeError):
        JRetNetDecoder(jcfg).init(jax.random.PRNGKey(0), token_embeddings=x)
    with pytest.raises(ValueError, match="heads"):
        RetNetDecoder(RetNetConfig(decoder_layers=1))
