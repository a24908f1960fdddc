"""The port's embeddings (``ops/embedding.py``), the multiway encoder and
BEiT-3 (``models/beit3.py``) held against the JAX package on the CPU,
forward 1e-5 in fp32, from the JAX init's parameters
(``state_dict_from_flax_params``: BEiT-3's position tables move under
``encoder.``, where torchscale keeps them). Images are NHWC for the JAX
package and NCHW for the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test process)
from flax import linen as fnn

from gigapath_tpu.architecture.config import EncoderConfig as JEncoderConfig
from gigapath_tpu.architecture.encoder import Encoder as JEncoder
from gigapath_tpu.models.beit3 import BEiT3 as JBEiT3
from gigapath_tpu.ops import embedding as jemb
from gigapath_tpu_torch.architecture.config import EncoderConfig
from gigapath_tpu_torch.architecture.encoder import Encoder
from gigapath_tpu_torch.models.beit3 import BEiT3
from gigapath_tpu_torch.ops import embedding as pemb
from gigapath_tpu_torch.utils.convert import state_dict_from_flax_params

FWD = dict(atol=1e-5, rtol=1e-5)
E = 32


def _perturbed(params, seed=1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32),
                                  params)


def _load(module, params):
    module.load_state_dict(state_dict_from_flax_params(params), strict=True)
    return module.eval()


def _n(x):
    return x.detach().numpy()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_embeddings_match_jax():
    """The vision embedding (with and without masked patches, cls
    prepended), the text and positional tables (fairseq offset), and the
    fused vision-language embedding."""
    rng = np.random.default_rng(0)
    img = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    masked = (rng.random((2, 4)) < 0.5).astype(np.int32)
    jve = jemb.VisionEmbedding(img_size=32, patch_size=16, embed_dim=E, contain_mask_token=True,
                               prepend_cls_token=True)
    params = _perturbed(jve.init(jax.random.PRNGKey(0), jnp.asarray(img))["params"])
    pve = _load(pemb.VisionEmbedding(32, 16, 3, E, contain_mask_token=True, prepend_cls_token=True), params)
    assert pve.num_position_embeddings() == jve.num_position_embeddings() == 5
    for m in (None, masked):
        want = jve.apply({"params": params}, jnp.asarray(img), None if m is None else jnp.asarray(m))
        got = pve(_nchw(img), None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(_n(got), np.asarray(want), **FWD)

    tokens = rng.integers(0, 40, (2, 6)).astype(np.int32)
    jte = jemb.TextEmbedding(40, E)
    tparams = jte.init(jax.random.PRNGKey(1), jnp.asarray(tokens))["params"]
    pte = _load(pemb.TextEmbedding(40, E), tparams)
    np.testing.assert_allclose(_n(pte(torch.from_numpy(tokens).long())),
                               np.asarray(jte.apply({"params": tparams}, jnp.asarray(tokens))), **FWD)
    assert abs(float(pemb.TextEmbedding(1000, 64).weight.detach().std()) / 64**-0.5 - 1) < 0.1

    jpe = jemb.PositionalEmbedding(10, E)
    x = np.zeros((1, 3, E), np.float32)
    pparams = jpe.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    ppe = _load(pemb.PositionalEmbedding(10, E), pparams)
    np.testing.assert_allclose(_n(ppe(torch.from_numpy(x))), np.asarray(jpe.apply({"params": pparams}, x)), **FWD)
    positions = np.array([[7, 3, 2]])
    np.testing.assert_allclose(_n(ppe(torch.from_numpy(x), torch.from_numpy(positions))),
                               np.asarray(jpe.apply({"params": pparams}, x, jnp.asarray(positions))), **FWD)

    class VL(fnn.Module):
        @fnn.compact
        def __call__(self, text, image):
            return jemb.VisionLanguageEmbedding(
                text_embed=jemb.TextEmbedding(40, E, name="text_embed"),
                vision_embed=jemb.VisionEmbedding(img_size=32, patch_size=16, embed_dim=E, name="vision_embed"),
            )(text, image)

    vl = VL()
    vparams = _perturbed(vl.init(jax.random.PRNGKey(3), jnp.asarray(tokens), jnp.asarray(img))["params"])
    pvl = _load(pemb.VisionLanguageEmbedding(pemb.TextEmbedding(40, E), pemb.VisionEmbedding(32, 16, 3, E)), vparams)
    np.testing.assert_allclose(_n(pvl(torch.from_numpy(tokens).long(), _nchw(img))),
                               np.asarray(vl.apply({"params": vparams}, jnp.asarray(tokens), jnp.asarray(img))), **FWD)


def _enc_cfg(cls, **kw):
    base = dict(encoder_embed_dim=E, encoder_attention_heads=4, encoder_ffn_embed_dim=64, encoder_layers=2,
                multiway=True, dropout=0.0, drop_path_rate=0.0)
    return cls(**{**base, **kw})


def test_multiway_encoder_matches_jax():
    """Every LayerNorm, projection and FFN split at the position: -1 (all
    A), 0 (all B) and inside the sequence; ``layernorm_embedding``
    multiway too."""
    x = np.random.default_rng(4).normal(size=(2, 8, E)).astype(np.float32)
    kw = dict(vocab_size=-1, no_output_layer=True, layernorm_embedding=True)
    jenc = JEncoder(_enc_cfg(JEncoderConfig, **kw))
    params = _perturbed(jenc.init(jax.random.PRNGKey(0), token_embeddings=jnp.asarray(x),
                                  multiway_split_position=4)["params"])
    port = _load(Encoder(_enc_cfg(EncoderConfig, **kw)), params)
    want = jax.jit(lambda p, a: [jenc.apply({"params": p}, token_embeddings=a, multiway_split_position=s)["encoder_out"]
                                 for s in (-1, 0, 4)])(params, x)
    for split, w in zip((-1, 0, 4), want):
        got = port(torch.from_numpy(x), multiway_split_position=split)["encoder_out"]
        np.testing.assert_allclose(_n(got), np.asarray(w), err_msg=f"split {split}", **FWD)


BEIT3_CFG = dict(vocab_size=100, img_size=32, patch_size=16, no_output_layer=True)


@pytest.fixture(scope="module")
def beit3():
    rng = np.random.default_rng(5)
    text = rng.integers(0, 100, (2, 6)).astype(np.int32)
    image = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    jmodel = JBEiT3(_enc_cfg(JEncoderConfig, **BEIT3_CFG))
    params = _perturbed(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(text), jnp.asarray(image))["params"])
    port = _load(BEiT3(_enc_cfg(EncoderConfig, **BEIT3_CFG)), params)
    return text, image, jmodel, params, port


CASES = {
    "fused": dict(text=True, image=True),
    "text": dict(text=True),
    "vision_masked": dict(image=True, masked=True),
    "fused_padded_positions": dict(text=True, image=True, pad=True, positions=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_beit3_matches_jax(beit3, case):
    text, image, jmodel, params, port = beit3
    c = CASES[case]
    pad = np.zeros((2, 6), bool)
    pad[1, 4:] = True
    masked = np.zeros((2, 4), np.int32)
    masked[:, 1] = 1
    L = (5 if c.get("image") else 0) + (6 if c.get("text") else 0)
    j = dict(textual_tokens=jnp.asarray(text) if c.get("text") else None,
             visual_tokens=jnp.asarray(image) if c.get("image") else None,
             text_padding_position=jnp.asarray(pad) if c.get("pad") else None,
             vision_masked_position=jnp.asarray(masked) if c.get("masked") else None,
             positions=jnp.arange(2, L + 2)[None, :] if c.get("positions") else None)
    want = jmodel.apply({"params": params}, **j)
    got = port(textual_tokens=torch.from_numpy(text).long() if c.get("text") else None,
               visual_tokens=_nchw(image) if c.get("image") else None,
               text_padding_position=torch.from_numpy(pad) if c.get("pad") else None,
               vision_masked_position=torch.from_numpy(masked) if c.get("masked") else None,
               positions=torch.arange(2, L + 2)[None, :] if c.get("positions") else None)
    assert got["multiway_split_position"] == want["multiway_split_position"]
    np.testing.assert_allclose(_n(got["encoder_out"]), np.asarray(want["encoder_out"]), **FWD)


def test_beit3_keys_are_torchscale_s():
    cfg = _enc_cfg(EncoderConfig, vocab_size=100, img_size=32, patch_size=16)
    keys = set(BEiT3(cfg).state_dict())
    assert {"text_embed.weight", "vision_embed.proj.weight", "vision_embed.cls_token", "vision_embed.mask_token",
            "encoder.embed_positions.A.weight", "encoder.embed_positions.B.weight",
            "encoder.layers.0.self_attn.q_proj.A.weight", "encoder.layers.0.ffn.B.fc1.weight",
            "encoder.layers.0.self_attn.inner_attn_ln.B.weight", "encoder.layer_norm.A.weight",
            "encoder.output_projection.weight"} <= keys
    with pytest.raises(ValueError, match="multiway"):
        BEiT3(_enc_cfg(EncoderConfig, multiway=False, vocab_size=100))
