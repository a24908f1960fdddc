"""The port's tile encoder and two-stage pipeline held against the JAX
package on the CPU.

Weights are made by the JAX model's init, perturbed from a numpy seed (so
the LayerScales are O(0.1), not 1e-5, and every block matters), and handed
to the port through ``state_dict_from_flax_params`` (strict load); images
come from a numpy seed.

Tolerances:

- fp32 forward and ``forward_features``: atol/rtol 1e-5 (sums in another
  order; flax's LayerNorm takes the variance as E[x^2] - E[x]^2).
- the ``int8``, ``fp8_e4m3`` and ``int8+attn`` tiers: relative error
  ||ours - ref|| / ||ref|| over the whole output <= 1e-4, and 1e-3 for
  ``+attn``. The matmuls round their fp32 input to bf16 in both packages,
  and inputs that differ by the fp32 rounding above can land on the two
  sides of a bf16 rounding boundary: one such flip moves an output by one
  bf16 ulp of one product, up to ~5e-4 of the largest output at these
  widths, and later blocks carry it on (max |err| / max |ref| read 1.3e-4
  for fp8 at the ragged config; the norm ratio read 2.2e-5 there and
  <= 5e-6 elsewhere). With ``+attn`` a Q or K value near the midpoint of
  two int8 levels can also round to either, and one flipped quantum moves
  one logit by up to absmax(q)*absmax(k)*D^-1/2/127 of its (batch, head),
  hence the wider limit.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test process)
from PIL import Image

from gigapath_tpu import pipeline as jpipeline
from gigapath_tpu.data import transforms as jtransforms
from gigapath_tpu.models import slide_encoder as jslide
from gigapath_tpu.models.tile_encoder import VisionTransformer as JaxViT
from gigapath_tpu.models.tile_encoder import init_params
from gigapath_tpu.models.tile_encoder import interpolate_pos_embed as jax_interpolate
from gigapath_tpu_torch import pipeline as ppipeline
from gigapath_tpu_torch.data import tile_dataset as pdataset
from gigapath_tpu_torch.data import transforms as ptransforms
from gigapath_tpu_torch.models import slide_encoder as pslide
from gigapath_tpu_torch.models import tile_encoder as pte
from gigapath_tpu_torch.quant.qmatmul import QuantLinear
from gigapath_tpu_torch.utils.convert import state_dict_from_flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = dict(img_size=32, patch_size=16, embed_dim=32, depth=2, num_heads=4,
            mlp_ratio=4.0, swiglu=True, init_values=1e-5)
# 3 x 3 patches + cls = 10 tokens (no multiple of any tile), head width 16
RAGGED = dict(img_size=48, patch_size=16, embed_dim=64, depth=2, num_heads=4,
              mlp_ratio=4.0, swiglu=True, init_values=1e-5)
CONFIGS = {"tiny_swiglu": TINY, "tiny_gelu": dict(TINY, swiglu=False), "ragged": RAGGED}
QUANT_TOL = {"int8": 1e-4, "fp8_e4m3": 1e-4, "int8+attn": 1e-3}


def _weights(cfg, seed=1):
    params = init_params(JaxViT(**cfg))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rng.normal(size=p.shape).astype(np.float32), params
    )


def _port(cfg, params, **kw):
    model = pte.VisionTransformer(**{**cfg, **kw}).eval()
    model.load_state_dict(state_dict_from_flax_params(params), strict=True)
    return model


def _images(cfg, n=3, seed=2):
    return np.random.default_rng(seed).normal(size=(n, cfg["img_size"], cfg["img_size"], 3)).astype(np.float32)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_and_features_match_jax(name):
    cfg = CONFIGS[name]
    params = _weights(cfg)
    img = _images(cfg)
    jmodel = JaxViT(**cfg)
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(img)))
    ref_tokens = np.asarray(jmodel.apply({"params": params}, jnp.asarray(img), method=jmodel.forward_features))
    model = _port(cfg, params)
    with torch.no_grad():
        out = model(torch.from_numpy(img)).numpy()
        tokens = model.forward_features(torch.from_numpy(img)).numpy()
    assert tokens.shape == (3, 1 + (cfg["img_size"] // 16) ** 2, cfg["embed_dim"])
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tokens, ref_tokens, atol=1e-5, rtol=1e-5)


def test_avg_pool_matches_jax():
    params = _weights(TINY)
    img = _images(TINY)
    ref = np.asarray(JaxViT(**TINY, global_pool="avg").apply({"params": params}, jnp.asarray(img)))
    with torch.no_grad():
        out = _port(TINY, params, global_pool="avg")(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("quant", sorted(QUANT_TOL))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_quant_tiers_match_jax(name, quant):
    cfg = CONFIGS[name]
    params = _weights(cfg)
    img = _images(cfg)
    jmodel = JaxViT(**cfg, quant=quant)
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(img)))
    ref_tokens = np.asarray(jmodel.apply({"params": params}, jnp.asarray(img), method=jmodel.forward_features))
    model = _port(cfg, params, quant=quant)
    assert sum(isinstance(m, QuantLinear) for m in model.modules()) == 4 * cfg["depth"]
    with torch.no_grad():
        out = model(torch.from_numpy(img)).numpy()
        tokens = model.forward_features(torch.from_numpy(img)).numpy()
    assert _rel(out, ref) <= QUANT_TOL[quant], _rel(out, ref)
    assert _rel(tokens, ref_tokens) <= QUANT_TOL[quant], _rel(tokens, ref_tokens)


def test_bf16_compute_dtype_tracks_jax():
    """The bf16 tier (fp32 parameters, bf16 compute): the same function as
    the JAX model with ``dtype=bfloat16``, within bf16 rounding through two
    blocks (1 - cosine per image <= 1e-3)."""
    params = _weights(RAGGED)
    img = _images(RAGGED)
    ref = np.asarray(JaxViT(**RAGGED, dtype=jnp.bfloat16).apply({"params": params}, jnp.asarray(img)), np.float32)
    with torch.no_grad():
        out = _port(RAGGED, params, dtype=torch.bfloat16)(torch.from_numpy(img))
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    cos = (out * ref).sum(-1) / (np.linalg.norm(out, axis=-1) * np.linalg.norm(ref, axis=-1))
    assert (1.0 - cos).max() <= 1e-3, cos


@pytest.mark.parametrize("old,new", [(4, 8), (16, 14)])
def test_interpolate_pos_embed_matches_jax(old, new):
    """jax.image.resize's bicubic (a = -0.5, half-pixel centres, antialiased
    when downsampling): 2e-6 (one einsum in another order)."""
    table = np.random.default_rng(3).normal(size=(1, 1 + old * old, 24)).astype(np.float32)
    ref = jax_interpolate(table, new)
    ours = pte.interpolate_pos_embed(torch.from_numpy(table), new).numpy()
    assert ours.shape == ref.shape == (1, 1 + new * new, 24)
    np.testing.assert_array_equal(ours[:, 0], table[:, 0])
    np.testing.assert_allclose(ours, ref, atol=2e-6, rtol=2e-6)


def test_timm_state_dict_at_another_grid_loads_through_the_resize():
    """A checkpoint at grid 2 loads into a grid-4 model: the position
    table is resized, the head and mask token are skipped."""
    params = _weights(TINY)
    state = state_dict_from_flax_params(params)
    state["head.weight"] = torch.zeros(3, 32)
    state["mask_token"] = torch.zeros(1, 32)
    model = pte.VisionTransformer(**dict(TINY, img_size=64))
    missing, unexpected = pte.load_timm_state_dict(model, state)
    assert missing == [] and unexpected == []
    want = jax_interpolate(np.asarray(params["pos_embed"]), 4)
    np.testing.assert_allclose(model.pos_embed.detach().numpy(), want, atol=2e-6, rtol=2e-6)


def test_flagship_keys_and_parameter_count_are_timm_vitg():
    with open(os.path.join(REPO, "tests", "fixtures", "timm_vitg_keys.json")) as f:
        schema = {k: tuple(v) for k, v in json.load(f).items()}
    for quant in ("", "int8+attn"):
        with torch.device("meta"):
            model = pte.gigapath_tile_enc(quant=quant)
        state = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        assert state == schema
        assert pte.count_params(model) == 1_134_953_984
    with torch.device("meta"):
        model = pte.gigapath_tile_enc()
    model.load_state_dict({k: torch.empty(s, device="meta") for k, s in schema.items()}, strict=True)


def test_create_tile_encoder_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pte.create_tile_encoder("", "vit_tile_enc_test")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ppipeline.load_tile_slide_encoder()


@pytest.mark.parametrize("env,tier", [(None, "int8+attn"), ("fp8_e4m3", "fp8_e4m3"), ("0", "")],
                         ids=["plan", "env-wins", "env-off-wins"])
def test_quant_tier_follows_a_blessed_plan_as_the_jax_factory(tmp_path, monkeypatch, env, tier):
    """A ``tile_encoder.gigapath_tile_enc`` plan blessed in a temporary
    registry fills the tier where GIGAPATH_QUANT_TILE is unset, and the
    variable wins where it is set, in the port's factory (built on the meta
    device) as in the JAX factory (its parameter init skipped)."""
    from gigapath_tpu.models import tile_encoder as jte
    from gigapath_tpu.plan import executionplan as jep
    from gigapath_tpu_torch import plan as tplan

    monkeypatch.setenv("GIGAPATH_PLAN_REGISTRY", str(tmp_path / "PLAN_REGISTRY.json"))
    monkeypatch.delenv("GIGAPATH_PLAN", raising=False)
    monkeypatch.delenv("GIGAPATH_QUANT_PALLAS", raising=False)
    if env is None:
        monkeypatch.delenv("GIGAPATH_QUANT_TILE", raising=False)
    else:
        monkeypatch.setenv("GIGAPATH_QUANT_TILE", env)
    key = tplan.geometry_key("tile_encoder.gigapath_tile_enc", (torch.empty((1, 224, 224, 3), device="meta"),))
    assert key == jep.geometry_key("tile_encoder.gigapath_tile_enc",
                                   (jax.ShapeDtypeStruct((1, 224, 224, 3), jnp.float32),))
    tplan.bless_plan(key, tplan.ExecutionPlan(quant_tile="int8+attn").as_dict())
    tplan.reset_plan_state()
    jep.reset_plan_state()
    monkeypatch.setattr(jte, "init_params", lambda model, rng=None: {})
    jmodel, _ = jte.create_tile_encoder("", "gigapath_tile_enc")
    model = pte.create_tile_encoder("", "gigapath_tile_enc", device="meta", generator=torch.Generator())
    assert model.quant == jmodel.quant == tier
    assert tplan.plan_stats()["hits"] == 1
    tplan.reset_plan_state()
    jep.reset_plan_state()


def test_create_tile_encoder_reads_the_quant_tier_once(monkeypatch):
    monkeypatch.setenv("GIGAPATH_QUANT_TILE", "int8+attn")
    model = pte.create_tile_encoder("", "vit_tile_enc_test", device="cpu")
    assert model.quant == "int8+attn" and not model.training
    assert all(b.attn.quant_attn and isinstance(b.mlp.fc2, QuantLinear) for b in model.blocks)
    assert pte.create_tile_encoder("", "vit_tile_enc_test", device="cpu", quant="").quant == ""
    monkeypatch.setenv("GIGAPATH_QUANT_TILE", "int4")
    with pytest.raises(ValueError, match="unknown quant mode"):
        pte.create_tile_encoder("", "vit_tile_enc_test", device="cpu")


def test_create_tile_encoder_loads_a_timm_checkpoint_and_seeds_from_a_generator(tmp_path):
    params = _weights(TINY)
    path = tmp_path / "tile_encoder.pth"
    torch.save(state_dict_from_flax_params(params), path)
    model = pte.create_tile_encoder(str(path), "vit_tile_enc_test", device="cpu", quant="")
    for key, value in state_dict_from_flax_params(params).items():
        torch.testing.assert_close(model.state_dict()[key], value, rtol=0, atol=0)
    a, b, c = (pte.create_tile_encoder("", "vit_tile_enc_test", device="cpu", quant="",
                                       generator=torch.Generator().manual_seed(s)) for s in (5, 5, 6))
    assert torch.equal(a.blocks[0].attn.qkv.weight, b.blocks[0].attn.qkv.weight)
    assert not torch.equal(a.blocks[0].attn.qkv.weight, c.blocks[0].attn.qkv.weight)


# ---------------------------------------------------------------------------
# transforms, dataset and the pipeline entries
# ---------------------------------------------------------------------------


def _write_tiles(tmp_path, n, size=64, seed=4):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        arr = rng.integers(0, 256, (size, size + 8 * (i % 3), 3)).astype(np.uint8)
        path = tmp_path / f"{256 * i:05d}x_{512 * (i % 4):05d}y.png"
        Image.fromarray(arr).save(path)
        paths.append(str(path))
    return paths


def test_preprocess_tile_and_dataset_match_jax(tmp_path):
    """The same resize and crop; the affine (x/255 - mean)/std in fp32
    (1e-6: the JAX package computes it natively or in numpy)."""
    path = _write_tiles(tmp_path, 1, size=300)[0]
    img = np.asarray(Image.open(path))
    for crop in (224, 32):
        ours = ptransforms.preprocess_tile(img, crop_size=crop)
        ref = jtransforms.preprocess_tile(img, crop_size=crop)
        assert ours.dtype == np.float32 and ours.shape == (crop, crop, 3)
        np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=1e-6)
    sample = pdataset.TileEncodingDataset([path], transform=ptransforms.preprocess_tile)[0]
    np.testing.assert_array_equal(sample["coords"], [0.0, 0.0])
    np.testing.assert_array_equal(pdataset.parse_tile_coords("a/slide_00123x_00456y.png"), [123.0, 456.0])


@pytest.fixture(scope="module")
def tile_run(tmp_path_factory):
    """Six PNG tiles through both packages' tile entry at batch 4 (one full
    batch and one padded partial batch)."""
    tmp_path = tmp_path_factory.mktemp("tiles")
    paths = _write_tiles(tmp_path, 6)
    params = _weights(TINY)
    ref = jpipeline.run_inference_with_tile_encoder(paths, JaxViT(**TINY), params, batch_size=4)
    model = pte.create_tile_encoder("", "vit_tile_enc_test", device="cpu", quant="")
    model.load_state_dict(state_dict_from_flax_params(params), strict=True)
    ours = ppipeline.run_inference_with_tile_encoder(paths, model, batch_size=4)
    return ours, ref


def test_run_inference_with_tile_encoder_matches_jax(tile_run):
    ours, ref = tile_run
    assert ours["tile_embeds"].shape == (6, 32) and ours["tile_embeds"].dtype == np.float32
    np.testing.assert_allclose(ours["tile_embeds"], ref["tile_embeds"], atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(ours["coords"], ref["coords"])


def test_two_stage_pipeline_matches_jax(tile_run):
    """Tile embeddings into the slide encoder (the tiny arch, fed the tile
    encoder's width): the JAX package's two-stage result, 1e-4 as the
    slide-encoder tests."""
    ours, ref = tile_run
    kw = dict(in_chans=32, dropout=0.0, drop_path_rate=0.0)
    jmodel, jparams = jslide.create_model("", "gigapath_slide_enc_tiny", **kw)
    ref_slide = jpipeline.run_inference_with_slide_encoder(ref["tile_embeds"], ref["coords"], jmodel, jparams)
    slide = pslide.create_model("", "gigapath_slide_enc_tiny", device="cpu", **kw)
    slide.load_state_dict(state_dict_from_flax_params(jparams), strict=True)
    got = ppipeline.run_inference_with_slide_encoder(ours["tile_embeds"], ours["coords"], slide)
    assert set(got) == set(ref_slide)
    for key, value in ref_slide.items():
        np.testing.assert_allclose(got[key], value, atol=1e-4, rtol=1e-4)
