"""The port's two-stage pretraining driver held against the JAX package on
the CPU.

The JAX modules' initial parameters are carried across
(``state_dict_from_flax_params``), the encoder's perturbed from a numpy
seed so every block matters; images come from a numpy seed, and the mask
noise is JAX's ``jax.random.uniform`` draw fed to the port.

Tolerances: the mask exactly equal; the MAE's loss and prediction (fp32
tiny encoder) 1e-5; one AdamW step's parameters 1e-4; the tied-norm
slide encoder's output 1e-5; the contrastive loss 1e-6 (the 0.1 sentinel
exact). The stages themselves run at ``tests/test_pipeline_drivers.py``'s
tiny sizes: finite losses, loadable best checkpoints, run-log events.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test process)
from PIL import Image

from gigapath_tpu.models.tile_encoder import VisionTransformer as JaxViT
from gigapath_tpu.pretrain import pretrain_gigapath as jpt
from gigapath_tpu_torch.models.tile_encoder import VisionTransformer
from gigapath_tpu_torch.pretrain import pretrain_gigapath as ppt
from gigapath_tpu_torch.utils.checkpoint import restore_checkpoint
from gigapath_tpu_torch.utils.convert import state_dict_from_flax_params

TINY = dict(img_size=32, patch_size=16, embed_dim=32, depth=1, num_heads=4, mlp_ratio=2.0)


@pytest.fixture(scope="module")
def jax_mae():
    """JAX's MAE and its init for the tiny fp32 encoder, the encoder
    perturbed."""
    mae = jpt.MaskedAutoencoder(encoder=JaxViT(**TINY))
    params = jax.jit(mae.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(np.asarray, params)
    params["encoder"] = jax.tree_util.tree_map(
        lambda p: p + 0.1 * rng.normal(size=p.shape).astype(np.float32), params["encoder"])
    return mae, params


def _port_mae(params):
    mae = ppt.MaskedAutoencoder(VisionTransformer(**TINY))
    mae.load_state_dict(state_dict_from_flax_params(params), strict=True)
    return mae


def _images(n=3, seed=2):
    return np.random.default_rng(seed).normal(size=(n, 32, 32, 3)).astype(np.float32)


def test_random_masking_matches_jax_noise_exactly():
    imgs = _images(4)
    rng = jax.random.PRNGKey(7)
    ref = np.asarray(jpt.random_masking(rng, jnp.asarray(imgs), 0.75))
    noise = torch.from_numpy(np.asarray(jax.random.uniform(rng, (4, 32 * 32))))
    ours = ppt.random_masking(None, torch.from_numpy(imgs), 0.75, noise=noise).numpy()
    np.testing.assert_array_equal(ours, ref)
    # drawn from a generator: a quarter of the positions kept, per image
    kept = ppt.random_masking(torch.Generator().manual_seed(0), torch.ones(2, 16, 16, 3), 0.75)
    assert kept[..., 0].sum(dim=(1, 2)).tolist() == [64.0, 64.0]


def test_mae_loss_and_prediction_match_jax(jax_mae):
    mae, params = jax_mae
    imgs = _images()
    rng = jax.random.PRNGKey(3)
    loss_ref, pred_ref = jax.jit(lambda p, x: mae.apply({"params": p}, x, rng))(params, jnp.asarray(imgs))
    noise = torch.from_numpy(np.asarray(jax.random.uniform(rng, (3, 32 * 32))))
    with torch.no_grad():
        loss, pred = _port_mae(params)(torch.from_numpy(imgs), noise=noise)
    assert pred.shape == (3, 32, 32, 3) and pred.dtype == torch.float32
    np.testing.assert_allclose(pred.numpy(), np.asarray(pred_ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(loss_ref), atol=1e-5, rtol=1e-5)
    # without noise nothing is masked, as JAX without an rng
    with torch.no_grad():
        unmasked, _ = _port_mae(params)(torch.from_numpy(imgs))
    ref = jax.jit(lambda p, x: mae.apply({"params": p}, x)[0])(params, jnp.asarray(imgs))
    np.testing.assert_allclose(float(unmasked), float(ref), atol=1e-5, rtol=1e-5)


def test_one_mae_adamw_step_matches_jax(jax_mae):
    """One update of the driver's step (the schedule's first lr, optax's
    adamw defaults) against JAX's: every parameter at 1e-4."""
    mae, params = jax_mae
    imgs = _images()
    rng = jax.random.PRNGKey(4)
    lr = 1e-3
    tx = optax.adamw(optax.cosine_decay_schedule(lr, 10))

    @jax.jit
    def jax_step(p):
        grads = jax.grad(lambda q: mae.apply({"params": q}, jnp.asarray(imgs), rng)[0])(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return optax.apply_updates(p, updates)

    want = state_dict_from_flax_params(jax_step(params))

    port = _port_mae(params)
    optimizer = ppt.make_adamw(port.parameters(), lr)
    noise = torch.from_numpy(np.asarray(jax.random.uniform(rng, (3, 32 * 32))))
    loss = ppt.mae_step(port, optimizer, torch.from_numpy(imgs), noise, lr)
    assert np.isfinite(float(loss))
    got = port.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), atol=1e-4, rtol=1e-4, err_msg=key)


def test_simple_slide_encoder_with_tied_norm_matches_jax():
    x = np.random.default_rng(5).normal(size=(3, 7, 16)).astype(np.float32)
    model = jpt.SimpleSlideEncoder(in_dim=16, hidden_dim=8, out_dim=4)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    params["norm"]["scale"] = params["norm"]["scale"] + np.linspace(-0.5, 0.5, 8, dtype=np.float32)
    params["norm"]["bias"] = params["norm"]["bias"] + 0.1
    ref = np.asarray(jax.jit(lambda p, v: model.apply({"params": p}, v))(params, jnp.asarray(x)))
    port = ppt.SimpleSlideEncoder(in_dim=16, hidden_dim=8, out_dim=4)
    port.load_state_dict(state_dict_from_flax_params(params), strict=True)
    assert sorted(k for k in port.state_dict() if k.startswith("norm")) == ["norm.bias", "norm.weight"]
    with torch.no_grad():
        ours = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)


def test_contrastive_loss_matches_jax():
    f = np.random.default_rng(6).normal(size=(4, 8)).astype(np.float32)
    for feats in (f, np.eye(4, 8, dtype=np.float32), np.ones((4, 8), np.float32)):
        ref = float(jpt.contrastive_loss(jnp.asarray(feats)))
        np.testing.assert_allclose(float(ppt.contrastive_loss(torch.from_numpy(feats))), ref, atol=1e-6, rtol=1e-6)
    one = torch.from_numpy(f[:1]).requires_grad_()
    sentinel = ppt.contrastive_loss(one)
    assert float(sentinel) == float(jpt.contrastive_loss(jnp.asarray(f[:1]))) == float(np.float32(0.1))
    sentinel.backward()  # a zero gradient, as JAX's grad of the constant
    assert torch.equal(one.grad, torch.zeros_like(one))


def _events(out_dir):
    (path,) = [p for p in glob.glob(os.path.join(out_dir, "obs", "*.jsonl"))
               if not os.path.basename(p).startswith("flight-")]
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def _tiles(directory, n, rng):
    os.makedirs(directory, exist_ok=True)
    paths = []
    for i in range(n):
        p = os.path.join(directory, f"{i:05d}x_00000y.png")
        Image.fromarray(rng.integers(0, 255, (32, 32, 3)).astype(np.uint8)).save(p)
        paths.append(p)
    return paths


def test_tile_and_slide_stages_at_tiny_sizes(tmp_path):
    rng = np.random.default_rng(0)
    paths = _tiles(str(tmp_path / "tiles"), 8, rng)
    encoder = VisionTransformer(**TINY)
    encoder.init_weights(torch.Generator().manual_seed(0))
    out = str(tmp_path / "tile")
    best = ppt.pretrain_tile_encoder(paths, out, encoder=encoder, batch_size=4, num_epochs=3,
                                     learning_rate=1e-3, checkpoint_every=2, device="cpu")
    state = restore_checkpoint(best)
    assert np.isfinite(state["loss"]) and state["epoch"] in (0, 1, 2)
    assert {k.split(".")[0] for k in state["params"]} == {"encoder", "dec1", "dec2", "dec3"}
    assert os.path.exists(os.path.join(out, "tile_encoder_epoch_2.pt"))
    events = _events(out)
    steps = [e for e in events if e["kind"] == "step"]
    assert len(steps) == 6 and all(np.isfinite(e["loss"]) for e in steps)
    assert [e["status"] for e in events if e["kind"] == "run_end"] == ["ok"]

    slide_dirs = [os.path.dirname(p) for p in (_tiles(str(tmp_path / f"s{s}"), 4, rng)[0] for s in range(3))]
    out2 = str(tmp_path / "slide")
    best2 = ppt.pretrain_slide_encoder(encoder, slide_dirs, out2, num_epochs=3, device="cpu")
    state2 = restore_checkpoint(best2)
    assert np.isfinite(state2["loss"])
    assert sorted(state2["params"]) == sorted(f"{m}.{p}" for m in ("fc1", "fc2", "fc3", "norm")
                                              for p in ("weight", "bias"))
    steps2 = [e for e in _events(out2) if e["kind"] == "step"]
    assert len(steps2) == 3 and all(np.isfinite(e["loss"]) for e in steps2)


def _slide_png(path, seed):
    rng = np.random.default_rng(seed)
    arr = np.full((256, 256, 3), 245, np.uint8)
    arr[64:192, 64:192] = rng.integers(30, 120, (128, 128, 3))
    Image.fromarray(arr).save(path)
    return path


def test_main_restores_the_best_tile_checkpoint_into_the_encoder(tmp_path):
    slides = [_slide_png(str(tmp_path / f"slide{i}.png"), i) for i in range(2)]
    encoder = VisionTransformer(**TINY)
    encoder.init_weights(torch.Generator().manual_seed(0))
    out = str(tmp_path / "run")
    best_tile, best_slide = ppt.main(slides, out, encoder=encoder, tile_size=64, tile_epochs=2,
                                     slide_epochs=2, batch_size=4, device="cpu")
    best = restore_checkpoint(best_tile)["params"]
    for key, value in encoder.state_dict().items():
        assert torch.equal(value, best["encoder." + key]), key
    assert np.isfinite(restore_checkpoint(best_slide)["loss"])
    assert len(glob.glob(os.path.join(out, "output", "slide0.png", "*.png"))) > 0
