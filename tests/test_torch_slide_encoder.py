"""The port's slide encoder held against the JAX package on the CPU.

Weights are made once by the JAX model's init and handed to the port through
``state_dict_from_flax_params`` (strict load); inputs come from a numpy seed.
fp32 tolerance 1e-4: sums run in another order, and flax's LayerNorm takes
the variance as E[x^2] - E[x]^2.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test process)

from gigapath_tpu.models.slide_encoder import LongNetViT as JaxLongNetViT
from gigapath_tpu.ops import pos_embed as jax_pe
from gigapath_tpu_torch.models import slide_encoder as port_se
from gigapath_tpu_torch.ops import pos_embed as port_pe
from gigapath_tpu_torch.pipeline import run_inference_with_slide_encoder
from gigapath_tpu_torch.utils.convert import state_dict_from_flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# depth 2, E=64, H=16 (the synthesized LongNet_2_layers_64_dim), a 5-branch
# schedule scaled down from the flagship's; segments with S > 1 divide by
# their ratio, as the flagship's do
SMALL = dict(
    in_chans=32, embed_dim=64, depth=2, slide_ngrids=40,
    segment_length=[32, 64, 128, 256, 512], dilated_ratio="[1, 2, 4, 8, 16]",
    dropout=0.0, drop_path_rate=0.0,
)
N_TILES = 200


@pytest.fixture(scope="module")
def weights():
    model = JaxLongNetViT(**SMALL)
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 32)), jnp.zeros((1, 4, 2))
    )["params"]
    # give the LayerNorms and biases non-trivial values so they are tested
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32), params
    )
    return params


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, N_TILES, 32)).astype(np.float32)
    coords = rng.integers(0, 40 * 256, size=(2, N_TILES, 2)).astype(np.float32)
    pad_mask = np.ones((2, N_TILES), bool)
    pad_mask[1, 137:] = False  # ragged batch: row 1 has 137 valid tiles
    return x, coords, pad_mask


def _port(weights, **kw):
    model = port_se.LongNetViT(**{**SMALL, **kw}).eval()
    model.load_state_dict(state_dict_from_flax_params(weights), strict=True)
    return model


@pytest.mark.parametrize(
    "global_pool,ragged", [(False, False), (True, False), (False, True), (True, True)]
)
def test_slide_forward_matches_jax(weights, inputs, global_pool, ragged):
    x, coords, pad_mask = inputs
    mask = pad_mask if ragged else None
    jmodel = JaxLongNetViT(**SMALL, global_pool=global_pool)
    fn = jax.jit(lambda p, a, c, m: jmodel.apply(
        {"params": p}, a, c, all_layer_embed=True, pad_mask=m))
    ref = fn(weights, jnp.asarray(x), jnp.asarray(coords), None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        ours = _port(weights, global_pool=global_pool)(
            torch.from_numpy(x), torch.from_numpy(coords), all_layer_embed=True,
            pad_mask=None if mask is None else torch.from_numpy(mask),
        )
    assert len(ours) == len(ref) == SMALL["depth"] + 1
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-4, rtol=1e-4)


def test_pipeline_entry_matches_last_layer_and_ragged_rows_match_alone(weights, inputs):
    """The entry's dict equals the model's outputs, and each row of a
    ragged batch equals that slide run alone."""
    x, coords, pad_mask = inputs
    model = _port(weights)
    batch = run_inference_with_slide_encoder(x, coords, model, pad_mask=pad_mask)
    assert set(batch) == {"layer_0_embed", "layer_1_embed", "layer_2_embed", "last_layer_embed"}
    np.testing.assert_array_equal(batch["last_layer_embed"], batch["layer_2_embed"])
    for row, n in enumerate(pad_mask.sum(axis=1)):
        alone = run_inference_with_slide_encoder(x[row, :n], coords[row, :n], model)
        for key, val in alone.items():
            np.testing.assert_allclose(batch[key][row], val[0], atol=1e-4, rtol=1e-4)


def test_pos_embed_matches_jax_and_table():
    rng = np.random.default_rng(3)
    coords = rng.integers(-3 * 256, 50 * 256, size=(4, 64, 2)).astype(np.float32)
    # c = (-40, -2): flat row -40*40 - 2 + 1 = -1601 wraps to the cls row 0
    coords[0, 0] = [-40 * 256.0, -2 * 256.0]
    ours = port_pe.pos_embed_for_coords(64, torch.from_numpy(coords), 256, 40).numpy()
    ref = np.asarray(jax_pe.pos_embed_for_coords(64, jnp.asarray(coords), 256, 40))
    np.testing.assert_allclose(ours, ref, atol=2e-5, rtol=1e-5)
    assert not ours[0, 0].any()
    # against the reference table the positions index, inside the grid
    table = port_pe.get_2d_sincos_pos_embed(64, 40, cls_token=True)
    inside = rng.integers(0, 40 * 256, size=(64, 2)).astype(np.float32)
    pos = port_pe.coords_to_pos(torch.from_numpy(inside), 256, 40).numpy()
    np.testing.assert_allclose(
        port_pe.pos_embed_for_coords(64, torch.from_numpy(inside), 256, 40).numpy(),
        table[pos], atol=2e-5,
    )


def _reference_keys(depth):
    keys = {"cls_token", "patch_embed.proj.weight", "patch_embed.proj.bias",
            "norm.weight", "norm.bias", "encoder.layer_norm.weight", "encoder.layer_norm.bias"}
    for i in range(depth):
        p = f"encoder.layers.{i}."
        for proj in ["q_proj", "k_proj", "v_proj", "out_proj", "inner_attn_ln"]:
            keys |= {f"{p}self_attn.{proj}.weight", f"{p}self_attn.{proj}.bias"}
        for ln in ["self_attn_layer_norm", "final_layer_norm"]:
            keys |= {f"{p}{ln}.weight", f"{p}{ln}.bias"}
        for name in ["fc1", "fc2", "ffn_layernorm"]:
            keys |= {f"{p}ffn.{name}.weight", f"{p}ffn.{name}.bias"}
    return keys


def test_flagship_state_dict_keys_are_the_reference_names():
    with torch.device("meta"):
        model = port_se.gigapath_slide_enc12l768d(in_chans=1536)
    state = model.state_dict()
    assert set(state) == _reference_keys(12)
    assert tuple(state["encoder.layers.0.ffn.fc1.weight"].shape) == (3072, 768)
    assert tuple(state["patch_embed.proj.weight"].shape) == (768, 1536)


def test_create_model_loads_reference_checkpoint(tmp_path, weights):
    """A reference-shaped .pth (with the skipped pos_embed buffer and one
    stray key) loads non-strictly into create_model's module."""
    state = state_dict_from_flax_params(weights)
    state["pos_embed"] = torch.zeros(1, 40 * 40 + 1, 64)
    state["head.weight"] = torch.zeros(3, 64)
    path = tmp_path / "slide_encoder.pth"
    torch.save(state, path)
    kw = {k: v for k, v in SMALL.items() if k != "in_chans"}
    model = port_se.create_model(str(path), "gigapath_slide_enc12l768d", in_chans=32, device="cpu", **kw)
    loaded = model.state_dict()
    for key, val in state_dict_from_flax_params(weights).items():
        torch.testing.assert_close(loaded[key], val, rtol=0, atol=0)
    assert not model.training


def test_create_model_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_se.create_model("", "gigapath_slide_enc_tiny", in_chans=8)


def test_port_imports_nothing_of_jax():
    """Importing every port module (the fine-tuning, tile, streaming,
    head-major, serving, obs, tiling, whole-slide training, linear-probe,
    parity, pretraining, tensor-parallel, MoE and dry-run paths' included, and
    the torchscale family's decoder, encoder-decoder, RetNet and BEiT-3) leaves
    jax, flax, optax, sklearn and gigapath_tpu (the exact name, or the
    gigapath_tpu. prefix) out of sys.modules, and pandas, yaml and h5py too:
    the port imports those only inside the functions that read files."""
    code = (
        "import pkgutil, sys, importlib, gigapath_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'gigapath_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "banned = ('jax', 'jaxlib', 'flax', 'optax', 'sklearn', 'pandas', 'yaml', 'h5py')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in banned"
        " or m == 'gigapath_tpu' or m.startswith('gigapath_tpu.'))\n"
        "need = {'gigapath_tpu_torch.finetune.' + m for m in ('main', 'training', 'utils', 'metrics', 'params')}\n"
        "need |= {'gigapath_tpu_torch.data.' + m for m in ('collate', 'loader', 'splits', 'slide_dataset')}\n"
        "need |= {'gigapath_tpu_torch.models.classification_head', 'gigapath_tpu_torch.utils.checkpoint',"
        " 'gigapath_tpu_torch.finetune.task_configs.utils'}\n"
        "need |= {'gigapath_tpu_torch.quant.' + m for m in ('qtensor', 'qmatmul', 'qflash', 'convert')}\n"
        "need |= {'gigapath_tpu_torch.models.tile_encoder', 'gigapath_tpu_torch.data.transforms',"
        " 'gigapath_tpu_torch.data.tile_dataset', 'gigapath_tpu_torch.pipeline'}\n"
        "need |= {'gigapath_tpu_torch.ops.streaming_kernels', 'gigapath_tpu_torch.ops.streaming_prefill',"
        " 'gigapath_tpu_torch.models.streaming_encoder', 'gigapath_tpu_torch.serve.streaming',"
        " 'gigapath_tpu_torch.obs.drift', 'gigapath_tpu_torch.obs.runlog',"
        " 'gigapath_tpu_torch.finetune.predict', 'gigapath_tpu_torch.inference'}\n"
        "need |= {'gigapath_tpu_torch.ops.' + m for m in ('flash_kernels', 'flash_attention', 'norms')}\n"
        "need |= {'gigapath_tpu_torch.obs.' + m for m in ('locktrace', 'runlog', 'flight', 'anomaly', 'spans',"
        " 'metrics', 'reqtrace', 'heartbeat', 'watchdog', 'ledger')}\n"
        "need |= {'gigapath_tpu_torch.obs', 'gigapath_tpu_torch.resilience', 'gigapath_tpu_torch.resilience.chaos'}\n"
        "need |= {'gigapath_tpu_torch.serve.' + m for m in ('buckets', 'queue', 'cache', 'health', 'aot', 'service')}\n"
        "need |= {'gigapath_tpu_torch.obs.' + m for m in ('clock', 'fleet', 'history')}\n"
        "need |= {'gigapath_tpu_torch.dist.' + m for m in ('boundary', 'membership', 'transport', 'stagemesh',"
        " 'worker', 'pipeline')}\n"
        "need |= {'gigapath_tpu_torch.dist', 'gigapath_tpu_torch.resilience.checkpoint'}\n"
        "need |= {'gigapath_tpu_torch.obs.telemetry', 'gigapath_tpu_torch.obs.numerics',"
        " 'gigapath_tpu_torch.resilience.guard', 'gigapath_tpu_torch.native', 'gigapath_tpu_torch.train_gigapath'}\n"
        "need |= {'gigapath_tpu_torch.data.' + m for m in ('box_utils', 'tiling', 'slide_utils')}\n"
        "need |= {'gigapath_tpu_torch.preprocessing', 'gigapath_tpu_torch.preprocessing.foreground_segmentation',"
        " 'gigapath_tpu_torch.preprocessing.create_tiles_dataset'}\n"
        "need |= {'gigapath_tpu_torch.data.pcam', 'gigapath_tpu_torch.linear_probe', 'gigapath_tpu_torch.linear_probe.main',"
        " 'gigapath_tpu_torch.quant.parity', 'gigapath_tpu_torch.pretrain', 'gigapath_tpu_torch.pretrain.pretrain_gigapath'}\n"
        "need |= {'gigapath_tpu_torch.parallel'} | {'gigapath_tpu_torch.parallel.' + m for m in ('mesh', 'sharding', 'spmd')}\n"
        "need |= {'gigapath_tpu_torch.parallel.tensor', 'gigapath_tpu_torch.ops.moe', 'gigapath_tpu_torch.dryrun',"
        " 'gigapath_tpu_torch.utils.profiling', 'gigapath_tpu_torch.utils.timing'} | {'gigapath_tpu_torch.ops.moe.' + m for m in ('routing',"
        " 'moe_layer', 'expert_parallel')}\n"
        "need |= {'gigapath_tpu_torch.ops.' + m for m in ('xpos', 'relative_position_bias', 'multiway', 'embedding',"
        " 'multiscale_retention')} | {'gigapath_tpu_torch.models.beit3', 'gigapath_tpu_torch.models.longnet'}\n"
        "need |= {'gigapath_tpu_torch.architecture.' + m for m in ('config', 'encoder', 'decoder', 'encoder_decoder',"
        " 'init', 'retnet')}\n"
        "assert need <= set(names), sorted(need - set(names))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
