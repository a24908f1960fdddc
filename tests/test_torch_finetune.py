"""The port's fine-tuning path held against the JAX package on the CPU.

Loss and gradients of the classification head, the layer-decay optimizer
with gradient accumulation, the metrics and the LR schedule against their
JAX counterparts on the same numpy-seeded inputs; drop-path statistics,
activation checkpointing, checkpoints and splits on their own; and the
port's fine-tuning CLI end to end on a tiny h5 fixture.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test process)

from gigapath_tpu.finetune import metrics as jax_metrics
from gigapath_tpu.finetune import utils as jax_ft
from gigapath_tpu.models.classification_head import ClassificationHead as JaxHead
from gigapath_tpu_torch.data.splits import train_test_split
from gigapath_tpu_torch.finetune import metrics as port_metrics
from gigapath_tpu_torch.finetune import utils as port_ft
from gigapath_tpu_torch.models.classification_head import ClassificationHead, get_model
from gigapath_tpu_torch.ops.droppath import DropPath
from gigapath_tpu_torch.utils.checkpoint import MonitorScore, restore_checkpoint, save_checkpoint
from gigapath_tpu_torch.utils.convert import state_dict_from_flax_params

# the 2-layer, E=64 slide encoder of test_torch_slide_encoder.py
SLIDE_KW = dict(
    embed_dim=64, depth=2, slide_ngrids=40,
    segment_length=[32, 64, 128, 256, 512], dilated_ratio="[1, 2, 4, 8, 16]",
    dropout=0.0, drop_path_rate=0.0,
)
HEAD_KW = dict(input_dim=32, latent_dim=64, n_classes=3, model_arch="gigapath_slide_enc12l768d")
N_TILES = 200


def _jax_head_params(head, seed=0, noise=0.05):
    params = jax.jit(head.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 4, HEAD_KW["input_dim"])), jnp.zeros((1, 4, 2))
    )["params"]
    rng = np.random.default_rng(seed + 1)  # non-trivial norms and biases
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + noise * rng.normal(size=p.shape).astype(np.float32), params
    )


def test_classification_head_loss_and_grads_match_jax():
    """Loss and every parameter gradient, ragged pad mask, feat_layer 0-2;
    the JAX head's weights load strictly into the port's."""
    feat_layer = "0-2"
    jhead = JaxHead(**HEAD_KW, feat_layer=feat_layer, slide_kwargs=SLIDE_KW)
    params = _jax_head_params(jhead)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, N_TILES, 32)).astype(np.float32)
    coords = rng.integers(0, 40 * 256, size=(2, N_TILES, 2)).astype(np.float32)
    pad_mask = np.ones((2, N_TILES), bool)
    pad_mask[1, 137:] = False
    labels = np.array([2, 0], np.int64)

    def jax_loss(p):
        logits = jhead.apply({"params": p}, x, coords, pad_mask=pad_mask, deterministic=True)
        return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()

    jloss, jgrads = jax.jit(jax.value_and_grad(jax_loss))(params)

    model = ClassificationHead(**HEAD_KW, feat_layer=feat_layer, **SLIDE_KW).train()
    model.load_state_dict(state_dict_from_flax_params(params), strict=True)
    assert all(k.split(".")[0] in ("slide_encoder", "classifier") for k in model.state_dict())
    loss_fn = port_ft.get_loss_function({"setting": "multi_class"})
    loss = loss_fn(model(torch.from_numpy(x), torch.from_numpy(coords), torch.from_numpy(pad_mask)),
                   torch.from_numpy(labels))
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-4 * abs(float(jloss))
    ref = state_dict_from_flax_params(jax.device_get(jgrads))
    # a parameter the loss does not reach (the encoder's final norm, with
    # every layer's embedding taken before it) has no .grad: its gradient is 0
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(ref)
    # rel 1e-4 of each gradient's own scale (the readings are ~1e-6), with a
    # floor of 1e-2 of the largest gradient: k_proj.bias has an exactly zero
    # gradient (each row's softmax ignores a shift common to its keys), so
    # both sides hold rounding noise of ~1e-8 there
    floor = 1e-2 * max(float(r.abs().max()) for r in ref.values())
    for name, g in grads.items():
        scale = max(float(ref[name].abs().max()), floor)
        assert float((g - ref[name]).abs().max()) <= 1e-4 * scale, name


@pytest.mark.parametrize("freeze", [False, True], ids=["trainable", "frozen_encoder"])
def test_optimizer_matches_jax_over_six_steps(freeze):
    """Layer-decay AdamW, warmup then cosine, gc = 2: six optimizer steps
    (twelve micro-steps) of identical gradients leave the parameters equal
    to 1e-6 after every step; a frozen encoder never moves."""
    slide_kw = dict(SLIDE_KW, segment_length=[16, 32], dilated_ratio="[1, 2]", embed_dim=32)
    head_kw = dict(HEAD_KW, latent_dim=32, feat_layer="1")
    jhead = JaxHead(**head_kw, slide_kwargs=slide_kw)
    params = _jax_head_params(jhead, seed=3)
    num_layers = slide_kw["depth"] + 1
    hp = dict(lr=1e-2, min_lr=1e-4, warmup_epochs=1, epochs=3, steps_per_epoch=3)
    tx = jax_ft.build_optimizer(
        params, **hp, weight_decay=0.05, layer_decay=0.95, num_layers=num_layers, gc=2,
        freeze_subtree="slide_encoder" if freeze else None,
    )
    opt_state = tx.init(params)
    update = jax.jit(tx.update)

    model = ClassificationHead(**head_kw, **slide_kw)
    model.load_state_dict(state_dict_from_flax_params(params), strict=True)
    optimizer = port_ft.build_optimizer(
        model, lr=hp["lr"], weight_decay=0.05, layer_decay=0.95, num_layers=num_layers,
        freeze_prefix="slide_encoder" if freeze else None,
    )
    scheduler = port_ft.make_lr_scheduler(optimizer, **hp)
    steps = port_ft.MultiSteps(optimizer, scheduler, gc=2)
    start = {k: v.clone() for k, v in model.state_dict().items()}

    rng = np.random.default_rng(4)
    n_steps = 0
    # a parameter the loss never reaches: zeros on the JAX side, no .grad on
    # the port's (it must still decay as under optax)
    unreached = "slide_encoder.encoder.layers.1.ffn.fc2.weight"
    for _ in range(12):
        grads = jax.tree_util.tree_map(lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        grads["slide_encoder"]["encoder"]["layers_1"]["ffn"]["fc2"]["kernel"] *= 0.0
        updates, opt_state = update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: np.asarray(p + u), params, updates)
        for name, g in state_dict_from_flax_params(grads).items():
            if name == unreached:
                continue
            p = model.get_parameter(name)
            p.grad = g.clone() if p.grad is None else p.grad + g
        if steps.step():
            n_steps += 1
            ref = state_dict_from_flax_params(params)
            for name, value in model.state_dict().items():
                np.testing.assert_allclose(value.numpy(), ref[name].numpy(), atol=1e-6, rtol=0,
                                           err_msg=f"step {n_steps}: {name}")
    assert n_steps == 6
    for name, value in model.state_dict().items():
        moved = not torch.equal(value, start[name])
        assert moved != (freeze and name.startswith("slide_encoder.")), name


def test_lr_schedule_and_layer_ids_match_jax():
    jsched = jax_ft.make_lr_schedule(1e-3, 1e-6, 1.5, 4, 7.0)
    psched = port_ft.make_lr_schedule(1e-3, 1e-6, 1.5, 4, 7.0)
    for step in range(40):
        assert abs(psched(step) - float(jsched(step))) <= 1e-6 * 1e-3
    L = 3
    assert port_ft.get_layer_id("slide_encoder.patch_embed.proj.weight", L) == 0
    assert port_ft.get_layer_id("slide_encoder.cls_token", L) == 0
    assert port_ft.get_layer_id("slide_encoder.encoder.layers.1.ffn.fc1.weight", L) == 2
    assert port_ft.get_layer_id("slide_encoder.norm.weight", L) == 3
    assert port_ft.get_layer_id("classifier.weight", L) == 3
    model = ClassificationHead(**dict(HEAD_KW, latent_dim=32), feat_layer="1",
                               **dict(SLIDE_KW, segment_length=[16, 32], dilated_ratio="[1, 2]", embed_dim=32))
    labels, groups = port_ft.param_labels_lrd(model.named_parameters(), L)
    assert labels["slide_encoder.cls_token"] == "layer0_decay"  # ndim != 1 decays
    assert labels["slide_encoder.patch_embed.proj.bias"] == "layer0_no_decay"
    assert labels["slide_encoder.encoder.layers.0.ffn.fc1.weight"] == "layer1_decay"
    assert labels["classifier.weight"] == "layer3_decay" and groups["layer3_decay"] == (3, True)


def _tied_probs(rng, n, c, normalise):
    p = np.round(rng.uniform(size=(n, c)), 1) + 1e-3 * rng.integers(0, 2, size=(n, c))
    return (p / p.sum(axis=1, keepdims=True) if normalise else p).astype(np.float32)


@pytest.mark.parametrize("setting", ["multi_class", "multi_label", "multi_class_missing_class"])
def test_metrics_match_jax(setting):
    """Every metric of the task dispatch, on probabilities with ties; a
    class absent from the labels gives nan per-class AUROC on both sides."""
    rng = np.random.default_rng(5)
    n = 60
    if setting == "multi_label":
        cfg = {"setting": "multi_label", "label_dict": {g: i for i, g in enumerate("ABCDE")}}
        probs = _tied_probs(rng, n, 5, normalise=False)
        labels = (rng.uniform(size=(n, 5)) < 0.4).astype(np.float32)
    else:
        cfg = {"setting": "multi_class", "label_dict": {i: i for i in range(6)}, "add_metrics": ["qwk"]}
        probs = _tied_probs(rng, n, 6, normalise=True)
        cls = rng.integers(0, 5 if setting.endswith("missing_class") else 6, size=n)
        labels = np.eye(6, dtype=np.float32)[cls]
    ours = port_metrics.calculate_metrics_with_task_cfg(probs, labels, cfg)
    ref = jax_metrics.calculate_metrics_with_task_cfg(probs, labels, cfg)
    assert set(ours) == set(ref)
    for key in ref:
        np.testing.assert_allclose(ours[key], ref[key], atol=1e-6, rtol=0, err_msg=key)
    if setting.endswith("missing_class"):
        assert np.isnan(ours["5_auroc"]) and ours["5_auprc"] == 0.0


def test_droppath_keep_rate_scaling_and_eval_identity():
    x = torch.ones(4000, 3, 5)
    dp = DropPath(0.25).train()
    y = dp(x, generator=torch.Generator().manual_seed(0))
    kept = y[:, 0, 0] != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.03  # binomial sd 0.007
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.75))  # whole rows, scaled by 1/keep
    assert not y[~kept].any()
    y2 = dp(x, generator=torch.Generator().manual_seed(0))
    assert torch.equal(y, y2)  # the caller's generator decides the mask
    assert dp.eval()(x) is x and DropPath(0.0).train()(x) is x


def test_checkpoint_activations_give_the_same_gradients():
    """Re-running each layer in the backward, dropout and drop-path on:
    the RNG state is restored for the re-run, so the gradients are equal."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(1, 90, 32)).astype(np.float32))
    coords = torch.from_numpy(rng.integers(0, 40 * 256, size=(1, 90, 2)).astype(np.float32))
    grads = []
    for remat in (False, True):
        model = get_model(**HEAD_KW, feat_layer="2", device="cpu", seed=0, checkpoint_activations=remat,
                          **dict(SLIDE_KW, dropout=0.1, drop_path_rate=0.2))
        assert model.training
        torch.manual_seed(7)
        model(x, coords).square().sum().backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None})
    assert set(grads[1]) == set(grads[0])
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, atol=1e-6, rtol=1e-6, msg=name)


def test_checkpoint_round_trip_and_monitor(tmp_path):
    path = str(tmp_path / "fold_0" / "checkpoint.pt")
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)}}
    save_checkpoint(path, state)
    assert torch.equal(restore_checkpoint(path)["params"]["w"], state["params"]["w"])
    monitor = MonitorScore()
    assert monitor(0.7, state, path) and not monitor(0.6, state, path) and monitor(0.8, state, path)
    assert restore_checkpoint(path)["best_score"] == 0.8
    assert MonitorScore.from_checkpoint(path).best_score == 0.8  # from the sidecar
    os.remove(path + ".best.json")
    assert MonitorScore.from_checkpoint(path).best_score == 0.8  # from the checkpoint
    assert MonitorScore.from_checkpoint(str(tmp_path / "none.pt")).best_score is None


@pytest.mark.parametrize("n,test_size,seed", [(8, 0.35, 0), (8, 0.25 / 0.35 * 0.35, 1), (37, 0.3, 4), (10, 0.2 / 0.3, 3)])
def test_train_test_split_is_sklearns(n, test_size, seed):
    from sklearn.model_selection import train_test_split as sk_split

    samples = [f"s{i}" for i in range(n)]
    assert train_test_split(samples, test_size, seed) == tuple(
        list(x) for x in sk_split(samples, test_size=test_size, random_state=seed)
    )


def test_finetune_main_end_to_end(tmp_path):
    """Two folds of the port's CLI on the tiny arch and the h5 fixture of
    tests/test_finetune_harness.py -> summary.csv with finite losses."""
    import h5py
    import pandas as pd

    from gigapath_tpu_torch.finetune.main import main

    rng = np.random.default_rng(0)
    root = tmp_path / "h5_files"
    root.mkdir()
    rows = []
    for i in range(8):
        n_tiles = 12 + i
        with h5py.File(root / f"s{i}.h5", "w") as f:
            f.create_dataset("features", data=rng.normal(size=(n_tiles, 16)).astype(np.float32))
            f.create_dataset("coords", data=rng.integers(0, 2000, (n_tiles, 2)).astype(np.float32))
        rows.append({"slide_id": f"s{i}.svs", "pat_id": f"p{i}", "label": ["neg", "pos"][i % 2]})
    csv_path = tmp_path / "dataset.csv"
    pd.DataFrame(rows).to_csv(csv_path, index=False)
    yaml_path = tmp_path / "task.yaml"
    yaml_path.write_text(
        "name: toy\nsetting: multi_class\n"
        "label_dict:\n  neg: 0\n  pos: 1\nmax_tiles: 64\nshuffle_tiles: false\n"
    )
    save_dir = tmp_path / "out"
    results = main([
        "--task_cfg_path", str(yaml_path), "--dataset_csv", str(csv_path), "--root_path", str(root),
        "--split_dir", str(tmp_path / "splits"), "--save_dir", str(save_dir),
        "--model_arch", "gigapath_slide_enc_tiny", "--input_dim", "16", "--latent_dim", "32",
        "--feat_layer", "1", "--folds", "2", "--epochs", "2", "--warmup_epochs", "1", "--gc", "2",
        "--val_r", "0.25", "--model_select", "val", "--report_to", "jsonl",
        "--dropout", "0.0", "--drop_path_rate", "0.0", "--device", "cpu",
    ])
    assert "test_macro_auroc" in results and len(results["test_macro_auroc"]) == 2
    summary = pd.read_csv(save_dir / "toy" / "eval_toy" / "summary.csv")
    assert "val_macro_auroc" in summary.columns
    assert np.isfinite(summary["test_loss"]).all() and np.isfinite(summary["val_loss"]).all()
    assert (save_dir / "toy" / "eval_toy" / "fold_1" / "checkpoint.pt").is_file()
    # each fold's run log, as the JAX loop writes it: the manifest, steps,
    # a compile event per new (batch, tiles) bucket, evals, spans, run_end
    import glob
    import json

    (log_path,) = glob.glob(str(save_dir / "toy" / "eval_toy" / "fold_1" / "obs" / "*.jsonl"))
    events = [json.loads(line) for line in open(log_path)]
    kinds = {e["kind"] for e in events}
    assert {"run_start", "step", "compile", "eval", "span", "run_end"} <= kinds, kinds
    assert {e["name"] for e in events if e["kind"] == "span"} >= {"epoch", "eval", "test"}
    assert all(e["fn"] == "train_step" and not e.get("unexpected") for e in events if e["kind"] == "compile")
    (end,) = [e for e in events if e["kind"] == "run_end"]
    assert end["status"] == "ok" and end["fold"] == 1 and end["stalls"] == 0


def _flax_tree_with_nan(params, seed):
    """Random gradients of the head's parameter tree (the classifier's
    bias poisoned with a NaN, one kernel in bf16)."""
    rng = np.random.default_rng(seed)
    grads = jax.tree_util.tree_map(lambda p: rng.normal(size=p.shape).astype(np.float32) * 1e-2, params)
    grads["classifier"]["bias"][1] = np.nan
    grads["slide_encoder"]["patch_embed"]["proj"]["kernel"] = jnp.asarray(
        grads["slide_encoder"]["patch_embed"]["proj"]["kernel"], jnp.bfloat16)
    return grads


def test_step_scalars_and_numerics_match_jax():
    """tree_norm / step_scalars / numerics_scalars on the same gradients and
    parameters (one top-level group per child of the head, a NaN carried by
    absmax, a bf16 leaf accumulated in fp32), and the numerics events."""
    from gigapath_tpu.obs import numerics as jnum
    from gigapath_tpu.obs import telemetry as jtel
    from gigapath_tpu_torch.obs import numerics as pnum
    from gigapath_tpu_torch.obs import telemetry as ptel

    jhead = JaxHead(**HEAD_KW, feat_layer="1", slide_kwargs=dict(SLIDE_KW, depth=1))
    params = _jax_head_params(jhead)
    grads = _flax_tree_with_nan(params, 5)
    pgrads = {k: v.clone() for k, v in state_dict_from_flax_params(
        jax.tree_util.tree_map(lambda g: np.asarray(g, np.float32), grads)).items()}
    name = "slide_encoder.patch_embed.proj.weight"
    pgrads[name] = pgrads[name].bfloat16()
    pparams = state_dict_from_flax_params(params)
    clean = {k: v for k, v in pgrads.items() if k != "classifier.bias"}
    jclean = dict(grads, classifier={"kernel": grads["classifier"]["kernel"]})

    ours = ptel.step_scalars(loss=torch.tensor(1.25), grads=clean, params=pparams)
    ref = jax.jit(lambda g, p: jtel.step_scalars(loss=jnp.float32(1.25), grads=g, params=p))(jclean, params)
    assert set(ours) == set(ref) == {"loss", "grad_norm", "param_norm"}
    for key in ours:
        assert float(ours[key]) == pytest.approx(float(ref[key]), rel=1e-5), key
    assert np.isnan(float(ptel.tree_norm(pgrads))) and np.isnan(float(jax.jit(jtel.tree_norm)(grads)))

    ours = pnum.numerics_scalars(grads=pgrads, params=pparams)
    ref = jax.jit(lambda g, p: jnum.numerics_scalars(grads=g, params=p))(grads, params)
    assert set(ours) == set(ref)
    assert {k.split(".")[2] for k in ours} == {"slide_encoder", "classifier"}
    for key in ours:
        assert float(ours[key]) == pytest.approx(float(ref[key]), rel=1e-5, nan_ok=True), key
    assert np.isnan(float(ours["num.grad.classifier.absmax"]))

    class Recorder:
        def event(self, kind, **fields):
            return {"kind": kind, **fields}

    synced = {k: float(v) for k, v in ref.items()}
    assert pnum.split_numerics({"loss": 1.0, **synced}) == jnum.split_numerics({"loss": 1.0, **synced})
    got = pnum.NumericsMonitor(Recorder(), name="finetune").emit(7, synced)
    want = jnum.NumericsMonitor(Recorder(), name="finetune").emit(7, synced)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert pnum.numerics_enabled() is False


class _EventRecorder:
    """A run log that keeps its step and numerics events."""

    path = None

    def __init__(self):
        self.steps, self.numerics = [], []

    def step(self, step, **fields):
        self.steps.append({"step": step, **fields})

    def event(self, kind, **fields):
        if kind == "numerics":
            self.numerics.append(fields)

    def echo(self, msg, **kw):
        pass


def test_finetune_events_carry_jax_scalars():
    """Twenty fp32 micro-steps (gc 1) through the JAX loop's train_one_epoch
    with its train_step's in-graph scalars and numerics, and through the
    port's: the synced step event's grad_norm and param_norm within 1e-4 of
    JAX's, the numerics event's layers and values as JAX's
    (GIGAPATH_NUMERICS on); none with it off."""
    from types import SimpleNamespace

    from gigapath_tpu.finetune import training as jtraining
    from gigapath_tpu.obs.numerics import numerics_scalars as jnumerics_scalars
    from gigapath_tpu.obs.telemetry import step_scalars as jstep_scalars
    from gigapath_tpu_torch.finetune import training as ptraining

    slide_kw = dict(SLIDE_KW, segment_length=[16, 32], dilated_ratio="[1, 2]", embed_dim=32, depth=1)
    head_kw = dict(HEAD_KW, latent_dim=32, feat_layer="1")
    jhead = JaxHead(**head_kw, slide_kwargs=slide_kw)
    params = _jax_head_params(jhead, seed=6)
    rng = np.random.default_rng(7)
    batches = [{"imgs": rng.normal(size=(1, 24, 32)).astype(np.float32),
                "coords": rng.integers(0, 4000, (1, 24, 2)).astype(np.float32),
                "labels": np.array([[i % 3]], np.int64), "slide_id": [f"s{i}"]} for i in range(20)]
    hp = dict(lr=1e-3, min_lr=1e-5, warmup_epochs=1, epochs=2, steps_per_epoch=20)
    args = SimpleNamespace(n_classes=3, bf16=False, task_config={"setting": "multi_class"})

    tx = jax_ft.build_optimizer(params, **hp, weight_decay=0.05, layer_decay=0.95, num_layers=2)
    jloss_fn = jax_ft.get_loss_function(args.task_config)

    @jax.jit
    def jax_step(params, opt_state, images, coords, labels, pad_mask, rng):  # the JAX loop's train_step
        def loss(p):
            logits = jhead.apply({"params": p}, images, coords, pad_mask=pad_mask, deterministic=False,
                                 rngs={"dropout": rng})
            return jloss_fn(logits, labels[:, 0])

        value, grads = jax.value_and_grad(loss)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        tel = jstep_scalars(grads=grads, params=params)
        tel.update(jnumerics_scalars(grads=grads))
        return params, opt_state, value, tel

    jlog = _EventRecorder()
    jtraining.train_one_epoch(batches, jax_step, params, tx.init(params), 0, jax.random.PRNGKey(0), args,
                              runlog=jlog)
    (jsynced,) = [e for e in jlog.steps if e.get("synced")]
    (jnum,) = jlog.numerics

    for numerics in (True, False):
        model = ClassificationHead(**head_kw, **slide_kw)
        model.load_state_dict(state_dict_from_flax_params(params), strict=True)
        optimizer = port_ft.build_optimizer(model, lr=hp["lr"], weight_decay=0.05, layer_decay=0.95, num_layers=2)
        steps = port_ft.MultiSteps(optimizer, port_ft.make_lr_scheduler(optimizer, **hp), gc=1)
        plog = _EventRecorder()
        ptraining.train_one_epoch(batches, model, port_ft.get_loss_function(args.task_config), steps, 0, args,
                                  runlog=plog, numerics=numerics)
        (synced,) = [e for e in plog.steps if e.get("synced")]
        assert synced["step"] == jsynced["step"] == 19
        assert synced["loss"] == pytest.approx(jsynced["loss"], rel=1e-4)
        for key in ("grad_norm", "param_norm"):
            assert synced[key] == pytest.approx(jsynced[key], rel=1e-4), key
        assert not any(k.startswith("num.") for k in synced)
        if not numerics:
            assert plog.numerics == []
            continue
        (num,) = plog.numerics
        assert num["step"] == jnum["step"] and num["name"] == jnum["name"] == "finetune"
        assert set(num["layers"]) == set(jnum["layers"]) == {"grad.slide_encoder", "grad.classifier"}
        for layer, stats in jnum["layers"].items():
            for stat, value in stats.items():
                assert num["layers"][layer][stat] == pytest.approx(value, rel=1e-4), (layer, stat)
