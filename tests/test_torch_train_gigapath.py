"""The port's whole-slide training driver held against the JAX package on
the CPU.

One ``train_model`` step at ``gigapath_slide_enc_tiny`` with dropout off
against the JAX driver's (loss and updated parameters, the frozen encoder
bit-unchanged); the non-finite guard's skip flags and event sequence
against JAX's; a NaN step that leaves parameters and AdamW state bit-equal,
a rollback after consecutive skips, a resume that ends bit-equal to the
uninterrupted run, a SIGTERM in a subprocess whose emergency checkpoint
resumes, and the whole journey from PNG slides (the fakes of
``tests/test_train_driver.py``).
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test process)
from PIL import Image

from gigapath_tpu_torch import train_gigapath as ptg
from gigapath_tpu_torch.models import classification_head as pch
from gigapath_tpu_torch.resilience import guard as pguard
from gigapath_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(model_arch="gigapath_slide_enc_tiny", latent_dim=32, feat_layer="1")
INPUT_DIM = 16


def _features(directory, n_slides=2, seed=0, labels=None):
    """Port feature caches ``s{i}_features.pt`` and a labels csv; returns
    (labels_file, [(features, coords)])."""
    rng = np.random.default_rng(seed)
    os.makedirs(directory, exist_ok=True)
    slides = []
    for i in range(n_slides):
        n = 24 + 7 * i
        x = rng.normal(size=(n, INPUT_DIM)).astype(np.float32)
        c = rng.integers(0, 3000, (n, 2)).astype(np.float32)
        save_checkpoint(os.path.join(directory, f"s{i}_features.pt"),
                        {"features": torch.from_numpy(x), "coords": torch.from_numpy(c)})
        slides.append((x, c))
    labels = labels if labels is not None else [i % 2 for i in range(n_slides)]
    labels_file = os.path.join(os.path.dirname(directory), "labels.csv")
    with open(labels_file, "w") as fh:
        fh.write("slide_id,label\n" + "".join(f"s{i},{y}\n" for i, y in enumerate(labels)))
    return labels_file, slides


def _events(out_dir):
    """The events of every run log under ``out_dir`` (one a run, or one
    shared by runs that start within the same second)."""
    paths = sorted(p for p in glob.glob(os.path.join(out_dir, "obs", "*.jsonl"))
                   if not os.path.basename(p).startswith("flight-"))
    assert paths
    return [json.loads(line) for path in paths for line in open(path)]


def _ckpt(out_dir, step):
    return restore_checkpoint(os.path.join(out_dir, "ckpts", f"ckpt-{step:08d}", "state.pt"))


def _assert_trees_equal(a, b, what):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    else:
        assert a == b, what


def test_one_train_model_step_matches_jax(tmp_path, monkeypatch):
    """fp32, dropout off, one slide, one step: the loss within 1e-4, every
    updated parameter within 1e-4 and each classifier update (final - init)
    within 1e-6 of the JAX driver's, the frozen encoder bit-unchanged."""
    import jax
    import jax.numpy as jnp

    from gigapath_tpu import train_gigapath as jtg
    from gigapath_tpu.models import classification_head as jch
    from gigapath_tpu.utils.checkpoint import restore_checkpoint as jrestore
    from gigapath_tpu.utils.checkpoint import save_checkpoint as jsave
    from gigapath_tpu_torch.utils.convert import state_dict_from_flax_params

    monkeypatch.setenv("GIGAPATH_OBS", "0")
    labels_file, [(x, c)] = _features(str(tmp_path / "features"), n_slides=1, labels=[1])
    jsave(str(tmp_path / "jfeatures" / "s0_features"), {"features": x, "coords": c})

    made = []

    def jget(*, input_dim, latent_dim, feat_layer, n_classes, model_arch, freeze, dtype):
        """The JAX factory's head and init (``PRNGKey(0)``), with fp32
        compute and no dropout to compare one step at 1e-4, and the init
        jitted (eager it traces ~200 small programs)."""
        head = jch.ClassificationHead(
            input_dim=input_dim, latent_dim=latent_dim, feat_layer=feat_layer, n_classes=n_classes,
            model_arch=model_arch, slide_kwargs={"dropout": 0.0, "drop_path_rate": 0.0},
        )
        params = jax.jit(head.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4, input_dim)), jnp.zeros((1, 4, 2)))
        made.append((head, params["params"]))
        return made[-1]

    monkeypatch.setattr(jch, "get_model", jget)
    jres = jtg.train_model(str(tmp_path / "jfeatures"), labels_file, str(tmp_path / "jout"), num_epochs=1, **TINY)
    ((_, init),) = made
    init = state_dict_from_flax_params(jax.device_get(init))
    ref = state_dict_from_flax_params(jrestore(str(tmp_path / "jout" / "model"))["params"])

    port_get_model = pch.get_model

    def pget(**kw):  # no dropout, and the JAX driver's initial weights
        model = port_get_model(**kw, dropout=0.0, drop_path_rate=0.0)
        model.load_state_dict(init, strict=True)
        return model

    monkeypatch.setattr(pch, "get_model", pget)
    res = ptg.train_model(str(tmp_path / "features"), labels_file, str(tmp_path / "pout"), num_epochs=1,
                          device="cpu", bf16=False, **TINY)
    assert res["n_classes"] == jres["n_classes"] == 2
    assert abs(res["loss_history"][0] - jres["loss_history"][0]) <= 1e-4
    final = restore_checkpoint(str(tmp_path / "pout" / "model.pt"))["params"]
    assert set(final) == set(ref)
    moved = 0
    for name, value in final.items():
        np.testing.assert_allclose(value.numpy(), ref[name].numpy(), atol=1e-4, rtol=0, err_msg=name)
        if name.startswith("slide_encoder."):
            assert torch.equal(value, init[name]), name
        else:
            # Adam's first step moves an element by about lr = 1e-4, so the
            # update itself is held to 1 % of that
            step, ref_step = (value - init[name]).numpy(), (ref[name] - init[name]).numpy()
            np.testing.assert_allclose(step, ref_step, atol=1e-6, rtol=0, err_msg=name)
            assert np.abs(ref_step).max() > 5e-5, name
            moved += 1
    assert moved == 2  # the classifier's weight and bias


def test_guard_matches_jax():
    """guard_update's skip flag on finite, NaN-loss and inf-gradient steps,
    and SkipStepMonitor's answers and events over one flag sequence, as the
    JAX package's."""
    import jax.numpy as jnp

    from gigapath_tpu.resilience import guard as jguard

    rng = np.random.default_rng(3)
    grads = [rng.normal(size=(4, 5)).astype(np.float32), rng.normal(size=(7,)).astype(np.float32)]
    cases = [(1.5, grads), (float("nan"), grads), (0.7, [grads[0], np.full(7, np.inf, np.float32)])]
    for loss, gs in cases:
        calls = []
        loss_f, skipped = pguard.guard_update(torch.tensor(loss), [torch.from_numpy(g) for g in gs],
                                              lambda: calls.append(1))
        (state, _), jskipped = jguard.guard_update(jnp.float32(loss), [jnp.asarray(g) for g in gs],
                                                   (jnp.zeros(2), None), (jnp.ones(2), None))
        assert skipped == float(jskipped)
        assert len(calls) == (skipped == 0.0) == bool(np.asarray(state)[0])
        assert loss_f == pytest.approx(loss, nan_ok=True)

    class Recorder:
        def __init__(self):
            self.events = []

        def event(self, kind, **fields):
            self.events.append((kind, fields))

        def echo(self, msg, **kw):
            self.events.append(("echo", msg))

    flags = [0, 1, 1, 0, 1, 1, 1, 1, 0]
    ours, ref = pguard.SkipStepMonitor(Recorder(), rollback_after_skips=2), \
        jguard.SkipStepMonitor(Recorder(), rollback_after_skips=2)
    for step, flag in enumerate(flags):
        assert ours.observe(step, flag) == ref.observe(step, flag)
        assert ours.last_consecutive == ref.last_consecutive
    ours.rollback_unavailable(9)
    ref.rollback_unavailable(9)
    assert ours.runlog.events == ref.runlog.events
    assert ours.skip_count == ref.skip_count == 6


def test_nan_step_skipped_and_rollback(tmp_path, monkeypatch):
    """GIGAPATH_CHAOS=nan_loss@2: step 2 is skipped, its checkpoint's
    parameters and AdamW state (its step count too) bit-equal to step 1's,
    a skip_step event written; two NaN steps with
    GIGAPATH_GUARD_ROLLBACK_AFTER=2 roll back to the last checkpoint."""
    labels_file, _ = _features(str(tmp_path / "features"))
    kw = dict(num_epochs=2, device="cpu", checkpoint_every=1, keep_checkpoints=10, **TINY)
    monkeypatch.setenv("GIGAPATH_CHAOS", "nan_loss@2")
    out = str(tmp_path / "nan")
    res = ptg.train_model(str(tmp_path / "features"), labels_file, out, **kw)
    assert np.isfinite(res["loss_history"]).all()
    before, after = _ckpt(out, 2), _ckpt(out, 3)
    _assert_trees_equal(after["params"], before["params"], "params")
    _assert_trees_equal(after["opt_state"], before["opt_state"], "opt_state")
    assert not torch.equal(_ckpt(out, 4)["params"]["classifier.weight"], after["params"]["classifier.weight"])
    events = _events(out)
    assert [(e["action"], e["step"]) for e in events if e["kind"] == "recovery"] == [("skip_step", 2)]
    (skipped,) = [e for e in events if e["kind"] == "step" and e.get("nonfinite")]
    assert skipped["step"] == 2 and skipped["consecutive"] == 1
    (end,) = [e for e in events if e["kind"] == "run_end"]
    assert end["skipped_steps"] == 1 and end["rollbacks"] == 0

    monkeypatch.setenv("GIGAPATH_CHAOS", "nan_loss@2,nan_loss@3")
    monkeypatch.setenv("GIGAPATH_GUARD_ROLLBACK_AFTER", "2")
    out = str(tmp_path / "rollback")
    ptg.train_model(str(tmp_path / "features"), labels_file, out, **kw)
    recovery = [(e["action"], e["step"], e.get("to_step")) for e in _events(out) if e["kind"] == "recovery"]
    assert recovery == [("skip_step", 2, None), ("skip_step", 3, None), ("rollback", 3, 3)]


def test_guard_off_runs_no_guard_code(tmp_path, monkeypatch):
    labels_file, _ = _features(str(tmp_path / "features"))
    monkeypatch.setenv("GIGAPATH_NONFINITE_GUARD", "0")
    monkeypatch.setenv("GIGAPATH_CHAOS", "nan_loss@1")
    monkeypatch.setattr(pguard, "guard_update", lambda *a: pytest.fail("guard code ran"))
    out = str(tmp_path / "off")
    ptg.train_model(str(tmp_path / "features"), labels_file, out, num_epochs=1, device="cpu", **TINY)
    # unguarded, the NaN step poisons the classifier
    final = restore_checkpoint(os.path.join(out, "model.pt"))["params"]
    assert torch.isnan(final["classifier.weight"]).all()


def test_resume_is_bit_exact(tmp_path):
    """Dropout on: 2 epochs, then resume="auto" to 3, against 3 epochs in
    one run: the same parameters and AdamW state, bit for bit."""
    labels_file, _ = _features(str(tmp_path / "features"))
    kw = dict(device="cpu", checkpoint_every=1, **TINY)
    whole, split = str(tmp_path / "whole"), str(tmp_path / "split")
    a = ptg.train_model(str(tmp_path / "features"), labels_file, whole, num_epochs=3, **kw)
    ptg.train_model(str(tmp_path / "features"), labels_file, split, num_epochs=2, **kw)
    b = ptg.train_model(str(tmp_path / "features"), labels_file, split, num_epochs=3, resume="auto", **kw)
    assert a["loss_history"][2] == b["loss_history"][2]
    _assert_trees_equal(_ckpt(split, 6), _ckpt(whole, 6), "state")
    assert ("resume", 4) in [(e["action"], e["step"]) for e in _events(split) if e["kind"] == "recovery"]


def test_sigterm_checkpoint_resumes(tmp_path):
    """sigterm@2 in a subprocess (no periodic checkpoint): the process dies
    of SIGTERM, leaving an emergency checkpoint of step 3 that resumes to
    the uninterrupted run's state."""
    labels_file, _ = _features(str(tmp_path / "features"))
    out = str(tmp_path / "killed")
    script = (
        "import sys; sys.path.insert(0, {root!r})\n"
        "from gigapath_tpu_torch import train_gigapath as t\n"
        "t.train_model({f!r}, {l!r}, {o!r}, num_epochs=3, device='cpu', model_arch='gigapath_slide_enc_tiny',"
        " latent_dim=32, feat_layer='1')\n"
    ).format(root=ROOT, f=str(tmp_path / "features"), l=labels_file, o=out)
    env = dict(os.environ, GIGAPATH_CHAOS="sigterm@2")
    proc = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0, proc.stdout + proc.stderr
    assert not os.path.exists(os.path.join(out, "model.pt"))
    assert sorted(os.listdir(os.path.join(out, "ckpts"))) == ["ckpt-00000003"]
    kw = dict(num_epochs=3, device="cpu", checkpoint_every=6, **TINY)
    ptg.train_model(str(tmp_path / "features"), labels_file, out, resume="auto", **kw)
    whole = str(tmp_path / "whole")
    ptg.train_model(str(tmp_path / "features"), labels_file, whole, **kw)
    _assert_trees_equal(_ckpt(out, 6), _ckpt(whole, 6), "state")


def test_full_journey_from_png_slides(tmp_path):
    """rename -> tile -> extract (cached on a second call) -> labels ->
    train, with the small test tile encoder on the CPU."""
    from gigapath_tpu_torch.models.tile_encoder import create_tile_encoder

    rng = np.random.default_rng(0)
    data_dir = tmp_path / "slides"
    data_dir.mkdir()
    for i in range(2):
        arr = np.full((256, 256, 3), 245, np.uint8)
        arr[64:192, 96:224] = rng.integers(30, 120, (128, 128, 3))
        Image.fromarray(arr).save(data_dir / f"slide_{i}.png")
    os.rename(data_dir / "slide_0.png", data_dir / "slide_0.png?download=1")
    encoder = create_tile_encoder("", "vit_tile_enc_test", device="cpu", quant="")
    out = str(tmp_path / "out")
    res = ptg.main(str(data_dir), out, tile_encoder=encoder, num_epochs=2, device="cpu",
                   freeze_pretrained=False, model_arch="gigapath_slide_enc_tiny", latent_dim=32, feat_layer="1")
    assert sorted(os.listdir(data_dir)) == ["slide_0.png", "slide_1.png"]
    assert len(res["loss_history"]) == 2 and np.isfinite(res["loss_history"]).all()
    feats = restore_checkpoint(os.path.join(out, "features", "slide_0_features.pt"))
    n_tiles = len(glob.glob(os.path.join(out, "features", "tiles", "output", "slide_0.png", "*.png")))
    assert n_tiles > 0 and feats["features"].shape == (n_tiles, encoder.embed_dim)
    assert os.path.exists(os.path.join(out, "labels.csv"))
    mtime = os.stat(os.path.join(out, "features", "slide_0_features.pt")).st_mtime_ns
    files = ptg.rename_slide_files(str(data_dir))
    assert len(ptg.extract_features(files, os.path.join(out, "features"), tile_encoder=encoder)) == 2
    assert os.stat(os.path.join(out, "features", "slide_0_features.pt")).st_mtime_ns == mtime
