"""The port's PCam linear probe held against the JAX package on the CPU.

The same numpy-seeded embeddings (``.pt`` members of a zip with a csv, the
layout of ``tests/test_linear_probe.py``) go to both packages, and the
JAX probe's initial parameters are carried across
(``state_dict_from_flax_params``: kernel [D, C] -> weight [C, D]).

Tolerances: the dataset's samples, labels and embeddings equal, its
z-score 1e-6; the batch index stream equal; ``evaluate``'s six numbers
1e-6 (scikit-learn's definitions in numpy); the cosine schedule 1e-7 of
optax's (fp32 there, fp64 here); 30 training iterations 1e-5 on the final
and the best parameters (both sides sum fp32 products in other orders),
the best-f1 selection equal and ``results.txt``'s numbers 1e-6.
"""

import io
import json
import glob
import os
import zipfile

import numpy as np
import optax
import pandas as pd
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test process)

from gigapath_tpu.data import pcam as jpcam
from gigapath_tpu.linear_probe import main as jlp
from gigapath_tpu.utils.checkpoint import restore_checkpoint as jrestore
from gigapath_tpu_torch.data import pcam as ppcam
from gigapath_tpu_torch.finetune.utils import cosine_decay_schedule
from gigapath_tpu_torch.linear_probe import main as plp
from gigapath_tpu_torch.utils.checkpoint import restore_checkpoint
from gigapath_tpu_torch.utils.convert import state_dict_from_flax_params

D = 16


def _make_pcam_fixture(tmp_path, seed=0, d=D, n_per_split=40, classes=("neg", "pos")):
    """Embeddings whose label is the argmax of a random linear map, as
    ``.pt`` members of a zip, and the csv."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(d, len(classes)))
    zpath = tmp_path / "embeds.zip"
    names, labels, splits = [], [], []
    with zipfile.ZipFile(zpath, "w") as z:
        for split in ("train", "val", "test"):
            for i in range(n_per_split):
                x = rng.normal(size=d)
                name = f"{split}_{i}"
                buf = io.BytesIO()
                torch.save(torch.from_numpy(x.astype(np.float32)), buf)
                z.writestr(f"e/{name}.pt", buf.getvalue())
                names.append(name)
                labels.append(classes[int(np.argmax(x @ w))])
                splits.append(split)
    csv = tmp_path / "ds.csv"
    pd.DataFrame({"input": names, "label": labels, "split": splits}).to_csv(csv)
    return str(csv), str(zpath)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    return _make_pcam_fixture(tmp_path_factory.mktemp("pcam"))


def _datasets(pcam, csv, zpath, **kw):
    return [pcam.EmbeddingDataset(csv, zpath, split=s, **kw) for s in ("train", "val", "test")]


def test_embedding_dataset_matches_jax(fixture):
    csv, zpath = fixture
    for z_score in (False, True):
        for ours, ref in zip(_datasets(ppcam, csv, zpath, z_score=z_score),
                             _datasets(jpcam, csv, zpath, z_score=z_score)):
            assert ours.samples == ref.samples and ours.labels == ref.labels
            assert ours.label_dict == ref.label_dict and len(ours) == len(ref)
            for i in range(len(ref)):
                (e, t), (e_ref, t_ref) = ours[i], ref[i]
                assert t == t_ref and e.dtype == np.float32
                if z_score:
                    np.testing.assert_allclose(e, e_ref, atol=1e-6, rtol=1e-6)
                else:
                    np.testing.assert_array_equal(e, e_ref)


def test_batches_index_stream_matches_jax(fixture):
    csv, zpath = fixture
    ours_ds, ref_ds = ppcam.EmbeddingDataset(csv, zpath), jpcam.EmbeddingDataset(csv, zpath)
    for infinite in (True, False):
        ours = plp._batches(ours_ds, 7, np.random.default_rng(5), infinite)
        ref = jlp._batches(ref_ds, 7, np.random.default_rng(5), infinite)
        for _ in range(12 if infinite else 6):
            (e, t), (e_ref, t_ref) = next(ours), next(ref)
            np.testing.assert_array_equal(e, e_ref)
            np.testing.assert_array_equal(t, t_ref)


def test_evaluate_matches_jax_with_a_class_never_predicted():
    """Fixed logits through an identity probe: three classes, class 2 in
    the targets but never the argmax."""
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(60, 3)).astype(np.float32)
    logits[:, 2] -= 10.0
    target = rng.integers(0, 3, 60)
    target[:5] = 2

    def loader():
        for s in range(0, 60, 16):
            yield logits[s : s + 16], target[s : s + 16]

    kernel = np.eye(3, dtype=np.float32)
    bias = np.zeros(3, np.float32)
    ref = jlp.evaluate({"kernel": kernel, "bias": bias}, loader)
    ours = plp.evaluate({"weight": torch.from_numpy(kernel.T.copy()), "bias": torch.from_numpy(bias)}, loader)
    assert ours[2] != pytest.approx(0.0)  # macro precision over classes 0, 1 and the unpredicted 2
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=1e-6)


def test_cosine_schedule_matches_optax():
    for lr, total, alpha in ((0.01, 30, 0.0), (0.5, 1000, 0.1), (1e-4, 7, 0.0)):
        ref = optax.cosine_decay_schedule(lr, total, alpha=alpha)
        ours = cosine_decay_schedule(lr, total, alpha=alpha)
        for t in (0, 1, total // 3, total - 1, total, total + 5):
            assert abs(ours(t) - float(ref(t))) <= 1e-7 * max(lr, 1.0), (lr, total, t)


def _results(path):
    with open(path) as fh:
        text = fh.read()
    return [float(tok) for tok in text.replace(":", " ").split() if tok[0].isdigit() or tok[0] == "-"]


@pytest.mark.parametrize("optim,momentum,weight_decay,lr", [
    ("sgd", 0.0, 0.0, 0.5),
    ("sgd", 0.9, 1e-3, 0.1),
    ("adam", 0.0, 1e-2, 0.05),
])
def test_train_matches_jax(fixture, tmp_path, optim, momentum, weight_decay, lr):
    """30 iterations with evals at 10, 20 and 30 from JAX's initial
    parameters: final and best parameters, the best-f1 selection and
    results.txt against the JAX driver."""
    csv, zpath = fixture
    init = jlp.init_linear_probe(D, 2, seed=3)
    kw = dict(train_iters=30, batch_size=16, lr=lr, min_lr=lr / 10, optim=optim, momentum=momentum,
              weight_decay=weight_decay, eval_interval=10, seed=7, report_to="jsonl")
    ref_dir, our_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    ref = jlp.train(init, *_datasets(jpcam, csv, zpath), output_dir=ref_dir, **kw)
    ours = plp.train(state_dict_from_flax_params(init), *_datasets(ppcam, csv, zpath), output_dir=our_dir,
                     device="cpu", **kw)
    for name in ("model", "best_model"):
        want = state_dict_from_flax_params(jrestore(os.path.join(ref_dir, name)))
        got = restore_checkpoint(os.path.join(our_dir, name + ".pt"))
        assert set(got) == {"weight", "bias"}
        for key in want:
            np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), atol=1e-5, rtol=1e-5)
    assert ours["val_f1"] == pytest.approx(ref["val_f1"], abs=1e-6)  # the same best-f1 eval selected
    np.testing.assert_allclose(_results(os.path.join(our_dir, "results.txt")),
                               _results(os.path.join(ref_dir, "results.txt")), atol=1e-6, rtol=1e-6)
    for key, value in ref.items():
        assert ours[key] == pytest.approx(value, abs=1e-6), key


def _events(out_dir):
    (path,) = [p for p in glob.glob(os.path.join(out_dir, "obs", "*.jsonl"))
               if not os.path.basename(p).startswith("flight-")]
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def test_main_end_to_end_writes_run_log_and_artifacts(tmp_path):
    csv, zpath = _make_pcam_fixture(tmp_path, seed=1, n_per_split=200)
    out = str(tmp_path / "out")
    res = plp.main(["--dataset_csv", csv, "--input_path", zpath, "--embed_dim", str(D), "--batch_size", "16",
                    "--train_iters", "300", "--lr", "0.5", "--eval_interval", "100", "--seed", "0",
                    "--report_to", "jsonl", "--device", "cpu", "--output_dir", out])
    assert res["test_auroc"] > 0.95  # separable: the probe learns
    for name in ("results.txt", "model.pt", "best_model.pt"):
        assert os.path.exists(os.path.join(out, name)), name
    events = _events(out)
    kinds = [e["kind"] for e in events]
    assert kinds.count("eval") == 3 and kinds.count("step") == 30
    (end,) = [e for e in events if e["kind"] == "run_end"]
    assert end["status"] == "ok" and end["test_auroc"] == pytest.approx(res["test_auroc"])
    assert "compile" in kinds and [e["name"] for e in events if e["kind"] == "span"].count("eval") == 3
    assert any("linear_probe.step_wall_s" in json.dumps(e) for e in events if e["kind"] == "metrics")


def test_init_linear_probe_is_the_same_on_every_device():
    a, b = plp.init_linear_probe(32, 3, seed=1), plp.init_linear_probe(32, 3, seed=1)
    assert torch.equal(a.weight, b.weight) and torch.equal(a.bias, b.bias)
    bound = 32**-0.5
    assert a.weight.abs().max() <= bound and a.bias.abs().max() <= bound
    assert not torch.equal(a.weight, plp.init_linear_probe(32, 3, seed=2).weight)


def test_train_without_device_raises_without_cuda(monkeypatch, fixture, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    csv, zpath = fixture
    with pytest.raises(RuntimeError, match="device='cpu'"):
        plp.train(plp.init_linear_probe(D, 2), *_datasets(ppcam, csv, zpath), train_iters=1,
                  output_dir=str(tmp_path))

