"""The port's hardened checkpoints
(``gigapath_tpu_torch/resilience/checkpoint.py``) against the JAX package's
(``gigapath_tpu/resilience/checkpoint.py``): the same saves, rotations,
corruptions and restores on both give the same checkpoint steps, ``best.json``
pointers, verifications, restored values and run-log events. The files
inside a checkpoint differ (``torch.save`` against Orbax); the discipline
around them does not.
"""

import json
import os
import types

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test process)

import gigapath_tpu.obs.runlog as jax_runlog
import gigapath_tpu.resilience.chaos as jax_chaos
import gigapath_tpu.resilience.checkpoint as jax_checkpoint
import gigapath_tpu_torch.obs.runlog as port_runlog
import gigapath_tpu_torch.resilience.chaos as port_chaos
import gigapath_tpu_torch.resilience.checkpoint as port_checkpoint

FLAVORS = {
    "jax": types.SimpleNamespace(ckpt=jax_checkpoint, log=jax_runlog, chaos=jax_chaos),
    "port": types.SimpleNamespace(ckpt=port_checkpoint, log=port_runlog, chaos=port_chaos),
}


def _state(step):
    return {"w": np.arange(6, dtype=np.float32).reshape(2, 3) * step,
            "nested": {"b": np.full(3, step, np.int64)}}


def _values(state):
    return {"w": np.asarray(state["w"]).tolist(), "b": np.asarray(state["nested"]["b"]).tolist()}


def _rotation(ns, ck, root):
    for step in (1, 2, 3, 4):
        ck.save(step, _state(step))
        if step == 2:
            ck.mark_best(2, 0.9)
    # a valid checkpoint of the same step is kept, not rewritten
    path = ck.save(4, _state(99))
    restored, step = ck.restore_latest()
    return {"steps": [s for s, _ in ck.checkpoints()], "best": ck.best(),
            "verify": [ck.verify(p) for _, p in ck.checkpoints()],
            "kept": os.path.basename(path), "latest": step, "values": _values(restored),
            "tmp_left": sorted(n for n in os.listdir(root) if n.startswith(".tmp"))}


def _corrupt_fallback(ns, ck, root):
    for step in (1, 2, 3):
        ck.save(step, _state(step))
    ns.chaos.corrupt_checkpoint_dir(ck.path_for(3), seed=0)  # keep=2: steps 2 and 3 remain
    restored, step = ck.restore_latest()
    return {"latest": step, "values": _values(restored), "verify": [ck.verify(p) for _, p in ck.checkpoints()]}


def _nothing_valid(ns, ck, root):
    ck.save(1, _state(1))
    ck.save(2, _state(2))
    ns.chaos.corrupt_checkpoint_dir(ck.path_for(1), seed=1)
    os.remove(os.path.join(ck.path_for(2), "manifest.json"))
    return {"restored": ck.restore_latest(emit_resume=False), "steps": [s for s, _ in ck.checkpoints()]}


def _emergency(ns, ck, root):
    armed = ck.arm_sigterm_checkpoint(lambda: (7, _state(7)))
    keep_going = ck._sigterm_cb(15)  # what the SIGTERM handler calls
    ck.disarm()
    restored, step = ck.restore_latest(emit_resume=False)
    return {"armed": armed, "keep_going": keep_going, "step": step, "values": _values(restored)}


SCENARIOS = {
    "rotation_best_pin": _rotation,
    "corrupt_fallback": _corrupt_fallback,
    "nothing_valid": _nothing_valid,
    "sigterm_emergency": _emergency,
}


def _normalize(value, root):
    if isinstance(value, dict):
        return {k: _normalize(v, root) for k, v in sorted(value.items()) if k not in ("v", "run", "t")}
    if isinstance(value, (list, tuple)):
        return [_normalize(v, root) for v in value]
    if isinstance(value, str):
        return value.replace(root, "<root>")
    return value


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_checkpointer_matches_jax(name, tmp_path):
    results = {}
    for flavor, ns in FLAVORS.items():
        root = str(tmp_path / flavor)
        log = ns.log.RunLog(os.path.join(str(tmp_path), f"{flavor}.jsonl"), driver="ckpt-test", echo=False)
        ck = ns.ckpt.ResilientCheckpointer(root, keep=2, runlog=log)
        out = SCENARIOS[name](ns, ck, root)
        log.close()
        with open(log.path, encoding="utf-8") as fh:
            events = [json.loads(line) for line in fh if line.strip()]
        results[flavor] = _normalize({"out": out, "events": events}, root)
    assert results["port"] == results["jax"]


def test_manifest_covers_the_state_file(tmp_path):
    """The port's checkpoint directory: ``state.pt`` and a manifest of its
    sha256; one flipped byte fails verification."""
    ck = port_checkpoint.ResilientCheckpointer(str(tmp_path))
    path = ck.save(3, {**_state(3), "tensor": torch.ones(2)})
    with open(os.path.join(path, "manifest.json"), encoding="utf-8") as fh:
        manifest = json.load(fh)
    assert manifest["step"] == 3 and sorted(manifest["files"]) == ["state.pt"]
    assert ck.verify(path)
    with open(os.path.join(path, "state.pt"), "r+b") as fh:
        fh.seek(-1, os.SEEK_END)
        last = fh.read(1)
        fh.seek(-1, os.SEEK_END)
        fh.write(bytes([last[0] ^ 0xFF]))
    assert not ck.verify(path)


# ---------------------------------------------------------------------------
# the slide dataset's loader faults and recovery events
# ---------------------------------------------------------------------------

DATASETS = {"jax": ("gigapath_tpu.data.slide_dataset", jax_runlog),
            "port": ("gigapath_tpu_torch.data.slide_dataset", port_runlog)}


@pytest.fixture
def slide_dataset(tmp_path):
    """A factory of either package's ``SlideDataset`` over three 8-tile h5
    slides (the JAX package's loader-hardening fixture)."""
    import importlib

    import h5py
    import pandas as pd

    rng = np.random.default_rng(0)
    root = tmp_path / "h5_files"
    root.mkdir()
    rows = []
    for i in range(3):
        with h5py.File(root / f"slide_{i}.h5", "w") as f:
            f.create_dataset("features", data=rng.normal(size=(8, 16)).astype(np.float32))
            f.create_dataset("coords", data=rng.integers(0, 5000, (8, 2)).astype(np.float32))
        rows.append({"slide_id": f"slide_{i}.svs", "pat_id": f"pat_{i}", "label": ["neg", "pos"][i % 2]})
    cfg = {"setting": "multi_class", "label_dict": {"neg": 0, "pos": 1}, "max_tiles": 10}

    def make(flavor, retry=3):
        df = pd.DataFrame(rows)
        cls = importlib.import_module(DATASETS[flavor][0]).SlideDataset
        return cls(df, str(root), splits=df["pat_id"].tolist(), task_config=cfg, retry=retry,
                   retry_backoff_s=0.0)

    return make


def test_port_dataset_heals_a_transient_loader_fault(slide_dataset, monkeypatch):
    monkeypatch.setenv("GIGAPATH_CHAOS", "fail_loader@1x1")
    sample = slide_dataset("port", retry=3).get_sample_with_try(1)
    assert sample is not None and sample["imgs"].shape == (8, 16)


def test_port_dataset_skips_with_one_recovery_event(slide_dataset, tmp_path, monkeypatch):
    monkeypatch.setenv("GIGAPATH_CHAOS", "fail_loader@1x9")
    ds = slide_dataset("port", retry=2)
    log = port_runlog.RunLog(str(tmp_path / "run.jsonl"), driver="t", echo=False)
    ds.set_runlog(log)
    assert ds.get_sample_with_try(1) is None  # skipped, not raised
    assert ds.get_sample_with_try(0) is not None  # the other samples are untouched
    log.close()
    with open(log.path, encoding="utf-8") as fh:
        events = [json.loads(line) for line in fh if line.strip()]
    (ev,) = [e for e in events if e["kind"] == "recovery" and e.get("action") == "data_retry"]
    assert ev["index"] == 1 and ev["attempts"] == 2 and "ChaosError" in ev["error"]
    assert ev["slide_id"] == "slide_1.svs"


@pytest.mark.parametrize("spec", ["fail_loader@1x9", "fail_loader@0x2,fail_loader@2x1", ""])
def test_port_dataset_skips_what_jax_skips(spec, slide_dataset, tmp_path, monkeypatch):
    """Under the same ``GIGAPATH_CHAOS`` spec both packages' datasets skip
    the same indices and log the same recovery events."""
    monkeypatch.setenv("GIGAPATH_CHAOS", spec)
    results = {}
    for flavor, (_, runlog_mod) in DATASETS.items():
        ds = slide_dataset(flavor, retry=2)
        log = runlog_mod.RunLog(str(tmp_path / f"{flavor}.jsonl"), driver="t", echo=False)
        ds.set_runlog(log)
        skipped = [i for i in range(3) if ds.get_sample_with_try(i) is None]
        log.close()
        with open(log.path, encoding="utf-8") as fh:
            events = [{k: e[k] for k in ("action", "index", "slide_id", "attempts", "error")}
                      for e in map(json.loads, fh) if e["kind"] == "recovery"]
        results[flavor] = (skipped, events)
    assert results["port"] == results["jax"]
