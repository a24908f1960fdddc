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
