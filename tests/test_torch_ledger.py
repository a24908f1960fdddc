"""The port's compile-side obs (``gigapath_tpu_torch/obs/ledger.py``,
``utils/timing.py``, ``utils/profiling.py:op_totals``) on the CPU, mirroring
the JAX package's ``tests/test_ledger.py``: the fingerprint's fixed columns,
the shape signature, full and fingerprint-only profiles, the ledger's dedup,
canonical file, full-then-fingerprint policy, deferred write, run-log path,
``GIGAPATH_OBS=0`` twin and contained failures, the watchdog's hooks; and
what the port adds: a product's flops equal to XLA's count, the kernels
opaque (their plain versions invisible, each call one launch with its
declared operations), no call ever run twice, ``scripts/ledger_diff.py`` on
two of the port's ledgers, the chained timing's chaining, and ``op_totals``
on a trace file.
"""

import copy
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test process)

from gigapath_tpu_torch.obs import CompileWatchdog, NullLedger, PerfLedger, get_ledger
from gigapath_tpu_torch.obs import runlog as port_runlog
from gigapath_tpu_torch.obs.ledger import (
    FINGERPRINT_COLUMNS,
    capture_profile,
    compiled_flops,
    compiled_memory,
    op_fingerprint,
    profile_call,
    shape_signature,
    write_ledger,
)
from gigapath_tpu_torch.ops import dilated_kernels as dk

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO_ROOT, "scripts"))

import ledger_diff  # noqa: E402


def _events(path):
    with open(path, encoding="utf-8") as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _runlog(tmp_path, run_id="r-1"):
    return port_runlog.RunLog(str(tmp_path / "obs" / "run.jsonl"), driver="t", run_id=run_id, echo=False)


# ---------------------------------------------------------------------------
# fingerprints and profiles
# ---------------------------------------------------------------------------


def test_fingerprint_counts_ops_with_fixed_columns():
    fp = op_fingerprint(lambda x: (x @ x.T).reshape(-1), torch.ones(4, 4))
    assert fp["eqns_total"] >= 2 and fp["primitives"]["mm"] == 1 and fp["primitives"]["view"] >= 1
    for col in FINGERPRINT_COLUMNS:  # always present, even at zero
        assert col in fp["primitives"]
    assert fp["primitives"]["kernels"] == 0 and fp["kernels"] == {}
    assert fp["eqns_total"] == sum(fp["primitives"].values())


def test_fingerprint_counts_the_backward_and_the_quant_and_mask_columns():
    """The autograd backward's ops count; an int8 tensor and a square bool
    mask fill their columns, as the JAX eqn predicates do."""
    w = torch.ones(3, 3, requires_grad=True)

    def step(x):
        (x @ w).sum().backward()
        q = x.to(torch.int8)
        return (q.float() > 0)[:, None, :] & torch.ones(3, 3, dtype=torch.bool)

    fp = op_fingerprint(step, torch.ones(3, 3))
    assert fp["primitives"]["mm"] == 2  # the forward's and the backward's dW
    assert fp["quant"] == 2  # the cast to int8 and its cast back
    assert fp["mask"] >= 1


def test_shape_signature_matches_jax():
    from gigapath_tpu.obs.ledger import shape_signature as jax_signature

    args, kwargs = (np.ones((2, 3), np.float32), {"w": 1, "b": 2}), {"y": np.ones(4, np.float32)}
    sig = shape_signature((torch.ones(2, 3), {"w": 1, "b": 2}), {"y": torch.ones(4)})
    assert sig == jax_signature(args, kwargs) == "float32[2,3];tree{2};y=float32[4]"


def test_full_profile_has_cost_memory_and_fingerprint():
    lin = torch.nn.Linear(8, 4)
    p = capture_profile(lin.forward, torch.ones(2, 8))
    assert p["cost"]["flops"] == 2 * 2 * 8 * 4 and p["cost"]["bytes_accessed"] > 0
    mem = p["memory"]
    # a bound method of a module: its parameters are arguments
    assert mem["argument_bytes"] == (2 * 8 + 8 * 4 + 4) * 4 and mem["output_bytes"] == 2 * 4 * 4
    # the CPU keeps no allocator account: no temporaries, no peak
    assert mem["temp_bytes"] is None and mem["peak_bytes"] is None and mem["donated_bytes"] == 0.0
    assert p["jaxpr"]["primitives"]["addmm"] == 1
    assert "cost" not in capture_profile(lambda x: x + 1, torch.ones(4), full=False)


def test_product_flops_equal_xla_cost_analysis():
    """One [32, 48] @ [48, 16] product: FlopCounterMode's count is XLA's."""
    import jax.numpy as jnp

    from gigapath_tpu.obs.ledger import compiled_flops as jax_compiled_flops

    a, b = np.ones((32, 48), np.float32), np.ones((48, 16), np.float32)
    ours = compiled_flops(torch.matmul, torch.from_numpy(a), torch.from_numpy(b))
    assert ours == jax_compiled_flops(jnp.matmul, jnp.asarray(a), jnp.asarray(b)) == 2 * 32 * 48 * 16
    mem = compiled_memory(torch.matmul, torch.from_numpy(a), torch.from_numpy(b))
    assert mem == {"temp_bytes": None, "argument_bytes": (32 * 48 + 48 * 16) * 4.0, "output_bytes": 32 * 16 * 4.0}


def test_a_kernel_counts_one_launch_with_its_declared_work():
    """A kernel wrapper alone: its plain version's ops are hidden, the call
    is one launch, and its flops are 4 Dh per admitted pair (each cell's
    valid keys squared, per head)."""
    torch.manual_seed(0)
    B, S, r, hb, Mp, Dh = 1, 2, 2, 2, 64, 8
    q6, k6, v6 = (torch.randn(B, S, r, hb, Mp, Dh) for _ in range(3))
    kvlen = torch.tensor([[[40, 37], [12, 0]]], dtype=torch.int32)
    p = capture_profile(dk.dilated_branch_fwd, q6, k6, v6, kvlen)
    assert p["jaxpr"]["primitives"] == {**dict.fromkeys(FINGERPRINT_COLUMNS, 0), "kernels": 1}
    assert p["jaxpr"]["kernels"] == {"dilated_branch_fwd": 1}
    pairs = hb * (40**2 + 37**2 + 12**2)
    rows = hb * (40 + 37 + 12)
    assert p["cost"]["flops"] == 4 * Dh * pairs
    assert p["cost"]["bytes_accessed"] == 4 * rows * Dh * 4 + rows * 4


def test_pair_count_equals_the_pair_mask():
    from gigapath_tpu_torch.ops import streaming_kernels as sk

    for H, q0, cq, k0, ck, g, r, valid in [(16, 1, 300, 1, 300, 256, 2, None), (4, 100, 50, 0, 700, 40, 8, 650),
                                           (6, 0, 64, 0, 64, 1000, 3, None), (4, 0, 90, 70, 90, 64, 4, 120)]:
        assert sk.pair_count(H, q0, cq, k0, ck, g, r, valid) == int(sk.pair_mask(q0, cq, k0, ck, g, r, valid, H).sum())


def _tiny_slide_encoder():
    from gigapath_tpu_torch.models.slide_encoder import create_model

    model = create_model("", "gigapath_slide_enc_tiny", in_chans=16, device="cpu", seed=0)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(1, 300, 16)).astype(np.float32))
    coords = torch.from_numpy(rng.uniform(0, 5000, (1, 300, 2)).astype(np.float32))
    return model, x, coords


KERNEL_WRAPPERS = ("pack_phases", "dilated_branch_fwd", "unpack_phases")


def test_kernel_bodies_stay_opaque(monkeypatch):
    """A 2-layer LongNetViT forward: the kernels column counts each wrapper
    call as one launch (on the CPU the plain version runs and LAUNCHES stays
    0; the card's check holds the column to LAUNCHES), and plain versions
    that dispatch three times the ops leave the fingerprint and the flops
    unchanged."""
    model, x, coords = _tiny_slide_encoder()
    with torch.no_grad():
        calls = dict.fromkeys(KERNEL_WRAPPERS, 0)
        for name in KERNEL_WRAPPERS:
            def counted(*a, _fn=getattr(dk, name), _name=name, **k):
                calls[_name] += 1
                return _fn(*a, **k)
            monkeypatch.setattr(dk, name, counted)
        dk.reset_launch_counts()
        plain = capture_profile(model.forward, x, coords)
        assert sum(dk.LAUNCHES.values()) == 0
        assert plain["jaxpr"]["kernels"] == calls == {"pack_phases": 12, "dilated_branch_fwd": 4, "unpack_phases": 4}
        assert plain["jaxpr"]["primitives"]["kernels"] == sum(calls.values())

        for ref in ("pack_phases_reference", "dilated_branch_fwd_reference", "unpack_phases_reference"):
            def busier(*a, _fn=getattr(dk, ref), **k):
                out = _fn(*a, **k)
                _fn(*a, **k)
                _fn(*a, **k)
                return out
            monkeypatch.setattr(dk, ref, busier)
        busy = capture_profile(model.forward, x, coords)
    assert busy["jaxpr"] == plain["jaxpr"]
    assert busy["cost"] == plain["cost"]


def test_profile_call_raises_the_call_s_error_and_closes():
    from gigapath_tpu_torch.ops.common import _open_profile

    with pytest.raises(ZeroDivisionError):
        profile_call(lambda x: 1 / 0, torch.ones(2))
    assert torch._C._len_torch_dispatch_stack() == 0 and _open_profile() is None


# ---------------------------------------------------------------------------
# PerfLedger
# ---------------------------------------------------------------------------


def test_dedup_and_canonical_rewrite(tmp_path):
    path = str(tmp_path / "run.ledger.json")
    led = PerfLedger(path=path)
    calls = []

    def fn(x):
        calls.append(x.shape)
        return (x * 2).sum()

    led.capture("step", fn, torch.ones(2, 8))
    led.capture("step", fn, torch.ones(2, 8))  # same signature: dedup, not run
    led.capture("step", fn, torch.ones(2, 16))
    assert len(led.entries) == 2 and len(calls) == 2
    first = open(path, "rb").read()
    led.write()
    assert open(path, "rb").read() == first  # canonical: stable bytes
    doc = json.loads(first)
    assert doc["v"] == 1 and list(doc["entries"]) == sorted(doc["entries"])


def test_full_then_fingerprint_policy(tmp_path):
    led = PerfLedger(path=str(tmp_path / "l.json"))
    e1 = led.capture("step", torch.sum, torch.ones(4))
    e2 = led.capture("step", torch.sum, torch.ones(8))
    e3 = led.capture_full("step", torch.sum, torch.ones(16))
    assert e1["cost"] is not None and "memory" in e1
    assert "cost" not in e2  # a later signature: fingerprint-only
    assert e3["cost"] is not None  # the explicit full override
    assert led.capture_full("step", torch.sum, torch.ones(8))["cost"] is not None  # upgrades
    assert "cost" not in led.capture_fingerprint("other", torch.sum, torch.ones(8))


def test_deferred_autowrite(tmp_path):
    path = str(tmp_path / "l.json")
    led = PerfLedger(path=path, autowrite=False, meta={"commit": "abc"})
    led.capture_full("f", torch.sum, torch.ones(4))
    assert not os.path.exists(path)
    led.write()
    assert json.load(open(path))["commit"] == "abc"


def test_ledger_path_derives_from_runlog(tmp_path):
    log = _runlog(tmp_path)
    led = get_ledger(log)
    assert led.path == str(tmp_path / "obs" / "r-1.ledger.json")
    led.capture("f", torch.neg, torch.ones(2))
    assert os.path.exists(led.path)
    log.close()
    (ev,) = [e for e in _events(log.path) if e["kind"] == "compile_profile"]
    assert ev["name"] == "f" and ev["jaxpr"]["primitives"]["neg"] == 1 and "cost" in ev


def test_null_ledger_under_obs_off(tmp_path, monkeypatch):
    monkeypatch.setenv("GIGAPATH_OBS", "0")
    log = port_runlog.get_run_log("t", out_dir=str(tmp_path))
    led = get_ledger(log)
    assert isinstance(led, NullLedger) and not isinstance(led, PerfLedger)
    assert led.capture("f", torch.neg, torch.ones(2)) is None and led.write() is None
    assert led.call_for_key("f", (2,), torch.neg, torch.ones(2)).tolist() == [-1.0, -1.0]
    assert list(tmp_path.iterdir()) == []  # no files, no obs dir


def test_capture_failure_is_contained(tmp_path):
    log = _runlog(tmp_path)
    led = get_ledger(log)
    assert led.capture("bad", lambda x: x.no_such_attr, torch.ones(2)) is None
    log.close()
    (ev,) = [e for e in _events(log.path) if e["kind"] == "compile_profile"]
    assert "error" in ev and led.entries == {}


def test_wrap_ledgers_each_new_key(tmp_path):
    log = _runlog(tmp_path)
    led = get_ledger(log)
    calls = []

    def fn(x):
        calls.append(tuple(x.shape))
        return x * 2

    wrapped = CompileWatchdog("step", log, ledger=led).wrap(fn)
    for _ in range(3):
        wrapped(torch.ones(2, 8))
    out = wrapped(torch.ones(2, 16))
    assert out.shape == (2, 16) and len(calls) == 4  # every call ran once
    entries = [led.entries[k] for k in sorted(led.entries)]
    assert len(entries) == 2 and sum("cost" in e for e in entries) == 1
    assert {e["key"] for e in entries} == {"(((2, 8), 'torch.float32'),)", "(((2, 16), 'torch.float32'),)"}
    log.close()


def test_profile_method_for_record_surface_loops(tmp_path):
    led = PerfLedger(path=str(tmp_path / "l.json"))
    wd = CompileWatchdog("train_step", ledger=led)
    wd.record((1, 128), 0.5)
    assert wd.profile((1, 128), torch.sum, torch.ones(1, 128)).item() == 128.0
    assert len(led.entries) == 1
    # without a ledger the call still runs, once, and nothing is kept
    assert CompileWatchdog("train_step").profile((1, 128), torch.sum, torch.ones(1, 128)).item() == 128.0


def test_finetune_steps_run_once_with_the_ledger(tmp_path):
    """Two fp32 fine-tune steps on two buckets through the port's loop: the
    parameters are bit-equal with the ledger on and off, and the ledger
    holds one full entry, then a fingerprint-only one."""
    from gigapath_tpu_torch.finetune import training
    from gigapath_tpu_torch.finetune import utils as ft
    from gigapath_tpu_torch.models.classification_head import ClassificationHead

    slide = dict(embed_dim=32, depth=1, segment_length=[16, 32], dilated_ratio="[1, 2]", dropout=0.0,
                 drop_path_rate=0.0)
    head = dict(input_dim=16, latent_dim=32, feat_layer="1", n_classes=3)
    rng = np.random.default_rng(5)
    batches = [{"imgs": rng.normal(size=(1, n, 16)).astype(np.float32),
                "coords": rng.uniform(0, 4000, (1, n, 2)).astype(np.float32),
                "labels": np.array([[i]], np.int64), "slide_id": [f"s{i}"]} for i, n in enumerate((24, 40))]
    args = SimpleNamespace(n_classes=3, bf16=False, task_config={"setting": "multi_class"})
    hp = dict(lr=1e-2, min_lr=1e-5, warmup_epochs=0, epochs=1, steps_per_epoch=2)
    finals = {}
    for label in ("off", "on"):
        torch.manual_seed(0)
        model = ClassificationHead(**head, **slide)
        optimizer = ft.build_optimizer(model, lr=hp["lr"], weight_decay=0.05, layer_decay=0.95, num_layers=1)
        steps = ft.MultiSteps(optimizer, ft.make_lr_scheduler(optimizer, **hp), gc=1)
        log = port_runlog.RunLog(str(tmp_path / label / "run.jsonl"), driver="t", echo=False)
        ledger = get_ledger(log) if label == "on" else NullLedger()
        watchdog = CompileWatchdog("train_step", log, ledger=ledger)
        training.train_one_epoch(batches, model, ft.get_loss_function(args.task_config), steps, 0, args,
                                 compile_log=watchdog, runlog=log)
        log.close()
        finals[label] = {k: v.detach().clone() for k, v in model.state_dict().items()}
        if label == "on":
            first, second = (next(e for e in ledger.entries.values() if f"[1,{n},16]" in e["sig"])
                             for n in (24, 40))
            assert len(ledger.entries) == 2 and "cost" in first and "cost" not in second
            assert first["jaxpr"]["kernels"]["dilated_branch_bwd_dq"] == 2  # one a branch
    assert all(torch.equal(finals["on"][k], finals["off"][k]) for k in finals["off"])


def test_ledger_diff_reads_two_port_ledgers(tmp_path):
    led = PerfLedger(path=str(tmp_path / "a.json"))
    led.capture("f", lambda x: (x @ x).sum(), torch.ones(8, 8))
    base, cand = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    doc = json.loads(open(base).read())
    write_ledger(doc, cand)
    out = str(tmp_path / "verdict.json")
    assert ledger_diff.main([base, cand, "--json", out]) == 0
    assert json.load(open(out))["decision"]["ok"] is True
    regressed = copy.deepcopy(doc)
    entry = next(iter(regressed["entries"].values()))
    entry["jaxpr"]["eqns_total"] += 5
    entry["jaxpr"]["primitives"]["kernels"] += 5
    write_ledger(regressed, cand)
    assert ledger_diff.main([base, cand, "--json", out]) == 1
    verdict = json.load(open(out))
    assert verdict["decision"]["ok"] is False
    assert any("kernels" in line for line in verdict["decision"]["regressed"])


# ---------------------------------------------------------------------------
# chained timing and trace totals
# ---------------------------------------------------------------------------


def test_chained_seconds_per_iter_chains_each_call():
    from gigapath_tpu_torch.utils.timing import chained_seconds_per_iter

    seen = []

    def step(carry, inc):
        seen.append(float(carry))
        return carry + inc

    per_iter, overhead = chained_seconds_per_iter(step, torch.zeros(()), args=(torch.ones(()),),
                                                  iters_low=2, iters_high=5, repeats=2)
    # one untimed chain of each count, then `repeats` of each
    assert len(seen) == (2 + 5) * (1 + 2)
    chains, i = [], 0
    for n in (2, 5, 2, 2, 5, 5):
        chains.append(seen[i:i + n])
        i += n
    assert all(c == [float(j) for j in range(len(c))] for c in chains)  # each call reads the last carry
    assert per_iter > 0 and isinstance(overhead, float)
    with pytest.raises(ValueError):
        chained_seconds_per_iter(step, torch.zeros(()), args=(torch.ones(()),), iters_low=3, iters_high=3)


def test_op_totals_on_a_trace_file(tmp_path):
    from gigapath_tpu_torch.utils.profiling import op_totals

    events = [
        {"ph": "X", "cat": "kernel", "name": "pack_phases_kernel<16>", "dur": 5.0},
        {"ph": "X", "cat": "kernel", "name": "pack_phases_kernel<16>", "dur": 7.0},
        {"ph": "X", "cat": "kernel", "name": "dilated_branch_fwd_mma_kernel<48>", "dur": 30.5},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)", "dur": 2.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "dur": 1.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 100.0},
        {"ph": "i", "cat": "kernel", "name": "marker"},
    ]
    with open(tmp_path / "trace.json", "w") as fh:
        json.dump({"traceEvents": events}, fh)
    totals = op_totals(str(tmp_path))
    assert totals["ops"] == {"pack_phases_kernel<16>": 12.0, "dilated_branch_fwd_mma_kernel<48>": 30.5}
    assert totals["counts"] == {"pack_phases_kernel<16>": 2, "dilated_branch_fwd_mma_kernel<48>": 1}
    assert totals["async"] == {"Memcpy DtoH (Device -> Pinned)": 2.0, "Memset (Device)": 1.0}


def _attention_step(flags=None, schedule=([16, 64], [1, 2])):
    """A dilated attention forward and backward at L = 64, H = 4, on
    ``flags``."""
    from gigapath_tpu_torch.ops.dilated_attention import dilated_attention

    torch.manual_seed(1)
    q, k, v = (torch.randn(1, 64, 4, 8, requires_grad=True) for _ in range(3))

    def step(q, k, v):
        out = dilated_attention(q, k, v, *schedule, flags=flags)
        out.square().sum().backward()
        return out

    return step, (q, k, v)


def _fold_step():
    import functools

    from gigapath_tpu_torch.ops.streaming_prefill import fold_pair

    torch.manual_seed(2)
    blocks = [torch.randn(1, 32, 4, 8, requires_grad=True) for _ in range(3)]
    acc = (torch.zeros(1, 32, 4, 8), torch.full((1, 4, 32), -1e30))
    fold = functools.partial(fold_pair, segment_len=48, ratio=2)

    def step(q, k, v):
        out, lse = fold(*acc, q, k, v, 16, 0, 40)
        out.square().sum().backward()
        return out

    return step, tuple(blocks)


def _quant_step():
    from gigapath_tpu_torch.quant import qflash, qmatmul, qtensor

    torch.manual_seed(3)
    x, w = torch.randn(2, 5, 24), torch.randn(16, 24)
    q = torch.randn(1, 12, 2, 16)

    def step(x, w, q):
        y = qmatmul.q_matmul(x, qtensor.quantize_per_channel(w, axis=0))
        return y, qflash.q_flash_attention(q, q, q)

    return step, (x, w, q)


KERNEL_ROUTES = {
    "default": (lambda: _attention_step(),
                {"pack_phases", "dilated_branch_fwd", "unpack_phases", "dilated_branch_bwd_dq",
                 "dilated_branch_bwd_dkv"}),
    "pipelined": (lambda: _attention_step(dk.PipelineFlags(pipelined_fwd=True, pipelined_bwd=True)),
                  {"pack_phases", "dilated_branch_fwd_pipe", "unpack_phases", "dilated_branch_bwd_dq_pipe",
                   "dilated_branch_bwd_dkv_pipe"}),
    "stream_fusion": (lambda: _attention_step(dk.PipelineFlags(stream_fusion=True, pack_direct=True)),
                      {"pack_phases", "pack_phases_direct", "unpack_phases", "unpack_phases_direct",
                       "dilated_branch_fwd", "fusion_epilogue_fwd", "fusion_epilogue_bwd", "dilated_branch_bwd_dq",
                       "dilated_branch_bwd_dkv"}),
    "head_major": (lambda: _attention_step(schedule=([16, 64], [1, 3])),  # 3 does not divide H = 4
                   {"flash_fwd", "flat_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flat_bwd_dq", "flat_bwd_dkv"}),
    "streaming_fold": (_fold_step, {"stream_pair_fwd", "stream_pair_bwd_dq", "stream_pair_bwd_dkv"}),
    "quantized": (_quant_step, {"q_matmul", "q_flash_attention"}),
}


@pytest.mark.parametrize("route", sorted(KERNEL_ROUTES))
def test_every_kernel_declares_its_work(route):
    """Each route's kernels appear in the fingerprint with their declared
    operations and bytes: the full profile's cost is counted (no
    ``compile_error``), above the aten products alone where a kernel
    computes attention or a product, and the fingerprint's kernels are the
    route's."""
    make, expected = KERNEL_ROUTES[route]
    step, args = make()
    full = capture_profile(step, *args)
    assert "compile_error" not in full, full.get("compile_error")
    assert set(full["jaxpr"]["kernels"]) == expected
    from torch.utils.flop_counter import FlopCounterMode

    step, args = make()
    with FlopCounterMode(display=False) as products:  # the plain versions' products included
        step(*args)
    assert full["cost"]["flops"] > 0 and full["cost"]["bytes_accessed"] > 0
    if route != "quantized":
        assert full["cost"]["flops"] != products.get_total_flops()  # the kernels' own count, not the plain one's


def test_no_buckets_path_ledgers_later_slides_by_signature(tmp_path):
    """The ``--no-buckets`` inference path sees a new key nearly every
    slide: the first slide's forward gets the full profile, each later one
    its signature alone, and every slide runs once."""
    from gigapath_tpu_torch import inference
    from gigapath_tpu_torch.models.classification_head import get_model

    rng = np.random.default_rng(4)
    for i, n in enumerate((5, 9, 13)):
        torch.save({"features": torch.from_numpy(rng.normal(size=(n, 16)).astype(np.float32)),
                    "coords": torch.from_numpy(rng.uniform(0, 5000, (n, 2)).astype(np.float32))},
                   tmp_path / f"s{i}_features.pt")
    head = get_model(input_dim=16, latent_dim=32, feat_layer="1", n_classes=2, model_arch="gigapath_slide_enc_tiny",
                     device="cpu", seed=3).eval()
    out = inference.run_inference(head, str(tmp_path), str(tmp_path / "e.csv"), use_buckets=False)
    assert len(out) == 3
    (log_path,) = (tmp_path / "obs").glob("*.jsonl")
    (end,) = [ev for ev in _events(log_path) if ev["kind"] == "run_end"]
    with open(end["ledger_path"]) as fh:
        entries = sorted(json.load(fh)["entries"].values(), key=lambda e: e["key"])
    assert [e["key"] for e in entries] == ["(1, 13)", "(1, 5)", "(1, 9)"]
    full = [e for e in entries if "cost" in e]
    assert [e["key"] for e in full] == ["(1, 5)"] and full[0]["jaxpr"]["primitives"]["kernels"] > 0
    assert all(set(e) == {"name", "key", "sig"} for e in entries if e is not full[0])


def test_signature_only_watchdog_keeps_fingerprints_off():
    led = PerfLedger()
    wd = CompileWatchdog("f", ledger=led, fingerprint_later=False)
    calls = []

    def fn(x):
        calls.append(x.shape[0])
        return x + 1

    for n in (2, 3, 3):
        wd.profile((n,), fn, torch.ones(n))
    assert calls == [2, 3, 3] and led.has_full("f")
    assert set(led.entries["f|float32[3]"]) == {"name", "key", "sig"}
    assert "cost" in led.entries["f|float32[2]"]


def test_peaks_survive_a_profile_reset(monkeypatch):
    """A full profile resets the allocator's peak counters to measure its
    call; the run's peaks, as ``peak_bytes`` and the heartbeat's watermarks
    read them, stay (a fake allocator stands in for the card's)."""
    from gigapath_tpu_torch.obs import heartbeat
    from gigapath_tpu_torch.obs import ledger as port_ledger

    stats = {"allocated_bytes.all.peak": 700, "reserved_bytes.all.peak": 900,
             "allocated_bytes.all.current": 100, "reserved_bytes.all.current": 400}

    def reset(index=None):
        stats["allocated_bytes.all.peak"] = stats["allocated_bytes.all.current"]
        stats["reserved_bytes.all.peak"] = stats["reserved_bytes.all.current"]

    for name, fake in (("memory_stats", lambda index=None: dict(stats)), ("reset_peak_memory_stats", reset),
                       ("current_device", lambda: 0), ("is_initialized", lambda: True),
                       ("device_count", lambda: 1)):
        monkeypatch.setattr(torch.cuda, name, fake)
    monkeypatch.setattr(port_ledger, "_FOLDED_PEAKS", {})
    port_ledger._reset_for_profile("cuda:0")
    assert stats["allocated_bytes.all.peak"] == 100  # the profile's own window starts here
    assert port_ledger.peak_bytes() == {"allocated": 700, "reserved": 900}
    marks = heartbeat.memory_watermarks()
    assert marks["mem_peak_bytes"] == 700 and marks["mem_reserved_peak_bytes"] == 900
    stats["allocated_bytes.all.peak"] = 800  # a later peak above the folded one
    assert port_ledger.peak_bytes()["allocated"] == 800
    port_ledger.reset_peaks()  # a caller's new window forgets the fold
    assert port_ledger.peak_bytes() == {"allocated": 100, "reserved": 400}


def _smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_bounds", os.path.join(REPO_ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_smoke_bounds_are_the_declared_work_on_a_ragged_call():
    """``chip_smoke.py``'s bounds take each kernel's declared work, the one
    count the profile adds up. On a ragged branch (37 tokens past the valid
    length) the admitted pairs are each cell's valid keys squared per head:
    the kernel also computes the cell's padded query rows (all Mp of
    them), which no consumer reads and the bound leaves out."""
    smoke = _smoke()
    E, H = smoke.E, smoke.H
    L = 2500
    real = L - 37
    hd = E // H
    for sl, r in ((1024, 1), (2048, 2), (4096, 4)):
        g, S, m, Mp = dk._branch_geometry(L, sl, r)
        kvlen = dk._branch_kvlen(1, S, g, r, m, real, None, "cpu")
        q6 = torch.zeros(1, S, r, H // r, Mp, hd, dtype=torch.bfloat16)
        x = torch.zeros(1, L, E, dtype=torch.bfloat16)
        kv = kvlen.numpy().astype(np.int64)
        brute = (H // r) * sum(int(((np.arange(Mp)[:, None] < n) & (np.arange(Mp)[None, :] < n)).sum())
                               for n in kv.ravel())
        assert brute < (H // r) * Mp * int(kv.sum())  # the padded rows the kernel computes
        bounds, pairs = smoke._branch_bounds(x, q6, q6, kvlen, L, g, S, r, Mp, "bfloat16")
        assert pairs == brute
        flops, nbytes = dk.dilated_branch_fwd.declared_work(q6, q6, q6, kvlen)
        assert flops == 4 * hd * brute
        assert bounds["dilated_branch_fwd"] == max((flops / smoke.PEAK_FLOPS["bfloat16"] * 1e3, "operations"),
                                                   (nbytes / smoke.HBM_BYTES_PER_S * 1e3, "bytes"))
        lse = torch.zeros(1, S, r, H // r, Mp)
        bwd, bwd_pairs = smoke._bwd_bounds((q6, q6, q6, q6, lse, lse, kvlen), "bfloat16")
        assert bwd_pairs == brute and set(bwd) == {"dilated_branch_bwd_dq", "dilated_branch_bwd_dkv"}
