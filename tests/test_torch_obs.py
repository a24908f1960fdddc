"""The port's obs core and chaos injection held against the JAX package's
modules on the CPU: the same calls on both sides give the same metrics,
request traces, anomaly detections, flight dumps, chaos schedules and run
log events; the port's own parts (the torch ``span`` fence, the heartbeat's
``torch.cuda.memory_stats`` watermarks, the watchdog's capture and kernel
build accounting, the ledger's capture entries, the profiler capture the
anomaly engine arms) on their own.
"""

import json
import os

import numpy as np
import pytest

from gigapath_tpu.obs import anomaly as jax_anomaly
from gigapath_tpu.obs import flight as jax_flight
from gigapath_tpu.obs import metrics as jax_metrics
from gigapath_tpu.obs import reqtrace as jax_reqtrace
from gigapath_tpu.obs import runlog as jax_runlog
from gigapath_tpu.resilience import chaos as jax_chaos
from gigapath_tpu_torch.obs import anomaly as port_anomaly
from gigapath_tpu_torch.obs import flight as port_flight
from gigapath_tpu_torch.obs import metrics as port_metrics
from gigapath_tpu_torch.obs import reqtrace as port_reqtrace
from gigapath_tpu_torch.obs import runlog as port_runlog
from gigapath_tpu_torch.resilience import chaos as port_chaos

SIDES = {"jax": (jax_runlog, jax_metrics, jax_reqtrace, jax_anomaly, jax_flight),
         "port": (port_runlog, port_metrics, port_reqtrace, port_anomaly, port_flight)}


def _runlogs(tmp_path):
    """A RunLog per side with one run id, in separate directories."""
    out = {}
    for side, (runlog, *_) in SIDES.items():
        out[side] = runlog.RunLog(str(tmp_path / side / "run.jsonl"), driver="t", run_id="r", echo=False)
    return out


def _events(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def _strip(rec, drop=("t", "run")):
    return {k: v for k, v in rec.items() if k not in drop}


# ---------------------------------------------------------------------------
# metrics and the SLO tracker
# ---------------------------------------------------------------------------


def _fill_registry(metrics_mod, seed):
    rng = np.random.default_rng(seed)
    reg = metrics_mod.MetricsRegistry()
    reqs = reg.counter("serve.submits")
    depth = reg.gauge("serve.queued_tokens")
    walls = reg.histogram("serve.dispatch_s")
    waits = reg.histogram("serve.queue_wait_s", bounds=[0.001, 0.01, 0.1, 1.0])
    for v in rng.lognormal(-3.0, 1.5, 300):
        walls.observe(float(v))
        reqs.inc()
    for v in rng.exponential(0.05, 120):
        waits.observe(float(v))
    depth.set(4096.0)
    depth.inc(128.0)
    return reg


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_snapshot_quantiles_and_exports_match_jax(seed):
    jreg, preg = _fill_registry(jax_metrics, seed), _fill_registry(port_metrics, seed)
    snap = preg.snapshot()
    assert snap == jreg.snapshot()
    assert port_metrics.to_prometheus(snap) == jax_metrics.to_prometheus(jreg.snapshot())
    assert port_metrics.to_json_line(snap) == jax_metrics.to_json_line(jreg.snapshot())
    hist = preg.histogram("serve.dispatch_s")
    for q in (0.5, 0.9, 0.99):
        assert hist.quantile(q) == jreg.histogram("serve.dispatch_s").quantile(q)
    vals = sorted(np.random.default_rng(seed).normal(size=77).tolist())
    for q in (0.0, 0.25, 0.5, 0.99, 1.0):
        assert port_metrics.percentile(vals, q) == jax_metrics.percentile(vals, q)
    other = _fill_registry(port_metrics, seed + 10).snapshot()
    jother = _fill_registry(jax_metrics, seed + 10).snapshot()
    assert port_metrics.merge_snapshots(snap, other) == jax_metrics.merge_snapshots(jreg.snapshot(), jother)


def test_slo_tracker_burn_transitions_match_jax(tmp_path):
    logs = _runlogs(tmp_path)
    trackers = {side: SIDES[side][1].SloTracker(0.1, budget=0.05, short_window_s=10.0, long_window_s=30.0,
                                                burn_threshold=2.0, min_events=4, runlog=logs[side])
                for side in SIDES}
    rng = np.random.default_rng(3)
    lat = np.concatenate([rng.uniform(0.01, 0.09, 40), rng.uniform(0.2, 0.5, 20), rng.uniform(0.01, 0.05, 60)])
    statuses = {side: [] for side in SIDES}
    for i, v in enumerate(lat):
        now = 100.0 + 0.5 * i
        for side, tr in trackers.items():
            if i % 17 == 5:
                tr.observe_failure(now=now)
            else:
                tr.observe(float(v), now=now)
            statuses[side].append(tr.status(now=now))
    assert statuses["port"] == statuses["jax"]
    assert trackers["port"].burn_entries == trackers["jax"].burn_entries >= 1
    for side in SIDES:
        trackers[side].emit_status()
        logs[side].close()
    slo = {side: [_strip(r) for r in _events(logs[side].path) if r["kind"] == "slo"] for side in SIDES}
    assert slo["port"] == slo["jax"] and slo["port"]


# ---------------------------------------------------------------------------
# request traces
# ---------------------------------------------------------------------------


def test_request_traces_export_the_same_chrome_trace(tmp_path):
    logs = _runlogs(tmp_path)
    docs = {}
    for side, (_, _, reqtrace, _, _) in SIDES.items():
        col = reqtrace.TraceCollector(logs[side], max_traces=3)
        col._t0 = 0.0
        for i in range(4):  # the fourth is dropped past max_traces
            tr = col.start(f"slide{i}", now=1.0 + i, n_tiles=10 * i)
            tr.add_span("submit", 1.0 + i, 1.25 + i, bucket=1024, outcome="enqueued")
            tr.add_span("queue", tr.t_last, 2.0 + i, bucket=1024)
            tr.add_span("dispatch", 2.0 + i, 2.5 + i, slides=2, capacity=4, source="captured")
            tr.finish(2.5 + i)
        assert col.stats() == {"traces": 3, "spans": 9, "dropped": 1}
        path = col.export()
        with open(path) as fh:
            docs[side] = json.load(fh)
        logs[side].close()
    assert docs["port"]["traceEvents"] == docs["jax"]["traceEvents"]
    meta = {side: {k: v for k, v in docs[side]["metadata"].items() if k != "source"} for side in SIDES}
    assert meta["port"] == meta["jax"]
    assert docs["port"]["metadata"]["source"] == "gigapath_tpu_torch.obs.reqtrace"
    traces = {side: [_strip(r) for r in _events(logs[side].path) if r["kind"] == "trace"] for side in SIDES}
    for side in SIDES:
        for r in traces[side]:
            r.pop("path")
    assert traces["port"] == traces["jax"] == [{"v": 1, "kind": "trace", "traces": 3, "spans": 9, "dropped": 1}]


# ---------------------------------------------------------------------------
# anomaly engine and flight recorder
# ---------------------------------------------------------------------------


def _event_sequence():
    """Step walls with a spike, an unexpected retrace, memory growth on
    heartbeats, a stall, an SLO burn and an error, with fixed times."""
    recs, t = [], 1000.0
    walls = [0.1] * 12 + [0.9] + [0.1] * 20 + [0.1] * 5
    for i, w in enumerate(walls):
        t += 0.2 if i != 30 else 3.0  # a throughput dip at step 30
        recs.append({"v": 1, "run": "r", "kind": "step", "t": t, "step": i, "wall_s": w, "synced": True,
                     "bucket": "1024"})
        if i == 14:
            recs.append({"v": 1, "run": "r", "kind": "compile", "t": t, "fn": "serve.forward",
                         "key": "(4, 1024)", "seconds": 0.5, "count": 2, "unexpected": True})
        if i in (3, 20, 35):
            recs.append({"v": 1, "run": "r", "kind": "heartbeat", "t": t, "last_step": i,
                         "since_progress_s": 0.1, "mem_peak_bytes": float((1 << 28) * (1 + (i // 10)))})
    recs.append({"v": 1, "run": "r", "kind": "stall", "t": t + 1, "last_step": 37, "since_progress_s": 400.0,
                 "deadline_s": 300.0})
    recs.append({"v": 1, "run": "r", "kind": "slo", "t": t + 2, "burning": True, "burn_short": 9.0,
                 "threshold": 2.0, "target_s": 0.1, "budget": 0.05, "burn_long": 4.0, "latency_s": 0.4})
    recs.append({"v": 1, "run": "r", "kind": "error", "t": t + 3, "where": "serve.dispatch", "error": "x"})
    return recs


def test_anomaly_detections_and_flight_dumps_match_jax(tmp_path):
    logs = _runlogs(tmp_path)
    engines, flights = {}, {}
    for side, (_, _, _, anomaly, flight) in SIDES.items():
        cfg = anomaly.AnomalyConfig()
        cfg.capture_budget = 0  # no profiler here: both sides react by events and dumps only
        cfg.cooldown_steps = 4
        flights[side] = flight.FlightRecorder(logs[side], capacity=16, max_dumps=8)
        engines[side] = anomaly.AnomalyEngine(logs[side], config=cfg, flight=flights[side])
        for rec in _event_sequence():
            flights[side].on_event(rec)
            engines[side].on_event(rec)
    found = {side: [_strip(r, ("t", "run", "flight")) for r in engines[side].anomalies] for side in SIDES}
    assert found["port"] == found["jax"]
    assert {r["detector"] for r in found["port"]} >= {
        "step_time_spike", "unexpected_retrace", "memory_watermark", "stall", "slo_burn"}
    dumps = {side: [_strip(r, ("t",)) for r in _events(flights[side].path)] for side in SIDES}
    assert dumps["port"] == dumps["jax"]
    assert flights["port"].dump_count == flights["jax"].dump_count >= 5


def test_anomaly_capture_runs_the_torch_profiler(tmp_path):
    """The port's armed capture: the steps after a firing detector run
    inside a torch.profiler trace, written to the anomaly's trace_dir."""
    log = port_runlog.RunLog(str(tmp_path / "run.jsonl"), driver="t", echo=False)
    cfg = port_anomaly.AnomalyConfig()
    cfg.capture_steps, cfg.capture_budget = 2, 1
    engine = port_anomaly.attach_anomaly_engine(log, config=cfg)
    log.event("stall", last_step=0, since_progress_s=400.0, deadline_s=300.0)
    for i in range(4):
        log.step(i, wall_s=0.1, synced=True)
    log.run_end()
    (fired,) = [r for r in engine.anomalies if r["detector"] == "stall"]
    assert engine.trace_dirs == [fired["trace_dir"]]
    assert os.path.isfile(os.path.join(fired["trace_dir"], "trace.json"))


# ---------------------------------------------------------------------------
# chaos
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "poison@s3,slow_dispatch@2:0.25,seed=7",
    "slow_dispatch@*:0.5,poison@a,poison@b",
    "nan_loss@3,corrupt_batch@5,fail_loader@2x3,slow_loader@1:0.5,sigterm@9",
])
def test_chaos_schedules_match_jax(monkeypatch, spec):
    monkeypatch.setenv("GIGAPATH_CHAOS", spec)
    jc, pc = jax_chaos.get_chaos(), port_chaos.get_chaos()
    assert bool(pc) and type(pc).__name__ == "ChaosInjector"
    ids = ["a", "s1", "s3", "b", "c"]
    for k in range(len(ids)):
        assert pc.poisoned(ids[k:]) == jc.poisoned(ids[k:])
    for k in range(12):
        assert pc.slow_dispatch(k) == jc.slow_dispatch(k)
        assert pc.batch_fault(k) == jc.batch_fault(k)
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    for kind in ("nan", "corrupt"):
        np.testing.assert_array_equal(pc.apply_batch_fault(kind, arr.copy()),
                                      jc.apply_batch_fault(kind, arr.copy()))


def test_chaos_off_and_typos(monkeypatch):
    monkeypatch.delenv("GIGAPATH_CHAOS", raising=False)
    assert not port_chaos.get_chaos()
    monkeypatch.setenv("GIGAPATH_CHAOS", "poison@x,no_such@1")
    with pytest.raises(ValueError, match="unknown injector"):
        port_chaos.get_chaos()


# ---------------------------------------------------------------------------
# run log, spans, heartbeat, watchdog, ledger
# ---------------------------------------------------------------------------


def test_run_log_events_match_jax(tmp_path, monkeypatch):
    """The same calls write events of the same kinds and keys (the
    manifest's device fields aside, which name each side's framework)."""
    monkeypatch.setenv("GIGAPATH_OBS", "1")
    monkeypatch.setenv("GIGAPATH_ANOMALY", "0")
    paths = {}
    for side, (runlog, *_) in SIDES.items():
        log = runlog.get_run_log("t", path=str(tmp_path / side / "run.jsonl"), config={"a": 1, "b": [1, 2]},
                                 echo=False, probe_devices=side == "port")
        log.step(3, wall_s=0.25, synced=True, bucket="1024", slides=2)
        log.compile_event("serve.forward", (4, 1024), 1.5, count=1, unexpected=False)
        log.heartbeat(last_step=3, since_progress_s=0.5)
        log.stall(last_step=3, since_progress_s=301.0, deadline_s=300.0)
        log.recovery("shed", slide_id="s", bucket=1024)
        log.event("serve_dispatch", bucket=1024, slides=2, capacity=4, occupancy=0.5, queue_wait_s=[0.1, 0.2],
                  wall_s=0.3, source="x")
        log.error("serve.dispatch", ValueError("boom"))
        runlog.fail_run(log, "inference.run_inference", RuntimeError("late"))
        paths[side] = log.path
    jev, pev = _events(paths["jax"]), _events(paths["port"])
    assert [r["kind"] for r in pev] == [r["kind"] for r in jev]
    device = {"jax_version", "torch_version", "cuda_version", "backend", "device_kind", "device_count",
              "device_names", "process_index", "manifest_error"}
    for j, p in zip(jev, pev):
        assert set(p) - device == set(j) - device, p["kind"]
        if p["kind"] not in ("run_start", "run_end"):
            assert _strip(p) == _strip(j)
    start = pev[0]
    assert start["config"] == {"a": 1, "b": [1, 2]} and start["torch_version"] and start["backend"] == "cpu"
    assert pev[-1]["status"] == "error"
    assert port_runlog._key_str((4, 1024)) == jax_runlog._key_str((4, 1024))
    for raw in (None, "", "0", "false", "no", "1", "yes"):
        if raw is None:
            monkeypatch.delenv("GIGAPATH_X", raising=False)
        else:
            monkeypatch.setenv("GIGAPATH_X", raw)
        assert port_runlog.env_on_by_default("GIGAPATH_X") == jax_runlog.env_on_by_default("GIGAPATH_X")
        assert port_runlog.env_number("GIGAPATH_X", 7.0) == jax_runlog.env_number("GIGAPATH_X", 7.0)


def test_obs_off_gives_null_sinks(tmp_path, monkeypatch):
    from gigapath_tpu_torch.obs import get_ledger, get_metrics, get_tracer, span

    monkeypatch.setenv("GIGAPATH_OBS", "0")
    log = port_runlog.get_run_log("t", out_dir=str(tmp_path), echo=False)
    assert isinstance(log, port_runlog.NullRunLog) and log.path is None
    assert get_ledger(log).path is None and get_tracer(log).export() is None
    assert isinstance(get_metrics(log), port_metrics.NullMetricsRegistry)
    assert get_metrics(log).flush() is None
    with span("x", log, fence=True) as sp:
        sp.fence(object())
    assert sp.dur_s is None and not os.listdir(tmp_path)


def test_span_events_nest_and_fence_cpu_tensors(tmp_path):
    import torch

    from gigapath_tpu_torch.obs.spans import span

    log = port_runlog.RunLog(str(tmp_path / "run.jsonl"), driver="t", echo=False)
    with span("outer", log, k=1):
        with span("inner", log, fence=True, depth="shadowed") as sp:
            sp.fence({"a": [torch.ones(3)]})
            sp.note(extra=2)
    log.close()
    inner, outer = [r for r in _events(log.path) if r["kind"] == "span"]
    assert (inner["path"], inner["depth"], inner["fenced"], inner["status"]) == ("outer/inner", 2, True, "ok")
    assert inner["field_depth"] == "shadowed" and inner["extra"] == 2 and inner["rank"] == 0
    assert (outer["path"], outer["depth"], outer["fenced"], outer["k"]) == ("outer", 1, False, 1)
    assert sp.dur_s is not None and sp.dur_s >= 0


def test_heartbeat_beats_and_reads_no_device_memory_on_the_cpu(tmp_path):
    import time

    from gigapath_tpu_torch.obs.heartbeat import Heartbeat, memory_watermarks

    assert memory_watermarks() == {}  # no CUDA context in this process
    log = port_runlog.RunLog(str(tmp_path / "run.jsonl"), driver="t", echo=False)
    with Heartbeat(log, interval_s=0.05, stall_after_s=0.2, name="t") as hb:
        hb.beat(1)
        time.sleep(0.5)
    log.close()
    kinds = [r["kind"] for r in _events(log.path)]
    assert "heartbeat" in kinds and "stall" in kinds and hb.stall_count == 1


class _Captures:
    """Stands in for the graph cache: ``_cache_size`` counts captures."""

    def __init__(self):
        self.n = 0

    def _cache_size(self):
        return self.n


def test_watchdog_counts_a_new_key_once_and_flags_growth_on_a_seen_key(tmp_path, monkeypatch):
    from gigapath_tpu_torch.obs.ledger import get_ledger
    from gigapath_tpu_torch.obs.watchdog import CompileWatchdog
    from gigapath_tpu_torch.ops import _build

    log = port_runlog.RunLog(str(tmp_path / "run.jsonl"), driver="t", echo=False)
    monkeypatch.setattr(_build, "build_seconds", {"old_kernel": 9.0})
    wd = CompileWatchdog("serve.forward", log, ledger=get_ledger(log))
    cache = _Captures()
    wd.attach(cache)
    cache.n = 1
    _build.build_seconds["dilated_branch_fwd-GP_HEAD_DIM=48"] = 2.0  # built inside the first capture
    wd.record((4, 1024), 3.0)
    for _ in range(3):
        wd.record((4, 1024), None)
    assert wd.unexpected_retraces == [] and wd.compile_count == {(4, 1024): 1}
    cache.n = 2
    wd.record((4, 2048), 1.0)
    cache.n = 3  # a capture on a key already seen
    wd.record((4, 1024), None)
    assert wd.unexpected_retraces == [(4, 1024)] and wd.compile_count[(4, 1024)] == 2
    assert wd.kernel_builds == {"dilated_branch_fwd-GP_HEAD_DIM=48": 2.0}
    assert wd.compile_seconds_total() == pytest.approx(3.0 + 1.0 + 2.0)
    assert wd._counts[(4, 1024)] == 3
    log.close()
    compiles = [(r["fn"], r["key"], r["unexpected"]) for r in _events(log.path) if r["kind"] == "compile"]
    assert compiles == [("serve.forward.kernel_build", "dilated_branch_fwd-GP_HEAD_DIM=48", False),
                        ("serve.forward", "(4, 1024)", False), ("serve.forward", "(4, 2048)", False),
                        ("serve.forward", "(4, 1024)", True)]


def test_ledger_adopts_captures_and_writes_a_canonical_file(tmp_path):
    import torch

    from gigapath_tpu_torch.obs.ledger import NullLedger, get_ledger

    assert isinstance(get_ledger(port_runlog.NullRunLog()), NullLedger)
    log = port_runlog.RunLog(str(tmp_path / "run.jsonl"), driver="t", run_id="r", echo=False)
    ledger = get_ledger(log)
    inputs = (torch.zeros(4, 16, 8), torch.zeros(4, 16, 2), torch.ones(4, 16, dtype=torch.bool))
    graph = {"capture_s": 1.25, "pool_bytes": 4096, "launches": {"dilated_branch_fwd": 60}}
    entry = ledger.adopt_compiled("serve.forward", (4, 16), graph, *inputs)
    assert entry["sig"] == "float32[4,16,8];float32[4,16,2];bool[4,16]" and entry["graph"] == graph
    ledger.capture_for_key("inference.forward", (1, 5), torch.neg, torch.zeros(1, 5, 8))
    with open(ledger.path) as fh:
        doc = json.load(fh)
    assert doc["run"] == "r" and sorted(doc["entries"]) == [
        "inference.forward|float32[1,5,8]", "serve.forward|float32[4,16,8];float32[4,16,2];bool[4,16]"]
    log.close()
    profiles = [r for r in _events(log.path) if r["kind"] == "compile_profile"]
    assert [p["key"] for p in profiles] == ["(4, 16)", "(1, 5)"]


# ---------------------------------------------------------------------------
# the fleet's clock, trace merge, trend history and drift sentinel
# ---------------------------------------------------------------------------

from gigapath_tpu.obs import clock as jax_clock  # noqa: E402
from gigapath_tpu.obs import drift as jax_drift  # noqa: E402
from gigapath_tpu.obs import fleet as jax_fleet  # noqa: E402
from gigapath_tpu.obs import history as jax_history  # noqa: E402
from gigapath_tpu_torch.obs import clock as port_clock  # noqa: E402
from gigapath_tpu_torch.obs import drift as port_drift  # noqa: E402
from gigapath_tpu_torch.obs import fleet as port_fleet  # noqa: E402
from gigapath_tpu_torch.obs import history as port_history  # noqa: E402

FLEET_SIDES = {"jax": (jax_runlog, jax_clock, jax_fleet, jax_history, jax_drift, jax_metrics),
               "port": (port_runlog, port_clock, port_fleet, port_history, port_drift, port_metrics)}
CLOCK_SAMPLES = [(1000.0, 5.02, 5.021, 1000.05), (1000.2, 5.205, 5.206, 1000.212),
                 (1000.4, 5.41, 5.43, 1000.5), (2000.0, 7.01, 7.011, 2000.02)]


def _clock_run(clock_mod, runlog):
    """Four handshakes on one link (a resync before the last: a restarted
    consumer) -> every estimate and the clock_sync events."""
    link = clock_mod.LinkClock("tcp.w0")
    out = []
    for i, sample in enumerate(CLOCK_SAMPLES):
        if i == 3:
            link.resync()
        est = link.update(clock_mod.ClockSample(*sample))
        clock_mod.emit_clock_sync(runlog, link, est)
        out.append((est.offset_s, est.rtt_s, est.uncertainty_s, link.offset_s, link.uncertainty_s,
                    est.to_reference(1000.1)))
    return out


def test_clock_offsets_match_jax(tmp_path):
    logs, out = _runlogs(tmp_path), {}
    for side, (_, clock_mod, *_rest) in FLEET_SIDES.items():
        out[side] = (_clock_run(clock_mod, logs[side]), )
        logs[side].close()
        out[side] += ([_strip(e) for e in _events(logs[side].path)],)
    assert out["port"] == out["jax"]
    assert len(out["port"][1]) == 4 and out["port"][1][-1]["epoch"] == 1


def _span(name, t0, t1, **args):
    return {"ph": "X", "tid": 1, "name": name, "ts": t0 * 1e6, "dur": (t1 - t0) * 1e6, "args": args}


def _exports(clock_mod, runlog):
    """Two processes' trace exports of one slide: a producer whose
    monotonic clock reads ~995 s ahead (its clock_sync events from
    :func:`_clock_run`) and the consumer (the reference axis)."""
    tr = "tr-fleet"
    sid = lambda actor, name, c=None: f"{tr}/{actor}/{name}" if c is None else f"{tr}/{actor}/c{c}/{name}"  # noqa: E731
    producer, consumer = [], []
    for c in range(3):
        t = 1000.0 + 0.03 * c
        producer += [_span("dist.encode", t, t + 0.02, span_id=sid("w0", "dist.encode", c), trace_id=tr,
                           chunk=c, actor="w0"),
                     _span("send", t + 0.02, t + 0.025, span_id=sid("w0", "send", c), trace_id=tr,
                           chunk=c, actor="w0", parent_span_id=sid("w0", "dist.encode", c))]
        d = 5.03 + 0.03 * c
        consumer += [_span("deliver", d, d + 0.004, span_id=sid("consumer", "deliver", c), trace_id=tr,
                           chunk=c, actor="consumer", parent_span_id=sid("w0", "send", c)),
                     _span("dist.fold", d + 0.004, d + 0.02, span_id=sid("consumer", "dist.fold", c),
                           trace_id=tr, chunk=c, actor="consumer",
                           parent_span_id=sid("consumer", "deliver", c))]
    consumer.append(_span("dist.finalize", 5.13, 5.15, span_id=sid("consumer", "dist.finalize"),
                          trace_id=tr, actor="consumer"))
    _clock_run(clock_mod, runlog)
    runlog.close()
    events = _events(runlog.path)
    doc = lambda actor, spans, pid: {"metadata": {"clock": {"t0_monotonic": 0.0}, "actor": actor,  # noqa: E731
                                                  "pid": pid}, "traceEvents": spans}
    return [{"label": "w0", "doc": doc("w0", producer, 11), "events": events[:3]},
            {"label": "consumer", "doc": doc("consumer", consumer, 22)}]


def test_fleet_merge_of_two_exports_matches_jax(tmp_path):
    """Two exports merged on the producer's clock_sync offset: the merged
    Perfetto doc, the critical path, the invariants, the orphans and the
    fleet health agree with the JAX package's merge."""
    logs, out = _runlogs(tmp_path), {}
    for side, (_, clock_mod, fleet_mod, *_rest) in FLEET_SIDES.items():
        fleet = fleet_mod.FleetTimeline.from_parts(_exports(clock_mod, logs[side]), run_id="r")
        perfetto = fleet.perfetto()
        assert perfetto["metadata"].pop("source") == fleet_mod.__name__  # each names its own module
        out[side] = {"perfetto": perfetto, "critical": fleet.critical_path(),
                     "invariants": fleet.invariants(), "orphans": [s.span_id for s in fleet.orphans()],
                     "health": fleet.health()}
    assert out["port"] == out["jax"]
    flows = [e for e in out["port"]["perfetto"]["traceEvents"] if e.get("ph") in ("s", "f")]
    assert len(flows) == 6 and out["port"]["invariants"] == []


def _history_run(history_mod, path):
    doc = history_mod.new_history()
    history_mod.fold_bench(doc, {"rc": 0, "parsed": {"value": 10.0, "mfu": 0.4}}, "r01")
    history_mod.fold_bench(doc, {"rc": 0, "parsed": {"value": 12.0, "mfu": 0.35}}, "r02")
    history_mod.fold_bench(doc, {"rc": 1, "parsed": {"error": "no chip"}}, "r03")
    history_mod.append_point(doc, "dist|smoke", "r01", {"chunks_per_sec": 50.0, "nan": float("nan")})
    history_mod.append_point(doc, "dist|smoke", "r02", {"chunks_per_sec": 40.0})
    history_mod.append_point(doc, "dist|smoke", "r01", {"chunks_per_sec": 55.0}, force=True)
    try:
        history_mod.append_point(doc, "dist|smoke", "r02", {"chunks_per_sec": 1.0})
    except ValueError as e:
        refused = str(e)
    history_mod.write_history(doc, path)
    return {"doc": history_mod.load_history(path), "best": history_mod.trend_verdict(doc),
            "prev": history_mod.trend_verdict(doc, baseline="prev"), "refused": refused,
            "directions": [history_mod.metric_direction(m) for m in ("mfu", "peak_hbm_gb", "chunks_per_sec")]}


def test_history_folding_matches_jax(tmp_path):
    out = {side: _history_run(mods[3], str(tmp_path / f"{side}.json")) for side, mods in FLEET_SIDES.items()}
    assert out["port"] == out["jax"]
    assert not out["port"]["best"]["decision"]["ok"]  # dist|smoke regressed against its best


def _drift_run(drift_mod, metrics_mod, runlog, path):
    rng = np.random.default_rng(5)
    baseline = drift_mod.EmbeddingSketch(6)
    for vec in rng.standard_normal((32, 6)):
        baseline.update(vec)
    baseline.save(path)
    loaded = drift_mod.EmbeddingSketch.load(path)
    metrics = metrics_mod.MetricsRegistry()
    sentinel = drift_mod.DriftSentinel(loaded, runlog, metrics=metrics, every=2, threshold=1.0, min_count=2)
    records = []
    for i in range(12):  # in distribution, then shifted by 3 sigma, then back
        shift = 3.0 if 4 <= i < 8 else 0.0
        records.append(sentinel.observe(rng.standard_normal(6) + shift))
    sentinel.emit_status()
    with open(os.path.join(path, "manifest.json")) as fh:
        manifest = json.load(fh)
    return {"records": [_strip(r) if r else r for r in records], "status": sentinel.status(),
            "scores": drift_mod.drift_scores(sentinel.current, baseline), "gauges": metrics.snapshot(),
            "manifest": sorted(manifest)}


def test_drift_sentinel_alarms_match_jax(tmp_path):
    """One fixed embedding sequence through the sentinel: the same alarming
    transitions, drift events, scores and gauges; a tampered baseline is a
    loud ``CorruptDriftArtifact`` on both sides."""
    logs, out = _runlogs(tmp_path), {}
    for side, (_, _, _, _, drift_mod, metrics_mod) in FLEET_SIDES.items():
        path = str(tmp_path / f"{side}-baseline")
        out[side] = _drift_run(drift_mod, metrics_mod, logs[side], path)
        logs[side].close()
        out[side]["events"] = [_strip(e) for e in _events(logs[side].path) if e["kind"] == "drift"]
        victim = [n for n in os.listdir(path) if n != "manifest.json"][0]
        with open(os.path.join(path, victim), "ab") as fh:
            fh.write(b"x")
        with pytest.raises(drift_mod.CorruptDriftArtifact):
            drift_mod.EmbeddingSketch.load(path)
    assert out["port"] == out["jax"]
    assert sum(1 for e in out["port"]["events"] if e.get("alarming")) >= 1
