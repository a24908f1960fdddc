"""Cross-run perf history: the append-only trend file behind the round
tables.

The port's copy of ``gigapath_tpu/obs/history.py`` (host-side Python: no torch
or jax here), names and event schema unchanged.

``BENCH_rNN.json`` / ``MULTICHIP_rNN.json`` snapshots and per-run
ledgers (:mod:`gigapath_tpu_torch.obs.ledger`) each pin one moment; the trend
between them has lived in PERFORMANCE.md prose and eyeballs. This module
folds them into ONE machine-checkable file (``PERF_HISTORY.json`` at the
repo root), keyed ``name|qualifier`` like the ledger:

- ``bench|slide_embed`` — the bench payload's throughput/MFU/memory
  metrics per round;
- ``multichip|dryrun`` — the multichip dryrun verdict per round;
- every ledger key (``name|shape-signature``) — flattened
  cost/memory/jaxpr metrics per ingested ledger.

Each entry is a list of labeled points (append-only: re-ingesting a
label is refused without ``force``), and :func:`trend_verdict` renders a
``ledger_diff``-shaped decision table: per metric, the latest non-stale
point is judged against the best (or previous) non-stale point in the
entry's history, with per-metric regression directions from
:func:`metric_direction`. Exit-code consumers read ``decision.ok`` —
the CI-gateable successor of eyeballing round tables, and the trend
surface a serving stack or geometry autotuner can read.

Pure stdlib — no jax import — shared by ``scripts/perf_history.py`` and
anything else that wants the trend (it must load on a workstation far
from any chip).
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Tuple

HISTORY_SCHEMA_VERSION = 1

# metric-name suffix -> regression direction. "up" means bigger is
# better (a DECREASE is the regression); "down" the opposite. Metrics
# matching no rule are recorded but not gated (counts, ids, flags).
_DIRECTION_RULES: Tuple[Tuple[str, str], ...] = (
    ("tokens_per_sec", "up"),
    ("tiles_per_sec", "up"),
    ("steps_per_sec", "up"),
    ("slides_per_sec", "up"),
    ("occupancy_mean", "up"),
    ("cache_hit_rate", "up"),
    ("queue_wait_p50_s", "down"),
    ("queue_wait_p90_s", "down"),
    ("chunks_per_sec", "up"),
    ("recover_extra_s", "down"),   # kill-recover wall over the clean run's
    ("reconnect_s", "down"),       # TCP chaos wall over the clean TCP run's
    ("consumer_recover_s", "down"),  # consumer kill-restart extra wall
    # latency-histogram quantiles (the serve|latency entry and any
    # future *_pNN_s metric): tail latency down-is-good
    ("_p50_s", "down"),
    ("_p90_s", "down"),
    ("_p95_s", "down"),
    ("_p99_s", "down"),
    ("compile_seconds_total", "down"),
    # quantized tile tier (tile|quant entry, scripts/ab_tile.py):
    # throughput rides the tiles_per_sec rule above; drift vs the f32
    # oracle and the downstream probe delta are down-good
    ("cosine_drift", "down"),
    ("probe_delta_pt", "down"),
    # execution-plan autotuner (plan|autotune entry, scripts/autotune.py
    # via perf_history ingest --plan): the best blessed variant's
    # walltime rides the wall_s rule below; registry coverage of the
    # resolved geometries is up-good (a DROP means dispatch silently
    # fell back to flag/defaults on geometries that used to be planned)
    ("plan_hit_rate", "up"),
    # fleet-trace critical-path shares (dist|trace entry,
    # scripts/dist_smoke.py --fleet-json): time the slide spent on the
    # wire or blocked on credits is the regression; encode/fold shares
    # ride no rule (they trade against each other as the split moves)
    ("wire_share", "down"),
    ("backpressure_share", "down"),
    # embedding-drift sentinel (serve|drift entry, serve_smoke --drift):
    # drift scores vs the blessed baseline sketch are down-good; the
    # anytime-confidence cosines (first/last peek vs the finalized
    # embedding) are up-good — a DROP means the provisional surface got
    # less trustworthy at the same peek cadence
    ("drift_mean_shift", "down"),
    ("drift_cosine_dist", "down"),
    ("drift_tail_mass", "down"),
    ("confidence_first", "up"),
    ("confidence_last", "up"),
    # streaming-prefill decision-table rows (prefill|stream entry):
    # executable arg/temp/peak megabytes and stream-vs-dense ratios,
    # smaller is better
    ("_mb", "down"),
    ("temp_ratio", "down"),
    ("peak_ratio", "down"),
    ("vs_baseline", "up"),
    ("mfu", "up"),
    ("value", "up"),          # bench payload primary metric
    ("ok", "up"),             # multichip dryrun verdict
    ("donated_bytes", "up"),  # a LOST donation is the regression
    ("peak_hbm_gb", "down"),
    ("bytes", "down"),        # peak/temp/argument/output/accessed bytes
    ("bytes_accessed", "down"),
    ("flops", "down"),
    ("eqns_total", "down"),
    ("wall_s", "down"),
    ("sec_per_it", "down"),
)


def metric_direction(name: str) -> Optional[str]:
    for suffix, direction in _DIRECTION_RULES:
        if name == suffix or name.endswith(suffix):
            return direction
    return None


def _finite_number(value) -> Optional[float]:
    if isinstance(value, bool):
        return float(value)
    if isinstance(value, (int, float)) and math.isfinite(value):
        return float(value)
    return None


# ---------------------------------------------------------------------------
# document shape
# ---------------------------------------------------------------------------

def new_history() -> dict:
    return {"v": HISTORY_SCHEMA_VERSION, "entries": {}}


def load_history(path: str) -> dict:
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    if not isinstance(doc, dict) or "entries" not in doc:
        raise ValueError(f"{path}: not a perf history (no 'entries' object)")
    return doc


def write_history(doc: dict, path: str) -> str:
    """Canonical serialization (sorted keys, indent 1, no NaN — the same
    invariants as the ledger writer, for the same diffability reasons)."""
    parent = os.path.dirname(os.path.abspath(path))
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, sort_keys=True, allow_nan=False)
        f.write("\n")
    return path


def append_point(doc: dict, key: str, label: str, metrics: Dict[str, float],
                 *, source: Optional[str] = None, stale: bool = False,
                 note: Optional[str] = None, force: bool = False) -> dict:
    """Append one labeled point to ``entries[key]``. Append-only: an
    existing label under the same key raises unless ``force`` (which
    replaces it — for re-measured rounds, loudly opted into)."""
    entry = doc["entries"].setdefault(key, {"points": []})
    clean = {}
    for name, value in sorted(metrics.items()):
        num = _finite_number(value)
        if num is not None:
            clean[name] = num
    point = {"label": label, "metrics": clean}
    if source:
        point["source"] = source
    if stale:
        point["stale"] = True
    if note:
        point["note"] = note
    for i, p in enumerate(entry["points"]):
        if p.get("label") == label:
            if not force:
                raise ValueError(
                    f"{key}: label '{label}' already in history "
                    "(append-only; pass force to replace a re-measured "
                    "round)"
                )
            # replace IN PLACE: a force-re-ingested old round must keep
            # its chronological slot — appending it at the end would
            # make it the trend gate's "latest" candidate and mask real
            # regressions in the actual latest round
            entry["points"][i] = point
            return point
    entry["points"].append(point)
    return point


# ---------------------------------------------------------------------------
# snapshot / ledger folding
# ---------------------------------------------------------------------------

# bench payload fields worth trending (everything else in `parsed` is
# provenance prose)
_BENCH_METRICS = (
    "value", "vs_baseline", "train_tokens_per_sec", "mfu", "peak_hbm_gb",
    "tile_tiles_per_sec", "tile_mfu", "tile_vs_baseline",
)


def fold_bench(doc: dict, snapshot: dict, label: str,
               source: Optional[str] = None, force: bool = False) -> Optional[dict]:
    """One BENCH_rNN.json (or a raw bench payload) -> one point under
    ``bench|slide_embed``. A failed round (rc != 0, null/absent value, an
    ``error``, or ``stale: true``) lands as a STALE point: provenance
    kept, trend gate blind to it — an unmeasured round must never move
    the trend (the same invariant bench.py holds for its own snapshot)."""
    parsed = snapshot.get("parsed", snapshot)
    if not isinstance(parsed, dict):
        parsed = {}
    stale = bool(
        snapshot.get("rc", 0) != 0
        or parsed.get("error")
        or parsed.get("stale")
        or _finite_number(parsed.get("value")) is None
    )
    metrics = {
        k: parsed[k] for k in _BENCH_METRICS
        if _finite_number(parsed.get(k)) is not None
    }
    note = None
    if stale:
        note = str(parsed.get("error") or "round not measured")[:200]
        metrics = {}
    return append_point(
        doc, "bench|slide_embed", label, metrics, source=source,
        stale=stale, note=note, force=force,
    )


# serve_smoke payload fields worth trending (scripts/serve_smoke.py's
# JSON line; everything else is provenance)
_SERVE_METRICS = (
    "slides_per_sec", "occupancy_mean", "cache_hit_rate",
    "queue_wait_p50_s", "queue_wait_p90_s", "compile_seconds_total",
    "buckets_used", "dispatches",
)


def _fold_serve_snapshot(doc: dict, snapshot: dict, label: str, *,
                         key: str, metric_keys: Tuple[str, ...],
                         source: Optional[str], force: bool) -> dict:
    """The ONE smoke-snapshot staleness policy (shared by the serve
    throughput/latency entries and the dist boundary entry so the
    verdicts can never diverge): a
    failed run (rc != 0 / error) or a NON-CHIP backend lands STALE —
    CPU smoke numbers carry the metric KEYS for future on-chip rounds
    without ever moving the trend; a laptop's percentiles are not a
    perf baseline."""
    parsed = snapshot.get("parsed", snapshot)
    if not isinstance(parsed, dict):
        parsed = {}
    backend = str(parsed.get("backend", "")).lower()
    stale = bool(
        snapshot.get("rc", 0) != 0
        or parsed.get("error")
        or backend not in ("tpu", "gpu")
    )
    metrics = {
        k: parsed[k] for k in metric_keys
        if _finite_number(parsed.get(k)) is not None
    }
    note = None
    if stale:
        note = str(
            parsed.get("error")
            or f"backend={backend or '?'}: not an on-chip measurement"
        )[:200]
    return append_point(
        doc, key, label, metrics, source=source,
        stale=stale, note=note, force=force,
    )


def fold_serve(doc: dict, snapshot: dict, label: str,
               source: Optional[str] = None, force: bool = False) -> dict:
    """One serve_smoke JSON -> one point under ``serve|smoke``."""
    return _fold_serve_snapshot(
        doc, snapshot, label, key="serve|smoke",
        metric_keys=_SERVE_METRICS, source=source, force=force,
    )


# serve_smoke latency keys (the metrics-snapshot half of the payload —
# the tail-latency surface) worth trending separately from the
# throughput-shaped serve|smoke entry: the serving operating point
# (10^5-10^6 tiles/slide) is decided by the p99, not the mean
_SERVE_LATENCY_METRICS = (
    "e2e_p50_s", "e2e_p90_s", "e2e_p99_s",
    "dispatch_p50_s", "dispatch_p99_s",
    "queue_wait_p50_s", "queue_wait_p90_s", "queue_wait_p99_s",
)


def fold_serve_latency(doc: dict, snapshot: dict, label: str,
                       source: Optional[str] = None,
                       force: bool = False) -> dict:
    """One serve_smoke JSON -> one point under ``serve|latency`` (the
    tail-latency twin of :func:`fold_serve` — same shared staleness
    policy, different metric keys)."""
    return _fold_serve_snapshot(
        doc, snapshot, label, key="serve|latency",
        metric_keys=_SERVE_LATENCY_METRICS, source=source, force=force,
    )


# dist_smoke payload fields worth trending (scripts/dist_smoke.py's
# JSON line): boundary throughput, the cost of losing a worker, and the
# cost of surviving connection-level chaos on the TCP transport
_DIST_METRICS = (
    "chunks_per_sec", "clean_wall_s", "recover_extra_s",
    "reconnect_s", "consumer_recover_s",
    "workers", "chunks",
)


def fold_dist(doc: dict, snapshot: dict, label: str,
              source: Optional[str] = None, force: bool = False) -> dict:
    """One dist_smoke JSON -> one point under ``dist|smoke`` (the
    cross-stage boundary's trend entry — same shared staleness policy
    as the serve entries: a CPU dryrun carries the metric keys but
    never moves the trend)."""
    return _fold_serve_snapshot(
        doc, snapshot, label, key="dist|smoke",
        metric_keys=_DIST_METRICS, source=source, force=force,
    )


# dist_smoke --fleet-json payload fields worth trending (the fleet
# critical-path attribution over the merged cross-process timeline):
# slide throughput/wall plus the share of the slide's wall charged to
# each pipeline category by scripts/fleet_report.py's priority sweep
_FLEET_METRICS = (
    "chunks_per_sec", "slide_wall_s",
    "wire_share", "backpressure_share", "encode_share", "fold_share",
    "flows", "clock_links",
)


def fold_fleet(doc: dict, snapshot: dict, label: str,
               source: Optional[str] = None, force: bool = False) -> dict:
    """One ``dist_smoke --fleet-json`` JSON -> one point under
    ``dist|trace`` (the fleet-timeline twin of :func:`fold_dist` — same
    shared CPU-stale-with-keys policy: a CPU smoke carries the metric
    keys and share shapes, only an on-chip fleet moves the trend)."""
    return _fold_serve_snapshot(
        doc, snapshot, label, key="dist|trace",
        metric_keys=_FLEET_METRICS, source=source, force=force,
    )


# serve_smoke --drift payload fields worth trending (the model-health
# leg's JSON line): drift scores of the shifted phase vs the blessed
# baseline sketch, plus the anytime-confidence summary
_DRIFT_METRICS = (
    "drift_mean_shift", "drift_cosine_dist", "drift_tail_mass",
    "stream_confidence_first", "stream_confidence_last",
)


def fold_drift(doc: dict, snapshot: dict, label: str,
               source: Optional[str] = None, force: bool = False) -> dict:
    """One ``serve_smoke --drift`` JSON -> one point under
    ``serve|drift`` (the model-health twin of :func:`fold_serve` — same
    shared CPU-stale-with-keys policy: a CPU smoke carries the drift
    score and confidence KEYS for future on-chip rounds without ever
    moving the trend)."""
    return _fold_serve_snapshot(
        doc, snapshot, label, key="serve|drift",
        metric_keys=_DRIFT_METRICS, source=source, force=force,
    )


# long_context_smoke --stream payload fields worth trending: the
# streaming-vs-dense memory decision table (per-variant XLA
# memory-analysis MB + walltime) behind the adopt_chunked_prefill row
_PREFILL_METRICS = (
    "stream_arg_mb", "stream_temp_mb", "stream_peak_mb",
    "dense_arg_mb", "dense_temp_mb", "dense_peak_mb",
    "temp_ratio", "peak_ratio",
    "stream_wall_s", "dense_wall_s",
)


def fold_prefill(doc: dict, snapshot: dict, label: str,
                 source: Optional[str] = None, force: bool = False) -> dict:
    """One ``long_context_smoke --stream`` JSON -> one point under
    ``prefill|stream`` (same shared staleness policy as the serve/dist
    entries: a CPU measurement carries the metric keys but never moves
    the trend)."""
    return _fold_serve_snapshot(
        doc, snapshot, label, key="prefill|stream",
        metric_keys=_PREFILL_METRICS, source=source, force=force,
    )


# ab_tile payload fields worth trending (scripts/ab_tile.py's JSON):
# per-variant tile throughput, the int8/bf16 walltime ratio, and the
# parity numbers behind the adopt_quant_tile decision row
_TILE_METRICS = (
    # variant keys as ab_tile flattens them: '+' -> '_' on the variant
    # name, so the fp8 and attn-rider variants fold too
    "bf16_tiles_per_sec", "int8_tiles_per_sec", "fp8_e4m3_tiles_per_sec",
    "int8_attn_tiles_per_sec",
    "int8_over_bf16", "cosine_drift", "probe_delta_pt",
)


def fold_tile(doc: dict, snapshot: dict, label: str,
              source: Optional[str] = None, force: bool = False) -> dict:
    """One ``ab_tile`` JSON -> one point under ``tile|quant`` (the
    quantized tile tier's trend entry — same shared staleness policy as
    the serve/dist/prefill entries: a CPU parity run carries the metric
    KEYS but never moves the trend; only on-chip throughput does)."""
    return _fold_serve_snapshot(
        doc, snapshot, label, key="tile|quant",
        metric_keys=_TILE_METRICS, source=source, force=force,
    )


# autotune payload fields worth trending (scripts/autotune.py's JSON):
# the best variant's walltime next to the default's (the A/B the sweep
# exists for), registry hit rate over the geometries the sweep resolved,
# and the sweep's own coverage counters
_PLAN_METRICS = (
    "best_wall_s", "default_wall_s", "plan_hit_rate",
    "candidates", "gates_passed", "blessed",
)


def fold_plan(doc: dict, snapshot: dict, label: str,
              source: Optional[str] = None, force: bool = False) -> dict:
    """One ``autotune`` JSON -> one point under ``plan|autotune`` (the
    execution-plan autotuner's trend entry — same shared
    CPU-stale-with-keys policy as the serve/dist/prefill/tile entries:
    a CPU sweep carries the metric KEYS — and may bless memory-motivated
    plans — but only an on-chip sweep's walltimes move the trend)."""
    return _fold_serve_snapshot(
        doc, snapshot, label, key="plan|autotune",
        metric_keys=_PLAN_METRICS, source=source, force=force,
    )


# fold-surface sweep payload fields worth trending
# (scripts/autotune.py --surface fold): the blessed fold step's wall
# next to the jnp default's (the per-pair A/B), plus the same registry
# hit-rate / coverage counters as the dilated sweep
_FOLD_SWEEP_METRICS = (
    "best_wall_s", "default_wall_s", "plan_hit_rate",
    "candidates", "gates_passed", "blessed",
)


def fold_autotune(doc: dict, snapshot: dict, label: str,
                  source: Optional[str] = None, force: bool = False) -> dict:
    """One fold-surface ``autotune`` JSON (``--surface fold``) -> one
    point under ``plan|sweep``. Same shared CPU-stale-with-keys policy:
    a CPU sweep lands STALE carrying the metric keys (and may bless
    memory-motivated fold plans); only an on-chip sweep's fold-step
    walltimes (``*wall_s`` — down-good) move the trend."""
    return _fold_serve_snapshot(
        doc, snapshot, label, key="plan|sweep",
        metric_keys=_FOLD_SWEEP_METRICS, source=source, force=force,
    )


def fold_multichip(doc: dict, snapshot: dict, label: str,
                   source: Optional[str] = None, force: bool = False) -> dict:
    metrics = {
        "ok": 1.0 if snapshot.get("ok") else 0.0,
        "n_devices": snapshot.get("n_devices"),
    }
    stale = bool(snapshot.get("skipped"))
    return append_point(
        doc, "multichip|dryrun", label, metrics, source=source,
        stale=stale, force=force,
    )


def _flatten_ledger_entry(entry: dict) -> Dict[str, float]:
    """cost/memory/jaxpr sections of one ledger entry -> flat metrics
    (the same fields ``scripts/ledger_diff.py`` gates on)."""
    metrics: Dict[str, float] = {}
    cost = entry.get("cost") or {}
    for field in ("flops", "bytes_accessed"):
        num = _finite_number(cost.get(field))
        if num is not None:
            metrics[f"cost.{field}"] = num
    mem = entry.get("memory") or {}
    for field in ("peak_bytes", "temp_bytes", "argument_bytes",
                  "output_bytes", "donated_bytes"):
        num = _finite_number(mem.get(field))
        if num is not None:
            metrics[f"memory.{field}"] = num
    jaxpr = entry.get("jaxpr") or {}
    num = _finite_number(jaxpr.get("eqns_total"))
    if num is not None:
        metrics["jaxpr.eqns_total"] = num
    num = _finite_number(jaxpr.get("quant"))
    if num is not None:
        # recorded, not direction-gated: the quant eqn count changes
        # legitimately with the tier flag; ledger_diff pins it per-key
        metrics["jaxpr.quant"] = num
    num = _finite_number(jaxpr.get("mask"))
    if num is not None:
        # same policy as quant: the square-bool mask eqn count is a
        # per-key pin (0 for the Pallas fold tier), not a trend slope
        metrics["jaxpr.mask"] = num
    return metrics


def fold_ledger(doc: dict, ledger_doc: dict, label: str,
                source: Optional[str] = None, force: bool = False) -> int:
    """Every entry of a perf ledger -> one point per ledger key. Returns
    the number of points appended."""
    n = 0
    for key, entry in sorted((ledger_doc.get("entries") or {}).items()):
        metrics = _flatten_ledger_entry(entry)
        if not metrics:
            continue
        append_point(doc, key, label, metrics, source=source, force=force)
        n += 1
    return n


# ---------------------------------------------------------------------------
# trend verdict (ledger_diff-shaped)
# ---------------------------------------------------------------------------

def _fresh_points(entry: dict) -> List[dict]:
    return [p for p in entry.get("points", []) if not p.get("stale")]


def trend_verdict(doc: dict, *, rel_tol: float = 0.05,
                  baseline: str = "best") -> dict:
    """Judge each entry's latest non-stale point against its history.

    ``baseline="best"`` holds the candidate to the best value ever
    recorded per metric (the regression gate: past wins are never
    silently given back); ``"prev"`` compares to the immediately
    preceding non-stale point (the round-over-round delta view).
    Improvements never fail the verdict. The payload mirrors
    ``scripts/ledger_diff.py`` so consumers read ONE decision shape:
    ``decision.ok``, ``decision.regressed``, per-entry rows.
    """
    entries: Dict[str, List[dict]] = {}
    regressions: List[str] = []
    improvements: List[str] = []
    notes: List[str] = []
    for key in sorted(doc.get("entries", {})):
        fresh = _fresh_points(doc["entries"][key])
        if not fresh:
            notes.append(f"{key}: no measured (non-stale) points")
            continue
        if len(fresh) < 2:
            notes.append(f"{key}: single measured point — no trend yet")
            continue
        cand = fresh[-1]
        prior = fresh[:-1]
        rows: List[dict] = []
        for name, value in sorted(cand.get("metrics", {}).items()):
            direction = metric_direction(name)
            if direction is None:
                continue
            prior_vals = [
                (p.get("label"), p["metrics"][name])
                for p in prior if name in p.get("metrics", {})
            ]
            if not prior_vals:
                continue
            if baseline == "prev":
                base_label, base = prior_vals[-1]
            else:
                pick = max if direction == "up" else min
                base_label, base = pick(prior_vals, key=lambda lv: lv[1])
            # direction "up" = bigger is better, so a DECREASE is the
            # regression; normalize so delta > 0 always means "moved in
            # the regression direction"
            delta = (base - value) if direction == "up" else (value - base)
            tol = rel_tol * abs(base)
            if delta > tol:
                verdict = "regression"
            elif delta < -tol:
                verdict = "improvement"
            else:
                verdict = "ok"
            if verdict == "ok":
                continue
            row = {
                "metric": name, "baseline": base,
                "baseline_label": base_label,
                "candidate": value, "candidate_label": cand.get("label"),
                "verdict": verdict,
            }
            if base:
                row["ratio"] = round(value / base, 4)
            rows.append(row)
            line = (f"{key}: {name} {base} ({base_label}) -> {value} "
                    f"({cand.get('label')})")
            (regressions if verdict == "regression" else improvements).append(
                line
            )
        if rows:
            entries[key] = rows
    return {
        "metric": "perf_history",
        "thresholds": {"rel_tol": rel_tol, "baseline": baseline},
        "history_entries": len(doc.get("entries", {})),
        "entries": entries,
        "notes": notes,
        "decision": {
            "regressions": len(regressions),
            "improvements": len(improvements),
            "regressed": regressions,
            "improved": improvements,
            "ok": not regressions,
        },
    }
