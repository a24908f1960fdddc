"""Fleet assembly: one timeline from many processes' obs artifacts.

The port's copy of ``gigapath_tpu/obs/fleet.py`` (host-side Python: no torch
or jax here), names and event schema unchanged.

A disaggregated run leaves one obs artifact set PER PROCESS — a runlog
JSONL, a ``<stem>.trace.json`` Perfetto export (``obs/reqtrace.py``),
and final ``metrics`` snapshots — all sharing one ``GIGAPATH_OBS_RUN_ID``.
Each export's span timestamps are microseconds past that process's OWN
``time.monotonic()`` origin, so the per-process files are mutually
untranslatable until the per-link clock offsets (``obs/clock.py``,
recorded as ``clock_sync`` events by each producer) are applied. This
module is the one place that does the join:

- :class:`FleetTimeline` — loads every artifact for a run id
  (:meth:`FleetTimeline.from_dir`), converts each process's spans onto
  the CONSUMER's clock (the fleet reference: consumers emit no
  ``clock_sync`` and sit at offset 0; each producer's last ``clock_sync``
  carries its link's epoch-best offset), and exposes:

  * :meth:`perfetto` — one merged Chrome-trace doc: one ``pid`` track
    group per process (named), all spans rebased onto the reference
    axis, and flow arrows (``ph: "s"`` / ``ph: "f"``) from each
    producer ``send`` span to the consumer span that named it as
    ``parent_span_id`` — the cross-process causal edges drawn as
    arrows in https://ui.perfetto.dev.
  * :meth:`critical_path` — per-slide attribution: the slide's wall is
    swept once and every instant is charged to exactly one category
    (``finalize > fold > checkpoint > deliver > wire > backpressure >
    encode > idle``, consumer-side work outranking producer-side
    because the consumer is the serial resource), so the shares sum to
    the makespan BY CONSTRUCTION. ``wire`` is the synthetic per-chunk
    interval [producer ``send`` end, consumer ``deliver`` start] on the
    reference axis. The straggler link is the producer charging the
    most wire + backpressure time.
  * :meth:`invariants` — merged-timeline sanity: no negative-duration
    span, no span starting before its causal parent, and per-chunk
    causality ``send end <= deliver start`` within the measured clock
    uncertainty of the two processes (plus a slack for scheduler
    jitter). A violation here means the clock correction is wrong, not
    the pipeline.
  * :meth:`orphans` — spans whose ``parent_span_id`` resolves to no
    exported span. NOT an invariant: a kill -9'd producer never runs
    its export closer, so its delivered chunks legitimately point at a
    missing doc. A CLEAN run asserts this list is empty
    (``scripts/dist_smoke.py``'s ``fleet_trace`` check).
  * :meth:`health` — fleet roll-up: per-link channel telemetry from
    each process's final ``metrics`` snapshot (``dist.link.*``
    instruments), clock estimates per link, loss-event counts.

``scripts/fleet_report.py`` is the CLI face. Pure stdlib — no jax, no
numpy — like the rest of the obs bus; safe to run on a laptop against
artifacts scp'd from the fleet.
"""

from __future__ import annotations

import glob as _glob
import json
import os
from typing import Any, Dict, List, Optional, Tuple

from gigapath_tpu_torch.obs.reqtrace import TRACE_FILE_SUFFIX

# causality tolerance added on top of the measured clock uncertainty:
# covers scheduler jitter between a span's clock read and the actual
# hand-off, which the NTP bound cannot see
DEFAULT_SLACK_S = 0.005

# critical-path priority, highest first; every swept instant is charged
# to the highest-priority category covering it (idle when none does)
CATEGORIES = ("finalize", "fold", "checkpoint", "deliver", "wire",
              "backpressure", "encode", "idle")

# span name -> sweep category ("wire" and "idle" are synthetic)
_CATEGORY_BY_NAME = {
    "dist.finalize": "finalize",
    "finalize": "finalize",
    "dist.fold": "fold",
    "fold": "fold",
    "dist.checkpoint": "checkpoint",
    "deliver": "deliver",
    "backpressure_wait": "backpressure",
    "dist.encode": "encode",
}


class FleetSpan:
    """One span on the REFERENCE (consumer-monotonic) axis."""

    __slots__ = ("process", "tid", "name", "t0", "t1", "span_id",
                 "parent_id", "chunk", "actor", "trace_id", "status",
                 "args")

    def __init__(self, process: str, tid: int, name: str, t0: float,
                 t1: float, args: Dict[str, Any]):
        self.process = process
        self.tid = int(tid)
        self.name = name
        self.t0 = float(t0)
        self.t1 = float(t1)
        self.span_id = str(args.get("span_id", "") or "")
        self.parent_id = str(args.get("parent_span_id", "") or "")
        chunk = args.get("chunk")
        self.chunk: Optional[int] = int(chunk) if chunk is not None else None
        self.actor = str(args.get("actor", "") or "")
        self.trace_id = str(args.get("trace_id", "") or "")
        self.status = str(args.get("status", "") or "")
        self.args = args

    @property
    def dur_s(self) -> float:
        return self.t1 - self.t0


class ProcessDoc:
    """One process's contribution: parsed trace export + runlog events,
    with the link clock offset that lands its spans on the reference
    axis (consumer = offset 0)."""

    def __init__(self, label: str, doc: Optional[dict] = None,
                 events: Optional[List[dict]] = None,
                 offset_s: Optional[float] = None,
                 uncertainty_s: Optional[float] = None,
                 path: str = ""):
        self.label = label
        self.doc = doc
        self.events = events or []
        self.path = path
        self.clock_syncs = [e for e in self.events
                            if e.get("kind") == "clock_sync"]
        if offset_s is None:
            # the producer's LAST clock_sync carries the epoch-best
            # estimate for the current connection; a process that never
            # emitted one IS the reference (the consumer) -> offset 0
            last = self.clock_syncs[-1] if self.clock_syncs else None
            offset_s = float(last.get("offset_s", 0.0)) if last else 0.0
            if uncertainty_s is None:
                uncertainty_s = (float(last.get("uncertainty_s", 0.0))
                                 if last else 0.0)
        self.offset_s = float(offset_s)
        self.uncertainty_s = float(uncertainty_s or 0.0)
        meta = (doc or {}).get("metadata", {})
        self.t0_monotonic = float(
            (meta.get("clock") or {}).get("t0_monotonic", 0.0))
        self.pid = meta.get("pid")
        self.host = meta.get("host", "")
        self.spans: List[FleetSpan] = []
        self.envelopes: List[dict] = []   # "request" X events, kept for UI
        self.thread_names: Dict[int, str] = {}
        for ev in (doc or {}).get("traceEvents", []):
            ph = ev.get("ph")
            if ph == "M" and ev.get("name") == "thread_name":
                self.thread_names[int(ev.get("tid", 0))] = str(
                    (ev.get("args") or {}).get("name", ""))
                continue
            if ph != "X":
                continue
            t0 = self.t0_monotonic + float(ev.get("ts", 0.0)) / 1e6 \
                + self.offset_s
            t1 = t0 + float(ev.get("dur", 0.0)) / 1e6
            args = dict(ev.get("args") or {})
            if ev.get("name") == "request":
                self.envelopes.append({"tid": int(ev.get("tid", 0)),
                                       "t0": t0, "t1": t1, "args": args})
                continue
            self.spans.append(FleetSpan(label, int(ev.get("tid", 0)),
                                        str(ev.get("name", "")), t0, t1,
                                        args))

    def final_metrics(self) -> Optional[dict]:
        """The process's LAST ``metrics`` event (the final-flush snapshot
        rides the runlog closers, so the last one is the run total)."""
        snap = None
        for ev in self.events:
            if ev.get("kind") == "metrics":
                snap = ev
        return snap

    def link_metrics(self) -> Dict[str, Dict[str, float]]:
        """``dist.link.{link}.{metric}`` instruments from the final
        snapshot, folded as ``{link: {metric: value}}``."""
        snap = self.final_metrics()
        out: Dict[str, Dict[str, float]] = {}
        if snap is None:
            return out
        for group in ("counters", "gauges"):
            for name, value in (snap.get(group) or {}).items():
                if not name.startswith("dist.link."):
                    continue
                link, _, metric = name[len("dist.link."):].rpartition(".")
                if not link:
                    continue
                out.setdefault(link, {})[metric] = value
        return out


def _read_jsonl(path: str) -> List[dict]:
    """Tolerant JSONL read: a torn final line (process killed mid-write)
    is skipped, not fatal — post-mortem assembly is the point."""
    events: List[dict] = []
    try:
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue
                if isinstance(ev, dict):
                    events.append(ev)
    except OSError:
        pass
    return events


def _merge_intervals(ivs: List[Tuple[float, float]]
                     ) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for t0, t1 in sorted(ivs):
        if t1 <= t0:
            continue
        if out and t0 <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t1))
        else:
            out.append((t0, t1))
    return out


class FleetTimeline:
    """The assembled fleet view (see module docstring)."""

    def __init__(self, processes: List[ProcessDoc], run_id: str = ""):
        self.run_id = run_id
        self.processes = processes
        self.spans: List[FleetSpan] = []
        for proc in processes:
            self.spans.extend(proc.spans)
        self._by_id: Dict[str, FleetSpan] = {}
        for sp in self.spans:
            if sp.span_id and sp.span_id not in self._by_id:
                self._by_id[sp.span_id] = sp

    # -- loading ----------------------------------------------------------
    @classmethod
    def from_dir(cls, obs_dir: str, run_id: str) -> "FleetTimeline":
        """Load every ``{run_id}*`` artifact in ``obs_dir``: trace
        exports with their sibling JSONLs, plus JSONL-only processes (a
        killed worker leaves no export but its events still count for
        health)."""
        pattern = os.path.join(obs_dir, _glob.escape(run_id) + "*")
        trace_paths = sorted(p for p in _glob.glob(pattern + TRACE_FILE_SUFFIX))
        jsonl_paths = sorted(p for p in _glob.glob(pattern + ".jsonl"))
        procs: List[ProcessDoc] = []
        claimed = set()
        for tpath in trace_paths:
            stem = tpath[:-len(TRACE_FILE_SUFFIX)]
            jpath = stem + ".jsonl"
            claimed.add(jpath)
            try:
                with open(tpath, "r", encoding="utf-8") as fh:
                    doc = json.load(fh)
            except (OSError, ValueError):
                continue
            events = _read_jsonl(jpath)
            procs.append(ProcessDoc(_label_for(stem, run_id, doc), doc=doc,
                                    events=events, path=tpath))
        for jpath in jsonl_paths:
            if jpath in claimed:
                continue
            stem = jpath[:-len(".jsonl")]
            procs.append(ProcessDoc(_label_for(stem, run_id, None),
                                    events=_read_jsonl(jpath), path=jpath))
        return cls(procs, run_id=run_id)

    @classmethod
    def from_parts(cls, parts: List[dict], run_id: str = "") -> "FleetTimeline":
        """Assemble from in-memory pieces (tests, ad-hoc tooling): each
        part is ``{"label", "doc", "events"?, "offset_s"?,
        "uncertainty_s"?}`` — explicit offsets win over the events'
        ``clock_sync`` record."""
        procs = [ProcessDoc(p["label"], doc=p.get("doc"),
                            events=p.get("events"),
                            offset_s=p.get("offset_s"),
                            uncertainty_s=p.get("uncertainty_s"))
                 for p in parts]
        return cls(procs, run_id=run_id)

    # -- structure --------------------------------------------------------
    def slides(self) -> Dict[str, List[FleetSpan]]:
        """Spans grouped by fleet trace id (one group per slide)."""
        out: Dict[str, List[FleetSpan]] = {}
        for sp in self.spans:
            if sp.trace_id:
                out.setdefault(sp.trace_id, []).append(sp)
        return out

    def resolve(self, span_id: str) -> Optional[FleetSpan]:
        return self._by_id.get(span_id)

    def orphans(self) -> List[FleetSpan]:
        """Spans naming a parent that no loaded doc exported (normal
        after a kill -9 — the dead producer never ran its export closer;
        must be EMPTY for a clean run)."""
        return [sp for sp in self.spans
                if sp.parent_id and sp.parent_id not in self._by_id]

    def wire_intervals(self, trace_id: Optional[str] = None
                       ) -> List[Tuple[FleetSpan, FleetSpan, float, float]]:
        """Per-chunk (send, deliver, t0, t1) wire transits on the
        reference axis: consumer ``deliver`` spans joined to the
        producer ``send`` they name as parent. Negative transits (clock
        error inside the uncertainty bound) clamp to empty at the
        deliver start so downstream math never sees time running
        backwards."""
        out = []
        for sp in self.spans:
            if sp.name != "deliver" or not sp.parent_id:
                continue
            if trace_id is not None and sp.trace_id != trace_id:
                continue
            parent = self._by_id.get(sp.parent_id)
            if parent is None or parent.name != "send":
                continue
            t0 = min(parent.t1, sp.t0)
            out.append((parent, sp, t0, sp.t0))
        return out

    # -- invariants -------------------------------------------------------
    def _tol(self, a: FleetSpan, b: FleetSpan, slack: float) -> float:
        by_label = {p.label: p.uncertainty_s for p in self.processes}
        return (by_label.get(a.process, 0.0) + by_label.get(b.process, 0.0)
                + slack)

    def invariants(self, slack_s: float = DEFAULT_SLACK_S) -> List[str]:
        """Merged-timeline sanity violations (empty list = healthy):
        negative durations, spans starting before their causal parent,
        and per-chunk ``send end <= deliver start`` outside the combined
        clock uncertainty + ``slack_s``."""
        bad: List[str] = []
        for sp in self.spans:
            if sp.t1 < sp.t0:
                bad.append(f"negative-duration span {sp.span_id or sp.name} "
                           f"({sp.dur_s:.6f}s) in {sp.process}")
        for sp in self.spans:
            if not sp.parent_id:
                continue
            parent = self._by_id.get(sp.parent_id)
            if parent is None:
                continue  # orphan, reported separately
            tol = self._tol(parent, sp, slack_s)
            if parent.name == "send":
                # hand-off semantics: the chunk cannot be delivered
                # before the producer finished sending it
                if sp.t0 < parent.t1 - tol:
                    bad.append(
                        f"causality: {sp.name} c{sp.chunk} starts "
                        f"{parent.t1 - sp.t0:.6f}s before parent send ends "
                        f"(tol {tol:.6f}s, link {parent.process}->"
                        f"{sp.process})")
            elif sp.t0 < parent.t0 - tol:
                bad.append(
                    f"parent-exceeding: {sp.name} starts "
                    f"{parent.t0 - sp.t0:.6f}s before parent "
                    f"{parent.name} (tol {tol:.6f}s)")
        return bad

    # -- critical path ----------------------------------------------------
    def critical_path(self, trace_id: Optional[str] = None) -> Dict[str, dict]:
        """Per-slide attribution table. Every instant of the slide's
        makespan is charged to exactly one category (priority in
        :data:`CATEGORIES`), so ``sum(seconds.values()) == wall_s``
        by construction and the shares are honest."""
        out: Dict[str, dict] = {}
        for tid, spans in sorted(self.slides().items()):
            if trace_id is not None and tid != trace_id:
                continue
            t_lo = min(sp.t0 for sp in spans)
            t_hi = max(sp.t1 for sp in spans)
            wall = max(t_hi - t_lo, 0.0)
            ivs: Dict[str, List[Tuple[float, float]]] = {
                c: [] for c in CATEGORIES}
            for sp in spans:
                cat = _CATEGORY_BY_NAME.get(sp.name)
                if cat is not None:
                    ivs[cat].append((sp.t0, sp.t1))
            wires = self.wire_intervals(tid)
            for _, _, w0, w1 in wires:
                ivs["wire"].append((w0, w1))
            merged = {c: _merge_intervals(v) for c, v in ivs.items()}
            points = sorted({t_lo, t_hi} | {
                t for v in merged.values() for iv in v for t in iv
                if t_lo <= t <= t_hi})
            seconds = {c: 0.0 for c in CATEGORIES}
            for a, b in zip(points, points[1:]):
                if b <= a:
                    continue
                mid = (a + b) / 2.0
                for cat in CATEGORIES[:-1]:
                    if any(t0 <= mid < t1 for t0, t1 in merged[cat]):
                        seconds[cat] += b - a
                        break
                else:
                    seconds["idle"] += b - a
            # straggler: the producer link charging the most wire +
            # backpressure (the slowest hand-off dominates the makespan)
            per_producer: Dict[str, float] = {}
            for send, _, w0, w1 in wires:
                key = send.actor or send.process
                per_producer[key] = per_producer.get(key, 0.0) + (w1 - w0)
            for sp in spans:
                if sp.name == "backpressure_wait":
                    key = sp.actor or sp.process
                    per_producer[key] = per_producer.get(key, 0.0) + sp.dur_s
            straggler = max(per_producer, key=per_producer.get) \
                if per_producer else None
            out[tid] = {
                "wall_s": round(wall, 6),
                "seconds": {c: round(s, 6) for c, s in seconds.items()},
                "shares": {c: round(s / wall, 4) if wall > 0 else 0.0
                           for c, s in seconds.items()},
                "chunks": sum(1 for sp in spans if sp.name == "deliver"),
                "straggler": straggler,
                "recovery_gaps": sum(1 for sp in spans
                                     if sp.name == "recovery_gap"),
            }
        return out

    # -- merged perfetto doc ----------------------------------------------
    def perfetto(self) -> dict:
        """One Chrome-trace doc: per-process ``pid`` track groups, all
        timestamps rebased onto the fleet origin (earliest reference
        instant), flow arrows on every resolved cross-process parent
        edge."""
        times = [sp.t0 for sp in self.spans] + [
            env["t0"] for p in self.processes for env in p.envelopes]
        origin = min(times) if times else 0.0

        def us(t: float) -> float:
            return round((t - origin) * 1e6, 1)

        events: List[dict] = []
        pid_of: Dict[str, int] = {}
        for i, proc in enumerate(self.processes):
            pid = i + 1
            pid_of[proc.label] = pid
            if proc.doc is None and not proc.events:
                continue
            events.append({"ph": "M", "pid": pid, "tid": 0,
                           "name": "process_name",
                           "args": {"name": proc.label}})
            for tid, tname in sorted(proc.thread_names.items()):
                events.append({"ph": "M", "pid": pid, "tid": tid,
                               "name": "thread_name",
                               "args": {"name": tname}})
            for env in proc.envelopes:
                events.append({"ph": "X", "pid": pid, "tid": env["tid"],
                               "name": "request", "ts": us(env["t0"]),
                               "dur": max(us(env["t1"]) - us(env["t0"]), 0.0),
                               "args": env["args"]})
            for sp in proc.spans:
                events.append({"ph": "X", "pid": pid, "tid": sp.tid,
                               "name": sp.name, "ts": us(sp.t0),
                               "dur": max(round(sp.dur_s * 1e6, 1), 0.0),
                               "args": sp.args})
        flow_id = 0
        for sp in self.spans:
            parent = self._by_id.get(sp.parent_id) if sp.parent_id else None
            if parent is None or parent.process == sp.process:
                continue
            flow_id += 1
            events.append({"ph": "s", "id": flow_id, "pid":
                           pid_of[parent.process], "tid": parent.tid,
                           "ts": us(parent.t1), "name": "chunk",
                           "cat": "fleet"})
            events.append({"ph": "f", "bp": "e", "id": flow_id, "pid":
                           pid_of[sp.process], "tid": sp.tid,
                           "ts": us(sp.t0), "name": "chunk",
                           "cat": "fleet"})
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "metadata": {"run": self.run_id,
                             "source": "gigapath_tpu_torch.obs.fleet",
                             "processes": [p.label for p in self.processes],
                             "flows": flow_id}}

    # -- health -----------------------------------------------------------
    def health(self) -> dict:
        """Fleet roll-up for the report CLIs: per-link channel telemetry
        (final snapshots), per-link clock estimates, loss events."""
        links: Dict[str, Dict[str, float]] = {}
        for proc in self.processes:
            for link, metrics in proc.link_metrics().items():
                links.setdefault(link, {}).update(metrics)
        clocks = {}
        for proc in self.processes:
            if not proc.clock_syncs:
                continue
            last = proc.clock_syncs[-1]
            clocks[str(last.get("link", proc.label))] = {
                "offset_s": float(last.get("offset_s", 0.0)),
                "uncertainty_s": float(last.get("uncertainty_s", 0.0)),
                "epoch": int(last.get("epoch", 0)),
                "samples": int(last.get("samples", 0)),
                "process": proc.label,
            }
        losses = {"worker_lost": 0, "consumer_lost": 0}
        for proc in self.processes:
            for ev in proc.events:
                kind = ev.get("kind")
                if kind in losses:
                    losses[kind] += 1
        return {
            "run": self.run_id,
            "processes": [p.label for p in self.processes],
            "spans": len(self.spans),
            "slides": len(self.slides()),
            "orphans": len(self.orphans()),
            "links": links,
            "clocks": clocks,
            **losses,
        }


def _label_for(stem: str, run_id: str, doc: Optional[dict]) -> str:
    """Process track label: the launcher's ``GIGAPATH_TRACE_ACTOR``
    (exported in the doc metadata) wins; else the shared-run-id filename
    suffix (``-<host>-p<pid>``); else the pid."""
    meta = (doc or {}).get("metadata", {})
    actor = str(meta.get("actor", "") or "")
    if actor:
        return actor
    base = os.path.basename(stem)
    if base.startswith(run_id) and len(base) > len(run_id):
        return base[len(run_id):].lstrip("-") or base
    pid = meta.get("pid")
    return f"p{pid}" if pid is not None else base


__all__ = [
    "CATEGORIES",
    "DEFAULT_SLACK_S",
    "FleetSpan",
    "FleetTimeline",
    "ProcessDoc",
]
