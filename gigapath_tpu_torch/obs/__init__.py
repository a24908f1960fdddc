"""Run-scoped observability for the port (counterpart of
``gigapath_tpu/obs``): the part of the obs core that the serving stack and
the inference CLI reach.

- :mod:`~gigapath_tpu_torch.obs.runlog` — ``RunLog`` / ``NullRunLog`` / the
  ``get_run_log`` env-gated factory, ``fail_run`` and the ``console`` sink;
- :mod:`~gigapath_tpu_torch.obs.watchdog` — ``CompileWatchdog`` (graph
  captures and kernel builds as compile events);
- :mod:`~gigapath_tpu_torch.obs.heartbeat` — ``Heartbeat`` liveness/stall
  monitor, device-memory watermarks from ``torch.cuda.memory_stats``;
- :mod:`~gigapath_tpu_torch.obs.ledger` — the per-run perf ledger: each
  profile (op fingerprint, cost, memory) taken on one real call;
- :mod:`~gigapath_tpu_torch.obs.spans` — nestable ``span`` (a fence waits
  for the fenced tensors' device) and the ``torch.profiler`` passthroughs;
- :mod:`~gigapath_tpu_torch.obs.anomaly` / :mod:`~gigapath_tpu_torch.obs.flight`
  — the anomaly engine and the flight recorder;
- :mod:`~gigapath_tpu_torch.obs.metrics` — typed metrics registry and the
  ``SloTracker``;
- :mod:`~gigapath_tpu_torch.obs.reqtrace` — end-to-end request tracing;
- :mod:`~gigapath_tpu_torch.obs.locktrace` — the lock-order sanitizer's
  lock factories.

Fold a run's JSONL into a report with ``scripts/obs_report.py``.
"""

from gigapath_tpu_torch.obs.anomaly import (
    AnomalyConfig,
    AnomalyEngine,
    NullAnomalyEngine,
    attach_anomaly_engine,
)
from gigapath_tpu_torch.obs.flight import FlightRecorder
from gigapath_tpu_torch.obs.heartbeat import Heartbeat, memory_watermarks
from gigapath_tpu_torch.obs.ledger import (
    LEDGER_SCHEMA_VERSION,
    NullLedger,
    PerfLedger,
    get_ledger,
)
from gigapath_tpu_torch.obs.metrics import (
    Histogram,
    MetricsRegistry,
    NullMetricsRegistry,
    NullSloTracker,
    SloTracker,
    get_metrics,
    merge_snapshots,
    percentile,
)
from gigapath_tpu_torch.obs.reqtrace import (
    RequestTrace,
    TraceCollector,
    get_tracer,
)
from gigapath_tpu_torch.obs.runlog import (
    EVENT_KINDS,
    SCHEMA_VERSION,
    NullRunLog,
    RunLog,
    console,
    fail_run,
    get_run_log,
)
from gigapath_tpu_torch.obs.spans import (
    Span,
    annotate,
    named_scope,
    span,
    start_trace,
    stop_trace,
    trace,
)
from gigapath_tpu_torch.obs.watchdog import CompileWatchdog

__all__ = [
    "EVENT_KINDS",
    "LEDGER_SCHEMA_VERSION",
    "SCHEMA_VERSION",
    "AnomalyConfig",
    "AnomalyEngine",
    "CompileWatchdog",
    "FlightRecorder",
    "Heartbeat",
    "Histogram",
    "MetricsRegistry",
    "NullAnomalyEngine",
    "NullLedger",
    "NullMetricsRegistry",
    "NullRunLog",
    "NullSloTracker",
    "PerfLedger",
    "RequestTrace",
    "RunLog",
    "SloTracker",
    "Span",
    "TraceCollector",
    "annotate",
    "attach_anomaly_engine",
    "console",
    "fail_run",
    "get_ledger",
    "get_metrics",
    "get_run_log",
    "get_tracer",
    "memory_watermarks",
    "merge_snapshots",
    "named_scope",
    "percentile",
    "span",
    "start_trace",
    "stop_trace",
    "trace",
]
