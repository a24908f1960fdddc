"""Nestable host-side spans: honest wall timing as obs events (the port's
counterpart of ``gigapath_tpu/obs/spans.py``).

A ``span`` brackets a region of driver code and lands one ``span`` event
(schema v1) in the run's JSONL when it closes:

    with span("epoch", runlog, epoch=3):
        with span("step", runlog, fence=True) as sp:
            out = step_fn(model, batch)
            sp.fence(out)          # the device waits for out at span exit

Fields: ``name``, ``path`` (dotted nesting, e.g. ``epoch/step``),
``depth``, ``dur_s`` (``time.monotonic`` delta), ``fenced``, ``rank``
(the ``torch.distributed`` rank when a process group is initialised,
else 0), plus any free-form keyword fields.

Why ``fence``: CUDA launches return before the kernels run, so a
wall-clock delta around a forward measures the launches. ``fence=True``
makes the span wait, before it reads the clock, for the devices of every
tensor registered via :meth:`Span.fence` (or passed directly as
``fence=value``): ``torch.cuda.synchronize(device)`` once per CUDA device;
tensors on the CPU need no wait.

Zero-overhead contract: against a :class:`~gigapath_tpu_torch.obs.runlog.NullRunLog`
(``GIGAPATH_OBS=0``) a span is a true no-op: no event, no clock reads, no
profiler annotation, and no fence.

The ``torch.profiler`` passthroughs live here too: :func:`trace` /
:func:`start_trace` / :func:`stop_trace` capture a profiler trace (a
Chrome-trace JSON under the given directory), :func:`annotate` and
:func:`named_scope` name a host region inside one
(``torch.profiler.record_function``), :func:`ring_step` names one step of
a ring schedule, and ``span(..., annotate=True)``
nests such a region so obs spans and profiler traces line up.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, List, Optional

_PROFILER = None  # the open-ended capture of start_trace, with its directory
_PROFILER_DIR: Optional[str] = None


@contextlib.contextmanager
def trace(log_dir: str, *, create_perfetto_link: bool = False):
    """Capture a profiler trace of the enclosed block into ``log_dir``."""
    start_trace(log_dir, create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        stop_trace()


def start_trace(log_dir: str, *, create_perfetto_link: bool = False) -> None:
    """The sanctioned open-ended trace start: a ``torch.profiler.profile``
    of the host and, where CUDA is available, the device, until
    :func:`stop_trace` writes it to ``<log_dir>/trace.json``. The anomaly
    engine's triggered capture is the open-ended case: it starts on a
    firing detector and stops K step events later. ``create_perfetto_link``
    is accepted for the JAX signature and ignored."""
    global _PROFILER, _PROFILER_DIR
    import torch

    if _PROFILER is not None:
        raise RuntimeError("a profiler trace is already running")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    _PROFILER, _PROFILER_DIR = prof, log_dir


def stop_trace() -> None:
    """Close the trace opened by :func:`start_trace` and write it."""
    global _PROFILER, _PROFILER_DIR
    prof, log_dir = _PROFILER, _PROFILER_DIR
    _PROFILER = _PROFILER_DIR = None
    if prof is None:
        raise RuntimeError("no profiler trace is running")
    prof.__exit__(None, None, None)
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _record_function(name: str):
    import torch

    return torch.profiler.record_function(name)


def annotate(name: str):
    """Named host region inside a trace (``with annotate("collate"): ...``)."""
    return _record_function(name)


def named_scope(name: str):
    """The JAX package's ``jax.named_scope`` seam: a named region of the
    launched work inside a profiler trace."""
    return _record_function(name)


def ring_step(step: int, total: int, comm_bytes: int):
    """A named region for one step of a ring schedule, under the JAX
    package's name ``ring_step_{step+1}of{total}_comm{bytes}B``
    (``comm_bytes``: what the step's exchange moves per rank), so a
    profiler trace groups each step's launches and its collective."""
    return _record_function(f"ring_step_{step + 1}of{total}_comm{comm_bytes}B")


_RANK: Optional[int] = None

# span-event schema keys; caller fields colliding with these are emitted
# under a "field_" prefix instead of crashing the emitting finally block
_RESERVED_SPAN_KEYS = (
    "name", "path", "depth", "dur_s", "fenced", "rank", "status",
    "fence_error",
)


def process_index() -> int:
    """The ``torch.distributed`` rank once a process group is initialised
    (cached then), else 0; never raises."""
    global _RANK
    if _RANK is not None:
        return _RANK
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            _RANK = int(dist.get_rank())
            return _RANK
    except Exception:
        pass
    return 0


def fence_devices(values: List[Any]) -> None:
    """Wait for the devices of every CUDA tensor in ``values`` (nested
    lists, tuples and dicts are walked); CPU tensors and other values need
    no wait."""
    devices = set()

    def walk(v):
        if isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)
        else:
            dev = getattr(v, "device", None)
            if dev is not None and getattr(dev, "type", None) == "cuda":
                devices.add(dev)

    walk(values)
    if devices:
        import torch

        for dev in devices:
            torch.cuda.synchronize(dev)


class _SpanStack(threading.local):
    def __init__(self):
        self.names: List[str] = []


_STACK = _SpanStack()


class Span:
    """Live span handle yielded by :func:`span`.

    ``dur_s`` is populated at exit (None until then, and always None for
    the no-op span), so drivers can reuse the span's measurement::

        with span("step", runlog, fence=True) as sp:
            out = step_fn(...)
            sp.fence(out)
        runlog.step(i, wall_s=sp.dur_s, synced=True)
    """

    __slots__ = ("name", "fenced", "dur_s", "_fence_values", "_fields")

    def __init__(self, name: str, fenced: bool):
        self.name = name
        self.fenced = fenced
        self.dur_s: Optional[float] = None
        self._fence_values: List[Any] = []
        self._fields: dict = {}

    def fence(self, value: Any) -> Any:
        """Register a value whose device is waited for at span exit (only
        honored when the span was opened with ``fence=...``); returns the
        value so it can be used inline."""
        self._fence_values.append(value)
        return value

    def note(self, **fields) -> None:
        """Attach free-form fields to the span event."""
        self._fields.update(fields)


class _NullSpan(Span):
    """Absorbs fence()/note() without recording anything."""

    def fence(self, value: Any) -> Any:
        return value

    def note(self, **fields) -> None:
        return None


_NULL_SPAN = _NullSpan("null", fenced=False)


def _is_recording(runlog) -> bool:
    # RunLog always has a file path; NullRunLog (and None) does not.
    return runlog is not None and getattr(runlog, "path", None) is not None


@contextlib.contextmanager
def span(name: str, runlog=None, *, fence: Any = None, annotate: bool = False,
         rank: Optional[int] = None, trace=None, **fields):
    """Nestable timed region emitting one ``span`` event at exit.

    ``fence``: falsy -> no wait (dur_s is host launch time, marked
    ``fenced: false``); ``True`` -> wait for the values registered via
    ``Span.fence``; any other value -> wait for it (plus registered
    values). ``annotate=True`` additionally wraps the region in a
    ``torch.profiler.record_function`` so it shows up in captured traces.

    ``rank`` overrides the event's rank tag (default: :func:`process_index`).
    ``trace`` threads a :class:`~gigapath_tpu_torch.obs.reqtrace.TraceContext`:
    at exit the region is mirrored into the context's causal tree (same
    name, same interval); a ``chunk=`` field keys the mirrored span.

    Against a ``NullRunLog`` (``GIGAPATH_OBS=0``) the whole thing is a
    no-op: the yielded span absorbs ``fence``/``note`` calls and nothing
    is timed, waited for, annotated, or written.
    """
    if not _is_recording(runlog):
        yield _NULL_SPAN
        return

    fenced = fence is not None and fence is not False
    sp = Span(name, fenced=fenced)
    if fence is not None and fence is not True and fence is not False:
        sp._fence_values.append(fence)
    _STACK.names.append(name)
    path = "/".join(_STACK.names)
    depth = len(_STACK.names)
    annotate_ctx = None
    if annotate:
        try:
            annotate_ctx = _record_function(name)
            annotate_ctx.__enter__()
        except Exception:
            annotate_ctx = None
    t0 = time.monotonic()
    status = "ok"
    try:
        yield sp
    except BaseException:
        status = "error"
        raise
    finally:
        try:
            fence_error = None
            # fence only on the clean path: waiting on a stuck device after
            # the body raised would turn an interruptible stall into a hang
            if sp.fenced and sp._fence_values and status == "ok":
                # a failing fence (a device error surfacing at the wait)
                # still leaves a span event and does not replace an
                # exception already in flight from the body
                try:
                    fence_devices(sp._fence_values)
                except Exception as e:
                    fence_error = f"{type(e).__name__}: {e}"
                    status = "error"
            sp.dur_s = round(time.monotonic() - t0, 6)
            if annotate_ctx is not None:
                annotate_ctx.__exit__(None, None, None)
            merged = dict(fields)
            merged.update(sp._fields)
            # caller fields must not shadow the span schema
            for reserved in _RESERVED_SPAN_KEYS:
                if reserved in merged:
                    merged[f"field_{reserved}"] = merged.pop(reserved)
            if fence_error is not None:
                merged["fence_error"] = fence_error
            runlog.event(
                "span", name=name, path=path, depth=depth, dur_s=sp.dur_s,
                fenced=sp.fenced,
                rank=process_index() if rank is None else int(rank),
                status=status,
                **merged,
            )
            if trace is not None:
                trace.add_span(name, t0, t0 + sp.dur_s,
                               chunk=merged.get("chunk"), status=status)
        finally:
            _STACK.names.pop()
