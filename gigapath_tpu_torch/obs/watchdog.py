"""Compile watchdog (the port's counterpart of
``gigapath_tpu/obs/watchdog.py``, same surface).

Per-(function, key) first-use accounting with first-call timing and
steady-call bookkeeping, ``compile`` events into a
:class:`~gigapath_tpu_torch.obs.runlog.RunLog`, and unexpected-retrace
flagging. What counts as a compile in the port:

- a **graph capture**: the cache-size probe reads the attached object's
  ``_cache_size()`` (the serving stack's per-bucket CUDA-graph cache,
  :mod:`gigapath_tpu_torch.serve.aot`, counts its captures there), so a
  capture on a key that was already seen is flagged as an unexpected
  retrace exactly as a jit-cache retrace is in the JAX package;
- a **kernel build**: every ``nvcc`` build that
  :mod:`gigapath_tpu_torch.ops._build` runs after the watchdog was made
  is filed as one ``compile`` event (fn ``<name>.kernel_build``, key the
  library's label, its seconds) the next time the watchdog records a
  call, and its seconds count in :meth:`compile_seconds_total`.

Two usage shapes, as in the JAX package: ``is_new(key)`` /
``record(key, seconds)`` from loops that manage their own sync points,
or ``step = watchdog.wrap(fn)`` for uniform-shape callers (the first call
per key waits for the device to time it; steady calls pass through). With
a ledger, a key's first call is profiled as it runs (:meth:`profile`), so
its first-call seconds include the profile's counting.
All bookkeeping is host-side Python around the call boundary.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from gigapath_tpu_torch.obs.runlog import NullRunLog, _key_str
from gigapath_tpu_torch.obs.spans import fence_devices


def _build_seconds() -> Dict[str, float]:
    from gigapath_tpu_torch.ops import _build

    return _build.build_seconds


def _default_key(args: tuple, kwargs: dict) -> tuple:
    """Shape/dtype signature over tensor-like positional args. Other
    values (modules, python scalars) are skipped: params do not change
    shape mid-run."""
    key: List[Tuple] = []
    for a in args:
        shape = getattr(a, "shape", None)
        if shape is not None:
            key.append((tuple(shape), str(getattr(a, "dtype", ""))))
    for name in sorted(kwargs):
        shape = getattr(kwargs[name], "shape", None)
        if shape is not None:
            key.append((name, tuple(shape), str(getattr(kwargs[name], "dtype", ""))))
    return tuple(key)


class CompileWatchdog:
    """Tracks first uses (graph captures) and kernel builds per
    (function, key); flags unexpected retraces. ``key`` is whatever the
    caller buckets on (``(capacity, bucket_n)`` in the serving stack; the
    default shape signature under :meth:`wrap`).
    """

    def __init__(self, name: str, runlog=None, *, fn: Optional[Callable] = None,
                 ledger=None, fingerprint_later: bool = True):
        self.name = name
        self.runlog = runlog if runlog is not None else NullRunLog()
        # perf-ledger hook (gigapath_tpu_torch.obs.ledger): when set, every new
        # key under wrap() — and every explicit profile() call from loops
        # driving the is_new/record surface — lands a compile_profile
        # event + ledger entry. None / NullLedger = no capture work.
        self.ledger = ledger
        # False: once the name has its full profile, later keys are
        # ledgered by their signature alone and run uncounted (a caller
        # whose every call is a new key)
        self.fingerprint_later = fingerprint_later
        self._fn = fn
        self.first_call_sec: Dict[Any, float] = {}
        self.step_sec: Dict[Any, list] = {}
        self._counts: Dict[Any, int] = {}  # untimed (async) steady steps
        self.compile_count: Dict[Any, int] = {}
        self.unexpected_retraces: List[Any] = []
        self.kernel_builds: Dict[str, float] = {}
        self._builds_seen = set(_build_seconds())
        self._last_cache_size = self._cache_size()

    # -- cache-size truth ------------------------------------------------
    def _cache_size(self) -> Optional[int]:
        size = getattr(self._fn, "_cache_size", None)
        if not callable(size):
            return None
        try:
            return int(size())
        except Exception:
            return None

    def attach(self, fn: Callable) -> None:
        """Point the cache-size probe at an object with ``_cache_size()``
        (the graph cache; done automatically by :meth:`wrap`)."""
        self._fn = fn
        self._last_cache_size = self._cache_size()

    # -- BucketCompileLog-compatible surface ------------------------------
    def is_new(self, key) -> bool:
        return key not in self.first_call_sec

    def mark_preloaded(self, key) -> None:
        """Register a key whose executable arrived WITHOUT a compile (the
        JAX package's persisted-artifact loads; the port's graph cache
        persists nothing and never calls this).
        Steady calls are counted under the key from here on, no
        ``compile`` event is filed (a load is not a compile), and later
        cache growth on the key is still flagged as an unexpected
        retrace."""
        if self.is_new(key):
            self.first_call_sec[key] = 0.0
            cur = self._cache_size()
            if cur is not None:
                self._last_cache_size = cur

    def record(self, key, seconds: Optional[float]) -> None:
        """File one completed call under ``key``.

        ``seconds=None`` marks a steady (async-dispatched, unsynced)
        step: counted, not timed — loops only block on new keys and at
        their periodic sync points, whose sec/it is the steady-state
        number. A timed value on a NEW key is the first call's
        compile+run seconds. Kernel builds finished since the last call
        are filed first.
        """
        self.file_kernel_builds()
        cur = self._cache_size()
        grew = (
            cur is not None
            and self._last_cache_size is not None
            and cur > self._last_cache_size
        )
        if cur is not None:
            self._last_cache_size = cur
        if self.is_new(key):
            self.first_call_sec[key] = seconds if seconds is not None else 0.0
            count = self.compile_count[key] = self.compile_count.get(key, 0) + 1
            self.runlog.compile_event(
                self.name, key, seconds, count=count, unexpected=False
            )
            self.runlog.echo(
                f"[compile] {self.name} key={_key_str(key)}: first call "
                f"{self.first_call_sec[key]:.2f}s (compile+run); "
                f"{len(self.first_call_sec)} key(s) compiled"
            )
        elif grew:
            # the capture count grew on a key we had already captured:
            # an unexpected retrace. seconds, when present, is this
            # call's wall, dominated by the capture.
            count = self.compile_count[key] = self.compile_count.get(key, 0) + 1
            self.unexpected_retraces.append(key)
            self.runlog.compile_event(
                self.name, key, seconds, count=count, unexpected=True
            )
            self.runlog.echo(
                f"[compile] WARNING {self.name} retraced on already-compiled "
                f"key {_key_str(key)} (cache {self._last_cache_size} entries)"
            )
        elif seconds is not None:
            self.step_sec.setdefault(key, []).append(seconds)
        else:
            self._counts[key] = self._counts.get(key, 0) + 1

    def file_kernel_builds(self) -> None:
        """File every kernel build that finished since the last look as
        one ``compile`` event (they happen inside first calls: a kernel
        builds at its first launch)."""
        for label, seconds in list(_build_seconds().items()):
            if label in self._builds_seen:
                continue
            self._builds_seen.add(label)
            self.kernel_builds[label] = float(seconds)
            self.runlog.compile_event(f"{self.name}.kernel_build", label,
                                      round(float(seconds), 6), count=1,
                                      unexpected=False)

    # -- wrapper for uniform-shape drivers --------------------------------
    def wrap(self, fn: Callable, key_fn: Optional[Callable] = None) -> Callable:
        """Instrument a callable. First call per key waits for the device
        to isolate its first-use cost; steady calls pass straight through
        (no added waits)."""
        self.attach(fn)

        def wrapped(*args, **kwargs):
            key = key_fn(*args, **kwargs) if key_fn else _default_key(args, kwargs)
            if self.is_new(key):
                t0 = time.time()
                out = self.profile(key, fn, *args, **kwargs)
                fence_devices([out])
                self.record(key, time.time() - t0)
            else:
                out = fn(*args, **kwargs)
                self.record(key, None)
            return out

        return wrapped

    # -- perf-ledger capture ----------------------------------------------
    def profile(self, key, fn, *args, **kwargs):
        """Run ``fn(*args, **kwargs)`` once and return its output; with a
        ledger, that call is profiled and ledgered under the watchdog's
        name, tagged with the key so compile and compile_profile events
        join (:meth:`PerfLedger.call_for_key
        <gigapath_tpu_torch.obs.ledger.PerfLedger.call_for_key>`). Loops
        that drive the ``is_new``/``record`` surface make a new key's first
        call through it; :meth:`wrap` does so on every new key. Nothing is
        run twice: the profile is taken on the call itself. Without
        ``fingerprint_later``, a key after the name's full profile is
        ledgered by its signature and runs uncounted."""
        if self.ledger is None:
            return fn(*args, **kwargs)
        if not self.fingerprint_later and self.ledger.has_full(self.name):
            self.ledger.sign(self.name, key, *args, **kwargs)
            return fn(*args, **kwargs)
        return self.ledger.call_for_key(self.name, key, fn, *args, **kwargs)

    # -- summaries --------------------------------------------------------
    def compile_seconds_total(self) -> float:
        """First-call seconds of every key plus every filed kernel build."""
        return float(sum(self.first_call_sec.values()) + sum(self.kernel_builds.values()))

    def summary(self) -> str:
        parts = []
        for key in sorted(self.first_call_sec, key=_key_str):
            steps = self.step_sec.get(key, [])
            n = len(steps) or self._counts.get(key, 0)
            timing = f" @ {sum(steps) / len(steps):.3f}s" if steps else ""
            retrace = (
                f", {self.compile_count.get(key, 1) - 1} unexpected retrace(s)"
                if self.compile_count.get(key, 1) > 1
                else ""
            )
            parts.append(
                f"key={_key_str(key)}: compile {self.first_call_sec[key]:.2f}s, "
                f"{n} steady steps{timing}{retrace}"
            )
        return f"[compile] {self.name} — " + "; ".join(parts)
