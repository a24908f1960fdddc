"""Liveness heartbeat + stall monitor (the port's counterpart of
``gigapath_tpu/obs/heartbeat.py``; only :func:`memory_watermarks` differs).

The failure mode this exists for: a blocking device call (a
``torch.cuda.synchronize``, a copy to the host) hangs with no deadline,
the loop stops advancing, and nothing in the process says so. A
background daemon thread cannot un-hang the call, but it can make the
hang *observable*: periodic ``heartbeat`` events keep timestamped proof
of liveness in the run artifact, and a ``stall`` event fires the moment
no step completes within the deadline, so both a human tail and
``scripts/obs_report.py`` can see exactly when progress stopped.

Usage::

    with Heartbeat(runlog, interval_s=30, stall_after_s=300) as hb:
        for step, batch in enumerate(loader):
            ...
            hb.beat(step)

``beat()`` is a lock + two assignments — safe to call every step. One
``stall`` event per stall episode; a later ``beat`` re-arms it so a
recovered run can flag a second stall.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, Optional

from gigapath_tpu_torch.obs.locktrace import make_lock


def env_seconds(name: str, default: float) -> float:
    """Host-side env override for the heartbeat deadlines (read once, at
    Heartbeat construction = driver start — never at trace time).
    Public: drivers with their own historical defaults (finetune's
    60/600) call this with those defaults instead of Heartbeat's."""
    from gigapath_tpu_torch.obs.runlog import env_number

    return env_number(name, default)


def memory_watermarks() -> Dict[str, float]:
    """Device-memory watermarks from ``torch.cuda.memory_stats`` (the
    caching allocator's allocated and reserved bytes and their peaks, per
    device), for the heartbeat events the anomaly engine's watermark
    detector reads.

    Read only when this process has already initialised CUDA
    (``torch.cuda.is_initialized()``), as the JAX package reads only once
    jax is imported: this runs on the heartbeat daemon thread, which must
    never be the one that creates a CUDA context. Any error returns ``{}``.
    ``mem_peak_bytes`` / ``mem_bytes_in_use`` keep the JAX field names (the
    peak allocated bytes of the busiest device, the allocated bytes of all
    devices); the reserved bytes ride beside them.
    """
    if "torch" not in sys.modules:
        return {}
    try:
        import torch

        from gigapath_tpu_torch.obs.ledger import peak_bytes

        if not torch.cuda.is_initialized():
            return {}
        stats = {i: torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}
        stats = {i: s for i, s in stats.items() if s}
        # the peaks through obs/ledger.py: a full profile's reset of the
        # allocator's counters does not lower them
        peaks = [peak_bytes(i) for i in stats]
    except Exception:
        return {}
    if not stats:
        return {}

    def total(key):
        return float(sum(s.get(key, 0) for s in stats.values()))

    return {
        "mem_peak_bytes": float(max(p["allocated"] for p in peaks)),
        "mem_bytes_in_use": total("allocated_bytes.all.current"),
        "mem_reserved_bytes": total("reserved_bytes.all.current"),
        "mem_reserved_peak_bytes": float(max(p["reserved"] for p in peaks)),
    }


class Heartbeat:
    def __init__(self, runlog, *, interval_s: Optional[float] = None,
                 stall_after_s: Optional[float] = None, name: str = "train"):
        self.runlog = runlog  # gigarace: type gigapath_tpu_torch.obs.runlog.RunLog
        # env-tunable defaults so EVERY driver's deadlines can be bent
        # without a CLI surface (a forced-stall repro, a tight CI run);
        # explicit arguments win
        if interval_s is None:
            interval_s = env_seconds("GIGAPATH_OBS_HEARTBEAT_S", 30.0)
        if stall_after_s is None:
            stall_after_s = env_seconds("GIGAPATH_OBS_STALL_S", 300.0)
        self.interval_s = float(interval_s)
        self.stall_after_s = float(stall_after_s)
        self.name = name
        self.stall_count = 0
        self._last_beat = time.time()
        self._last_step: Optional[int] = None
        self._stalled = False
        self._lock = make_lock("gigapath_tpu_torch.obs.heartbeat.Heartbeat._lock")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "Heartbeat":
        if self._thread is not None:
            return self
        # under the lock even though the monitor thread does not exist
        # yet: restarts race a stop()ing monitor's final read
        with self._lock:
            self._last_beat = time.time()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"obs-heartbeat-{self.name}"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "Heartbeat":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- progress ---------------------------------------------------------
    def beat(self, step: Optional[int] = None) -> None:
        """Record progress; re-arms stall detection after a recovery."""
        with self._lock:
            self._last_beat = time.time()
            if step is not None:
                self._last_step = step
            self._stalled = False

    # -- monitor thread ---------------------------------------------------
    def _tick_s(self) -> float:
        # poll fast enough to hit the stall deadline promptly even with
        # sub-second test configs, without spinning
        return max(0.01, min(self.interval_s, self.stall_after_s) / 4.0)

    def _run(self) -> None:
        next_hb = time.time() + self.interval_s
        while not self._stop.wait(timeout=self._tick_s()):
            now = time.time()
            with self._lock:
                since = now - self._last_beat
                step = self._last_step
                stalled = self._stalled
            if since >= self.stall_after_s and not stalled:
                with self._lock:
                    self._stalled = True
                self.stall_count += 1
                self.runlog.stall(
                    last_step=step,
                    since_progress_s=round(since, 3),
                    deadline_s=self.stall_after_s,
                )
                self.runlog.echo(
                    f"[stall] {self.name}: no step completed in "
                    f"{since:.1f}s (deadline {self.stall_after_s:.1f}s); "
                    f"last step {step}"
                )
            if now >= next_hb:
                # watermarks only once the run has made step progress:
                # this daemon thread must never be the one that
                # initialises the device
                mem = memory_watermarks() if step is not None else {}
                self.runlog.heartbeat(
                    last_step=step, since_progress_s=round(since, 3), **mem
                )
                next_hb = now + self.interval_s
