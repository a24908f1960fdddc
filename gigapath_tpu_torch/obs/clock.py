"""Cross-process clock alignment for the disaggregated fleet.

The port's copy of ``gigapath_tpu/obs/clock.py`` (host-side Python: no torch
or jax here), names and event schema unchanged.

Every process in a fleet run keeps its own ``time.monotonic()`` origin,
so spans recorded by a tile worker and by the slide consumer cannot be
merged onto one timeline by subtraction alone.  This module is the ONE
place that turns a four-timestamp handshake sample into a per-link
clock offset, NTP-style:

    producer                     consumer
    t_send  ---- hello ------->  t_recv
    t_ack   <--- hello_ack ----  t_reply

    offset      = ((t_recv - t_send) + (t_reply - t_ack)) / 2
    rtt         = (t_ack - t_send) - (t_reply - t_recv)
    uncertainty = rtt / 2

``offset`` maps the producer's monotonic clock onto the consumer's
(``t_consumer ~= t_producer + offset``); the consumer is the fleet's
reference clock.  The estimate is re-taken on EVERY (re)connect — a
restarted consumer is a fresh monotonic origin, so a link's offset is
only as durable as its connection — and each link keeps the
lowest-uncertainty sample seen on the current connection epoch
(shorter round trip = tighter bound).

Transport integration: the TCP ``hello``/``hello_ack`` exchange carries
the four timestamps directly; the directory transport exchanges a
``clock-ping-*``/``clock-pong-*`` file pair with the same fields.  Both
emit one schema'd ``clock_sync`` event per estimate
(``gigapath_tpu_torch/obs/runlog.py`` EVENT_KINDS), which is what
``obs/fleet.py`` reads to place each process's trace export on the
consumer's axis.  Pure stdlib — no jax, no numpy — like the rest of the
obs bus.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ClockSample:
    """One four-timestamp handshake: ``t_send``/``t_ack`` on the
    producer's monotonic clock, ``t_recv``/``t_reply`` on the
    consumer's."""

    t_send: float
    t_recv: float
    t_reply: float
    t_ack: float


@dataclasses.dataclass(frozen=True)
class ClockEstimate:
    """offset maps producer-monotonic onto consumer-monotonic
    (reference) time; uncertainty is the half-RTT error bound."""

    offset_s: float
    rtt_s: float
    uncertainty_s: float

    def to_reference(self, t_producer: float) -> float:
        return t_producer + self.offset_s


def estimate_offset(sample: ClockSample) -> ClockEstimate:
    """The NTP midpoint estimate.  Negative offsets (producer clock
    ahead of the consumer's) are perfectly legal — monotonic origins
    are arbitrary per process."""
    offset = ((sample.t_recv - sample.t_send)
              + (sample.t_reply - sample.t_ack)) / 2.0
    rtt = (sample.t_ack - sample.t_send) - (sample.t_reply - sample.t_recv)
    rtt = max(rtt, 0.0)  # clock jitter can't make a round trip negative
    return ClockEstimate(offset_s=offset, rtt_s=rtt,
                         uncertainty_s=rtt / 2.0)


class LinkClock:
    """Per-(producer, consumer)-link offset estimator.

    ``update(sample)`` folds one handshake sample; within one
    connection epoch the lowest-RTT sample wins (it bounds the offset
    tightest).  ``resync()`` starts a new epoch — call it when the link
    reconnects, because the peer may be a RESTARTED process with a
    brand-new monotonic origin, and averaging across that boundary
    would be meaningless.  Single-owner (the producer's ack-drain
    path); not thread-safe by design."""

    def __init__(self, link: str):
        self.link = link
        self.estimate: Optional[ClockEstimate] = None
        self.samples = 0   # samples folded in the CURRENT epoch
        self.epochs = 0    # resync() count — reconnect re-estimations

    def resync(self) -> None:
        """Drop the current estimate: the next sample re-estimates from
        scratch (reconnect = possibly a different peer clock)."""
        if self.samples:
            self.epochs += 1
        self.estimate = None
        self.samples = 0

    def update(self, sample: ClockSample) -> ClockEstimate:
        est = estimate_offset(sample)
        self.samples += 1
        if self.estimate is None or est.rtt_s < self.estimate.rtt_s:
            self.estimate = est
        return est

    @property
    def offset_s(self) -> float:
        return self.estimate.offset_s if self.estimate else 0.0

    @property
    def uncertainty_s(self) -> float:
        return self.estimate.uncertainty_s if self.estimate else 0.0


def emit_clock_sync(runlog, clock: LinkClock,
                    estimate: ClockEstimate) -> None:
    """One ``clock_sync`` event per folded sample — the record
    ``obs/fleet.py`` aligns timelines from.  No-ops on a NullRunLog
    (``event`` is permissive) and never raises into the transport."""
    if runlog is None:
        return
    runlog.event(
        "clock_sync",
        link=clock.link,
        offset_s=round(clock.offset_s, 9),
        rtt_s=round(estimate.rtt_s, 9),
        uncertainty_s=round(clock.uncertainty_s, 9),
        sample_offset_s=round(estimate.offset_s, 9),
        samples=clock.samples,
        epoch=clock.epochs,
    )
