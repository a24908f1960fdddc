"""The cross-stage embedding channel: bounded, credit-based, checksummed.

The port's copy of ``gigapath_tpu/dist/boundary.py`` (host-side Python: no torch
or jax here), names and event schema unchanged.

One slide's tile embeddings flow from the tile-encoder stage to the
slide-encoder stage as *chunks* — contiguous tile ranges cut by the
deterministic :func:`plan_chunks` plan. The channel gives that flow the
four properties a cross-host boundary needs and a monolithic pjit gets
for free:

- **bounded**: the producer holds at most ``capacity`` unacked chunks in
  flight (credit-based flow control). When credits hit zero the producer
  BLOCKS — and emits one schema'd ``backpressure`` event per blocking
  episode (queue depth, credits, capacity) so a consumer falling behind
  is visible on the obs bus, not an OOM an hour later;
- **checksummed**: every chunk carries a sha256 over its header and
  payload bytes; a corrupt arrival is counted and discarded (the
  producer-side retransmit timer heals it), never assembled;
- **acked**: the consumer acks each delivered seq; producer credits are
  acked-based, so unacked chunks are exactly the set a recovery has to
  requeue (:mod:`gigapath_tpu_torch.dist.membership` re-assigns a lost
  worker's unacked range across survivors);
- **deduped**: sequence numbers are the chunk ids of the deterministic
  plan — stable across retransmits AND across re-assignment — so a
  duplicate (a ``dup_chunk`` injection, a retransmit racing its ack, a
  survivor re-producing a chunk the dead worker's last write also
  landed) is dropped by seq and the assembled slide is bit-identical to
  the clean run's.

Two transports, one protocol: :class:`MemoryChannel` (in-process,
``threading.Condition`` — the serving/inference prefetch path and the
unit tests) and the :class:`DirChannelProducer`/:class:`DirChannelConsumer`
pair (a shared directory with atomic tmp+rename writes — the two-process
dryrun harness; DCN/RPC transports slot in behind the same surface).
numpy + stdlib only; nothing here can touch a traced program, so the
channel can add no retraces (pinned by tests/test_dist.py).
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import json
import os
import threading
import time
import zipfile
from typing import Dict, List, Optional, Sequence, Tuple

from gigapath_tpu_torch.obs.locktrace import make_condition

import numpy as np

from gigapath_tpu_torch.obs.clock import (ClockSample, LinkClock, emit_clock_sync)
from gigapath_tpu_torch.obs.metrics import get_metrics
from gigapath_tpu_torch.obs.runlog import env_number


@dataclasses.dataclass(frozen=True)
class BoundaryConfig:
    """Channel knobs, snapshotted host-side at construction.

    ``from_env`` reads the ``GIGAPATH_DIST_*`` flags ONCE (the
    ``get_run_log`` discipline — never at trace time; README flag
    table)."""

    capacity: int = 8          # credits: max unacked chunks in flight
    chunk_tiles: int = 512     # tiles per chunk in the deterministic plan
    poll_s: float = 0.02       # producer block / consumer scan cadence
    retransmit_s: float = 2.0  # unacked-for-longer gets re-sent
    # TCP transport (dist/transport.py) only
    connect_timeout_s: float = 5.0  # per-connect AND per-frame deadline
    backoff_s: float = 2.0          # reconnect backoff cap (full jitter)

    @classmethod
    def from_env(cls, **overrides) -> "BoundaryConfig":
        fields = dict(
            capacity=int(env_number("GIGAPATH_DIST_CREDITS", cls.capacity)),
            chunk_tiles=int(env_number("GIGAPATH_DIST_CHUNK_TILES",
                                       cls.chunk_tiles)),
            poll_s=env_number("GIGAPATH_DIST_POLL_S", cls.poll_s),
            retransmit_s=env_number("GIGAPATH_DIST_RETRANSMIT_S",
                                    cls.retransmit_s),
            connect_timeout_s=env_number("GIGAPATH_DIST_CONNECT_TIMEOUT_S",
                                         cls.connect_timeout_s),
            backoff_s=env_number("GIGAPATH_DIST_BACKOFF_S", cls.backoff_s),
        )
        fields.update({k: v for k, v in overrides.items() if v is not None})
        if fields["capacity"] < 1:
            raise ValueError(f"capacity must be >= 1, got {fields['capacity']}")
        return cls(**fields)


# ---------------------------------------------------------------------------
# the deterministic chunk plan
# ---------------------------------------------------------------------------

def plan_chunks(n_tiles: int, chunk_tiles: int) -> List[Tuple[int, int, int]]:
    """``[(chunk_id, start, stop), ...]`` covering ``[0, n_tiles)`` in
    order. Chunk ids double as the channel's sequence numbers: they are
    a pure function of the slide geometry, so a survivor re-producing a
    lost worker's chunk emits the SAME seq the original would have —
    dedup and bit-parity both hang off this determinism."""
    if n_tiles < 1 or chunk_tiles < 1:
        raise ValueError(f"need n_tiles/chunk_tiles >= 1, got "
                         f"{n_tiles}/{chunk_tiles}")
    return [
        (cid, start, min(start + chunk_tiles, n_tiles))
        for cid, start in enumerate(range(0, n_tiles, chunk_tiles))
    ]


def assign_chunks(chunk_ids: Sequence[int],
                  workers: Sequence[str]) -> Dict[str, List[int]]:
    """Deterministic round-robin of chunk ids over SORTED worker ids —
    the one assignment function, used both for the initial shard and for
    re-assigning a lost worker's unacked chunks across survivors (same
    inputs -> same plan on every host, no coordination round needed)."""
    if not workers:
        raise ValueError("assign_chunks: no workers")
    ordered = sorted(workers)
    out: Dict[str, List[int]] = {w: [] for w in ordered}
    for i, cid in enumerate(sorted(chunk_ids)):
        out[ordered[i % len(ordered)]].append(cid)
    return out


# ---------------------------------------------------------------------------
# chunks
# ---------------------------------------------------------------------------

def chunk_checksum(slide_id: str, chunk_id: int, start: int, stop: int,
                   payload: np.ndarray,
                   coords: Optional[np.ndarray]) -> str:
    """sha256 over the header and the exact payload bytes. The header is
    inside the digest so a chunk whose payload survived but whose tile
    range was mangled still fails verification."""
    h = hashlib.sha256()
    h.update(f"{slide_id}|{chunk_id}|{start}|{stop}|".encode())
    h.update(np.ascontiguousarray(payload).tobytes())
    if coords is not None:
        h.update(np.ascontiguousarray(coords).tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class EmbeddingChunk:
    """One contiguous tile range of one slide's embeddings in flight.

    ``seq == chunk_id`` (see :func:`plan_chunks`); ``producer`` is
    provenance for the report, never protocol state. ``trace_id`` /
    ``parent_span_id`` carry the fleet trace context across the boundary
    (:mod:`gigapath_tpu_torch.obs.reqtrace`): the parent is the producer's
    structural ``send`` span id, computed at build time, so the
    consumer's ``deliver`` span joins the causal tree without any
    side-channel. Like ``producer``, they stay OUTSIDE the checksum —
    observability fields must never change the assembled bytes'
    verification."""

    slide_id: str
    chunk_id: int
    start: int
    stop: int
    payload: np.ndarray                    # [stop-start, D] float32
    coords: Optional[np.ndarray] = None    # [stop-start, 2] float32
    producer: str = ""
    checksum: str = ""
    trace_id: str = ""
    parent_span_id: str = ""

    @property
    def seq(self) -> int:
        return self.chunk_id

    @classmethod
    def build(cls, slide_id: str, chunk_id: int, start: int, stop: int,
              payload: np.ndarray, coords: Optional[np.ndarray] = None,
              producer: str = "", digest: bool = True,
              trace_id: str = "",
              parent_span_id: str = "") -> "EmbeddingChunk":
        """``digest=False`` skips the sha256 (checksum stays ``""``) —
        ONLY for intra-process channels, where the handoff is a memory
        reference that cannot corrupt and hashing hundreds of MB per
        slide would tax the hot path for nothing. Cross-process
        transports must digest: the directory consumer rejects an
        empty checksum outright."""
        payload = np.asarray(payload, np.float32)
        if coords is not None:
            coords = np.asarray(coords, np.float32)
        if payload.shape[0] != stop - start:
            raise ValueError(
                f"chunk {chunk_id}: payload rows {payload.shape[0]} != "
                f"tile range [{start}, {stop})"
            )
        return cls(
            slide_id=slide_id, chunk_id=int(chunk_id), start=int(start),
            stop=int(stop), payload=payload, coords=coords,
            producer=producer,
            checksum=chunk_checksum(slide_id, chunk_id, start, stop,
                                    payload, coords) if digest else "",
            trace_id=trace_id, parent_span_id=parent_span_id,
        )

    def verify(self) -> bool:
        return self.checksum == chunk_checksum(
            self.slide_id, self.chunk_id, self.start, self.stop,
            self.payload, self.coords,
        )


@dataclasses.dataclass
class ChannelStats:
    """Host-side protocol counters, rendered by ``obs_report.py``'s
    ``== dist ==`` section and asserted by the smoke/tests."""

    sent: int = 0
    delivered: int = 0
    acked: int = 0
    duplicates: int = 0      # arrivals dropped by seq dedup
    corrupt: int = 0         # arrivals failing checksum verification
    retransmits: int = 0     # unacked chunks re-sent after the timer
    dropped: int = 0         # sends swallowed by chaos injection
    backpressure_events: int = 0
    blocked_s: float = 0.0   # total producer wall spent credit-blocked
    # TCP transport only (dist/transport.py); zero on the other two
    reconnects: int = 0      # connections re-established after the first
    frame_errors: int = 0    # torn/corrupt/misframed wire frames dropped
    bytes_sent: int = 0      # frame bytes pushed onto the wire

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _emit_backpressure(runlog, *, channel: str, seq: int, queue_depth: int,
                       capacity: int) -> None:
    """One schema'd ``backpressure`` event per producer blocking episode
    (runlog optional — bare-channel users stay silent)."""
    if runlog is not None:
        runlog.event(  # gigarace: calls RunLog.event
            "backpressure", channel=channel, seq=seq, credits=0,
            queue_depth=queue_depth, capacity=capacity,
        )


class LinkTelemetry:
    """Per-(producer, consumer)-link labeled instruments
    (:mod:`gigapath_tpu_torch.obs.metrics`): the channel-health view the fleet
    report's ``== fleet ==`` per-link table renders. One instance per
    producing half of a cross-process channel; the link label is
    ``{transport}.{producer}`` (the consumer side is the single fan-in
    point, so the producer id identifies the link).

    Instruments (all ``dist.link.{link}.*``):

    - ``credits_in_flight`` (gauge) — credits currently consumed;
    - ``unacked_depth``     (gauge) — sent-unacked chunks;
    - ``ack_lag_chunks``    (gauge) — chunks past the ack watermark
      (for this protocol: the unacked set's size);
    - ``ack_lag_s``         (gauge) — age of the OLDEST unacked chunk
      (how long the watermark has been stuck);
    - ``backpressure_s``    (counter) — producer wall spent credit-blocked;
    - ``retransmits``       (counter) — timer-driven re-sends;
    - ``bytes``             (counter) — payload/frame bytes pushed.

    Built on :func:`~gigapath_tpu_torch.obs.metrics.get_metrics`, so with obs
    (or metrics) off every instrument is the shared null — zero
    overhead, no locks. The final ``metrics`` snapshot rides the
    registry's existing closer flush."""

    def __init__(self, runlog, link: str):
        registry = get_metrics(runlog)
        self.link = link
        prefix = f"dist.link.{link}"
        self.credits_in_flight = registry.gauge(f"{prefix}.credits_in_flight")
        self.unacked_depth = registry.gauge(f"{prefix}.unacked_depth")
        self.ack_lag_chunks = registry.gauge(f"{prefix}.ack_lag_chunks")
        self.ack_lag_s = registry.gauge(f"{prefix}.ack_lag_s")
        self.backpressure_s = registry.counter(f"{prefix}.backpressure_s")
        self.retransmits = registry.counter(f"{prefix}.retransmits")
        self.bytes = registry.counter(f"{prefix}.bytes")

    def on_send(self, nbytes: int) -> None:
        self.bytes.inc(max(int(nbytes), 0))

    def on_blocked(self, seconds: float) -> None:
        self.backpressure_s.inc(max(float(seconds), 0.0))

    def on_retransmit(self, n: int = 1) -> None:
        self.retransmits.inc(n)

    def set_depth(self, *, unacked: int, capacity: int,
                  oldest_sent_at: Optional[float],
                  now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        self.credits_in_flight.set(min(unacked, capacity))
        self.unacked_depth.set(unacked)
        self.ack_lag_chunks.set(unacked)
        self.ack_lag_s.set(0.0 if oldest_sent_at is None
                           else max(now - oldest_sent_at, 0.0))


def chunk_nbytes(chunk: EmbeddingChunk) -> int:
    """Payload bytes a send pushes across the link (the dir transport's
    byte accounting; the TCP transport counts real frame bytes)."""
    n = int(chunk.payload.nbytes)
    if chunk.coords is not None:
        n += int(chunk.coords.nbytes)
    return n


# ---------------------------------------------------------------------------
# in-process transport (threads)
# ---------------------------------------------------------------------------

class MemoryChannel:
    """Intra-process producer/consumer pair over one bounded buffer.

    The transport behind the inference prefetch wiring and the
    backpressure unit tests: ``send`` blocks while ``capacity`` chunks
    are unacked, ``recv`` dedups by seq, ``ack`` returns the credit.
    """

    def __init__(self, config: Optional[BoundaryConfig] = None, *,
                 runlog=None, name: str = "memory"):
        self.cfg = config or BoundaryConfig()
        self.name = name
        self._runlog = runlog  # gigarace: type gigapath_tpu_torch.obs.runlog.RunLog
        self.stats = ChannelStats()
        self._cond = make_condition("gigapath_tpu_torch.dist.boundary.MemoryChannel._cond")
        self._queue: List[EmbeddingChunk] = []
        self._unacked: Dict[int, EmbeddingChunk] = {}
        self._delivered: set = set()
        self._closed = False
        self._episode_seq: Optional[int] = None  # backpressure dedup

    # -- producer side ----------------------------------------------------
    def send(self, chunk: EmbeddingChunk,
             timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            blocked_at = None
            while len(self._unacked) >= self.cfg.capacity and not self._closed:
                if blocked_at is None:
                    blocked_at = time.monotonic()
                    if self._episode_seq != chunk.seq:
                        # one event per blocking EPISODE: a caller
                        # retrying a timed-out send of the same seq is
                        # the same episode, not a new one
                        self._episode_seq = chunk.seq
                        self.stats.backpressure_events += 1
                        _emit_backpressure(
                            self._runlog, channel=self.name, seq=chunk.seq,
                            queue_depth=len(self._unacked),
                            capacity=self.cfg.capacity,
                        )
                wait = self.cfg.poll_s
                if deadline is not None:
                    wait = min(wait, deadline - time.monotonic())
                    if wait <= 0:
                        self.stats.blocked_s += time.monotonic() - blocked_at
                        raise TimeoutError(
                            f"{self.name}: no credit within {timeout}s "
                            f"(seq {chunk.seq})"
                        )
                self._cond.wait(timeout=wait)
            if blocked_at is not None:
                self.stats.blocked_s += time.monotonic() - blocked_at
            if self._closed:
                raise RuntimeError(f"{self.name}: channel closed")
            self._unacked[chunk.seq] = chunk
            self._queue.append(chunk)
            self.stats.sent += 1
            self._cond.notify_all()

    def unacked_seqs(self) -> List[int]:
        with self._cond:
            return sorted(self._unacked)

    # -- consumer side ----------------------------------------------------
    def recv(self, timeout: Optional[float] = None) -> Optional[EmbeddingChunk]:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                while self._queue:
                    chunk = self._queue.pop(0)
                    if chunk.seq in self._delivered:
                        self.stats.duplicates += 1
                        continue
                    # digest-less chunks (build(digest=False)) are the
                    # sanctioned intra-process fast path: the handoff
                    # is a memory reference, there is nothing to verify
                    if chunk.checksum and not chunk.verify():
                        self.stats.corrupt += 1
                        continue
                    self._delivered.add(chunk.seq)
                    self.stats.delivered += 1
                    return chunk
                if self._closed:
                    return None
                wait = self.cfg.poll_s
                if deadline is not None:
                    wait = min(wait, deadline - time.monotonic())
                    if wait <= 0:
                        return None
                self._cond.wait(timeout=wait)

    def ack(self, seq: int) -> None:
        with self._cond:
            if self._unacked.pop(seq, None) is not None:
                self.stats.acked += 1
                self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()


# ---------------------------------------------------------------------------
# cross-process transport (shared directory)
# ---------------------------------------------------------------------------
#
# Layout under <root>/channel/:
#   chunk-<seq:06d>-<nonce>.npz   one send (atomic tmp+rename; the nonce
#                                 keeps retransmits/dups from colliding)
#   ack-<seq:06d>                 consumer ack marker (empty file)
#
# The producer's credit view is acked-based (a chunk file it wrote whose
# ack marker exists frees its credit); the consumer's dedup view is an
# in-memory seq set. Atomic renames mean a reader never sees a partial
# chunk; SIGKILL mid-write leaves only a tmp file nobody scans.

def _atomic_write_npz(path: str, **arrays) -> None:
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, path)


def atomic_touch(path: str) -> str:
    """Atomically materialize an empty marker file (ack markers, the
    pipeline's DONE flag): tmp + rename, so a scanner never races a
    half-created entry."""
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w", encoding="utf-8"):
        pass
    os.replace(tmp, path)
    return path


class DirChannelProducer:
    """One tile worker's sending half of the directory channel."""

    def __init__(self, root: str, config: Optional[BoundaryConfig] = None, *,
                 producer: str = "", runlog=None, chaos=None,
                 name: str = "dir"):
        self.cfg = config or BoundaryConfig()
        self.dir = os.path.join(root, "channel")
        os.makedirs(self.dir, exist_ok=True)
        self.producer = producer
        self.name = name
        self._runlog = runlog  # gigarace: type gigapath_tpu_torch.obs.runlog.RunLog
        self._chaos = chaos
        self.stats = ChannelStats()
        self._sent_at: Dict[int, float] = {}      # seq -> last send time
        self._chunks: Dict[int, EmbeddingChunk] = {}  # unacked payloads
        self._nonce = 0
        self._episode_seq: Optional[int] = None   # backpressure dedup
        self.telemetry = LinkTelemetry(
            runlog, f"{name}.{producer or 'p'}")
        # clock alignment (obs/clock.py): one ping/pong file exchange per
        # producer lifetime — the dir transport is same-machine (shared
        # monotonic clock), so a single sample documents offset ~= 0 with
        # an honest poll-cadence uncertainty bound
        self.clock = LinkClock(f"{name}.{producer or 'p'}")
        self._clock_ping: Optional[Tuple[str, float]] = None
        self._send_clock_ping()

    # -- clock alignment --------------------------------------------------
    def _send_clock_ping(self) -> None:
        tag = self.producer or "p"
        path = os.path.join(self.dir, f"clock-ping-{tag}-{os.getpid()}.json")
        t_send = time.monotonic()
        try:
            tmp = f"{path}.tmp-{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump({"link": self.clock.link, "t_send": t_send}, fh)
            os.replace(tmp, path)
        except OSError:
            return  # clock sync is best-effort; the channel must not care
        self._clock_ping = (path, t_send)

    def _poll_clock(self) -> None:
        """Complete an outstanding ping if the consumer answered: fold
        the four-timestamp sample, emit one ``clock_sync`` event, clean
        both files up."""
        if self._clock_ping is None:
            return
        path, t_send = self._clock_ping
        pong = path.replace("clock-ping-", "clock-pong-")
        if not os.path.exists(pong):
            return
        t_ack = time.monotonic()
        try:
            with open(pong, "r", encoding="utf-8") as fh:
                doc = json.load(fh)
            sample = ClockSample(t_send=t_send, t_recv=float(doc["t_recv"]),
                                 t_reply=float(doc["t_reply"]), t_ack=t_ack)
        except (OSError, ValueError, KeyError):
            return  # torn pong: re-read next poll
        est = self.clock.update(sample)
        emit_clock_sync(self._runlog, self.clock, est)
        self._clock_ping = None
        _unlink_quiet(path)
        _unlink_quiet(pong)

    # -- protocol ---------------------------------------------------------
    def _ack_path(self, seq: int) -> str:
        return os.path.join(self.dir, f"ack-{seq:06d}")

    def _refresh_acks(self) -> None:
        self._poll_clock()
        for seq in list(self._sent_at):
            if os.path.exists(self._ack_path(seq)):
                self._sent_at.pop(seq, None)
                self._chunks.pop(seq, None)
                self.stats.acked += 1
        self.telemetry.set_depth(
            unacked=len(self._sent_at), capacity=self.cfg.capacity,
            oldest_sent_at=min(self._sent_at.values())
            if self._sent_at else None,
        )

    def _write(self, chunk: EmbeddingChunk) -> None:
        self._nonce += 1
        path = os.path.join(
            self.dir,
            f"chunk-{chunk.seq:06d}-{self.producer or 'p'}-{self._nonce}.npz",
        )
        arrays = dict(
            slide_id=np.array(chunk.slide_id),
            chunk_id=np.array(chunk.chunk_id, np.int64),
            start=np.array(chunk.start, np.int64),
            stop=np.array(chunk.stop, np.int64),
            payload=chunk.payload,
            producer=np.array(chunk.producer or self.producer),
            checksum=np.array(chunk.checksum),
            trace_id=np.array(chunk.trace_id),
            parent_span_id=np.array(chunk.parent_span_id),
        )
        if chunk.coords is not None:
            arrays["coords"] = chunk.coords
        _atomic_write_npz(path, **arrays)

    def credits(self) -> int:
        self._refresh_acks()
        return max(self.cfg.capacity - len(self._sent_at), 0)

    def unacked_seqs(self) -> List[int]:
        self._refresh_acks()
        return sorted(self._sent_at)

    def send(self, chunk: EmbeddingChunk,
             timeout: Optional[float] = None) -> None:
        """Blocks (polling) while every credit is in flight; the chaos
        injectors hook here — a ``drop_chunk`` swallows THIS write but
        still registers the seq as sent-unacked (the retransmit timer
        heals it, exactly like a lost network write), a ``dup_chunk``
        writes twice (the consumer's dedup absorbs the twin)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        blocked_at = None
        while self.credits() <= 0:
            if blocked_at is None:
                blocked_at = time.monotonic()
                if self._episode_seq != chunk.seq:
                    # one event per blocking episode, even when the
                    # caller retries a timed-out send of the same seq
                    # (the worker's lease-renewing retry loop does)
                    self._episode_seq = chunk.seq
                    self.stats.backpressure_events += 1
                    _emit_backpressure(
                        self._runlog, channel=self.name, seq=chunk.seq,
                        queue_depth=len(self._sent_at),
                        capacity=self.cfg.capacity,
                    )
            if deadline is not None and time.monotonic() >= deadline:
                blocked = time.monotonic() - blocked_at
                self.stats.blocked_s += blocked
                self.telemetry.on_blocked(blocked)
                raise TimeoutError(
                    f"{self.name}: no credit within {timeout}s "
                    f"(seq {chunk.seq})"
                )
            time.sleep(self.cfg.poll_s)
        if blocked_at is not None:
            blocked = time.monotonic() - blocked_at
            self.stats.blocked_s += blocked
            self.telemetry.on_blocked(blocked)
        self._sent_at[chunk.seq] = time.monotonic()
        self._chunks[chunk.seq] = chunk
        self.stats.sent += 1
        if self._chaos is not None and self._chaos.drops_chunk(chunk.seq):
            self.stats.dropped += 1
            return
        self._write(chunk)
        self.telemetry.on_send(chunk_nbytes(chunk))
        if self._chaos is not None and self._chaos.dups_chunk(chunk.seq):
            self._write(chunk)
            self.telemetry.on_send(chunk_nbytes(chunk))

    def pump_retransmits(self, now: Optional[float] = None) -> int:
        """Re-send every chunk unacked for longer than ``retransmit_s``.
        Returns the number re-sent. Safe against duplicates: seqs dedup
        at the consumer."""
        now = time.monotonic() if now is None else now
        self._refresh_acks()
        n = 0
        for seq, sent_at in list(self._sent_at.items()):
            if now - sent_at >= self.cfg.retransmit_s:
                chunk = self._chunks.get(seq)
                if chunk is None:
                    continue
                self._write(chunk)
                self._sent_at[seq] = now
                self.stats.retransmits += 1
                self.telemetry.on_retransmit()
                self.telemetry.on_send(chunk_nbytes(chunk))
                n += 1
        return n


class DirChannelConsumer:
    """The slide stage's receiving half of the directory channel (one
    consumer drains every producer's chunks — the fan-in point)."""

    def __init__(self, root: str, config: Optional[BoundaryConfig] = None, *,
                 runlog=None, name: str = "dir",
                 delivered: Optional[Sequence[int]] = None):
        """``delivered``: seqs a RESTARTED consumer already holds (its
        checkpoint watermark) — seeded into the dedup set so retransmits
        of pre-crash chunks are absorbed, not re-assembled."""
        self.cfg = config or BoundaryConfig()
        self.dir = os.path.join(root, "channel")
        os.makedirs(self.dir, exist_ok=True)
        self.name = name
        self._runlog = runlog  # gigarace: type gigapath_tpu_torch.obs.runlog.RunLog
        self.stats = ChannelStats()
        self._delivered: set = set(
            int(s) for s in delivered) if delivered else set()
        # seqs this consumer considers DURABLE: the seeded watermark plus
        # every ack it issued itself. Only these may be re-acked on a
        # duplicate — a delivered-but-deferred-ack seq must NOT be (the
        # deferred-ack discipline: an ack is a durability promise)
        self._acked: set = set(self._delivered)

    def _load(self, path: str) -> Optional[EmbeddingChunk]:
        try:
            with np.load(path, allow_pickle=False) as z:
                coords = z["coords"] if "coords" in z.files else None
                return EmbeddingChunk(
                    slide_id=str(z["slide_id"]),
                    chunk_id=int(z["chunk_id"]), start=int(z["start"]),
                    stop=int(z["stop"]), payload=np.asarray(z["payload"]),
                    coords=None if coords is None else np.asarray(coords),
                    producer=str(z["producer"]),
                    checksum=str(z["checksum"]),
                    trace_id=str(z["trace_id"])
                    if "trace_id" in z.files else "",
                    parent_span_id=str(z["parent_span_id"])
                    if "parent_span_id" in z.files else "",
                )
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            # a torn archive can only be a racing writer's tmp that
            # slipped in; re-scan next poll, never delete blind
            return None

    def recv(self, timeout: Optional[float] = None) -> Optional[EmbeddingChunk]:
        """Next new, verified chunk (any producer), or None on timeout.
        Processed files are deleted; duplicate seqs and corrupt payloads
        are counted and dropped."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            self._answer_clock_pings()
            for path in sorted(glob.glob(os.path.join(self.dir, "chunk-*.npz"))):
                name = os.path.basename(path)
                try:
                    seq = int(name.split("-")[1])
                except (IndexError, ValueError):
                    continue
                if seq in self._delivered:
                    self.stats.duplicates += 1
                    _unlink_quiet(path)
                    if seq in self._acked:
                        # re-ack (idempotent marker): a RESTARTED
                        # consumer's seeded watermark may cover seqs
                        # whose deferred ack died with the predecessor
                        # between checkpoint and flush — swallowing the
                        # retransmit without acking would pin the
                        # producer's credit forever. ONLY durable seqs:
                        # acking a deferred-ack duplicate would promise
                        # durability a crash can still revoke
                        atomic_touch(os.path.join(self.dir,
                                                  f"ack-{seq:06d}"))
                    continue
                chunk = self._load(path)
                if chunk is None:
                    continue
                _unlink_quiet(path)
                if not chunk.verify():
                    self.stats.corrupt += 1
                    continue
                self._delivered.add(seq)
                self.stats.delivered += 1
                return chunk
            if deadline is not None and time.monotonic() >= deadline:
                return None
            time.sleep(self.cfg.poll_s)

    def _answer_clock_pings(self) -> None:
        """Answer outstanding clock pings (obs/clock.py's dir-transport
        half): stamp this process's monotonic clock into an atomic pong
        the pinging producer completes its sample from. Idempotent — an
        already-answered ping is skipped."""
        for path in glob.glob(os.path.join(self.dir, "clock-ping-*.json")):
            pong = path.replace("clock-ping-", "clock-pong-")
            if os.path.exists(pong):
                continue
            now = time.monotonic()
            try:
                tmp = f"{pong}.tmp-{os.getpid()}"
                with open(tmp, "w", encoding="utf-8") as fh:
                    json.dump({"t_recv": now, "t_reply": now}, fh)
                os.replace(tmp, pong)
            except OSError:
                continue  # best-effort: the producer just re-polls

    def ack(self, seq: int) -> None:
        atomic_touch(os.path.join(self.dir, f"ack-{seq:06d}"))
        self._acked.add(int(seq))
        self.stats.acked += 1


def _unlink_quiet(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


# ---------------------------------------------------------------------------
# assembly
# ---------------------------------------------------------------------------

class ChunkTracker:
    """Delivery-set bookkeeping (expect / dedup-add / received /
    missing / complete) — the recovery-critical half every consumer
    needs regardless of what it does with the payloads. The streaming
    (chunked-prefill) consumer uses it bare: the session, not a dense
    array, holds the slide."""

    def __init__(self):
        self._have: set = set()
        self._expected: Optional[set] = None

    def expect(self, chunk_ids: Sequence[int]) -> None:
        self._expected = set(int(c) for c in chunk_ids)

    def seed_received(self, chunk_ids: Sequence[int]) -> None:
        """Mark chunks already held (a restarted consumer's checkpoint
        watermark) so their retransmits dedup instead of re-folding."""
        self._have.update(int(c) for c in chunk_ids)

    def add(self, chunk: EmbeddingChunk) -> bool:
        """Record one delivery; returns False for a chunk id already
        seen (belt under the channel's dedup suspenders)."""
        if chunk.chunk_id in self._have:
            return False
        self._have.add(chunk.chunk_id)
        return True

    @property
    def received(self) -> set:
        return set(self._have)

    def missing(self) -> List[int]:
        if self._expected is None:
            return []
        return sorted(self._expected - self._have)

    def complete(self) -> bool:
        return self._expected is not None and not self.missing()


class SlideAssembler(ChunkTracker):
    """Chunks -> the dense ``[n_tiles, D]`` tile-embedding sequence.

    Placement is by the chunk's tile range, so arrival order and the
    identity of the producing worker are irrelevant to the assembled
    bytes — the bit-parity half of the recovery contract."""

    def __init__(self, n_tiles: int, dim: int, *, coords_dim: int = 2):
        super().__init__()
        self.n_tiles = int(n_tiles)
        self.embeds = np.zeros((n_tiles, dim), np.float32)
        self.coords = np.zeros((n_tiles, coords_dim), np.float32)

    def add(self, chunk: EmbeddingChunk) -> bool:
        """Place one chunk (tracker dedup first)."""
        if not super().add(chunk):
            return False
        self.embeds[chunk.start:chunk.stop] = chunk.payload
        if chunk.coords is not None:
            self.coords[chunk.start:chunk.stop] = chunk.coords
        return True
