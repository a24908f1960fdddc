"""The real network transport of the cross-stage boundary: TCP sockets.

The port's copy of ``gigapath_tpu/dist/transport.py`` (host-side Python: no torch
or jax here), names and event schema unchanged.

Same producer/consumer protocol as :class:`~gigapath_tpu_torch.dist.boundary.
DirChannelProducer`/``DirChannelConsumer`` (credits, acks, seq dedup,
checksums, retransmit timer, one ``backpressure`` event per blocking
episode), over a wire instead of a shared directory — the DCN/RPC shape
ROADMAP item 4 called for, with the directory transport kept as the
dryrun stand-in. ``worker.py``/``pipeline.py`` pick the transport
through :func:`make_producer`/:func:`make_consumer`
(``GIGAPATH_DIST_TRANSPORT``) with zero changes to the fold path.

Wire format — length-prefixed frames with MANDATORY digests:

    ``b"GPF1" | body_len:u32 | sha256(body):32B | body``
    ``body = header_len:u32 | header_json | blob``

``header_json`` carries the frame type (``hello`` / ``hello_ack`` /
``chunk`` / ``ack``); a chunk frame's blob is the same npz byte layout
the directory transport writes, so the chunk's OWN sha256 checksum rides
inside the frame digest (frame digest = wire integrity, chunk checksum
= end-to-end integrity — a corrupt frame is dropped and counted, never
delivered).

Recovery properties:

- **handshake**: every (re)connection opens with ``hello`` carrying the
  run id + producer id; the consumer answers ``hello_ack`` with its ACK
  WATERMARK (the sorted seqs it considers durable). The producer drops
  those from its unacked set and replays exactly the rest — a reconnect
  retransmits the unacked chunk ids and nothing else, and a RESTARTED
  consumer (whose watermark is its checkpoint's, see
  ``pipeline.run_slide_consumer``) receives only post-watermark chunks;
- **reconnect**: capped exponential backoff with full jitter
  (``random.uniform(0, min(cap, base * 2**attempt))`` — the herd-safe
  schedule), endpoint re-read per attempt (a restarted consumer binds a
  fresh port and rewrites ``transport.json``);
- **deadlines everywhere**: every ``connect`` carries
  ``connect_timeout_s``, every blocking frame read a ``settimeout``,
  the consumer's event loop a ``select(timeout)`` — no recv without a
  deadline (gigalint GL015 enforces this even here, the one
  socket-sanctioned module);
- **chaos at the frame layer**: ``drop_conn@K`` (half the frame, then
  the socket dies), ``delay_frame@K[:S]``, ``corrupt_frame@K`` (bytes
  flipped after the digest was computed), ``reorder_frame@K`` — all
  injected host-side inside :meth:`TcpChannelProducer._transmit`, so a
  chaos run compiles the same programs as a clean one.

numpy + stdlib only (no jax import), like the rest of the protocol
layer — the transport can never retrace anything.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import random
import selectors
import socket
import struct
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from gigapath_tpu_torch.dist.boundary import (
    BoundaryConfig,
    ChannelStats,
    EmbeddingChunk,
    LinkTelemetry,
    _emit_backpressure,
)
from gigapath_tpu_torch.dist.membership import _read_json, atomic_write_json
from gigapath_tpu_torch.obs.clock import ClockSample, LinkClock, emit_clock_sync

MAGIC = b"GPF1"
_PREFIX = struct.Struct("!4sI")      # magic, body length
_U32 = struct.Struct("!I")
_DIGEST_SIZE = 32
MAX_FRAME_BYTES = 1 << 30            # framing sanity bound
ENDPOINT_FILE = "transport.json"
_BACKOFF_BASE_S = 0.05


class FrameError(ValueError):
    """Unrecoverable framing damage (bad magic / absurd length): the
    stream position is lost, the connection must be torn down."""


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------

def encode_frame(header: dict, blob: bytes = b"") -> bytes:
    """One wire frame: length-prefixed, sha256-digested body."""
    header_json = json.dumps(header, sort_keys=True).encode()
    body = _U32.pack(len(header_json)) + header_json + blob
    return _PREFIX.pack(MAGIC, len(body)) + hashlib.sha256(body).digest() + body


def decode_body(body: bytes) -> Tuple[dict, bytes]:
    (header_len,) = _U32.unpack_from(body, 0)
    header = json.loads(body[_U32.size:_U32.size + header_len].decode())
    return header, body[_U32.size + header_len:]


def chunk_to_blob(chunk: EmbeddingChunk) -> bytes:
    """Same npz byte layout as the directory transport's ``_write`` —
    one serialization, two transports."""
    arrays = dict(
        slide_id=np.array(chunk.slide_id),
        chunk_id=np.array(chunk.chunk_id, np.int64),
        start=np.array(chunk.start, np.int64),
        stop=np.array(chunk.stop, np.int64),
        payload=chunk.payload,
        producer=np.array(chunk.producer),
        checksum=np.array(chunk.checksum),
        trace_id=np.array(chunk.trace_id),
        parent_span_id=np.array(chunk.parent_span_id),
    )
    if chunk.coords is not None:
        arrays["coords"] = chunk.coords
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def blob_to_chunk(blob: bytes) -> Optional[EmbeddingChunk]:
    try:
        with np.load(io.BytesIO(blob), allow_pickle=False) as z:
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
    except (OSError, ValueError, KeyError):
        return None


class FrameBuffer:
    """Incremental frame parser over a byte stream. ``feed`` appends
    received bytes; ``frames`` yields every complete, digest-verified
    ``(header, blob)``. Digest mismatches are counted and skipped (the
    length prefix sits OUTSIDE the digest, so framing survives a
    corrupted body); magic/length damage raises :class:`FrameError`."""

    def __init__(self):
        self._buf = bytearray()
        self.digest_errors = 0

    def feed(self, data: bytes) -> None:
        self._buf.extend(data)

    @property
    def pending_bytes(self) -> int:
        return len(self._buf)

    def frames(self) -> List[Tuple[dict, bytes]]:
        out: List[Tuple[dict, bytes]] = []
        while True:
            if len(self._buf) < _PREFIX.size:
                return out
            magic, body_len = _PREFIX.unpack_from(self._buf, 0)
            if magic != MAGIC or body_len > MAX_FRAME_BYTES:
                raise FrameError(
                    f"misframed stream (magic={magic!r}, len={body_len})"
                )
            total = _PREFIX.size + _DIGEST_SIZE + body_len
            if len(self._buf) < total:
                return out
            digest = bytes(self._buf[_PREFIX.size:_PREFIX.size + _DIGEST_SIZE])
            body = bytes(self._buf[_PREFIX.size + _DIGEST_SIZE:total])
            del self._buf[:total]
            if hashlib.sha256(body).digest() != digest:
                self.digest_errors += 1
                continue  # the frame is droppable; framing is intact
            try:
                out.append(decode_body(body))
            except (ValueError, KeyError, UnicodeDecodeError):
                self.digest_errors += 1


# ---------------------------------------------------------------------------
# endpoint discovery
# ---------------------------------------------------------------------------

def endpoint_path(root: str) -> str:
    return os.path.join(root, ENDPOINT_FILE)


def read_endpoint(root: str) -> Optional[Tuple[str, int]]:
    doc = _read_json(endpoint_path(root))
    if not doc or "port" not in doc:
        return None
    return str(doc.get("host", "127.0.0.1")), int(doc["port"])


def _metrics_counters(runlog):
    """The dist transport's three registry counters (a NullRunLog — or
    metrics off — yields no-op instruments)."""
    from gigapath_tpu_torch.obs.metrics import get_metrics

    m = get_metrics(runlog)
    return (m.counter("dist.reconnects"), m.counter("dist.frame_errors"),
            m.counter("dist.bytes_sent"))


# ---------------------------------------------------------------------------
# consumer (the accepting side — the slide stage binds, workers dial in)
# ---------------------------------------------------------------------------

class TcpChannelConsumer:
    """The slide stage's receiving half over TCP: binds an ephemeral
    loopback port, publishes it to ``<root>/transport.json`` (atomic),
    and fans in every producer connection through one single-threaded
    ``selectors`` loop — no reader threads, no hand-rolled queues.

    ``delivered`` seeds the dedup AND ack-watermark sets for a restarted
    consumer: the handshake tells reconnecting producers these seqs are
    durable, so they replay only the rest."""

    def __init__(self, root: str, config: Optional[BoundaryConfig] = None, *,
                 runlog=None, name: str = "tcp",
                 delivered: Optional[Sequence[int]] = None,
                 host: str = "127.0.0.1", run_id: str = ""):
        self.cfg = config or BoundaryConfig()
        self.root = root
        self.name = name
        self.run_id = run_id
        self._runlog = runlog
        self.stats = ChannelStats()
        (self._c_reconnects, self._c_frame_errors,
         self._c_bytes) = _metrics_counters(runlog)
        self._delivered: set = set(
            int(s) for s in delivered) if delivered else set()
        self._acked: set = set(self._delivered)
        self._ready: List[EmbeddingChunk] = []  # parsed, undelivered
        self._conns: Dict[socket.socket, dict] = {}
        self._seq_conn: Dict[int, socket.socket] = {}
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, 0))
        self._listener.listen(64)
        self._listener.setblocking(False)
        self._sel = selectors.DefaultSelector()
        self._sel.register(self._listener, selectors.EVENT_READ)
        os.makedirs(root, exist_ok=True)
        atomic_write_json(endpoint_path(root), {
            "host": host, "port": self._listener.getsockname()[1],
            "pid": os.getpid(), "run": run_id,
        })
        self._closed = False

    @property
    def port(self) -> int:
        return self._listener.getsockname()[1]

    # -- the event loop ----------------------------------------------------
    def _drop_conn(self, sock: socket.socket, *, torn: bool) -> None:
        state = self._conns.pop(sock, None)
        if torn or (state and state["buf"].pending_bytes):
            # a half-received frame died with the connection
            self.stats.frame_errors += 1
            self._c_frame_errors.inc()
        try:
            self._sel.unregister(sock)
        except (KeyError, ValueError):
            pass
        try:
            sock.close()
        except OSError:
            pass

    def _send_frame(self, sock: socket.socket, header: dict,
                    blob: bytes = b"") -> bool:
        """Outbound ack/handshake frame. The socket lives non-blocking
        for the read loop, but a send must not tear a frame on
        transient buffer pressure (sendall on a non-blocking socket can
        raise BlockingIOError after a PARTIAL write): flip to a
        deadline-bounded blocking send, restore after. Only a peer
        stuck past the deadline — not a full buffer — drops the
        connection."""
        try:
            sock.settimeout(self.cfg.connect_timeout_s)
            sock.sendall(encode_frame(header, blob))
            return True
        except OSError:
            self._drop_conn(sock, torn=False)
            return False
        finally:
            try:
                sock.setblocking(False)
            except OSError:
                pass  # already dropped/closed

    def _handle_frame(self, sock: socket.socket, header: dict,
                      blob: bytes) -> Optional[EmbeddingChunk]:
        kind = header.get("type")
        if kind == "hello":
            self._conns[sock]["producer"] = str(header.get("producer", "?"))
            # the ack watermark: what THIS consumer considers durable —
            # a reconnecting producer replays exactly the complement
            reply = {
                "type": "hello_ack", "run": self.run_id,
                "acked": sorted(self._acked),
            }
            if "t_send" in header:
                # clock alignment (obs/clock.py): echo the producer's
                # send stamp and add this clock's receive/reply stamps —
                # the producer completes the four-timestamp sample when
                # the reply lands and re-estimates the link offset on
                # EVERY (re)connect (a restarted peer is a fresh
                # monotonic origin)
                now = time.monotonic()
                reply["t_send"] = header["t_send"]
                reply["t_recv"] = now
                reply["t_reply"] = now
            self._send_frame(sock, reply)
            return None
        if kind == "ack":
            return None  # producers ack nothing; ignore
        if kind != "chunk":
            self.stats.frame_errors += 1
            self._c_frame_errors.inc()
            return None
        chunk = blob_to_chunk(blob)
        if chunk is None:
            self.stats.frame_errors += 1
            self._c_frame_errors.inc()
            return None
        if chunk.seq in self._delivered:
            self.stats.duplicates += 1
            if chunk.seq in self._acked:
                # the producer missed the ack (e.g. its conn died before
                # the ack frame landed): re-ack so it stops replaying
                self._send_frame(sock, {"type": "ack", "seq": chunk.seq})
            return None
        # cross-process transports must digest end-to-end: an empty
        # chunk checksum is rejected like the directory consumer does
        if not chunk.checksum or not chunk.verify():
            self.stats.corrupt += 1
            return None
        self._delivered.add(chunk.seq)
        self._seq_conn[chunk.seq] = sock
        self.stats.delivered += 1
        return chunk

    def _pump(self, timeout: float) -> None:
        """One bounded select pass: accept, read, parse. Parsed chunks
        land in ``self._ready`` (a same-thread list, drained by
        ``recv``)."""
        for key, _ in self._sel.select(timeout=max(timeout, 0.0)):
            sock = key.fileobj
            if sock is self._listener:
                try:
                    conn, _ = self._listener.accept()
                except OSError:
                    continue
                conn.setblocking(False)
                self._conns[conn] = {"buf": FrameBuffer(), "producer": ""}
                self._sel.register(conn, selectors.EVENT_READ)
                continue
            state = self._conns.get(sock)
            if state is None:
                continue
            try:
                data = sock.recv(1 << 16)
            except (BlockingIOError, InterruptedError):
                continue
            except OSError:
                self._drop_conn(sock, torn=False)
                continue
            if not data:
                # peer EOF: only a non-empty parse buffer means a frame
                # died with the connection — a clean close (worker done,
                # SIGKILL between frames) is not wire corruption
                self._drop_conn(sock, torn=False)
                continue
            buf = state["buf"]
            buf.feed(data)
            before = buf.digest_errors
            try:
                frames = buf.frames()
            except FrameError:
                self._drop_conn(sock, torn=True)
                continue
            if buf.digest_errors > before:
                n = buf.digest_errors - before
                self.stats.frame_errors += n
                self._c_frame_errors.inc(n)
            for header, blob in frames:
                chunk = self._handle_frame(sock, header, blob)
                if chunk is not None:
                    self._ready.append(chunk)

    # -- the channel surface ------------------------------------------------
    def recv(self, timeout: Optional[float] = None) -> Optional[EmbeddingChunk]:
        """Next new, verified chunk (any producer), or None on timeout —
        the same contract as ``DirChannelConsumer.recv``."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._ready:
                return self._ready.pop(0)
            if self._closed:
                return None
            wait = self.cfg.poll_s
            if deadline is not None:
                wait = min(wait, deadline - time.monotonic())
                if wait < 0:
                    return None
            self._pump(wait)
            if self._ready:
                return self._ready.pop(0)
            if deadline is not None and time.monotonic() >= deadline:
                return None

    def ack(self, seq: int) -> None:
        """Ack ``seq`` toward the producer that delivered it (falling
        back to every live connection — an ack is idempotent and a
        reconnected producer learns the watermark from the handshake
        anyway)."""
        seq = int(seq)
        self._acked.add(seq)
        self.stats.acked += 1
        sock = self._seq_conn.pop(seq, None)
        if sock is not None and sock in self._conns:
            if self._send_frame(sock, {"type": "ack", "seq": seq}):
                return
        for other in list(self._conns):
            self._send_frame(other, {"type": "ack", "seq": seq})

    def acked_seqs(self) -> List[int]:
        return sorted(self._acked)

    def close(self) -> None:
        self._closed = True
        for sock in list(self._conns):
            self._drop_conn(sock, torn=False)
        try:
            self._sel.unregister(self._listener)
        except (KeyError, ValueError):
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        self._sel.close()


# ---------------------------------------------------------------------------
# producer (one per tile worker — dials the consumer, replays on reconnect)
# ---------------------------------------------------------------------------

class TcpChannelProducer:
    """One tile worker's sending half over TCP. Connection management is
    LAZY and self-healing: ``send``/``pump_retransmits`` (re)connect as
    needed with capped-exponential-backoff + full-jitter, and every
    (re)handshake reconciles the unacked set against the consumer's ack
    watermark, then replays exactly the still-unacked chunks."""

    def __init__(self, root: str, config: Optional[BoundaryConfig] = None, *,
                 producer: str = "", runlog=None, chaos=None,
                 name: str = "tcp", run_id: str = ""):
        self.cfg = config or BoundaryConfig()
        self.root = root
        self.producer = producer
        self.name = name
        self.run_id = run_id
        self._runlog = runlog
        self._chaos = chaos
        self.stats = ChannelStats()
        (self._c_reconnects, self._c_frame_errors,
         self._c_bytes) = _metrics_counters(runlog)
        self.telemetry = LinkTelemetry(runlog, f"{name}.{producer or 'p'}")
        self.clock = LinkClock(f"{name}.{producer or 'p'}")
        self._sock: Optional[socket.socket] = None
        self._buf = FrameBuffer()           # the ack/handshake stream
        self._ever_connected = False
        self._replay_on_watermark = False
        self._sent_at: Dict[int, float] = {}
        self._chunks: Dict[int, EmbeddingChunk] = {}
        self._frame_idx = 0                 # data-frame index for chaos
        self._reorder_held: Optional[bytes] = None
        self._episode_seq: Optional[int] = None

    # -- connection management ----------------------------------------------
    def _close_sock(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None
        self._buf = FrameBuffer()

    def _connect_once(self) -> bool:
        """One connect attempt: dial, send ``hello``, and mark the
        stream as awaiting the consumer's ``hello_ack``. The handshake
        reply is processed ASYNCHRONOUSLY by :meth:`_drain_acks` (the
        consumer serves handshakes from its single recv loop — a
        producer blocking here for the reply would couple its send path
        to the consumer's poll cadence)."""
        addr = read_endpoint(self.root)
        if addr is None:
            return False
        try:
            sock = socket.create_connection(
                addr, timeout=self.cfg.connect_timeout_s
            )
        except OSError:
            return False
        was_reconnect = self._ever_connected
        self._close_sock()
        self._sock = sock
        # replay is gated on the watermark: a RECONNECT (or a first
        # connect that follows lost offline writes) must re-send the
        # unacked complement once the consumer tells us what is durable.
        # A clean first connect replays nothing — no spurious dups.
        self._replay_on_watermark = was_reconnect or bool(self._sent_at)
        if self._replay_on_watermark:
            # re-stamp so the retransmit timer defers to the imminent
            # watermark replay (it stays the fallback if the reply is
            # lost with yet another connection death)
            now = time.monotonic()
            for seq in self._sent_at:
                self._sent_at[seq] = now
        # every (re)connect re-estimates the link clock: the peer may be
        # a restarted process with a brand-new monotonic origin
        self.clock.resync()
        self._raw_send(encode_frame({
            "type": "hello", "run": self.run_id,
            "producer": self.producer,
            "t_send": time.monotonic(),
        }))
        if self._sock is None:  # the hello send itself failed
            return False
        self._ever_connected = True
        if was_reconnect:
            self.stats.reconnects += 1
            self._c_reconnects.inc()
            if self._runlog is not None:
                self._runlog.event(
                    "recovery", action="reconnect", channel=self.name,
                    producer=self.producer,
                    unacked=len(self._sent_at),
                )
        return True

    def _on_watermark(self, acked: Sequence[int]) -> None:
        """Process the handshake reply: reconcile the unacked set
        against the consumer's ack watermark, then replay exactly the
        still-unacked chunks — and nothing else."""
        for seq in acked:
            if self._sent_at.pop(int(seq), None) is not None:
                self._chunks.pop(int(seq), None)
                self.stats.acked += 1
        if not self._replay_on_watermark:
            return
        self._replay_on_watermark = False
        for seq in sorted(self._sent_at):
            chunk = self._chunks.get(seq)
            if chunk is None:
                continue
            self._transmit(chunk)
            self._sent_at[seq] = time.monotonic()
            self.stats.retransmits += 1
            self.telemetry.on_retransmit()

    def _ensure_connected(self,
                          deadline: Optional[float] = None) -> bool:
        """Reconnect loop: capped exponential backoff with FULL jitter
        (every waiter picks uniform-random inside the cap, so a fleet of
        workers reconnecting to a restarted consumer cannot stampede in
        lockstep)."""
        if self._sock is not None:
            return True
        attempt = 0
        while True:
            if self._connect_once():
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            cap = min(self.cfg.backoff_s, _BACKOFF_BASE_S * (2 ** attempt))
            delay = random.uniform(0, cap)
            if deadline is not None:
                delay = min(delay, max(deadline - time.monotonic(), 0))
            time.sleep(delay)
            attempt += 1

    # -- wire ----------------------------------------------------------------
    def _raw_send(self, frame: bytes) -> None:
        if self._sock is None:
            return  # lost write: stays unacked, reconnect+replay heals it
        try:
            self._sock.settimeout(self.cfg.connect_timeout_s)
            self._sock.sendall(frame)
            self.stats.bytes_sent += len(frame)
            self._c_bytes.inc(len(frame))
            self.telemetry.on_send(len(frame))
        except OSError:
            self._close_sock()

    def _transmit(self, chunk: EmbeddingChunk) -> None:
        """Serialize + send one chunk frame, with the frame-layer chaos
        injectors applied here — host-side, inside the transport, so
        chaos runs compile the same programs as clean runs."""
        frame = encode_frame(
            {"type": "chunk", "seq": chunk.seq, "producer": self.producer},
            chunk_to_blob(chunk),
        )
        idx = self._frame_idx
        self._frame_idx += 1
        chaos = self._chaos
        if chaos:
            delay = chaos.delay_frame(idx)
            if delay:
                time.sleep(delay)
            if chaos.corrupts_frame(idx):
                # flip bytes INSIDE the body, after the digest was
                # computed: framing survives, the digest check must not
                corrupted = bytearray(frame)
                body_at = _PREFIX.size + _DIGEST_SIZE
                for off in range(body_at + 8, min(body_at + 24, len(corrupted))):
                    corrupted[off] ^= 0xFF
                frame = bytes(corrupted)
            if chaos.drops_conn(idx):
                # a torn write: half the frame lands, then the wire dies
                half = frame[: len(frame) // 2]
                if self._sock is not None:
                    try:
                        self._sock.settimeout(self.cfg.connect_timeout_s)
                        self._sock.sendall(half)
                        self.stats.bytes_sent += len(half)
                        self._c_bytes.inc(len(half))
                        self.telemetry.on_send(len(half))
                    except OSError:
                        pass
                self._close_sock()
                self.stats.dropped += 1
                return
            if chaos.reorders_frame(idx):
                self._reorder_held = frame
                return
        self._raw_send(frame)
        if chaos and self._reorder_held is not None:
            held, self._reorder_held = self._reorder_held, None
            self._raw_send(held)

    def _drain_acks(self) -> None:
        """Non-blocking sweep of the consumer->producer stream (acks)."""
        if self._sock is None:
            return
        while True:
            try:
                self._sock.settimeout(0.0)
                data = self._sock.recv(1 << 16)
            except (BlockingIOError, InterruptedError, socket.timeout):
                return
            except OSError:
                self._close_sock()
                return
            if not data:
                self._close_sock()
                return
            self._buf.feed(data)
            try:
                frames = self._buf.frames()
            except FrameError:
                self._close_sock()
                return
            for header, _ in frames:
                if header.get("type") == "ack":
                    seq = int(header.get("seq", -1))
                    if self._sent_at.pop(seq, None) is not None:
                        self._chunks.pop(seq, None)
                        self.stats.acked += 1
                elif header.get("type") == "hello_ack":
                    self._fold_clock_sample(header)
                    self._on_watermark(header.get("acked", []))

    def _fold_clock_sample(self, header: dict) -> None:
        """Complete the four-timestamp sample the ``hello`` opened: the
        ``hello_ack`` echoes ``t_send`` and carries the consumer's
        ``t_recv``/``t_reply``; the ack stamp is taken here, when the
        reply surfaces from the drain. One ``clock_sync`` event per
        folded sample."""
        if "t_send" not in header:
            return  # pre-clock peer: no sample, offset stays 0
        try:
            sample = ClockSample(
                t_send=float(header["t_send"]),
                t_recv=float(header["t_recv"]),
                t_reply=float(header["t_reply"]),
                t_ack=time.monotonic(),
            )
        except (KeyError, TypeError, ValueError):
            return  # malformed stamps: drop the sample, never the link
        est = self.clock.update(sample)
        emit_clock_sync(self._runlog, self.clock, est)

    def _update_depth(self) -> None:
        self.telemetry.set_depth(
            unacked=len(self._sent_at), capacity=self.cfg.capacity,
            oldest_sent_at=min(self._sent_at.values())
            if self._sent_at else None,
        )

    # -- the channel surface --------------------------------------------------
    def credits(self) -> int:
        self._drain_acks()
        self._update_depth()
        return max(self.cfg.capacity - len(self._sent_at), 0)

    def unacked_seqs(self) -> List[int]:
        self._drain_acks()
        return sorted(self._sent_at)

    def send(self, chunk: EmbeddingChunk,
             timeout: Optional[float] = None) -> None:
        """Blocks (polling) while every credit is in flight — identical
        credit/backpressure semantics to the other transports, with the
        connection managed underneath."""
        deadline = None if timeout is None else time.monotonic() + timeout
        self._ensure_connected(deadline)
        blocked_at = None
        while self.credits() <= 0:
            if blocked_at is None:
                blocked_at = time.monotonic()
                if self._episode_seq != chunk.seq:
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
        self._transmit(chunk)
        if self._chaos is not None and self._chaos.dups_chunk(chunk.seq):
            self._transmit(chunk)

    def pump_retransmits(self, now: Optional[float] = None) -> int:
        """Re-send unacked chunks past the timer; a dead connection is
        re-established first (its handshake-watermark replay covers
        every unacked chunk the moment the ``hello_ack`` arrives, and
        the timer below stays the fallback)."""
        self._drain_acks()
        self._update_depth()
        if self._sock is None and self._sent_at:
            # ONE connect attempt per pump: the caller's poll loop is
            # the backoff here, and a worker must keep renewing its
            # lease between attempts — a blocking reconnect loop inside
            # the pump would read as a dead worker (the send path keeps
            # the jittered backoff, bounded by its own timeout)
            if not self._connect_once():
                return 0
            self._drain_acks()  # the watermark reply may already be in
            return len(self._sent_at)
        now = time.monotonic() if now is None else now
        n = 0
        for seq, sent_at in list(self._sent_at.items()):
            if now - sent_at >= self.cfg.retransmit_s:
                chunk = self._chunks.get(seq)
                if chunk is None:
                    continue
                self._transmit(chunk)
                self._sent_at[seq] = now
                self.stats.retransmits += 1
                self.telemetry.on_retransmit()
                n += 1
        return n

    def close(self) -> None:
        self._close_sock()


# ---------------------------------------------------------------------------
# transport selection (the worker/pipeline seam)
# ---------------------------------------------------------------------------

TRANSPORTS = ("dir", "tcp")


def transport_name(explicit: Optional[str] = None) -> str:
    """Resolve the cross-process transport: the plan document's value
    wins (every process sees the same choice), else the
    ``GIGAPATH_DIST_TRANSPORT`` env snapshot (host-side, read at
    construction), else the directory dryrun stand-in."""
    name = (explicit or os.environ.get("GIGAPATH_DIST_TRANSPORT", "")
            or "dir").strip().lower()
    if name not in TRANSPORTS:
        raise ValueError(
            f"GIGAPATH_DIST_TRANSPORT={name!r}: known transports "
            f"{TRANSPORTS}"
        )
    return name


def make_producer(root: str, config: Optional[BoundaryConfig] = None, *,
                  producer: str = "", runlog=None, chaos=None,
                  transport: Optional[str] = None, run_id: str = ""):
    """The producing half of the selected transport — the one seam
    ``worker.py`` calls, so switching transports changes zero lines of
    the produce/fold path."""
    name = transport_name(transport)
    if name == "tcp":
        return TcpChannelProducer(root, config, producer=producer,
                                  runlog=runlog, chaos=chaos, run_id=run_id)
    from gigapath_tpu_torch.dist.boundary import DirChannelProducer

    return DirChannelProducer(root, config, producer=producer,
                              runlog=runlog, chaos=chaos)


def make_consumer(root: str, config: Optional[BoundaryConfig] = None, *,
                  runlog=None, transport: Optional[str] = None,
                  delivered: Optional[Sequence[int]] = None,
                  run_id: str = ""):
    """The consuming half of the selected transport (``pipeline.py``'s
    seam). ``delivered`` is the restarted consumer's checkpoint
    watermark."""
    name = transport_name(transport)
    if name == "tcp":
        return TcpChannelConsumer(root, config, runlog=runlog,
                                  delivered=delivered, run_id=run_id)
    from gigapath_tpu_torch.dist.boundary import DirChannelConsumer

    return DirChannelConsumer(root, config, runlog=runlog,
                              delivered=delivered)
