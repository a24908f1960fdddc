"""Lease-based worker liveness and elastic degradation.

The port's copy of ``gigapath_tpu/dist/membership.py`` (host-side Python: no torch
or jax here), names and event schema unchanged.

A cross-stage pipeline cannot ask a dead worker whether it is dead; it
can only notice the silence. Every worker of either stage holds a
*lease* — a small JSON file under ``<root>/members/`` it re-writes
(atomic tmp+rename) every ``lease_s / 3`` while alive. The consumer side
(:class:`Membership`) polls the lease directory; a lease past its expiry
is a lost worker:

1. a schema'd ``worker_lost`` event lands on the obs bus (the anomaly
   engine's ``worker_lost`` detector reacts with a flight dump — the
   post-mortem context for *why* the fleet shrank);
2. the coordinator computes the lost worker's UNACKED chunk ids (its
   assignment minus what the boundary channel has delivered) and
   re-assigns them across the survivors via the same deterministic
   :func:`~gigapath_tpu_torch.dist.boundary.assign_chunks` plan, emitting a
   ``recovery`` event (``action="reassign"``);
3. survivors poll ``<root>/reassign/`` and pick up the ranges addressed
   to them — the slide completes with bit-parity to the clean run,
   because chunk ids (and therefore the assembled bytes) never depended
   on who produced them.

Files, not sockets, because the dryrun milestone is two process groups
on ONE machine (ROADMAP item 4) and a shared directory is the transport
both already have; the lease/reassign protocol itself is
transport-agnostic. numpy-free, jax-free, stdlib only.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Dict, List, Optional, Sequence

from gigapath_tpu_torch.obs.runlog import env_number

DEFAULT_LEASE_S = 5.0


def lease_seconds() -> float:
    """``GIGAPATH_DIST_LEASE_S`` (host-side, read at construction)."""
    return env_number("GIGAPATH_DIST_LEASE_S", DEFAULT_LEASE_S)


def _members_dir(root: str) -> str:
    return os.path.join(root, "members")


def _reassign_dir(root: str) -> str:
    return os.path.join(root, "reassign")


def atomic_write_json(path: str, doc: dict, *, indent=None,
                      sort_keys: bool = False) -> str:
    """The dist layer's ONE atomic JSON write (tmp + ``os.replace`` —
    a reader never sees a torn document, a SIGKILL mid-write leaves
    only a tmp file nobody scans). Leases, reassignments and the plan
    document all go through here."""
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=indent, sort_keys=sort_keys)
    os.replace(tmp, path)
    return path


def _read_json(path: str) -> Optional[dict]:
    try:
        with open(path, encoding="utf-8") as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None  # racing rename / torn read: next poll sees it


class WorkerLease:
    """One worker's liveness claim. ``renew()`` is cheap enough to call
    every loop iteration — it only rewrites the file once a third of the
    lease has burned down."""

    def __init__(self, root: str, worker_id: str, *, stage: str = "tile",
                 lease_s: Optional[float] = None):
        self.root = root
        self.worker_id = worker_id
        self.stage = stage
        self.lease_s = lease_seconds() if lease_s is None else float(lease_s)
        self.path = os.path.join(_members_dir(root), f"lease-{worker_id}.json")
        os.makedirs(_members_dir(root), exist_ok=True)
        self._renewed_at = 0.0
        self._seq = 0

    def register(self, now: Optional[float] = None) -> None:
        self._write(time.time() if now is None else now)

    def renew(self, now: Optional[float] = None) -> bool:
        """Rewrite the lease if a third of it has elapsed; True when a
        write happened."""
        now = time.time() if now is None else now
        if now - self._renewed_at < self.lease_s / 3.0:
            return False
        self._write(now)
        return True

    def _write(self, now: float) -> None:
        self._seq += 1
        atomic_write_json(self.path, {
            "worker": self.worker_id, "stage": self.stage,
            "renewed": now, "expires": now + self.lease_s,
            "pid": os.getpid(), "seq": self._seq,
        })
        self._renewed_at = now

    def retire(self) -> None:
        """Clean exit: remove the lease so the coordinator never counts
        an orderly shutdown as a loss."""
        try:
            os.unlink(self.path)
        except OSError:
            pass


def read_lease(root: str, worker_id: str) -> Optional[dict]:
    """One lease document, raw (no expiry judgment) — the restarted
    consumer reads its predecessor's stale lease for ``consumer_lost``
    post-mortem context (pid, last renewal)."""
    return _read_json(os.path.join(_members_dir(root),
                                   f"lease-{worker_id}.json"))


class Membership:
    """The consumer/coordinator's view of the worker fleet."""

    def __init__(self, root: str, *, runlog=None):
        self.root = root
        self._runlog = runlog
        self._lost: set = set()   # workers already reported lost
        os.makedirs(_members_dir(root), exist_ok=True)
        os.makedirs(_reassign_dir(root), exist_ok=True)

    def _leases(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for path in glob.glob(os.path.join(_members_dir(self.root),
                                           "lease-*.json")):
            doc = _read_json(path)
            if doc and doc.get("worker"):
                out[str(doc["worker"])] = doc
        return out

    def alive(self, now: Optional[float] = None) -> List[str]:
        now = time.time() if now is None else now
        return sorted(
            w for w, doc in self._leases().items()
            if float(doc.get("expires", 0)) > now and w not in self._lost
        )

    def poll_lost(self, now: Optional[float] = None) -> List[str]:
        """Workers whose lease expired since the last poll. Each loss is
        reported ONCE: a ``worker_lost`` event (new EVENT_KIND; the
        anomaly engine fires its ``worker_lost`` detector on it) with the
        expiry context a post-mortem needs."""
        now = time.time() if now is None else now
        newly_lost: List[str] = []
        for worker, doc in sorted(self._leases().items()):
            expires = float(doc.get("expires", 0))
            if expires > now or worker in self._lost:
                continue
            self._lost.add(worker)
            newly_lost.append(worker)
            if self._runlog is not None:
                self._runlog.event(
                    "worker_lost", worker=worker,
                    stage=doc.get("stage"),
                    expired_by_s=round(now - expires, 3),
                    last_renew=doc.get("renewed"), pid=doc.get("pid"),
                )
                self._runlog.echo(
                    f"[dist] worker_lost: {worker} (stage "
                    f"{doc.get('stage')}, lease expired "
                    f"{now - expires:.2f}s ago)"
                )
        return newly_lost

    def report_lost(self, worker: str, *, reason: str = "process_exit",
                    **info) -> bool:
        """Mark a worker lost from DIRECT evidence (the orchestrator
        watched its OS process die) instead of waiting out the lease —
        faster detection when the process handle is at hand, and the
        ONLY detection for a worker that died before its first
        ``register()`` (no lease file ever existed for the expiry path
        to notice). Same once-per-worker contract and ``worker_lost``
        event as :meth:`poll_lost`. Returns False when already lost."""
        if worker in self._lost:
            return False
        self._lost.add(worker)
        if self._runlog is not None:
            self._runlog.event("worker_lost", worker=worker,
                               reason=reason, **info)
            self._runlog.echo(f"[dist] worker_lost: {worker} ({reason})")
        return True

    def lost(self) -> List[str]:
        return sorted(self._lost)


# ---------------------------------------------------------------------------
# reassignment
# ---------------------------------------------------------------------------

def write_reassignment(root: str, *, lost_worker: str,
                       assignments: Dict[str, Sequence[int]],
                       runlog=None) -> str:
    """Publish a reassignment of a lost worker's unacked chunk ids to
    the survivors (one JSON file under ``<root>/reassign/``, atomic) and
    emit the ``recovery`` event (``action="reassign"``) the acceptance
    asserts on."""
    os.makedirs(_reassign_dir(root), exist_ok=True)
    n = len(glob.glob(os.path.join(_reassign_dir(root), "reassign-*.json")))
    path = os.path.join(_reassign_dir(root), f"reassign-{n:04d}.json")
    doc = {
        "lost": lost_worker,
        "assignments": {w: sorted(int(c) for c in cs)
                        for w, cs in assignments.items()},
    }
    atomic_write_json(path, doc)
    if runlog is not None:
        total = sum(len(cs) for cs in assignments.values())
        runlog.recovery(
            action="reassign", worker=lost_worker, chunks=total,
            survivors=sorted(assignments), path=path,
        )
        runlog.echo(
            f"[dist] reassign: {total} unacked chunk(s) of {lost_worker} "
            f"-> {sorted(assignments)}"
        )
    return path


def reassignments_for(root: str, worker_id: str,
                      seen: Optional[set] = None) -> List[int]:
    """Chunk ids newly re-assigned TO ``worker_id``. ``seen`` (mutated)
    tracks processed reassignment files across calls so each file is
    honored once per worker."""
    out: List[int] = []
    for path in sorted(glob.glob(os.path.join(_reassign_dir(root),
                                              "reassign-*.json"))):
        name = os.path.basename(path)
        if seen is not None:
            if name in seen:
                continue
            doc = _read_json(path)
            if doc is None:
                continue  # torn read: retry next poll, don't mark seen
            seen.add(name)
        else:
            doc = _read_json(path)
            if doc is None:
                continue
        out.extend(int(c) for c in
                   (doc.get("assignments") or {}).get(worker_id, []))
    return sorted(set(out))
