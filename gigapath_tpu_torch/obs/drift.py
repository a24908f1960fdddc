"""Embedding drift sentinel: the model-health half of the obs bus.

The port's copy of ``gigapath_tpu/obs/drift.py`` (host-side Python: no torch
or jax here), names and event schema unchanged.

A quant-tier regression, a corrupt checkpoint, or a shifted tile
population serves garbage embeddings at a perfect p99 — nothing in the
system-side bus can see it. This module watches the *distribution* of
served slide embeddings:

- :class:`EmbeddingSketch` — a mergeable streaming summary per
  embedding dimension (count / mean / M2, the Welford-Chan moments —
  the ONE sanctioned home of running-moment accumulators, gigalint
  GL023) plus a coarse fixed-edge histogram of embedding norms for
  quantile/tail questions. ``merge`` is the Chan parallel fold, so
  per-process sketches combine into a fleet sketch; ``save``/``load``
  persist baseline artifacts with the resilient-checkpoint manifest
  discipline (``.tmp-*`` staging + per-file sha256 ``manifest.json`` +
  atomic rename — corruption is a loud :class:`CorruptDriftArtifact`,
  never silently-wrong baselines).
- :func:`drift_scores` — current-vs-baseline: standardized mean shift
  (mean over dims of |Δmean|/σ_baseline), cosine distance between the
  mean embeddings, and tail mass (fraction of current norms above the
  baseline's q99).
- :class:`DriftSentinel` — the online monitor: every served embedding
  folds into the current sketch; at a cadence the scores are computed,
  exported as :mod:`gigapath_tpu_torch.obs.metrics` gauges, and — TRANSITION-
  EDGED, the SloTracker discipline — a ``drift`` event fires on each
  entry into / exit from the alarming state. The anomaly engine's
  ``embedding_drift`` detector turns the alarming transition into the
  usual reactions (flight dump + armed profiler capture, cooldown);
  terminal status events are marked ``final`` and never fire it.

All host-side, numpy-only (no jax import — a baseline must load on a
workstation far from any chip); deterministic update order makes
restart-resume bit-exact (pinned by ``tests/test_model_health.py``).
Env knobs (``GIGAPATH_DRIFT_EVERY`` / ``GIGAPATH_DRIFT_THRESHOLD`` /
``GIGAPATH_DRIFT_MIN_COUNT`` / ``GIGAPATH_DRIFT_PEEK_EVERY``) are read
ONCE at sentinel construction — driver start, host-side (GL001-clean).
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
from typing import Dict, Optional

import numpy as np

DRIFT_SCHEMA_VERSION = 1

_MANIFEST = "manifest.json"
_SKETCH_FILE = "sketch.npz"


class CorruptDriftArtifact(ValueError):
    """A drift baseline failed manifest verification (missing file,
    digest mismatch, malformed metadata). Loud by design — restoring a
    rotted baseline would turn every healthy run into an alarm (or
    every drifted run into silence)."""


def _sha256_file(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


def cosine(a, b, eps: float = 1e-12) -> float:
    """Cosine similarity of two vectors (0.0 when either is ~zero)."""
    a = np.asarray(a, np.float64).reshape(-1)
    b = np.asarray(b, np.float64).reshape(-1)
    na, nb = float(np.linalg.norm(a)), float(np.linalg.norm(b))
    if na < eps or nb < eps:
        return 0.0
    return float(np.dot(a, b) / (na * nb))


class EmbeddingSketch:
    """Mergeable streaming summary of an embedding population.

    Per-dimension Welford moments (count, mean, M2 — variance without a
    second pass) plus a fixed-edge norm histogram: ``bins`` equal-width
    buckets over ``[0, hi)`` and one overflow bucket. Fixed edges make
    two sketches mergeable bucket-wise (the metrics-histogram rule: a
    merge across two ladders would be a silent lie); ``hi`` defaults to
    ``4 * sqrt(dim)``, generous for unit-ish-scale embedding entries.
    """

    def __init__(self, dim: int, *, bins: int = 64,
                 hi: Optional[float] = None):
        if int(dim) < 1:
            raise ValueError(f"dim must be >= 1, got {dim}")
        if int(bins) < 1:
            raise ValueError(f"bins must be >= 1, got {bins}")
        self.dim = int(dim)
        self.bins = int(bins)
        self.hi = float(hi) if hi is not None else 4.0 * math.sqrt(self.dim)
        if self.hi <= 0:
            raise ValueError(f"hi must be > 0, got {self.hi}")
        self.count = 0
        self.mean = np.zeros(self.dim, np.float64)
        self.m2 = np.zeros(self.dim, np.float64)
        # bins equal-width norm buckets over [0, hi) + one overflow
        self.hist = np.zeros(self.bins + 1, np.int64)

    # -- streaming update (Welford) ---------------------------------------
    def update(self, vec) -> None:
        """Fold one embedding. Deterministic given arrival order — the
        restart-resume bit-exactness contract rides on this."""
        vec = np.asarray(vec, np.float64).reshape(-1)
        if vec.shape[0] != self.dim:
            raise ValueError(
                f"sketch dim {self.dim} cannot fold a {vec.shape[0]}-dim "
                f"embedding"
            )
        self.count += 1
        delta = vec - self.mean
        self.mean = self.mean + delta / self.count
        self.m2 = self.m2 + delta * (vec - self.mean)
        norm = float(np.linalg.norm(vec))
        idx = int(norm / self.hi * self.bins)
        self.hist[min(max(idx, 0), self.bins)] += 1

    # -- parallel fold (Chan) ---------------------------------------------
    def merge(self, other: "EmbeddingSketch") -> "EmbeddingSketch":
        """Chan's parallel-moments fold; returns a NEW sketch. Geometry
        (dim/bins/hi) must match — merging mismatched sketches would be
        the mismatched-bucket-ladder lie the metrics layer refuses."""
        if (self.dim, self.bins) != (other.dim, other.bins) or \
                not math.isclose(self.hi, other.hi):
            raise ValueError(
                f"cannot merge sketches with mismatched geometry "
                f"(dim {self.dim}/{other.dim}, bins {self.bins}/"
                f"{other.bins}, hi {self.hi:g}/{other.hi:g})"
            )
        out = EmbeddingSketch(self.dim, bins=self.bins, hi=self.hi)
        n = self.count + other.count
        out.count = n
        if n == 0:
            return out
        delta = other.mean - self.mean
        out.mean = self.mean + delta * (other.count / n)
        out.m2 = self.m2 + other.m2 + \
            delta * delta * (self.count * other.count / n)
        out.hist = self.hist + other.hist
        return out

    # -- derived stats ----------------------------------------------------
    def std(self) -> np.ndarray:
        """Per-dimension standard deviation (zeros below 2 samples)."""
        if self.count < 2:
            return np.zeros(self.dim, np.float64)
        return np.sqrt(self.m2 / self.count)

    def _edge(self, i: int) -> float:
        return self.hi * i / self.bins

    def quantile(self, q: float) -> float:
        """Nearest-rank norm quantile off the histogram: the containing
        bucket's UPPER edge (conservative, the histogram_quantile rule);
        ``inf`` for the overflow bucket, NaN when empty."""
        if self.count == 0:
            return float("nan")
        rank = min(self.count - 1, max(0, int(round(q * (self.count - 1)))))
        seen = 0
        for i in range(self.bins + 1):
            seen += int(self.hist[i])
            if rank < seen:
                return self._edge(i + 1) if i < self.bins else float("inf")
        return float("inf")  # unreachable

    def mass_above(self, v: float) -> float:
        """Fraction of folded norms in buckets wholly above ``v`` —
        conservative (under-counts a straddling bucket, never over)."""
        if self.count == 0 or not math.isfinite(v):
            return 0.0
        mass = 0
        for i in range(self.bins + 1):
            lo = self._edge(i) if i < self.bins else self.hi
            if lo >= v:
                mass += int(self.hist[i])
        return mass / self.count

    # -- persistence (manifest discipline) --------------------------------
    def save(self, path: str) -> str:
        """Atomic verified save into directory ``path``: arrays in
        ``sketch.npz``, metadata + per-file sha256 in ``manifest.json``,
        staged in ``.tmp-*`` and renamed into place — a SIGKILL
        mid-write leaves a stale tmp dir, never a half-written
        baseline."""
        path = os.path.abspath(path)
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        tmp = f"{path}.tmp-{os.getpid()}"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, _SKETCH_FILE), mean=self.mean,
                 m2=self.m2, hist=self.hist)
        manifest = {
            "v": DRIFT_SCHEMA_VERSION,
            "dim": self.dim, "bins": self.bins, "hi": self.hi,
            "count": self.count,
            "files": {_SKETCH_FILE: _sha256_file(
                os.path.join(tmp, _SKETCH_FILE))},
        }
        with open(os.path.join(tmp, _MANIFEST), "w", encoding="utf-8") as fh:
            json.dump(manifest, fh, sort_keys=True)
        if os.path.exists(path):
            old = f"{path}.old-{os.getpid()}"
            if os.path.exists(old):
                shutil.rmtree(old)
            os.rename(path, old)
            os.rename(tmp, path)
            shutil.rmtree(old)
        else:
            os.rename(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "EmbeddingSketch":
        """Verified restore: manifest re-hashed, geometry re-checked —
        any mismatch is a :class:`CorruptDriftArtifact`."""
        manifest_path = os.path.join(path, _MANIFEST)
        try:
            with open(manifest_path, "r", encoding="utf-8") as fh:
                manifest = json.load(fh)
        except (OSError, ValueError) as e:
            raise CorruptDriftArtifact(
                f"drift baseline {path}: unreadable manifest "
                f"({type(e).__name__}: {e})"
            )
        files = manifest.get("files")
        if not isinstance(files, dict) or _SKETCH_FILE not in files:
            raise CorruptDriftArtifact(
                f"drift baseline {path}: manifest lists no {_SKETCH_FILE}"
            )
        for name, digest in files.items():
            full = os.path.join(path, name)
            if not os.path.isfile(full):
                raise CorruptDriftArtifact(
                    f"drift baseline {path}: missing file {name}"
                )
            actual = _sha256_file(full)
            if actual != digest:
                raise CorruptDriftArtifact(
                    f"drift baseline {path}: sha256 mismatch for {name} "
                    f"(manifest {digest[:12]}..., file {actual[:12]}...)"
                )
        try:
            with np.load(os.path.join(path, _SKETCH_FILE)) as npz:
                mean = np.asarray(npz["mean"], np.float64)
                m2 = np.asarray(npz["m2"], np.float64)
                hist = np.asarray(npz["hist"], np.int64)
            out = cls(int(manifest["dim"]), bins=int(manifest["bins"]),
                      hi=float(manifest["hi"]))
            out.count = int(manifest["count"])
        except (KeyError, ValueError, TypeError) as e:
            raise CorruptDriftArtifact(
                f"drift baseline {path}: malformed payload "
                f"({type(e).__name__}: {e})"
            )
        if mean.shape != (out.dim,) or m2.shape != (out.dim,) or \
                hist.shape != (out.bins + 1,) or \
                out.count != int(hist.sum()):
            raise CorruptDriftArtifact(
                f"drift baseline {path}: geometry/count mismatch between "
                f"manifest and payload"
            )
        out.mean, out.m2, out.hist = mean, m2, hist
        return out


def drift_scores(current: EmbeddingSketch, baseline: EmbeddingSketch,
                 eps: float = 1e-6) -> Dict[str, float]:
    """Current-vs-baseline drift scores (all down-good):

    - ``mean_shift``  — mean over dims of |Δmean| / σ_baseline (the
      standardized shift; ``eps`` floors degenerate dims);
    - ``cosine_dist`` — 1 − cos(mean_current, mean_baseline);
    - ``tail_mass``   — fraction of current norms above the baseline's
      q99 (the per-channel-absmax outlier discipline, continuous)."""
    std = baseline.std()
    mean_shift = float(
        np.mean(np.abs(current.mean - baseline.mean) / (std + eps))
    )
    # fp rounding can put cos() a hair above 1.0; clamp so identical
    # means score exactly 0.0 (not -0.0) in reports and trend points
    cos_dist = max(0.0, 1.0 - cosine(current.mean, baseline.mean))
    tail = current.mass_above(baseline.quantile(0.99))
    return {
        "mean_shift": round(mean_shift, 6),
        "cosine_dist": round(cos_dist, 6),
        "tail_mass": round(tail, 6),
    }


def stream_peek_every() -> int:
    """``GIGAPATH_DRIFT_PEEK_EVERY`` snapshot: peek the streaming
    session every N folded chunks for the anytime-confidence surface
    (0 = off, the default — a peek is a real readout pass). Host-side,
    read once at submitter/consumer construction (GL001)."""
    from gigapath_tpu_torch.obs.runlog import env_number

    return max(int(env_number("GIGAPATH_DRIFT_PEEK_EVERY", 0)), 0)


class DriftSentinel:
    """Online drift monitor over served embeddings (see module
    docstring). ``every``/``threshold``/``min_count`` default to the
    ``GIGAPATH_DRIFT_*`` env knobs, snapshotted here at construction.
    """

    def __init__(self, baseline: EmbeddingSketch, runlog=None, *,
                 metrics=None, every: Optional[int] = None,
                 threshold: Optional[float] = None,
                 min_count: Optional[int] = None,
                 name: str = "serve.drift"):
        from gigapath_tpu_torch.obs.runlog import env_number

        self.baseline = baseline
        self.current = EmbeddingSketch(baseline.dim, bins=baseline.bins,
                                       hi=baseline.hi)
        self.runlog = runlog
        self.metrics = metrics
        self.name = name
        self.every = int(every if every is not None
                         else env_number("GIGAPATH_DRIFT_EVERY", 4))
        self.threshold = float(
            threshold if threshold is not None
            else env_number("GIGAPATH_DRIFT_THRESHOLD", 4.0)
        )
        self.min_count = int(min_count if min_count is not None
                             else env_number("GIGAPATH_DRIFT_MIN_COUNT", 4))
        self.alarming = False
        self.transitions = 0
        self.scores: Optional[Dict[str, float]] = None

    def observe(self, embedding) -> Optional[dict]:
        """Fold one served embedding; at the cadence, score and —
        on an alarming-state TRANSITION — emit the ``drift`` event the
        anomaly engine's ``embedding_drift`` detector reacts to.
        Returns the emitted record on a transition, else None."""
        self.current.update(embedding)
        n = self.current.count
        if self.every <= 0 or n < self.min_count or n % self.every:
            return None
        return self._score_and_edge()

    def _score_and_edge(self) -> Optional[dict]:
        scores = drift_scores(self.current, self.baseline)
        self.scores = scores
        if self.metrics is not None:
            for key, val in scores.items():
                self.metrics.gauge(f"{self.name}.{key}").set(val)
        alarming_now = scores["mean_shift"] > self.threshold
        if alarming_now == self.alarming:
            return None
        self.alarming = alarming_now
        if alarming_now:
            self.transitions += 1
        if self.runlog is None:
            return None
        return self.runlog.event(
            "drift", name=self.name, alarming=alarming_now,
            threshold=self.threshold, count=self.current.count,
            baseline_count=self.baseline.count, **scores,
        )

    def status(self) -> dict:
        return dict(
            name=self.name, alarming=self.alarming,
            threshold=self.threshold, count=self.current.count,
            baseline_count=self.baseline.count,
            transitions=self.transitions,
            **(self.scores or {}),
        )

    def emit_status(self, reason: str = "final") -> None:
        """Terminal ``drift`` status event (marked ``final`` — the
        detector only reacts to transitions, the SloTracker rule)."""
        if self.runlog is None:
            return
        if self.current.count and self.scores is None:
            self.scores = drift_scores(self.current, self.baseline)
        self.runlog.event("drift", reason=reason, final=True,
                          **self.status())


__all__ = [
    "CorruptDriftArtifact",
    "DRIFT_SCHEMA_VERSION",
    "DriftSentinel",
    "EmbeddingSketch",
    "cosine",
    "drift_scores",
    "stream_peek_every",
]
