"""Embedding-drift helpers (the port's copy of the part of
``gigapath_tpu/obs/drift.py`` that the streaming serve path reads).

The ``DriftSentinel``, the embedding sketches and the metrics histogram are
not ported yet (``ROADMAP.md`` Queue A item 15).
"""

from __future__ import annotations

import numpy as np

from gigapath_tpu_torch.obs.runlog import env_number


def cosine(a, b, eps: float = 1e-12) -> float:
    """Cosine similarity of two vectors (0.0 when either is ~zero)."""
    a = np.asarray(a, np.float64).reshape(-1)
    b = np.asarray(b, np.float64).reshape(-1)
    na, nb = float(np.linalg.norm(a)), float(np.linalg.norm(b))
    if na < eps or nb < eps:
        return 0.0
    return float(np.dot(a, b) / (na * nb))


def stream_peek_every() -> int:
    """``GIGAPATH_DRIFT_PEEK_EVERY``: peek a streaming session every N folded
    chunks (0 = off, the default: a peek is a real readout pass). Read once,
    when a submitter is built."""
    return max(int(env_number("GIGAPATH_DRIFT_PEEK_EVERY", 0)), 0)
