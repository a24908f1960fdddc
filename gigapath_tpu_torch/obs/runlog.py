"""Host-side settings of the run log (the port's copy of the part of
``gigapath_tpu/obs/runlog.py`` that the ported paths read).

The run log itself (events, spans, heartbeat, compile watchdog) is not
ported yet (``ROADMAP.md`` Queue A item 15).
"""

from __future__ import annotations

import os


def env_number(name: str, default: float) -> float:
    """The numeric environment setting ``name``; unset, blank or
    unparseable gives ``default``. Read on the host when an object is built,
    never per step."""
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return float(default)
    try:
        return float(raw)
    except ValueError:
        return float(default)
