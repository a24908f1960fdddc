"""Checkpoint save/restore (counterpart of
``gigapath_tpu/utils/checkpoint.py``), with ``torch.save``/``torch.load`` in
place of Orbax.

A checkpoint is one file holding a dict of tensors and plain values (e.g.
``{"params": model.state_dict()}``), written to a temporary name and moved
into place. :class:`MonitorScore` keeps the best-score semantics of the JAX
package: the best score rides inside the checkpoint (``best_score``) and in
a ``<ckpt>.best.json`` sidecar, so a resumed run re-arms the monitor.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any, Dict, Optional

import torch


def _to_cpu(state):
    if isinstance(state, torch.Tensor):
        return state.detach().cpu()
    if isinstance(state, dict):
        return {k: _to_cpu(v) for k, v in state.items()}
    return state


def save_checkpoint(path: str, state: Dict[str, Any]) -> None:
    """Save a state dict (tensors moved to the CPU) to ``path``."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    torch.save(_to_cpu(state), tmp)
    os.replace(tmp, path)  # a reader never sees half a file


def restore_checkpoint(path: str) -> Dict[str, Any]:
    """Load a state dict written by :func:`save_checkpoint`, on the CPU."""
    return torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)


def checkpoint_exists(path: str) -> bool:
    return os.path.isfile(os.path.abspath(path))


class MonitorScore:
    """Best-score checkpoint monitor: saves when the score improves, with
    the score persisted in the checkpoint (``best_score``) and in a JSON
    sidecar that :meth:`from_checkpoint` reads first."""

    def __init__(self, best_score: Optional[float] = None):
        self.best_score = best_score

    @staticmethod
    def _sidecar(ckpt_name: str) -> str:
        return os.path.abspath(str(ckpt_name)) + ".best.json"

    @classmethod
    def from_checkpoint(cls, ckpt_name: str) -> "MonitorScore":
        """Re-arm from a previous run's best checkpoint: the sidecar first,
        the checkpoint's ``best_score`` as fallback, a fresh monitor when
        both are missing or unreadable."""
        try:
            with open(cls._sidecar(ckpt_name), encoding="utf-8") as fh:
                return cls(float(json.load(fh)["best_score"]))
        except (OSError, ValueError, KeyError, TypeError):
            pass
        if not checkpoint_exists(ckpt_name):
            return cls()
        try:
            score = restore_checkpoint(ckpt_name).get("best_score")
        except (OSError, RuntimeError, AttributeError, pickle.UnpicklingError):
            return cls()
        return cls(None if score is None else float(score))

    def __call__(self, val_score: float, state: Dict[str, Any], ckpt_name: str) -> bool:
        if self.best_score is None or val_score > self.best_score:
            self.best_score = val_score
            save_checkpoint(ckpt_name, {**state, "best_score": float(val_score)})
            # the sidecar after the checkpoint: a crash between the two
            # leaves a sidecar of the previous best, never one for a
            # checkpoint that was not written
            side = self._sidecar(ckpt_name)
            try:
                tmp = f"{side}.tmp-{os.getpid()}"
                with open(tmp, "w", encoding="utf-8") as fh:
                    json.dump({"best_score": float(val_score)}, fh)
                os.replace(tmp, side)
            except OSError:
                pass  # the checkpoint's own copy holds
            return True
        return False
