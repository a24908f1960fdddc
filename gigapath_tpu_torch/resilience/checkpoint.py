"""Hardened checkpoints: atomic saves, verified restores, rotation,
emergency SIGTERM snapshots (counterpart of
``gigapath_tpu/resilience/checkpoint.py``).

:mod:`gigapath_tpu_torch.utils.checkpoint` serializes a state dict with
``torch.save``; this module makes those serializations survivable, with the
JAX module's on-disk discipline:

- **atomic**: every save lands in a ``.tmp-*`` directory and is renamed
  into place — a SIGKILL mid-write leaves a stale tmp dir, never a
  half-written "latest" checkpoint;
- **verified**: a ``manifest.json`` of per-file sha256 digests is written
  with each save and re-hashed on restore, so bit rot or a truncated copy
  is a detected failure, not silently-wrong state;
- **rotated**: keep-last-K by step, with a ``best.json`` pointer that pins
  the best-scoring checkpoint outside the rotation window;
- **resumable**: :meth:`ResilientCheckpointer.restore_latest` scans
  newest-first and falls back past any corrupt or unreadable checkpoint,
  emitting an ``anomaly`` event (``detector="corrupt_checkpoint"``) per
  skip and a ``recovery`` event (``action="resume"``) for the one it lands
  on;
- **preemption-safe**: :meth:`arm_sigterm_checkpoint` chains an emergency
  final save through :mod:`gigapath_tpu_torch.obs.flight`'s single SIGTERM
  handler, after the flight dump and before process death.

A checkpoint directory holds ``state.pt`` (the state dict; numpy arrays and
numpy scalars are stored as tensors, every tensor moved to the CPU) and
``manifest.json``. A restore returns the state with CPU tensors, which the
caller places on its device.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from gigapath_tpu_torch.resilience.chaos import NullChaos

_PREFIX = "ckpt-"
_STATE_FILE = "state.pt"
_MANIFEST = "manifest.json"
_BEST = "best.json"


def _sha256_file(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


def _hash_tree(root: str) -> Dict[str, str]:
    """Relative path -> sha256 for every file under ``root`` (manifest
    excluded — it describes the tree, it is not part of it)."""
    out: Dict[str, str] = {}
    for dirpath, _, files in os.walk(root):
        for name in sorted(files):
            if dirpath == root and name == _MANIFEST:
                continue
            full = os.path.join(dirpath, name)
            out[os.path.relpath(full, root)] = _sha256_file(full)
    return out


def _tensors(state):
    """numpy leaves -> tensors (``torch.load(weights_only=True)`` reads
    tensors, not numpy objects); dicts, lists and tuples recursively."""
    if isinstance(state, (np.ndarray, np.generic)):
        return torch.from_numpy(np.ascontiguousarray(state))
    if isinstance(state, dict):
        return {k: _tensors(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_tensors(v) for v in state)
    return state


class ResilientCheckpointer:
    """See module docstring. ``runlog=None`` emits nothing (obs off —
    a ``NullRunLog`` whose events are no-ops)."""

    def __init__(self, directory: str, *, keep: int = 3, runlog=None,
                 chaos=None):
        self.dir = os.path.abspath(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.keep = max(int(keep), 1)
        if runlog is None:
            from gigapath_tpu_torch.obs.runlog import NullRunLog

            runlog = NullRunLog(driver="checkpoint", echo=False)
        self.runlog = runlog
        self.chaos = chaos if chaos is not None else NullChaos()
        self._sigterm_cb: Optional[Callable] = None

    # -- naming -----------------------------------------------------------
    def _name(self, step: int) -> str:
        return f"{_PREFIX}{int(step):08d}"

    def path_for(self, step: int) -> str:
        return os.path.join(self.dir, self._name(step))

    def checkpoints(self) -> List[Tuple[int, str]]:
        """[(step, path)] ascending by step; corrupt ones included —
        ``restore_latest`` verifies, listing does not."""
        out = []
        for name in os.listdir(self.dir):
            if not name.startswith(_PREFIX):
                continue
            try:
                step = int(name[len(_PREFIX):])
            except ValueError:
                continue
            full = os.path.join(self.dir, name)
            if os.path.isdir(full):
                out.append((step, full))
        return sorted(out)

    # -- save -------------------------------------------------------------
    def save(self, step: int, state: Dict[str, Any]) -> str:
        """Atomic verified save of a state dict (tensors on any device,
        numpy arrays, plain values)."""
        from gigapath_tpu_torch.utils.checkpoint import save_checkpoint

        final = self.path_for(step)
        # a valid checkpoint for this exact step already on disk (a SIGTERM
        # emergency save racing the periodic save it just made): keep it —
        # rmtree-before-rename here would destroy the only valid latest
        # checkpoint in the window before the new rename commits
        if os.path.isdir(final) and self.verify(final):
            return final
        tmp = os.path.join(self.dir, f".tmp-{self._name(step)}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        save_checkpoint(os.path.join(tmp, _STATE_FILE), _tensors(state))
        manifest = {
            "step": int(step),
            "files": _hash_tree(tmp),
        }
        with open(os.path.join(tmp, _MANIFEST), "w", encoding="utf-8") as fh:
            json.dump(manifest, fh, indent=1, sort_keys=True)
        # the rename is the commit: readers either see the old world or the
        # complete new checkpoint, never a partial write (only a corrupt or
        # absent ``final`` ever gets replaced — see above)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._rotate()
        return final

    def _rotate(self) -> None:
        """Keep the newest ``keep`` checkpoints plus the best-pinned one."""
        ckpts = self.checkpoints()
        if len(ckpts) <= self.keep:
            return
        best = self.best()
        pinned = best["name"] if best else None
        for step, path in ckpts[: len(ckpts) - self.keep]:
            if os.path.basename(path) == pinned:
                continue
            shutil.rmtree(path, ignore_errors=True)

    # -- best pointer -----------------------------------------------------
    def mark_best(self, step: int, score: float) -> None:
        tmp = os.path.join(self.dir, f".tmp-{_BEST}-{os.getpid()}")
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump({"name": self._name(step), "score": float(score)}, fh)
        os.replace(tmp, os.path.join(self.dir, _BEST))

    def best(self) -> Optional[dict]:
        try:
            with open(os.path.join(self.dir, _BEST), encoding="utf-8") as fh:
                return json.load(fh)
        except (OSError, ValueError):
            return None

    # -- verify / restore -------------------------------------------------
    def verify(self, path: str) -> bool:
        """Re-hash a checkpoint against its manifest. False on any
        missing/mismatched/extra-manifest condition — never raises."""
        try:
            with open(os.path.join(path, _MANIFEST), encoding="utf-8") as fh:
                manifest = json.load(fh)
            expected = manifest["files"]
        except (OSError, ValueError, KeyError):
            return False
        try:
            return _hash_tree(path) == expected
        except OSError:
            return False

    def restore(self, path: str) -> Dict[str, Any]:
        """The state of one checkpoint directory, tensors on the CPU."""
        from gigapath_tpu_torch.utils.checkpoint import restore_checkpoint

        return restore_checkpoint(os.path.join(path, _STATE_FILE))

    def restore_latest(
        self, *, emit_resume: bool = True,
    ) -> Optional[Tuple[Dict[str, Any], int]]:
        """The resume scan: the newest valid checkpoint wins; a corrupt one
        is skipped with an ``anomaly`` event and the scan falls back to the
        previous. None when nothing valid exists. ``emit_resume=False`` for
        callers that report their own recovery action (the dist consumer's
        ``consumer_resume``)."""
        candidates = list(reversed(self.checkpoints()))
        if candidates and self.chaos and self.chaos.corrupts_checkpoint():
            corrupted = self.chaos.corrupt_checkpoint(candidates[0][1])
            self.runlog.echo(
                f"[chaos] corrupted latest checkpoint file: {corrupted}"
            )
        fallbacks = 0
        for step, path in candidates:
            if not self.verify(path):
                self.runlog.event(
                    "anomaly", detector="corrupt_checkpoint", step=step,
                    path=path, value=None,
                )
                self.runlog.echo(
                    f"[resume] checkpoint {os.path.basename(path)} failed "
                    "manifest verification; falling back"
                )
                fallbacks += 1
                continue
            try:
                state = self.restore(path)
            except Exception as e:
                self.runlog.event(
                    "anomaly", detector="corrupt_checkpoint", step=step,
                    path=path, error=f"{type(e).__name__}: {e}",
                )
                fallbacks += 1
                continue
            if emit_resume:
                self.runlog.event(
                    "recovery", action="resume", step=step, path=path,
                    fallbacks=fallbacks,
                )
            return state, step
        return None

    # -- SIGTERM emergency checkpoint -------------------------------------
    def arm_sigterm_checkpoint(
        self, state_provider: Callable[[], Optional[Tuple[int, Dict[str, Any]]]]
    ) -> bool:
        """Chain a final checkpoint through the flight recorder's SIGTERM
        handler: ``state_provider() -> (step, state) | None`` supplies the
        last completed step's state (the caller updates it each step). Runs
        after the flight dump; the process still dies after (resumption is
        the next process's job)."""
        from gigapath_tpu_torch.obs.flight import register_signal_callback

        def _emergency(signum) -> bool:
            try:
                provided = state_provider()
                if provided is not None:
                    step, state = provided
                    path = self.save(step, state)
                    # signal-safe obs: the handler may have interrupted the
                    # main thread INSIDE runlog.event() holding its write
                    # lock — the *_from_signal paths try-acquire and drop
                    # on contention instead of self-deadlocking
                    self.runlog.event_from_signal(
                        "recovery", action="emergency_checkpoint",
                        step=step, path=path, signal=int(signum),
                    )
                    self.runlog.echo_from_signal(
                        f"[sigterm] emergency checkpoint at step {step} "
                        f"-> {path}"
                    )
            except Exception:  # a failed save must not mask the signal
                pass
            return False  # not a graceful claim: the process dies next

        self._sigterm_cb = _emergency
        return register_signal_callback(_emergency)

    def disarm(self) -> None:
        if self._sigterm_cb is not None:
            from gigapath_tpu_torch.obs.flight import unregister_signal_callback

            unregister_signal_callback(self._sigterm_cb)
            self._sigterm_cb = None
