"""The quantized tile-encoder artifact (counterpart of
``gigapath_tpu/quant/convert.py``).

Same on-disk format as the JAX package's, so an artifact written by either
package loads in the other:

- ``arrays.npz``: one entry per leaf of the flax-path parameter tree
  (``blocks_0/attn/qkv/kernel``, ...): ``<path>.q`` int8 data or
  ``<path>.qf8`` fp8-e4m3 data as a uint8 bitcast, ``<path>.scale`` fp32,
  or ``<path>.raw`` for a leaf left unquantized;
- ``meta.json``: schema version, mode, counts;
- ``manifest.json``: the sha256 of every other file, checked on load: a
  missing, changed or extra file refuses the artifact
  (:class:`CorruptQuantArtifact`).

A save stages into a ``.tmp-*`` directory and renames it into place. What
is quantized: every 2-D ``kernel`` leaf (the qkv, proj, fc1 and fc2
matmuls, ``[in, out]`` with one scale per output channel, as the JAX
package lays them out). The trees here are nested dicts in flax paths with
numpy leaves and :class:`~.qtensor.QTensor` leaves of CPU tensors; the
port's ``state_dict`` maps to and from them through
:mod:`gigapath_tpu_torch.utils.convert`.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from gigapath_tpu_torch.quant.qtensor import QTensor, base_mode, dequantize, normalize_mode, quantize_per_channel

ARTIFACT_SCHEMA_VERSION = 1
_ARRAYS = "arrays.npz"
_META = "meta.json"
_MANIFEST = "manifest.json"


class CorruptQuantArtifact(ValueError):
    """A quantized artifact whose manifest verification failed."""


def _walk(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            yield from _walk(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _set(tree: Dict[str, Any], path: Tuple[str, ...], leaf) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def quantize_params(params: Dict[str, Any], mode: str) -> Dict[str, Any]:
    """Flax-path tree -> the same tree with every 2-D ``kernel`` leaf
    replaced by a :class:`QTensor` (per output channel, the last axis);
    other leaves pass through as numpy arrays."""
    mode = base_mode(normalize_mode(mode))
    out: Dict[str, Any] = {}
    for path, leaf in _walk(params):
        arr = np.asarray(leaf)
        if path[-1] == "kernel" and arr.ndim == 2:
            leaf = quantize_per_channel(torch.from_numpy(np.asarray(arr, np.float32)), mode, axis=-1)
        else:
            leaf = arr
        _set(out, path, leaf)
    return out


def dequantize_params(qparams: Dict[str, Any]) -> Dict[str, Any]:
    """QTensor leaves -> fp32 numpy arrays (``data * scale``); other leaves
    pass through."""
    out: Dict[str, Any] = {}
    for path, leaf in _walk(qparams):
        _set(out, path, dequantize(leaf).numpy() if isinstance(leaf, QTensor) else leaf)
    return out


def _sha256_file(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


def _hash_tree(root: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for dirpath, _, files in os.walk(root):
        for name in sorted(files):
            if dirpath == root and name == _MANIFEST:
                continue
            full = os.path.join(dirpath, name)
            out[os.path.relpath(full, root)] = _sha256_file(full)
    return out


def save_quantized(path: str, qparams: Dict[str, Any], *, meta: Optional[dict] = None) -> str:
    """Atomic verified save: stage in ``.tmp-*``, write the manifest, rename."""
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".tmp-{os.path.basename(path)}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)

    arrays: Dict[str, np.ndarray] = {}
    n_quant = n_raw = 0
    mode = ""
    for tree_path, leaf in _walk(qparams):
        key = "/".join(tree_path)
        if isinstance(leaf, QTensor):
            data = leaf.data.cpu()
            if data.dtype == torch.int8:
                arrays[f"{key}.q"] = data.numpy()
            else:  # fp8 rides the npz as a uint8 bitcast, bit-exact
                arrays[f"{key}.qf8"] = data.view(torch.uint8).numpy()
            arrays[f"{key}.scale"] = leaf.scale.cpu().float().numpy()
            mode = mode or leaf.mode
            n_quant += 1
        else:
            arrays[f"{key}.raw"] = np.asarray(leaf)
            n_raw += 1
    with open(os.path.join(tmp, _ARRAYS), "wb") as fh:
        np.savez(fh, **arrays)
    doc = {"v": ARTIFACT_SCHEMA_VERSION, "mode": mode, "n_quantized": n_quant, "n_raw": n_raw, **(meta or {})}
    with open(os.path.join(tmp, _META), "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
    manifest = {"v": ARTIFACT_SCHEMA_VERSION, "files": _hash_tree(tmp)}
    with open(os.path.join(tmp, _MANIFEST), "w", encoding="utf-8") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)
    shutil.rmtree(path, ignore_errors=True)
    os.rename(tmp, path)
    return path


def load_quantized(path: str, *, verify: bool = True) -> Tuple[Dict[str, Any], dict]:
    """Verified load: re-hash against the manifest first; any missing,
    changed or extra file refuses the artifact."""
    path = os.path.abspath(path)
    if verify:
        try:
            with open(os.path.join(path, _MANIFEST), encoding="utf-8") as fh:
                expected = json.load(fh)["files"]
        except (OSError, ValueError, KeyError) as e:
            raise CorruptQuantArtifact(f"{path}: unreadable manifest ({type(e).__name__}: {e})") from None
        actual = _hash_tree(path)
        if actual != expected:
            bad = sorted(set(expected.items()) ^ set(actual.items()))[:3]
            raise CorruptQuantArtifact(
                f"{path}: manifest verification failed (first deltas: {[name for name, _ in bad]})"
            )
    with open(os.path.join(path, _META), encoding="utf-8") as fh:
        meta = json.load(fh)
    staged: Dict[str, dict] = {}
    with np.load(os.path.join(path, _ARRAYS), allow_pickle=False) as z:
        for key in z.files:
            tree_key, _, kind = key.rpartition(".")
            staged.setdefault(tree_key, {})[kind] = z[key]
    qparams: Dict[str, Any] = {}
    for tree_key, parts in staged.items():
        if "raw" in parts:
            leaf = parts["raw"]
        elif "qf8" in parts:
            leaf = QTensor(torch.from_numpy(parts["qf8"]).view(torch.float8_e4m3fn), torch.from_numpy(parts["scale"]))
        else:
            leaf = QTensor(torch.from_numpy(parts["q"]), torch.from_numpy(parts["scale"]))
        _set(qparams, tuple(tree_key.split("/")), leaf)
    return qparams, meta
