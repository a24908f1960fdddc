"""Checkpoint conversion (counterpart of ``gigapath_tpu/utils/torch_convert.py``).

- :func:`load_torch_state_dict` reads a reference ``.pth`` file.
- :func:`state_dict_from_flax_params` turns a JAX-package parameter tree
  (nested dicts of numpy arrays) into the port's ``state_dict``: the inverse
  of the JAX package's ``convert_torch_entry``. Dense ``kernel`` [in, out]
  becomes ``weight`` [out, in], a 4-D conv kernel goes from HWIO back to
  OIHW, a norm ``scale`` becomes ``weight``, and flax's ``layers_N`` and
  ``blocks_N`` become ``layers.N`` and ``blocks.N``.
- :func:`flax_params_from_state_dict` is its inverse, for the tile
  encoder's and the slide encoder's names: it gives the flax-path tree the
  quantized artifact (:mod:`gigapath_tpu_torch.quant.convert`) stores.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch


def load_torch_state_dict(path: str) -> Dict[str, Any]:
    """Read a torch checkpoint file; unwraps ``{"model": ...}`` and
    ``{"model_state_dict": ...}``."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "model" in state and all(
        hasattr(v, "shape") for v in state["model"].values()
    ):
        state = state["model"]
    if isinstance(state, dict) and "model_state_dict" in state:
        state = state["model_state_dict"]
    return state


def _flatten(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_dict_from_flax_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX-package param tree -> the port's ``state_dict`` (fp32 CPU tensors).

    Takes a tile encoder's tree, a slide encoder's or a
    ``ClassificationHead``'s, whose ``slide_encoder`` and ``classifier``
    subtrees become the key prefixes of the same names."""
    out = {}
    for path, value in _flatten(params):
        arr = np.array(value, dtype=np.float32)  # a writable copy
        parts = list(path)
        leaf = parts[-1]
        if leaf == "kernel":
            parts[-1] = "weight"
            arr = arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
        elif leaf == "scale":
            parts[-1] = "weight"
        key = re.sub(r"\b(layers|blocks)_(\d+)\b", r"\1.\2", ".".join(parts))
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def flax_params_from_state_dict(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's ``state_dict`` -> a nested flax-path tree of fp32 numpy
    arrays, the inverse of :func:`state_dict_from_flax_params`: a 2-D
    ``weight`` becomes a transposed ``kernel``, a 4-D one an HWIO
    ``kernel``, a 1-D one (a LayerNorm's) ``scale``."""
    tree: Dict[str, Any] = {}
    for key, value in state.items():
        arr = value.detach().cpu().float().numpy()
        parts = re.sub(r"\b(layers|blocks)\.(\d+)\b", r"\1_\2", key).split(".")
        if parts[-1] == "weight":
            parts[-1] = "scale" if arr.ndim == 1 else "kernel"
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(2, 3, 1, 0)
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.ascontiguousarray(arr)
    return tree
