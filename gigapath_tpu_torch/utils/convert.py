"""Checkpoint conversion (counterpart of ``gigapath_tpu/utils/torch_convert.py``).

- :func:`load_torch_state_dict` reads a reference ``.pth`` file.
- :func:`state_dict_from_flax_params` turns a JAX-package parameter tree
  (nested dicts of numpy arrays) into the port's ``state_dict``: the inverse
  of the JAX package's ``convert_torch_entry``. Dense ``kernel`` [in, out]
  becomes ``weight`` [out, in], a 4-D conv kernel goes from HWIO back to
  OIHW, a norm ``scale`` becomes ``weight``, and flax's ``layers_N``
  becomes ``layers.N``.
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

    Takes a slide encoder's tree or a ``ClassificationHead``'s, whose
    ``slide_encoder`` and ``classifier`` subtrees become the key prefixes
    of the same names."""
    out = {}
    for path, value in _flatten(params):
        arr = np.asarray(value, dtype=np.float32)
        parts = list(path)
        leaf = parts[-1]
        if leaf == "kernel":
            parts[-1] = "weight"
            arr = arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
        elif leaf == "scale":
            parts[-1] = "weight"
        key = re.sub(r"\blayers_(\d+)\b", r"layers.\1", ".".join(parts))
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out
