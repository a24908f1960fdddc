"""Checkpoint conversion (counterpart of ``gigapath_tpu/utils/torch_convert.py``).

- :func:`load_torch_state_dict` reads a reference ``.pth`` file.
- :func:`state_dict_from_flax_params` turns a JAX-package parameter tree
  (nested dicts of numpy arrays) into the port's ``state_dict``: the inverse
  of the JAX package's ``convert_torch_entry``. Dense ``kernel`` [in, out]
  becomes ``weight`` [out, in], a 4-D conv kernel goes from HWIO back to
  OIHW, a norm ``scale`` becomes ``weight``, and flax's ``layers_N`` and
  ``blocks_N`` become ``layers.N`` and ``blocks.N``. The MoE layers' vmapped
  ``experts`` keep their leading E axis (a kernel ``[E, in, out]`` becomes
  ``[E, out, in]``), and ``gate/wg`` becomes ``gate.wg.weight``. An
  ``nn.Embed`` table (``embedding``) becomes ``weight``, and one wrapped in
  a module that names it ``weight`` (``TextEmbedding``,
  ``PositionalEmbedding``) that module's ``weight``: so the decoder's
  ``embed_tokens``, the relative-position tables
  (``relative_attention_bias``) and BEiT-3's ``text_embed`` and
  ``embed_positions`` take torchscale's keys. Multiway ``A`` / ``B``
  branches, the retention projections (``g_proj`` among them) and the
  decoder's ``encoder_attn`` keep their names. A BEiT-3 tree's
  ``embed_positions`` (beside the encoder in the JAX package) moves under
  ``encoder.``, where torchscale keeps it.
- :func:`flax_params_from_state_dict` is its inverse, for the tile
  encoder's and the slide encoder's names: it gives the flax-path tree the
  quantized artifact (:mod:`gigapath_tpu_torch.quant.convert`) stores.
- :func:`state_dict_for_rank` converts and cuts a tree for one rank of a
  ``model`` or ``expert`` group (``parallel/tensor.py:shard_state_dict``).
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
    subtrees become the key prefixes of the same names, and the torchscale
    family's: encoder, decoder, encoder-decoder, RetNet and BEiT-3."""
    beit3 = {"text_embed", "vision_embed", "embed_positions", "encoder"} <= set(params)
    out = {}
    for path, value in _flatten(params):
        arr = np.array(value, dtype=np.float32)  # a writable copy
        parts = list(path)
        if beit3 and parts[0] == "embed_positions":
            parts.insert(0, "encoder")
        leaf = parts[-1]
        if leaf == "kernel":
            parts[-1] = "weight"
            arr = {2: lambda a: a.T, 3: lambda a: a.transpose(0, 2, 1)}.get(
                arr.ndim, lambda a: a.transpose(3, 2, 0, 1))(arr)
        elif leaf == "scale":
            parts[-1] = "weight"
        elif leaf == "embedding":
            parts = parts[:-1] if parts[-2:-1] == ["weight"] else parts[:-1] + ["weight"]
        key = re.sub(r"\b(layers|blocks)_(\d+)\b", r"\1.\2", ".".join(parts))
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def flax_params_from_state_dict(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's ``state_dict`` -> a nested flax-path tree of fp32 numpy
    arrays, the inverse of :func:`state_dict_from_flax_params`: a 2-D
    ``weight`` becomes a transposed ``kernel``, a 4-D one an HWIO
    ``kernel``, a 1-D one (a LayerNorm's) ``scale``; under ``experts`` the
    leading E axis is kept and the rule reads the rest."""
    tree: Dict[str, Any] = {}
    for key, value in state.items():
        arr = value.detach().cpu().float().numpy()
        parts = re.sub(r"\b(layers|blocks)\.(\d+)\b", r"\1_\2", key).split(".")
        if parts[-1] == "weight":
            stacked = "experts" in parts  # a leading expert axis
            ndim = arr.ndim - stacked
            parts[-1] = "scale" if ndim == 1 else "kernel"
            if ndim == 2:
                arr = np.swapaxes(arr, -1, -2)
            elif ndim == 4:
                arr = arr.transpose(2, 3, 1, 0)
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.ascontiguousarray(arr)
    return tree


def state_dict_for_rank(params: Mapping[str, Any], rank: int, world: int, axis: str = "model") -> Dict[str, torch.Tensor]:
    """A JAX-package param tree (or a whole ``state_dict``) -> rank
    ``rank``'s of ``world`` ``state_dict`` over the ``model`` or ``expert``
    dim (:func:`gigapath_tpu_torch.parallel.tensor.shard_state_dict`)."""
    from gigapath_tpu_torch.parallel.tensor import shard_state_dict

    is_state = all(isinstance(v, torch.Tensor) for v in params.values())
    state = dict(params) if is_state else state_dict_from_flax_params(params)
    return shard_state_dict(state, rank, world, axis=axis)
