"""MoE gating telemetry (the port's counterpart of the MoE half of
``gigapath_tpu/utils/profiling.py``).

The JAX package's MoE layers sow their gating metadata (entropy, unused
experts, balance fractions, overflow) into the ``intermediates``
collection, and :func:`iter_moe_metadata` flattens it into
``"layer_path/metric"`` keys. Here every
:class:`~gigapath_tpu_torch.ops.moe.MOELayer` keeps its last forward's
metadata on ``.metadata``, and the flattening walks the module tree: the
layer's path under the module passed (``layers.1.moe_layer``) is written
as flax names it (``layers_1/moe_layer``), so both packages give the same
keys for the same model. The profiler passthroughs and the compiled-cost
helpers of the JAX module live in ``obs/spans.py`` and are not repeated
here.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import torch
from torch import nn


def _flax_path(module_path: str) -> str:
    """``layers.1.moe_layer`` -> ``layers_1/moe_layer``."""
    return re.sub(r"\.(\d+)(?=\.|$)", r"_\1", module_path).replace(".", "/")


def iter_moe_metadata(model: nn.Module) -> Iterator[Tuple[str, torch.Tensor]]:
    """``("layer_path/metric", 0-d tensor)`` for every scalar of every MoE
    layer's last gating metadata under ``model``: the one flattening shared
    by :func:`collect_moe_metadata` and ``obs/telemetry.py:moe_scalars``.
    A non-scalar entry is skipped (gating statistics are scalars)."""
    for name, module in model.named_modules():
        metadata = getattr(module, "metadata", None)
        if not metadata or not hasattr(module, "gate"):
            continue
        layer = _flax_path(name)
        for metric, leaf in metadata.items():
            if leaf.numel() != 1:
                continue
            yield (f"{layer}/{metric}" if layer else metric), leaf.reshape(())


def collect_moe_metadata(model: nn.Module) -> Dict[str, float]:
    """Every MoE layer's last gating metadata as ``layer_path/metric`` host
    floats (one device read per scalar: call at a sync point)."""
    return {key: float(leaf) for key, leaf in iter_moe_metadata(model)}
