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
keys for the same model. The profiler passthroughs (:func:`trace`,
:func:`annotate`) and the cost helpers (:func:`compiled_flops`,
:func:`compiled_memory`, each of which runs its function once) are
re-exported from ``obs/spans.py`` and ``obs/ledger.py`` under the JAX
module's names, and :func:`op_totals` sums a profiler trace's device time
per kernel, the counterpart of ``xla_op_totals``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Iterator, Tuple

import torch
from torch import nn

from gigapath_tpu_torch.obs.ledger import compiled_flops, compiled_memory  # noqa: F401  (re-exported)
from gigapath_tpu_torch.obs.spans import annotate, trace  # noqa: F401  (re-exported)


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


def op_totals(trace_dir: str) -> Dict[str, Dict]:
    """Per-kernel device time of the profiler trace that
    ``obs/spans.py:stop_trace`` wrote to ``<trace_dir>/trace.json``.

    Returns ``{"ops": {kernel name: device µs}, "async": {memcpy / memset
    name: µs}, "counts": {kernel name: launches seen}}``: the device's
    kernel records summed by name, and its copies and fills apart (they may
    overlap kernels, so their sum is for orientation only)."""
    with open(os.path.join(trace_dir, "trace.json"), encoding="utf-8") as fh:
        events = json.load(fh).get("traceEvents", [])
    ops: Dict[str, float] = {}
    asyncs: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name, dur = ev.get("cat", ""), ev.get("name", ""), float(ev.get("dur", 0.0))
        if cat == "kernel":
            ops[name] = ops.get(name, 0.0) + dur
            counts[name] = counts.get(name, 0) + 1
        elif cat in ("gpu_memcpy", "gpu_memset"):
            asyncs[name] = asyncs.get(name, 0.0) + dur
    return {"ops": ops, "async": asyncs, "counts": counts}
