"""Per-stage placement and the declarative sharding-rule registry
(counterpart of ``gigapath_tpu/dist/stagemesh.py``).

The disaggregated pipeline runs the two encoders as separate fleets, and
each fleet has its own geometry and parameter layout:

- the **tile encoder** is data-parallel over tiles (optional tensor
  parallelism over the ViT's hidden dim) — axes ``("data", "model")``;
- the **slide encoder** is sequence/model-sharded — axes
  ``("data", "seq", "model")``.

Each stage's layout is a *registry entry*: an ordered list of
``(param-name regex, spec)`` rules resolved against a module's
``state_dict`` names by :func:`match_partition_rules` (first matching rule
wins, scalars never partition, a param no rule covers is a loud error, not
silent replication).

A rule's spec is written as the JAX package writes it, over the flax
``kernel`` layout: ``[in, out]`` for a dense kernel, HWIO for a conv. A
torch ``weight`` is ``[out, in]`` (OIHW for a conv), so the matched spec
is permuted into the torch layout — the permutation
:func:`gigapath_tpu_torch.utils.convert.state_dict_from_flax_params`
applies to the values. A column-parallel ``(None, "model")`` on a flax
kernel is ``("model", None)`` on the torch weight.

The column- and row-parallel name lists and the flax-to-torch spec
permutation come from :mod:`gigapath_tpu_torch.parallel.sharding`, as the
JAX module takes its lists from ``gigapath_tpu/parallel/sharding.py``.

:func:`stage_mesh` builds a stage's ``DeviceMesh`` over its axes (over a
subset of the ranks, so two fleets can hold disjoint ranks), and
:func:`stage_param_shardings` resolves the rules into DTensor placements
on it, each spec first degraded to the mesh's live axes (:func:`_degrade`:
an axis the mesh lacks or holds at size 1 is dropped).

Placement: one device is ``module.to(device)``. A stage over more than one
device raises rather than replicate silently: the JAX package runs no
stage above one device either (its workers and pipeline place each stage
on one), so the sharded placement would be a feature of the port alone.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

from gigapath_tpu_torch.parallel.sharding import _COLUMN_PARALLEL, _ROW_PARALLEL, Spec, _to_torch_layout


def _named_shapes(params) -> List[Tuple[str, Tuple[int, ...]]]:
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    return [(name, tuple(getattr(v, "shape", ()))) for name, v in params.items()]


def match_partition_rules(rules: Sequence[Tuple[str, Spec]],
                          params: Union[torch.nn.Module, Mapping[str, torch.Tensor]]
                          ) -> Dict[str, Spec]:
    """``{state_dict name: spec over the torch tensor's axes}`` from
    ordered ``(regex, flax-layout spec)`` rules.

    Each name (``slide_encoder.encoder.layers.0.ffn.fc1.weight``) is
    matched with ``re.search``; the FIRST matching rule wins. Scalar (or
    1-element) tensors never partition. A name matching no rule raises — a
    silent fall-through to replicated is exactly the bug class the
    registry's explicit catch-all exists to rule out."""
    compiled = [(re.compile(rule), tuple(spec)) for rule, spec in rules]
    out: Dict[str, Spec] = {}
    for name, shape in _named_shapes(params):
        numel = 1
        for d in shape:
            numel *= int(d)
        if len(shape) == 0 or numel == 1:
            out[name] = ()
            continue
        for rx, spec in compiled:
            if rx.search(name) is not None:
                out[name] = _to_torch_layout(spec, name, len(shape))
                break
        else:
            raise ValueError(
                f"no partition rule matches param '{name}' "
                f"(shape {shape}); add a rule (or an explicit "
                "catch-all) to the stage's registry entry"
            )
    return out


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One fleet's declarative geometry + layout."""

    name: str
    axes: Tuple[str, ...]
    rules: Tuple[Tuple[str, Spec], ...]
    description: str = ""


def _tp_rules(model_axis: str = "model") -> Tuple[Tuple[str, Spec], ...]:
    """The tensor-parallel weight rules over ``state_dict`` names, from the
    column/row-parallel name lists above (specs in the flax layout)."""
    col = "|".join(_COLUMN_PARALLEL)
    row = "|".join(_ROW_PARALLEL)
    return (
        # stacked MoE experts carry a leading E axis (ops/moe/moe_layer.py):
        # first, so that an expert's fc1/fc2 is not read as a dense layer
        (r"(^|\.)experts\.", ("expert",)),
        (rf"(^|\.)({col})\.weight$", (None, model_axis)),
        (rf"(^|\.)({row})\.weight$", (model_axis, None)),
        (r".*", ()),  # everything else (biases, norms, embeddings)
    )


_REGISTRY: Dict[str, StageSpec] = {}


def register_stage(spec: StageSpec) -> StageSpec:
    _REGISTRY[spec.name] = spec
    return spec


def get_stage(name: str) -> StageSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown stage '{name}' (registered: {stage_names()})"
        ) from None


def stage_names() -> List[str]:
    return sorted(_REGISTRY)


register_stage(StageSpec(
    name="tile_encoder",
    axes=("data", "model"),
    rules=_tp_rules(),
    description="ViT-G tile fleet: data-parallel over tiles, optional "
                "tensor parallelism over hidden/head dims",
))

register_stage(StageSpec(
    name="slide_encoder",
    axes=("data", "seq", "model"),
    rules=_tp_rules(),
    description="LongNet slide fleet: the tile-embedding sequence shards "
                "over seq (ring/chunked prefill), weights over model",
))


def stage_param_specs(name: str, params) -> Dict[str, Spec]:
    """One stage's registry rules resolved over a module (or state
    dict): ``{state_dict name: spec over the torch tensor's axes}``."""
    return match_partition_rules(get_stage(name).rules, params)


def stage_mesh(name: str, n_devices: Optional[int] = None, *,
               ranks: Optional[Sequence[int]] = None,
               axis_sizes: Optional[Dict[str, int]] = None,
               device_type: str = "cuda"):
    """One stage's ``DeviceMesh`` over its axes, on every rank of the
    default group or on ``ranks`` (the JAX package's ``devices=`` slice:
    two stages on disjoint ranks), through
    :func:`gigapath_tpu_torch.parallel.mesh.make_mesh`. ``axis_sizes`` may
    name only the stage's axes (``ValueError`` otherwise). Every rank of
    the default group makes the call."""
    from gigapath_tpu_torch.parallel.mesh import make_mesh

    spec = get_stage(name)
    if axis_sizes is not None:
        unknown = set(axis_sizes) - set(spec.axes)
        if unknown:
            raise ValueError(f"stage '{name}' has axes {spec.axes}; axis_sizes names {sorted(unknown)}")
    return make_mesh(n_devices, axes=spec.axes, axis_sizes=axis_sizes, device_type=device_type,
                     ranks=ranks)


def _degrade(spec: Spec, mesh) -> Spec:
    """Drop from a spec the axis names the mesh lacks or holds at size 1:
    the rules stay declarative, the mesh decides what is real."""
    names = mesh.mesh_dim_names or ()
    live = {a for i, a in enumerate(names) if mesh.size(i) > 1}

    def keep(entry):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = tuple(e for e in entry if e in live)
            return kept if kept else None
        return entry if entry in live else None

    return tuple(keep(e) for e in spec)


def stage_param_shardings(name: str, module, mesh) -> Dict[str, list]:
    """``{state_dict name: DTensor placements}`` for one stage's module (or
    state dict) on ``mesh``: per mesh dim, ``Shard(i)`` where the degraded
    spec names that dim's axis at tensor dim ``i``, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names or ()
    out: Dict[str, list] = {}
    for param, spec in stage_param_specs(name, module).items():
        degraded = _degrade(spec, mesh)
        placements = []
        for axis in names:
            dims = [i for i, e in enumerate(degraded)
                    if e == axis or (isinstance(e, tuple) and axis in e)]
            placements.append(Shard(dims[0]) if dims else Replicate())
        out[param] = placements
    return out


def place_stage(name: str, module: torch.nn.Module, devices) -> torch.nn.Module:
    """Place one stage's module: its rules must cover every parameter (an
    uncovered one raises), then one device is ``module.to(device)``. More
    than one device raises ``NotImplementedError``: the JAX package runs no
    stage above one device, and silent replication is not a placement."""
    stage_param_specs(name, module)
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    devices = list(devices)
    if len(devices) != 1:
        raise NotImplementedError(
            f"stage '{name}' over {len(devices)} devices: a stage runs on one "
            "device, as in the JAX package (its workers and pipeline place "
            "each stage on one); place it on one device"
        )
    return module.to(torch.device(devices[0]))
