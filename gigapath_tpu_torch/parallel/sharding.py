"""Parameter and collective layout rules (counterpart of
``gigapath_tpu/parallel/sharding.py``).

Tensor-parallel layout for the transformer stack: attention and FFN
weights split over the ``model`` mesh dim (column-parallel ``fc1`` / q / k
/ v, row-parallel ``fc2`` / ``out_proj``), everything else replicated. The
rules are written by module name, as in the JAX package; the JAX package
states them over the flax ``kernel`` ``[in, out]``, and a torch ``weight``
is ``[out, in]``, so here column-parallel is ``Shard(0)`` of the weight
and row-parallel ``Shard(1)``. This file holds layout decisions only:
:func:`apply_shardings` lays a state dict out as DTensors and runs nothing.
A model runs on ``model``-sharded weights as a tensor-parallel model
(:mod:`gigapath_tpu_torch.parallel.tensor`: each rank holds its shards as
plain parameters, cut by ``shard_state_dict`` with these rules).

The JAX package's ``shard_map_compat`` has no counterpart: there is no
``shard_map`` here. A rank is a process that runs the model on its own
slice, and the sequence-parallel attention issues its collectives itself
over the ``seq`` dim's process group.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

# leaf module name -> the rule for its weight; biases and norms stay
# replicated. A name in neither list is replicated.
_COLUMN_PARALLEL = (
    "q_proj", "k_proj", "v_proj", "fc1", "gate",
    # retention gate projection: [E, value_dim], split like q/k/v
    "g_proj",
    # ViT packed qkv: [D, 3D], output-dim split (megatron fused-qkv rule)
    "qkv",
    # vocab head: [E, V], vocab-dim split
    "output_projection",
)
_ROW_PARALLEL = (
    "out_proj", "fc2",
    # ViT attention output projection; the slide encoder's patch embed
    # (a dense [in_chans, E] kernel) shares the name and also input-dim
    # splits
    "proj",
)

# Sequence-parallel collective registry: the communication the library
# issues by hand over the ``seq`` dim's process group, by module, with
# the torch.distributed functions it calls. The gathered dilated branches
# all-gather the per-rank valid counts once per call and the sparse K/V
# of each gathered branch, whose backward reduce-scatters; the ring
# schedule rotates K/V (and in its backward the dK/dV accumulators) by
# one all-to-all per step. Every one of them takes CUDA tensors under
# both gloo and NCCL; send/recv would not (gloo refuses device pointers,
# scripts/torch_gloo_cuda_probe.py).
_SEQ_COLLECTIVES: Dict[str, tuple] = {
    "gigapath_tpu_torch/ops/dilated_attention.py": ("all_gather", "reduce_scatter", "all_to_all_single"),
}

Spec = Tuple[object, ...]  # one mesh-dim name (or None) per tensor axis

# flax kernel axis order -> torch weight axis order, by rank (the values'
# permutation in utils/convert.py): torch axis j is flax axis perm[j]
_TORCH_FROM_FLAX = {2: (1, 0), 4: (3, 2, 0, 1)}


def _to_torch_layout(spec: Spec, name: str, ndim: int) -> Spec:
    """A spec over the flax kernel's axes -> the same spec over the torch
    weight's axes (padded with None to the rank first). A stacked expert
    tensor keeps its leading expert axis in both layouts, so its spec
    stays as it is."""
    full = tuple(spec) + (None,) * (ndim - len(spec))
    if "experts" in name.split("."):
        return tuple(spec)
    if not name.endswith("weight") or ndim not in _TORCH_FROM_FLAX or not any(full):
        return tuple(spec)
    return tuple(full[j] for j in _TORCH_FROM_FLAX[ndim])


def param_spec(
    name: str,
    tensor,
    *,
    model_axis: Optional[str] = "model",
    expert_axis: Optional[str] = None,
) -> Spec:
    """The spec of one parameter over the torch tensor's axes, by its
    ``state_dict`` name: ``("model", None)`` for a column-parallel weight,
    ``(None, "model")`` for a row-parallel one, ``(expert_axis, None, ...)``
    for a stacked expert tensor, ``()`` (replicated) for everything else.
    Either axis may be None, disabling its rule."""
    parts = name.split(".")
    ndim = tensor.dim() if hasattr(tensor, "dim") else len(tensor.shape)
    if expert_axis and "experts" in parts and ndim >= 1:
        return (expert_axis,) + (None,) * (ndim - 1)
    if model_axis and len(parts) >= 2 and parts[-1] == "weight" and ndim == 2:
        if parts[-2] in _COLUMN_PARALLEL:
            return _to_torch_layout((None, model_axis), name, ndim)
        if parts[-2] in _ROW_PARALLEL:
            return _to_torch_layout((model_axis, None), name, ndim)
    return ()


def placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on the
    mesh dim that tensor axis ``i`` names, ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(spec.index(dim)) if dim in spec else Replicate() for dim in (mesh.mesh_dim_names or ())]


def param_shardings(state_dict: Mapping[str, object], mesh) -> Dict[str, list]:
    """``{name: placements}`` for a state dict on ``mesh``. Where the mesh
    has no ``model`` (or ``expert``) dim, or it has size 1, that rule is off
    and everything it would shard is replicated, as in the JAX package."""
    from gigapath_tpu_torch.parallel.mesh import axis_size

    model_axis = "model" if axis_size(mesh, "model") > 1 else None
    expert_axis = "expert" if axis_size(mesh, "expert") > 1 else None
    return {
        name: placements(param_spec(name, t, model_axis=model_axis, expert_axis=expert_axis), mesh)
        for name, t in state_dict.items()
    }


def apply_shardings(state_dict: Mapping[str, object], mesh) -> Dict[str, object]:
    """Lay a state dict out on ``mesh`` by its rules: ``{name: DTensor}``
    through ``distribute_tensor``. Every rank passes the same values."""
    from torch.distributed.tensor import distribute_tensor

    specs = param_shardings(state_dict, mesh)
    return {name: distribute_tensor(t, mesh, specs[name]) for name, t in state_dict.items()}
