"""Device-mesh construction (counterpart of ``gigapath_tpu/parallel/mesh.py``).

The JAX package's communication surface is one ``jax.sharding.Mesh`` with
named axes; here it is one ``torch.distributed.device_mesh.DeviceMesh``
over the ranks of the default process group, with the same axis names:

- ``data``   — batch (data parallelism; :mod:`~gigapath_tpu_torch.parallel.spmd`);
- ``seq``    — sequence parallelism: the process group of this dim is the
  ``seq_group`` of :func:`gigapath_tpu_torch.ops.dilated_attention.dilated_attention`;
- ``model``  — tensor parallelism over hidden and head dims
  (:mod:`~gigapath_tpu_torch.parallel.tensor`, the rules of
  :mod:`~gigapath_tpu_torch.parallel.sharding`);
- ``expert`` — MoE expert parallelism (:mod:`gigapath_tpu_torch.ops.moe.expert_parallel`).

The caller initialises the default process group: its backend, the
store or address, the world size and the rank. This module never picks a
backend and never falls back from one to another. One rank is one
process; on a machine with one card several ranks may share it over
``gloo`` (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

MESH_AXES = ("data", "seq", "model", "expert")


def factorize(n: int, axes: Sequence[str]) -> Dict[str, int]:
    """Spread ``n`` ranks over axes, preferring seq > data > model.

    Long context is first-class: sequence parallelism gets ranks first (the
    slide encoder's token count dwarfs the batch size), then data, then
    tensor parallelism."""
    sizes = {a: 1 for a in axes}
    remaining = n
    order = [a for a in ("seq", "data", "model", "expert") if a in axes]
    i = 0
    while remaining > 1 and order:
        axis = order[i % len(order)]
        if remaining % 2 == 0:
            sizes[axis] *= 2
            remaining //= 2
        else:
            sizes[axis] *= remaining
            remaining = 1
        i += 1
    return sizes


def make_mesh(
    n_devices: Optional[int] = None,
    *,
    axis_sizes: Optional[Dict[str, int]] = None,
    axes: Sequence[str] = ("data", "seq"),
    device_type: str = "cuda",
    ranks: Optional[Sequence[int]] = None,
):
    """A ``DeviceMesh`` over every rank of the initialised default group,
    or over ``ranks`` (the first ``n_devices`` of them where given: the
    counterpart of the JAX ``devices=`` subset), its dims named by ``axes``
    (sizes from :func:`factorize`) or by the keys of ``axis_sizes``.
    Without ``ranks``, ``n_devices`` must be the world size; the product of
    the axis sizes must be the mesh's rank count; otherwise ``ValueError``.
    Every rank of the default group builds the mesh, members or not (its
    process groups are made collectively)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialise the default process group first")
    if ranks is not None:
        members = [int(r) for r in ranks][:n_devices]
        if not members or len(set(members)) != len(members) or not all(0 <= r < dist.get_world_size()
                                                                      for r in members):
            raise ValueError(f"make_mesh: ranks {list(ranks)} are not distinct ranks of the default group")
    else:
        members = list(range(dist.get_world_size()))
        if n_devices is not None and int(n_devices) != len(members):
            raise ValueError(f"make_mesh: n_devices={n_devices} but the default group has {len(members)} ranks")
    world = n = len(members)
    if axis_sizes is None:
        axis_sizes = factorize(n, axes)
    else:
        axes = tuple(axis_sizes.keys())
    shape = tuple(int(axis_sizes[a]) for a in axes)
    size = 1
    for s in shape:
        size *= s
    if size != world:
        raise ValueError(f"make_mesh: mesh {dict(axis_sizes)} holds {size} ranks, the group {world}")
    return DeviceMesh(device_type, torch.tensor(members).reshape(shape), mesh_dim_names=tuple(axes))


def axis_size(mesh, axis: str) -> int:
    """The size of ``mesh``'s dim ``axis``, 1 where the mesh has no such dim."""
    names = mesh.mesh_dim_names or ()
    return int(mesh.size(names.index(axis))) if axis in names else 1


def replicated(mesh) -> List:
    """DTensor placements that replicate a tensor over every dim of ``mesh``."""
    from torch.distributed.tensor import Replicate

    return [Replicate() for _ in range(mesh.ndim)]


def shard_batch_seq(mesh, batch_axis: str = "data", seq_axis: str = "seq") -> List:
    """DTensor placements for ``[B, L, ...]`` activations: the batch
    (tensor dim 0) over ``batch_axis``, the tokens (tensor dim 1) over
    ``seq_axis``, replicated over every other dim of ``mesh``."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names or ()
    out = []
    for name in names:
        if name == batch_axis:
            out.append(Shard(0))
        elif name == seq_axis:
            out.append(Shard(1))
        else:
            out.append(Replicate())
    return out
