"""Expert parallelism over an ``expert_group`` of D ranks, each holding
E/D of the experts (counterpart of ``gigapath_tpu/ops/moe/expert_parallel.py``
and of the ``expert``-axis constraint of ``gigapath_tpu/ops/moe/moe_layer.py``).

Two variants, as in the JAX package:

- :func:`experts_gathered`, the single-device function (JAX's
  ``MOELayer`` under the ``expert`` constraint): every rank gates the same
  tokens, runs its own experts on their slice of the ``[E, C, M]``
  dispatch, and the outputs are all-gathered over the group. The slice's
  input passes ``copy_to_group`` (its gradient is all-reduced: each rank's
  experts see only their slice); the all-gather's backward is its
  adjoint, a reduce-scatter, divided by D because every rank's loss is the
  same replica.
- :func:`moe_expert_parallel`, per-shard gating (JAX's ``moe_shard_fn`` /
  ``moe_expert_parallel``): each rank gates its own tokens into ``[E,
  C_loc, M]``, one ``all_to_all_single`` leaves every rank with its E/D
  experts' slots from every rank (``[E/D, D*C_loc, M]``), the experts run,
  and the inverse exchange brings the outputs home before the local
  combine. An all-to-all of equal splits is its own adjoint, so its
  backward is the same exchange of the gradient. ``l_aux`` is averaged
  over the group (all-reduce forward, identity backward, then / D: each
  rank's balance loss takes 1/D of the gradient, as JAX's ``pmean``).

Every collective takes CUDA tensors under gloo and NCCL.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.distributed as dist

from gigapath_tpu_torch.parallel.tensor import copy_to_group, rank_and_world, reduce_from_group


class _GatherExperts(torch.autograd.Function):
    """``[E/D, C, M]`` per rank -> ``[E, C, M]`` on every rank; backward:
    the reduce-scatter of the gradient, / D (identical replicas)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, grad):
        world = dist.get_world_size(ctx.group)
        chunks = [c.contiguous() for c in grad.chunk(world, dim=0)]
        out = torch.empty_like(chunks[0])
        dist.reduce_scatter(out, chunks, group=ctx.group)
        return out / world, None


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over dim 0 in equal splits (block d to rank d,
    block s from rank s); self-adjoint, so the backward exchanges the
    gradient the same way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x.contiguous())
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = torch.empty_like(grad.contiguous())
        dist.all_to_all_single(out, grad.contiguous(), group=ctx.group)
        return out, None


def local_expert_range(num_experts: int, group) -> Tuple[int, int]:
    """``[e0, e1)``: the experts this rank of ``group`` holds. ``ValueError``
    unless the group's size divides ``num_experts``."""
    rank, world = rank_and_world(group)
    if num_experts % world:
        raise ValueError(f"{num_experts} experts do not split over an expert group of {world} ranks")
    per = num_experts // world
    return rank * per, (rank + 1) * per


def experts_gathered(dispatched: torch.Tensor, experts: Callable, group) -> torch.Tensor:
    """Variant (a): ``dispatched [E, C, M]`` (the same on every rank) ->
    ``experts(own slice)`` all-gathered to ``[E, C, M]``."""
    e0, e1 = local_expert_range(dispatched.shape[0], group)
    return _GatherExperts.apply(experts(copy_to_group(dispatched, group)[e0:e1]), group)


def exchange(dispatched: torch.Tensor, group) -> torch.Tensor:
    """``[E, C, M]`` (this rank's slots for every expert) -> ``[E/D, D*C,
    M]`` (every rank's slots for this rank's experts, by source rank)."""
    world = dist.get_world_size(group)
    E, C, M = dispatched.shape
    out = _AllToAll.apply(dispatched, group)  # [D, E/D, C, M] by source rank
    return out.reshape(world, E // world, C, M).transpose(0, 1).reshape(E // world, world * C, M)


def exchange_back(expert_output: torch.Tensor, group) -> torch.Tensor:
    """The inverse of :func:`exchange`: ``[E/D, D*C, M]`` -> ``[E, C, M]``."""
    world = dist.get_world_size(group)
    El, DC, M = expert_output.shape
    x = expert_output.reshape(El, world, DC // world, M).transpose(0, 1).contiguous()
    return _AllToAll.apply(x, group).reshape(El * world, DC // world, M)


def moe_expert_parallel(gate_fn: Callable, expert_fn: Callable, tokens: torch.Tensor, group):
    """Variant (b) on this rank's ``tokens [S_loc, M]``: ``gate_fn(tokens)
    -> (l_aux, combine, dispatch, metadata)``, ``expert_fn(dispatched
    [E/D, D*C_loc, M]) -> same shape`` (this rank's experts). Returns
    ``(out [S_loc, M], l_aux averaged over the group, metadata)``."""
    l_aux, combine, dispatch, metadata = gate_fn(tokens)
    dispatched = torch.einsum("sec,sm->ecm", dispatch.to(tokens.dtype), tokens)
    world = rank_and_world(group)[1]
    if world > 1:
        dispatched = exchange(dispatched, group)
    expert_output = expert_fn(dispatched)
    if world > 1:
        expert_output = exchange_back(expert_output, group)
        l_aux = reduce_from_group(l_aux, group) / world
    out = torch.einsum("sec,ecm->sm", combine.to(tokens.dtype), expert_output)
    return out, l_aux, metadata
