"""Tensor parallelism over a ``model`` group (the port's counterpart of the
JAX package's ``model``-axis annotations, ``gigapath_tpu/parallel/sharding.py``).

The JAX package lays the attention and FFN weights out over the mesh's
``model`` axis and lets GSPMD insert the collectives. Here a rank of a
model group of T ranks is a process that holds only its own shards as
parameters and runs the collectives itself (Megatron's layout):

- ``q_proj``, ``k_proj``, ``v_proj`` and ``fc1`` are column-parallel: a
  rank holds ``1/T`` of their output features (weight rows and bias);
  their input passes :func:`copy_to_group` (identity forward, all-reduce
  of the gradient backward);
- ``out_proj`` and ``fc2`` are row-parallel: a rank holds ``1/T`` of their
  input features (weight columns); their partial products pass
  :func:`reduce_from_group` (all-reduce forward, identity backward) and
  the whole bias is added after it (:func:`row_parallel_linear`);
- the sub-LNs (``inner_attn_ln`` over E, ``ffn_layernorm`` over
  ``ffn_dim``) normalise a width that is split over the ranks:
  :class:`ShardedLayerNorm` all-reduces each row's sum and sum of squares
  in fp32 and holds its own slice of the scale and shift.

Every parameter a rank holds acts either on its own shard of an
activation (and its gradient is the whole gradient of that shard) or on a
replicated activation (pre-LN, the row-parallel biases, the patch embed,
the head: each rank computes the same whole gradient). So no gradient is
summed over the model group; the train step averages over ``data`` only.

A residual-stream dropout acts on a replicated activation: every rank of
a model group must draw the same mask, which it does when their torch
generators hold the same state (``parallel/spmd.py`` seeds them so).
:func:`sharded_dropout` draws the whole width's mask and keeps its own
slice, so a sharded activation's dropout is the single-device one.

:func:`shard_state_dict` cuts a whole state dict into one rank's (the
column and row rules of :func:`~gigapath_tpu_torch.parallel.sharding.param_spec`,
restricted to the modules that run tensor-parallel, plus the sub-LNs and
the column-parallel biases), :func:`gather_state_dict` puts it back
together; with ``axis="expert"`` they cut the stacked MoE experts'
leading axis instead.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from gigapath_tpu_torch.parallel.sharding import param_spec

# the modules that run tensor-parallel, by leaf name (a subset of
# sharding.py's rule lists: the patch embed's ``proj`` and the ViT's
# ``qkv`` stay whole)
TP_COLUMN = ("q_proj", "k_proj", "v_proj", "fc1", "gate")
TP_ROW = ("out_proj", "fc2")
TP_NORMS = ("inner_attn_ln", "ffn_layernorm")


def rank_and_world(group) -> Tuple[int, int]:
    """(this rank's index in ``group``, the group's size); (0, 1) for None."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the backward all-reduces (sums) the gradient over
    the group: each rank's column shards give only their part of it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromGroup(torch.autograd.Function):
    """All-reduce (sum) forward; identity backward: the sum is replicated,
    so each rank's gradient of it is already the whole gradient."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllReduceSum(torch.autograd.Function):
    """All-reduce (sum) forward and backward: the statistics of a sharded
    row, whose every rank's normalised slice depends on every rank's
    part."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """The input of a column-parallel layer (identity; gradient summed)."""
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The partial output of a row-parallel layer, summed over the group."""
    return x if group is None else _ReduceFromGroup.apply(x, group)


def row_parallel_linear(x: torch.Tensor, linear: nn.Linear, group) -> torch.Tensor:
    """``linear`` holding its input features' shard: the partial products
    summed over the group, then the whole bias (added once)."""
    if group is None:
        return linear(x)
    out = reduce_from_group(F.linear(x, linear.weight), group)
    return out if linear.bias is None else out + linear.bias


def sharded_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                       group) -> torch.Tensor:
    """LayerNorm over the last dim of ``x``, which holds this rank's slice
    of a width split over ``group``: each row's sum and sum of squares in
    fp32, all-reduced as one ``[..., 2]`` tensor (the gradient flows back
    through the collective), the variance ``E[x^2] - E[x]^2`` (flax's fast
    variance), the affine in fp32 and one rounding to ``x``'s dtype."""
    world = dist.get_world_size(group)
    x32 = x.float()
    stats = _AllReduceSum.apply(torch.stack((x32.sum(-1), x32.square().sum(-1)), dim=-1), group)
    width = x.shape[-1] * world
    mean = stats[..., :1] / width
    var = (stats[..., 1:] / width - mean.square()).clamp_min(0.0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


class ShardedLayerNorm(nn.Module):
    """A LayerNorm whose width is split over ``group``: this rank's slice of
    the scale (``weight``) and shift (``bias``), each ``[width / T]``."""

    def __init__(self, local_width: int, group, eps: float = 1e-5):
        super().__init__()
        self.group = group
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(local_width))
        self.bias = nn.Parameter(torch.zeros(local_width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return sharded_layer_norm(x, self.weight, self.bias, self.eps, self.group)

    def extra_repr(self) -> str:
        return f"{self.weight.shape[0]} of {self.weight.shape[0] * dist.get_world_size(self.group)}, eps={self.eps}"


def sharded_dropout(x: torch.Tensor, p: float, training: bool, group, dim: int = -1) -> torch.Tensor:
    """Dropout of this rank's slice (along ``dim``) of an activation split
    over ``group``: the whole width's mask is drawn, as one device draws it,
    and this rank keeps its slice (the ranks' generators hold one state)."""
    if not training or p == 0.0:
        return x
    rank, world = rank_and_world(group)
    shape = list(x.shape)
    shape[dim] *= world
    mask = F.dropout(torch.ones(shape, dtype=x.dtype, device=x.device), p, True)
    return x * mask.chunk(world, dim=dim)[rank]


def local_heads(num_heads: int, group) -> Tuple[int, int]:
    """(this rank's head count, its first head's global index): rank j of
    T holds heads ``[j*H/T, (j+1)*H/T)``. ``ValueError`` unless T divides
    H."""
    rank, world = rank_and_world(group)
    if num_heads % world:
        raise ValueError(f"tensor parallelism over {world} ranks needs the head count {num_heads} divisible by it")
    per = num_heads // world
    return per, rank * per


def _split_dim(name: str, tensor, axis: str) -> Optional[int]:
    """The dim of ``name`` that ``axis`` splits, or None (kept whole)."""
    parts = name.split(".")
    if axis == "expert":
        return 0 if "experts" in parts else None
    if axis != "model":
        raise ValueError(f"axis must be 'model' or 'expert', not {axis!r}")
    if "experts" in parts or len(parts) < 2:
        return None
    module, leaf = parts[-2], parts[-1]
    if module in TP_NORMS:
        return 0
    if module in TP_COLUMN and leaf == "bias":
        return 0
    if module in TP_COLUMN + TP_ROW and leaf == "weight":
        spec = param_spec(name, tensor, model_axis="model")
        return spec.index("model") if "model" in spec else None
    return None


def shard_state_dict(state_dict: Mapping[str, torch.Tensor], rank: int, world: int,
                     axis: str = "model") -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s of ``world`` part of a whole state dict: over
    ``axis="model"`` the tensor-parallel modules' weights by the column and
    row rules of ``param_spec`` (column weights and biases and the sub-LNs
    by rows, row weights by columns, everything else whole); over
    ``"expert"`` the stacked experts' leading axis. ``ValueError`` where a
    split dim does not divide by ``world``."""
    out = {}
    for name, t in state_dict.items():
        dim = _split_dim(name, t, axis) if world > 1 else None
        if dim is None:
            out[name] = t
            continue
        if t.shape[dim] % world:
            raise ValueError(f"{name}: dim {dim} of {tuple(t.shape)} does not split over {world} ranks")
        out[name] = t.chunk(world, dim=dim)[rank].contiguous()
    return out


def gather_state_dict(parts, *, group=None, axis: str = "model") -> Dict[str, torch.Tensor]:
    """The whole state dict again: ``parts`` is every rank's part, in rank
    order (a sequence of dicts), or, with ``group``, this rank's part, which
    is all-gathered over the group (a collective: every rank of it calls
    it and gets the whole dict)."""
    if group is not None:
        local = parts
        world = dist.get_world_size(group)
        out = {}
        for name, t in local.items():
            dim = _split_dim(name, t, axis) if world > 1 else None
            if dim is None:
                out[name] = t
                continue
            pieces = [torch.empty_like(t.contiguous()) for _ in range(world)]
            dist.all_gather(pieces, t.contiguous(), group=group)
            out[name] = torch.cat(pieces, dim=dim)
        return out
    parts = list(parts)
    out = {}
    for name, t in parts[0].items():
        dim = _split_dim(name, t, axis) if len(parts) > 1 else None
        out[name] = t if dim is None else torch.cat([p[name] for p in parts], dim=dim)
    return out


__all__ = [
    "ShardedLayerNorm", "copy_to_group", "gather_state_dict", "local_heads", "rank_and_world",
    "reduce_from_group", "row_parallel_linear", "shard_state_dict", "sharded_dropout", "sharded_layer_norm",
]
