"""Training and evaluation steps over a mesh (counterpart of
``gigapath_tpu/parallel/spmd.py``).

The JAX package builds one pure ``jit`` step and lets XLA insert the
gradient all-reduce from sharding annotations. Here a step runs in every
rank's process on that rank's part of the batch, and the all-reduce over
the mesh's ``data`` dim is explicit: the gradients are summed over it and
divided by its size before ``optimizer.step()`` (gloo has no
``ReduceOp.AVG``), and the reported loss is averaged the same way, so a
data-parallel step over equal parts equals the one-process step over the
whole batch.

A ``model`` dim above 1 trains a tensor-parallel model: the caller builds
it with the mesh's ``model`` group (``model_group=`` of the slide encoder
or ``make_longnet_from_name``) and loads each rank's shards
(``parallel/tensor.py:shard_state_dict``). Every gradient a rank holds is
already whole for its parameter (``parallel/tensor.py``), so gradients are
still averaged over ``data`` only.

A ``seq`` dim above 1: each rank holds a slice of the tokens of its
``images`` and ``coords``; the step all-gathers them over the ``seq``
group at its entry and runs the model on the whole sequence, which is the
function the JAX package's annotated step computes (GSPMD gathers what the
sharded tokens need). Running the encoder sequence-sharded inside the step
would need the model-level sequence-parallel entry, which is left
unported on purpose (``ROADMAP.md`` Queue C item 5: JAX's prepends a cls
token to every shard, so it computes another function); the
sequence-sharded encoder itself is ``make_longnet_from_name(...,
seq_parallel=True, seq_group=)``.

An ``expert`` dim runs the MoE layers' gathered variant
(``ops/moe/expert_parallel.py:experts_gathered``): every rank of it takes
the data index's whole part of the batch, as JAX's annotated step does.

Under a ``model``, ``seq`` or ``expert`` dim the ranks of one data index
are replicas of one computation, so their dropout masks (and top-2's
second-expert noise) must agree: at its creation the step seeds torch's
generators with a seed shared by those ranks (``seed``, or one drawn on
the replica group's first rank and broadcast) plus the data index, so the
data ranks draw different masks, as one device draws different rows of
one batch.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, task: str = "multi_class") -> torch.Tensor:
    """Mean softmax cross-entropy over integer labels, or (``multi_label``)
    mean sigmoid binary cross-entropy over 0/1 targets (optax's two
    losses)."""
    if task == "multi_label":
        return F.binary_cross_entropy_with_logits(logits.float(), labels.float())
    return F.cross_entropy(logits.float(), labels.long())


def collect_moe_l_aux(model: nn.Module) -> torch.Tensor:
    """The sum of the MoE layers' balance losses of ``model``'s last
    forward: every encoder's ``moe_l_aux`` (the JAX package sows it into the
    ``intermediates`` collection), with its gradient; 0 without MoE
    layers."""
    found = [m.moe_l_aux for m in model.modules() if getattr(m, "moe_l_aux", None) is not None]
    return sum(found[1:], found[0]) if found else torch.zeros((), dtype=torch.float32)


def _group(mesh, axis: str):
    """The process group of ``mesh``'s ``axis`` dim, or None where it has
    one rank (or there is no mesh)."""
    if mesh is None:
        return None
    from gigapath_tpu_torch.parallel.mesh import axis_size

    return mesh.get_group(axis) if axis_size(mesh, axis) > 1 else None


def _seed_replicas(mesh, groups, seed: Optional[int], device) -> None:
    """Seed torch's generators with one seed for the ranks of a data index:
    ``seed``, or the one drawn on the first rank of the replica group
    (broadcast over each of its dims in turn), plus the data index."""
    import torch.distributed as dist

    if seed is None:
        value = torch.randint(0, 2**62, (1,), dtype=torch.int64).to(device)
        for group in groups:
            dist.broadcast(value, src=dist.get_global_rank(group, 0), group=group)
        seed = int(value.item())
    names = mesh.mesh_dim_names or ()
    data_index = mesh.get_local_rank("data") if "data" in names else 0
    torch.manual_seed(int(seed) + int(data_index))


def _gather_tokens(x: torch.Tensor, group) -> torch.Tensor:
    """``[B, N/W, ...]`` slices of the seq group's ranks -> ``[B, N, ...]``."""
    import torch.distributed as dist

    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=1)


def _mean_over(tensors, group) -> None:
    """Average ``tensors`` in place over ``group``: an all-reduce (sum),
    then a division by its size."""
    import torch.distributed as dist

    size = dist.get_world_size(group)
    for t in tensors:
        dist.all_reduce(t, group=group)
        t.div_(size)


def make_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    *,
    task: str = "multi_class",
    loss_fn: Optional[Callable] = None,
    moe_aux_loss_weight: float = 0.0,
    mesh=None,
    seed: Optional[int] = None,
) -> Callable[[Dict[str, Any]], torch.Tensor]:
    """``train_step(batch) -> loss`` for a classification model called as
    ``model(images, coords)``; ``batch`` holds ``images``, ``coords`` and
    ``labels`` (this rank's part of the batch under a ``data`` mesh dim,
    and of the tokens under a ``seq`` dim). The step runs the model in
    training mode, takes ``loss_fn(logits, labels)`` (default
    :func:`cross_entropy_loss` for ``task``) plus ``moe_aux_loss_weight``
    times :func:`collect_moe_l_aux`, averages the gradients over the mesh's
    ``data`` dim and updates the parameters in place. The returned loss
    (detached) is averaged over the same dim. Under a ``model``, ``seq`` or
    ``expert`` dim the step seeds torch's generators once, here (the module
    docstring; ``seed`` fixes the shared part)."""
    group = _group(mesh, "data")
    seq_group = _group(mesh, "seq")
    replicas = [g for g in (_group(mesh, "model"), seq_group, _group(mesh, "expert")) if g is not None]
    if replicas:
        device = next(model.parameters()).device
        _seed_replicas(mesh, replicas, seed, device)

    def train_step(batch: Dict[str, Any]) -> torch.Tensor:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        images, coords = batch["images"], batch["coords"]
        if seq_group is not None:
            images, coords = _gather_tokens(images, seq_group), _gather_tokens(coords, seq_group)
        logits = model(images, coords)
        if loss_fn is not None:
            loss = loss_fn(logits, batch["labels"])
        else:
            loss = cross_entropy_loss(logits, batch["labels"], task)
        if moe_aux_loss_weight:
            loss = loss + moe_aux_loss_weight * collect_moe_l_aux(model).to(loss.device)
        loss.backward()
        loss = loss.detach().clone()
        if group is not None:
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            _mean_over(grads + [loss], group)
        optimizer.step()
        return loss

    return train_step


def make_eval_step(model: nn.Module) -> Callable[[Dict[str, Any]], torch.Tensor]:
    """``eval_step(batch) -> logits``: the model in evaluation mode (no
    dropout or drop-path) without gradients; the model's previous mode is
    restored after."""

    def eval_step(batch: Dict[str, Any]) -> torch.Tensor:
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                return model(batch["images"], batch["coords"])
        finally:
            model.train(was_training)

    return eval_step
