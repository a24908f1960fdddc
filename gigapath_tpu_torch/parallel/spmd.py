"""Training and evaluation steps over a mesh (counterpart of
``gigapath_tpu/parallel/spmd.py``).

The JAX package builds one pure ``jit`` step and lets XLA insert the
gradient all-reduce from sharding annotations. Here a step runs in every
rank's process on that rank's part of the batch, and the all-reduce over
the mesh's ``data`` dim is explicit: the gradients are summed over it and
divided by its size before ``optimizer.step()`` (gloo has no
``ReduceOp.AVG``), and the reported loss is averaged the same way, so a
data-parallel step over equal parts equals the one-process step over the
whole batch. A ``seq`` or ``model`` dim above 1 is refused in the train
step: a model whose weights or activations are sharded there needs the
tensor-parallel layer, which is not ported yet (``ROADMAP.md`` Queue A
item 1).
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
    """The sum of the MoE layers' balance losses (the JAX package sows them
    into the ``intermediates`` collection): 0, until ``ops/moe/`` is
    ported (``ROADMAP.md`` Queue A item 1)."""
    return torch.zeros((), dtype=torch.float32)


def _data_group(mesh):
    """The process group of ``mesh``'s ``data`` dim, or None where it has
    one rank; ``NotImplementedError`` for a ``seq`` or ``model`` dim above
    1."""
    if mesh is None:
        return None
    from gigapath_tpu_torch.parallel.mesh import axis_size

    for axis in ("seq", "model"):
        if axis_size(mesh, axis) > 1:
            raise NotImplementedError(
                f"make_train_step over a '{axis}' mesh dim of {axis_size(mesh, axis)} ranks needs the "
                "tensor-parallel layer, which is not ported yet (ROADMAP.md Queue A item 1); "
                "sequence-parallel attention runs through dilated_attention(seq_group=)"
            )
    return mesh.get_group("data") if axis_size(mesh, "data") > 1 else None


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
) -> Callable[[Dict[str, Any]], torch.Tensor]:
    """``train_step(batch) -> loss`` for a classification model called as
    ``model(images, coords)``; ``batch`` holds ``images``, ``coords`` and
    ``labels`` (this rank's part of the batch under a ``data`` mesh dim).
    The step runs the model in training mode, takes ``loss_fn(logits,
    labels)`` (default :func:`cross_entropy_loss` for ``task``) plus
    ``moe_aux_loss_weight`` times :func:`collect_moe_l_aux`, averages the
    gradients over the mesh's ``data`` dim and updates the parameters in
    place. The returned loss (detached) is averaged over the same dim."""
    group = _data_group(mesh)

    def train_step(batch: Dict[str, Any]) -> torch.Tensor:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        logits = model(batch["images"], batch["coords"])
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
