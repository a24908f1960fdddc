"""Per-step scalar telemetry computed on the device (counterpart of
``gigapath_tpu/obs/telemetry.py``).

The helpers queue a handful of reductions on the device where the step
runs and return 0-d tensors. The host converts them to floats only at its
existing sync points (the fine-tune loop's 20-iteration echo), so the
telemetry adds no device round trip of its own. They read no environment
variable and branch on no value.

A tree is a tensor, an iterable of tensors, or a (possibly nested) dict of
them, e.g. ``dict(model.named_parameters())``; ``None`` leaves (a
parameter the loss never reached has no ``.grad``) count as zeros.
``moe_scalars`` reads the MoE layers' last gating metadata.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of ``tree`` (dicts in key order), ``None`` dropped."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    return [leaf for item in tree for leaf in tree_leaves(item)]


def fp32_leaves(tree) -> List[torch.Tensor]:
    """The leaves of ``tree``, detached, as fp32 (bf16 squares of ~1e-2
    gradients underflow)."""
    return [leaf.detach().float() for leaf in tree_leaves(tree)]


def tree_norm(tree) -> torch.Tensor:
    """Global L2 norm over a tree, accumulated in fp32: one multi-tensor
    norm per leaf, then the norm of those."""
    leaves = fp32_leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(leaves, 2)))


def step_scalars(
    loss: Optional[torch.Tensor] = None,
    grads=None,
    params=None,
    **extras,
) -> Dict[str, torch.Tensor]:
    """The standard per-step scalar set: loss, grad norm, param norm, and
    any caller extras (0-d tensors). The values are 0-d tensors on the
    step's device, not synchronised: hand them to ``RunLog.step`` only at a
    host sync point."""
    out: Dict[str, torch.Tensor] = {}
    if loss is not None:
        out["loss"] = loss.detach().float()
    if grads is not None:
        out["grad_norm"] = tree_norm(grads)
    if params is not None:
        out["param_norm"] = tree_norm(params)
    out.update(extras)
    return out


def moe_scalars(model) -> Dict[str, torch.Tensor]:
    """The MoE layers' gating telemetry of ``model``'s last forward as 0-d
    device tensors under the JAX package's ``layer_path/metric`` keys (the
    flattening of ``utils/profiling.py:iter_moe_metadata``), not
    synchronised: merge them into :func:`step_scalars`' dict and read them
    at the step's sync point."""
    from gigapath_tpu_torch.utils.profiling import iter_moe_metadata

    return {key: leaf.detach() for key, leaf in iter_moe_metadata(model)}


__all__ = ["fp32_leaves", "moe_scalars", "step_scalars", "tree_leaves", "tree_norm"]
