"""Mixture of experts (counterpart of ``gigapath_tpu/ops/moe``): the
gates (:mod:`~gigapath_tpu_torch.ops.moe.routing`), the layer
(:mod:`~gigapath_tpu_torch.ops.moe.moe_layer`) and expert parallelism
(:mod:`~gigapath_tpu_torch.ops.moe.expert_parallel`)."""

from gigapath_tpu_torch.ops.moe.moe_layer import MOELayer, StackedExperts  # noqa: F401
from gigapath_tpu_torch.ops.moe.routing import Top1Gate, Top2Gate, top1_gating, top2_gating  # noqa: F401
