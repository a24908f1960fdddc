"""Geometry-keyed execution plans (counterpart of ``gigapath_tpu/plan/``):
:func:`resolve_plan` is the one seam the dilated-attention dispatch routes
through. The registry reader and writer honour the JAX package's file
format, so one ``PLAN_REGISTRY.json`` serves both packages."""

from gigapath_tpu_torch.plan.executionplan import (
    BRANCH_VARIANTS,
    FUSION_CLASSES,
    ExecutionPlan,
    apply_plan,
    geometry_key,
    lookup_plan,
    plan_enabled,
    plan_registry_signature,
    plan_stats,
    reset_plan_state,
    resolve_plan,
    shape_signature,
)
from gigapath_tpu_torch.plan.registry import (
    REGISTRY_SCHEMA_VERSION,
    CorruptPlanRegistry,
    bless_plan,
    load_registry,
    new_registry,
    registry_path,
    save_registry,
)

__all__ = [
    "BRANCH_VARIANTS",
    "FUSION_CLASSES",
    "ExecutionPlan",
    "apply_plan",
    "geometry_key",
    "lookup_plan",
    "plan_enabled",
    "plan_registry_signature",
    "plan_stats",
    "reset_plan_state",
    "resolve_plan",
    "shape_signature",
    "REGISTRY_SCHEMA_VERSION",
    "CorruptPlanRegistry",
    "bless_plan",
    "load_registry",
    "new_registry",
    "registry_path",
    "save_registry",
]
