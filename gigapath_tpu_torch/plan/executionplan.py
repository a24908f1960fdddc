"""Geometry-keyed execution plans: one dispatch decision per public call
(counterpart of ``gigapath_tpu/plan/executionplan.py``).

:func:`resolve_plan` snapshots the ``GIGAPATH_*`` dispatch flags
(:func:`~gigapath_tpu_torch.ops.dilated_kernels.snapshot_flags`), looks the
call's geometry key up in the registry of blessed plans
(:mod:`gigapath_tpu_torch.plan.registry`) and overlays the plan where the
environment is silent:

1. a dispatch flag present (non-empty) in the environment keeps its value,
   an explicit ``=0`` included;
2. the blessed plan fills the fields the environment leaves unset;
3. the defaults cover the rest: with no registry entry the result is
   ``snapshot_flags()`` itself.

``GIGAPATH_PLAN=off`` (or ``0``/``false``/``no``) turns plan lookup off. A
corrupt registry is refused with one warning and read as empty, so it can
degrade dispatch to the flags and defaults but never mis-dispatch.

The geometry key is the JAX package's, dtype names included
(``dilated_attention|bfloat16[1,10241,16,48];...``), so one registry file
gives the same plan to both packages. :func:`plan_stats` counts lookups and
hits, :func:`plan_registry_signature` names the active registry state.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

from gigapath_tpu_torch.plan.registry import CorruptPlanRegistry, _digest, load_registry, registry_path

BRANCH_VARIANTS = ("", "serial", "pipelined")
FUSION_CLASSES = ("", "dense", "stream", "streaming")
_SCALAR_PLAN_FIELDS = (
    "pipelined_fwd", "pipelined_bwd", "pipe_block_k", "pipe_bwd_block_k",
    "pack_direct", "ring_attn", "chunked_prefill", "quant_tile",
    "quant_pallas", "fold_pallas", "fold_block_q", "fold_block_k",
)
_INT_FIELDS = ("pipe_block_k", "pipe_bwd_block_k", "fold_block_q", "fold_block_k")


class ExecutionPlan(NamedTuple):
    """One geometry's blessed dispatch decision; a zero value ("" / None /
    ()) means no opinion. ``branches``: ``(segment_length, ratio, variant,
    block)`` per branch class; ``fusion``: ``"stream"`` (the packed
    epilogue), ``"streaming"`` (the online dense fold) or ``"dense"``.
    Block sizes are TPU tiling, carried and unused by the port."""

    branches: Tuple[Tuple[int, int, str, int], ...] = ()
    fusion: str = ""
    pipelined_fwd: Optional[bool] = None
    pipelined_bwd: Optional[bool] = None
    pipe_block_k: Optional[int] = None
    pipe_bwd_block_k: Optional[int] = None
    pack_direct: Optional[bool] = None
    ring_attn: Optional[bool] = None
    chunked_prefill: Optional[bool] = None
    quant_tile: Optional[str] = None
    quant_pallas: Optional[bool] = None
    fold_pallas: Optional[bool] = None
    fold_block_q: Optional[int] = None
    fold_block_k: Optional[int] = None
    fold_branches: Tuple[Tuple[int, int, int, int], ...] = ()

    def as_dict(self) -> Dict[str, Any]:
        """Registry serialization: only the fields with an opinion."""
        doc: Dict[str, Any] = {}
        if self.branches:
            doc["branches"] = [[int(sl), int(r), str(v), int(b)] for sl, r, v, b in self.branches]
        if self.fold_branches:
            doc["fold_branches"] = [[int(sl), int(r), int(bq), int(bk)] for sl, r, bq, bk in self.fold_branches]
        if self.fusion:
            doc["fusion"] = str(self.fusion)
        for field in _SCALAR_PLAN_FIELDS:
            value = getattr(self, field)
            if value is not None:
                doc[field] = value
        return doc

    @classmethod
    def from_dict(cls, doc: Dict[str, Any]) -> "ExecutionPlan":
        """A registry entry -> a plan; unknown keys are ignored, a malformed
        known field raises ValueError."""
        branches = []
        for sl, r, variant, block in doc.get("branches", ()) or ():
            if str(variant) not in BRANCH_VARIANTS:
                raise ValueError(f"unknown branch variant {variant!r}")
            branches.append((int(sl), int(r), str(variant), int(block)))
        fold_branches = tuple(
            (int(sl), int(r), int(bq), int(bk)) for sl, r, bq, bk in doc.get("fold_branches", ()) or ()
        )
        fusion = str(doc.get("fusion", "") or "")
        if fusion not in FUSION_CLASSES:
            raise ValueError(f"unknown fusion class {fusion!r}")
        kwargs: Dict[str, Any] = {}
        for field in _SCALAR_PLAN_FIELDS:
            value = doc.get(field)
            if value is None:
                continue
            if field in _INT_FIELDS:
                kwargs[field] = int(value)
            elif field == "quant_tile":
                from gigapath_tpu_torch.quant.qtensor import normalize_mode

                kwargs[field] = normalize_mode(str(value))
            else:
                kwargs[field] = bool(value)
        return cls(branches=tuple(branches), fusion=fusion, fold_branches=fold_branches, **kwargs)


def shape_signature(args: Sequence[Any]) -> str:
    """The JAX package's ledger signature (``obs/ledger.py``) over array-like
    arguments: ``dtype[d0,d1,...]`` joined by ``;``, with numpy's dtype
    names (``bfloat16``, not ``torch.bfloat16``); a dict counts as
    ``tree{leaves}``; other values are skipped."""

    def leaves(value: Any) -> int:
        if isinstance(value, dict):
            return sum(leaves(v) for v in value.values())
        if isinstance(value, (list, tuple)):
            return sum(leaves(v) for v in value)
        return 1

    parts = []
    for value in args:
        shape = getattr(value, "shape", None)
        if shape is not None and hasattr(value, "dtype"):
            dtype = str(value.dtype).replace("torch.", "")
            parts.append(f"{dtype}[{','.join(str(int(d)) for d in shape)}]")
        elif isinstance(value, dict):
            parts.append(f"tree{{{leaves(value)}}}")
    return ";".join(parts)


def geometry_key(name: str, shapes: Sequence[Any]) -> str:
    """The registry key ``name|shape-signature`` (only ``.shape`` and
    ``.dtype`` are read)."""
    if not isinstance(shapes, (tuple, list)):
        shapes = (shapes,)
    return f"{name}|{shape_signature(tuple(shapes))}"


# one parsed registry per (path, mtime, size): an edit is seen on the next
# resolve, an unchanged file costs one os.stat
_CACHE: Dict[str, Any] = {"stamp": None, "doc": None}
_STATS: Dict[str, int] = {"lookups": 0, "hits": 0}
_WARNED: set = set()


def _warn_once(msg: str) -> None:
    if msg not in _WARNED:
        _WARNED.add(msg)
        warnings.warn(msg, stacklevel=3)


def reset_plan_state() -> None:
    """Drop the registry cache, the lookup counters and the warn-once
    memory."""
    _CACHE["stamp"] = _CACHE["doc"] = None
    _STATS["lookups"] = _STATS["hits"] = 0
    _WARNED.clear()


def plan_stats() -> Dict[str, float]:
    """Lookups and hits since the process started (or the last reset), and
    the hit rate."""
    lookups = _STATS["lookups"]
    return {"lookups": lookups, "hits": _STATS["hits"],
            "plan_hit_rate": (_STATS["hits"] / lookups) if lookups else 0.0}


def plan_enabled() -> bool:
    """``GIGAPATH_PLAN``: off/0/false/no turn plan lookup off."""
    return os.environ.get("GIGAPATH_PLAN", "").strip().lower() not in ("off", "0", "false", "no")


def _env_present(name: str) -> bool:
    return bool(os.environ.get(name, "").strip())


def _registry_doc() -> dict:
    path = registry_path()
    try:
        st = os.stat(path)
        stamp = (path, st.st_mtime_ns, st.st_size)
    except OSError:
        stamp = (path, None, None)
    if _CACHE["stamp"] != stamp:
        try:
            doc = load_registry(path)
        except CorruptPlanRegistry as e:
            _warn_once(f"plan registry refused: {e}; dispatch falls back to env-flag/default behavior")
            doc = {"v": 1, "entries": {}}
        _CACHE["stamp"], _CACHE["doc"] = stamp, doc
    return _CACHE["doc"]


def plan_registry_signature() -> str:
    """Identity of the active plan state: the verified registry's entries
    digest when lookup is on and the registry holds entries, else
    ``"plan-none"`` (off, missing, empty and refused registries all give
    the flag/default dispatch)."""
    if not plan_enabled():
        return "plan-none"
    entries = _registry_doc().get("entries") or {}
    return _digest(entries) if entries else "plan-none"


def lookup_plan(key: str) -> Optional[ExecutionPlan]:
    """The registry's plan for one geometry key, or None; a malformed entry
    is refused with one warning. Counts into :func:`plan_stats`."""
    _STATS["lookups"] += 1
    entry = (_registry_doc().get("entries") or {}).get(key)
    if entry is None:
        return None
    try:
        plan = ExecutionPlan.from_dict(entry)
    except (ValueError, TypeError, KeyError) as e:
        _warn_once(f"plan registry entry for {key!r} refused ({type(e).__name__}: {e}); using flag/default dispatch")
        return None
    _STATS["hits"] += 1
    return plan


def apply_plan(plan: ExecutionPlan, snap):
    """Overlay a plan onto a flag snapshot: a field whose environment
    variable is present keeps the snapshot's value, the rest take the
    plan's opinion."""
    from gigapath_tpu_torch.ops.dilated_kernels import FLAG_ENV

    updates: Dict[str, Any] = {}
    for field in _SCALAR_PLAN_FIELDS:
        opinion = getattr(plan, field)
        if opinion is not None and not _env_present(FLAG_ENV[field]):
            updates[field] = opinion
    fusion = {"stream": {"stream_fusion": True}, "streaming": {"streaming_fusion": True},
              "dense": {"stream_fusion": False, "streaming_fusion": False}}.get(plan.fusion, {})
    for field, value in fusion.items():
        if not _env_present(FLAG_ENV[field]):
            updates[field] = value
    if plan.branches:
        # a set global pipelined flag beats the per-branch variants
        strip = _env_present(FLAG_ENV["pipelined_fwd"])
        updates["branch_plans"] = tuple(
            (int(sl), int(r), "" if strip else str(v), int(b)) for sl, r, v, b in plan.branches
        )
    if plan.fold_branches:
        strip_q = _env_present(FLAG_ENV["fold_block_q"])
        strip_k = _env_present(FLAG_ENV["fold_block_k"])
        updates["fold_branches"] = tuple(
            (int(sl), int(r), 0 if strip_q else int(bq), 0 if strip_k else int(bk))
            for sl, r, bq, bk in plan.fold_branches
        )
    return snap._replace(**updates) if updates else snap


def resolve_plan(name: str, shapes: Sequence[Any], flags=None):
    """The dispatch seam: one resolved ``PipelineFlags`` per public call.
    ``flags`` given is returned as it is (the caller resolved once
    already, or pins the dispatch)."""
    if flags is not None:
        return flags
    from gigapath_tpu_torch.ops.dilated_kernels import snapshot_flags

    snap = snapshot_flags()
    if not plan_enabled():
        return snap
    plan = lookup_plan(geometry_key(name, shapes))
    return snap if plan is None else apply_plan(plan, snap)
