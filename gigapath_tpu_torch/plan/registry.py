"""Reader of the registry of blessed execution plans (counterpart of
``gigapath_tpu/plan/registry.py``).

One JSON document at ``GIGAPATH_PLAN_REGISTRY`` (default:
``PLAN_REGISTRY.json`` at the root of the checkout), keyed by the geometry
key ``name|shape-signature``, holding one serialized
:class:`~gigapath_tpu_torch.plan.executionplan.ExecutionPlan` per geometry,
and a sha256 over the canonical serialization of its entries. The format is
the JAX package's, so one file serves both packages. A file whose digest
does not match is refused (:class:`CorruptPlanRegistry`), never read in
part. :func:`save_registry` writes atomically (a ``.tmp-*`` sibling renamed
into place, so a killed writer never leaves a torn registry) with the
digest stamped; :func:`bless_plan` loads strictly before it writes, so a
corrupt registry is refused, never overwritten.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Optional

REGISTRY_SCHEMA_VERSION = 1
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_REGISTRY_BASENAME = "PLAN_REGISTRY.json"


class CorruptPlanRegistry(ValueError):
    """A plan registry whose digest verification failed."""


def registry_path() -> str:
    """``GIGAPATH_PLAN_REGISTRY`` when set, else ``PLAN_REGISTRY.json`` at
    the root of the checkout."""
    override = os.environ.get("GIGAPATH_PLAN_REGISTRY", "").strip()
    if override:
        return os.path.abspath(override)
    return os.path.join(_REPO_ROOT, DEFAULT_REGISTRY_BASENAME)


def _digest(entries: Dict[str, Any]) -> str:
    canonical = json.dumps(entries, sort_keys=True, separators=(",", ":"), allow_nan=False)
    return hashlib.sha256(canonical.encode()).hexdigest()


def new_registry() -> dict:
    return {"v": REGISTRY_SCHEMA_VERSION, "entries": {}}


def load_registry(path: Optional[str] = None) -> dict:
    """Verified load: a missing file is an empty registry; a present file
    that is unreadable, of another schema or whose entries digest does not
    match raises :class:`CorruptPlanRegistry`."""
    path = path or registry_path()
    if not os.path.exists(path):
        return new_registry()
    try:
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
    except (OSError, ValueError) as e:
        raise CorruptPlanRegistry(f"{path}: unreadable plan registry ({type(e).__name__}: {e})") from None
    if not isinstance(doc, dict) or not isinstance(doc.get("entries"), dict):
        raise CorruptPlanRegistry(f"{path}: no 'entries' object")
    if doc.get("v") != REGISTRY_SCHEMA_VERSION:
        raise CorruptPlanRegistry(f"{path}: schema v{doc.get('v')!r} != {REGISTRY_SCHEMA_VERSION}")
    expected, actual = doc.get("sha256"), _digest(doc["entries"])
    if expected != actual:
        raise CorruptPlanRegistry(
            f"{path}: entries digest mismatch (manifest {str(expected)[:12]}..., actual {actual[:12]}...)"
        )
    return doc


def save_registry(doc: dict, path: Optional[str] = None) -> str:
    """Atomic verified save of ``doc``'s entries with their digest stamped;
    returns the path."""
    path = path or registry_path()
    entries = doc.get("entries", {})
    doc = {"v": REGISTRY_SCHEMA_VERSION, "entries": entries, "sha256": _digest(entries)}
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".tmp-{os.path.basename(path)}-{os.getpid()}")
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True, allow_nan=False)
        fh.write("\n")
    os.replace(tmp, path)
    return path


def bless_plan(key: str, plan_doc: Dict[str, Any], *, path: Optional[str] = None,
               provenance: Optional[dict] = None) -> str:
    """Read-modify-write one blessed plan (``ExecutionPlan.as_dict()``)
    under the geometry key ``key``; a strict load first, so a corrupt
    registry raises :class:`CorruptPlanRegistry` instead of being
    overwritten. Returns the path."""
    path = path or registry_path()
    doc = load_registry(path)
    entry = dict(plan_doc)
    if provenance:
        entry["provenance"] = dict(provenance)
    doc["entries"][key] = entry
    return save_registry(doc, path)
