"""Model registry: named architecture factories (counterpart of
``gigapath_tpu/utils/registry.py``, kept as the port's own copy)."""

from __future__ import annotations

from typing import Callable, Dict, List

MODEL_REGISTRY: Dict[str, Callable] = {}


def register_model(fn: Callable) -> Callable:
    MODEL_REGISTRY[fn.__name__] = fn
    return fn


def create_model_from_registry(arch: str, **kwargs):
    if arch not in MODEL_REGISTRY:
        raise KeyError(f"unknown model arch {arch!r}; known: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[arch](**kwargs)


def list_models() -> List[str]:
    return sorted(MODEL_REGISTRY)
