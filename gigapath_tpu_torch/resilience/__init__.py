"""Fault-tolerance layer of the port (counterpart of
``gigapath_tpu/resilience``): the deterministic chaos injection that the
serving stack and the dist fleet read,
:mod:`gigapath_tpu_torch.resilience.chaos` (``GIGAPATH_CHAOS``, parsed once
host-side by ``get_chaos``), and the hardened checkpoints of
:mod:`gigapath_tpu_torch.resilience.checkpoint` (``ResilientCheckpointer``:
atomic, manifest-verified, rotated, SIGTERM-armed), which the dist
consumer's resume runs on. The non-finite guard goes with the trainer
(``ROADMAP.md`` Queue A item 5).
"""

from gigapath_tpu_torch.resilience.chaos import (
    ChaosError,
    ChaosInjector,
    NullChaos,
    get_chaos,
)
from gigapath_tpu_torch.resilience.checkpoint import ResilientCheckpointer

__all__ = [
    "ChaosError",
    "ChaosInjector",
    "NullChaos",
    "ResilientCheckpointer",
    "get_chaos",
]
