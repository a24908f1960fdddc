"""Tiny helpers shared across the ops layer and the kernel wrappers, and
the seam through which a compile-side profile (``obs/ledger.py``) sees the
hand-written kernels."""

from __future__ import annotations

import functools
import inspect
from typing import Callable

import torch

def _open_profile():
    """The compile-side profile open on this thread (or on the autograd
    thread that runs its backward, which inherits the dispatch-mode stack):
    the innermost mode on the stack with a ``kernel_call``
    (``obs/ledger.py``'s op counter), else None. Outside a profile the
    stack is empty and this is one length test."""
    if not torch._C._len_torch_dispatch_stack():
        return None
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for mode in reversed(_get_current_dispatch_mode_stack()):
        if hasattr(mode, "kernel_call"):
            return mode
    return None


def kernel_wrapper(name: str, cost: Callable):
    """Mark the wrapper of the hand-written kernel ``name`` for the
    compile-side profile.

    While a profile is open (:func:`_open_profile`), the wrapper's own aten
    ops (its plain version on the CPU, its checks and allocations on the
    card) are hidden from the profile, and the call counts as one launch
    of the kernel: each wrapper launches its kernel once a call on the card
    (an empty input, which launches nothing, still counts one), and the
    plain version on the CPU stands for that launch, so the count is the
    same on both devices and no other thread's launches reach it.
    ``cost`` takes the wrapper's arguments by name (defaults filled in) and
    returns ``(flops, bytes)``: the operations the kernel's masks admit and
    the bytes it must move (each input read once, each output written
    once). A full profile asks for it, and ``wrapped.declared_work(*args,
    **kwargs)`` gives it to any caller (``chip_smoke.py``'s bounds). The
    kernel's body stays opaque, as a ``pallas_call``'s does in a jaxpr."""

    def decorate(fn):
        signature = inspect.signature(fn)

        def declared_work(*args, **kwargs):
            bound = signature.bind(*args, **kwargs)
            bound.apply_defaults()
            return cost(**bound.arguments)

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            profile = _open_profile()
            if profile is not None:
                return profile.kernel_call(name, declared_work, fn, args, kwargs)
            return fn(*args, **kwargs)

        wrapped.declared_work = declared_work
        return wrapped

    return decorate


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def check_cuda(name: str, t: torch.Tensor, dtypes=(torch.float32, torch.bfloat16)) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of one of ``dtypes``."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def cuda_stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as the pointer a kernel
    launch takes."""
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on(rc: int, kernel: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {rc}")


def env_flag(name: str) -> bool:
    """A truthy ``GIGAPATH_*`` flag: unset, '', '0', 'false' and 'no' mean
    off (the JAX package's one truthiness convention)."""
    import os

    return os.environ.get(name, "").strip().lower() not in ("", "0", "false", "no")
