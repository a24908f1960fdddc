"""Tiny helpers shared across the ops layer and the kernel wrappers."""

from __future__ import annotations

import torch


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
