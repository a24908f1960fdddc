"""The port's device rule: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means ``cuda``.

    Raises when no device is given and no GPU is present: the entry points
    never carry on silently on the CPU. Pass ``device="cpu"`` to run the
    plain PyTorch versions of the kernels there.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU"
        )
    return torch.device("cuda")
