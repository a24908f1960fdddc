"""xPos, the extrapolatable rotary position embedding (counterpart of
``gigapath_tpu/ops/xpos.py``).

A rotate-every-two rotary embedding whose amplitude is scaled per pair by
``((2i + 0.4d) / (1.4d)) ** (pos / scale_base)``: keys are downscaled,
queries upscaled. Positions are centred around zero (torchscale's
``XPOS.forward``). The constants are made in fp32 on the input's device, so
a bf16 input gives an fp32 result, as in the JAX package.
"""

from __future__ import annotations

import torch


def _rotate_every_two(x: torch.Tensor) -> torch.Tensor:
    x1 = x[..., ::2]
    x2 = x[..., 1::2]
    return torch.stack((-x2, x1), dim=-1).reshape(x.shape)


def xpos_scale(length: int, head_dim: int, scale_base: int, offset: int = 0, device=None) -> torch.Tensor:
    """Per-(position, pair) amplitude scale at centred positions, ``[L, D/2]``."""
    per_dim = (torch.arange(0, head_dim, 2, device=device) + 0.4 * head_dim) / (1.4 * head_dim)
    min_pos = -(length + offset) // 2
    positions = torch.arange(min_pos, min_pos + length + offset, dtype=torch.float32, device=device)
    scale = per_dim[None, :] ** (positions[:, None] / scale_base)
    return scale[-length:]


def apply_xpos(
    x: torch.Tensor,
    *,
    scale_base: int = 512,
    offset: int = 0,
    downscale: bool = False,
) -> torch.Tensor:
    """xPos along the length axis of ``[B, L, H, D]`` (per head) or ``[B, L,
    D]``: the length is axis -3 of a 4-D input, axis -2 otherwise."""
    head_dim = x.shape[-1]
    length = x.shape[-3] if x.dim() == 4 else x.shape[-2]
    scale = xpos_scale(length, head_dim, scale_base, offset, device=x.device)  # [L, D/2]
    if downscale:
        scale = 1.0 / scale
    # the sinusoid runs over length + offset rows and keeps the last
    # `length`, as the scale rows do
    half = scale.shape[-1]
    inv_freq = 1.0 / (10000 ** (torch.arange(0, half, device=x.device) / half))
    positions = torch.arange(length + offset, dtype=torch.float32, device=x.device)[-length:]
    sinusoid = positions[:, None] * inv_freq[None, :]
    sin = torch.repeat_interleave(torch.sin(sinusoid) * scale, 2, dim=-1)
    cos = torch.repeat_interleave(torch.cos(sinusoid) * scale, 2, dim=-1)
    if x.dim() == 4:  # [B, L, H, D]: broadcast over the heads
        sin = sin[None, :, None, :]
        cos = cos[None, :, None, :]
    return (x * cos) + (_rotate_every_two(x) * sin)
