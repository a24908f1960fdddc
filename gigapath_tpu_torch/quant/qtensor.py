"""Quantized-weight containers and the quantize/dequantize helpers
(counterpart of ``gigapath_tpu/quant/qtensor.py``).

Two weight formats, both symmetric per-output-channel absmax with no zero
point: int8 (the channel's absmax maps to 127) and fp8-e4m3 (it maps to
448, the e4m3 max normal; ``torch.float8_e4m3fn`` is the same OCP format as
the JAX package's ``float8_e4m3fn``). The contract:

- ``QTensor(data, scale)``: ``data`` in the low-precision dtype, ``scale``
  fp32 broadcastable against it (one scale per output channel);
- :func:`dequantize` returns fp32 ``data * scale``;
- ``quantize_per_channel(dequantize(qt)) == qt`` bit for bit.

Both packages do the same IEEE fp32 operations in the same order (absmax,
divide, round half to even, clip, or a round-to-nearest-even cast to
e4m3), so the data and scales are bit-equal to the JAX package's for the
same fp32 input, whatever the layout: the port's ``nn.Linear`` weight is
``[out, in]`` and quantizes along ``axis=0``, the JAX ``[in, out]`` kernel
along ``axis=-1``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

QINT8 = "int8"
QFP8 = "fp8_e4m3"
QUANT_MODES: Tuple[str, ...] = (QINT8, QFP8)

INT8_MAX = 127.0
FP8_E4M3_MAX = 448.0

_ALIASES = {
    "": "", "0": "", "false": "", "no": "",
    "1": QINT8, "true": QINT8, "yes": QINT8, "int8": QINT8,
    "fp8": QFP8, "fp8_e4m3": QFP8, "e4m3": QFP8, "float8_e4m3": QFP8,
}


def normalize_mode(mode: str) -> str:
    """One spelling per mode: '', '0', 'false', 'no' -> '' (off);
    '1'/'true'/'yes'/'int8' -> int8; 'fp8'/'fp8_e4m3'/'e4m3' -> fp8. A
    ``+attn`` suffix passes through. An unknown spelling raises: a
    mistyped mode never serves the unquantized path."""
    raw = (mode or "").strip().lower()
    base, _, suffix = raw.partition("+")
    if suffix not in ("", "attn"):
        raise ValueError(f"unknown quant suffix '+{suffix}' in '{mode}'")
    if base not in _ALIASES:
        raise ValueError(f"unknown quant mode '{mode}' (modes: {QUANT_MODES}, optionally '+attn')")
    base = _ALIASES[base]
    return f"{base}+attn" if (base and suffix) else base


def base_mode(mode: str) -> str:
    """'int8+attn' -> 'int8' (the weight format without the attn rider)."""
    return normalize_mode(mode).partition("+")[0]


def quant_attn(mode: str) -> bool:
    """True when the mode quantizes the attention logits too ('+attn')."""
    return normalize_mode(mode).endswith("+attn")


class QTensor(NamedTuple):
    """A quantized tensor: low-precision ``data`` and fp32 ``scale``."""

    data: torch.Tensor
    scale: torch.Tensor

    @property
    def mode(self) -> str:
        return QINT8 if self.data.dtype == torch.int8 else QFP8


def _absmax_scale(w32: torch.Tensor, qmax: float, axis: int) -> torch.Tensor:
    """Per-channel absmax / qmax along ``axis``, keepdims, fp32; an
    all-zero channel gets scale 1 so its dequant stays exact zeros."""
    reduce = [a for a in range(w32.ndim) if a != axis % w32.ndim]
    absmax = w32.abs().amax(dim=reduce, keepdim=True) if reduce else w32.abs()
    return torch.where(absmax > 0, absmax / qmax, torch.ones_like(absmax))


def quantize_per_channel(w, mode: str = QINT8, *, axis: int = -1) -> QTensor:
    """Symmetric per-channel absmax quantization; ``axis`` is the output
    channel (``0`` for an ``nn.Linear`` weight ``[out, in]``)."""
    mode = base_mode(mode)
    w32 = torch.as_tensor(w).float()
    if mode == QINT8:
        scale = _absmax_scale(w32, INT8_MAX, axis)
        q = torch.clamp(torch.round(w32 / scale), -INT8_MAX, INT8_MAX)
        return QTensor(q.to(torch.int8), scale)
    if mode == QFP8:
        scale = _absmax_scale(w32, FP8_E4M3_MAX, axis)
        return QTensor((w32 / scale).to(torch.float8_e4m3fn), scale)
    raise ValueError(f"unknown quant mode '{mode}' (modes: {QUANT_MODES})")


def dequantize(qt: QTensor) -> torch.Tensor:
    """fp32 ``data * scale``."""
    return qt.data.float() * qt.scale


def quantize_dynamic(x: torch.Tensor) -> QTensor:
    """int8 activation quantization for the '+attn' tier: ``x`` [B, H, L,
    D] -> data int8 [B, H, L, D] with one scale per (batch, head), fp32
    [B, H, 1, 1]."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=(-2, -1), keepdim=True)
    scale = torch.where(absmax > 0, absmax / INT8_MAX, torch.ones_like(absmax))
    q = torch.clamp(torch.round(x32 / scale), -INT8_MAX, INT8_MAX)
    return QTensor(q.to(torch.int8), scale)


def bf16_round_trip(embeds) -> np.ndarray:
    """Round to bf16 and return fp32 numpy: the quantization every
    producer of tile embeddings applies before the slide encoder."""
    return torch.as_tensor(np.asarray(embeds)).to(torch.bfloat16).float().numpy()
