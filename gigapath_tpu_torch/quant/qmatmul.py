"""Quantized matmul and ``QuantLinear`` (counterpart of
``gigapath_tpu/quant/qmatmul.py``).

Numerics contract, the same as the JAX package's: the int8 / fp8 weight is
widened exactly, the activation is rounded to bf16, the products are summed
in fp32, and the per-output-channel scale multiplies the fp32 sum once. The
only approximation is the weight quantization itself (:mod:`.qtensor`).

Weights keep ``nn.Linear``'s layout: a quantized weight is a
:class:`~.qtensor.QTensor` with data ``[N, K]`` (K contiguous) and scale
``[N, 1]``, quantized along ``axis=0``; the JAX package's ``[K, N]``
kernel with scale ``[1, N]`` holds the same numbers transposed.

Dispatch differs from the JAX package's: there the Pallas tier runs only
behind the ``quant_pallas`` flag and only when K and N are multiples of the
TPU's 128-lane quantum. Here :func:`q_matmul` launches
``csrc/q_matmul.cu`` on every CUDA tensor, at any M, K and N, and runs the
plain version :func:`q_matmul_reference` on a CPU tensor; it counts its
launches in :data:`LAUNCHES`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gigapath_tpu_torch.ops.common import check_cuda, cuda_stream, raise_on
from gigapath_tpu_torch.quant.qtensor import QTensor, base_mode, normalize_mode, quantize_per_channel

# Launches of the CUDA kernel in this process: the wrapper adds one where it
# launches it and nowhere else; callers reset and read it.
LAUNCHES = {"q_matmul": 0}


def reset_launch_counts() -> None:
    LAUNCHES["q_matmul"] = 0


def q_matmul_reference(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """``[..., K]`` times the quantized ``[N, K]`` weight -> fp32 ``[..., N]``:
    bf16 x times the weight widened to fp32, fp32 sums, times the scale.
    (A bf16 value times an int8 or e4m3 weight is exact in fp32, so this is
    the JAX package's bf16 x bf16 product with fp32 accumulation.)"""
    xb = x.to(torch.bfloat16).float()
    return (xb @ qt.data.float().t()) * qt.scale.reshape(-1)


def q_matmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """The quantized matmul: fp32 ``[..., N]`` (``csrc/q_matmul.cu`` on a
    CUDA tensor, :func:`q_matmul_reference` on a CPU one)."""
    if x.device.type == "cpu":
        return q_matmul_reference(x, qt)
    from gigapath_tpu_torch.ops import _build

    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError("q_matmul: the quantized tier is inference-only on the card (no backward)")
    N, K = qt.data.shape
    if x.shape[-1] != K:
        raise ValueError(f"q_matmul: x has K={x.shape[-1]}, the weight [N, K] = {tuple(qt.data.shape)}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K).to(torch.bfloat16).contiguous()
    M = x2.shape[0]
    check_cuda("q_matmul x", x2, (torch.bfloat16,))
    check_cuda("q_matmul weight", qt.data, (torch.int8, torch.float8_e4m3fn))
    scale = qt.scale.reshape(-1)
    check_cuda("q_matmul scale", scale, (torch.float32,))
    if qt.data.device != x2.device or scale.device != x2.device or scale.numel() != N:
        raise ValueError("q_matmul: x, weight and scale [N] must share a device")
    if M >= 2**31 - 128:
        raise ValueError(f"q_matmul: M = {M} rows, the kernel takes fewer than 2^31 - 128")
    y = torch.empty((M, N), dtype=torch.float32, device=x2.device)
    if M == 0:
        return y.reshape(*lead, N)
    vec = int(K % 8 == 0 and N % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (x2, qt.data, scale, y)))
    with torch.cuda.device(x2.device):
        rc = _build.library("q_matmul").gp_q_matmul(
            x2.data_ptr(), qt.data.data_ptr(), scale.data_ptr(), y.data_ptr(),
            M, N, K, int(qt.data.dtype == torch.float8_e4m3fn), vec, cuda_stream(x2),
        )
    raise_on(rc, "q_matmul")
    LAUNCHES["q_matmul"] += 1
    return y.reshape(*lead, N)


class QuantLinear(nn.Module):
    """``nn.Linear`` with a quantized-weight forward (the ``QuantDense``
    twin).

    Its parameters are exactly ``nn.Linear``'s (``weight`` [out, in] and
    ``bias`` [out], fp32), so a timm state dict loads unchanged. The
    forward quantizes the fp32 master weight per output channel, as
    ``QuantDense`` quantizes its fp32 kernel under a bf16 compute dtype,
    and runs :func:`q_matmul`: fp32 out, plus the fp32 bias, cast to the
    input's dtype (the module's compute dtype). The quantized weight is
    computed once and kept until the weight changes (an in-place update,
    a load or a move to another device), where the JAX package
    re-quantizes inside every traced forward; the numbers are the same.
    """

    def __init__(self, in_features: int, out_features: int, mode: str, bias: bool = True):
        super().__init__()
        self.mode = base_mode(normalize_mode(mode))
        if not self.mode:
            raise ValueError("QuantLinear requires a quant mode; use nn.Linear for the unquantized path")
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(torch.empty((out_features, in_features)))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        self._cached: Optional[tuple] = None  # (weight key, QTensor)

    def quantized_weight(self) -> QTensor:
        w = self.weight
        key = (w.data_ptr(), w.device, w._version)
        if self._cached is None or self._cached[0] != key:
            with torch.no_grad():
                qt = quantize_per_channel(w.detach(), self.mode, axis=0)
            self._cached = (key, QTensor(qt.data.contiguous(), qt.scale))
        return self._cached[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = q_matmul(x, self.quantized_weight())
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)

    def extra_repr(self) -> str:
        return f"in_features={self.in_features}, out_features={self.out_features}, mode={self.mode}"


def linear(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``layer`` (an ``nn.Linear`` or a :class:`QuantLinear`) applied in
    ``x``'s dtype: an ``nn.Linear`` casts its fp32 weight and bias to it, as
    a flax ``Dense`` with a compute ``dtype`` does."""
    if isinstance(layer, QuantLinear):
        return layer(x)
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)

