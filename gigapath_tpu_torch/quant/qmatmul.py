"""Quantized matmul and ``QuantLinear`` (counterpart of
``gigapath_tpu/quant/qmatmul.py``).

Numerics contract, the same as the JAX package's: the int8 / fp8 weight is
widened exactly, the activation is rounded to bf16, the products are summed
in fp32, and the per-output-channel scale multiplies the fp32 sum once.
``QuantDense``'s epilogue follows in the same call when asked: plus the
fp32 bias, then one cast to the output dtype (two fp32 roundings, then
the cast). The only approximation is the weight quantization itself
(:mod:`.qtensor`).

Weights keep ``nn.Linear``'s layout: a quantized weight is a
:class:`~.qtensor.QTensor` with data ``[N, K]`` (K contiguous) and scale
``[N, 1]``, quantized along ``axis=0``; the JAX package's ``[K, N]``
kernel with scale ``[1, N]`` holds the same numbers transposed. Where K is
no multiple of 16, both the plain version and the kernel's wrapper zero-pad
K on x and on the weight (zeros add exact zeros); a weight may come
pre-padded to that width (``QuantLinear`` keeps one beside its quantized
weight).

Dispatch differs from the JAX package's: there the Pallas tier runs only
behind the ``quant_pallas`` flag and only when K and N are multiples of the
TPU's 128-lane quantum. Here :func:`q_matmul` launches
``csrc/q_matmul.cu`` (bf16 tensor cores, the epilogue fused) on every CUDA
tensor, at any M, K and N, and runs the plain version
:func:`q_matmul_reference` on a CPU tensor; it counts its launches in
:data:`LAUNCHES`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gigapath_tpu_torch.ops.common import check_cuda, cuda_stream, kernel_wrapper, raise_on, round_up
from gigapath_tpu_torch.quant.qtensor import QTensor, base_mode, normalize_mode, quantize_per_channel

K_QUANTUM = 16  # the kernel's k step: K is zero-padded to a multiple of it

# Launches of the CUDA kernel in this process: the wrapper adds one where it
# launches it and nowhere else; callers reset and read it.
LAUNCHES = {"q_matmul": 0}


def reset_launch_counts() -> None:
    LAUNCHES["q_matmul"] = 0


def pad_weight(data: torch.Tensor) -> torch.Tensor:
    """The ``[N, K]`` quantized weight with K zero-padded to a multiple of
    :data:`K_QUANTUM` (itself when it is one already)."""
    N, K = data.shape
    Kp = round_up(K, K_QUANTUM)
    if Kp == K:
        return data
    padded = torch.zeros((N, Kp), dtype=torch.uint8, device=data.device)
    padded[:, :K] = data.view(torch.uint8)
    return padded.view(data.dtype)


def _padded_operands(x: torch.Tensor, qt: QTensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x as bf16 ``[M, Kp]`` and the weight data ``[N, Kp]``, K zero-padded
    to a multiple of :data:`K_QUANTUM`; the weight may arrive pre-padded."""
    K = x.shape[-1]
    N, Kw = qt.data.shape
    Kp = round_up(K, K_QUANTUM)
    if Kw not in (K, Kp):
        raise ValueError(f"q_matmul: x has K={K}, the weight [N, K] = {tuple(qt.data.shape)}")
    x2 = x.reshape(-1, K).to(torch.bfloat16)
    if Kp != K:
        x2 = F.pad(x2, (0, Kp - K))
    return x2, pad_weight(qt.data)


def q_matmul_reference(
    x: torch.Tensor, qt: QTensor, bias: Optional[torch.Tensor] = None, out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``[..., K]`` times the quantized ``[N, K]`` weight -> ``[..., N]`` in
    ``out_dtype``: bf16 x times the weight widened to fp32, fp32 sums, times
    the scale, plus the fp32 bias, cast. (A bf16 value times an int8 or e4m3
    weight is exact in fp32, so this is the JAX package's bf16 x bf16
    product with fp32 accumulation, then ``QuantDense``'s epilogue.)"""
    x2, data = _padded_operands(x, qt)
    y = (x2.float() @ data.float().t()) * qt.scale.reshape(-1)
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype).reshape(*x.shape[:-1], data.shape[0])


def _q_matmul_cost(x, qt, bias, out_dtype, **_):
    """2 M N K operations; x, the weight, the scale and bias read once, y
    written once."""
    K, N = x.shape[-1], qt.data.shape[0]
    M = x.numel() // max(K, 1)
    nbytes = M * K * x.element_size() + N * K * qt.data.element_size() + N * 4
    nbytes += (0 if bias is None else N * 4) + M * N * torch.empty((), dtype=out_dtype).element_size()
    return 2.0 * M * N * K, float(nbytes)


@kernel_wrapper("q_matmul", _q_matmul_cost)
def q_matmul(
    x: torch.Tensor, qt: QTensor, bias: Optional[torch.Tensor] = None, out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The quantized matmul with ``QuantDense``'s epilogue: ``[..., N]`` in
    ``out_dtype`` (fp32 or bf16; ``csrc/q_matmul.cu`` on a CUDA tensor,
    :func:`q_matmul_reference` on a CPU one). With the defaults it is the
    fp32 product times the scale."""
    if x.device.type == "cpu":
        return q_matmul_reference(x, qt, bias, out_dtype)
    from gigapath_tpu_torch.ops import _build

    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError("q_matmul: the quantized tier is inference-only on the card (no backward)")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q_matmul: out_dtype {out_dtype} is neither float32 nor bfloat16")
    lead = x.shape[:-1]
    x2, data = _padded_operands(x, qt)
    x2 = x2.contiguous()
    if x2.data_ptr() % 16:  # TMA reads 16-byte aligned tensors
        x2 = x2.clone()
    M, K = x2.shape
    N = data.shape[0]
    check_cuda("q_matmul x", x2, (torch.bfloat16,))
    check_cuda("q_matmul weight", data, (torch.int8, torch.float8_e4m3fn))
    scale = qt.scale.reshape(-1)
    check_cuda("q_matmul scale", scale, (torch.float32,))
    if bias is not None:
        bias = bias.detach().float().contiguous()
        if bias.shape != (N,) or bias.device != x2.device:
            raise ValueError(f"q_matmul: bias must be [N] = [{N}] on {x2.device}, got {tuple(bias.shape)}")
    if data.device != x2.device or scale.device != x2.device or scale.numel() != N:
        raise ValueError("q_matmul: x, weight and scale [N] must share a device")
    if data.data_ptr() % 16:
        raise ValueError("q_matmul: the weight must be 16-byte aligned")
    y = torch.empty((M, N), dtype=out_dtype, device=x2.device)
    if M == 0:
        return y.reshape(*lead, N)
    with torch.cuda.device(x2.device):
        rc = _build.library("q_matmul").gp_q_matmul(
            x2.data_ptr(), data.data_ptr(), scale.data_ptr(), None if bias is None else bias.data_ptr(),
            y.data_ptr(), M, N, K, int(data.dtype == torch.float8_e4m3fn), int(out_dtype == torch.bfloat16),
            cuda_stream(x2),
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
    and runs :func:`q_matmul` with the bias and the input's dtype (the
    module's compute dtype): one kernel launch computes the product, the
    scale, the fp32 bias and the cast. The quantized weight (and, where
    ``in_features`` is no multiple of 16, its zero-padded copy for the
    kernel) is computed once and kept until the weight changes (an in-place
    update, a load or a move to another device), where the JAX package
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
        self._cached: Optional[tuple] = None  # (weight key, QTensor, K-padded QTensor)

    def _quantized(self) -> tuple:
        w = self.weight
        key = (w.data_ptr(), w.device, w._version)
        if self._cached is None or self._cached[0] != key:
            with torch.no_grad():
                qt = quantize_per_channel(w.detach(), self.mode, axis=0)
                qt = QTensor(qt.data.contiguous(), qt.scale)
                padded = pad_weight(qt.data)
            self._cached = (key, qt, qt if padded is qt.data else QTensor(padded, qt.scale))
        return self._cached

    def quantized_weight(self) -> QTensor:
        """The quantized weight ``[out, in]`` (data and per-channel scale)."""
        return self._quantized()[1]

    def kernel_weight(self) -> QTensor:
        """The quantized weight with ``in`` zero-padded to a multiple of 16,
        as :func:`q_matmul` takes it (the same object when no pad is
        needed)."""
        return self._quantized()[2]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return q_matmul(x, self.kernel_weight(), self.bias, x.dtype)

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

