"""Attention with int8 Q/K logits, the '+attn' rider of the quantized tile
tier (counterpart of ``gigapath_tpu/quant/qflash.py``).

Q and K are quantized dynamically to int8 with one absmax scale per
(batch, head) (:func:`~.qtensor.quantize_dynamic`); both scales and the
softmax temperature fold into one multiply of the fp32 logits. V stays in
its dtype, the softmax statistics stay fp32, and the op returns the
``(out [B, L, H, D], lse [B, H, L])`` contract of every attention tier.

:func:`q_flash_attention_reference` is the plain version and the spec.
:func:`q_flash_attention` quantizes Q and K in torch (the JAX package does
so outside its ``pallas_call`` too) and launches
``csrc/q_flash_attention.cu`` on CUDA tensors; on CPU tensors it runs the
plain version. It counts its launches in :data:`LAUNCHES`. Inside the
source, bf16 v (the tile encoder's bf16 compute) runs on the tensor cores
(int8 MMA for Q.K^T, bf16 MMA for P.V) at head widths that are multiples
of 16, and fp32 v on the fp32 FMA pipes, since a tensor-core P.V in fp32
would be TF32, another function.

Dispatch differs from the JAX package's: its Pallas tier needs ``L % 128
== 0``, so the tile encoder's 197-token sequence (1 cls + 196 patches)
never reached the kernel on the TPU and took the jnp reference tier. The
CUDA kernel takes any L (it masks the partial last key tile) and computes
the same function as the reference tier, which is the spec both JAX tiers
meet, so on the card every sequence length runs the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from gigapath_tpu_torch.ops.common import check_cuda, cuda_stream, raise_on
from gigapath_tpu_torch.quant.qtensor import quantize_dynamic

LOG2E = 1.4426950408889634
MAX_HEAD_DIM = 128  # the kernel takes head widths that are multiples of 4 up to this

# Launches of the CUDA kernel in this process: the wrapper adds one where it
# launches it and nowhere else; callers reset and read it.
LAUNCHES = {"q_flash_attention": 0}


def reset_launch_counts() -> None:
    LAUNCHES["q_flash_attention"] = 0


def q_flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, L, H, D] q/k/v -> ``(out [B, L, H, D] in q's dtype, lse [B, H, L]
    fp32)``: int8 Q.K logits (exact integers in fp32) times ``sq*sk*scale``,
    a natural-log logsumexp, the probabilities cast to v's dtype, and the PV
    product summed in fp32."""
    B, L, H, D = q.shape
    if scale is None:
        scale = D**-0.5
    qq = quantize_dynamic(q.transpose(1, 2))
    kq = quantize_dynamic(k.transpose(1, 2))
    logits = torch.einsum("bhqd,bhkd->bhqk", qq.data.float(), kq.data.float())
    logits = logits * (qq.scale * kq.scale.reshape(B, H, 1, 1) * scale)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None]).to(v.dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype), lse


def _strides(t: torch.Tensor):
    """(batch, head, row) element strides of a [B, H, L, D] view."""
    return t.stride(0), t.stride(1), t.stride(2)


def q_flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The quantized attention: ``(out [B, L, H, D], lse [B, H, L])``
    (``csrc/q_flash_attention.cu`` on CUDA tensors, the plain version on
    CPU ones). Inputs may be strided views (the packed qkv's slices) as
    long as the head width is contiguous."""
    if q.device.type == "cpu":
        return q_flash_attention_reference(q, k, v, scale=scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("q_flash_attention: the quantized tier is inference-only on the card (no backward)")
    B, L, H, D = q.shape
    if scale is None:
        scale = D**-0.5
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q_flash_attention: q, k, v must share [B, L, H, D]; got {q.shape}, {k.shape}, {v.shape}")
    qq = quantize_dynamic(q.transpose(1, 2))
    kq = quantize_dynamic(k.transpose(1, 2))
    combined = (qq.scale * kq.scale * (scale * LOG2E)).reshape(B * H).contiguous()
    out = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    if _tensor_cores(v, D) and not _aligned16(v.transpose(1, 2)):
        v = v.contiguous()
    q_flash_kernel(qq.data, kq.data, v.transpose(1, 2), combined, out.transpose(1, 2), lse)
    return out, lse


def _tensor_cores(v: torch.Tensor, D: int) -> bool:
    """Whether the source's tensor-core kernel serves this call (bf16 v,
    a head width that is a multiple of 16)."""
    return v.dtype == torch.bfloat16 and D % 16 == 0


def _aligned16(t: torch.Tensor) -> bool:
    """A [B, H, L, D] view the tensor-core kernel copies in 16-byte pieces:
    the base and the batch, head and row strides on 16-byte boundaries."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(s * size % 16 == 0 for s in t.stride()[:3])


def q_flash_kernel(
    qq: torch.Tensor, kq: torch.Tensor, vh: torch.Tensor, combined: torch.Tensor,
    out_h: torch.Tensor, lse: torch.Tensor,
) -> None:
    """Launch ``csrc/q_flash_attention.cu`` on int8 ``qq``/``kq``, ``vh``
    (fp32 or bf16) and the output view ``out_h`` (fp32 or bf16), all [B, H,
    L, D] views with the head width contiguous; ``combined`` fp32 [B*H] is
    ``sq*sk*scale*log2(e)``; writes ``out_h`` and ``lse`` [B, H, L]."""
    from gigapath_tpu_torch.ops import _build

    B, H, L, D = qq.shape
    for name, t, dtypes in (("q", qq, (torch.int8,)), ("k", kq, (torch.int8,)),
                            ("v", vh, (torch.float32, torch.bfloat16)),
                            ("out", out_h, (torch.float32, torch.bfloat16))):
        if t.device.type != "cuda" or t.dtype not in dtypes:
            raise ValueError(f"q_flash_attention {name}: needs a CUDA tensor of {dtypes}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != (B, H, L, D) or t.stride(3) != 1 or t.device != qq.device:
            raise ValueError(f"q_flash_attention {name}: needs [B, H, L, D] = {(B, H, L, D)} with D contiguous")
    check_cuda("q_flash_attention scale", combined, (torch.float32,))
    check_cuda("q_flash_attention lse", lse, (torch.float32,))
    if D % 4 or D > MAX_HEAD_DIM or combined.numel() != B * H or lse.shape != (B, H, L):
        raise ValueError(f"q_flash_attention: needs D % 4 == 0 and D <= {MAX_HEAD_DIM}; got D={D}")
    if _tensor_cores(vh, D):
        pair = 2 * out_h.element_size()
        if not all(_aligned16(t) for t in (qq, kq, vh)) or out_h.data_ptr() % pair or any(
                s % 2 for s in out_h.stride()[:3]):
            raise ValueError("q_flash_attention: the tensor-core kernel needs q, k and v 16-byte aligned with "
                             "strides of whole 16-byte pieces, and out aligned to pairs of elements")
    if B * H == 0 or L == 0:
        return
    strides = (ctypes.c_longlong * 12)(*_strides(qq), *_strides(kq), *_strides(vh), *_strides(out_h))
    with torch.cuda.device(qq.device):
        rc = _build.library("q_flash_attention", GP_HEAD_DIM=D).gp_q_flash_attention(
            qq.data_ptr(), kq.data_ptr(), vh.data_ptr(), combined.data_ptr(), out_h.data_ptr(),
            lse.data_ptr(), int(vh.dtype == torch.bfloat16), int(out_h.dtype == torch.bfloat16),
            B * H, H, L, D, strides, cuda_stream(qq),
        )
    raise_on(rc, "q_flash_attention")
    LAUNCHES["q_flash_attention"] += 1
