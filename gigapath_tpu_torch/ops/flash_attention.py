"""Fused attention entry points returning ``(out, lse)`` (counterpart of
``gigapath_tpu/ops/flash_attention.py``).

:func:`flash_attention` runs the segment-flash kernel
(:func:`~gigapath_tpu_torch.ops.flash_kernels.cuda_flash_attention`) unless
the caller passes a ``bias``, which the kernel does not take: then the
plain :func:`~gigapath_tpu_torch.ops.attention.attention_with_lse` runs, as
in the JAX package. The JAX package also sends segments shorter than its
``PALLAS_MIN_SEQ`` (512) to XLA's fused dense attention, a TPU tuning; here
the kernel runs at every length, so no small case hides it. On a CPU
tensor the kernel's wrapper runs its plain version.
:func:`partial_attention` is the ring schedules' per-chunk entry, and
:func:`combine_partials` (kept in :mod:`~gigapath_tpu_torch.ops.attention`
beside the attention that emits the pair it merges) folds two partials.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gigapath_tpu_torch.ops import flash_kernels
from gigapath_tpu_torch.ops.attention import attention_with_lse, combine_partials

__all__ = ["flash_attention", "partial_attention", "combine_partials"]


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    is_causal: bool = False,
    bias: Optional[torch.Tensor] = None,
    kv_valid_len=None,
    use_pallas: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention on [B, L, H, D] returning ``(out [B, L, H, D], lse [B, H, L])``.

    ``kv_valid_len``: [B, H] valid-key counts (a tensor, which may live on
    the device, or an array-like). ``use_pallas`` keeps the JAX package's
    name for the choice of the kernel: None runs it whenever there is no
    ``bias``; True with a ``bias`` raises; False runs the plain
    ``attention_with_lse``. As in the JAX package, a causal mask with
    ``Lq != Lk`` aligns the starts on the kernel and the ends on the plain
    path.
    """
    if use_pallas is None:
        use_pallas = bias is None
    elif use_pallas and bias is not None:
        raise ValueError(
            "use_pallas=True is incompatible with a non-None bias: the kernel takes no bias; "
            "use use_pallas=False for biased attention"
        )
    if use_pallas:
        return flash_kernels.cuda_flash_attention(q, k, v, is_causal=is_causal, kv_len=kv_valid_len)
    return attention_with_lse(q, k, v, is_causal=is_causal, bias=bias, kv_valid_len=kv_valid_len)


def partial_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_valid_len=None,
    use_pallas: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention of ``q`` against one resident K/V chunk, returning the
    chunk-normalized ``(out [B, Lq, H, D], lse [B, H, Lq])`` that
    :func:`combine_partials` folds across chunks: :func:`flash_attention`
    without a causal mask (a ring step masks through ``kv_valid_len``)."""
    return flash_attention(q, k, v, is_causal=False, kv_valid_len=kv_valid_len, use_pallas=use_pallas)
