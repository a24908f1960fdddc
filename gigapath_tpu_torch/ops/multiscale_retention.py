"""Multi-scale retention (RetNet) in its parallel, chunkwise and recurrent
forms (counterpart of ``gigapath_tpu/ops/multiscale_retention.py``).

The xPos-like theta rotation of q and k, a per-head exponential decay, the
head-wise RMS group norm (no affine), the swish output gate, and the
stability normalisations (row abs-sum clamps with detached denominators).
:func:`retnet_rel_pos` makes each form's constants with torch on the
caller's device (the JAX package folds its numpy constants into the
compiled program). The recurrent state rides an explicit
``incremental_state`` dict (``prev_key_value [B, H, Dk, Dv]``, ``scale
[H]``), and the chunkwise cross-chunk accumulation is a loop over the
chunks (the JAX package's ``lax.scan``).

After the rotation the retention computes in fp32 (the constants are fp32,
and the JAX package's promotion makes q and k fp32 there); the gated
output is cast back to the input's dtype before ``out_proj``. Key names
are torchscale's (``q_proj``, ``k_proj``, ``v_proj``, ``g_proj``,
``out_proj``, ``group_norm``). The JAX package computes retention outside
any Pallas kernel, so it is plain PyTorch here too.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gigapath_tpu_torch.ops.norms import RMSNorm


def rotate_every_two(x: torch.Tensor) -> torch.Tensor:
    x1 = x[..., ::2]
    x2 = x[..., 1::2]
    return torch.stack((-x2, x1), dim=-1).reshape(x.shape)


def theta_shift(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    return x * cos + rotate_every_two(x) * sin


def retnet_angle_decay(embed_dim: int, num_heads: int) -> Tuple[np.ndarray, np.ndarray]:
    """(angle [Dk], decay [H]) constants (torchscale's ``RetNetRelPos``)."""
    key_dim = embed_dim // num_heads
    angle = 1.0 / (10000 ** np.linspace(0, 1, key_dim // 2))
    angle = np.repeat(angle, 2)
    decay = np.log(1 - 2.0 ** (-5 - np.arange(num_heads, dtype=np.float64)))
    return angle.astype(np.float32), decay.astype(np.float32)


def retnet_rel_pos(
    slen: int,
    embed_dim: int,
    num_heads: int,
    *,
    activate_recurrent: bool = False,
    chunkwise_recurrent: bool = False,
    recurrent_chunk_size: int = 512,
    device=None,
):
    """``((sin, cos), inner)`` of one form, fp32 tensors on ``device``:
    ``inner`` is the recurrent decay ``[H]``, the chunkwise
    ``(inner_mask, cross_decay, query_inner_decay, value_inner_decay)`` or
    the parallel decay mask ``[H, T, T]``. In the recurrent form ``slen`` is
    the 1-based position of the step. The tables are made by torch on
    ``device`` from the fp32 angle and decay, in float64 wherever the JAX
    package's numpy promotes them to float64, then cast to fp32 as there;
    the fp32 vectors come from numpy, as there."""
    angle, decay = retnet_angle_decay(embed_dim, num_heads)
    if activate_recurrent:
        # [Dk] and [H] vectors in numpy's fp32 on the host, the JAX package's own
        sin, cos = np.sin(angle * (slen - 1)), np.cos(angle * (slen - 1))
        return (_on(sin, device), _on(cos, device)), _on(np.exp(decay), device)
    angle64, decay64 = (torch.as_tensor(a, dtype=torch.float64, device=device) for a in (angle, decay))
    index = torch.arange(slen, dtype=torch.float64, device=device)
    sin = torch.sin(index[:, None] * angle64).float()
    cos = torch.cos(index[:, None] * angle64).float()
    if chunkwise_recurrent:
        C = recurrent_chunk_size
        mask = _decay_mask(C, decay64)  # [H, C, C]
        last = mask[:, -1]
        value_inner_decay = (last / last.sum(-1, keepdim=True))[:, :, None]
        scale = mask.sum(-1, keepdim=True).sqrt()
        inner_mask = mask / scale
        block = torch.arange(C, dtype=torch.float64, device=device)
        query_inner_decay = torch.exp(decay64[:, None] * (block + 1))[:, :, None]
        query_inner_decay = query_inner_decay / (scale / last.sum(-1)[:, None, None])
        cross_decay = _on(np.exp(decay * C)[:, None, None], device)  # [H, 1, 1] in fp32, as numpy's
        return (sin, cos), (inner_mask.float(), cross_decay, query_inner_decay.float(), value_inner_decay.float())
    mask = _decay_mask(slen, decay64)  # [H, T, T]
    return (sin, cos), (mask / mask.sum(-1, keepdim=True).sqrt()).float()


def _on(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


def _decay_mask(n: int, decay: torch.Tensor) -> torch.Tensor:
    """[H, n, n]: ``exp((t - s) * decay[h])`` where ``s <= t``, else 0."""
    index = torch.arange(n, dtype=decay.dtype, device=decay.device)
    diff = index[:, None] - index[None, :]
    return torch.where(diff >= 0, torch.exp(diff[None] * decay[:, None, None]), 0.0)


class MultiScaleRetention(nn.Module):
    """Retention over ``[B, T, E]``; call with the matching ``rel_pos`` of
    :func:`retnet_rel_pos`. ``incremental_state`` (a dict, empty before the
    first step) runs the recurrent form, one token a call."""

    def __init__(self, embed_dim: int, value_dim: int, num_heads: int, gate_fn: str = "swish",
                 layernorm_eps: float = 1e-6):
        super().__init__()
        if embed_dim % num_heads or value_dim % num_heads:
            # the JAX package fails alike, reshaping v to [B, T, H, value_dim // H]
            raise ValueError(f"embed_dim {embed_dim} and value_dim {value_dim} must divide into {num_heads} heads")
        self.embed_dim = embed_dim
        self.value_dim = value_dim
        self.num_heads = num_heads
        self.key_dim = embed_dim // num_heads
        self.head_dim = value_dim // num_heads
        self.gate_fn = gate_fn
        self.q_proj = nn.Linear(embed_dim, embed_dim, bias=False)
        self.k_proj = nn.Linear(embed_dim, embed_dim, bias=False)
        self.v_proj = nn.Linear(embed_dim, value_dim, bias=False)
        self.g_proj = nn.Linear(embed_dim, value_dim, bias=False)
        self.out_proj = nn.Linear(value_dim, embed_dim, bias=False)
        self.group_norm = RMSNorm(self.head_dim, eps=layernorm_eps, elementwise_affine=False)
        self.reset_parameters()

    def reset_parameters(self) -> None:
        for proj in (self.q_proj, self.k_proj, self.v_proj, self.g_proj):
            nn.init.xavier_uniform_(proj.weight, gain=2**-2.5)
        nn.init.xavier_uniform_(self.out_proj.weight, gain=2**-1)

    def _parallel(self, qr, kr, v, mask):
        B, T, _ = v.shape
        vr = v.reshape(B, T, self.num_heads, self.head_dim).transpose(1, 2).float()
        qk = torch.einsum("bhtd,bhsd->bhts", qr, kr) * mask
        denom = qk.detach().abs().sum(-1, keepdim=True).clamp(1.0, 5e4)
        return torch.einsum("bhts,bhsd->bhtd", qk / denom, vr).transpose(1, 2)  # [B, T, H, Dv]

    def _chunkwise(self, qr, kr, v, inner):
        mask, cross_decay, query_inner_decay, value_inner_decay = inner
        B, T, _ = v.shape
        H, Dk, Dv = self.num_heads, self.key_dim, self.head_dim
        C = mask.shape[1]
        if T % C:
            raise ValueError(f"chunkwise retention needs the length {T} to be a multiple of the chunk {C}")
        N = T // C
        qr = qr.reshape(B, H, N, C, Dk).transpose(1, 2)  # [B, N, H, C, Dk]
        kr = kr.reshape(B, H, N, C, Dk).transpose(1, 2)
        vr = v.reshape(B, N, C, H, Dv).transpose(2, 3).float()  # [B, N, H, C, Dv]
        qk = torch.einsum("bnhtd,bnhsd->bnhts", qr, kr) * mask
        inner_scale = qk.detach().abs().sum(-1, keepdim=True).clamp(min=1.0)
        inner_output = torch.einsum("bnhts,bnhsd->bnhtd", qk / inner_scale, vr)
        kv = torch.einsum("bnhsd,bnhsv->bnhdv", kr, vr * value_inner_decay)  # each chunk's summary
        # the state entering each chunk, threaded through the chunks
        kv_state = torch.zeros(B, H, Dk, Dv, dtype=kv.dtype, device=kv.device)
        kv_scale = torch.ones(B, H, 1, 1, dtype=kv.dtype, device=kv.device)
        states, scales = [], []
        for n in range(N):
            states.append(kv_state / kv_scale)
            scales.append(kv_scale)
            kv_state = kv_state * cross_decay + kv[:, n]
            kv_scale = kv_state.detach().abs().sum(-2, keepdim=True).amax(-1, keepdim=True).clamp(min=1.0)
        kv_recurrent = torch.stack(states, 1)  # [B, N, H, Dk, Dv]
        cross_scale = torch.stack(scales, 1)  # [B, N, H, 1, 1]
        all_scale = torch.maximum(inner_scale, cross_scale)
        cross_output = torch.einsum("bnhtd,bnhdv->bnhtv", qr * query_inner_decay, kv_recurrent)
        output = inner_output / (all_scale / inner_scale) + cross_output / (all_scale / cross_scale)
        return output.transpose(2, 3).reshape(B, T, H, Dv)

    def _recurrent(self, qr, kr, v, decay, state: Dict[str, Any]):
        """One step against ``state``: the decayed, renormalised sum of the
        earlier steps' ``k v^T`` (torchscale's ``recurrent_forward``); an
        empty state is zeros, so the first step's scale is 1."""
        B = v.shape[0]
        H, Dk, Dv = self.num_heads, self.key_dim, self.head_dim
        kv = torch.einsum("bhd,bhv->bhdv", kr[:, :, 0, :], v.reshape(B, H, Dv).float())
        prev_kv = state.get("prev_key_value")
        prev_scale = state.get("scale")
        if prev_kv is None:
            prev_kv = torch.zeros(B, H, Dk, Dv, dtype=kv.dtype, device=kv.device)
            prev_scale = torch.zeros(H, dtype=torch.float32, device=kv.device)
        scale = prev_scale * decay + 1
        kv = prev_kv * (prev_scale.sqrt() * decay / scale.sqrt()).reshape(1, H, 1, 1) + kv / scale.sqrt().reshape(
            1, H, 1, 1)
        state.update(prev_key_value=kv, scale=scale)
        out = torch.einsum("bhd,bhdv->bhv", qr[:, :, 0, :], kv)
        return out.reshape(B, 1, H, Dv)

    def forward(self, x: torch.Tensor, rel_pos, chunkwise_recurrent: bool = False,
                incremental_state: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        B, T, _ = x.shape
        (sin, cos), inner = rel_pos
        q = self.q_proj(x)
        k = self.k_proj(x) * (self.key_dim**-0.5)
        v = self.v_proj(x)
        g = self.g_proj(x)
        q = q.reshape(B, T, self.num_heads, self.key_dim).transpose(1, 2)
        k = k.reshape(B, T, self.num_heads, self.key_dim).transpose(1, 2)
        qr = theta_shift(q, sin, cos)
        kr = theta_shift(k, sin, cos)
        if incremental_state is not None:
            output = self._recurrent(qr, kr, v, inner, incremental_state)
        elif chunkwise_recurrent:
            output = self._chunkwise(qr, kr, v, inner)
        else:
            output = self._parallel(qr, kr, v, inner)
        output = self.group_norm(output).reshape(B, T, self.value_dim)
        act = F.silu if self.gate_fn == "swish" else (lambda t: F.gelu(t, approximate="tanh"))
        output = act(g) * output
        return self.out_proj(output.to(x.dtype))
