"""GShard MoE layer (counterpart of ``gigapath_tpu/ops/moe/moe_layer.py``):
gate -> dispatch einsum -> the experts -> combine einsum.

The experts live as one stacked FFN (:class:`StackedExperts`): each of
``fc1``, ``fc2`` (and the sub-LN ``ffn_layernorm``) holds one tensor with a
leading expert axis, ``experts.fc1.weight [E, ffn_dim, M]`` and so on, the
layout of the JAX package's vmapped ``experts`` (a flax kernel ``[E, in,
out]`` is the torch ``[E, out, in]``). It is the layout the stage rules
shard (``dist/stagemesh.py``: ``experts.`` on a leading ``expert`` axis)
and ``parallel/sharding.py:param_spec``'s expert rule, and
``parallel/tensor.py:shard_state_dict(..., axis="expert")`` cuts it for an
expert rank. The gate is ``gate.wg.weight [E, M]`` (xmoe:
``gate.wg_reduction.weight`` and ``gate.wg``), torchscale's names.

``forward(x, padding_mask)`` returns ``(out, l_aux)`` and keeps the gating
metadata on the layer (``self.metadata``, 0-d tensors of the last
forward) where ``utils/profiling.py`` and ``obs/telemetry.py:moe_scalars``
read it. Gating is in eval mode (the eval capacity) unless the module is
in training mode, where top-2's second-expert policy draws its noise.

With an ``expert_group`` of D ranks a rank holds E/D experts
(:mod:`~gigapath_tpu_torch.ops.moe.expert_parallel`): ``expert_parallel=
"gather"`` (every rank gates the same tokens; the single-device function)
or ``"all_to_all"`` (each rank gates its own tokens; ``l_aux`` averaged).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gigapath_tpu_torch.ops.feedforward import _activation
from gigapath_tpu_torch.ops.moe import expert_parallel as ep
from gigapath_tpu_torch.ops.moe.routing import Top1Gate, Top2Gate, second_expert_noise
from gigapath_tpu_torch.parallel.tensor import sharded_dropout

EXPERT_PARALLEL_MODES = ("gather", "all_to_all")


class _StackedLinear(nn.Module):
    """E linears in one tensor: ``weight [E, out, in]``, ``bias [E, out]``;
    ``[E, C, in] -> [E, C, out]``. Each expert's weight is xavier-uniform
    (the JAX package's init), biases zero."""

    def __init__(self, num_experts: int, in_features: int, out_features: int):
        super().__init__()
        bound = math.sqrt(6.0 / (in_features + out_features))
        self.weight = nn.Parameter(torch.empty(num_experts, out_features, in_features).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.zeros(num_experts, out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.baddbmm(self.bias[:, None, :], x, self.weight.transpose(1, 2))


class _StackedLayerNorm(nn.Module):
    """E LayerNorms over the last dim: ``weight``, ``bias`` ``[E, width]``."""

    def __init__(self, num_experts: int, width: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_experts, width))
        self.bias = nn.Parameter(torch.zeros(num_experts, width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], eps=self.eps) * self.weight[:, None, :] + self.bias[:, None, :]


class StackedExperts(nn.Module):
    """E copies of ``FeedForwardNetwork`` (fc1 -> activation -> [sub-LN] ->
    fc2, with activation and output dropout) on ``[E, C, M]``.

    With an ``expert_group`` the module holds this rank's E/D experts, and
    each dropout draws the mask of all E experts' rows and keeps this
    rank's (``sharded_dropout`` over dim 0): every expert gets its own mask,
    as on one device, where the ranks' generators hold one state."""

    def __init__(self, num_experts: int, embed_dim: int, ffn_dim: int, activation_fn: str = "gelu",
                 dropout: float = 0.0, activation_dropout: float = 0.0, layernorm_eps: float = 1e-5,
                 subln: bool = False, expert_group=None):
        super().__init__()
        self.act = _activation(activation_fn)
        self.fc1 = _StackedLinear(num_experts, embed_dim, ffn_dim)
        self.fc2 = _StackedLinear(num_experts, ffn_dim, embed_dim)
        self.activation_dropout, self.dropout = activation_dropout, dropout
        self.expert_group = expert_group
        self.ffn_layernorm = _StackedLayerNorm(num_experts, ffn_dim, layernorm_eps) if subln else None

    def _dropout(self, x: torch.Tensor, p: float) -> torch.Tensor:
        if self.expert_group is None:
            return F.dropout(x, p, self.training)
        return sharded_dropout(x, p, self.training, self.expert_group, dim=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self._dropout(self.act(self.fc1(x)), self.activation_dropout)
        if self.ffn_layernorm is not None:
            h = self.ffn_layernorm(h)
        return self._dropout(self.fc2(h), self.dropout)


class MOELayer(nn.Module):
    """Mixture-of-experts block over ``[B, L, M]`` tokens -> ``(out [B, L,
    M], l_aux)`` (fp32)."""

    def __init__(
        self,
        embed_dim: int,
        ffn_dim: int,
        num_experts: int,
        top1: bool = False,
        activation_fn: str = "gelu",
        dropout: float = 0.0,
        activation_dropout: float = 0.0,
        layernorm_eps: float = 1e-5,
        subln: bool = False,
        gating_use_fp32: bool = True,
        eval_capacity_token_fraction: float = 0.25,
        second_expert_policy: str = "random",
        normalize_gate_prob_before_dropping: bool = False,
        use_xmoe: bool = False,
        capacity_factor: float = 1.0,
        expert_group=None,
        expert_parallel: str = "gather",
    ):
        super().__init__()
        if expert_parallel not in EXPERT_PARALLEL_MODES:
            raise ValueError(f"expert_parallel must be one of {EXPERT_PARALLEL_MODES}, not {expert_parallel!r}")
        self.embed_dim, self.num_experts, self.top1 = embed_dim, num_experts, top1
        self.second_expert_policy = second_expert_policy
        self.expert_group = expert_group if ep.rank_and_world(expert_group)[1] > 1 else None
        self.expert_parallel = expert_parallel
        e0, e1 = ep.local_expert_range(num_experts, self.expert_group)
        if top1:
            self.gate = Top1Gate(embed_dim, num_experts, use_xmoe=use_xmoe, use_fp32=gating_use_fp32,
                                 capacity_factor=capacity_factor,
                                 eval_capacity_token_fraction=eval_capacity_token_fraction)
        else:
            self.gate = Top2Gate(embed_dim, num_experts, use_xmoe=use_xmoe, use_fp32=gating_use_fp32,
                                 second_expert_policy=second_expert_policy,
                                 normalize_gate_prob_before_dropping=normalize_gate_prob_before_dropping,
                                 eval_capacity_token_fraction=eval_capacity_token_fraction)
        self.experts = StackedExperts(e1 - e0, embed_dim, ffn_dim, activation_fn, dropout, activation_dropout,
                                      layernorm_eps, subln, expert_group=self.expert_group)
        self.metadata = {}

    @classmethod
    def from_config(cls, args, *, prefix: str = "encoder", expert_group=None,
                    expert_parallel: str = "gather") -> "MOELayer":
        """From a config (a layer's MoE hook): the widths of its ``prefix``
        side, ``"encoder"`` or ``"decoder"``."""
        return cls(
            embed_dim=getattr(args, f"{prefix}_embed_dim"),
            ffn_dim=getattr(args, f"{prefix}_ffn_embed_dim"),
            num_experts=args.moe_expert_count,
            top1=args.moe_top1_expert,
            activation_fn=args.activation_fn,
            dropout=args.dropout,
            activation_dropout=args.activation_dropout,
            layernorm_eps=args.layernorm_eps,
            subln=args.subln,
            gating_use_fp32=args.moe_gating_use_fp32,
            eval_capacity_token_fraction=args.moe_eval_capacity_token_fraction,
            second_expert_policy=args.moe_second_expert_policy,
            normalize_gate_prob_before_dropping=args.moe_normalize_gate_prob_before_dropping,
            use_xmoe=args.use_xmoe,
            expert_group=expert_group,
            expert_parallel=expert_parallel,
        )

    def _gate(self, tokens, pad, generator, noise):
        eval_mode = not self.training
        if self.top1:
            return self.gate(tokens, pad, eval_mode=eval_mode)
        if eval_mode or self.second_expert_policy not in ("sampling", "random"):
            return self.gate(tokens, pad, eval_mode=eval_mode)
        if noise is None:
            noise = second_expert_noise((tokens.shape[0], self.num_experts), self.second_expert_policy,
                                        generator, tokens.device)
        return self.gate(tokens, pad, noise=noise, eval_mode=False)

    def forward(
        self,
        x: torch.Tensor,
        input_padding_mask: Optional[torch.Tensor] = None,
        *,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``x [B, L, M]``, ``input_padding_mask [B, L]`` (True = pad). In
        training mode top-2's second expert draws ``noise`` (a tensor, e.g.
        the JAX package's draw) or from ``generator`` (default: torch's
        default generator of ``x``'s device)."""
        B, L, M = x.shape
        tokens = x.reshape(B * L, M)
        pad = input_padding_mask.reshape(B * L) if input_padding_mask is not None else None

        def gate_fn(t):
            return self._gate(t, pad, generator, noise)

        if self.expert_group is not None and self.expert_parallel == "all_to_all":
            out, l_aux, metadata = ep.moe_expert_parallel(gate_fn, self.experts, tokens, self.expert_group)
        else:
            l_aux, combine, dispatch, metadata = gate_fn(tokens)
            dispatched = torch.einsum("sec,sm->ecm", dispatch.to(tokens.dtype), tokens)
            if self.expert_group is None:
                expert_output = self.experts(dispatched)
            else:
                expert_output = ep.experts_gathered(dispatched, self.experts, self.expert_group)
            out = torch.einsum("sec,ecm->sm", combine.to(tokens.dtype), expert_output)
        self.metadata = {k: v.detach() for k, v in metadata.items()}
        return out.reshape(B, L, M), l_aux.float()
