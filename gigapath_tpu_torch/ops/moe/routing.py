"""GShard-style MoE gating, top-1 and top-2 (counterpart of
``gigapath_tpu/ops/moe/routing.py``).

The same semantics as the JAX package's: softmax gates, capacity ``cf *
ceil(S/E)`` (top-1) or ``2 * ceil(S/E)`` (top-2) with the eval-mode
token-fraction override, locations by a cumulative sum minus one over the
token axis, the balance loss ``l_aux = mean(me * ce) * E^2``, the xmoe
cosine router (a 16-wide reduction against L2-normalised expert
embeddings) and the gating metadata (entropy, unused experts, balance
top / bottom fractions, overflow).

The stochastic second-expert policies of top-2 take their noise as a
tensor (``noise``: a Gumbel sample ``[S, E]`` for ``"sampling"``, a uniform
``[S]`` one for ``"random"``) or draw it from an explicit
``torch.Generator``; with neither, both policies keep their noise-free
core, as the JAX function does with ``rng=None``. A padded token
(``input_mask`` True) claims no capacity.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# fixed constants, as the JAX package's (reference routing.py:25-33)
EVAL_CAPACITY_TOKEN_FRACTION = 0.25
SAMPLE_FRACTION = 0.2

GatingResult = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]


def _entropy(probs: torch.Tensor) -> torch.Tensor:
    return -(probs * torch.log(probs.clamp_min(1e-9))).sum(-1)


def _balance_metadata(indices_s: torch.Tensor, num_experts: int, num_tokens: int,
                      prefix: str) -> Dict[str, torch.Tensor]:
    """Percent-of-tokens-per-expert histogram statistics."""
    hist = 100.0 * torch.bincount(indices_s, minlength=num_experts).float() / num_tokens
    sample_count = max(math.ceil(num_experts * SAMPLE_FRACTION), 1)
    hist_sorted = torch.sort(hist, descending=True).values + torch.finfo(torch.float32).tiny
    return {
        f"unused_{prefix}_count": (hist == 0).sum(),
        f"{prefix}_balance_top": hist_sorted[:sample_count].sum(),
        f"{prefix}_balance_bottom": hist_sorted[-sample_count:].sum(),
    }


def _capacity(num_tokens: int, num_experts: int, *, capacity_factor: float, eval_mode: bool,
              eval_capacity_token_fraction: float) -> int:
    if eval_capacity_token_fraction > 0.0 and eval_mode:
        return math.ceil(eval_capacity_token_fraction * num_tokens)
    return int(capacity_factor * math.ceil(num_tokens / num_experts))


def _combine(gates_s, masks, locations_s, capacity: int, dtype) -> torch.Tensor:
    """``sum_k einsum("se,sc->sec", gates_k[:, None] * mask_k,
    one_hot(location_k, C))``."""
    combine = None
    for g_s, mask, loc_s in zip(gates_s, masks, locations_s):
        term = torch.einsum("se,sc->sec", g_s[:, None] * mask, F.one_hot(loc_s, capacity).to(dtype))
        combine = term if combine is None else combine + term
    return combine


def top1_gating(
    logits: torch.Tensor,
    input_mask: Optional[torch.Tensor] = None,
    *,
    use_fp32: bool = True,
    capacity_factor: float = 1.0,
    eval_mode: bool = False,
    eval_capacity_token_fraction: float = EVAL_CAPACITY_TOKEN_FRACTION,
) -> GatingResult:
    """Top-1 gating on ``logits [S, E]`` -> ``(l_aux, combine_weights [S, E,
    C], dispatch_mask [S, E, C], metadata)``."""
    orig_dtype = logits.dtype
    if use_fp32:
        logits = logits.float()
    gates = torch.softmax(logits, dim=-1)
    num_tokens, num_experts = gates.shape
    capacity = _capacity(num_tokens, num_experts, capacity_factor=capacity_factor, eval_mode=eval_mode,
                         eval_capacity_token_fraction=eval_capacity_token_fraction)

    indices1_s = torch.argmax(gates, dim=-1)
    mask1 = F.one_hot(indices1_s, num_experts).to(gates.dtype)
    if input_mask is not None:
        mask1 = mask1 * (~input_mask.to(torch.bool))[:, None].to(mask1.dtype)

    metadata = {"entropy_gating": _entropy(gates).mean()}
    metadata.update(_balance_metadata(indices1_s, num_experts, num_tokens, "expert1"))

    gates1_s = (gates * mask1).sum(dim=-1)
    locations1 = torch.cumsum(mask1, dim=0) - 1

    # balance loss (fraction routed x mean gate, scaled E^2)
    me = gates.mean(dim=0)
    ce = mask1.mean(dim=0)
    l_aux = (me * ce).mean() * num_experts * num_experts

    mask1 = mask1 * (locations1 < capacity)
    locations1_s = (locations1 * mask1).sum(dim=-1).long()
    combine = _combine([gates1_s], [mask1], [locations1_s], capacity, gates.dtype)
    dispatch = combine > 0
    if use_fp32:
        combine = combine.to(orig_dtype)
    return l_aux, combine, dispatch, metadata


def second_expert_noise(shape_se: Tuple[int, int], policy: str, generator: Optional[torch.Generator],
                        device=None) -> torch.Tensor:
    """The noise of top-2's second-expert policy from ``generator`` (None:
    torch's default generator of ``device``): a
    standard Gumbel sample ``[S, E]`` (``"sampling"``) or a uniform ``[S]``
    one (``"random"``)."""
    if policy == "sampling":
        u = torch.rand(shape_se, generator=generator, device=device)
        tiny = torch.finfo(torch.float32).tiny
        return -torch.log(-torch.log(u.clamp(tiny, 1.0)).clamp_min(tiny))
    return torch.rand(shape_se[:1], generator=generator, device=device)


def top2_gating(
    logits: torch.Tensor,
    input_mask: Optional[torch.Tensor] = None,
    *,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    use_fp32: bool = True,
    second_expert_policy: str = "sampling",
    normalize_gate_prob_before_dropping: bool = False,
    eval_mode: bool = False,
    eval_capacity_token_fraction: float = EVAL_CAPACITY_TOKEN_FRACTION,
    batch_prioritized_routing: bool = False,
) -> GatingResult:
    """Top-2 gating on ``logits [S, E]``. The second expert's policy draws
    ``noise`` (or, if it is None, draws it from ``generator``;
    :func:`second_expert_noise`): ``"sampling"`` adds the Gumbel noise to
    the logits before the second argmax, ``"random"`` keeps the second
    expert where ``2 * gate2 > noise``. With neither, no noise (the JAX
    function's ``rng=None``)."""
    orig_dtype = logits.dtype
    if use_fp32:
        logits = logits.float()
    gates = torch.softmax(logits, dim=-1)
    num_tokens, num_experts = gates.shape
    if eval_capacity_token_fraction > 0.0 and eval_mode:
        capacity = math.ceil(eval_capacity_token_fraction * num_tokens)
    else:
        capacity = 2 * math.ceil(num_tokens / num_experts)
    if noise is None and generator is not None and second_expert_policy in ("sampling", "random"):
        noise = second_expert_noise((num_tokens, num_experts), second_expert_policy, generator, logits.device)

    indices1_s = torch.argmax(gates, dim=-1)
    mask1 = F.one_hot(indices1_s, num_experts).to(gates.dtype)

    if second_expert_policy == "sampling" and noise is not None:
        logits_w_noise = logits + noise.to(logits.dtype)
    else:
        logits_w_noise = logits
    logits_except1 = logits_w_noise.masked_fill(mask1 > 0, float("-inf"))
    indices2_s = torch.argmax(logits_except1, dim=-1)
    mask2 = F.one_hot(indices2_s, num_experts).to(gates.dtype)

    gates1_s = (gates * mask1).sum(dim=-1)
    gates2_s = (gates * mask2).sum(dim=-1)
    eps = torch.finfo(gates.dtype).eps

    if normalize_gate_prob_before_dropping:
        denom_s = (gates1_s + gates2_s).clamp_min(eps)
        gates1_s = gates1_s / denom_s
        gates2_s = gates2_s / denom_s

    if second_expert_policy == "random" and noise is not None:
        sampled = (2 * gates2_s) > noise.to(gates2_s.dtype)
        mask2 = mask2 * sampled[:, None].to(mask2.dtype)

    if input_mask is not None:
        nonpad = (~input_mask.to(torch.bool))[:, None].to(mask1.dtype)
        mask1 = mask1 * nonpad
        mask2 = mask2 * nonpad

    if batch_prioritized_routing:
        # capacity assigned in order of gate confidence (a stable sort)
        importance = -gates.max(dim=-1).values
        order = torch.argsort(importance, dim=0, stable=True)
        inverse = torch.argsort(order, dim=0, stable=True)
        sorted_mask1 = mask1[order]
        locations1 = ((torch.cumsum(sorted_mask1, dim=0) - 1) * sorted_mask1)[inverse]
        sorted_mask2 = mask2[order]
        locations2 = ((torch.cumsum(sorted_mask2, dim=0) - 1) * sorted_mask2)[inverse]
        locations2 = locations2 + mask1.sum(dim=0, keepdim=True)
    else:
        locations1 = torch.cumsum(mask1, dim=0) - 1
        locations2 = torch.cumsum(mask2, dim=0) - 1
        locations2 = locations2 + mask1.sum(dim=0, keepdim=True)

    me = gates.mean(dim=0)
    ce = mask1.mean(dim=0)
    l_aux = (me * ce).mean() * num_experts * num_experts

    metadata = {
        "entropy_gating": _entropy(gates).mean(),
        "overflow_expert1": 100.0 * (mask1 * (locations1 >= capacity)).sum() / mask1.sum().clamp_min(1.0),
        "overflow_expert2": 100.0 * (mask2 * (locations2 >= capacity)).sum() / mask2.sum().clamp_min(1.0),
    }
    metadata.update(_balance_metadata(indices1_s, num_experts, num_tokens, "expert1"))
    metadata.update(_balance_metadata(indices2_s, num_experts, num_tokens, "expert2"))

    mask1 = mask1 * (locations1 < capacity)
    mask2 = mask2 * (locations2 < capacity)
    locations1_s = (locations1 * mask1).sum(dim=-1).long()
    locations2_s = (locations2 * mask2).sum(dim=-1).long()

    if not normalize_gate_prob_before_dropping:
        gates1_s = (gates * mask1).sum(dim=-1)
        gates2_s = (gates * mask2).sum(dim=-1)
        denom_s = (gates1_s + gates2_s).clamp_min(eps)
        gates1_s = gates1_s / denom_s
        gates2_s = gates2_s / denom_s

    combine = _combine([gates1_s, gates2_s], [mask1, mask2], [locations1_s, locations2_s], capacity,
                       gates.dtype)
    dispatch = combine > 0
    if use_fp32:
        combine = combine.to(orig_dtype)
    return l_aux, combine, dispatch, metadata


class _GateBase(nn.Module):
    """The router projection: a bias-free ``wg`` linear, or (``use_xmoe``)
    the cosine router: ``wg_reduction`` to 16 wide against the L2-normalised
    expert embeddings ``wg`` ``[E, 16]`` (torchscale's names)."""

    def __init__(self, model_dim: int, num_experts: int, use_xmoe: bool = False):
        super().__init__()
        self.num_experts = num_experts
        self.use_xmoe = use_xmoe
        if use_xmoe:
            self.wg_reduction = nn.Linear(model_dim, 16, bias=False)
            wg = torch.empty(num_experts, 16)
            nn.init.orthogonal_(wg, gain=0.32)
            self.wg = nn.Parameter(wg)
        else:
            self.wg = nn.Linear(model_dim, num_experts, bias=False)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        if not self.use_xmoe:
            return self.wg(x)
        reduced = self.wg_reduction(x)
        wg = self.wg / self.wg.norm(dim=-1, keepdim=True).clamp_min(1e-4)
        logits = reduced.float() @ wg.float().T
        logits = torch.where(torch.isfinite(logits), logits, torch.finfo(torch.float32).min)
        return logits.to(reduced.dtype)


class Top1Gate(_GateBase):
    """Top-1 gate (reference ``Top1Gate``)."""

    def __init__(self, model_dim: int, num_experts: int, use_xmoe: bool = False, use_fp32: bool = True,
                 capacity_factor: float = 1.0,
                 eval_capacity_token_fraction: float = EVAL_CAPACITY_TOKEN_FRACTION):
        super().__init__(model_dim, num_experts, use_xmoe)
        self.use_fp32 = use_fp32
        self.capacity_factor = capacity_factor
        self.eval_capacity_token_fraction = eval_capacity_token_fraction

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, *,
                eval_mode: bool = True) -> GatingResult:
        return top1_gating(self._logits(x), mask, use_fp32=self.use_fp32, capacity_factor=self.capacity_factor,
                           eval_mode=eval_mode, eval_capacity_token_fraction=self.eval_capacity_token_fraction)


class Top2Gate(_GateBase):
    """Top-2 gate (reference ``Top2Gate``)."""

    def __init__(self, model_dim: int, num_experts: int, use_xmoe: bool = False, use_fp32: bool = True,
                 second_expert_policy: str = "sampling", normalize_gate_prob_before_dropping: bool = False,
                 eval_capacity_token_fraction: float = EVAL_CAPACITY_TOKEN_FRACTION,
                 batch_prioritized_routing: bool = False):
        super().__init__(model_dim, num_experts, use_xmoe)
        self.use_fp32 = use_fp32
        self.second_expert_policy = second_expert_policy
        self.normalize_gate_prob_before_dropping = normalize_gate_prob_before_dropping
        self.eval_capacity_token_fraction = eval_capacity_token_fraction
        self.batch_prioritized_routing = batch_prioritized_routing

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, *,
                noise: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
                eval_mode: bool = True) -> GatingResult:
        return top2_gating(
            self._logits(x), mask, noise=noise, generator=generator, use_fp32=self.use_fp32,
            second_expert_policy=self.second_expert_policy,
            normalize_gate_prob_before_dropping=self.normalize_gate_prob_before_dropping,
            eval_mode=eval_mode, eval_capacity_token_fraction=self.eval_capacity_token_fraction,
            batch_prioritized_routing=self.batch_prioritized_routing,
        )
