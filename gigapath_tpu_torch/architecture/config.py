"""Encoder config (counterpart of ``gigapath_tpu/architecture/config.py``).

The fields the slide encoder reads and the MoE fields, with the same
``postprocessing()`` invariants (deepnorm and sub-LN exclusive, sub-LN
forces pre-LN, xmoe forces normalised gates and the random second-expert
policy) and the
same safe parsing of stringified schedules (``ast.literal_eval``, never
``eval``). Unknown keys from a registry dict land in ``extras``.
"""

from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

IntList = Union[None, str, List[int]]


def _parse_int_list(value: IntList) -> Optional[List[int]]:
    if value is None or value == "":
        return None
    parsed = ast.literal_eval(value) if isinstance(value, str) else value
    return [int(x) for x in parsed]


@dataclass
class EncoderConfig:
    encoder_embed_dim: int = 768
    encoder_attention_heads: int = 12
    encoder_ffn_embed_dim: int = 3072
    encoder_layers: int = 12
    encoder_normalize_before: bool = True
    normalize_output: bool = True
    activation_fn: str = "gelu"
    dropout: float = 0.0
    drop_path_rate: float = 0.0
    attention_dropout: float = 0.0
    activation_dropout: float = 0.0
    no_scale_embedding: bool = True
    layernorm_embedding: bool = False
    deepnorm: bool = False
    subln: bool = True
    layernorm_eps: float = 1e-5
    segment_length: IntList = None
    dilated_ratio: IntList = None
    checkpoint_activations: bool = False
    # sequence parallelism: the encoder's DilatedAttention layers shard the
    # tokens over the process group in ``extras["seq_group"]``
    seq_parallel: bool = False
    # mixture of experts: layer i is an MoE layer when moe_freq divides i + 1
    moe_freq: int = 0
    moe_top1_expert: bool = False
    moe_expert_count: int = 0
    moe_gating_use_fp32: bool = True
    moe_eval_capacity_token_fraction: float = 0.25
    moe_second_expert_policy: str = "random"
    moe_normalize_gate_prob_before_dropping: bool = False
    use_xmoe: bool = False
    extras: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        self.postprocessing()

    def postprocessing(self) -> None:
        self.segment_length = _parse_int_list(self.segment_length)
        self.dilated_ratio = _parse_int_list(self.dilated_ratio)
        if self.deepnorm:
            self.subln = False
            self.encoder_normalize_before = False
        if self.subln:
            self.deepnorm = False
            self.encoder_normalize_before = True
        if self.use_xmoe:
            self.moe_normalize_gate_prob_before_dropping = True
            self.moe_second_expert_policy = "random"
            if not (self.moe_freq > 0 and self.moe_expert_count > 0):
                raise ValueError("use_xmoe needs moe_freq > 0 and moe_expert_count > 0")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "EncoderConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        cfg = cls(**{k: v for k, v in d.items() if k in names})
        cfg.extras.update({k: v for k, v in d.items() if k not in names})
        return cfg
