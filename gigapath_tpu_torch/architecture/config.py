"""Architecture configs (counterpart of ``gigapath_tpu/architecture/config.py``):
:class:`EncoderConfig`, :class:`DecoderConfig`, :class:`EncoderDecoderConfig`
and :class:`RetNetConfig`.

The JAX package's fields that the port reads (the MoE fields shared by
all four; a registry dict's other keys land in ``extras``) and its
``postprocessing()`` invariants: deepnorm and sub-LN exclusive, sub-LN
forcing pre-LN (``*_normalize_before``), deepnorm post-LN, xmoe forcing
normalised gates and the random second-expert policy; and the same safe
parsing of stringified schedules (``ast.literal_eval``, never ``eval``).
Process groups ride in ``extras`` too (``seq_group``, ``model_group``,
``expert_group``).
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


def _flip_norms(cfg) -> None:
    """deepnorm turns sub-LN off and puts the norms after the blocks;
    sub-LN turns deepnorm off and puts them before."""
    def normalize_before(value: bool) -> None:
        for name in ("encoder_normalize_before", "decoder_normalize_before"):
            if hasattr(cfg, name):
                setattr(cfg, name, value)

    if cfg.deepnorm:
        cfg.subln = False
        normalize_before(False)
    if cfg.subln:
        cfg.deepnorm = False
        normalize_before(True)


def _xmoe(cfg) -> None:
    if cfg.use_xmoe:
        cfg.moe_normalize_gate_prob_before_dropping = True
        cfg.moe_second_expert_policy = "random"
        if not (cfg.moe_freq > 0 and cfg.moe_expert_count > 0):
            raise ValueError("use_xmoe needs moe_freq > 0 and moe_expert_count > 0")


@dataclass
class _MoEFields:
    moe_freq: int = 0
    moe_top1_expert: bool = False
    moe_expert_count: int = 0
    moe_gating_use_fp32: bool = True
    moe_eval_capacity_token_fraction: float = 0.25
    moe_second_expert_policy: str = "random"
    moe_normalize_gate_prob_before_dropping: bool = False
    use_xmoe: bool = False


class _ConfigBase:
    def __post_init__(self):
        self.postprocessing()

    def postprocessing(self) -> None:
        self.segment_length = _parse_int_list(self.segment_length)
        self.dilated_ratio = _parse_int_list(self.dilated_ratio)
        _flip_norms(self)
        _xmoe(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]):
        names = {f.name for f in dataclasses.fields(cls)}
        cfg = cls(**{k: v for k, v in d.items() if k in names})
        cfg.extras.update({k: v for k, v in d.items() if k not in names})
        return cfg


@dataclass
class EncoderConfig(_ConfigBase, _MoEFields):
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
    rel_pos_buckets: int = 0
    max_rel_pos: int = 0
    deepnorm: bool = False
    subln: bool = True
    multiway: bool = False
    share_encoder_input_output_embed: bool = False
    max_source_positions: int = 1024
    no_output_layer: bool = False
    layernorm_eps: float = 1e-5
    vocab_size: int = -1
    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    checkpoint_activations: bool = False
    xpos_rel_pos: bool = False
    xpos_scale_base: int = 512
    segment_length: IntList = None
    dilated_ratio: IntList = None
    # sequence parallelism: the encoder's DilatedAttention layers shard the
    # tokens over the process group in ``extras["seq_group"]``
    seq_parallel: bool = False
    extras: Dict[str, Any] = field(default_factory=dict)


@dataclass
class DecoderConfig(_ConfigBase, _MoEFields):
    decoder_embed_dim: int = 768
    decoder_attention_heads: int = 12
    decoder_ffn_embed_dim: int = 3072
    decoder_layers: int = 12
    decoder_normalize_before: bool = True
    activation_fn: str = "gelu"
    dropout: float = 0.0
    drop_path_rate: float = 0.0
    attention_dropout: float = 0.0
    activation_dropout: float = 0.0
    no_scale_embedding: bool = True
    layernorm_embedding: bool = False
    rel_pos_buckets: int = 0
    max_rel_pos: int = 0
    deepnorm: bool = False
    subln: bool = True
    share_decoder_input_output_embed: bool = False
    no_output_layer: bool = False
    layernorm_eps: float = 1e-5
    vocab_size: int = -1
    checkpoint_activations: bool = False
    xpos_rel_pos: bool = False
    xpos_scale_base: int = 512
    segment_length: IntList = None
    dilated_ratio: IntList = None
    seq_parallel: bool = False
    extras: Dict[str, Any] = field(default_factory=dict)


@dataclass
class EncoderDecoderConfig(_ConfigBase, _MoEFields):
    encoder_embed_dim: int = 768
    encoder_attention_heads: int = 12
    encoder_ffn_embed_dim: int = 3072
    encoder_layers: int = 12
    encoder_normalize_before: bool = True
    normalize_output: bool = True
    decoder_embed_dim: int = 768
    decoder_attention_heads: int = 12
    decoder_ffn_embed_dim: int = 3072
    decoder_layers: int = 12
    decoder_normalize_before: bool = True
    activation_fn: str = "gelu"
    dropout: float = 0.0
    drop_path_rate: float = 0.0
    attention_dropout: float = 0.0
    activation_dropout: float = 0.0
    no_scale_embedding: bool = True
    layernorm_embedding: bool = False
    rel_pos_buckets: int = 0
    max_rel_pos: int = 0
    deepnorm: bool = False
    subln: bool = True
    multiway: bool = False
    share_all_embeddings: bool = False
    share_decoder_input_output_embed: bool = False
    max_source_positions: int = 1024
    no_output_layer: bool = False
    layernorm_eps: float = 1e-5
    vocab_size: int = -1
    checkpoint_activations: bool = False
    xpos_rel_pos: bool = False
    xpos_scale_base: int = 512
    segment_length: IntList = None
    dilated_ratio: IntList = None
    seq_parallel: bool = False
    extras: Dict[str, Any] = field(default_factory=dict)


@dataclass
class RetNetConfig(_ConfigBase, _MoEFields):
    decoder_embed_dim: int = 768
    decoder_value_embed_dim: int = 1280
    decoder_retention_heads: int = 3
    decoder_ffn_embed_dim: int = 1280
    decoder_layers: int = 12
    decoder_normalize_before: bool = True
    activation_fn: str = "gelu"
    dropout: float = 0.0
    drop_path_rate: float = 0.0
    activation_dropout: float = 0.0
    no_scale_embedding: bool = True
    layernorm_embedding: bool = False
    deepnorm: bool = False
    subln: bool = True
    share_decoder_input_output_embed: bool = False
    no_output_layer: bool = False
    layernorm_eps: float = 1e-6
    chunkwise_recurrent: bool = False
    recurrent_chunk_size: int = 512
    vocab_size: int = -1
    extras: Dict[str, Any] = field(default_factory=dict)

    def postprocessing(self) -> None:
        _flip_norms(self)
        _xmoe(self)
