"""LongNet: the encoder and the causal decoder with dilated
self-attention, and the named factory (counterpart of
``gigapath_tpu/models/longnet.py``).

:class:`LongNetDecoder` runs a whole sequence causally (on one device the
phase-major kernels, rows 1-3, as the encoder does) or decodes
incrementally with ``incremental_state``: each step's dilated attention
takes the cache by position (``offset``) on the generic route, each
branch on the segment-flash kernel (row 11).
"""

from __future__ import annotations

from typing import Tuple, Union

from torch import nn

from gigapath_tpu_torch.architecture.config import EncoderConfig
from gigapath_tpu_torch.architecture.decoder import Decoder, DecoderLayer
from gigapath_tpu_torch.architecture.encoder import Encoder, EncoderLayer
from gigapath_tpu_torch.models import longnet_config
from gigapath_tpu_torch.ops.dilated_attention import DilatedAttention


def _dilated_self_attention(args, embed_dim: int, heads: int, model_group=None, multiway: bool = False):
    if not (args.segment_length and args.dilated_ratio):
        raise ValueError("LongNet requires a segment_length/dilated_ratio schedule")
    return DilatedAttention(
        embed_dim,
        heads,
        segment_length=args.segment_length,
        dilated_ratio=args.dilated_ratio,
        subln=args.subln,
        layernorm_eps=args.layernorm_eps,
        dropout=args.attention_dropout,
        seq_parallel=args.seq_parallel,
        seq_group=args.extras.get("seq_group"),
        model_group=model_group,
        xpos_rel_pos=args.xpos_rel_pos,
        xpos_scale_base=args.xpos_scale_base,
        multiway=multiway,
    )


class LongNetDecoderLayer(DecoderLayer):
    """Decoder block with dilated causal self-attention."""

    def build_self_attention(self) -> nn.Module:
        return _dilated_self_attention(self.args, self.args.decoder_embed_dim, self.args.decoder_attention_heads)


class LongNetDecoder(Decoder):
    """Causal LongNet: the whole sequence at once, or eager incremental
    decoding with ``incremental_state``."""

    layer_cls = LongNetDecoderLayer


class LongNetEncoderLayer(EncoderLayer):
    def build_self_attention(self) -> nn.Module:
        args = self.args
        return _dilated_self_attention(args, args.encoder_embed_dim, args.encoder_attention_heads,
                                       model_group=self.model_group, multiway=args.multiway)


class LongNetEncoder(Encoder):
    layer_cls = LongNetEncoderLayer


def make_longnet_from_name(
    config_name: str,
    dilated_ratio: Union[str, list] = "[1, 2, 4, 8, 16]",
    segment_length: Union[str, list] = "[1024, 2048, 4096, 8192, 16384]",
    drop_path_rate: float = 0.1,
    dropout: float = 0.1,
    *,
    seq_parallel: bool = False,
    seq_group=None,
    model_group=None,
    expert_group=None,
    expert_parallel: str = "gather",
    **overrides,
) -> Tuple[LongNetEncoder, EncoderConfig]:
    """Build a LongNet encoder from a registry name; ``**overrides``
    update any EncoderConfig field. Returns ``(module, config)``.

    ``seq_parallel`` with ``seq_group`` (the process group of a mesh's
    ``seq`` dim; the JAX package's ``seq_axis_name`` / ``seq_axis_size``)
    makes every layer's attention sequence-parallel: each rank runs the
    encoder on its own slice of the tokens. ``model_group`` (a mesh's
    ``model`` dim) makes the attention and the FFNs tensor-parallel: each
    rank holds its shards (load them with
    ``parallel.tensor.shard_state_dict``). ``expert_group`` (a mesh's
    ``expert`` dim) spreads an MoE variant's experts (``moe_freq=2,
    moe_expert_count=8`` among the overrides) over its ranks,
    ``expert_parallel`` ``"gather"`` or ``"all_to_all"``
    (:mod:`gigapath_tpu_torch.ops.moe.expert_parallel`)."""
    cfg_dict = longnet_config.get_config(config_name)
    cfg_dict.update(
        dropout=dropout,
        drop_path_rate=drop_path_rate,
        dilated_ratio=dilated_ratio,
        segment_length=segment_length,
        seq_parallel=seq_parallel,
        **overrides,
    )
    cfg = EncoderConfig.from_dict(cfg_dict)
    cfg.extras.update(seq_group=seq_group, model_group=model_group, expert_group=expert_group,
                      expert_parallel=expert_parallel)
    return LongNetEncoder(cfg), cfg
