"""Transformer encoder stack (counterpart of
``gigapath_tpu/architecture/encoder.py``): pre-LN (or post-LN) blocks of
self-attention and FFN-or-MoE with sub-LN or deepnorm, per-depth drop-path,
``return_all_hiddens``, the final ``layer_norm`` and
``checkpoint_activations`` (each layer re-run in the backward, the
counterpart of the JAX package's per-layer ``nn.remat``). Training mode
comes from ``module.train()``: dropout and drop-path act only there.

Inputs, as in the JAX package: ``token_embeddings`` or ``src_tokens``
(through ``embed_tokens``, scaled by ``sqrt(E)`` unless
``no_scale_embedding``), an ``embed_positions`` module (torchscale's
constructor argument; the JAX package passes it per call),
``layernorm_embedding``, padding rows zeroed, an ``attn_mask`` (True =
masked) and the bucketed relative-position bias (``rel_pos_buckets`` and
``max_rel_pos``) on every layer's attention, and ``multiway_split_position``
through every LayerNorm, attention and FFN of a ``multiway`` config. The
output projection is built as torchscale builds it (a vocabulary and no
``no_output_layer``; shared with ``embed_tokens`` under
``share_encoder_input_output_embed``) and applied unless
``features_only``. An encoder of an encoder-decoder
(``is_encoder_decoder``) takes deepnorm's encoder-decoder residual alpha.

MoE: layer i is an MoE layer when ``moe_freq`` divides ``i + 1``; its FFN
is a :class:`~gigapath_tpu_torch.ops.moe.MOELayer` (``moe_layer``, fed the
padding mask so that padded tokens claim no capacity), and the encoder
keeps the sum of the layers' balance losses as ``moe_l_aux`` (the JAX
package sows it as ``intermediates/moe_l_aux``), where
``parallel/spmd.py:collect_moe_l_aux`` finds it; the output dict's
``l_aux`` lists each layer's (None for a dense layer).

The config's ``extras`` may carry process groups: ``model_group`` (tensor
parallelism: the attention and dense FFN run on the rank's shards,
:mod:`gigapath_tpu_torch.parallel.tensor`), ``expert_group`` and
``expert_parallel`` (the MoE layers' expert parallelism). MoE layers do
not run tensor-parallel (``ValueError``).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from gigapath_tpu_torch.architecture.config import EncoderConfig
from gigapath_tpu_torch.ops import multiway as mw
from gigapath_tpu_torch.ops.attention import NEG_INF, MultiheadAttention
from gigapath_tpu_torch.ops.droppath import DropPath
from gigapath_tpu_torch.ops.feedforward import FeedForwardNetwork
from gigapath_tpu_torch.ops.moe import MOELayer
from gigapath_tpu_torch.ops.relative_position_bias import RelativePositionBias


def drop_path_prob(rate: float, layers: int, depth: int) -> float:
    """Layer ``depth``'s drop-path probability: linear from 0 to ``rate``."""
    return float(np.linspace(0, rate, layers)[depth]) if rate > 0 else 0.0


class EncoderLayer(nn.Module):
    """One encoder block; ``build_self_attention`` is the hook the LongNet
    layer overrides to put in dilated attention."""

    def __init__(self, args: EncoderConfig, depth: int, is_moe_layer: bool = False,
                 is_encoder_decoder: bool = False):
        super().__init__()
        self.args = args
        self.model_group = args.extras.get("model_group")
        if is_moe_layer and self.model_group is not None:
            raise ValueError("MoE layers do not run tensor-parallel: pass no model_group with moe_freq > 0")
        E = args.encoder_embed_dim
        self.self_attn = self.build_self_attention()
        self.self_attn_layer_norm = mw.multiway_layernorm(args.multiway, E, args.layernorm_eps)
        self.dropout_module = nn.Dropout(args.dropout)
        prob = drop_path_prob(args.drop_path_rate, args.encoder_layers, depth)
        self.drop_path = DropPath(prob) if prob > 0 else None
        self.normalize_before = args.encoder_normalize_before
        if is_moe_layer:
            self.ffn = None
            self.moe_layer = MOELayer.from_config(
                args, expert_group=args.extras.get("expert_group"),
                expert_parallel=args.extras.get("expert_parallel", "gather"),
            )
        else:
            self.moe_layer = None
            self.ffn = mw.maybe_multiway(args.multiway, lambda: FeedForwardNetwork(
                E, args.encoder_ffn_embed_dim, args.activation_fn, args.dropout, args.activation_dropout,
                args.layernorm_eps, args.subln, model_group=self.model_group,
            ))
        self.final_layer_norm = mw.multiway_layernorm(args.multiway, E, args.layernorm_eps)
        if not args.deepnorm:
            self.alpha = 1.0
        elif is_encoder_decoder:
            self.alpha = math.pow(math.pow(args.encoder_layers, 4) * getattr(args, "decoder_layers", 1), 0.0625) * 0.81
        else:
            self.alpha = math.pow(2.0 * args.encoder_layers, 0.25)

    def build_self_attention(self) -> nn.Module:
        args = self.args
        return MultiheadAttention(
            args.encoder_embed_dim,
            args.encoder_attention_heads,
            subln=args.subln,
            layernorm_eps=args.layernorm_eps,
            model_group=self.model_group,
            dropout=args.attention_dropout,
            xpos_rel_pos=args.xpos_rel_pos,
            xpos_scale_base=args.xpos_scale_base,
            multiway=args.multiway,
        )

    def _residual(self, residual: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        if self.drop_path is not None:
            x = self.drop_path(x)
        return residual * self.alpha + x

    def forward(self, x: torch.Tensor, encoder_padding_mask: Optional[torch.Tensor] = None,
                return_l_aux: bool = False, attn_mask: Optional[torch.Tensor] = None,
                rel_pos: Optional[torch.Tensor] = None, multiway_split_position: int = -1):
        """The block; with ``return_l_aux``, ``(x, l_aux)`` (None for a
        dense layer). ``attn_mask``: True = masked."""
        split = multiway_split_position
        if attn_mask is not None:
            attn_mask = torch.where(attn_mask.to(torch.bool), NEG_INF, 0.0)
        residual = x
        if self.normalize_before:
            x = mw.call(self.self_attn_layer_norm, x, split_position=split)
        x = self.self_attn(x, x, x, key_padding_mask=encoder_padding_mask, attn_mask=attn_mask, rel_pos=rel_pos,
                           multiway_split_position=split)
        x = self._residual(residual, self.dropout_module(x))
        if not self.normalize_before:
            x = mw.call(self.self_attn_layer_norm, x, split_position=split)

        residual = x
        if self.normalize_before:
            x = mw.call(self.final_layer_norm, x, split_position=split)
        l_aux = None
        if self.moe_layer is None:
            x = mw.call(self.ffn, x, split_position=split)
        else:
            x, l_aux = self.moe_layer(x, encoder_padding_mask)
        x = self._residual(residual, x)
        if not self.normalize_before:
            x = mw.call(self.final_layer_norm, x, split_position=split)
        return (x, l_aux) if return_l_aux else x


class Encoder(nn.Module):
    """Encoder stack returning the reference's output dict
    (``encoder_out``, ``encoder_embedding``, ``encoder_padding_mask``,
    ``encoder_states``, ``l_aux``).

    ``state_readout`` (with ``return_all_hiddens``) reduces each hidden
    state as soon as its layer has run, and ``encoder_states`` holds the
    reductions: a caller that reads one row or a mean of each state then
    never holds more than one full ``[B, L, E]`` state at a time. Without
    it ``encoder_states`` holds the full states, as in the reference."""

    layer_cls = EncoderLayer  # subclass hook (LongNetEncoder overrides)

    def __init__(self, args: EncoderConfig, embed_tokens: Optional[nn.Module] = None,
                 embed_positions: Optional[nn.Module] = None, output_projection: Optional[nn.Module] = None,
                 is_encoder_decoder: bool = False):
        super().__init__()
        self.args = args
        E = args.encoder_embed_dim
        self.embed_scale = 1.0 if args.no_scale_embedding else math.sqrt(E)
        self.embed_tokens = embed_tokens
        self.embed_positions = embed_positions
        self.layernorm_embedding = (
            mw.multiway_layernorm(args.multiway, E, args.layernorm_eps) if args.layernorm_embedding else None
        )
        self.dropout_module = nn.Dropout(args.dropout)
        self.relative_position = None
        if args.rel_pos_buckets > 0 and args.max_rel_pos > 0:
            self.relative_position = RelativePositionBias(
                num_buckets=args.rel_pos_buckets, max_distance=args.max_rel_pos,
                n_heads=args.encoder_attention_heads,
            )
        self.layers = nn.ModuleList(
            type(self).layer_cls(args, depth=i, is_moe_layer=args.moe_freq != 0 and (i + 1) % args.moe_freq == 0,
                                 is_encoder_decoder=is_encoder_decoder)
            for i in range(args.encoder_layers)
        )
        self.moe_l_aux = None
        self.layer_norm = (
            mw.multiway_layernorm(args.multiway, E, args.layernorm_eps)
            if args.encoder_normalize_before and args.normalize_output else None
        )
        if output_projection is None and not args.no_output_layer and args.vocab_size > 0:
            output_projection = nn.Linear(E, args.vocab_size, bias=False)
            if getattr(args, "share_encoder_input_output_embed", False):
                output_projection.weight = self.embed_tokens.weight
        self.output_projection = output_projection

    def forward(
        self,
        token_embeddings: Optional[torch.Tensor] = None,
        encoder_padding_mask: Optional[torch.Tensor] = None,
        return_all_hiddens: bool = False,
        state_readout: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        *,
        src_tokens: Optional[torch.Tensor] = None,
        attn_mask: Optional[torch.Tensor] = None,
        features_only: bool = False,
        multiway_split_position: int = -1,
        positions: Optional[torch.Tensor] = None,
    ) -> Dict[str, Any]:
        """``embed_positions(x, positions)``, split at
        ``multiway_split_position`` for a multiway table."""
        if token_embeddings is None:
            if src_tokens is None:
                raise ValueError("the encoder needs src_tokens or token_embeddings")
            token_embeddings = self.embed_tokens(src_tokens)
        split = multiway_split_position
        x = embed = self.embed_scale * token_embeddings
        if self.embed_positions is not None:
            x = x + mw.call(self.embed_positions, x, positions, split_position=split)
        if self.layernorm_embedding is not None:
            x = mw.call(self.layernorm_embedding, x, split_position=split)
        x = self.dropout_module(x)
        if encoder_padding_mask is not None:
            x = x.masked_fill(encoder_padding_mask[..., None].to(torch.bool), 0)
        rel_pos = None
        if self.relative_position is not None:
            rel_pos = self.relative_position(x.shape[0], x.shape[1], x.shape[1])

        keep = state_readout or (lambda state: state)
        encoder_states = [keep(x)] if return_all_hiddens else []
        remat = self.args.checkpoint_activations and torch.is_grad_enabled()
        l_aux = []
        for layer in self.layers:
            args = (x, encoder_padding_mask, True, attn_mask, rel_pos, split)
            if remat:
                # non-reentrant; the RNG state is restored for the re-run,
                # so dropout draws the same masks twice
                x, aux = torch.utils.checkpoint.checkpoint(layer, *args, use_reentrant=False)
            else:
                x, aux = layer(*args)
            l_aux.append(aux)
            if return_all_hiddens:
                encoder_states.append(keep(x))
        moe_losses = [a for a in l_aux if a is not None]
        self.moe_l_aux = sum(moe_losses) if moe_losses else None
        if self.layer_norm is not None:
            x = mw.call(self.layer_norm, x, split_position=split)
        if not features_only and self.output_projection is not None:
            x = self.output_projection(x)
        return {
            "encoder_out": x,
            "encoder_embedding": embed,
            "encoder_padding_mask": encoder_padding_mask,
            "encoder_states": encoder_states,
            "l_aux": l_aux,
        }
