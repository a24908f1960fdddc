"""Transformer decoder stack (counterpart of
``gigapath_tpu/architecture/decoder.py``).

:class:`DecoderLayer`: causal self-attention, cross-attention on the
encoder's output (an encoder-decoder's layers), FFN or MoE, pre- or
post-LN, deepnorm's residual alpha and per-depth drop-path.
:class:`Decoder`: the embedding scale, an optional ``embed_positions``
module (torchscale's constructor argument; fairseq positions ``2..``,
continued across decode steps), ``layernorm_embedding``, the bucketed
relative-position biases (self and cross), the layer stack, the final
``layer_norm`` and the output projection (shared with ``embed_tokens``
under ``share_decoder_input_output_embed``) unless ``features_only``.

The causal mask is the attention's flag, never a materialized triangle.
Decoding keeps torchscale's ``incremental_state``, a dict the caller
passes to every call, empty at first: the decoder keeps layer i's
self-attention cache under ``incremental_state[i]``
(:class:`~gigapath_tpu_torch.ops.attention.MultiheadAttention`), and each
call feeds only the new tokens (one, or a chunk), as the JAX package's
``decode=True`` calls do. Relative-position biases do not combine with
decoding (``ValueError``; the JAX package cannot reshape its bias to the
cache either).

Key names are torchscale's (``embed_tokens``, ``layers.N.self_attn``,
``encoder_attn``, ``encoder_attn_layer_norm``, ``ffn``, ``moe_layer``,
``final_layer_norm``, ``layer_norm``, ``output_projection``,
``self_attn_relative_position``, ``cross_attn_relative_position``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.utils.checkpoint
from torch import nn

from gigapath_tpu_torch.architecture.config import DecoderConfig
from gigapath_tpu_torch.architecture.encoder import drop_path_prob
from gigapath_tpu_torch.ops.attention import MultiheadAttention
from gigapath_tpu_torch.ops.droppath import DropPath
from gigapath_tpu_torch.ops.feedforward import FeedForwardNetwork
from gigapath_tpu_torch.ops.moe import MOELayer
from gigapath_tpu_torch.ops.relative_position_bias import RelativePositionBias


class DecoderLayer(nn.Module):
    """One decoder block; ``build_self_attention`` is the hook the LongNet
    layer overrides to put in dilated attention."""

    def __init__(self, args: DecoderConfig, depth: int, is_moe_layer: bool = False,
                 is_encoder_decoder: bool = False):
        super().__init__()
        self.args = args
        E, eps = args.decoder_embed_dim, args.layernorm_eps
        self.self_attn = self.build_self_attention()
        self.self_attn_layer_norm = nn.LayerNorm(E, eps=eps)
        self.dropout_module = nn.Dropout(args.dropout)
        prob = drop_path_prob(args.drop_path_rate, args.decoder_layers, depth)
        self.drop_path = DropPath(prob) if prob > 0 else None
        self.normalize_before = args.decoder_normalize_before
        if is_encoder_decoder:
            self.encoder_attn = MultiheadAttention(
                E, args.decoder_attention_heads, subln=args.subln, layernorm_eps=eps,
                dropout=args.attention_dropout, self_attention=False, encoder_decoder_attention=True,
            )
            self.encoder_attn_layer_norm = nn.LayerNorm(E, eps=eps)
        else:
            self.encoder_attn = self.encoder_attn_layer_norm = None
        if is_moe_layer:
            self.ffn = None
            self.moe_layer = MOELayer.from_config(args, prefix="decoder")
        else:
            self.moe_layer = None
            self.ffn = FeedForwardNetwork(E, args.decoder_ffn_embed_dim, args.activation_fn, args.dropout,
                                          args.activation_dropout, eps, args.subln)
        self.final_layer_norm = nn.LayerNorm(E, eps=eps)
        if not args.deepnorm:
            self.alpha = 1.0
        else:
            self.alpha = math.pow((3.0 if is_encoder_decoder else 2.0) * args.decoder_layers, 0.25)

    def build_self_attention(self) -> nn.Module:
        args = self.args
        return MultiheadAttention(
            args.decoder_embed_dim, args.decoder_attention_heads, subln=args.subln,
            layernorm_eps=args.layernorm_eps, dropout=args.attention_dropout,
            xpos_rel_pos=args.xpos_rel_pos, xpos_scale_base=args.xpos_scale_base,
        )

    def _residual(self, residual: torch.Tensor, x: torch.Tensor, generator) -> torch.Tensor:
        x = self.dropout_module(x)
        if self.drop_path is not None:
            x = self.drop_path(x, generator)
        return residual * self.alpha + x

    def forward(
        self,
        x: torch.Tensor,
        encoder_out: Optional[torch.Tensor] = None,
        encoder_padding_mask: Optional[torch.Tensor] = None,
        incremental_state: Optional[Dict[str, Any]] = None,
        self_attn_padding_mask: Optional[torch.Tensor] = None,
        self_attn_rel_pos: Optional[torch.Tensor] = None,
        cross_attn_rel_pos: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """The block -> ``(x, l_aux)`` (None for a dense layer)."""
        residual = x
        if self.normalize_before:
            x = self.self_attn_layer_norm(x)
        x = self.self_attn(
            x, x, x, key_padding_mask=self_attn_padding_mask, rel_pos=self_attn_rel_pos, is_causal=True,
            incremental_state=incremental_state, generator=generator,
        )
        x = self._residual(residual, x, generator)
        if not self.normalize_before:
            x = self.self_attn_layer_norm(x)

        if self.encoder_attn is not None and encoder_out is not None:
            residual = x
            if self.normalize_before:
                x = self.encoder_attn_layer_norm(x)
            x = self.encoder_attn(
                x, encoder_out, encoder_out, key_padding_mask=encoder_padding_mask, rel_pos=cross_attn_rel_pos,
                generator=generator,
            )
            x = self._residual(residual, x, generator)
            if not self.normalize_before:
                x = self.encoder_attn_layer_norm(x)

        residual = x
        if self.normalize_before:
            x = self.final_layer_norm(x)
        l_aux = None
        if self.moe_layer is None:
            x = self.ffn(x)
        else:
            x, l_aux = self.moe_layer(x, self_attn_padding_mask, generator=generator)
        if self.drop_path is not None:
            x = self.drop_path(x, generator)
        x = residual * self.alpha + x
        if not self.normalize_before:
            x = self.final_layer_norm(x)
        return x, l_aux


class Decoder(nn.Module):
    """Decoder stack returning the JAX package's dict (``decoder_out``,
    ``inner_states``, ``l_aux``, ``attn``). ``embed_tokens`` and
    ``output_projection`` as torchscale takes them; with a vocabulary and no
    ``embed_tokens`` given, the decoder makes its own (the JAX package's
    ``embed_tokens``), and it builds the output projection unless
    ``no_output_layer``."""

    layer_cls = DecoderLayer  # subclass hook (LongNetDecoder overrides)

    def __init__(self, args: DecoderConfig, embed_tokens: Optional[nn.Module] = None,
                 embed_positions: Optional[nn.Module] = None, output_projection: Optional[nn.Module] = None,
                 is_encoder_decoder: bool = False):
        super().__init__()
        self.args = args
        E = args.decoder_embed_dim
        self.embed_scale = 1.0 if args.no_scale_embedding else math.sqrt(E)
        if embed_tokens is None and args.vocab_size > 0:
            embed_tokens = nn.Embedding(args.vocab_size, E)
        self.embed_tokens = embed_tokens
        self.embed_positions = embed_positions
        self.layernorm_embedding = nn.LayerNorm(E, eps=args.layernorm_eps) if args.layernorm_embedding else None
        self.dropout_module = nn.Dropout(args.dropout)
        self.self_attn_relative_position = self.cross_attn_relative_position = None
        if args.rel_pos_buckets > 0 and args.max_rel_pos > 0:
            def rel():
                return RelativePositionBias(bidirectional=False, num_buckets=args.rel_pos_buckets,
                                            max_distance=args.max_rel_pos, n_heads=args.decoder_attention_heads)

            self.self_attn_relative_position = rel()
            if is_encoder_decoder:
                self.cross_attn_relative_position = rel()
        self.layers = nn.ModuleList(
            type(self).layer_cls(args, depth=i, is_moe_layer=args.moe_freq != 0 and (i + 1) % args.moe_freq == 0,
                                 is_encoder_decoder=is_encoder_decoder)
            for i in range(args.decoder_layers)
        )
        self.moe_l_aux = None
        self.layer_norm = nn.LayerNorm(E, eps=args.layernorm_eps) if args.decoder_normalize_before else None
        if output_projection is None and not args.no_output_layer and args.vocab_size > 0:
            output_projection = nn.Linear(E, args.vocab_size, bias=False)
            if args.share_decoder_input_output_embed:
                output_projection.weight = self.embed_tokens.weight
        self.output_projection = output_projection

    def forward(
        self,
        prev_output_tokens: Optional[torch.Tensor] = None,
        self_attn_padding_mask: Optional[torch.Tensor] = None,
        encoder_out: Optional[Dict[str, Any]] = None,
        incremental_state: Optional[Dict[int, Dict[str, Any]]] = None,
        features_only: bool = False,
        return_all_hiddens: bool = False,
        token_embeddings: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, Any]:
        """``prev_output_tokens`` [B, L] or ``token_embeddings`` [B, L, E]:
        the whole sequence, or with ``incremental_state`` the tokens after
        those already decoded. ``generator`` draws attention and drop-path
        dropout in training mode."""
        if token_embeddings is None:
            if prev_output_tokens is None:
                raise ValueError("the decoder needs prev_output_tokens or token_embeddings")
            token_embeddings = self.embed_tokens(prev_output_tokens)
        start = 0 if incremental_state is None else incremental_state.get(0, {}).get("index", 0)
        x = self.embed_scale * token_embeddings
        if self.embed_positions is not None:
            positions = torch.arange(start + 2, start + 2 + x.shape[1], device=x.device)[None, :]
            x = x + self.embed_positions(x, positions)
        if self.layernorm_embedding is not None:
            x = self.layernorm_embedding(x)
        x = self.dropout_module(x)

        B, slen = x.shape[:2]
        self_rel = cross_rel = None
        if self.self_attn_relative_position is not None:
            if incremental_state is not None:
                raise ValueError("relative position biases with incremental decoding are not supported")
            self_rel = self.self_attn_relative_position(B, slen, slen)
            if self.cross_attn_relative_position is not None and encoder_out is not None:
                cross_rel = self.cross_attn_relative_position(B, slen, encoder_out["encoder_out"].shape[1])

        enc = encoder_out["encoder_out"] if encoder_out else None
        enc_pad = encoder_out.get("encoder_padding_mask") if encoder_out else None
        inner_states = [x]
        l_aux = list(encoder_out.get("l_aux", [])) if encoder_out else []
        remat = self.args.checkpoint_activations and torch.is_grad_enabled() and incremental_state is None
        for i, layer in enumerate(self.layers):
            state = None if incremental_state is None else incremental_state.setdefault(i, {})
            args = (x, enc, enc_pad, state, self_attn_padding_mask, self_rel, cross_rel, generator)
            if remat:
                x, aux = torch.utils.checkpoint.checkpoint(_replaying(layer, generator), *args, use_reentrant=False)
            else:
                x, aux = layer(*args)
            l_aux.append(aux)
            inner_states.append(x)
        moe_losses = [a for a in l_aux if a is not None]
        self.moe_l_aux = sum(moe_losses) if moe_losses else None
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        if not features_only and self.output_projection is not None:
            x = self.output_projection(x)
        return {
            "decoder_out": x,
            "inner_states": inner_states if return_all_hiddens else [x],
            "l_aux": l_aux,
            "attn": None,
        }


def _replaying(layer: nn.Module, generator: Optional[torch.Generator]):
    """``layer`` for a checkpoint: the checkpoint restores only torch's
    default generators for the backward's re-run, so the caller's
    ``generator`` is wound back to its state before the forward, for the
    re-run to draw the forward's dropout masks, and set again after it to
    where the forward left it."""
    if generator is None:
        return layer
    before, calls = generator.get_state(), []

    def run(*args):
        rerun, after = bool(calls), generator.get_state()
        calls.append(1)
        generator.set_state(before)
        try:
            return layer(*args)
        finally:  # the re-run may stop early, by an exception
            if rerun:
                generator.set_state(after)

    return run
