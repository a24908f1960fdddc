"""Transformer encoder stack (counterpart of
``gigapath_tpu/architecture/encoder.py``), restricted to what LongNet uses:
pre-LN (or post-LN) blocks of self-attention and FFN with sub-LN, padding
rows zeroed at the input, ``return_all_hiddens``, the final ``layer_norm``,
and ``checkpoint_activations`` (each layer re-run in the backward, the
counterpart of the JAX package's per-layer ``nn.remat``). Training mode
comes from ``module.train()``: dropout and drop-path act only there.

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
not run tensor-parallel (``ValueError``). Relative-position bias, multiway
and the token embedding are not ported.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from gigapath_tpu_torch.architecture.config import EncoderConfig
from gigapath_tpu_torch.ops.attention import MultiheadAttention
from gigapath_tpu_torch.ops.droppath import DropPath
from gigapath_tpu_torch.ops.feedforward import FeedForwardNetwork
from gigapath_tpu_torch.ops.moe import MOELayer


class EncoderLayer(nn.Module):
    """One encoder block; ``build_self_attention`` is the hook the LongNet
    layer overrides to put in dilated attention."""

    def __init__(self, args: EncoderConfig, depth: int, is_moe_layer: bool = False):
        super().__init__()
        self.args = args
        self.model_group = args.extras.get("model_group")
        if is_moe_layer and self.model_group is not None:
            raise ValueError("MoE layers do not run tensor-parallel: pass no model_group with moe_freq > 0")
        self.self_attn = self.build_self_attention()
        self.self_attn_layer_norm = nn.LayerNorm(args.encoder_embed_dim, eps=args.layernorm_eps)
        self.dropout_module = nn.Dropout(args.dropout)
        prob = 0.0
        if args.drop_path_rate > 0:
            prob = float(np.linspace(0, args.drop_path_rate, args.encoder_layers)[depth])
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
            self.ffn = FeedForwardNetwork(
                args.encoder_embed_dim,
                args.encoder_ffn_embed_dim,
                args.activation_fn,
                args.dropout,
                args.activation_dropout,
                args.layernorm_eps,
                args.subln,
                model_group=self.model_group,
            )
        self.final_layer_norm = nn.LayerNorm(args.encoder_embed_dim, eps=args.layernorm_eps)
        self.alpha = math.pow(2.0 * args.encoder_layers, 0.25) if args.deepnorm else 1.0

    def build_self_attention(self) -> nn.Module:
        return MultiheadAttention(
            self.args.encoder_embed_dim,
            self.args.encoder_attention_heads,
            subln=self.args.subln,
            layernorm_eps=self.args.layernorm_eps,
            model_group=self.model_group,
        )

    def _residual(self, residual: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        if self.drop_path is not None:
            x = self.drop_path(x)
        return residual * self.alpha + x

    def forward(self, x: torch.Tensor, encoder_padding_mask: Optional[torch.Tensor] = None,
                return_l_aux: bool = False):
        """The block; with ``return_l_aux``, ``(x, l_aux)`` (None for a
        dense layer)."""
        residual = x
        if self.normalize_before:
            x = self.self_attn_layer_norm(x)
        x = self.self_attn(x, x, x, key_padding_mask=encoder_padding_mask)
        x = self._residual(residual, self.dropout_module(x))
        if not self.normalize_before:
            x = self.self_attn_layer_norm(x)

        residual = x
        if self.normalize_before:
            x = self.final_layer_norm(x)
        l_aux = None
        if self.moe_layer is None:
            x = self.ffn(x)
        else:
            x, l_aux = self.moe_layer(x, encoder_padding_mask)
        x = self._residual(residual, x)
        if not self.normalize_before:
            x = self.final_layer_norm(x)
        return (x, l_aux) if return_l_aux else x


class Encoder(nn.Module):
    """Encoder stack returning the reference's output dict
    (``encoder_out``, ``encoder_embedding``, ``encoder_padding_mask``,
    ``encoder_states``).

    ``state_readout`` (with ``return_all_hiddens``) reduces each hidden
    state as soon as its layer has run, and ``encoder_states`` holds the
    reductions: a caller that reads one row or a mean of each state then
    never holds more than one full ``[B, L, E]`` state at a time. Without
    it ``encoder_states`` holds the full states, as in the reference."""

    layer_cls = EncoderLayer  # subclass hook (LongNetEncoder overrides)

    def __init__(self, args: EncoderConfig):
        super().__init__()
        self.args = args
        self.embed_scale = 1.0 if args.no_scale_embedding else math.sqrt(args.encoder_embed_dim)
        self.layernorm_embedding = (
            nn.LayerNorm(args.encoder_embed_dim, eps=args.layernorm_eps)
            if args.layernorm_embedding else None
        )
        self.dropout_module = nn.Dropout(args.dropout)
        self.layers = nn.ModuleList(
            type(self).layer_cls(args, depth=i, is_moe_layer=args.moe_freq != 0 and (i + 1) % args.moe_freq == 0)
            for i in range(args.encoder_layers)
        )
        self.moe_l_aux = None
        self.layer_norm = (
            nn.LayerNorm(args.encoder_embed_dim, eps=args.layernorm_eps)
            if args.encoder_normalize_before and args.normalize_output else None
        )

    def forward(
        self,
        token_embeddings: torch.Tensor,
        encoder_padding_mask: Optional[torch.Tensor] = None,
        return_all_hiddens: bool = False,
        state_readout: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    ) -> Dict[str, Any]:
        x = embed = self.embed_scale * token_embeddings
        if self.layernorm_embedding is not None:
            x = self.layernorm_embedding(x)
        x = self.dropout_module(x)
        if encoder_padding_mask is not None:
            x = x.masked_fill(encoder_padding_mask[..., None].to(torch.bool), 0)

        keep = state_readout or (lambda state: state)
        encoder_states = [keep(x)] if return_all_hiddens else []
        remat = self.args.checkpoint_activations and torch.is_grad_enabled()
        l_aux = []
        for layer in self.layers:
            if remat:
                # non-reentrant; the RNG state is restored for the re-run,
                # so dropout draws the same masks twice
                x, aux = torch.utils.checkpoint.checkpoint(layer, x, encoder_padding_mask, True, use_reentrant=False)
            else:
                x, aux = layer(x, encoder_padding_mask, return_l_aux=True)
            l_aux.append(aux)
            if return_all_hiddens:
                encoder_states.append(keep(x))
        moe_losses = [a for a in l_aux if a is not None]
        self.moe_l_aux = sum(moe_losses) if moe_losses else None
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        return {
            "encoder_out": x,
            "encoder_embedding": embed,
            "encoder_padding_mask": encoder_padding_mask,
            "encoder_states": encoder_states,
            "l_aux": l_aux,
        }
