"""RetNet decoder (counterpart of ``gigapath_tpu/architecture/retnet.py``).

RMS-normed blocks of :class:`~gigapath_tpu_torch.ops.multiscale_retention.MultiScaleRetention`
and a GLU feed-forward (or MoE), deepnorm's residual alpha, per-depth
drop-path; the decoder adds the embedding scale, RMS ``layernorm_embedding``,
the chunk padding of the chunkwise form (the input padded to a multiple of
``recurrent_chunk_size`` and cut back), the final RMSNorm and the output
projection (shared with ``embed_tokens`` under
``share_decoder_input_output_embed``).

Forms: parallel by default; chunkwise when the config sets
``chunkwise_recurrent``; recurrent with ``incremental_state`` (a dict the
caller passes to every call, empty at first; layer i's state under
``incremental_state[i]``), one token a call, the step's 0-based position
counted there (the JAX package's ``decode_position``). Key names are
torchscale's (``layers.N.retention``, ``retention_layer_norm``, ``ffn``,
``final_layer_norm``, ``layer_norm``, ``embed_tokens``,
``output_projection``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
from torch import nn

from gigapath_tpu_torch.architecture.config import RetNetConfig
from gigapath_tpu_torch.architecture.encoder import drop_path_prob
from gigapath_tpu_torch.ops.droppath import DropPath
from gigapath_tpu_torch.ops.feedforward import GLU
from gigapath_tpu_torch.ops.moe import MOELayer
from gigapath_tpu_torch.ops.multiscale_retention import MultiScaleRetention, retnet_rel_pos
from gigapath_tpu_torch.ops.norms import RMSNorm


class RetNetDecoderLayer(nn.Module):
    def __init__(self, args: RetNetConfig, depth: int, is_moe_layer: bool = False):
        super().__init__()
        E, eps = args.decoder_embed_dim, args.layernorm_eps
        self.retention = MultiScaleRetention(E, args.decoder_value_embed_dim, args.decoder_retention_heads,
                                             layernorm_eps=eps)
        self.retention_layer_norm = RMSNorm(E, eps=eps)
        self.dropout_module = nn.Dropout(args.dropout)
        prob = drop_path_prob(args.drop_path_rate, args.decoder_layers, depth)
        self.drop_path = DropPath(prob) if prob > 0 else None
        self.normalize_before = args.decoder_normalize_before
        if is_moe_layer:
            self.ffn = None
            self.moe_layer = MOELayer.from_config(args, prefix="decoder")
        else:
            self.moe_layer = None
            self.ffn = GLU(E, args.decoder_ffn_embed_dim, args.activation_fn, args.dropout, args.activation_dropout)
        self.final_layer_norm = RMSNorm(E, eps=eps)
        self.alpha = math.pow(2.0 * args.decoder_layers, 0.25) if args.deepnorm else 1.0

    def _residual(self, residual, x, generator):
        if self.drop_path is not None:
            x = self.drop_path(x, generator)
        return residual * self.alpha + x

    def forward(self, x: torch.Tensor, rel_pos, chunkwise_recurrent: bool = False,
                incremental_state: Optional[Dict[str, Any]] = None, generator: Optional[torch.Generator] = None):
        """The block -> ``(x, l_aux)`` (None for a dense layer)."""
        residual = x
        if self.normalize_before:
            x = self.retention_layer_norm(x)
        x = self.retention(x, rel_pos, chunkwise_recurrent=chunkwise_recurrent, incremental_state=incremental_state)
        x = self._residual(residual, self.dropout_module(x), generator)
        if not self.normalize_before:
            x = self.retention_layer_norm(x)
        residual = x
        if self.normalize_before:
            x = self.final_layer_norm(x)
        l_aux = None
        if self.moe_layer is None:
            x = self.ffn(x)
        else:
            x, l_aux = self.moe_layer(x, generator=generator)
        x = self._residual(residual, x, generator)
        if not self.normalize_before:
            x = self.final_layer_norm(x)
        return x, l_aux


class RetNetDecoder(nn.Module):
    """RetNet stack returning the JAX package's dict (``decoder_out``,
    ``inner_states``, ``l_aux``, ``attn``)."""

    def __init__(self, args: RetNetConfig, embed_tokens: Optional[nn.Module] = None,
                 output_projection: Optional[nn.Module] = None):
        super().__init__()
        self.args = args
        E = args.decoder_embed_dim
        self.embed_scale = 1.0 if args.no_scale_embedding else math.sqrt(E)
        if embed_tokens is None and args.vocab_size > 0:
            embed_tokens = nn.Embedding(args.vocab_size, E)
        self.embed_tokens = embed_tokens
        self.layernorm_embedding = RMSNorm(E, eps=args.layernorm_eps) if args.layernorm_embedding else None
        self.dropout_module = nn.Dropout(args.dropout)
        self.layers = nn.ModuleList(
            RetNetDecoderLayer(args, i, is_moe_layer=args.moe_freq != 0 and (i + 1) % args.moe_freq == 0)
            for i in range(args.decoder_layers)
        )
        self.layer_norm = RMSNorm(E, eps=args.layernorm_eps) if args.decoder_normalize_before else None
        if output_projection is None and not args.no_output_layer and args.vocab_size > 0:
            output_projection = nn.Linear(E, args.vocab_size, bias=False)
            if args.share_decoder_input_output_embed:
                output_projection.weight = self.embed_tokens.weight
        self.output_projection = output_projection

    def forward(
        self,
        prev_output_tokens: Optional[torch.Tensor] = None,
        incremental_state: Optional[Dict[Any, Any]] = None,
        features_only: bool = False,
        return_all_hiddens: bool = False,
        token_embeddings: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, Any]:
        args = self.args
        if token_embeddings is None:
            if prev_output_tokens is None:
                raise ValueError("the decoder needs prev_output_tokens or token_embeddings")
            token_embeddings = self.embed_tokens(prev_output_tokens)
        x = self.embed_scale * token_embeddings
        if self.layernorm_embedding is not None:
            x = self.layernorm_embedding(x)
        x = self.dropout_module(x)

        T = x.shape[1]
        decode = incremental_state is not None
        if decode and T != 1:
            raise ValueError(f"the recurrent form takes one token a call, got {T}")
        chunkwise = args.chunkwise_recurrent and not decode
        if chunkwise and T % args.recurrent_chunk_size:
            x = torch.nn.functional.pad(x, (0, 0, 0, args.recurrent_chunk_size - T % args.recurrent_chunk_size))
        slen = x.shape[1]
        position = incremental_state.get("position", 0) if decode else 0
        rel_pos = retnet_rel_pos(
            position + 1 if decode else slen, args.decoder_embed_dim, args.decoder_retention_heads,
            activate_recurrent=decode, chunkwise_recurrent=chunkwise,
            recurrent_chunk_size=args.recurrent_chunk_size, device=x.device,
        )
        inner_states = [x]
        l_aux = []
        for i, layer in enumerate(self.layers):
            state = incremental_state.setdefault(i, {}) if decode else None
            x, aux = layer(x, rel_pos, chunkwise_recurrent=chunkwise, incremental_state=state, generator=generator)
            l_aux.append(aux)
            inner_states.append(x)
        if decode:
            incremental_state["position"] = position + 1
        if chunkwise and slen != T:
            x = x[:, :T]
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
