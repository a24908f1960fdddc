"""Seq2seq wrapper: an :class:`~gigapath_tpu_torch.architecture.encoder.Encoder`
and a :class:`~gigapath_tpu_torch.architecture.decoder.Decoder` whose layers
cross-attend the encoder's output (counterpart of
``gigapath_tpu/architecture/encoder_decoder.py``).

The embeddings are torchscale's constructor arguments; the decoder makes
its own table when it gets none and the config has a vocabulary.
``share_all_embeddings`` ties the decoder's output projection to its input
table, as the JAX package does; the encoder's and the decoder's tables are
one only when the caller passes one module as both (torchscale hands the
decoder the encoder's table itself; the JAX package keeps two).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from gigapath_tpu_torch.architecture.config import EncoderDecoderConfig
from gigapath_tpu_torch.architecture.decoder import Decoder
from gigapath_tpu_torch.architecture.encoder import Encoder


class EncoderDecoder(nn.Module):
    def __init__(self, args: EncoderDecoderConfig, encoder_embed_tokens: Optional[nn.Module] = None,
                 encoder_embed_positions: Optional[nn.Module] = None,
                 decoder_embed_tokens: Optional[nn.Module] = None,
                 decoder_embed_positions: Optional[nn.Module] = None,
                 output_projection: Optional[nn.Module] = None):
        super().__init__()
        self.args = args
        if args.share_all_embeddings:
            args.share_decoder_input_output_embed = True
        self.encoder = Encoder(args, encoder_embed_tokens, encoder_embed_positions, is_encoder_decoder=True)
        self.decoder = Decoder(args, decoder_embed_tokens, decoder_embed_positions, output_projection,
                               is_encoder_decoder=True)

    def forward(
        self,
        src_tokens: Optional[torch.Tensor] = None,
        prev_output_tokens: Optional[torch.Tensor] = None,
        *,
        encoder_token_embeddings: Optional[torch.Tensor] = None,
        decoder_token_embeddings: Optional[torch.Tensor] = None,
        return_all_hiddens: bool = False,
        features_only: bool = False,
        incremental_state: Optional[Dict[int, Dict[str, Any]]] = None,
    ) -> Dict[str, Any]:
        encoder_out = self.encoder(
            encoder_token_embeddings, src_tokens=src_tokens, return_all_hiddens=return_all_hiddens,
            features_only=True,
        )
        return self.decoder(
            prev_output_tokens, encoder_out=encoder_out, incremental_state=incremental_state,
            features_only=features_only, return_all_hiddens=return_all_hiddens,
            token_embeddings=decoder_token_embeddings,
        )
