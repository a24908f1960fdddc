"""BEiT-3, the multiway vision-language encoder (counterpart of
``gigapath_tpu/models/beit3.py``).

A text embedding, a conv vision embedding (mask token, cls prepended), a
multiway pair of learned position tables (vision positions and text
positions, both from the fairseq offset 2) and a multiway
:class:`~gigapath_tpu_torch.architecture.encoder.Encoder`, split at the
vision token count (cls + patches). Images are ``[B, C, H, W]``. Key
names are torchscale's: ``text_embed``, ``vision_embed``, and the position
tables inside the encoder, ``encoder.embed_positions.A`` / ``.B`` (the JAX
package keeps them beside the encoder; ``state_dict_from_flax_params``
moves them). Unused by the gigapath pipeline, as in the reference.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from gigapath_tpu_torch.architecture.config import EncoderConfig
from gigapath_tpu_torch.architecture.encoder import Encoder
from gigapath_tpu_torch.ops.embedding import PositionalEmbedding, TextEmbedding, VisionEmbedding
from gigapath_tpu_torch.ops.multiway import MultiwayNetwork


class MultiwayPositionalEmbedding(MultiwayNetwork):
    """Position tables A (the vision span) and B (the text span), each
    numbering its own span from 2; explicit ``positions`` are split with
    the tokens."""

    def __init__(self, num_a: int, num_b: int, embed_dim: int):
        nn.Module.__init__(self)
        self.dim = 1
        self.A = PositionalEmbedding(num_a, embed_dim)
        self.B = PositionalEmbedding(num_b, embed_dim)

    def forward(self, x: torch.Tensor, positions: Optional[torch.Tensor] = None, split_position: int = -1):
        if split_position == -1:
            return self.A(x, positions)
        if split_position == 0:
            return self.B(x, positions)
        p1 = p2 = None
        if positions is not None:
            p1, p2 = positions[:, :split_position], positions[:, split_position:]
        return torch.cat([self.A(x[:, :split_position], p1), self.B(x[:, split_position:], p2)], dim=1)


class BEiT3(nn.Module):
    def __init__(self, args: EncoderConfig):
        super().__init__()
        if not args.multiway or args.vocab_size <= 0 or args.share_encoder_input_output_embed:
            raise ValueError("BEiT-3 needs multiway, a vocabulary and no shared output embedding")
        if not args.no_scale_embedding:
            # positions are added before the scale; the reference's default keeps the orders alike
            raise ValueError("BEiT-3 needs no_scale_embedding")
        self.args = args
        E = args.encoder_embed_dim
        self.text_embed = TextEmbedding(args.vocab_size, E)
        self.vision_embed = VisionEmbedding(args.img_size, args.patch_size, args.in_chans, E,
                                            contain_mask_token=True, prepend_cls_token=True)
        positions = MultiwayPositionalEmbedding(self.vision_embed.num_position_embeddings() + 2,
                                                args.max_source_positions, E)
        self.encoder = Encoder(args, embed_positions=positions)

    def forward(
        self,
        textual_tokens: Optional[torch.Tensor] = None,
        visual_tokens: Optional[torch.Tensor] = None,
        text_padding_position: Optional[torch.Tensor] = None,
        attn_mask: Optional[torch.Tensor] = None,
        vision_masked_position: Optional[torch.Tensor] = None,
        positions: Optional[torch.Tensor] = None,
    ) -> Dict[str, Any]:
        if textual_tokens is None and visual_tokens is None:
            raise ValueError("BEiT-3 needs textual_tokens or visual_tokens")
        if textual_tokens is None:
            x = self.vision_embed(visual_tokens, vision_masked_position)
            encoder_padding_mask = None
            split = -1
        elif visual_tokens is None:
            x = self.text_embed(textual_tokens)
            encoder_padding_mask = text_padding_position
            split = 0
        else:
            x1 = self.vision_embed(visual_tokens, vision_masked_position)
            split = x1.shape[1]
            x = torch.cat([x1, self.text_embed(textual_tokens)], dim=1)
            encoder_padding_mask = None
            if text_padding_position is not None:
                encoder_padding_mask = torch.cat(
                    [torch.zeros(x1.shape[:-1], dtype=torch.bool, device=x1.device),
                     text_padding_position.to(torch.bool)], dim=1)
        out = self.encoder(
            x, encoder_padding_mask, attn_mask=attn_mask, multiway_split_position=split, positions=positions,
            features_only=True,
        )
        out["multiway_split_position"] = split
        return out
