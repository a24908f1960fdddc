"""Embeddings: vision patches, text, learned positions, and their fused
vision-language pair (counterpart of ``gigapath_tpu/ops/embedding.py``).

Key names are torchscale's (``proj``, ``mask_token``, ``cls_token``,
``weight``). Images are ``[B, C, H, W]``, PyTorch's layout (the JAX
package takes NHWC). :class:`PositionalEmbedding` keeps the fairseq
convention: default positions are ``2..L+1``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class VisionEmbedding(nn.Module):
    """Image ``[B, C, H, W]`` -> patch tokens ``[B, (1+)N, D]``."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, in_chans: int = 3, embed_dim: int = 768,
                 contain_mask_token: bool = False, prepend_cls_token: bool = False):
        super().__init__()
        self.img_size = img_size
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.num_patches = (img_size // patch_size) ** 2
        self.proj = nn.Conv2d(in_chans, embed_dim, kernel_size=patch_size, stride=patch_size)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, embed_dim)) if contain_mask_token else None
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim)) if prepend_cls_token else None

    def num_position_embeddings(self) -> int:
        return self.num_patches + (1 if self.cls_token is not None else 0)

    def forward(self, x: torch.Tensor, masked_position: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, _, H, W = x.shape
        if H != self.img_size or W != self.img_size:
            raise ValueError(f"Input image size ({H}*{W}) doesn't match model ({self.img_size}*{self.img_size}).")
        x = self.proj(x).flatten(2).transpose(1, 2)
        if masked_position is not None:
            if self.mask_token is None:
                raise ValueError("masked_position needs contain_mask_token=True")
            w = masked_position[..., None].to(x.dtype)
            x = x * (1 - w) + self.mask_token.to(x.dtype) * w
        if self.cls_token is not None:
            x = torch.cat([self.cls_token.to(x.dtype).expand(B, 1, self.embed_dim), x], dim=1)
        return x


class TextEmbedding(nn.Embedding):
    """Token embedding drawn from normal(std = D**-0.5)."""

    def reset_parameters(self) -> None:
        nn.init.normal_(self.weight, mean=0.0, std=self.embedding_dim**-0.5)
        self._fill_padding_idx_with_zero()


class PositionalEmbedding(nn.Embedding):
    """Learned position table; default positions ``2..L+1`` for ``x [B, L,
    ...]``."""

    def forward(self, x: torch.Tensor, positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        if positions is None:
            positions = torch.arange(2, x.shape[1] + 2, device=x.device)[None, :]
        return F.embedding(positions, self.weight)


class VisionLanguageEmbedding(nn.Module):
    """Vision tokens, then text tokens, along the length."""

    def __init__(self, text_embed: nn.Module, vision_embed: nn.Module):
        super().__init__()
        self.text_embed = text_embed
        self.vision_embed = vision_embed

    def forward(self, textual_tokens: Optional[torch.Tensor], visual_tokens: Optional[torch.Tensor]) -> torch.Tensor:
        if textual_tokens is None:
            return self.vision_embed(visual_tokens)
        if visual_tokens is None:
            return self.text_embed(textual_tokens)
        return torch.cat([self.vision_embed(visual_tokens), self.text_embed(textual_tokens)], dim=1)
