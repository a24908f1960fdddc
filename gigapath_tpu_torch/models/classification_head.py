"""Slide-level classification head (counterpart of
``gigapath_tpu/models/classification_head.py``).

The slide encoder's selected per-layer embeddings (``feat_layer`` "5-11" ->
entries 5 and 11 of the all-layer output list) are concatenated and go
through one linear classifier. ``state_dict`` keys start with
``slide_encoder.`` and ``classifier.``. Freezing the encoder is the
optimizer's business (its frozen group, :mod:`..finetune.utils`), as in the
JAX package.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Union

import torch
from torch import nn

from gigapath_tpu_torch.models.slide_encoder import load_pretrained  # importing it registers the archs
from gigapath_tpu_torch.utils.device import resolve_device
from gigapath_tpu_torch.utils.registry import create_model_from_registry

logger = logging.getLogger(__name__)


def parse_feat_layer(feat_layer: str) -> List[int]:
    return [int(x) for x in str(feat_layer).split("-")]


class ClassificationHead(nn.Module):
    def __init__(
        self,
        input_dim: int = 1536,
        latent_dim: int = 768,
        feat_layer: str = "11",
        n_classes: int = 2,
        model_arch: str = "gigapath_slide_enc12l768d",
        global_pool: bool = False,
        **slide_kwargs,
    ):
        super().__init__()
        self.feat_layer = parse_feat_layer(feat_layer)
        self.latent_dim = latent_dim
        self.slide_encoder = create_model_from_registry(
            model_arch, in_chans=input_dim, global_pool=global_pool, **slide_kwargs
        )
        self.classifier = nn.Linear(len(self.feat_layer) * latent_dim, n_classes)

    def forward(
        self,
        images: torch.Tensor,
        coords: torch.Tensor,
        pad_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """``images`` [B, N, input_dim] (or [N, input_dim]), ``coords`` [B, N,
        2], ``pad_mask`` [B, N] True = valid tile -> logits [B, n_classes]."""
        if images.ndim == 2:
            images, coords = images[None], coords[None]
        embeds = self.slide_encoder(images, coords, all_layer_embed=True, pad_mask=pad_mask)
        h = torch.cat([embeds[i] for i in self.feat_layer], dim=-1)
        if h.shape[-1] != len(self.feat_layer) * self.latent_dim:
            raise ValueError(
                f"feat dim {h.shape[-1]} != {len(self.feat_layer)} layers x latent_dim "
                f"{self.latent_dim}; latent_dim must match the slide encoder width"
            )
        return self.classifier(h.reshape(-1, h.shape[-1]))


def get_model(
    *,
    input_dim: int = 1536,
    latent_dim: int = 768,
    feat_layer: str = "11",
    n_classes: int = 2,
    model_arch: str = "gigapath_slide_enc12l768d",
    pretrained: str = "",
    freeze: bool = False,
    global_pool: bool = False,
    device: Optional[Union[str, torch.device]] = None,
    seed: int = 0,
    **kwargs,
) -> ClassificationHead:
    """The head on ``device`` (``cuda`` unless the caller passes
    ``device="cpu"``), in training mode, fp32 parameters. Weights are random
    from ``seed`` (the encoder as :meth:`LongNetViT.init_weights`, the
    classifier ~ N(0, 1/fan_in), zero bias); a local ``pretrained`` slide
    encoder loads non-strictly into ``slide_encoder``. ``freeze`` is applied
    by the optimizer's frozen group."""
    dev = resolve_device(device)
    model = ClassificationHead(
        input_dim=input_dim, latent_dim=latent_dim, feat_layer=feat_layer,
        n_classes=n_classes, model_arch=model_arch, global_pool=global_pool, **kwargs,
    )
    gen = torch.Generator().manual_seed(seed)
    model.slide_encoder.init_weights(gen)
    with torch.no_grad():
        model.classifier.weight.normal_(0.0, model.classifier.in_features**-0.5, generator=gen)
        model.classifier.bias.zero_()
    if pretrained and os.path.exists(pretrained):
        missing, unexpected = load_pretrained(model.slide_encoder, pretrained)
        logger.info(
            "Loaded pretrained slide encoder from %s (%d missing, %d unexpected)",
            pretrained, len(missing), len(unexpected),
        )
    elif pretrained:
        logger.warning("Pretrained weights not found at %s", pretrained)
    if freeze:
        logger.info("Freezing is applied at the optimizer: the slide encoder's frozen group")
    return model.to(dev).train()
