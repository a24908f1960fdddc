"""Slide-level inference entry (counterpart of ``gigapath_tpu/pipeline.py``)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from gigapath_tpu_torch.models.slide_encoder import LongNetViT


@torch.inference_mode()
def run_inference_with_slide_encoder(
    tile_embeds,
    coords,
    slide_encoder_model: LongNetViT,
    *,
    pad_mask=None,
) -> Dict[str, np.ndarray]:
    """All-layer slide embeddings from tile embeddings.

    ``tile_embeds`` [N, C] or [B, N, C] and ``coords`` [N, 2] or [B, N, 2]
    (numpy arrays or tensors) move to the model's device; ``pad_mask``
    [B, N] (True = valid tile) marks suffix padding in a ragged batch. The
    embeddings are rounded through bf16 before the model's dtype, as the
    JAX entry does. Returns ``layer_{i}_embed`` for the input embedding and
    every layer, plus ``last_layer_embed``, as fp32 numpy arrays.
    """
    param = next(slide_encoder_model.parameters())
    device, dtype = param.device, param.dtype
    tile_embeds = torch.as_tensor(tile_embeds).to(device)
    coords = torch.as_tensor(coords).to(device=device, dtype=torch.float32)
    if tile_embeds.ndim == 2:
        tile_embeds, coords = tile_embeds[None], coords[None]
    x = tile_embeds.to(torch.bfloat16).to(dtype)
    mask: Optional[torch.Tensor] = None
    if pad_mask is not None:
        mask = torch.as_tensor(pad_mask).to(device=device, dtype=torch.bool)
    slide_embeds = slide_encoder_model(x, coords, all_layer_embed=True, pad_mask=mask)
    outputs = {
        f"layer_{i}_embed": e.float().cpu().numpy() for i, e in enumerate(slide_embeds)
    }
    outputs["last_layer_embed"] = outputs[f"layer_{len(slide_embeds) - 1}_embed"]
    return outputs
