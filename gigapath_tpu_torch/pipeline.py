"""The two-stage inference entry: tiles -> tile encoder -> slide encoder
(counterpart of ``gigapath_tpu/pipeline.py``).

- :func:`load_tile_encoder_transforms` and :func:`load_tile_slide_encoder`
  build the tile transform and both encoders;
- :func:`run_inference_with_tile_encoder` embeds a list of PNG tiles in
  fixed-size batches;
- :func:`run_inference_with_slide_encoder` turns the tile embeddings and
  their coordinates into all-layer slide embeddings;
- :func:`run_inference_with_slide_encoder_streaming` does the same from a
  stream of tile-embedding chunks (streaming chunked prefill), never
  building the slide's tile sequence.

Slide tiling (``tile_one_slide``, OpenSlide) is not ported yet.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from gigapath_tpu_torch.data.tile_dataset import TileEncodingDataset
from gigapath_tpu_torch.data.transforms import preprocess_tile
from gigapath_tpu_torch.models.slide_encoder import LongNetViT, create_model
from gigapath_tpu_torch.models.tile_encoder import VisionTransformer, count_params, create_tile_encoder

logger = logging.getLogger(__name__)


def load_tile_encoder_transforms(crop_size: int = 224):
    """The tile transform (resize-256 bicubic, center-crop 224, ImageNet
    normalize) as a callable on PIL images or uint8 arrays."""
    return lambda img: preprocess_tile(img, crop_size=crop_size)


def load_tile_slide_encoder(
    local_tile_encoder_path: str = "",
    local_slide_encoder_path: str = "",
    global_pool: bool = False,
    *,
    device: Optional[Union[str, torch.device]] = None,
):
    """Both encoders, bf16, in eval mode on ``device`` (``cuda`` unless the
    caller passes ``device="cpu"``): ``(tile_encoder, slide_encoder)``.

    The tile encoder's quant tier comes from ``GIGAPATH_QUANT_TILE``, read
    once by :func:`create_tile_encoder`. Paths that do not exist leave the
    weights random (with a warning), as the JAX entry does."""
    tile_encoder = create_tile_encoder(local_tile_encoder_path, device=device, dtype=torch.bfloat16)
    logger.warning("tile encoder param # %d", count_params(tile_encoder))
    slide_encoder = create_model(
        local_slide_encoder_path, "gigapath_slide_enc12l768d", 1536,
        device=device, dtype=torch.bfloat16, global_pool=global_pool,
    )
    logger.warning("slide encoder param # %d", count_params(slide_encoder))
    return tile_encoder, slide_encoder


@torch.inference_mode()
def run_inference_with_tile_encoder(
    image_paths: List[str], tile_encoder: VisionTransformer, batch_size: int = 128,
) -> Dict[str, np.ndarray]:
    """Embed tiles in fixed ``batch_size`` batches -> ``{"tile_embeds" [N,
    E] fp32, "coords" [N, 2] fp32}``.

    Each batch moves to the model's device as bf16 (the JAX entry's
    ``jnp.asarray(imgs, jnp.bfloat16)``) and then to the model's compute
    dtype; the last partial batch is padded with zeros to ``batch_size``
    and sliced back, as in the JAX entry."""
    device = next(tile_encoder.parameters()).device
    dataset = TileEncodingDataset(
        image_paths, transform=load_tile_encoder_transforms(crop_size=tile_encoder.img_size)
    )
    embeds, coords = [], []
    for start in range(0, len(dataset), batch_size):
        samples = [dataset[i] for i in range(start, min(start + batch_size, len(dataset)))]
        imgs = np.stack([s["img"] for s in samples])
        n = imgs.shape[0]
        if n < batch_size:
            imgs = np.concatenate([imgs, np.zeros((batch_size - n, *imgs.shape[1:]), imgs.dtype)])
        x = torch.from_numpy(imgs).to(device=device, dtype=torch.bfloat16)
        out = tile_encoder(x.to(tile_encoder.dtype))
        embeds.append(out[:n].float().cpu().numpy())
        coords.append(np.stack([s["coords"] for s in samples]))
    return {
        "tile_embeds": np.concatenate(embeds),
        "coords": np.concatenate(coords).astype(np.float32),
    }


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


def run_inference_with_slide_encoder_streaming(
    chunks,
    n_tiles: int,
    slide_encoder_model: LongNetViT,
    *,
    chunk_tiles: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Streaming twin of :func:`run_inference_with_slide_encoder`.

    ``chunks`` is any iterable of ``(chunk_idx, tile_embeds [c, C], coords
    [c, 2])`` triples, or of objects with ``chunk_id``, ``payload`` and
    ``coords``, cut by the plan ``chunk_bounds(n_tiles, chunk_tiles)``, in
    any arrival order. Each chunk is rounded through bf16 (as the dense entry
    rounds its input) and folds into the encoder as it arrives. Returns the
    same ``layer_{i}_embed`` / ``last_layer_embed`` dict as the dense entry,
    which stays the fallback and oracle."""
    from gigapath_tpu_torch.models.streaming_encoder import StreamingEncoderSession, embeds_to_outputs
    from gigapath_tpu_torch.quant.qtensor import bf16_round_trip

    session = StreamingEncoderSession(
        slide_encoder_model, int(n_tiles), chunk_tiles=chunk_tiles, all_layer_embed=True,
    )
    for item in chunks:
        if hasattr(item, "chunk_id"):
            session.feed(item.chunk_id, bf16_round_trip(item.payload), item.coords)
        else:
            idx, embeds, coords = item
            session.feed(idx, bf16_round_trip(embeds), coords)
    return embeds_to_outputs(session.finalize())
