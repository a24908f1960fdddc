"""LongNetViT slide encoder + factory (counterpart of
``gigapath_tpu/models/slide_encoder.py``).

A ViT over tile *embeddings*: linear patch embed (in_chans -> D), 2-D sincos
position from the tile coords, a cls token, a LongNet encoder, and a cls or
global-pool readout per selected layer. Key names are the reference
torchscale ones, so a reference ``slide_encoder.pth`` loads as it is.

The sincos table is never materialized (:mod:`..ops.pos_embed`), and the
sequence is not padded: the JAX package pads the internal length to a
multiple of 128 for the TPU's tiling, with the pad masked exactly, so the
math is the same as here.
"""

from __future__ import annotations

import logging
import math
import os
from typing import List, Optional, Union

import numpy as np
import torch
from torch import nn

from gigapath_tpu_torch.models.longnet import make_longnet_from_name
from gigapath_tpu_torch.ops.pos_embed import coords_to_pos, pos_embed_for_coords
from gigapath_tpu_torch.utils.convert import load_torch_state_dict
from gigapath_tpu_torch.utils.device import resolve_device
from gigapath_tpu_torch.utils.registry import create_model_from_registry, register_model

logger = logging.getLogger(__name__)


class PatchEmbed(nn.Module):
    """Linear projection of tile embeddings."""

    def __init__(self, in_chans: int = 1536, embed_dim: int = 768):
        super().__init__()
        self.proj = nn.Linear(in_chans, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


def get_optimal_segment_length(max_wsi_size: int = 262144, tile_size: int = 256) -> List[int]:
    """Log2-spaced 5-segment schedule from the max WSI size."""
    max_seq_len = (max_wsi_size // tile_size) ** 2
    exponents = np.linspace(np.log2(1024), int(np.log2(max_seq_len)), 5)
    return [int(x) for x in np.power(2, exponents).astype(int)]


class LongNetViT(nn.Module):
    """Slide encoder over ``(tile_embeddings [B, N, in_chans], coords [B, N, 2])``.

    ``forward`` returns a list of slide embeddings, each ``[B, embed_dim]``:
    one per hidden state (the input embedding and every layer) when
    ``all_layer_embed``, else just the final one. It trains through
    ``model.train()`` (dropout and drop-path act only then);
    ``checkpoint_activations`` re-runs each encoder layer in the backward
    instead of keeping its activations. ``model_group`` makes the encoder's
    attention and FFNs tensor-parallel over that process group
    (``models/longnet.py:make_longnet_from_name``); the patch embed, the
    cls token, the norms and the head stay whole on every rank.
    """

    def __init__(
        self,
        in_chans: int = 1536,
        embed_dim: int = 768,
        depth: int = 12,
        slide_ngrids: int = 1000,
        tile_size: int = 256,
        max_wsi_size: int = 262144,
        global_pool: bool = False,
        dropout: float = 0.25,
        drop_path_rate: float = 0.1,
        norm_eps: float = 1e-6,
        mlp_ratio: float = 4.0,
        segment_length: Optional[List[int]] = None,
        dilated_ratio: str = "[1, 2, 4, 8, 16]",
        checkpoint_activations: bool = False,
        model_group=None,
    ):
        super().__init__()
        self.embed_dim = embed_dim
        self.slide_ngrids = slide_ngrids
        self.tile_size = tile_size
        self.global_pool = global_pool
        self.patch_embed = PatchEmbed(in_chans, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        name = f"LongNet_{depth}_layers_{embed_dim}_dim"
        if mlp_ratio != 4.0:
            name += f"_mlp{mlp_ratio:g}"
        segment_length = segment_length or get_optimal_segment_length(max_wsi_size, tile_size)
        self.encoder, _ = make_longnet_from_name(
            name,
            dilated_ratio=dilated_ratio,
            segment_length=list(segment_length),
            drop_path_rate=drop_path_rate,
            dropout=dropout,
            checkpoint_activations=checkpoint_activations,
            model_group=model_group,
        )
        self.norm = nn.LayerNorm(embed_dim, eps=norm_eps)

    def coords_to_pos(self, coords: torch.Tensor) -> torch.Tensor:
        return coords_to_pos(coords, self.tile_size, self.slide_ngrids)

    def init_weights(self, generator: torch.Generator) -> None:
        """Random init from ``generator``: xavier-uniform Linear weights, zero
        biases, unit LayerNorms, cls token ~ N(0, 0.02). Call on a module
        that lives on the CPU (the generator is a CPU one)."""
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, nn.Linear):
                    fan_out, fan_in = mod.weight.shape
                    bound = math.sqrt(6.0 / (fan_in + fan_out))
                    mod.weight.uniform_(-bound, bound, generator=generator)
                    mod.bias.zero_()
                elif isinstance(mod, nn.LayerNorm):
                    mod.weight.fill_(1.0)
                    mod.bias.zero_()
            self.cls_token.normal_(0.0, 0.02, generator=generator)

    def forward(
        self,
        x: torch.Tensor,
        coords: torch.Tensor,
        all_layer_embed: bool = False,
        pad_mask: Optional[torch.Tensor] = None,
    ) -> List[torch.Tensor]:
        """``pad_mask``: optional [B, N] bool, True = VALID tile, padding as a
        suffix. Padded tiles are zeroed, excluded from every attention
        branch's keys, and excluded from the global-pool mean."""
        B = x.shape[0]
        x = self.patch_embed(x)
        x = x + pos_embed_for_coords(self.embed_dim, coords, self.tile_size, self.slide_ngrids).to(x.dtype)
        # the cls row of the position table is zeros, so cls = cls_token
        cls = self.cls_token.to(x.dtype).expand(B, 1, self.embed_dim)
        x = torch.cat([cls, x], dim=1)

        encoder_padding_mask = None
        if pad_mask is not None:
            pad_mask = pad_mask.to(torch.bool)
            encoder_padding_mask = torch.cat(
                [torch.zeros((B, 1), dtype=torch.bool, device=x.device), ~pad_mask], dim=1
            )
        def readout(h: torch.Tensor) -> torch.Tensor:  # [B, L, E] -> [B, E], before the norm
            if not self.global_pool:
                return h[:, 0].clone()  # a copy: a view would keep the whole state alive
            if pad_mask is not None:
                valid = pad_mask.to(h.dtype)[..., None]
                return (h[:, 1:] * valid).sum(dim=1) / valid.sum(dim=1).clamp_min(1.0)
            return h[:, 1:].mean(dim=1)

        # each layer's state is reduced as soon as it is made, so the
        # forward never holds the 13 full states at once
        out = self.encoder(
            token_embeddings=x,
            encoder_padding_mask=encoder_padding_mask,
            return_all_hiddens=all_layer_embed,
            state_readout=readout,
        )
        x_list = out["encoder_states"] if all_layer_embed else [readout(out["encoder_out"])]
        return [self.norm(h) for h in x_list]


def _arch(defaults: dict, kwargs: dict) -> LongNetViT:
    return LongNetViT(**{**defaults, **kwargs})


@register_model
def gigapath_slide_enc12l768d(**kwargs):
    return _arch(dict(embed_dim=768, depth=12, mlp_ratio=4.0, norm_eps=1e-6), kwargs)


@register_model
def gigapath_slide_enc24l1024d(**kwargs):
    return _arch(dict(embed_dim=1024, depth=24, mlp_ratio=4.0, norm_eps=1e-6), kwargs)


@register_model
def gigapath_slide_enc12l1536d(**kwargs):
    return _arch(dict(embed_dim=1536, depth=12, mlp_ratio=4.0, norm_eps=1e-6), kwargs)


@register_model
def gigapath_slide_enc_tiny(**kwargs):
    """2-layer/32-dim smoke-test arch."""
    return _arch(
        dict(
            embed_dim=32, depth=2, mlp_ratio=2.0, norm_eps=1e-6,
            segment_length=[16, 32], dilated_ratio="[1, 2]",
        ),
        kwargs,
    )


def load_pretrained(model: LongNetViT, path: str):
    """Non-strict load of a reference ``slide_encoder.pth`` into ``model``.

    The ``pos_embed`` buffer is skipped (computed from coords here);
    tensors whose shape does not match count as unexpected. Returns
    ``(missing_keys, unexpected_keys)``.
    """
    own = model.state_dict()
    state, unexpected = {}, []
    for key, value in load_torch_state_dict(path).items():
        key = key.replace("_checkpoint_wrapped_module.", "")
        if key.startswith("pos_embed"):
            continue
        if key not in own or tuple(own[key].shape) != tuple(value.shape):
            unexpected.append(key)
            continue
        state[key] = value
    missing = [k for k in own if k not in state]
    model.load_state_dict(state, strict=False)
    return missing, unexpected


def create_streaming_session(
    model: LongNetViT,
    n_tiles: int,
    *,
    chunk_tiles: Optional[int] = None,
    all_layer_embed: bool = False,
):
    """The chunk-granular ``LongNetViT`` entry (streaming chunked prefill): a
    :class:`~gigapath_tpu_torch.models.streaming_encoder.StreamingEncoderSession`
    whose ``feed(idx, tile_embeds, coords)`` takes the chunk plan in any
    arrival order and whose ``finalize()`` returns the same output list as
    ``model(x, coords, all_layer_embed=...)``, which stays the dense fallback
    and oracle. ``chunk_tiles`` defaults to ``GIGAPATH_PREFILL_CHUNK``."""
    from gigapath_tpu_torch.models.streaming_encoder import StreamingEncoderSession

    return StreamingEncoderSession(
        model, n_tiles, chunk_tiles=chunk_tiles, all_layer_embed=all_layer_embed,
    )


def create_model(
    pretrained: str = "",
    model_arch: str = "gigapath_slide_enc12l768d",
    in_chans: int = 1536,
    *,
    device: Optional[Union[str, torch.device]] = None,
    dtype: Optional[torch.dtype] = None,
    seed: int = 0,
    **kwargs,
) -> LongNetViT:
    """Build a slide encoder in eval mode on ``device`` (``cuda`` unless the
    caller passes ``device="cpu"``; raises when neither is possible).

    Weights are random from ``seed``; a local ``pretrained`` path loads
    non-strictly with the missing and unexpected keys reported. ``dtype``
    casts the parameters (e.g. ``torch.bfloat16``).
    """
    dev = resolve_device(device)
    model = create_model_from_registry(model_arch, in_chans=in_chans, **kwargs)
    model.init_weights(torch.Generator().manual_seed(seed))
    if pretrained and os.path.exists(pretrained):
        missing, unexpected = load_pretrained(model, pretrained)
        logger.warning(
            "loaded slide encoder from %s (%d missing, %d unexpected keys): missing=%s unexpected=%s",
            pretrained, len(missing), len(unexpected), missing, unexpected,
        )
    elif pretrained:
        logger.warning("pretrained weights not found at %s; the model is randomly initialized", pretrained)
    return model.to(device=dev, dtype=dtype).eval()
