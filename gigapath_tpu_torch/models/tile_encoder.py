"""ViT-G/14 tile encoder, DINOv2-style (counterpart of
``gigapath_tpu/models/tile_encoder.py``).

The flagship ``gigapath_tile_enc`` is 40 pre-norm blocks at E = 1536, 24
heads, packed SwiGLU 8192 -> 4096 and LayerScale: 1,134,953,984
parameters. Module and parameter names are timm's (``patch_embed.proj``,
``blocks.N.attn.qkv``, ``blocks.N.ls1.gamma``, ``blocks.N.mlp.fc1``, ...),
so a timm ``vit_giant`` state dict of the prov-gigapath shape loads
strictly.

Inputs are NHWC ``[B, H, W, 3]`` images, as in the JAX package. Parameters
are fp32; ``dtype`` is the compute dtype (``None`` = fp32), as a flax
``dtype`` with an fp32 ``param_dtype``: each matmul and the patch conv
cast their weights to it, LayerNorms compute in fp32 and return it,
attention keeps fp32 softmax statistics.

``quant`` (``''``, ``'int8'``, ``'fp8_e4m3'``, optionally ``'+attn'``)
picks the quantized tile tier at construction: the four matmuls of every
block become :class:`~gigapath_tpu_torch.quant.qmatmul.QuantLinear`
(``csrc/q_matmul.cu`` on the card), and ``+attn`` computes the attention
logits from int8 Q and K (``csrc/q_flash_attention.cu``). ``''`` builds
plain ``nn.Linear`` layers and the plain ``attention_with_lse``.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gigapath_tpu_torch.ops.attention import attention_with_lse
from gigapath_tpu_torch.ops.droppath import DropPath
from gigapath_tpu_torch.quant.qflash import q_flash_attention
from gigapath_tpu_torch.quant.qmatmul import QuantLinear, linear
from gigapath_tpu_torch.quant.qtensor import normalize_mode, quant_attn
from gigapath_tpu_torch.utils.device import resolve_device
from gigapath_tpu_torch.utils.registry import create_model_from_registry, register_model

logger = logging.getLogger(__name__)

# ImageNet normalization of the reference's tile transforms
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _dense(in_features: int, out_features: int, quant: str) -> nn.Module:
    """``nn.Linear`` when ``quant`` is empty, else its quantized twin
    (same parameter names and shapes)."""
    if not quant:
        return nn.Linear(in_features, out_features)
    return QuantLinear(in_features, out_features, quant)


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm in fp32 from fp32 parameters, returned in ``x``'s dtype."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps).to(x.dtype)


class PatchEmbedConv(nn.Module):
    """Conv patch embedding (timm ``patch_embed``): [B, H, W, 3] -> [B, N, E]."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 1536):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.proj.weight.to(x.dtype), self.proj.bias.to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=self.proj.stride)
        return y.flatten(2).transpose(1, 2)


class LayerScale(nn.Module):
    """Per-channel learned residual scale (DINOv2 ``ls1``/``ls2``)."""

    def __init__(self, dim: int, init_values: float = 1e-5):
        super().__init__()
        self.init_values = init_values
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class ViTAttention(nn.Module):
    """Packed-qkv multi-head self-attention (timm ``Attention``)."""

    def __init__(self, dim: int, num_heads: int, quant: str = ""):
        super().__init__()
        self.num_heads = num_heads
        self.quant_attn = quant_attn(quant)
        self.qkv = _dense(dim, 3 * dim, quant)
        self.proj = _dense(dim, dim, quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        H = self.num_heads
        qkv = linear(self.qkv, x).reshape(B, N, 3, H, D // H)
        q, k, v = qkv.unbind(2)
        attend = q_flash_attention if self.quant_attn else attention_with_lse
        out, _ = attend(q, k, v)
        return linear(self.proj, out.reshape(B, N, D))


class SwiGLUPacked(nn.Module):
    """Packed SwiGLU MLP: fc1 -> chunk 2 -> silu(x1) * x2 -> fc2 (timm
    ``SwiGLUPacked``)."""

    def __init__(self, dim: int, hidden_dim: int, quant: str = ""):
        super().__init__()
        self.fc1 = _dense(dim, hidden_dim, quant)
        self.fc2 = _dense(hidden_dim // 2, dim, quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = linear(self.fc1, x).chunk(2, dim=-1)
        return linear(self.fc2, F.silu(x1) * x2)


class Mlp(nn.Module):
    """Standard ViT MLP: fc1 -> exact-erf GELU -> fc2 (timm ``Mlp``)."""

    def __init__(self, dim: int, hidden_dim: int, quant: str = ""):
        super().__init__()
        self.fc1 = _dense(dim, hidden_dim, quant)
        self.fc2 = _dense(hidden_dim, dim, quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self.fc2, F.gelu(linear(self.fc1, x)))


class ViTBlock(nn.Module):
    """Pre-norm transformer block with LayerScale and DropPath (timm/DINOv2)."""

    def __init__(self, dim: int, num_heads: int, mlp_hidden_dim: int, *, swiglu: bool = True,
                 init_values: Optional[float] = 1e-5, drop_path: float = 0.0,
                 norm_eps: float = 1e-6, quant: str = ""):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=norm_eps)
        self.attn = ViTAttention(dim, num_heads, quant)
        self.ls1 = LayerScale(dim, init_values) if init_values is not None else None
        self.norm2 = nn.LayerNorm(dim, eps=norm_eps)
        self.mlp = (SwiGLUPacked if swiglu else Mlp)(dim, mlp_hidden_dim, quant)
        self.ls2 = LayerScale(dim, init_values) if init_values is not None else None
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.attn(_layer_norm(self.norm1, x))
        if self.ls1 is not None:
            h = self.ls1(h)
        x = x + self.drop_path(h)
        h = self.mlp(_layer_norm(self.norm2, x))
        if self.ls2 is not None:
            h = self.ls2(h)
        return x + self.drop_path(h)


class VisionTransformer(nn.Module):
    """DINOv2-style ViT: conv patch embed, cls token, learned position
    table, pre-norm blocks and a final LayerNorm.

    ``forward(images [B, H, W, 3]) -> [B, embed_dim]`` (the normed cls token
    for ``global_pool="token"``, the mean of the patch tokens for ``"avg"``);
    :meth:`forward_features` returns every token ``[B, 1 + N, E]``.
    """

    def __init__(
        self,
        img_size: int = 224,
        patch_size: int = 16,
        embed_dim: int = 1536,
        depth: int = 40,
        num_heads: int = 24,
        mlp_ratio: float = 5.33334,
        swiglu: bool = True,
        init_values: Optional[float] = 1e-5,
        drop_path_rate: float = 0.0,
        norm_eps: float = 1e-6,
        global_pool: str = "token",
        quant: str = "",
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.img_size, self.patch_size, self.embed_dim = img_size, patch_size, embed_dim
        self.global_pool = global_pool
        self.quant = normalize_mode(quant)
        self.dtype = dtype or torch.float32
        self.mlp_hidden_dim = int(embed_dim * mlp_ratio)
        self.patch_embed = PatchEmbedConv(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + self.num_patches, embed_dim))
        dpr = np.linspace(0.0, drop_path_rate, depth)
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, num_heads, self.mlp_hidden_dim, swiglu=swiglu, init_values=init_values,
                     drop_path=float(dpr[i]), norm_eps=norm_eps, quant=self.quant)
            for i in range(depth)
        )
        self.norm = nn.LayerNorm(embed_dim, eps=norm_eps)

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size**2

    def init_weights(self, generator: torch.Generator) -> None:
        """Random init from ``generator`` (on the parameters' device):
        Linear and conv weights ~ N(0, 1/fan_in), zero biases, unit
        LayerNorms, LayerScale at its ``init_values``, cls ~ N(0, 1e-6),
        position table ~ N(0, 0.02)."""
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, (nn.Linear, QuantLinear, nn.Conv2d)):
                    fan_in = mod.weight[0].numel()
                    mod.weight.normal_(0.0, fan_in**-0.5, generator=generator)
                    mod.bias.zero_()
                elif isinstance(mod, nn.LayerNorm):
                    mod.weight.fill_(1.0)
                    mod.bias.zero_()
                elif isinstance(mod, LayerScale):
                    mod.gamma.fill_(mod.init_values)
            self.cls_token.normal_(0.0, 1e-6, generator=generator)
            self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x.to(self.dtype))
        B = x.shape[0]
        cls = self.cls_token.to(x.dtype).expand(B, 1, self.embed_dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        for block in self.blocks:
            x = block(x)
        return _layer_norm(self.norm, x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.forward_features(x)
        if self.global_pool == "avg":
            return x[:, 1:].mean(dim=1)
        return x[:, 0]


# ---------------------------------------------------------------------------
# the position table at another grid
# ---------------------------------------------------------------------------


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """The Keys cubic kernel with a = -0.5."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    """[n_in, n_out] fp32 weights of ``jax.image.resize(method="bicubic")``
    along one axis: half-pixel centres, the kernel widened by the inverse
    scale when downsampling (antialiasing), each column normalized."""
    f32 = torch.float32
    inv_scale = torch.tensor(1.0 / (n_out / n_in), dtype=f32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(n_out, dtype=f32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(n_in, dtype=f32)[:, None]).abs() / kernel_scale
    weights = _keys_cubic(x)
    total = weights.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    weights = torch.where(total.abs() > eps, weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def interpolate_pos_embed(pos_embed, new_grid: int) -> torch.Tensor:
    """Resize a [1, 1 + g*g, D] position table to [1, 1 + new_grid^2, D].

    The JAX package resizes with ``jax.image.resize(..., "bicubic")`` (the
    Keys kernel with a = -0.5, half-pixel centres, antialiased when
    downsampling), and this computes the same; torch's
    ``F.interpolate(mode="bicubic")`` uses a = -0.75 and does not match."""
    pos_embed = torch.as_tensor(pos_embed)
    n_tok = pos_embed.shape[1] - 1
    g = math.isqrt(n_tok)
    if g * g != n_tok:
        raise ValueError(f"pos_embed patch count {n_tok} is not square")
    if g == new_grid:
        return pos_embed
    cls, patches = pos_embed[:, :1], pos_embed[:, 1:]
    D = patches.shape[-1]
    grid = patches.reshape(g, g, D).float()
    w = _resize_weights(g, new_grid).to(grid.device)
    resized = torch.einsum("ijd,ia,jb->abd", grid, w, w).reshape(1, new_grid * new_grid, D)
    return torch.cat([cls, resized.to(pos_embed.dtype)], dim=1)


# ---------------------------------------------------------------------------
# registry and factory
# ---------------------------------------------------------------------------


@register_model
def gigapath_tile_enc(**kwargs) -> VisionTransformer:
    """The prov-gigapath ViT-G/14 tile encoder (1,134,953,984 parameters)."""
    defaults = dict(img_size=224, patch_size=16, embed_dim=1536, depth=40, num_heads=24,
                    mlp_ratio=5.33334, swiglu=True, init_values=1e-5)
    return VisionTransformer(**{**defaults, **kwargs})


@register_model
def vit_tile_enc_test(**kwargs) -> VisionTransformer:
    """Tiny smoke-test tile encoder."""
    defaults = dict(img_size=32, patch_size=16, embed_dim=32, depth=2, num_heads=4,
                    mlp_ratio=4.0, swiglu=True, init_values=1e-5)
    return VisionTransformer(**{**defaults, **kwargs})


def load_timm_state_dict(model: VisionTransformer, state: Dict[str, torch.Tensor]) -> Tuple[list, list]:
    """Non-strict load of a timm-named state dict: the classifier ``head.*``
    and ``mask_token`` are skipped, a position table at another grid is
    resized (:func:`interpolate_pos_embed`), and a tensor of another shape
    counts as unexpected. Returns ``(missing_keys, unexpected_keys)``."""
    own = model.state_dict()
    picked, unexpected = {}, []
    for key, value in state.items():
        if key.startswith("head.") or key == "mask_token":
            continue
        value = torch.as_tensor(value)
        if key == "pos_embed" and tuple(value.shape) != tuple(own[key].shape):
            value = interpolate_pos_embed(value, model.grid_size)
        if key not in own or tuple(own[key].shape) != tuple(value.shape):
            unexpected.append(key)
            continue
        picked[key] = value
    missing = [k for k in own if k not in picked]
    model.load_state_dict(picked, strict=False)
    return missing, unexpected


def create_tile_encoder(
    pretrained: str = "",
    model_arch: str = "gigapath_tile_enc",
    *,
    device: Optional[Union[str, torch.device]] = None,
    quant: Optional[str] = None,
    generator: Optional[torch.Generator] = None,
    **kwargs,
) -> VisionTransformer:
    """Build the tile encoder in eval mode on ``device`` (``cuda`` unless
    the caller passes ``device="cpu"``; raises when neither is possible).

    ``quant`` pins the tier; ``None`` reads ``GIGAPATH_QUANT_TILE`` once,
    here (the JAX factory's plan seam resolves the same variable, its plan
    registry having no ``tile_encoder.*`` entry). Weights are random from
    ``generator`` (a ``torch.Generator`` on the target device; seed 0 when
    none is given). ``pretrained`` may be a quantized artifact directory
    (``manifest.json``; verified, then dequantized), or a timm ``.pth``;
    either loads non-strictly with the missing and unexpected keys
    reported. ``kwargs`` go to the architecture (``dtype``, ``global_pool``,
    ...)."""
    dev = resolve_device(device)
    if quant is None:
        quant = os.environ.get("GIGAPATH_QUANT_TILE", "")
    with torch.device("meta"):
        model = create_model_from_registry(model_arch, quant=normalize_mode(quant), **kwargs)
    model = model.to_empty(device=dev)
    model.init_weights(generator if generator is not None else torch.Generator(device=dev).manual_seed(0))
    if pretrained and os.path.isdir(pretrained) and os.path.exists(os.path.join(pretrained, "manifest.json")):
        from gigapath_tpu_torch.quant.convert import dequantize_params, load_quantized
        from gigapath_tpu_torch.utils.convert import state_dict_from_flax_params

        qparams, meta = load_quantized(pretrained)
        state = state_dict_from_flax_params(dequantize_params(qparams))
        missing, unexpected = load_timm_state_dict(model, state)
        logger.warning(
            "loaded quantized tile-encoder artifact from %s (mode=%s, %s quantized kernels, "
            "%d missing, %d unexpected keys): missing=%s unexpected=%s",
            pretrained, meta.get("mode"), meta.get("n_quantized"), len(missing), len(unexpected),
            missing, unexpected,
        )
    elif pretrained and os.path.exists(pretrained):
        from gigapath_tpu_torch.utils.convert import load_torch_state_dict

        missing, unexpected = load_timm_state_dict(model, load_torch_state_dict(pretrained))
        logger.warning(
            "loaded tile encoder from %s (%d missing, %d unexpected keys): missing=%s unexpected=%s",
            pretrained, len(missing), len(unexpected), missing, unexpected,
        )
    elif pretrained:
        logger.warning("tile-encoder weights not found at %s; the model is randomly initialized", pretrained)
    return model.eval()


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())

