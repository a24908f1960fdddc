"""Host-side tile image transforms (counterpart of
``gigapath_tpu/data/transforms.py``).

The reference's tile transform: resize the shorter side to 256 (bicubic),
center-crop 224, scale to [0, 1] and ImageNet-normalize. The result is an
fp32 NHWC array, the tile encoder's input layout. PIL is imported inside
the functions that use it.
"""

from __future__ import annotations

import numpy as np

from gigapath_tpu_torch.models.tile_encoder import IMAGENET_MEAN, IMAGENET_STD


def resize_shorter_side(img, size: int = 256):
    """PIL resize so the shorter side equals ``size`` (torchvision
    ``Resize(256)`` semantics), bicubic."""
    from PIL import Image

    w, h = img.size
    if w <= h:
        new_w, new_h = size, max(1, round(h * size / w))
    else:
        new_w, new_h = max(1, round(w * size / h)), size
    return img.resize((new_w, new_h), Image.BICUBIC)


def center_crop(arr: np.ndarray, size: int = 224) -> np.ndarray:
    """Center-crop an [H, W, C] array (torchvision ``CenterCrop`` rounding)."""
    h, w = arr.shape[:2]
    top = int(round((h - size) / 2.0))
    left = int(round((w - size) / 2.0))
    return arr[top : top + size, left : left + size]


def normalize_tiles(batch_u8: np.ndarray) -> np.ndarray:
    """uint8 [..., H, W, 3] -> fp32 ``(x/255 - mean)/std`` with the ImageNet
    constants, computed as the per-channel affine ``x * (1/(255*std)) +
    (-mean/std)`` in fp32, the same operations as the JAX package's native
    host kernel."""
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    a = np.float32(1.0) / (np.float32(255.0) * std)
    b = -mean / std
    return np.asarray(batch_u8, np.uint8).astype(np.float32) * a + b


def preprocess_tile(img, crop_size: int = 224) -> np.ndarray:
    """PIL image (or uint8 [H, W, 3] array) -> fp32 [crop, crop, 3]. The
    resize keeps the reference's 256/224 ratio for other crop sizes (the
    small test encoders)."""
    from PIL import Image

    if isinstance(img, np.ndarray):
        img = Image.fromarray(img)
    img = img.convert("RGB")
    img = resize_shorter_side(img, round(crop_size * 256 / 224))
    return normalize_tiles(center_crop(np.asarray(img, np.uint8), crop_size))
