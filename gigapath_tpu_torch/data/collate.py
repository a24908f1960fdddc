"""Batch collation (counterpart of ``gigapath_tpu/data/collate.py``): ragged
tile sequences padded to a common length with a validity mask.

The pad length is rounded up to the next power of two by default, as in
the JAX package, so the two packages see the same padded shapes. Mask
convention: ``pad_mask`` is True at VALID positions; the model's
key-padding mask is its negation.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


def next_power_of_two(n: int, minimum: int = 16) -> int:
    n = max(int(n), minimum)
    return 1 << (n - 1).bit_length()


def pad_tensors(
    imgs: Sequence[np.ndarray],
    coords: Sequence[np.ndarray],
    bucket_fn: Optional[Callable[[int], int]] = None,
):
    """Pad a list of [L_i, D] + [L_i, 2] arrays to a common length.

    Returns ``(padded [B, L, D], padded_coords [B, L, 2], mask [B, L])``;
    mask True = valid token.
    """
    if len(imgs) != len(coords):
        raise ValueError(f"{len(imgs)} feature arrays != {len(coords)} coordinate arrays")
    for i, (tensor, coord) in enumerate(zip(imgs, coords)):
        if tensor.shape[0] != coord.shape[0]:
            raise ValueError(f"item {i}: {tensor.shape[0]} feature rows != {coord.shape[0]} coords")
    max_len = max(t.shape[0] for t in imgs)
    if bucket_fn is not None:
        max_len = bucket_fn(max_len)
    B, D = len(imgs), imgs[0].shape[1]
    padded = np.zeros((B, max_len, D), imgs[0].dtype)
    padded_coords = np.zeros((B, max_len, 2), np.float32)
    mask = np.zeros((B, max_len), bool)
    for i, (tensor, coord) in enumerate(zip(imgs, coords)):
        n = coord.shape[0]
        padded[i, :n] = tensor
        padded_coords[i, :n] = coord
        mask[i, :n] = True
    return padded, padded_coords, mask


def slide_collate_fn(
    samples: List[Optional[dict]],
    bucket: bool = True,
) -> Optional[Dict[str, np.ndarray]]:
    """Collate slide samples into one padded batch dict. ``None`` samples
    (loads that failed every retry) are dropped; an all-None batch returns
    None."""
    samples = [s for s in samples if s is not None]
    if not samples:
        return None
    image_list = [s["imgs"] for s in samples]
    coord_list = [s["coords"] for s in samples]
    labels = np.stack([s["labels"] for s in samples])
    pad_imgs, pad_coords, pad_mask = pad_tensors(
        image_list, coord_list, bucket_fn=next_power_of_two if bucket else None
    )
    return {
        "imgs": pad_imgs,
        "img_lens": [s["imgs"].shape[0] for s in samples],
        "coords": pad_coords,
        "slide_id": [s["slide_id"] for s in samples],
        "pad_mask": pad_mask,
        "labels": labels,
    }
