"""Tile-image dataset: PNG tiles named ``{x:05d}x_{y:05d}y.png``
(counterpart of ``gigapath_tpu/data/tile_dataset.py``).

Coordinates are parsed from the filename; images load through PIL and run
through the tile transform (:mod:`gigapath_tpu_torch.data.transforms`),
giving NHWC fp32 arrays for the tile encoder.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

import numpy as np


def parse_tile_coords(filename: str) -> np.ndarray:
    """``'..._00123x_00456y.png'`` (or ``'00123x_00456y.png'``) -> [123, 456]."""
    base = os.path.basename(filename)
    x_s, y_s = base.split(".png")[0].split("_")[-2:]
    return np.asarray([int(x_s.replace("x", "")), int(y_s.replace("y", ""))], np.float32)


class TileEncodingDataset:
    """(transformed image [H, W, 3], coords [2]) samples from tile paths."""

    def __init__(self, image_paths: List[str],
                 transform: Optional[Callable[[np.ndarray], np.ndarray]] = None):
        self.image_paths = image_paths
        self.transform = transform

    def __len__(self) -> int:
        return len(self.image_paths)

    def __getitem__(self, idx: int) -> dict:
        from PIL import Image

        path = self.image_paths[idx]
        coords = parse_tile_coords(path)
        with open(path, "rb") as f:
            img = np.asarray(Image.open(f).convert("RGB"))
        if self.transform is not None:
            img = self.transform(img)
        return {"img": img, "coords": coords}
