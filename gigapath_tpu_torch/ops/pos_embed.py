"""2-D sin-cos positional embeddings, computed from tile coords on the fly.

Counterpart of ``gigapath_tpu/ops/pos_embed.py``. The reference builds a
``(grid_size^2 + 1, D)`` table (~3 GB of fp32 at ``slide_ngrids=1000,
D=768``) and gathers rows by tile position; the embedding is a closed-form
function of the grid position, so it is computed here from the positions a
slide uses. The numpy table builder is kept for parity tests.

Layout: for table row ``p = i*G + j`` the first D/2 channels encode ``j``
and the second D/2 encode ``i``; coords ``(c0, c1)`` map to
``p = floor(c0/tile)*G + floor(c1/tile)``.
"""

from __future__ import annotations

import numpy as np
import torch


def _sincos_1d_np(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000**omega
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed(
    embed_dim: int, grid_size: int, cls_token: bool = False
) -> np.ndarray:
    """Full numpy table ``(G*G [+1], D)``, for parity tests only: row-major
    over (h, w), the w-coordinate in the first half of the channels."""
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0)
    grid = grid.reshape([2, 1, grid_size, grid_size])
    emb_h = _sincos_1d_np(embed_dim // 2, grid[0])
    emb_w = _sincos_1d_np(embed_dim // 2, grid[1])
    pos_embed = np.concatenate([emb_h, emb_w], axis=1)
    if cls_token:
        pos_embed = np.concatenate([np.zeros([1, embed_dim]), pos_embed], axis=0)
    return pos_embed


def _sincos_1d(embed_dim: int, pos: torch.Tensor) -> torch.Tensor:
    """pos [...] -> [..., embed_dim], computed in fp32."""
    omega = torch.arange(embed_dim // 2, dtype=torch.float32, device=pos.device)
    omega = 1.0 / 10000 ** (omega / (embed_dim / 2.0))
    out = pos.to(torch.float32)[..., None] * omega
    return torch.cat([torch.sin(out), torch.cos(out)], dim=-1)


def sincos_pos_embed_from_grid_pos(
    embed_dim: int, pos: torch.Tensor, ngrids: int
) -> torch.Tensor:
    """Embedding for flat table indices ``pos`` (cls offset removed).

    Reproduces the table row the reference would gather, including the wrap
    a flat index implies when ``j >= ngrids`` and torch's negative-index
    wrap for negative positions (padded edge tiles can have negative
    coords). A wrapped index that lands on the cls row gives zeros.
    """
    table_rows = ngrids * ngrids + 1
    pos = pos.to(torch.int64) + 1  # back to the full-table row index
    pos = torch.where(pos < 0, pos + table_rows, pos)
    is_cls_row = pos == 0
    grid_pos = pos - 1
    i = torch.div(grid_pos, ngrids, rounding_mode="floor")
    j = grid_pos - i * ngrids
    emb = torch.cat([_sincos_1d(embed_dim // 2, j), _sincos_1d(embed_dim // 2, i)], dim=-1)
    return torch.where(is_cls_row[..., None], torch.zeros_like(emb), emb)


def coords_to_pos(coords: torch.Tensor, tile_size: int, ngrids: int) -> torch.Tensor:
    """Coordinates [..., 2] -> flat positional index [...] (+1 for cls)."""
    c = torch.floor(coords.to(torch.float32) / float(tile_size)).to(torch.int64)
    return c[..., 0] * ngrids + c[..., 1] + 1


def pos_embed_for_coords(
    embed_dim: int, coords: torch.Tensor, tile_size: int, ngrids: int
) -> torch.Tensor:
    """Positional embedding for tile coords [..., 2] -> [..., embed_dim] fp32,
    equal to ``pos_embed[coords_to_pos(coords)]`` of the reference table."""
    pos = coords_to_pos(coords, tile_size, ngrids) - 1
    return sincos_pos_embed_from_grid_pos(embed_dim, pos, ngrids)
