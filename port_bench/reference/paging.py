"""Tile paging for large comparison matrices.

Frozen copy of the plain PyTorch version in ``md_rdm_tpu_torch``, the
port of ``md_rdm_tpu/ops/paging.py``.  Maps of 32x32 and more are split
into 16x16 tiles (with the matching 8x8 tiles of the half-size map), so
that every page's comparison, quantization and ALS run in one batched call.
Pure reshapes and permutes.  Pages merge back into the intended
row-major grid, the JAX package's default (its ``faithful=True`` quirk,
which repeats the first row of tiles, runs on no path and is not ported).
"""
from __future__ import annotations

from typing import Tuple

import torch


def split_into_tiles(x: torch.Tensor, tile: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, n_tiles, C, tile, tile), tiles row-major."""
    b, c, h, w = x.shape
    gh, gw = h // tile, w // tile
    x = x.reshape(b, c, gh, tile, gw, tile).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, gh * gw, c, tile, tile)


def split_matrix(dn: torch.Tensor, dn_1: torch.Tensor,
                 tile: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Page d_n into 16x16 tiles and d_{n-1} into the matching 8x8 tiles:
    (B, P, 1, 16, 16) and (B, P, 1, 8, 8) with P = (H/16)^2."""
    return split_into_tiles(dn, tile), split_into_tiles(dn_1, tile // 2)


def merge_pages(pages: torch.Tensor, grid: int) -> torch.Tensor:
    """(B, P, C, t, t) pages -> (B, C, grid*t, grid*t) map, row-major: the
    inverse of :func:`split_into_tiles`."""
    b, _, c, t, _ = pages.shape
    x = pages.reshape(b, grid, grid, c, t, t).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, c, grid * t, grid * t)
