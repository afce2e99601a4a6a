"""Geometric-mean normalization: each depth map is divided by its
per-image geometric mean, computed as exp(mean(log x)).  Zero entries give
a zero mean and negative entries NaN, as in the reference."""
from __future__ import annotations

import torch


def quick_gm(maps: torch.Tensor) -> torch.Tensor:
    """Per-image geometric mean of (B, ...) maps -> (B,)."""
    return torch.exp(torch.log(maps.reshape(maps.shape[0], -1)).mean(-1))


def normalize_gm(maps: torch.Tensor) -> torch.Tensor:
    """Divide each image by its geometric mean over all non-batch axes."""
    gm = quick_gm(maps)
    return maps / gm.reshape((-1,) + (1,) * (maps.ndim - 1))
