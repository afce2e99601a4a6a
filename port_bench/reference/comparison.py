"""Pairwise depth-ratio comparison matrices for the relative decoders.

Frozen copy of the plain PyTorch version in ``md_rdm_tpu_torch``, the
port of ``md_rdm_tpu/ops/comparison.py``.

* :func:`comparison_v1` (8x8 path): the full ratio matrix
  ``M[b, i, j] = d_i * (1 / d_j)``.
* :func:`comparison_cross_scale`: the ratio of each pixel of d_n against
  the clamped 3x3 window of d_{n-1} under it, embedded in a field of
  ones.  The window positions depend only on the shapes, so they are one
  static boolean mask (:func:`_neighborhood_mask`):

      sparse[b, p, q] = d_n[b, p] * (mask[p, q] ? 1 / d_{n-1}[b, q] : 1)

Both keep the JAX rounding: a reciprocal, then a product (not a quotient).
The two differ in the last bit, and a last-bit change moves a ratio that
sits on a Lloyd threshold into the next bin.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def comparison_v1(d: torch.Tensor) -> torch.Tensor:
    """Full ratio matrix of a (B, 1, H, W) map -> (B, H*W, H*W)."""
    v = d.reshape(d.shape[0], -1)
    return v[:, :, None] * torch.reciprocal(v[:, None, :])


@functools.lru_cache(maxsize=None)
def _neighborhood_mask(h: int, w: int) -> np.ndarray:
    """Static (H*W, H1*W1) mask of the clamped 3x3 windows: pixel (r, c) of
    d_n sees rows rs..rs+2 and columns cs..cs+2 of d_{n-1}, with
    rs = clip(r // 2, 0, H1 - 3) and cs = clip(c // 2, 0, W1 - 3)."""
    h1, w1 = h // 2, w // 2
    rs = np.clip(np.arange(h) // 2, 0, h1 - 3)
    cs = np.clip(np.arange(w) // 2, 0, w1 - 3)
    rows = (np.arange(h1)[None, :] >= rs[:, None]) & (
        np.arange(h1)[None, :] < rs[:, None] + 3)          # (h, h1)
    cols = (np.arange(w1)[None, :] >= cs[:, None]) & (
        np.arange(w1)[None, :] < cs[:, None] + 3)          # (w, w1)
    mask = rows[:, None, :, None] & cols[None, :, None, :]  # (h, w, h1, w1)
    mask = mask.reshape(h * w, h1 * w1)
    mask.setflags(write=False)
    return mask


@functools.lru_cache(maxsize=None)
def _device_mask(h: int, w: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_neighborhood_mask(h, w).copy(), device=device)


def comparison_cross_scale(dn: torch.Tensor,
                           dn_1: torch.Tensor) -> torch.Tensor:
    """Cross-scale comparison (B,1,H,W) x (B,1,H/2,W/2) -> (B, HW, HW/4):
    d_n[p] / d_{n-1}[q] inside p's window, d_n[p] outside it."""
    b, _, h, w = dn.shape
    mask = _device_mask(h, w, dn.device)
    inv_prev = torch.reciprocal(dn_1.reshape(b, 1, -1))
    return dn.reshape(b, h * w, 1) * torch.where(mask[None], inv_prev, 1.0)
