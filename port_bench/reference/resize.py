"""Resize ops with the reference's ``F.interpolate`` semantics, as matrices.

Bicubic: a = -0.75, ``align_corners=False``, out-of-range taps clamped to
the border.  The taps depend only on (in_size, out_size), so the resize is
two small dense matrices applied separably, ``W_h @ img @ W_w^T``, as in the
JAX package (``md_rdm_tpu/ops/resize.py``).  The products run in float32;
they feed the fusion tail's 1e-3 parity budget, so TF32 must stay off
(the model's forward runs under ``core.device.no_tf32``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

_A = -0.75  # cubic convolution alpha used by PyTorch


def _cubic_kernel(t: np.ndarray) -> np.ndarray:
    """Cubic convolution weight for |offset| t (vectorized, float64)."""
    t = np.abs(t)
    t2, t3 = t * t, t * t * t
    return np.where(
        t <= 1.0,
        (_A + 2.0) * t3 - (_A + 3.0) * t2 + 1.0,
        np.where(t < 2.0, _A * t3 - 5.0 * _A * t2 + 8.0 * _A * t - 4.0 * _A,
                 0.0),
    )


@functools.lru_cache(maxsize=None)
def _bicubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense (out_size, in_size) 1-D bicubic resampling matrix (float64)."""
    scale = in_size / out_size
    o = np.arange(out_size, dtype=np.float64)
    src = (o + 0.5) * scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    t = src - i0
    w = np.stack([_cubic_kernel(t + 1.0), _cubic_kernel(t),
                  _cubic_kernel(t - 1.0), _cubic_kernel(t - 2.0)], axis=1)
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for k in range(4):
        idx = np.clip(i0 + (k - 1), 0, in_size - 1)
        np.add.at(mat, (o.astype(np.int64), idx), w[:, k])
    return mat


@functools.lru_cache(maxsize=None)
def _device_matrix(in_size: int, out_size: int, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """The bicubic matrix on ``device``, made once: a copy from host
    memory on every call would make each forward wait for the card."""
    return torch.as_tensor(_bicubic_matrix(in_size, out_size), dtype=dtype,
                           device=device)


def resize_bicubic(x: torch.Tensor, out_hw,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Bicubic resize of (..., H, W) maps along the last two axes."""
    if isinstance(out_hw, int):
        out_hw = (out_hw, out_hw)
    out_h, out_w = out_hw
    in_h, in_w = x.shape[-2], x.shape[-1]
    wh = _device_matrix(in_h, out_h, dtype, x.device)
    ww = _device_matrix(in_w, out_w, dtype, x.device)
    return wh @ x.to(dtype) @ ww.T


def upsample_nearest2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 upsample along the last two axes."""
    return multi_upsample(x, 1)


def multi_upsample(x: torch.Tensor, n: int) -> torch.Tensor:
    """n-fold nearest x2 upsample, done as one nearest x2**n repeat."""
    if n <= 0:
        return x
    f = 2 ** n
    *lead, h, w = x.shape
    return (x[..., :, None, :, None].expand(*lead, h, f, w, f)
            .reshape(*lead, h * f, w * f))
