"""Lloyd-Max quantization of depth-ratio matrices.

Frozen copy of the plain PyTorch version in ``md_rdm_tpu_torch``, the
port of ``md_rdm_tpu/ops/quantize.py``.  Each ratio maps to one of 41
reconstruction levels by the count of the 40 sorted thresholds it reaches:

    index = sum_i [ratio >= q_i],   out = level[index]

The JAX op accumulates ``inv[0] + sum_i [r >= q_i] * (inv[i+1] - inv[i])``
in float32, one threshold after the other.  Because the thresholds are
sorted the indicators form a prefix, and adding 0.0 is exact, so that sum
equals a float32 level table built by the same sequential sums
(:func:`level_table`), looked up by the count.  The port's result equals
the JAX value bit for bit; NaN ratios reach no threshold and take
``level[0]``, as in JAX.

Quantization emits constants: the result is detached, the port's form of
the JAX ``stop_gradient``.  The tables live in the port's own copy of the
asset (``assets/depth_ratio_quant.npz``).
"""
from __future__ import annotations

import functools
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

_ASSET = (Path(__file__).resolve().parent / "assets"
          / "depth_ratio_quant.npz")

# map size -> quantizer id of the reference
SIZE_TO_ID = {8: 3, 16: 4, 32: 5, 64: 6, 128: 7}


@functools.lru_cache(maxsize=None)
def _tables() -> dict:
    with np.load(_ASSET) as z:
        return {k: z[k].astype(np.float64) for k in z.files}


def quant_tables(size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(thresholds (40,), levels (41,)), float64, for a map size in
    {8, ..., 128}."""
    t = _tables()
    return t[f"q{size}"], t[f"inv{size}"]


@functools.lru_cache(maxsize=None)
def level_table(size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(thresholds, levels) in float32 as the JAX op applies them: the
    thresholds rounded to float32, ``level[0] = f32(inv[0])`` and
    ``level[k+1] = f32(level[k] + f32(inv[k+1] - inv[k]))`` with the
    differences taken in float64."""
    q64, inv64 = quant_tables(size)
    steps = np.diff(inv64).astype(np.float32)
    level = np.empty(inv64.shape, np.float32)
    level[0] = np.float32(inv64[0])
    for k, step in enumerate(steps):
        level[k + 1] = level[k] + step
    q = q64.astype(np.float32)
    q.setflags(write=False)
    level.setflags(write=False)
    return q, level


@functools.lru_cache(maxsize=None)
def _device_levels(size: int, device: torch.device) -> torch.Tensor:
    """The level table on ``device``, made once (no host copy per call)."""
    return torch.as_tensor(level_table(size)[1].copy(), device=device)


def lloyd_quantize(ratios: torch.Tensor, size: int) -> torch.Tensor:
    """Quantize every element to its Lloyd-Max level: a detached float32
    tensor of the same shape.  ``size`` selects the per-resolution
    table."""
    r = ratios.detach().float()
    count = torch.zeros(r.shape, dtype=torch.int64, device=r.device)
    for qi in level_table(size)[0].tolist():
        count += r >= qi
    return _device_levels(size, r.device)[count]
