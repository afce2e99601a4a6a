"""The 3x3 growth convolution as one matmul plus nine shifted slice adds.

Port of ``md_rdm_tpu/kernels/growth_conv.py``, which is plain XLA (no
Pallas kernel), so its port is torch ops.  Each dense layer's second conv
writes 48 channels; the formulation instead runs one [9G, C] x [C, ZL]
product whose long dimension is the flattened, zero-padded frame: with the
frame padded to width F = S + 2 and flattened row-major, tap (dy, dx) of
output pixel q sits at flat position q + dy * F + dx, and the row wraps
land on the zero border columns.  Which layers run it,
``models/routing.py`` decides (``ModelConfig.growth_matmul``).

The JAX package's ``growth_flop_inflation`` (a correction of XLA's
``cost_analysis``) has no counterpart here: nothing in the port counts
flops from a compiled graph.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _pad128(n: int) -> int:
    return -(-n // 128) * 128


def growth_conv_matmul(z: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """3x3 convolution, padding 1, no bias: ``z`` (B, C, S, S) in the
    compute dtype (any memory format), ``w2`` (G, C, 3, 3) -> (B, G, S, S)
    in ``z``'s dtype.  The product runs in the compute dtype (its float32
    accumulation rounded once to that dtype), the nine tap sums in
    float32."""
    b, c, s, _ = z.shape
    g = w2.shape[0]
    f = s + 2
    lp = _pad128(s * f)
    zl = _pad128(max(f * f, 2 * f + 2 + lp))
    # zero-padded frame, flattened row-major, lane tail padded: [B, C, ZL]
    zf = F.pad(F.pad(z, (1, 1, 1, 1)).reshape(b, c, f * f),
               (0, zl - f * f))
    # [G, C, ky, kx] -> [ky, kx, G, C] -> [9G, C]
    w2s = w2.to(z.dtype).permute(2, 3, 0, 1).reshape(9 * g, c)
    t = torch.matmul(w2s, zf).float()                # [B, 9G, ZL]
    acc = torch.zeros((b, g, lp), dtype=torch.float32, device=z.device)
    for dy in range(3):
        for dx in range(3):
            j = 3 * dy + dx
            off = dy * f + dx
            acc = acc + t[:, j * g:(j + 1) * g, off:off + lp]
    # flat q = o * F + w, w < S
    y = acc[..., :s * f].reshape(b, g, s, f)[..., :s]
    return y.to(z.dtype)
