"""Multi-scale depth decomposition and recombination (the fusion tail).

Every list is ordered coarse to fine ([D0, F1, ..., Fn]), as in the JAX
package (``md_rdm_tpu/ops/decompose.py``).  The tail runs in float32.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from .resize import (multi_upsample, resize_bicubic,
                                         upsample_nearest2)


def decompose_depth_map(dn: torch.Tensor, n: int, relative_map: bool = False,
                        eps: float = 0.0) -> List[torch.Tensor]:
    """Decompose a (B, 1, 2^n, 2^n) map into [D0, F1, ..., Fn] (no D0 when
    ``relative_map``), with ``d_{k-1} = bicubic(d_k)`` and
    ``F_k = d_k / nearest_up2(d_{k-1})``.

    ``eps`` > 0 floors each level at eps and clips the ratios to
    [eps, 1/eps]; eps = 0 is the faithful reference tail.
    """
    fines: List[torch.Tensor] = []
    for k in range(n, 0, -1):
        dn_1 = resize_bicubic(dn, 2 ** (k - 1))
        if eps:
            dn_1 = torch.clamp(dn_1, min=eps)
            fines.append(torch.clamp(dn / upsample_nearest2(dn_1),
                                     eps, 1.0 / eps))
        else:
            fines.append(dn / upsample_nearest2(dn_1))
        dn = dn_1
    out = [] if relative_map else [dn]
    out.extend(reversed(fines))
    return out


def recombination(components: Sequence[torch.Tensor],
                  n: int = 7) -> torch.Tensor:
    """Sum the components, each nearest-upsampled to 2^n, into a
    (B, 1, 2^n, 2^n) log-space map."""
    size = 2 ** n
    out = None
    for c in components:
        up = multi_upsample(c, _log2(size // c.shape[-1]))
        out = up if out is None else out + up
    return out


def _log2(x: int) -> int:
    return int(x).bit_length() - 1


def slot_index(size: int) -> int:
    """Fine-detail slot of a map of spatial size ``size`` (2**slot)."""
    idx = _log2(size)
    if 2 ** idx != size or not 0 <= idx <= 7:
        raise ValueError(f"invalid fine-detail map size {size}")
    return idx


def fine_detail_matrices(rows: Sequence[Sequence[torch.Tensor]],
                         eps: float = 0.0) -> List[torch.Tensor]:
    """Group maps by size slot and stack their logs.

    rows: per-decoder component lists.  Returns one (B, k_i, H_i*W_i)
    log-space matrix per non-empty slot, ascending size.  ``eps`` > 0
    floors the log input.
    """
    slots: List[List[torch.Tensor]] = [[] for _ in range(8)]
    for row in rows:
        for m in row:
            slots[slot_index(m.shape[-1])].append(m)
    mats = []
    for cand in slots:
        if not cand:
            continue
        b = cand[0].shape[0]
        mats.append(torch.stack(
            [torch.log(torch.clamp(x, min=eps) if eps else x).reshape(b, -1)
             for x in cand], dim=1))
    return mats


def make_pred(weights: Sequence[torch.Tensor],
              matrices: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Apply the fusion weights per slot: (B,k,M)^T @ (k,1) -> (B,1,s,s)."""
    out = []
    for a, w in zip(matrices, weights):
        b, _, m = a.shape
        s = int(round(m ** 0.5))
        y = torch.einsum("bkm,ko->bmo", a, w.to(a.dtype))
        out.append(y.reshape(b, 1, s, s))
    return out


def squared_err(yhat: Sequence[torch.Tensor],
                y: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Per-slot MSE list.  When the prediction lacks the smallest-scale
    head (relative-only decoders) the first target is dropped, aligning
    the lists from the tail."""
    if yhat[0].shape[2] > y[0].shape[2]:
        y = y[1:]
    return [torch.mean((a - b) ** 2) for a, b in zip(yhat, y)]


def optimize_components(yhat: Sequence[torch.Tensor],
                        y: Sequence[torch.Tensor]):
    """(yhat as a list, the sum of the per-slot MSEs)."""
    losses = squared_err(list(yhat), list(y))
    return list(yhat), torch.stack(losses).sum()
