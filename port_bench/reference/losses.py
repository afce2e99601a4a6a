"""Losses of the training path: the DORN ordinal loss and the MSE.

Frozen copy of the plain PyTorch version in ``md_rdm_tpu_torch``, the
port of ``md_rdm_tpu/losses.py`` (the reference's loss.py and criteria.py).
"""
from __future__ import annotations

import torch


def ordinal_loss(ord_probs: torch.Tensor,
                 target_labels: torch.Tensor) -> torch.Tensor:
    """DORN ordinal loss.  ord_probs (N, C, H, W) holds P(label > k);
    target_labels (N, 1, H, W) integer-valued SID labels.

    loss = -[sum_{k <= t} log P_k + sum_{k > t} log(1 - P_k)] / (N*H*W),
    normalized by N*H*W and not by C, as the reference does."""
    n, c, h, w = ord_probs.shape
    k = torch.arange(c, dtype=torch.float32,
                     device=ord_probs.device)[None, :, None, None]
    t = target_labels.float()
    p = ord_probs.float()
    log_p = torch.log(torch.clamp(p, 1e-8, 1e8))
    log_not_p = torch.log(torch.clamp(1.0 - p, 1e-8, 1e8))
    total = torch.where(k <= t, log_p, log_not_p).sum()
    return -total / (n * h * w)


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Plain MSE."""
    return torch.mean((pred - target) ** 2)
