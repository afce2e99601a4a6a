"""Spacing-increasing discretization (SID): depth -> label.

Frozen copy of the plain PyTorch version in ``md_rdm_tpu_torch``, the
port of ``md_rdm_tpu/ops/sid.py``:

    label = K * ln(depth / alpha) / ln(beta / alpha)
    depth = exp(ln(alpha) + ln(beta / alpha) * label / K)
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class SIDConfig:
    """The training path's NYU constants (K=90), the configurations'
    default."""

    alpha: float = 0.02
    beta: float = 10.0
    K: float = 90.0


def depth_to_label(depth: torch.Tensor, sid: SIDConfig,
                   clamp_negative: bool = True,
                   integer: bool = True) -> torch.Tensor:
    """Float label, clamped >= 0 and truncated toward zero (the reference's
    ``.int()``), returned as float32."""
    label = sid.K * torch.log(depth / sid.alpha) / math.log(sid.beta / sid.alpha)
    if clamp_negative:
        label = torch.clamp(label, min=0.0)
    if integer:
        label = torch.trunc(label)
    return label.float()

