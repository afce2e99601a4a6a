"""The plain reference of one training step: the loss assembly of the
reference repo's training path, then AdamW.

Frozen copy of the loss assembly that ``md_rdm_tpu_torch/training/
module.py`` ports (the reference's MSE + fine-detail + ordinal loss), on
:class:`model.ReferenceModel` in train mode (batch statistics), with
``torch.optim.AdamW`` at the configuration's hyperparameters.  Relative
decoders run under ``no_grad`` in the model and get zero gradients, which
AdamW still decays, as optax does.
"""
from __future__ import annotations

from typing import Dict

import torch

from .decompose import decompose_depth_map, optimize_components, recombination
from .geometry import normalize_gm
from .losses import mse_loss, ordinal_loss
from .model import ReferenceModel
from .resize import resize_bicubic
from .sid import SIDConfig, depth_to_label

LOG_NAMES = ("loss", "MSE", "Ord_Loss", "Fine_Detail")


def mask_target(y: torch.Tensor) -> torch.Tensor:
    """Valid pixels keep gt (+1e-4), invalid ones become 1.0001."""
    return y * (y > 0) + ((y <= 0) + 1e-4)


def loss_terms(model: ReferenceModel, x: torch.Tensor, y: torch.Tensor,
               sid: SIDConfig = SIDConfig()) -> Dict[str, torch.Tensor]:
    """The logged terms of one step's loss; x (B, 226, 226, 3), y (B, 1,
    226, 226) raw depth."""
    y = mask_target(resize_bicubic(y, 128))
    yhat, ord_depth, ord_probs, margin = model(x)
    target = decompose_depth_map(normalize_gm(y), 7)
    if ord_depth is not None:
        labels8 = depth_to_label(resize_bicubic(y, 8), sid)
        target[0] = decompose_depth_map(normalize_gm(labels8), 3)[0]
    components, fine = optimize_components(yhat, target)
    final = recombination(components)
    mse = mse_loss(final, y)
    if ord_probs is not None:
        ord_l = ordinal_loss(ord_probs, depth_to_label(
            resize_bicubic(y, ord_depth.shape[-1]), sid))
    else:
        ord_l = torch.zeros((), device=y.device)
    terms = dict(zip(LOG_NAMES, (mse + fine + ord_l, mse, ord_l, fine)))
    terms["margin"] = margin
    return terms


def make_optimizer(model: ReferenceModel, train_fields: Dict
                   ) -> torch.optim.AdamW:
    params = [p for p in model.parameters() if p.numel()]
    return torch.optim.AdamW(
        params, lr=float(train_fields.get("learning_rate", 1e-4)),
        betas=(0.9, 0.999), eps=1e-8,
        weight_decay=float(train_fields.get("weight_decay", 0.01)))


def train_step(model: ReferenceModel, opt: torch.optim.Optimizer,
               x: torch.Tensor, y: torch.Tensor, near: float = 4e-4
               ) -> Dict[str, float]:
    """One step; returns the logged terms as floats, and ``near_pairs``:
    the ordinal pairs within ``near`` of flipping (the model's margins),
    where a last-bit difference can flip the hard decode that the fusion
    tail and the loss read."""
    model.train()
    terms = loss_terms(model, x, y)
    margin = terms.pop("margin")
    opt.zero_grad(set_to_none=True)
    terms["loss"].backward()
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    opt.step()
    out = {k: float(v.detach()) for k, v in terms.items()}
    if margin is not None:
        out["near_pairs"] = float((margin.detach() < near).sum())
    return out
