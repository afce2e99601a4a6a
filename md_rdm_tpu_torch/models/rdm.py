"""DepthEstimationNet: encoder -> decoders -> fine-detail fusion.

Port of ``md_rdm_tpu/models/rdm.py`` for every decoder set: the live
configuration (decoder 1), the authors' optimal set (1, 6, 7, 8, 9) and
any other subset of ids 1-10.  Returns (yhat components, ordinal decode,
ordinal probs), as the JAX model does; the ordinal outputs come from the
first DORN decoder and are None without one.  ``model.train()`` gives the
JAX model's ``train=True`` (batch statistics, running statistics
updated); ``freeze_encoder`` stops the gradient at the encoder's output.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn as nn

from md_rdm_tpu_torch.core import trace
from md_rdm_tpu_torch.core.config import ModelConfig, decomposition_depth
from md_rdm_tpu_torch.core.device import compute_dtype, no_tf32
from md_rdm_tpu_torch.models.decoder import Decoder, relative_tail
from md_rdm_tpu_torch.models.densenet import Encoder
from md_rdm_tpu_torch.models.routing import Routing
from md_rdm_tpu_torch.ops.decompose import (decompose_depth_map,
                                            fine_detail_matrices, make_pred)
from md_rdm_tpu_torch.ops.geometry import normalize_gm

SLOT_NAMES = ("d0", "f1", "f2", "f3", "f4", "f5", "f6", "f7")


class Weights(nn.Module):
    """Learned fusion weights, one (size, 1) vector per slot.  Empty slots
    keep a zero-size parameter, as the reference does; it gets no gradient
    and the optimizer leaves it out (the JAX model has no parameter
    there)."""

    def __init__(self, vector_sizes: Sequence[int],
                 init_mode: str = "abs_randn"):
        super().__init__()
        self.init_mode = init_mode
        for name, size in zip(SLOT_NAMES, vector_sizes):
            setattr(self, name, nn.Parameter(torch.zeros(size, 1)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """|N(0,1)| per candidate ("abs_randn"), rescaled to sum 1 per slot
        ("normalized"), or first candidate 1 and the rest 0.01
        ("primary")."""
        with torch.no_grad():
            for name in SLOT_NAMES:
                w = getattr(self, name)
                if w.numel() == 0:
                    continue
                r = torch.randn(w.shape, generator=generator).abs()
                if self.init_mode == "normalized":
                    r = r / r.sum()
                elif self.init_mode == "primary":
                    r = torch.full(w.shape, 0.01)
                    r[0, 0] = 1.0
                w.copy_(r)

    def forward(self, matrices: List[torch.Tensor]) -> List[torch.Tensor]:
        weights = [w for w in (getattr(self, n) for n in SLOT_NAMES)
                   if w.numel()]
        return make_pred(weights, matrices)


class DepthEstimationNet(nn.Module):
    """Full model; input NHWC float images (B, 226, 226, 3)."""

    def __init__(self, config: ModelConfig = ModelConfig()):
        super().__init__()
        self.config = config
        routing = Routing.of(config)
        self.encoder = Encoder(routing, config.remat)
        for did in config.decoder_ids:
            self.add_module(f"d_{did}", Decoder(
                did, config.ordinal_channels, config.soft_ordinal_decode,
                routing))
        self.weight_layer = Weights(config.vector_sizes, config.fusion_init)

    def forward(self, images: torch.Tensor,
                stages: Optional[Dict[str, Any]] = None):
        """(yhat components, ordinal decode, ordinal probs); the ordinal
        outputs are None without a DORN decoder.  A ``stages`` dict is
        filled with the intermediate tensors (see :meth:`decoder_maps`)."""
        # float32 means float32, as in the JAX package: the float32 model,
        # and the float32 parts of a bfloat16 one, never run in TF32 (a
        # train step also holds TF32 off over its backward:
        # training/module.py)
        with no_tf32():
            cfg = self.config
            dt = compute_dtype(cfg.compute_dtype)
            feats = self.encoder(images.permute(0, 3, 1, 2).to(dt))
            if cfg.freeze_encoder:
                feats = feats.detach()
            _record(stages, "encoder", feats)
            maps, ord_depth, ord_probs = self.decoder_maps(feats, stages)
            return self.fuse(maps), ord_depth, ord_probs

    def decoder_maps(self, feats: torch.Tensor,
                     stages: Optional[Dict[str, Any]] = None):
        """Every decoder's map for the fusion tail, by id: DORN decodes
        divided by their geometric mean, relative maps filled by
        :func:`relative_tail` in one call over all relative decoders
        (their decoders inside the device span ``relative.decoders``).
        Returns (maps, ordinal decode, ordinal probs) of the first DORN
        decoder.  ``stages`` receives ``map_<id>`` (the 1-channel map) per
        relative id, the tail's ``sparse_<id>`` and ``filled_<id>``, and
        ``maps``, the returned maps."""
        cfg = self.config
        maps: Dict[int, torch.Tensor] = {}
        relative: Dict[int, torch.Tensor] = {}
        ord_depth = ord_probs = None
        for did in cfg.decoder_ids:
            if did > 5:
                continue
            depth, probs = getattr(self, f"d_{did}")(feats)
            if ord_depth is None:          # the first DORN decoder feeds
                ord_depth, ord_probs = depth, probs   # the ordinal loss
            maps[did] = normalize_gm(depth)
        rel_ids = [did for did in cfg.decoder_ids if did > 5]
        # the relative tail's quantization passes no gradient, so autograd
        # records nothing for a relative decoder: a train step saves none
        # of its activations (train-mode norms still update their running
        # statistics).  The relative decoders run after the DORN ones, in
        # one device span.
        if rel_ids:
            with trace.device_span("relative.decoders", feats.device), \
                    torch.no_grad():
                for did in rel_ids:
                    relative[did] = getattr(self, f"d_{did}")(feats)
                    _record(stages, f"map_{did}", relative[did])
        maps.update(relative_tail(relative, cfg.als_iters_quadratic,
                                  cfg.als_iters_rect, stages))
        _record(stages, "maps", maps)
        return maps, ord_depth, ord_probs

    def fuse(self, maps: Dict[int, torch.Tensor]) -> List[torch.Tensor]:
        """The fusion tail (float32) on :meth:`decoder_maps`'s maps: with
        ``fusion_eps`` > 0 relative maps are clipped to [eps, 1/eps]
        first; each map is decomposed (no D0 for a relative one), the
        levels grouped by size into log matrices and weighted."""
        cfg = self.config
        eps = cfg.fusion_eps
        rows = []
        for did in cfg.decoder_ids:
            m = maps[did]
            if eps and did > 5:
                m = torch.clamp(m, eps, 1.0 / eps)
            rows.append(decompose_depth_map(
                m, decomposition_depth(did), relative_map=did > 5, eps=eps))
        return self.weight_layer(fine_detail_matrices(rows, eps=eps))


def _record(stages: Optional[Dict[str, Any]], key: str, value) -> None:
    if stages is not None:
        stages[key] = value


def init_parameters(model: nn.Module, seed: int) -> None:
    """Seeded initialization: conv and transposed-conv kernels N(0,
    1/fan_in) (flax's lecun_normal scale; a transposed conv's fan-in is
    its input channels times its taps), biases 0, BatchNorm identity,
    fusion weights by the model's ``fusion_init``."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
                fan_in = mod.weight[0].numel()
                if isinstance(mod, nn.ConvTranspose2d):
                    fan_in = mod.weight[:, 0].numel()
                mod.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=g)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.BatchNorm2d):
                mod.reset_parameters()
            elif isinstance(mod, Weights):
                mod.reset_parameters(g)


def randomize_batchnorm(model: nn.Module, seed: int) -> None:
    """Non-trivial BatchNorm statistics and affines, so that an eval-mode
    run tests the folded and unfolded norms for real: running mean
    N(0, 0.5), running var U(0.5, 1.5), weight U(0.5, 1.5), bias
    N(0, 0.2)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.BatchNorm2d):
                mod.running_mean.normal_(0, 0.5, generator=g)
                mod.running_var.uniform_(0.5, 1.5, generator=g)
                mod.weight.uniform_(0.5, 1.5, generator=g)
                mod.bias.normal_(0, 0.2, generator=g)
