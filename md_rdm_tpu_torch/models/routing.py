"""Which path each dense layer and dense block takes: every such decision
and the H100 measurements it is made by.

A dense layer of spatial size S runs conv1 -> norm2 -> ReLU -> conv2
either as one call of the sandwich kernels F1-F3
(``kernels/dense_sandwich.py``, norm2 folded), whose backward is K1-K4 or
autograd through the plain ops, or as separate ops, its 3x3 conv then
``kernels/growth_conv.py::growth_conv_matmul`` or cuDNN's.  A dense block
whose every layer takes the kernels may run flat: one in-place buffer
(``models/densenet.py::DenseBlock``, ``_FlatBlock``).  The encoder's
blocks are at S = 57, 29 and 15 (:data:`ENCODER_SIZES`), every decoder's
at S = 8.  Three ``ModelConfig`` fields (and ``cli/train.py``'s flags of
the same names) choose; :meth:`Routing.of` resolves them once per model:

``fused_dense``
    "on" runs F1-F3 at the sizes :data:`MEASURED` gives for the step's
    mode and dtype, and K1-K4 wherever the train sizes hold S, in either
    mode of the step (elsewhere autograd through the plain ops).
    "on_all" runs F1-F3 at every encoder size in both modes of the step,
    the backward through autograd.  "on_all_bwd" runs F1-F3 and K1-K4 at
    every encoder size.  "off" runs none.  "auto" means "on" on every
    device: the kernels' wrappers run their plain versions on CPU
    tensors, so the CPU port stands for the card (the JAX package
    resolves "auto" to "off" off the TPU).  "interpret" (the JAX
    package's interpreted kernels) means "on_all_bwd": the plain versions
    on the CPU, the kernels on the card.
``flat_block``
    "on" runs flat the blocks at the flat sizes of :data:`MEASURED`;
    "on_all" every encoder block; "interpret" the S=57 block alone; "off"
    none.  "auto" means "on" wherever ``fused_dense`` routes layers ("on",
    "on_all", "on_all_bwd", "interpret", "auto"), else "off".  A block
    runs flat only on a square input whose size every layer takes forward
    through the kernels, and in train backward too, so that no block runs
    flat on the cuDNN path.
``growth_matmul``
    "on_all" runs ``growth_conv_matmul`` in every encoder layer that the
    sandwich does not take; "on" at the measured sizes, which are none
    (the JAX package measured none on the TPU either); "off" and "auto"
    nowhere, as the JAX package resolves "auto" off the TPU.  No decoder
    layer takes it.

The forcing modes ("on_all", "on_all_bwd", "interpret") keep to the
encoder's sizes, as the JAX package's routing functions
(``md_rdm_tpu/kernels/dense_sandwich.py``, ``growth_conv.py``) do.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

# The encoder's three dense blocks' sizes, all the forcing modes take.
ENCODER_SIZES = frozenset({57, 29, 15})


class Sizes(NamedTuple):
    """For one mode of the step and compute dtype: the sizes whose layers
    run F1-F3 (the train sizes: and K1-K4, in either mode of the step),
    and the sizes whose blocks run flat."""
    layers: frozenset
    flat: frozenset


# Layers.  Sizes whose whole dense block runs faster through the kernels
# than through the cuDNN sequence, per mode of the step and compute dtype
# (f32 and bf16 measure apart), at batch 16, NVIDIA H100 80GB HBM3, 700.00
# W.  S=57: F1-F3 27.33 / 5.49 ms against cuDNN's 57.82 / 9.14 (f32 /
# bf16, the six layers' sandwiches), K1-K4 71.10 / 13.74 against
# autograd's 119.09 / 19.13 (chip_smoke.py times_kernel, times_kernel_bwd,
# run "proof6").  S=29 / S=15, the whole block timed per mode
# (chip_smoke.py routing, runs "route2", "full12", "proof12", "proof12b"):
# eval f32 10.89-11.05 / 13.24-13.37 ms routed against 17.57-17.72 /
# 23.29-23.50 unrouted; bf16 S=29 3.36-3.96 against 5.79-5.84; bf16 S=15
# 8.44 / 9.14 / 10.10 / 6.50 against 8.34 / 13.03 / 10.09 / 6.97, a win
# in two runs of four (the host sets these), so not routed.  Train forward
# + backward f32: S=29 52.49-52.94 (K1-K4) against 63.08-63.45; S=15
# 72.40-83.89 against 62.66-63.27 (the batch statistics cost 25-35 ms
# there); bf16 S=29 24.33-45.14 against 17.55-21.19, S=15 60.53-88.63
# against 32.00-51.81.  S=8, the decoders' block (24 layers, C_in 1,056,
# bn_size 8), eval only: the whole block as device time of captured
# launches (chip_smoke.py routing, run "s1"), f32 routed 1.57 / 3.16 ms
# against 4.15 / 7.13 unrouted at batch 1 / 16 (F1 and F2 split K as
# card_splits picks); bf16 1.45 / 1.97 against 1.14 / 1.52, so not
# routed.  It is not in the train tables: S=8 stays off the kernels in
# train.  The train sizes are also where the backward runs K1-K4
# (elsewhere a forward-routed layer's backward is autograd through the
# plain ops, which lost to both at S=29 and S=15: f32 85.28-86.03 /
# 101.70-112.21 ms).
#
# Flat.  Sizes whose whole dense block runs faster as one in-place buffer
# (F3 writing each layer's output into it, K1 / K4 reading the cotangent
# by row) than as the routed block (a cat per layer), per mode of the
# step and compute dtype, under on_all_bwd at batch 16: a size enters
# where chip_smoke.py phase 18 (flat) measured it faster by over 10% in
# every turn, on an NVIDIA H100 80GB HBM3 at 700.00 W (runs "flat2",
# "full13", "proof13"); the JAX package's TPU tables do not carry over.
# bf16 S=15 eval, host-bound: flat / unflat 0.45-0.90 in all five turns
# of "proof13" (least times 7.18 / 8.06 ms; one device operation fewer a
# layer), 0.59-1.29 in the three turns of "flat2" and "full13".  Ties
# (within 10% in some turn): f32 eval at every size (0.990-1.005), bf16
# eval S=57 (0.97-0.98) and S=29 (0.77-1.30).  Train loses at every size:
# f32 1.04 / 1.11 / 1.20-1.38 at S=57 / 29 / 15, bf16 1.16 / 1.05-1.95 /
# 1.17-1.35 (the flat backward recomputes norm1 and norm2's statistics).
# A block runs flat only where its layers route: bf16 S=15 eval does so
# under the forcing fused_dense modes, not under "on".
#
# Keyed by (train, dtype); read at each decision, so that a measurement
# may route a size before the table holds it by replacing this name.
MEASURED = {
    (False, torch.float32): Sizes(frozenset({57, 29, 15, 8}), frozenset()),
    (False, torch.bfloat16): Sizes(frozenset({57, 29}), frozenset({15})),
    (True, torch.float32): Sizes(frozenset({57, 29}), frozenset()),
    (True, torch.bfloat16): Sizes(frozenset({57}), frozenset()),
}

_FORCED_FLAT = {"on_all": ENCODER_SIZES, "interpret": frozenset({57})}


@dataclasses.dataclass(frozen=True)
class Routing:
    """The three modes, given as ``ModelConfig`` takes them (the defaults
    are its defaults) and kept resolved: ``fused`` "on", "on_all",
    "on_all_bwd" or "off"; ``flat`` "on", "on_all", "interpret" or "off";
    ``growth`` "on", "on_all" or "off".  Each method answers for a layer or
    block of spatial size ``s`` in a mode of the step and compute dtype."""

    fused: str = "auto"
    flat: str = "auto"
    growth: str = "auto"

    def __post_init__(self):
        fused = {"auto": "on", "interpret": "on_all_bwd"}.get(self.fused,
                                                              self.fused)
        flat = self.flat
        if flat == "auto":
            flat = "on" if fused in ("on", "on_all", "on_all_bwd") else "off"
        object.__setattr__(self, "fused", fused)
        object.__setattr__(self, "flat", flat)
        object.__setattr__(self, "growth",
                           "off" if self.growth == "auto" else self.growth)

    @classmethod
    def of(cls, config) -> "Routing":
        """The routing of ``config``, a ``ModelConfig``."""
        return cls(config.fused_dense, config.flat_block, config.growth_matmul)

    def fwd(self, s: int, train: bool, dtype: torch.dtype) -> bool:
        """Whether a dense layer runs F1-F3."""
        if self.fused == "on":
            return s in MEASURED[train, dtype].layers
        return self.fused in ("on_all", "on_all_bwd") and s in ENCODER_SIZES

    def bwd(self, s: int, dtype: torch.dtype) -> bool:
        """Whether a layer that runs F1-F3 runs K1-K4 in its backward, in
        either mode of the step (else autograd through the plain ops)."""
        if self.fused == "on":
            return s in MEASURED[True, dtype].layers
        return self.fused == "on_all_bwd" and s in ENCODER_SIZES

    def growth_conv(self, s: int) -> bool:
        """Whether a layer outside the sandwich kernels runs its 3x3 conv
        as ``growth_conv_matmul``."""
        return self.growth == "on_all" and s in ENCODER_SIZES

    def flat_block(self, s: int, train: bool, dtype: torch.dtype) -> bool:
        """Whether a dense block on a square input runs flat: ``flat``
        takes ``s`` and every layer runs F1-F3, and in train K1-K4."""
        sizes = (MEASURED[train, dtype].flat if self.flat == "on"
                 else _FORCED_FLAT.get(self.flat, frozenset()))
        return (s in sizes and self.fwd(s, train, dtype)
                and (not train or self.bwd(s, dtype)))

    def launches(self, s: int, train: bool, dtype: torch.dtype,
                 bwd: bool = False) -> bool:
        """Whether one call of a layer launches each of F1-F3 once (with
        ``bwd``: its backward each of K1-K4 once): a flat block's layers
        run both, every other layer as :meth:`fwd` and :meth:`bwd` say."""
        return self.flat_block(s, train, dtype) or (
            self.fwd(s, train, dtype) and (not bwd or self.bwd(s, dtype)))
