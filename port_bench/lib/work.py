"""The work the model must do, counted from shapes: frozen copies of
``md_rdm_tpu_torch/kernels/dense_sandwich.py``'s ``sandwich_flops``,
``sandwich_bytes`` and ``sandwich_bwd_bytes``, the encoder's dense layers
and their roofline bounds, and the model's FLOPs per image.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from port_bench.lib.peaks import bound_s
from port_bench.reference.model import ReferenceModel

GROWTH = 48
ITEMSIZE = {"float32": 4, "bfloat16": 2}
# the encoder's dense blocks by state_dict path: (S, layers, input
# channels); bn_size = S, so each layer expands to S * 48 channels
ENCODER_BLOCKS: Dict[str, Tuple[int, int, int]] = {
    "encoder.dense_e2": (57, 6, 96),
    "encoder.dense_e3": (29, 12, 192),
    "encoder.dense_e4": (15, 36, 384),
}


def sandwich_flops(b: int, s: int, c_in: int, c_mid: int,
                   growth: int = GROWTH) -> int:
    """Multiply-add operations (x2) of one sandwich: 1x1 expand plus the
    3x3 growth conv."""
    return 2 * b * s * s * c_mid * (c_in + 9 * growth)


def sandwich_bytes(b: int, s: int, c_in: int, c_mid: int, itemsize: int,
                   growth: int = GROWTH) -> int:
    """Bytes the function must move: x, w1, w2 and out once each in the
    compute dtype, scale and shift in float32."""
    elems = (b * s * s * c_in + c_in * c_mid + 9 * c_mid * growth
             + b * s * s * growth)
    return elems * itemsize + 2 * c_mid * 4


def sandwich_bwd_bytes(b: int, s: int, c_in: int, c_mid: int, itemsize: int,
                       growth: int = GROWTH) -> int:
    """Bytes the backward must move: x, g, w1 and w2 read and dx written in
    the compute dtype; scale and shift read and dw1, dw2, dscale and dshift
    written in float32."""
    pix = b * s * s
    dt_elems = 2 * pix * c_in + pix * growth + c_in * c_mid + 9 * c_mid * growth
    f32_elems = 2 * c_mid + c_in * c_mid + 9 * c_mid * growth + 2 * c_mid
    return dt_elems * itemsize + f32_elems * 4


def block_layers(path: str):
    """(S, c_in, c_mid) of each layer of an encoder dense block."""
    s, n, c0 = ENCODER_BLOCKS[path]
    return [(s, c0 + i * GROWTH, s * GROWTH) for i in range(n)]


def block_bound_s(path: str, batch: int, dtype: str, train: bool) -> float:
    """The least time of a block's dense layers: per layer the larger of
    operations over the peak and bytes over the bandwidth, summed.  The
    forward counts one sandwich; forward plus backward counts 3x its
    operations (recomputation not counted) and the backward's bytes too."""
    item = ITEMSIZE[dtype]
    total = 0.0
    for s, c_in, c_mid in block_layers(path):
        flops = sandwich_flops(batch, s, c_in, c_mid)
        nbytes = sandwich_bytes(batch, s, c_in, c_mid, item)
        if train:
            flops *= 3
            nbytes += sandwich_bwd_bytes(batch, s, c_in, c_mid, item)
        total += bound_s(flops, nbytes, dtype)
    return total


def conv_flops(mod: nn.Module, inp: torch.Tensor, out: torch.Tensor) -> int:
    """Multiply-adds x2 of one convolution call."""
    kh, kw = mod.kernel_size
    if isinstance(mod, nn.ConvTranspose2d):
        return 2 * inp.numel() * mod.out_channels * kh * kw // mod.groups
    return 2 * out.numel() * (mod.in_channels // mod.groups) * kh * kw


def model_flops_per_image(model_fields: Dict) -> int:
    """The forward's FLOPs per image: every convolution and transposed
    convolution of the encoder and the decoders at their real shapes,
    counted on the meta device.  The fusion tail, the relative decoders'
    comparison, quantization and ALS, and elementwise work are left out."""
    with torch.device("meta"):
        ref = ReferenceModel(model_fields)
    total = [0]

    def hook(mod, args, out):
        total[0] += conv_flops(mod, args[0], out)

    for mod in ref.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            mod.register_forward_hook(hook)
    size = int(model_fields.get("image_size", 226))
    with torch.no_grad():
        feats = ref.encoder(torch.empty(1, 3, size, size, device="meta"))
        for did in ref.ids:
            getattr(ref, f"d_{did}")(feats)
    return total[0]
