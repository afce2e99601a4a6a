"""Decoder branches: DORN ordinal heads and relative (comparison + ALS)
heads.

Port of ``md_rdm_tpu/models/decoder.py``.  Each decoder: a 24-layer dense
block (bn_size 8) on the 8x8x1056 encoder features -> 2208 channels ->
a WSM cascade of (id - 1) % 5 stages -> head:

  * id 1: 1x1 conv to 180 channels -> DORN decode;
  * ids 2-5: no head conv, the cascade output goes straight into DORN
    (ord_num = channels / 2), as in the reference;
  * ids 6-10: 1x1 conv to 1 channel -> the relative tail
    (:func:`relative_tail`, run by the model over all its relative
    decoders at once): comparison matrix, Lloyd quantization, ALS fill.

The head runs in the compute dtype; the relative tail always runs in
float32.  In train mode the dense block's norms use batch statistics; the
hard DORN decode and the quantization carry no gradient.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from md_rdm_tpu_torch.core import trace
from md_rdm_tpu_torch.core.config import DECODER_SIZES
from md_rdm_tpu_torch.kernels.lloyd import (fused_comparison_quantize_many,
                                            segment_pages)
from md_rdm_tpu_torch.models.densenet import DenseBlock, conv
from md_rdm_tpu_torch.models.routing import Routing
from md_rdm_tpu_torch.models.wsm import WSMCascade, wsm_output_planes
from md_rdm_tpu_torch.ops.als import als_factorize_grouped, quadratic_als
from md_rdm_tpu_torch.ops.comparison import comparison_v1
from md_rdm_tpu_torch.ops.paging import merge_pages
from md_rdm_tpu_torch.ops.quantize import lloyd_quantize
from md_rdm_tpu_torch.ops.resize import resize_bicubic

# Relative maps of this size and more are paged into 16x16 tiles.
PAGE = 16


def dorn_decode(logits: torch.Tensor,
                soft: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """DORN ordinal regression on NHWC logits (C = 2 * ord_num).

    Logits are clamped to [1e-8, 1e4]; each (A, B) pair's softmax is
    sigmoid(B - A).  Returns (decoded (B,1,H,W) float32, probs
    (B,ord_num,H,W)).  The decode counts pairs with P > 0.5, or sums P
    when ``soft``.
    """
    x = torch.clamp(logits.float(), 1e-8, 1e4)
    probs = torch.sigmoid(x[..., 1::2] - x[..., 0::2])
    if soft:
        decoded = probs.sum(-1)
    else:
        decoded = (probs > 0.5).sum(-1).float()
    return decoded[:, None], probs.permute(0, 3, 1, 2)


def cross_scale_pages(d: torch.Tensor, size: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """A (B, 1, size, size) relative map and its bicubic half as the plain
    comparison's operands: (dn (B*P, 1, 16, 16), dn_1 (B*P, 1, 8, 8), P),
    pages row-major per image; P = 1 at size 16."""
    return (*segment_pages(d, resize_bicubic(d, size // 2)),
            (size // PAGE) ** 2)


def relative_tail(maps: Dict[int, torch.Tensor],
                  als_iters_quadratic: int = 30, als_iters_rect: int = 100,
                  stages: Optional[Dict[str, Any]] = None
                  ) -> Dict[int, torch.Tensor]:
    """The relative tail: the 1-channel float32 maps of relative decoders,
    by id, filled by ALS.

    Size 8 (decoder 6): full ratio matrix -> quadratic ALS.  Size >= 16:
    cross-scale matrices against the bicubic half, every such decoder's
    16x16 / 8x8 pages in one launch of kernel B4, then one rectangular
    ALS loop over that one buffer, with one RMSE-selection group per
    decoder and page (the reference's one call per page); pages are
    merged back.  ``stages`` receives ``sparse_<id>`` (the quantized
    matrices, views of the buffer) and ``filled_<id>`` (the ALS output,
    pages unmerged).  Each ALS call's input and chosen iterates are kept
    (``core/trace.py``): ``als.quadratic.d<id>.sparse`` (the quantized
    matrices) and ``.best_iter`` (one value); ``als.pages.sparse`` (B4's
    buffer) and ``als.pages.best_iter`` (one per decoder and page, in
    ``maps``' order).  Every quantization runs before every ALS loop,
    each stage inside its device span (``relative.quantize``,
    ``relative.als``); the counters ``relative.tails``, ``relative.pages``
    (16x16 pages filled) and ``relative.als_steps`` (ALS steps issued)
    move where this runs in Python.  Without maps it does nothing."""
    stages = {} if stages is None else stages
    if not maps:
        return {}
    device = next(iter(maps.values())).device
    quad = [did for did in maps if DECODER_SIZES[did] == 8]
    rect = [(did, d, DECODER_SIZES[did]) for did, d in maps.items()
            if DECODER_SIZES[did] != 8]
    pages = [(size // PAGE) ** 2 for _, _, size in rect]
    counts = [d.shape[0] * p for (_, d, _), p in zip(rect, pages)]
    trace.count("relative.tails")
    trace.count("relative.pages", sum(counts))
    trace.count("relative.als_steps", len(quad) * als_iters_quadratic
                + (als_iters_rect if rect else 0))
    with trace.device_span("relative.quantize", device):
        for did in quad:
            stages[f"sparse_{did}"] = lloyd_quantize(
                comparison_v1(maps[did]), 8)
            trace.keep(f"als.quadratic.d{did}.sparse",
                       stages[f"sparse_{did}"])
        if rect:
            sparse = fused_comparison_quantize_many(
                [(d, resize_bicubic(d, size // 2), size)
                 for _, d, size in rect])
            trace.keep("als.pages.sparse", sparse)
    filled: Dict[int, torch.Tensor] = {}
    with trace.device_span("relative.als", device):
        for did in quad:
            filled[did] = quadratic_als(
                stages[f"sparse_{did}"], n=3, num_iters=als_iters_quadratic,
                kept=f"als.quadratic.d{did}.best_iter")
            stages[f"filled_{did}"] = filled[did]
        if rect:
            group_ids = torch.cat([
                sum(pages[:i]) + torch.arange(n, device=device) % p
                for i, (n, p) in enumerate(zip(counts, pages))])
            tiles = als_factorize_grouped(
                sparse, PAGE, als_iters_rect, group_ids, sum(pages),
                kept="als.pages.best_iter")
    if not rect:
        return filled
    for (did, _, size), p, sp, t in zip(rect, pages, sparse.split(counts),
                                         tiles.split(counts)):
        stages[f"sparse_{did}"] = sp
        stages[f"filled_{did}"] = t
        filled[did] = t if p == 1 else merge_pages(
            t.reshape(-1, p, 1, PAGE, PAGE), grid=size // PAGE)
    return filled


class Decoder(nn.Module):
    """One decoder branch on NCHW encoder features (channels-last memory,
    compute dtype).  DORN ids return (decode, probs); relative ids the
    1-channel float32 map, which :func:`relative_tail` fills.
    ``routing`` (the model's) goes to the dense block, whose layers route
    at S=8 where it says so."""

    def __init__(self, decoder_id: int, ordinal_channels: int = 180,
                 soft_ordinal_decode: bool = False,
                 routing: Routing = Routing()):
        super().__init__()
        did = decoder_id
        self.decoder_id = did
        self.soft = soft_ordinal_decode
        self.dense_layer = DenseBlock(24, 1056, 8, routing=routing)
        self.wsm_block = WSMCascade((did - 1) % 5)
        if did > 5:
            self.conv1 = nn.Conv2d(wsm_output_planes(did), 1, 1)
        elif did == 1:
            self.conv2 = nn.Conv2d(2208, ordinal_channels, 1)

    def forward(self, x: torch.Tensor):
        x = self.wsm_block(self.dense_layer(x))
        if self.decoder_id > 5:
            return conv(x, self.conv1).float().contiguous()
        if self.decoder_id == 1:
            x = conv(x, self.conv2)
        return dorn_decode(x.permute(0, 2, 3, 1), soft=self.soft)
