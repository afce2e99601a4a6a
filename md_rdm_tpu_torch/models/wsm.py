"""Whole-strip-masking (WSM) upsampling layers of the decoders.

Port of ``md_rdm_tpu/models/wsm.py``.  One stage doubles the resolution:
a 1x1 input adjustment, a 2x2 stride-2 transposed conv, then five branches
concatenated to ``in_channels`` channels:

  * 1x1 (C/4);  1x1 -> 3x3 (C/4);  1x1 -> 5x5 (C/4);
  * 1x1 -> a vertical strip conv, kernel (3, s), stride (1, s), H padded
    by one zero row each side: one column, tiled back along W (C/8);
  * 1x1 -> a horizontal strip conv, kernel (s, 3), stride (s, 1), W padded
    by one zero column each side: one row, tiled back along H (C/8).

Module names and registration order follow the reference
(``tools/torch_replica.py::TorchWSMLayer``): ``deconv1``, ``wsm_wx3`` and
``wsm_3xh`` are ``nn.Sequential`` wrappers, so their keys read
``deconv1.0.*``, ``wsm_wx3.1.*`` and ``wsm_3xh.1.*``.  Activations are NCHW
in channels-last memory, in the compute dtype; the weights stay float32
and are cast at each call, as in ``models/densenet.py``.

A stage runs as matrix products (``torch.mm``, cuBLAS on the card) on the
NHWC rows that its channels-last activations already are (cuDNN's float32
kernels for these convolutions run in NCHW, behind transposes):

  1. the input adjustment: [B S^2, raw] x [raw, C];
  2. the transposed conv: [B S^2, C] x [C, 4C], its weight (C, C, 2, 2)
     viewed as it lies, then one pixel-shuffle copy to the rows of the
     2S x 2S map; its bias passes into the next product's;
  3. the five 1x1 branches: [B 4S^2, C] x [C, C], their weights stacked in
     the output's channel order at each call (nothing is cached);
  4. the 3x3 and the 5x5 on their C/4 columns of 3., at the shapes of
     :data:`TAP_SHAPES`: a zero-padded frame, one product against every
     tap's weights, the k^2 shifted slices summed (:func:`_tap_conv`, the
     form of ``kernels/growth_conv.py``); elsewhere cuDNN on a contiguous
     channels-last copy of the columns, which is faster there;
  5. the strips likewise, as 1-D convolutions whose pixel is a whole row
     (or column) of the map;
  6. one concatenation of the five outputs into the NHWC output.

Float32 products stay float32 under ``core.device.no_tf32``, as the
model's forward runs.  Counters (``core/trace.py``): ``wsm.gemm`` once a
stage, ``wsm.gemm.kxk`` once per 3x3 or 5x5 taken as tap products.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from md_rdm_tpu_torch.core import trace
from md_rdm_tpu_torch.models.densenet import CL, conv

# Cascade table: stage -> (in_channels, strip size after the upsample).
WSM_STAGES = ((1664, 16), (832, 32), (416, 64), (208, 128))
# Channels of the raw encoder-side input of the first stage (the decoder's
# dense block output); later stages take 2 * in_channels.
FIRST_STAGE_INPUT = 2208
# (k, channels, size) of the k x k convolutions of a stage that run as tap
# products: where they beat cuDNN on the contiguous channels-last columns
# in captured timings of batch 16 in float32 on an H100 (chip_smoke.py's
# wsm phase): the third stage's 5x5, 1.50 against 2.42 ms.  Every other
# 3x3 and 5x5 of the four stages lost, by up to 2x, or tied (the second
# stage's 5x5, within 3%; cuDNN holds less memory there).
TAP_SHAPES = frozenset({(5, 104, 64)})


class WSMLayer(nn.Module):
    """One stage: ``raw`` channels at SxS -> ``in_channels`` at 2Sx2S."""

    def __init__(self, in_channels: int, strip_size: int, raw: int):
        super().__init__()
        c, s = in_channels, strip_size
        k_in, w_in = c // 4, c // 8
        self.strip_size = s
        self.deconv1 = nn.Sequential(nn.ConvTranspose2d(c, c, 2, 2))
        self.conv1_1 = nn.Conv2d(c, k_in, 1)
        self.conv1_2 = nn.Conv2d(c, k_in, 1)
        self.conv1_3 = nn.Conv2d(c, k_in, 1)
        self.conv1_4 = nn.Conv2d(c, w_in, 1)
        self.conv1_5 = nn.Conv2d(c, w_in, 1)
        self.conv2_1 = nn.Conv2d(k_in, k_in, 3, padding=1)
        self.conv2_2 = nn.Conv2d(k_in, k_in, 5, padding=2)
        self.wsm_wx3 = nn.Sequential(nn.ZeroPad2d((0, 0, 1, 1)),
                                     nn.Conv2d(w_in, w_in, (3, s), (1, s)))
        self.wsm_3xh = nn.Sequential(nn.ZeroPad2d((1, 1, 0, 0)),
                                     nn.Conv2d(w_in, w_in, (s, 3), (s, 1)))
        self.input_adjustment_layer = nn.Conv2d(raw, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        b, raw, n, _ = x.shape
        ia, de = self.input_adjustment_layer, self.deconv1[0]
        c, s = de.in_channels, 2 * n
        trace.count("wsm.gemm")
        # 1: the input's NHWC rows (a view of its channels-last memory)
        h = torch.addmm(ia.bias.to(dt),
                        x.permute(0, 2, 3, 1).reshape(-1, raw),
                        ia.weight.to(dt).view(c, raw).t())
        # 2: columns (o, ky, kx); the shuffle orders the rows (b, y, x)
        up = torch.mm(h, de.weight.to(dt).view(c, 4 * c))
        del h
        up = up.view(b, n, n, c, 2, 2).permute(0, 1, 4, 2, 5, 3).reshape(
            -1, c)
        # 3: the five 1x1 branches, the transposed conv's bias through them
        branches = (self.conv1_1, self.conv1_2, self.conv1_3, self.conv1_4,
                    self.conv1_5)
        w1 = torch.cat([m.weight.view(-1, c) for m in branches])
        b1 = torch.cat([m.bias for m in branches]) + w1 @ de.bias
        p = torch.addmm(b1.to(dt), up, w1.to(dt).t())
        del up
        p = p.view(b, s, s, c)
        q, w = c // 4, c // 8
        # 4: tap products go in groups of images no larger than p
        budget = p.numel()
        o21 = _square_conv(p[..., q:2 * q], self.conv2_1, budget)
        o22 = _square_conv(p[..., 2 * q:3 * q], self.conv2_2, budget)
        col, row = self.strips(p, budget)
        out = torch.cat([p[..., :q], o21, o22, row.expand(b, s, s, w),
                         col.expand(b, s, s, w)], 3)
        return out.permute(0, 3, 1, 2)

    def strips(self, p: torch.Tensor, budget: int):
        """The strip convolutions (step 5 above) on their C/8 columns of
        the 1x1 product ``p`` (B, S, S, C), NHWC: a column (B, S, 1, C/8),
        to be tiled along W, and a row (B, 1, S, C/8), along H."""
        b, s, _, c = p.shape
        q, w = c // 4, c // 8
        wx3, w3h = self.wsm_wx3[1], self.wsm_3xh[1]
        col = _tap_conv(
            F.pad(p[..., 3 * q:3 * q + w], (0, 0, 0, 0, 1, 1)).reshape(
                b, s + 2, 1, s * w),
            wx3.weight.to(p.dtype).permute(3, 1, 2, 0).reshape(s * w, 3 * w),
            3, 1, wx3.bias, budget)
        row = _tap_conv(
            F.pad(p[..., 3 * q + w:].transpose(1, 2),
                  (0, 0, 0, 0, 1, 1)).reshape(b, 1, s + 2, s * w),
            w3h.weight.to(p.dtype).permute(2, 1, 3, 0).reshape(s * w, 3 * w),
            1, 3, w3h.bias, budget)
        return col, row


def _square_conv(z: torch.Tensor, layer: nn.Conv2d,
                 budget: int) -> torch.Tensor:
    """``layer`` (k x k, padding k // 2) on NHWC ``z`` (B, S, S, G), as
    tap products at :data:`TAP_SHAPES`, else through cuDNN: (B, S, S, G)
    in ``z``'s dtype."""
    k, g = layer.kernel_size[0], layer.out_channels
    if (k, g, z.shape[1]) not in TAP_SHAPES:
        z = z.permute(0, 3, 1, 2).contiguous(memory_format=CL)
        return conv(z, layer).permute(0, 2, 3, 1)
    trace.count("wsm.gemm.kxk")
    frames = F.pad(z, (0, 0) + (k // 2,) * 4)
    # (G_out, G_in, dy, dx) -> [G_in, (dy, dx, G_out)]
    wm = layer.weight.to(z.dtype).permute(1, 2, 3, 0).reshape(-1, k * k * g)
    return _tap_conv(frames, wm, k, k, layer.bias, budget)


def _tap_conv(frames: torch.Tensor, wm: torch.Tensor, kh: int, kw: int,
              bias: torch.Tensor, budget: int) -> torch.Tensor:
    """A (kh, kw) convolution, stride 1, over zero-padded NHWC ``frames``
    (N, Fh, Fw, K).  One product against ``wm`` [K, (dy, dx, G)] gives
    every tap's contribution at every frame pixel, t[n, y, x, dy, dx, :];
    output pixel (y, x) sums t[n, y + dy, x + dx, dy, dx, :] over the taps,
    in float32, read through one strided view of t.  Images go in groups
    whose t holds at most ``budget`` elements (one image at least).
    Returns (N, Fh - kh + 1, Fw - kw + 1, G) plus ``bias`` (float32), in
    ``frames``' dtype."""
    n, fh, fw, k = frames.shape
    g = wm.shape[1] // (kh * kw)
    step = max(1, budget // (fh * fw * kh * kw * g))
    # t's strides along dx, dy, x, y; the view's dy and dx move the source
    # pixel too
    sdx, sdy = g, kw * g
    sx, sy = kh * sdy, fw * kh * sdy
    outs = []
    for i in range(0, n, step):
        f = frames[i:i + step]
        t = torch.mm(f.reshape(-1, k), wm)
        taps = t.as_strided(
            (f.shape[0], fh - kh + 1, fw - kw + 1, kh, kw, g),
            (fh * sy, sy, sx, sy + sdy, sx + sdx, 1))
        outs.append(taps.sum((3, 4), dtype=torch.float32))
    y = outs[0] if len(outs) == 1 else torch.cat(outs)
    return (y + bias).to(frames.dtype)


class WSMCascade(nn.Sequential):
    """``num_layers`` stacked stages ``WSM_1``, ...; empty is identity."""

    def __init__(self, num_layers: int):
        super().__init__()
        raw = FIRST_STAGE_INPUT
        for i in range(num_layers):
            ch, size = WSM_STAGES[i]
            self.add_module(f"WSM_{i + 1}", WSMLayer(ch, size, raw))
            raw = ch


def wsm_output_planes(decoder_id: int) -> int:
    """Channels after a decoder's cascade of (id - 1) % 5 stages."""
    stages = (decoder_id - 1) % 5
    return WSM_STAGES[stages - 1][0] if stages else FIRST_STAGE_INPUT
