"""The plain reference of the served and trained model, in float32 PyTorch.

It starts from a frozen copy of ``tools/torch_replica.py`` (the reference
repo's module names, so that its state_dict keys are the port's) and adds
what that replica left to the reference repo's own ``computations.py``:
the fusion tail, the relative decoders' tail (comparison, Lloyd
quantization, ALS, paging) and the WSM cascade for every relative id, all
from the frozen plain functions beside this file.  It imports nothing of
``md_rdm_tpu_torch``: no kernel, no graph, no channels-last layout, no
routing.  A relative decoder's tail runs one ALS call per page, as the
reference repo does, where the port runs one grouped loop.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .als import alternating_least_squares, quadratic_als
from .comparison import comparison_cross_scale, comparison_v1
from .decompose import decompose_depth_map, fine_detail_matrices, make_pred
from .geometry import normalize_gm
from .paging import merge_pages, split_matrix
from .quantize import lloyd_quantize
from .resize import resize_bicubic

DECODER_SIZES = {1: 8, 2: 16, 3: 32, 4: 64, 5: 128,
                 6: 8, 7: 16, 8: 32, 9: 64, 10: 128}
SLOT_NAMES = ("d0", "f1", "f2", "f3", "f4", "f5", "f6", "f7")
PAGE = 16
# WSM cascade: stage -> (in_channels, strip size after the upsample)
WSM_STAGES = ((1664, 16), (832, 32), (416, 64), (208, 128))


def decomposition_depth(decoder_id: int) -> int:
    return {8: 3, 16: 4, 32: 5, 64: 6, 128: 7}[DECODER_SIZES[decoder_id]]


def vector_sizes(decoder_ids: Sequence[int]) -> List[int]:
    """Fusion weights per slot: a DORN decoder of size 2**n fills slots
    0..n, a relative one slots 1..n."""
    sizes = [0] * 8
    for d in decoder_ids:
        for slot in range(0 if d <= 5 else 1, decomposition_depth(d) + 1):
            sizes[slot] += 1
    return sizes


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm whose running statistics follow the configuration's
    semantics, flax's: ``ra = 0.9 ra + 0.1 batch`` with the biased batch
    variance (``nn.BatchNorm2d`` would take the unbiased one).  The
    train-mode output normalizes by the batch's biased statistics either
    way."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return F.batch_norm(x, None, None, self.weight, self.bias, True,
                            0.0, self.eps)


class DenseLayer(nn.Module):
    """torchvision _DenseLayer semantics (BN-ReLU-1x1-BN-ReLU-3x3)."""

    def __init__(self, in_ch, bn_size, growth=48):
        super().__init__()
        self.norm1 = BatchNorm2d(in_ch)
        self.conv1 = nn.Conv2d(in_ch, bn_size * growth, 1, bias=False)
        self.norm2 = BatchNorm2d(bn_size * growth)
        self.conv2 = nn.Conv2d(bn_size * growth, growth, 3, padding=1,
                               bias=False)

    def forward(self, x):
        h = self.conv1(torch.relu(self.norm1(x)))
        return self.conv2(torch.relu(self.norm2(h)))


class DenseBlock(nn.Module):
    def __init__(self, layers, in_ch, bn_size, growth=48):
        super().__init__()
        for i in range(layers):
            self.add_module(f"denselayer{i + 1}",
                            DenseLayer(in_ch + i * growth, bn_size, growth))

    def forward(self, x):
        for layer in self.children():
            x = torch.cat([x, layer(x)], 1)
        return x


class Transition(nn.Module):
    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.norm = BatchNorm2d(in_ch)
        self.conv = nn.Conv2d(in_ch, out_ch, 1, bias=False)

    def forward(self, x):
        return F.avg_pool2d(self.conv(torch.relu(self.norm(x))), 2, 2)


class Encoder(nn.Module):
    """226x226x3 -> 8x8x1056 (the reference repo's RDM_Net.py:515-534)."""

    def __init__(self):
        super().__init__()
        self.conv_e1 = nn.Conv2d(3, 96, 7, stride=2, padding=3)
        self.dense_e2 = DenseBlock(6, 96, 57)
        self.trans_e2 = Transition(384, 192)
        self.dense_e3 = DenseBlock(12, 192, 29)
        self.trans_e3 = Transition(768, 384)
        self.dense_e4 = DenseBlock(36, 384, 15)
        self.trans_e4 = Transition(2112, 1056)

    def forward(self, x):
        pad = (0, 1, 0, 1)   # ZeroPad2d bottom/right
        x = F.max_pool2d(self.conv_e1(x), 3, 2, 1)
        x = self.trans_e2(F.pad(self.dense_e2(x), pad))
        x = self.trans_e3(F.pad(self.dense_e3(x), pad))
        return self.trans_e4(F.pad(self.dense_e4(x), pad))


class WSMLayer(nn.Module):
    """One whole-strip-masking stage (RDM_Net.py:163-236)."""

    def __init__(self, in_channels, kernel_size, raw):
        super().__init__()
        k_in, w_in = in_channels // 4, in_channels // 8
        self.deconv1 = nn.Sequential(
            nn.ConvTranspose2d(in_channels, in_channels, 2, 2))
        self.conv1_1 = nn.Conv2d(in_channels, k_in, 1)
        self.conv1_2 = nn.Conv2d(in_channels, k_in, 1)
        self.conv1_3 = nn.Conv2d(in_channels, k_in, 1)
        self.conv1_4 = nn.Conv2d(in_channels, w_in, 1)
        self.conv1_5 = nn.Conv2d(in_channels, w_in, 1)
        self.conv2_1 = nn.Conv2d(k_in, k_in, 3, padding=1)
        self.conv2_2 = nn.Conv2d(k_in, k_in, 5, padding=2)
        self.wsm_wx3 = nn.Sequential(
            nn.ZeroPad2d((0, 0, 1, 1)),
            nn.Conv2d(w_in, w_in, (3, kernel_size), (1, kernel_size)))
        self.wsm_3xh = nn.Sequential(
            nn.ZeroPad2d((1, 1, 0, 0)),
            nn.Conv2d(w_in, w_in, (kernel_size, 3), (kernel_size, 1)))
        self.input_adjustment_layer = nn.Conv2d(raw, in_channels, 1)

    def forward(self, x):
        x = self.input_adjustment_layer(x)
        up = self.deconv1(x)
        o11 = self.conv1_1(up)
        o21 = self.conv2_1(self.conv1_2(up))
        o22 = self.conv2_2(self.conv1_3(up))
        col = self.wsm_wx3(self.conv1_4(up))
        row = self.wsm_3xh(self.conv1_5(up))
        ch = col.repeat(1, 1, 1, col.shape[2])
        cv = row.repeat(1, 1, row.shape[3], 1)
        return torch.cat((o11, o21, o22, cv, ch), 1)


class Decoder(nn.Module):
    """Dense block (24 layers, bn_size 8) -> WSM cascade of (id - 1) % 5
    stages -> head: id 1 a 180-channel 1x1 conv and the DORN decode, ids
    6-10 a 1-channel 1x1 conv (the relative map)."""

    def __init__(self, did, ordinal_channels=180):
        super().__init__()
        if did != 1 and did <= 5:
            raise ValueError(f"the reference has no DORN decoder {did}")
        self.did = did
        self.dense_layer = DenseBlock(24, 1056, 8)
        self.wsm_block = nn.Sequential()
        raw = 2208
        for stage in range((did - 1) % 5):
            ch, k = WSM_STAGES[stage]
            self.wsm_block.add_module(f"WSM_{stage + 1}",
                                      WSMLayer(ch, k, raw))
            raw = ch
        if did == 1:
            self.conv2 = nn.Conv2d(2208, ordinal_channels, 1)
        else:
            self.conv1 = nn.Conv2d(raw, 1, 1)

    def forward(self, x):
        x = self.wsm_block(self.dense_layer(x))
        if self.did > 5:
            return self.conv1(x)
        x = self.conv2(x)
        # DORN decode: clamp, pairwise softmax == sigmoid(B - A), decode =
        # count of P > 0.5
        a = x[:, 0::2].clamp(1e-8, 1e4)
        b = x[:, 1::2].clamp(1e-8, 1e4)
        probs = torch.sigmoid(b - a)
        # how far each pair's raw logits lie from flipping its count:
        # clamp(B) > clamp(A) changes where raw B crosses max(raw A, floor)
        margin = (x[:, 1::2] - x[:, 0::2].clamp(min=1e-8)).abs()
        return (probs > 0.5).sum(1, keepdim=True).float(), probs, margin


class WeightLayer(nn.Module):
    def __init__(self, sizes):
        super().__init__()
        for name, size in zip(SLOT_NAMES, sizes):
            setattr(self, name, nn.Parameter(torch.zeros(size, 1)))

    def forward(self, matrices):
        weights = [w for w in (getattr(self, n) for n in SLOT_NAMES)
                   if w.numel()]
        return make_pred(weights, matrices)


@torch.no_grad()
def relative_fill(d: torch.Tensor, did: int, iters_quadratic: int,
                  iters_rect: int) -> torch.Tensor:
    """One relative decoder's map (B, 1, S, S) -> its ALS fill, the
    reference repo's way: the 8x8 map's full ratio matrix and a quadratic
    ALS; a larger map's 16x16 pages against the bicubic half, each page
    index quantized and filled by its own ALS call over the batch, then
    merged."""
    size = DECODER_SIZES[did]
    d = d.float()
    if size == 8:
        return quadratic_als(lloyd_quantize(comparison_v1(d), 8), n=3,
                             num_iters=iters_quadratic)
    dn, dn_1 = split_matrix(d, resize_bicubic(d, size // 2), PAGE)
    b, pages = dn.shape[:2]
    filled = torch.stack([
        alternating_least_squares(
            lloyd_quantize(comparison_cross_scale(dn[:, j], dn_1[:, j]),
                           size), n=4, num_iters=iters_rect)
        for j in range(pages)], 1)               # (B, P, 1, 16, 16)
    return filled[:, 0] if pages == 1 else merge_pages(filled,
                                                       grid=size // PAGE)


class ReferenceModel(nn.Module):
    """The whole model for a configuration's ``model`` fields; NHWC images
    (B, 226, 226, 3) -> (yhat components, ordinal decode, ordinal probs,
    ordinal margins: how far each pair's raw logits lie from flipping
    the decode's count)."""

    def __init__(self, model_fields: Dict):
        super().__init__()
        self.ids = tuple(model_fields.get("decoder_ids", (1,)))
        self.eps = float(model_fields.get("fusion_eps", 0.0))
        self.iters_q = int(model_fields.get("als_iters_quadratic", 30))
        self.iters_r = int(model_fields.get("als_iters_rect", 100))
        self.encoder = Encoder()
        for did in self.ids:
            self.add_module(f"d_{did}", Decoder(
                did, model_fields.get("ordinal_channels", 180)))
        self.weight_layer = WeightLayer(vector_sizes(self.ids))

    def heads(self, images) -> Dict[int, object]:
        """Each decoder's head output: (decode, probs, margins) for DORN
        ids, the raw 1-channel map for relative ids."""
        feats = self.encoder(images.permute(0, 3, 1, 2))
        return {did: getattr(self, f"d_{did}")(feats) for did in self.ids}

    def fusion_map(self, did: int, out) -> torch.Tensor:
        """A decoder's map as the fusion tail takes it: a DORN decode over
        its geometric mean, a relative fill clipped to [eps, 1/eps]."""
        if did <= 5:
            return normalize_gm(out[0])
        return self.clip(relative_fill(out, did, self.iters_q, self.iters_r))

    def clip(self, m: torch.Tensor) -> torch.Tensor:
        return torch.clamp(m, self.eps, 1.0 / self.eps) if self.eps else m

    def fuse(self, maps: Dict[int, torch.Tensor]):
        """The yhat components of the decoders' fusion maps."""
        rows = [decompose_depth_map(maps[did], decomposition_depth(did),
                                    relative_map=did > 5, eps=self.eps)
                for did in self.ids]
        return self.weight_layer(fine_detail_matrices(rows, eps=self.eps))

    def forward(self, images):
        heads = self.heads(images)
        ordinal = next((heads[d] for d in self.ids if d <= 5),
                       (None, None, None))
        yhat = self.fuse({did: self.fusion_map(did, heads[did])
                          for did in self.ids})
        return (yhat, *ordinal)
