"""Dense-layer sandwich ``conv3x3(relu(conv1x1(x)*scale+shift))`` and its
gradient.

Port of ``md_rdm_tpu/kernels/dense_sandwich.py::_kernel`` (the TPU kernel,
reached through ``_pallas_sandwich``) and of its backward kernels.  On CUDA
tensors :func:`dense_sandwich` runs three hand-written kernels of
``csrc/dense_sandwich.cu``: F1 :func:`fwd_expand` (r = the 1x1 expand,
affine and ReLU), F2 :func:`fwd_taps` (the nine 3x3 taps as one product
with r) and F3 :func:`fwd_tapsum` (the taps' shifted windows summed); the
source's header states the kernels' bound on an H100 and what the design
does about it.  Where a product's tiles cannot fill the card, F1 and F2
split K across a thread-block cluster (:func:`k_splits`).  On CPU
tensors, and only there, it runs their plain stages composed
(:func:`fwd_stages_reference`: the kernels' function and dtype
semantics; :func:`dense_sandwich_reference` is the unrouted layer's,
which in bfloat16 also rounds z before the affine).

Layouts: ``x`` is NHWC ``[B, S, S, C_in]`` in the compute dtype (float32
or bfloat16), already through norm1 and ReLU; ``w1`` ``[C_mid, C_in, 1, 1]``
and ``w2`` ``[48, C_mid, 3, 3]`` are the layer's conv weights as
``nn.Conv2d`` holds them (any float dtype, cast to the compute dtype);
``scale`` and ``shift`` ``[C_mid]`` are norm2 folded into an affine, in
float32.  The result is NHWC ``[B, S, S, 48]`` in the compute dtype.

Under autograd the sandwich is :class:`SandwichFunction`: the three
forward kernels, then :func:`dense_sandwich_bwd`, the four backward kernels
of the same source (port of ``_bwd_kernel`` and ``_bwd_kernel_flat``),
which recompute z from the saved input instead of keeping it.
:func:`conv_bn_stats` gives norm2's train-mode batch statistics without
materializing z.  Which dense layers take the kernels, and which dense
blocks run as one in-place buffer, ``models/routing.py`` decides; in
such a block F3 writes y by row stride into the block's buffer, and K1
and K4 read the cotangent by row stride from the block's cotangent (the
port of ``_kernel_flat`` / ``_bwd_kernel_flat``'s block-native I/O).
Each kernel's wrapper counts its launches (``kernel.<name>.launches`` in
``core/trace.py``; F1 and F2 also ``kernel.<name>.split``) and has its
plain stage beside it.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from md_rdm_tpu_torch.core import mesh as mesh_lib
from md_rdm_tpu_torch.core import trace
from md_rdm_tpu_torch.kernels import _build

GROWTH = 48
GK = 9 * GROWTH     # the nine 3x3 taps' columns: tap * 48 + channel
# C_in and C_mid are multiples of 48 channels (the bf16 k tile).
CHUNK = 48

def dense_sandwich_reference(x, w1, scale, shift, w2):
    """Plain PyTorch version, with the dtype semantics of the JAX
    ``reference_sandwich``: conv1 in the compute dtype, affine and ReLU in
    float32, conv2 in the compute dtype."""
    dt = x.dtype
    z = F.conv2d(x.permute(0, 3, 1, 2), w1.to(dt))
    z = z.float() * scale[:, None, None] + shift[:, None, None]
    z = torch.relu(z).to(dt)
    return F.conv2d(z, w2.to(dt), padding=1).permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=None)
def _lib():
    """The sandwich kernels' C launchers, built and loaded at first use."""
    lib = _build.load("dense_sandwich")
    for name, n_ptr, n_int in (("sandwich_fwd_expand", 5, 5),
                               ("sandwich_fwd_taps", 3, 4),
                               ("sandwich_fwd_tapsum", 2, 4),
                               ("sandwich_bwd_recompute", 10, 6),
                               ("sandwich_bwd_dx", 3, 5),
                               ("sandwich_bwd_dw1", 3, 5),
                               ("sandwich_bwd_dw2", 3, 5)):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.sandwich_fwd_clusters.argtypes = [ctypes.c_int] * 3
    lib.sandwich_fwd_clusters.restype = ctypes.c_int
    return lib


def _launch(name, device, *args):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(_lib(), name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")


def _check(x, w1, scale, shift, w2=None):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dense_sandwich: unsupported dtype {x.dtype}")
    if x.dim() != 4 or x.shape[1] != x.shape[2]:
        raise ValueError(f"dense_sandwich: x must be [B,S,S,C], got "
                         f"{tuple(x.shape)}")
    b, s, _, c_in = x.shape
    c_mid = w1.shape[0]
    if tuple(w1.shape) != (c_mid, c_in, 1, 1):
        raise ValueError(f"dense_sandwich: w1 {tuple(w1.shape)} does not "
                         f"match C_in={c_in}")
    if w2 is not None and tuple(w2.shape) != (GROWTH, c_mid, 3, 3):
        raise ValueError(f"dense_sandwich: w2 {tuple(w2.shape)} is not "
                         f"[{GROWTH}, {c_mid}, 3, 3]")
    for name, t in (("scale", scale), ("shift", shift)):
        if tuple(t.shape) != (c_mid,) or t.dtype != torch.float32:
            raise ValueError(f"dense_sandwich: {name} must be float32 "
                             f"[{c_mid}]")
    if (b < 1 or b > 65535 or c_in % CHUNK or c_in < 2 * CHUNK
            or c_mid % CHUNK or c_mid < CHUNK):
        raise ValueError(f"dense_sandwich: the kernels take 1 <= B <= 65535, "
                         f"C_in a multiple of {CHUNK} from {2 * CHUNK} and "
                         f"C_mid a multiple of {CHUNK}; got B={b}, "
                         f"C_in={c_in}, C_mid={c_mid}")
    for name, t in (("x", x), ("w1", w1), ("w2", w2), ("scale", scale),
                    ("shift", shift)):
        if t is not None and t.device != x.device:
            raise ValueError(f"dense_sandwich: {name} is on {t.device}, "
                             f"x on {x.device}")
    if not x.is_contiguous():
        raise ValueError("dense_sandwich: x must be a contiguous NHWC "
                         "tensor (a channels-last activation, permuted)")
    if x.data_ptr() % 16:
        raise ValueError("dense_sandwich: x must be 16-byte aligned")


def _on_card(who, t):
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: unsupported device {t.device}")
    return t.device.type == "cuda"


def _check_operand(who, name, t, shape, dtype, device):
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype
            or t.device != device or not t.is_contiguous()
            or t.data_ptr() % 16):
        raise ValueError(f"{who}: {name} must be a contiguous 16-byte "
                         f"aligned {dtype} tensor {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def row_stride(t) -> int | None:
    """The row stride ``ld`` of an NHWC tensor [B, S, S, 48] whose pixels
    lie ``ld`` elements apart (strides (S*S*ld, S*ld, ld, 1), ``ld`` a
    multiple of 48): 48 for a contiguous tensor, the block's channel count
    for a 48-channel slot of a dense block's buffer.  None for any other
    layout."""
    if t.dim() != 4 or t.shape[3] != GROWTH or t.stride(3) != 1:
        return None
    s, ld = t.shape[2], t.stride(2)
    if (ld % GROWTH or t.stride(1) != s * ld
            or t.stride(0) != t.shape[1] * s * ld):
        return None
    return ld


def _check_rows(who, name, t, shape, dtype, device) -> int:
    """The row stride of ``t``, a [B, S, S, 48] operand F3 writes or K1
    and K4 read by row (:func:`row_stride`), 16-byte aligned; raises for
    any other tensor."""
    ld = row_stride(t)
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype
            or t.device != device or ld is None or t.data_ptr() % 16):
        raise ValueError(f"{who}: {name} must be a 16-byte aligned {dtype} "
                         f"tensor {tuple(shape)} on {device} whose pixels lie "
                         f"a multiple of {GROWTH} elements apart (contiguous, "
                         f"or a {GROWTH}-channel slot of a block's buffer), "
                         f"got {t.dtype} {tuple(t.shape)} strides "
                         f"{t.stride()} on {t.device}")
    return ld


def _rows(g, dtype):
    """The cotangent ``g`` in ``dtype`` as K1 and K4 read it: as it is
    where its pixels lie a row stride apart, else a contiguous copy."""
    g = g.to(dtype)
    return g if row_stride(g) is not None and not g.data_ptr() % 16 \
        else g.contiguous()


def w1_cols(w1, dtype):
    """The 1x1 conv weight w1 [C_mid, C_in, 1, 1] as F1's and K1's operand:
    [C_in, C_mid] in ``dtype``."""
    return w1.detach().flatten(1).t().to(dtype)


def w2_cols(w2, dtype):
    """The 3x3 conv weight w2 [48, C_mid, 3, 3] as F2's operand w2n:
    [C_mid, 432] in ``dtype``, column tap*48 + g = w2[g, :, ky, kx] with
    tap = 3*ky + kx, so that r @ w2n holds every tap's product."""
    return w2.detach().permute(1, 2, 3, 0).reshape(w2.shape[1], GK).to(dtype)


class SandwichWeights(NamedTuple):
    """One layer's weights as given (the plain version's operands), and
    laid out for the kernels in the compute dtype: ``w1t`` [C_in, C_mid]
    (:func:`w1_cols`), ``w2n`` [C_mid, 432] (:func:`w2_cols`)."""
    w1: torch.Tensor
    scale: torch.Tensor
    shift: torch.Tensor
    w2: torch.Tensor
    w1t: torch.Tensor
    w2n: torch.Tensor


def pack_weights(w1, scale, shift, w2, dtype: torch.dtype) -> SandwichWeights:
    """Lay a layer's weights out for the kernels; a routed layer does it
    at each forward (``DenseLayer.sandwich_weights``)."""
    return SandwichWeights(w1, scale, shift, w2,
                           w1_cols(w1, dtype).contiguous(),
                           w2_cols(w2, dtype).contiguous())


def dense_sandwich(x, w1, scale, shift, w2):
    """The sandwich.  CPU tensors take the plain version; CUDA tensors
    launch F1-F3 (counting one call in ``kernel.dense_sandwich.launches``) or
    raise.  Differentiable: see :class:`SandwichFunction`."""
    return dense_sandwich_packed(x, pack_weights(w1, scale, shift, w2,
                                                 x.dtype))


def dense_sandwich_packed(x, p: SandwichWeights, kernel_bwd: bool = True,
                          replay: bool = False, out=None):
    """:func:`dense_sandwich` on weights from :func:`pack_weights`.  When
    autograd needs the sandwich's gradient it goes through
    :class:`SandwichFunction`, whose backward runs K1-K4 (``kernel_bwd``)
    or autograd through the plain version (the JAX package's
    ``pallas_bwd=False``).  ``replay``: the backward's recomputation of a
    rematerialized layer, which records the call (its inputs, all the
    backward reads) but runs no kernel and returns an empty y.  ``out``, a
    [B, S, S, 48] view whose pixels lie a row stride apart
    (:func:`row_stride`: a 48-channel slot of a dense block's buffer),
    takes y in place; it is for callers that run their own backward
    (``models/densenet.py::_FlatBlock``), so autograd must not need
    this call's gradient."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, p.w1, p.scale, p.shift, p.w2)):
        if out is not None:
            raise ValueError("dense_sandwich_packed: out= is not "
                             "differentiable; call it without autograd")
        return SandwichFunction.apply(x, p.w1, p.scale, p.shift, p.w2, p,
                                      kernel_bwd, replay)
    if replay:
        return x.new_empty((*x.shape[:3], GROWTH))
    return _forward(x, p, out)


def _forward(x, p: SandwichWeights, out=None):
    if not _on_card("dense_sandwich", x):
        return fwd_stages_reference(x, p.w1, p.scale, p.shift, p.w2, out)
    _check(x, p.w1, p.scale, p.shift, p.w2)
    b, s = x.shape[:2]
    r = fwd_expand(x, p.w1, p.scale, p.shift, p.w1t)
    taps = fwd_taps(r, p.w2, p.w2n)
    del r
    y = fwd_tapsum(taps.view(b, s, s, GK), x.dtype, out)
    trace.count("kernel.dense_sandwich.launches")
    return y



class SandwichFunction(torch.autograd.Function):
    """The sandwich under autograd: forward :func:`dense_sandwich_packed`'s
    kernels (no z or r kept: only the inputs are saved).  Backward
    :func:`dense_sandwich_bwd`, which recomputes z, or with ``kernel_bwd``
    False autograd through :func:`dense_sandwich_reference` recomputed from
    the inputs (no K1-K4 stage runs).  Gradients come back in the inputs'
    own layouts (OIHW conv weights, float32 for the weights and the
    affine, the compute dtype for x)."""

    @staticmethod
    def forward(ctx, x, w1, scale, shift, w2, packed: SandwichWeights,
                kernel_bwd: bool = True, replay: bool = False):
        ctx.save_for_backward(x, w1, scale, shift, w2)
        ctx.w1t = packed.w1t
        ctx.kernel_bwd = kernel_bwd
        if replay:
            return x.new_empty((*x.shape[:3], GROWTH))
        return _forward(x, packed)

    @staticmethod
    def backward(ctx, gy):
        args = ctx.saved_tensors
        if ctx.kernel_bwd:
            grads = dense_sandwich_bwd(*args, gy, ctx.w1t)
        else:
            leaves = [t.detach().requires_grad_() for t in args]
            with torch.enable_grad():
                y = dense_sandwich_reference(*leaves)
            grads = torch.autograd.grad(y, leaves, gy)
        return (*grads, None, None, None)


# ---- forward: three kernels ------------------------------------------------
# F1 writes r [P, C_mid] in the compute dtype (P = B*S*S), F2 the nine taps'
# products T9 [P, 432] in float32, F3 sums T9's shifted windows into y.  The
# plain stages compose to the TPU kernel's function (z summed in float32,
# r rounded once, the taps summed in float32, y rounded once).

def _expand(x, w1, scale, shift):
    """z and a = z * scale + shift, float32 NCHW, summed from compute-dtype
    operands, and r = relu(a) as rows [P, C_mid] rounded to x's dtype: the
    one formula behind F1's and K1's plain stages."""
    dt = x.dtype
    z = F.conv2d(x.permute(0, 3, 1, 2).float(), w1.detach().to(dt).float())
    a = z * scale.detach()[:, None, None] + shift.detach()[:, None, None]
    r = torch.relu(a).permute(0, 2, 3, 1).reshape(-1, w1.shape[0]).to(dt)
    return r, z, a


def fwd_expand_reference(x, w1, scale, shift):
    """F1's plain version: r [P, C_mid] in x's dtype."""
    return _expand(x, w1, scale, shift)[0]


def fwd_taps_reference(r, w2):
    """F2's plain version: T9 [P, 432] = r @ w2_cols(w2), float32 sums of
    compute-dtype operands."""
    return r.float() @ w2_cols(w2, r.dtype).float()


def fwd_tapsum_reference(taps, dtype, out=None):
    """F3's plain version: taps [B, S, S, 432] float32 -> y [B, S, S, 48]
    in ``dtype``, y[b, i, j] = sum over tap = 3*ky + kx of taps[b, i + ky
    - 1, j + kx - 1, tap*48:(tap+1)*48], taps outside the image adding
    nothing (the 3x3 conv's zero padding of r), summed in tap order.  With
    ``out`` (a row-strided view, :func:`row_stride`) y is written there
    and returned."""
    b, s = taps.shape[:2]
    tp = F.pad(taps, (0, 0, 1, 1, 1, 1))
    y = torch.zeros((b, s, s, GROWTH), dtype=torch.float32,
                    device=taps.device)
    for tap in range(9):
        ky, kx = divmod(tap, 3)
        y = y + tp[:, ky:ky + s, kx:kx + s, tap * GROWTH:(tap + 1) * GROWTH]
    if out is None:
        return y.to(dtype)
    _check_rows("fwd_tapsum", "out", out, (b, s, s, GROWTH), dtype,
                taps.device)
    return out.copy_(y)


def fwd_stages_reference(x, w1, scale, shift, w2, out=None):
    """F1-F3's plain stages composed: the forward kernels' function, z and
    the taps summed in float32, r and y rounded to x's dtype once each.
    In float32 it is :func:`dense_sandwich_reference`'s function.  ``out``:
    as :func:`fwd_tapsum_reference`'s."""
    b, s = x.shape[:2]
    r = fwd_expand_reference(x, w1, scale, shift)
    taps = fwd_taps_reference(r, w2).view(b, s, s, GK)
    return fwd_tapsum_reference(taps, x.dtype, out)


# ---- K split across a thread-block cluster (F1, F2) -------------------------
# Each block of F1 and F2 computes one TILE x TILE output tile.  Where a
# product has too few tiles to fill the card (batch 1, S=15), each tile's K
# range runs as s slices, one block a slice; the s blocks of a tile form one
# thread-block cluster, which sums their partial tiles through distributed
# shared memory in a fixed order (``csrc/dense_sandwich.cu::cluster_sum``):
# no workspace, no atomics, two calls bit-equal.  :func:`k_splits` picks s
# from the shape, the card's SMs and the clusters it holds at once
# (``cudaOccupancyMaxActiveClusters``), once per shape.  Its constants come
# from chip_smoke.py --split-only (F1 and F2 at every s from 1 to 16, then
# to 8, on three layers of each live block, batch 1 and 16, both dtypes;
# device time of captured launches; NVIDIA H100 80GB HBM3, 700 W): the
# rule's choice is within 7% (float32) and 9% (bfloat16) of the fastest s
# measured at every shape.

TILE = 128
K_TILE = {torch.float32: 16, torch.bfloat16: 48}   # the mainloops' k tiles
# Clusters of 9 to 16 blocks (not portable) beat 8 on 3 of 32 shapes, by
# at most 8% (F2 at S=15, batch 1).
MAX_CLUSTER = 8
MIN_SLICE_K = 4      # k tiles a slice keeps at least
# The kernels run two blocks per SM; a block alone on its SM runs a k tile
# in this share of a paired block's time (float32: 1.44 against 2.65 us;
# bfloat16 fitted to the sweep with SPLIT_COST).
ALONE = {torch.float32: 0.55, torch.bfloat16: 0.7}
# The cluster's reduction (two cluster barriers, the partial tiles through
# shared memory), in k tiles of one block.
SPLIT_COST = {torch.float32: 1.0, torch.bfloat16: 6.0}
# Of two splits within this share of the least modelled time, the smaller.
SPLIT_TIE = 0.05


def product_tiles(p: int, n: int, k: int, dtype: torch.dtype):
    """(output tiles, k tiles) of F1's or F2's product [p, k] @ [k, n]."""
    return -(-p // TILE) * -(-n // TILE), k // K_TILE[dtype]


def split_time(tiles: int, k_tiles: int, s: int, clusters: int, sms: int,
               dtype: torch.dtype) -> float:
    """Modelled time, in k tiles of a block sharing its SM, of ``tiles``
    output tiles over ``k_tiles`` with ``s`` blocks a tile, where the card
    (``sms`` SMs) holds ``clusters`` clusters of ``s`` blocks at once: per
    wave of clusters the longest slice plus the reduction's cost where
    ``s`` > 1, at :data:`ALONE`'s rate where the wave leaves each SM one
    block at most."""
    step = math.ceil(k_tiles / s) + (SPLIT_COST[dtype] if s > 1 else 0.0)
    full, rest = divmod(tiles, clusters)

    def wave(n):
        return step * (1.0 if n * s > sms else ALONE[dtype])

    return full * wave(clusters) + (wave(rest) if rest else 0.0)


def k_splits(tiles: int, k_tiles: int, clusters: Callable[[int], int],
             sms: int, dtype: torch.dtype) -> int:
    """The blocks a tile, 1 to :data:`MAX_CLUSTER`, of least modelled time
    (:func:`split_time`), each slice at least :data:`MIN_SLICE_K` whole k
    tiles, the smaller on a near tie (:data:`SPLIT_TIE`).  ``clusters(s)``:
    the clusters of ``s`` blocks the card holds at once (0 where none)."""
    times = {1: split_time(tiles, k_tiles, 1, clusters(1), sms, dtype)}
    for s in range(2, min(MAX_CLUSTER, k_tiles // MIN_SLICE_K) + 1):
        n = clusters(s)
        if n > 0:
            times[s] = split_time(tiles, k_tiles, s, n, sms, dtype)
    best = min(times.values())
    return min(s for s, t in times.items() if t <= best * (1 + SPLIT_TIE))


def fwd_splits(p: int, n: int, k: int, dtype: torch.dtype,
               clusters: Callable[[int], int], sms: int) -> int:
    """:func:`k_splits` of F1's or F2's product [p, k] @ [k, n]."""
    tiles, k_tiles = product_tiles(p, n, k, dtype)
    return k_splits(tiles, k_tiles, clusters, sms, dtype)


@functools.lru_cache(maxsize=None)
def card_clusters(taps: bool, s: int, dtype: torch.dtype, index: int) -> int:
    """Clusters of ``s`` blocks of F2 (``taps``) or F1 that card ``index``
    holds at once."""
    with torch.cuda.device(index):
        n = _lib().sandwich_fwd_clusters(int(taps), s,
                                         int(dtype == torch.bfloat16))
    if n < 0:
        raise RuntimeError(f"sandwich_fwd_clusters: cudaError {-n}")
    return n


@functools.lru_cache(maxsize=None)
def card_splits(taps: bool, p: int, n: int, k: int, dtype: torch.dtype,
                index: int) -> int:
    """:func:`fwd_splits` on card ``index``, once per shape."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return fwd_splits(p, n, k, dtype,
                      lambda s: card_clusters(taps, s, dtype, index), sms)


def fwd_expand(x, w1, scale, shift, w1t=None, splits=None):
    """F1: r as :func:`fwd_expand_reference` returns it.  CPU tensors take
    that plain version; CUDA tensors launch the kernel (counted in
    ``kernel.fwd_expand.launches``, and in ``kernel.fwd_expand.split``
    where K is split) or raise.  ``w1t`` is :func:`w1_cols` of w1, made
    here if not given.  ``splits``: the blocks a tile, :func:`card_splits`
    where None (others are for measurement)."""
    if not _on_card("fwd_expand", x):
        return fwd_expand_reference(x, w1, scale, shift)
    _check(x, w1, scale, shift)
    b, s, _, c_in = x.shape
    c_mid, dt, dev = w1.shape[0], x.dtype, x.device
    if w1t is None:
        w1t = w1_cols(w1, dt).contiguous()
    _check_operand("fwd_expand", "w1t", w1t, (c_in, c_mid), dt, dev)
    scale = scale.detach().contiguous()
    shift = shift.detach().contiguous()
    p = b * s * s
    if splits is None:
        splits = card_splits(False, p, c_mid, c_in, dt, dev.index)
    r = torch.empty((p, c_mid), dtype=dt, device=dev)
    _launch("sandwich_fwd_expand", dev, x.data_ptr(), w1t.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), r.data_ptr(), p, c_in,
            c_mid, splits, int(dt == torch.bfloat16))
    trace.count("kernel.fwd_expand.launches")
    trace.count("kernel.fwd_expand.split", int(splits > 1))
    return r


def fwd_taps(r, w2, w2n=None, splits=None):
    """F2: T9 as :func:`fwd_taps_reference` returns it.  CPU tensors take
    that plain version; CUDA tensors launch the kernel (counted in
    ``kernel.fwd_taps.launches``, and in ``kernel.fwd_taps.split`` where K
    is split) or raise.  ``w2n`` is :func:`w2_cols` of w2, made here if not
    given.  ``splits``: as :func:`fwd_expand`'s."""
    if not _on_card("fwd_taps", r):
        return fwd_taps_reference(r, w2)
    p, c_mid = r.shape
    dt, dev = r.dtype, r.device
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fwd_taps: unsupported dtype {dt}")
    if w2n is None:
        w2n = w2_cols(w2, dt).contiguous()
    _check_operand("fwd_taps", "r", r, (p, c_mid), dt, dev)
    _check_operand("fwd_taps", "w2n", w2n, (c_mid, GK), dt, dev)
    if splits is None:
        splits = card_splits(True, p, GK, c_mid, dt, dev.index)
    taps = torch.empty((p, GK), dtype=torch.float32, device=dev)
    _launch("sandwich_fwd_taps", dev, r.data_ptr(), w2n.data_ptr(),
            taps.data_ptr(), p, c_mid, splits, int(dt == torch.bfloat16))
    trace.count("kernel.fwd_taps.launches")
    trace.count("kernel.fwd_taps.split", int(splits > 1))
    return taps


def fwd_tapsum(taps, dtype, out=None):
    """F3: y as :func:`fwd_tapsum_reference` returns it.  CPU tensors take
    that plain version; CUDA tensors launch the kernel (counted in
    ``kernel.fwd_tapsum.launches``) or raise.  ``out``, a [B, S, S, 48] view in
    ``dtype`` whose pixels lie a multiple of 48 elements apart (a slot of
    a dense block's buffer), takes y by row stride and is returned."""
    if not _on_card("fwd_tapsum", taps):
        return fwd_tapsum_reference(taps, dtype, out)
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fwd_tapsum: unsupported dtype {dtype}")
    b, s = taps.shape[:2]
    _check_operand("fwd_tapsum", "taps", taps, (b, s, s, GK), torch.float32,
                   taps.device)
    y = (torch.empty((b, s, s, GROWTH), dtype=dtype, device=taps.device)
         if out is None else out)
    ldy = _check_rows("fwd_tapsum", "out", y, (b, s, s, GROWTH), dtype,
                      taps.device)
    _launch("sandwich_fwd_tapsum", taps.device, taps.data_ptr(), y.data_ptr(),
            b, s, ldy, int(dtype == torch.bfloat16))
    trace.count("kernel.fwd_tapsum.launches")
    if ldy != GROWTH:
        trace.count("kernel.fwd_tapsum.strided")
    return y


FWD_KERNELS = (fwd_expand, fwd_taps, fwd_tapsum)
# The kernels that also count, in ``kernel.<name>.split``, the launches
# that split K across a cluster (0 added where they did not).
SPLIT_KERNELS = (fwd_expand, fwd_taps)


# ---- backward: four kernels ------------------------------------------------
# K1 recomputes z once per pixel tile and writes r and dz [P, C_mid] in the
# compute dtype; K2-K4 are the products dx, dw1 and dw2 over them.  Each
# stage's plain version sits beside its wrapper, and the plain backward is
# their composition.

def g_columns(g):
    """The im2col matrix of the cotangent g [B, S, S, 48] that K1 and K4
    read: [P, 432], where column tap*48 + c of pixel (y, x) holds
    g[y + 1 - tap // 3, x + 1 - tap % 3, c], zero outside the image."""
    b, s, _, c = g.shape
    gp = F.pad(g, (0, 0, 1, 1, 1, 1))
    return torch.cat([gp[:, 2 - dy:2 - dy + s, 2 - dx:2 - dx + s]
                      for dy in range(3) for dx in range(3)],
                     -1).reshape(b * s * s, 9 * c)


def w2_rows(w2, dtype):
    """The 3x3 conv weight w2 [48, C_mid, 3, 3] as K1's operand for dr:
    [432, C_mid] in ``dtype``, row tap*48 + c (the rows of
    :func:`g_columns`), so that dr = g_columns(g) @ w2_rows(w2)."""
    return w2.detach().permute(2, 3, 0, 1).reshape(GK, -1).to(dtype)


def bwd_recompute_reference(x, w1, scale, shift, w2, g):
    """K1's plain version, with the TPU kernels' dtype semantics
    (``_bwd_kernel``): z summed in float32 from compute-dtype operands, r
    (F1's formula) and dz rounded to the compute dtype.  Returns r, dz [P,
    C_mid] in x's dtype and dscale, dshift [C_mid] in float32."""
    dt = x.dtype
    c_mid = w1.shape[0]
    r, z, a = _expand(x, w1, scale, shift)
    mask = a > 0
    gf = g.permute(0, 3, 1, 2).to(dt).float()
    w2f = w2.detach().to(dt).float()
    da = torch.where(mask, F.conv_transpose2d(gf, w2f, padding=1), 0.0)
    dz = (da * scale.detach()[:, None, None]).permute(0, 2, 3, 1)
    return (r, dz.reshape(-1, c_mid).to(dt), (da * z).sum((0, 2, 3)),
            da.sum((0, 2, 3)))


def bwd_dx_reference(dz, w1, shape):
    """K2's plain version: dx = dz @ w1 (w1 as [C_mid, C_in]) summed in
    float32, in dz's dtype, NHWC ``shape``."""
    w1m = w1.detach().reshape(w1.shape[0], -1).to(dz.dtype).float()
    return (dz.float() @ w1m).to(dz.dtype).reshape(shape)


def bwd_dw1_reference(x, dz):
    """K3's plain version: dw1 [C_mid, C_in, 1, 1] = dz^T @ x, float32."""
    xm = x.reshape(-1, x.shape[-1]).float()
    return (dz.float().t() @ xm)[:, :, None, None]


def bwd_dw2_reference(r, g):
    """K4's plain version: dw2 [48, C_mid, 3, 3] in float32, as r^T @ G
    with G = :func:`g_columns` (each tap's shifted window, zero outside the
    image), which is ``conv2d_weight`` of the 3x3 conv."""
    c_mid = r.shape[1]
    d = r.float().t() @ g_columns(g.to(r.dtype).float())
    return d.view(c_mid, 3, 3, GROWTH).permute(3, 0, 1, 2).contiguous()


def dense_sandwich_bwd_reference(x, w1, scale, shift, w2, g):
    """Plain backward, the composition of the four stages' plain versions.
    Returns (dx in x's dtype and NHWC layout, dw1 [C_mid, C_in, 1, 1],
    dscale, dshift [C_mid], dw2 [48, C_mid, 3, 3]), the last four
    float32."""
    r, dz, dscale, dshift = bwd_recompute_reference(x, w1, scale, shift, w2,
                                                    g)
    return (bwd_dx_reference(dz, w1, x.shape), bwd_dw1_reference(x, dz),
            dscale, dshift, bwd_dw2_reference(r, g))


def dense_sandwich_bwd(x, w1, scale, shift, w2, g, w1t=None):
    """Gradients of the sandwich given the cotangent ``g`` [B, S, S, 48]:
    (dx, dw1, dscale, dshift, dw2) as :func:`dense_sandwich_bwd_reference`
    returns them, through the four stage wrappers (CPU tensors take their
    plain versions; CUDA tensors launch K1-K4 or raise).  ``w1t`` is the
    forward's packed w1, made here if not given."""
    r, dz, dscale, dshift = bwd_recompute(x, w1, scale, shift, w2, g, w1t)
    dx = bwd_dx(dz, w1, x.shape)
    dw1 = bwd_dw1(x, dz)
    del dz
    return dx, dw1, dscale, dshift, bwd_dw2(r, g)


def bwd_recompute(x, w1, scale, shift, w2, g, w1t=None):
    """K1: (r, dz, dscale, dshift) as :func:`bwd_recompute_reference`
    returns them.  CPU tensors take that plain version; CUDA tensors launch
    the kernel (counted in ``kernel.bwd_recompute.launches``) or raise.  The
    kernel reads ``g`` by row stride (:func:`row_stride`: in place from a
    slot of a dense block's cotangent); another layout is copied first."""
    if not _on_card("bwd_recompute", x):
        return bwd_recompute_reference(x, w1, scale, shift, w2, g)
    _check(x, w1, scale, shift, w2)
    b, s, _, c_in = x.shape
    c_mid, dt, dev = w1.shape[0], x.dtype, x.device
    if w1t is None:
        w1t = w1_cols(w1, dt).contiguous()
    w2m = w2_rows(w2, dt).contiguous()
    g = _rows(g, dt)
    scale = scale.detach().contiguous()
    shift = shift.detach().contiguous()
    who = "bwd_recompute"
    ldg = _check_rows(who, "g", g, (b, s, s, GROWTH), dt, dev)
    _check_operand(who, "w1t", w1t, (c_in, c_mid), dt, dev)
    r = torch.empty((b * s * s, c_mid), dtype=dt, device=dev)
    dz = torch.empty_like(r)
    dscale = torch.zeros((c_mid,), dtype=torch.float32, device=dev)
    dshift = torch.zeros_like(dscale)
    _launch("sandwich_bwd_recompute", dev, x.data_ptr(), g.data_ptr(),
                w1t.data_ptr(), w2m.data_ptr(), scale.data_ptr(),
                shift.data_ptr(), r.data_ptr(), dz.data_ptr(),
                dscale.data_ptr(), dshift.data_ptr(), b, s, c_in, c_mid,
                ldg, int(dt == torch.bfloat16))
    trace.count("kernel.bwd_recompute.launches")
    if ldg != GROWTH:
        trace.count("kernel.bwd_recompute.strided")
    return r, dz, dscale, dshift


def bwd_dx(dz, w1, shape):
    """K2: dx as :func:`bwd_dx_reference` returns it.  CPU tensors take
    that plain version; CUDA tensors launch the kernel (counted in
    ``kernel.bwd_dx.launches``) or raise."""
    if not _on_card("bwd_dx", dz):
        return bwd_dx_reference(dz, w1, shape)
    b, s, _, c_in = shape
    c_mid, dt, dev = w1.shape[0], dz.dtype, dz.device
    w1m = w1.detach().reshape(c_mid, c_in).to(dt).contiguous()
    _check_operand("bwd_dx", "dz", dz, (b * s * s, c_mid), dt, dev)
    _check_operand("bwd_dx", "w1", w1m, (c_mid, c_in), dt, dev)
    dx = torch.empty(tuple(shape), dtype=dt, device=dev)
    _launch("sandwich_bwd_dx", dev, dz.data_ptr(), w1m.data_ptr(),
                dx.data_ptr(), b, s, c_in, c_mid, int(dt == torch.bfloat16))
    trace.count("kernel.bwd_dx.launches")
    return dx


def bwd_dw1(x, dz):
    """K3: dw1 as :func:`bwd_dw1_reference` returns it.  CPU tensors take
    that plain version; CUDA tensors launch the kernel (counted in
    ``kernel.bwd_dw1.launches``) or raise."""
    if not _on_card("bwd_dw1", x):
        return bwd_dw1_reference(x, dz)
    b, s, _, c_in = x.shape
    c_mid, dt, dev = dz.shape[1], x.dtype, x.device
    _check_operand("bwd_dw1", "x", x, (b, s, s, c_in), dt, dev)
    _check_operand("bwd_dw1", "dz", dz, (b * s * s, c_mid), dt, dev)
    dw1 = torch.zeros((c_mid, c_in), dtype=torch.float32, device=dev)
    _launch("sandwich_bwd_dw1", dev, x.data_ptr(), dz.data_ptr(),
                dw1.data_ptr(), b, s, c_in, c_mid, int(dt == torch.bfloat16))
    trace.count("kernel.bwd_dw1.launches")
    return dw1.reshape(c_mid, c_in, 1, 1)


def bwd_dw2(r, g):
    """K4: dw2 as :func:`bwd_dw2_reference` returns it.  CPU tensors take
    that plain version; CUDA tensors launch the kernel (counted in
    ``kernel.bwd_dw2.launches``) or raise.  ``g``: as
    :func:`bwd_recompute`'s."""
    if not _on_card("bwd_dw2", r):
        return bwd_dw2_reference(r, g)
    b, s = g.shape[:2]
    c_mid, dt, dev = r.shape[1], r.dtype, r.device
    g = _rows(g, dt)
    _check_operand("bwd_dw2", "r", r, (b * s * s, c_mid), dt, dev)
    ldg = _check_rows("bwd_dw2", "g", g, (b, s, s, GROWTH), dt, dev)
    dw2m = torch.zeros((c_mid, GK), dtype=torch.float32, device=dev)
    _launch("sandwich_bwd_dw2", dev, r.data_ptr(), g.data_ptr(),
                dw2m.data_ptr(), b, s, c_mid, ldg, int(dt == torch.bfloat16))
    trace.count("kernel.bwd_dw2.launches")
    if ldg != GROWTH:
        trace.count("kernel.bwd_dw2.strided")
    return dw2m.view(c_mid, 3, 3, GROWTH).permute(3, 0, 1, 2).contiguous()


BWD_KERNELS = (bwd_recompute, bwd_dx, bwd_dw1, bwd_dw2)
# The kernels that also count, in ``kernel.<name>.strided``, the launches
# that wrote y or read g by a row stride other than 48 (a slot of a dense
# block's buffer or of the stack's cotangent).
STRIDED_KERNELS = (fwd_tapsum, bwd_recompute, bwd_dw2)


# The covariance form keeps no z (569 MB a layer at S=57).  At S=15 a z
# materialized per layer was measured faster (ROADMAP item 4.3 has the
# numbers), but no table routes S=15 in train, so only the forcing modes
# would take it there; the covariance stays the one form until a table
# does.
def conv_bn_stats(x, w1):
    """Train-mode batch mean and biased variance of ``conv1x1(x, w1)``
    without materializing it (port of the JAX package's
    ``conv_bn_stats``): the 1x1 conv is linear with no bias, so over the
    N = B*H*W pixels mean = E[x] @ W and var = diag(W^T Cov(x) W), with
    Cov the centered input covariance.  x NHWC [B, H, W, C_in], w1
    [C_mid, C_in, 1, 1]; float32 throughout, differentiable in both.
    Inside ``core.mesh.active`` the pixels are the global batch's: the
    mean and then the C_in x C_in centered covariance are all-reduced,
    differentiably."""
    c_in = x.shape[-1]
    xf = x.reshape(-1, c_in).float()
    wf = w1.reshape(w1.shape[0], c_in).float().t()
    group = mesh_lib.current()
    if group is None:
        m = xf.mean(0)
        xc = xf - m
        cov = (xc.t() @ xc) / xf.shape[0]
    else:
        m, n = mesh_lib.global_mean(xf.sum(0), xf.shape[0], group)
        xc = xf - m
        cov = mesh_lib.all_reduce_sum(xc.t() @ xc, group) / n
    mean = m @ wf
    var = torch.clamp((wf * (cov @ wf)).sum(0), min=0.0)
    return mean, var


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


def fwd_stage_work(b: int, s: int, c_in: int, c_mid: int, itemsize: int,
                   growth: int = GROWTH) -> dict:
    """(operations, bytes) of each forward kernel's own function, keyed by
    wrapper name, each input read once and each output written once (r in
    the compute dtype, T9 and the affine in float32).  F1's and F2's
    operations are their multiply-adds x2 and add up to
    :func:`sandwich_flops`; F3's are its additions, one fewer than each
    output's in-image taps ((3S-2)^2 in-image (pixel, tap) pairs per image
    and channel)."""
    pix, taps = b * s * s, 9 * growth
    return {
        "fwd_expand": (2 * pix * c_mid * c_in,
                       (pix * c_in + c_in * c_mid + pix * c_mid) * itemsize
                       + 2 * c_mid * 4),
        "fwd_taps": (2 * pix * c_mid * taps,
                     (pix * c_mid + c_mid * taps) * itemsize
                     + pix * taps * 4),
        "fwd_tapsum": (b * growth * ((3 * s - 2) ** 2 - s * s),
                       pix * taps * 4 + pix * growth * itemsize),
    }


def sandwich_bwd_flops(b: int, s: int, c_in: int, c_mid: int,
                       growth: int = GROWTH) -> int:
    """Multiply-add operations (x2) of one backward: the z recompute, dx
    and dw1 over C_in each, dr and dw2 over the 9 * 48 taps each."""
    return 2 * b * s * s * c_mid * (3 * c_in + 18 * growth)


def sandwich_bwd_bytes(b: int, s: int, c_in: int, c_mid: int, itemsize: int,
                       growth: int = GROWTH) -> int:
    """Bytes the backward must move: x, g, w1 and w2 read and dx written in
    the compute dtype; scale and shift read and dw1, dw2, dscale and dshift
    written in float32."""
    pix = b * s * s
    dt_elems = 2 * pix * c_in + pix * growth + c_in * c_mid + 9 * c_mid * growth
    f32_elems = 2 * c_mid + c_in * c_mid + 9 * c_mid * growth + 2 * c_mid
    return dt_elems * itemsize + f32_elems * 4


def bwd_stage_work(b: int, s: int, c_in: int, c_mid: int, itemsize: int,
                   growth: int = GROWTH) -> dict:
    """(operations, bytes) of each backward kernel's own function, keyed by
    wrapper name: multiply-adds x2, and each input read once and each
    output written once (r and dz in the compute dtype, the weight
    gradients and the affine in float32).  The operations add up to
    :func:`sandwich_bwd_flops`."""
    pix, taps = b * s * s, 9 * growth
    return {
        "bwd_recompute": (
            2 * pix * c_mid * (c_in + taps),
            (pix * c_in + pix * growth + (c_in + taps) * c_mid
             + 2 * pix * c_mid) * itemsize + 4 * c_mid * 4),
        "bwd_dx": (2 * pix * c_mid * c_in,
                   (pix * c_mid + c_mid * c_in + pix * c_in) * itemsize),
        "bwd_dw1": (2 * pix * c_mid * c_in,
                    (pix * c_in + pix * c_mid) * itemsize
                    + c_mid * c_in * 4),
        "bwd_dw2": (2 * pix * c_mid * taps,
                    (pix * c_mid + pix * growth) * itemsize
                    + c_mid * taps * 4),
    }
