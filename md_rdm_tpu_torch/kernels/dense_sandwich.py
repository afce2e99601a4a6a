"""Dense-layer sandwich ``conv3x3(relu(conv1x1(x)*scale+shift))`` and its
gradient.

Port of ``md_rdm_tpu/kernels/dense_sandwich.py::_kernel`` (the TPU kernel,
reached through ``_pallas_sandwich``).  On CUDA tensors
:func:`dense_sandwich` launches the hand-written kernel in
``csrc/dense_sandwich.cu``; its header states the kernel's bound on an
H100 and what the design does about it.  On CPU tensors, and only there,
it runs the plain version :func:`dense_sandwich_reference`.

Layouts: ``x`` is NHWC ``[B, S, S, C_in]`` in the compute dtype (float32
or bfloat16), already through norm1 and ReLU; ``w1`` ``[C_mid, C_in, 1, 1]``
and ``w2`` ``[48, C_mid, 3, 3]`` are the layer's conv weights as
``nn.Conv2d`` holds them (any float dtype, cast to the compute dtype);
``scale`` and ``shift`` ``[C_mid]`` are norm2 folded into an affine, in
float32.  The result is NHWC ``[B, S, S, 48]`` in the compute dtype.

Under autograd the sandwich is :class:`SandwichFunction`: the forward
kernel, then :func:`dense_sandwich_bwd`, the four backward kernels of
``csrc/dense_sandwich_bwd.cu`` (port of ``_bwd_kernel`` and
``_bwd_kernel_flat``), which recompute z from the saved input instead of
keeping it.  :func:`conv_bn_stats` gives norm2's train-mode batch
statistics without materializing z.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from md_rdm_tpu_torch.kernels import _build

GROWTH = 48
# The kernel streams C_in and C_mid in chunks of 48 channels (C_in in at
# least two, for its load pipeline).
CHUNK = 48
# Spatial sizes whose dense layers the encoder routes through the kernels,
# in eval and in train, as the JAX package routes its TPU kernels
# (_PROFITABLE_EVAL, _BWD_PROFITABLE, _FLAT_PROFITABLE_TRAIN).
ROUTED_SIZES = frozenset({57})


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
def _launcher():
    """The kernel's C launcher, built and loaded at first use."""
    fn = _build.load("dense_sandwich").dense_sandwich_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, w1, scale, shift, w2):
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
    if tuple(w2.shape) != (GROWTH, c_mid, 3, 3):
        raise ValueError(f"dense_sandwich: w2 {tuple(w2.shape)} is not "
                         f"[{GROWTH}, {c_mid}, 3, 3]")
    for name, t in (("scale", scale), ("shift", shift)):
        if tuple(t.shape) != (c_mid,) or t.dtype != torch.float32:
            raise ValueError(f"dense_sandwich: {name} must be float32 "
                             f"[{c_mid}]")
    if (b < 1 or b > 65535 or c_in % CHUNK or c_in < 2 * CHUNK
            or c_mid % CHUNK or c_mid < CHUNK):
        raise ValueError(f"dense_sandwich: the kernel needs 1 <= B <= 65535, "
                         f"C_in a multiple of {CHUNK} from {2 * CHUNK} and "
                         f"C_mid a multiple of {CHUNK}; got B={b}, "
                         f"C_in={c_in}, C_mid={c_mid}")
    for name, t in (("x", x), ("w1", w1), ("w2", w2), ("scale", scale),
                    ("shift", shift)):
        if t.device != x.device:
            raise ValueError(f"dense_sandwich: {name} is on {t.device}, "
                             f"x on {x.device}")
    if not x.is_contiguous():
        raise ValueError("dense_sandwich: x must be a contiguous NHWC "
                         "tensor (a channels-last activation, permuted)")
    if x.data_ptr() % 16:
        raise ValueError("dense_sandwich: x must be 16-byte aligned")


class SandwichWeights(NamedTuple):
    """One layer's weights as given (the plain version's operands), and
    laid out for the kernel in the compute dtype: ``w1t`` [C_in, C_mid],
    ``w2p`` [9, C_mid, 48] (tap-major)."""
    w1: torch.Tensor
    scale: torch.Tensor
    shift: torch.Tensor
    w2: torch.Tensor
    w1t: torch.Tensor
    w2p: torch.Tensor


def pack_weights(w1, scale, shift, w2, dtype: torch.dtype) -> SandwichWeights:
    """Lay a layer's weights out for the kernel; a caller that serves many
    batches makes this once per weights (``DenseLayer.sandwich_weights``)."""
    w1t = w1.detach().flatten(1).t().to(dtype).contiguous()
    w2p = w2.detach().permute(2, 3, 1, 0).flatten(0, 1).to(dtype).contiguous()
    return SandwichWeights(w1, scale, shift, w2, w1t, w2p)


def dense_sandwich(x, w1, scale, shift, w2):
    """Fused sandwich.  CPU tensors take the plain version; CUDA tensors
    launch the kernel (and count the launch in ``dense_sandwich.launches``)
    or raise.  Differentiable: see :class:`SandwichFunction`."""
    return dense_sandwich_packed(x, pack_weights(w1, scale, shift, w2,
                                                 x.dtype))


def dense_sandwich_packed(x, p: SandwichWeights):
    """:func:`dense_sandwich` on weights from :func:`pack_weights`.  When
    autograd needs the sandwich's gradient it goes through
    :class:`SandwichFunction`."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, p.w1, p.scale, p.shift, p.w2)):
        return SandwichFunction.apply(x, p.w1, p.scale, p.shift, p.w2, p)
    return _forward(x, p)


def _forward(x, p: SandwichWeights):
    if x.device.type == "cpu":
        return dense_sandwich_reference(x, p.w1, p.scale, p.shift, p.w2)
    if x.device.type != "cuda":
        raise ValueError(f"dense_sandwich: unsupported device {x.device}")
    _check(x, p.w1, p.scale, p.shift, p.w2)
    dt = x.dtype
    _check_packed(x, p.w1t, p.w2p)
    b, s, _, c_in = x.shape
    c_mid = p.w1.shape[0]
    scale = p.scale.detach().contiguous()
    shift = p.shift.detach().contiguous()
    out = torch.empty((b, s, s, GROWTH), dtype=dt, device=x.device)
    launch = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = launch(
            x.data_ptr(), p.w1t.data_ptr(), p.w2p.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), out.data_ptr(), b, s, c_in,
            c_mid, int(dt == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"dense_sandwich: kernel launch failed "
                           f"(cudaError {rc})")
    dense_sandwich.launches += 1
    return out


dense_sandwich.launches = 0


def _check_packed(x, w1t, w2p):
    for name, t in (("w1t", w1t), ("w2p", w2p)):
        if t.dtype != x.dtype or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"dense_sandwich: packed {name} is {t.dtype} on "
                             f"{t.device}, x is {x.dtype} on {x.device}")


class SandwichFunction(torch.autograd.Function):
    """The sandwich under autograd: forward :func:`dense_sandwich_packed`'s
    kernel (no z kept: only the inputs are saved), backward
    :func:`dense_sandwich_bwd`, which recomputes z.  Gradients come back
    in the inputs' own layouts (OIHW conv weights, float32 for the weights
    and the affine, the compute dtype for x)."""

    @staticmethod
    def forward(ctx, x, w1, scale, shift, w2, packed: SandwichWeights):
        ctx.save_for_backward(x, w1, scale, shift, w2)
        ctx.w1t = packed.w1t
        return _forward(x, packed)

    @staticmethod
    def backward(ctx, gy):
        x, w1, scale, shift, w2 = ctx.saved_tensors
        dx, dw1, dscale, dshift, dw2 = dense_sandwich_bwd(
            x, w1, scale, shift, w2, gy, ctx.w1t)
        return dx, dw1, dscale, dshift, dw2, None


# ---- backward: four kernels, csrc/dense_sandwich_bwd.cu --------------------
# K1 recomputes z once per pixel tile and writes r and dz [P, C_mid] in the
# compute dtype (P = B*S*S); K2-K4 are the products dx, dw1 and dw2 over
# them.  Each stage's plain version sits beside its wrapper, and the plain
# backward is their composition.

GK = 9 * GROWTH     # im2col width of the cotangent


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
    and dz rounded to the compute dtype.  Returns r, dz [P, C_mid] in x's
    dtype and dscale, dshift [C_mid] in float32."""
    dt = x.dtype
    c_mid = w1.shape[0]
    xf = x.permute(0, 3, 1, 2).float()
    w1f, w2f = w1.detach().to(dt).float(), w2.detach().to(dt).float()
    sc, sh = scale.detach()[:, None, None], shift.detach()[:, None, None]
    z = F.conv2d(xf, w1f)
    a = z * sc + sh
    mask = a > 0
    gf = g.permute(0, 3, 1, 2).to(dt).float()
    da = torch.where(mask, F.conv_transpose2d(gf, w2f, padding=1), 0.0)

    def rows(t):
        return t.permute(0, 2, 3, 1).reshape(-1, c_mid).to(dt)

    return (rows(torch.where(mask, a, 0.0)), rows(da * sc),
            (da * z).sum((0, 2, 3)), da.sum((0, 2, 3)))


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


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    """The backward kernels' C launchers, built and loaded at first use."""
    lib = _build.load("dense_sandwich_bwd")
    for name, n_ptr, n_int in (("sandwich_bwd_recompute", 10, 5),
                               ("sandwich_bwd_dx", 3, 5),
                               ("sandwich_bwd_dw1", 3, 5),
                               ("sandwich_bwd_dw2", 3, 4)):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _launch_bwd(name, device, *args):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(_bwd_lib(), name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")


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


def bwd_recompute(x, w1, scale, shift, w2, g, w1t=None):
    """K1: (r, dz, dscale, dshift) as :func:`bwd_recompute_reference`
    returns them.  CPU tensors take that plain version; CUDA tensors launch
    the kernel (counted in ``bwd_recompute.launches``) or raise."""
    if not _on_card("bwd_recompute", x):
        return bwd_recompute_reference(x, w1, scale, shift, w2, g)
    _check(x, w1, scale, shift, w2)
    b, s, _, c_in = x.shape
    c_mid, dt, dev = w1.shape[0], x.dtype, x.device
    if w1t is None:
        w1t = w1.detach().flatten(1).t().to(dt).contiguous()
    w2m = w2_rows(w2, dt).contiguous()
    g = g.to(dt).contiguous()
    scale = scale.detach().contiguous()
    shift = shift.detach().contiguous()
    who = "bwd_recompute"
    _check_operand(who, "g", g, (b, s, s, GROWTH), dt, dev)
    _check_operand(who, "w1t", w1t, (c_in, c_mid), dt, dev)
    r = torch.empty((b * s * s, c_mid), dtype=dt, device=dev)
    dz = torch.empty_like(r)
    dscale = torch.zeros((c_mid,), dtype=torch.float32, device=dev)
    dshift = torch.zeros_like(dscale)
    _launch_bwd("sandwich_bwd_recompute", dev, x.data_ptr(), g.data_ptr(),
                w1t.data_ptr(), w2m.data_ptr(), scale.data_ptr(),
                shift.data_ptr(), r.data_ptr(), dz.data_ptr(),
                dscale.data_ptr(), dshift.data_ptr(), b, s, c_in, c_mid,
                int(dt == torch.bfloat16))
    bwd_recompute.launches += 1
    return r, dz, dscale, dshift


def bwd_dx(dz, w1, shape):
    """K2: dx as :func:`bwd_dx_reference` returns it.  CPU tensors take
    that plain version; CUDA tensors launch the kernel (counted in
    ``bwd_dx.launches``) or raise."""
    if not _on_card("bwd_dx", dz):
        return bwd_dx_reference(dz, w1, shape)
    b, s, _, c_in = shape
    c_mid, dt, dev = w1.shape[0], dz.dtype, dz.device
    w1m = w1.detach().reshape(c_mid, c_in).to(dt).contiguous()
    _check_operand("bwd_dx", "dz", dz, (b * s * s, c_mid), dt, dev)
    _check_operand("bwd_dx", "w1", w1m, (c_mid, c_in), dt, dev)
    dx = torch.empty(tuple(shape), dtype=dt, device=dev)
    _launch_bwd("sandwich_bwd_dx", dev, dz.data_ptr(), w1m.data_ptr(),
                dx.data_ptr(), b, s, c_in, c_mid, int(dt == torch.bfloat16))
    bwd_dx.launches += 1
    return dx


def bwd_dw1(x, dz):
    """K3: dw1 as :func:`bwd_dw1_reference` returns it.  CPU tensors take
    that plain version; CUDA tensors launch the kernel (counted in
    ``bwd_dw1.launches``) or raise."""
    if not _on_card("bwd_dw1", x):
        return bwd_dw1_reference(x, dz)
    b, s, _, c_in = x.shape
    c_mid, dt, dev = dz.shape[1], x.dtype, x.device
    _check_operand("bwd_dw1", "x", x, (b, s, s, c_in), dt, dev)
    _check_operand("bwd_dw1", "dz", dz, (b * s * s, c_mid), dt, dev)
    dw1 = torch.zeros((c_mid, c_in), dtype=torch.float32, device=dev)
    _launch_bwd("sandwich_bwd_dw1", dev, x.data_ptr(), dz.data_ptr(),
                dw1.data_ptr(), b, s, c_in, c_mid, int(dt == torch.bfloat16))
    bwd_dw1.launches += 1
    return dw1.reshape(c_mid, c_in, 1, 1)


def bwd_dw2(r, g):
    """K4: dw2 as :func:`bwd_dw2_reference` returns it.  CPU tensors take
    that plain version; CUDA tensors launch the kernel (counted in
    ``bwd_dw2.launches``) or raise."""
    if not _on_card("bwd_dw2", r):
        return bwd_dw2_reference(r, g)
    b, s = g.shape[:2]
    c_mid, dt, dev = r.shape[1], r.dtype, r.device
    g = g.to(dt).contiguous()
    _check_operand("bwd_dw2", "r", r, (b * s * s, c_mid), dt, dev)
    _check_operand("bwd_dw2", "g", g, (b, s, s, GROWTH), dt, dev)
    dw2m = torch.zeros((c_mid, GK), dtype=torch.float32, device=dev)
    _launch_bwd("sandwich_bwd_dw2", dev, r.data_ptr(), g.data_ptr(),
                dw2m.data_ptr(), b, s, c_mid, int(dt == torch.bfloat16))
    bwd_dw2.launches += 1
    return dw2m.view(c_mid, 3, 3, GROWTH).permute(3, 0, 1, 2).contiguous()


BWD_KERNELS = (bwd_recompute, bwd_dx, bwd_dw1, bwd_dw2)
for _fn in BWD_KERNELS:
    _fn.launches = 0


def conv_bn_stats(x, w1):
    """Train-mode batch mean and biased variance of ``conv1x1(x, w1)``
    without materializing it (port of the JAX package's
    ``conv_bn_stats``): the 1x1 conv is linear with no bias, so over the
    N = B*H*W pixels mean = E[x] @ W and var = diag(W^T Cov(x) W), with
    Cov the centered input covariance.  x NHWC [B, H, W, C_in], w1
    [C_mid, C_in, 1, 1]; float32 throughout, differentiable in both."""
    c_in = x.shape[-1]
    xf = x.reshape(-1, c_in).float()
    wf = w1.reshape(w1.shape[0], c_in).float().t()
    m = xf.mean(0)
    xc = xf - m
    cov = (xc.t() @ xc) / xf.shape[0]
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
