"""DenseNet encoder with torchvision semantics, eval and train forward.

Port of ``md_rdm_tpu/models/densenet.py``.  Module and parameter names
follow the reference (``dense_eK.denselayerN.{norm1,conv1,norm2,conv2}``,
``trans_eK.{norm,conv}``), so the state_dict loads reference checkpoints.

Activations are NCHW tensors in channels-last memory: the routed layers
hand their input to the sandwich kernels as an NHWC view without a copy.
The compute dtype is the dtype of the activations; parameters stay float32
and are cast at each conv.  BatchNorm runs in float32 and its output is cast
to the compute dtype before the ReLU, as in the JAX package.

Train mode (``nn.Module.training``) follows flax's BatchNorm: batch mean
and *biased* batch variance, running statistics updated as
``ra = 0.9 * ra + 0.1 * batch`` with that biased variance (torch's own
``batch_norm`` would store the unbiased one).  ``num_batches_tracked`` is
left alone: the momentum is fixed.

``ModelConfig.remat`` (the JAX ``nn.remat`` of each encoder dense layer,
torchvision's ``memory_efficient``) runs each encoder layer under
``torch.utils.checkpoint``: the layer keeps only its input and is run
again in the backward, inside :func:`recompute`, which leaves the running
statistics alone and keeps the forward's data-parallel group.  Which
layers run the sandwich kernels, and which blocks run as one in-place
buffer (:class:`_FlatBlock`), the model's one ``Routing``
(``models/routing.py``, built from its ``ModelConfig``) decides.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from md_rdm_tpu_torch.core import mesh as mesh_lib
from md_rdm_tpu_torch.kernels.dense_sandwich import (SandwichWeights,
                                                     conv_bn_stats,
                                                     dense_sandwich_bwd,
                                                     dense_sandwich_packed,
                                                     pack_weights)
from md_rdm_tpu_torch.kernels.growth_conv import growth_conv_matmul
from md_rdm_tpu_torch.models.routing import Routing

GROWTH = 48
CL = torch.channels_last


_RECOMPUTING = contextvars.ContextVar("md_rdm_tpu_torch_recomputing",
                                      default=False)


def recomputing() -> bool:
    """True inside :func:`recompute`: the backward's second run of a
    forward."""
    return _RECOMPUTING.get()


@contextlib.contextmanager
def recompute(mesh):
    """The backward's second run of a forward (a rematerialized layer, a
    flat block's layers): running statistics are not updated again, and
    train-mode BatchNorm takes its statistics over ``mesh``, the group the
    forward ran in (None: this process's batch), so that its collectives
    run again in the same order on every rank."""
    token = _RECOMPUTING.set(True)
    try:
        with mesh_lib.active(mesh):
            yield
    finally:
        _RECOMPUTING.reset(token)


def _remat_contexts():
    """``checkpoint``'s ``context_fn``, called at the forward: no context
    for the forward, :func:`recompute` in the forward's group for the
    recomputation."""
    return contextlib.nullcontext(), recompute(mesh_lib.current())


def bn_eval(x: torch.Tensor, norm: nn.BatchNorm2d) -> torch.Tensor:
    """Eval-mode BatchNorm on running statistics, in float32."""
    return F.batch_norm(x.float(), norm.running_mean, norm.running_var,
                        norm.weight, norm.bias, False, 0.0, norm.eps)


def update_running_stats(norm: nn.BatchNorm2d, mean: torch.Tensor,
                         var: torch.Tensor) -> None:
    """flax's update: ``ra = (1 - m) * ra + m * batch`` (torch momentum m =
    0.1 is flax's 0.9), with the biased batch variance.  Skipped inside
    :func:`recompute`: a step updates each statistic once."""
    if recomputing():
        return
    with torch.no_grad():
        m = norm.momentum
        norm.running_mean.lerp_(mean.detach(), m)
        norm.running_var.lerp_(var.detach(), m)


def bn_train(x: torch.Tensor, norm: nn.BatchNorm2d) -> torch.Tensor:
    """Train-mode BatchNorm in float32 on the batch statistics; updates
    the running statistics.  The buffers get the biased variance from an
    explicit ``var_mean``; the normalization (same statistics) is one
    ``F.batch_norm`` call given no buffers, so torch's unbiased update
    never runs, and autograd differentiates it as one op.

    Inside ``core.mesh.active`` the statistics are the global batch's, in
    two passes as ``jnp.var`` takes them: one all-reduce of the sums with
    the count gives the mean, a second one the centered sums of squares;
    both are differentiable, so the backward reaches every rank's rows
    through them (SyncBatchNorm's gradient)."""
    xf = x.float()
    group = mesh_lib.current()
    if group is not None:
        c = xf.shape[1]
        mean, n = mesh_lib.global_mean(xf.sum((0, 2, 3)), xf.numel() // c,
                                       group)
        xc = xf - mean[:, None, None]
        var = mesh_lib.all_reduce_sum(xc.square().sum((0, 2, 3)), group) / n
        update_running_stats(norm, mean, var)
        mul = torch.rsqrt(var + norm.eps) * norm.weight
        return xc * mul[:, None, None] + norm.bias[:, None, None]
    with torch.no_grad():
        var, mean = torch.var_mean(xf, dim=(0, 2, 3), unbiased=False)
    update_running_stats(norm, mean, var)
    return F.batch_norm(xf, None, None, norm.weight, norm.bias, True, 0.0,
                        norm.eps)


def batch_norm(x: torch.Tensor, norm: nn.BatchNorm2d) -> torch.Tensor:
    """``norm`` in its module's mode, in float32."""
    return bn_train(x, norm) if norm.training else bn_eval(x, norm)


def fold(norm: nn.BatchNorm2d, mean: torch.Tensor, var: torch.Tensor):
    """BatchNorm on (mean, var) as a float32 (scale, shift) affine."""
    scale = norm.weight * torch.rsqrt(var + norm.eps)
    return scale, norm.bias - mean * scale


def conv(x: torch.Tensor, layer: nn.Conv2d) -> torch.Tensor:
    """``layer`` applied in the dtype of ``x``."""
    dt = x.dtype
    bias = None if layer.bias is None else layer.bias.to(dt)
    return F.conv2d(x, layer.weight.to(dt), bias, layer.stride,
                    layer.padding)


class DenseLayer(nn.Module):
    """torchvision _DenseLayer: BN-ReLU-1x1 (bn_size*48) -BN-ReLU-3x3 (48).

    On a square input whose size ``routing`` takes (``Routing.fwd``),
    conv1 -> norm2 -> ReLU -> conv2 runs as one sandwich call with norm2
    folded into an affine (the JAX ``_FoldedNorm``): running statistics in
    eval, in train the batch statistics from :func:`conv_bn_stats`,
    differentiable, so the sandwich's dscale / dshift reach gamma, beta, x
    and conv1 through them.  Its backward runs K1-K4 where ``Routing.bwd``
    says so, else autograd through the plain ops.  Elsewhere the layer
    runs as separate ops, its 3x3 conv as :func:`growth_conv_matmul` where
    ``Routing.growth_conv`` says so.  The parameters are the same on every
    path.
    """

    def __init__(self, in_ch: int, bn_size: int, growth: int = GROWTH,
                 routing: Routing = Routing()):
        super().__init__()
        self.routing = routing
        c_mid = bn_size * growth
        self.norm1 = nn.BatchNorm2d(in_ch)
        self.conv1 = nn.Conv2d(in_ch, c_mid, 1, bias=False)
        self.norm2 = nn.BatchNorm2d(c_mid)
        self.conv2 = nn.Conv2d(c_mid, growth, 3, padding=1, bias=False)

    def sandwich_weights(self, dt: torch.dtype) -> SandwichWeights:
        """conv1, norm2 folded and conv2, laid out for the kernel in ``dt``
        from the weights as they are at this call: a captured forward lays
        them out inside its graph, so each replay reads the weights of its
        own time."""
        n = self.norm2
        return pack_weights(self.conv1.weight,
                            *fold(n, n.running_mean, n.running_var),
                            self.conv2.weight, dt)

    def norm2_affine(self, nhwc: torch.Tensor):
        """norm2 folded into a float32 (scale, shift) affine: on the batch
        statistics of conv1(nhwc) in train mode (``conv_bn_stats``,
        differentiable; updates norm2's running statistics), else on the
        running statistics."""
        n = self.norm2
        if not n.training:
            return fold(n, n.running_mean, n.running_var)
        mean, var = conv_bn_stats(nhwc, self.conv1.weight)
        update_running_stats(n, mean, var)
        return fold(n, mean, var)

    def weights(self, nhwc: torch.Tensor) -> SandwichWeights:
        """conv1, norm2 folded (:meth:`norm2_affine`) and conv2, laid out
        for the kernels in nhwc's dtype; in eval mode the kept
        :meth:`sandwich_weights`."""
        if not self.norm2.training:
            return self.sandwich_weights(nhwc.dtype)
        return pack_weights(self.conv1.weight, *self.norm2_affine(nhwc),
                            self.conv2.weight, nhwc.dtype)

    def front(self, x: torch.Tensor) -> torch.Tensor:
        """relu(norm1(x)) in x's dtype, NHWC [B, S, S, C_in] contiguous,
        for the kernels; x is NCHW of any strides (a view of a block's
        buffer too)."""
        h = torch.relu(batch_norm(x, self.norm1).to(x.dtype))
        return h.contiguous(memory_format=CL).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, s, routing = x.dtype, x.shape[-1], self.routing
        square = s == x.shape[-2]
        if square and routing.fwd(s, self.training, dt):
            nhwc = self.front(x)
            # a rematerialized layer's recomputation runs no kernel: the
            # sandwich's backward reads its inputs alone
            return dense_sandwich_packed(
                nhwc, self.weights(nhwc), routing.bwd(s, dt),
                recomputing()).permute(0, 3, 1, 2)
        h = torch.relu(batch_norm(x, self.norm1).to(dt))
        h = conv(h, self.conv1)
        h = torch.relu(batch_norm(h, self.norm2).to(dt))
        if square and routing.growth_conv(s):
            return growth_conv_matmul(h, self.conv2.weight)
        return conv(h, self.conv2)


class DenseBlock(nn.Module):
    """torchvision _DenseBlock: each layer's 48 channels are concatenated
    onto the running stack.  ``routing`` goes to every layer.  With
    ``remat`` (``ModelConfig.remat``, the JAX ``nn.remat(DenseLayer)``)
    each layer that autograd records runs under ``torch.utils.checkpoint``
    and keeps only its input; its backward runs it again inside
    :func:`recompute`, where a routed layer launches no forward kernel (its
    backward reads only its inputs).

    Where :meth:`runs_flat` says so on the actual input (square, as the
    JAX ``Encoder.block`` routes on the incoming shape: device-augment
    init traces non-square shapes), the block runs in its own layout (the
    JAX package's flat dense block): one NHWC buffer [B, S, S, C_final]
    holds the whole stack, the block's input is copied once into channels
    [0, C0), and each layer's F3 writes its 48 channels into their slot by
    row stride, so no layer copies the stack.  Layer i computes h =
    relu(norm1(buf[..., :C_in])) and norm2 folded
    (:meth:`DenseLayer.norm2_affine`: running statistics in eval, the
    batch statistics of ``conv_bn_stats`` in train), then F1-F3 into the
    buffer.  Under autograd the block is one :class:`_FlatBlock` Function:
    in-place writes into the buffer would bump the version of every view
    an earlier layer saved.  Its backward always recomputes each layer's
    h from the buffer (the role of ``nn.remat(FlatDenseLayer)``), whatever
    ``remat`` says."""

    def __init__(self, num_layers: int, in_ch: int, bn_size: int,
                 growth: int = GROWTH, routing: Routing = Routing(),
                 remat: bool = False):
        super().__init__()
        self.routing = routing
        self.remat = remat
        for i in range(num_layers):
            self.add_module(f"denselayer{i + 1}",
                            DenseLayer(in_ch + i * growth, bn_size, growth,
                                       routing))

    def runs_flat(self, x: torch.Tensor) -> bool:
        """Whether a call on ``x`` (NCHW) runs flat: a square size that
        ``Routing.flat_block`` takes."""
        s = x.shape[-1]
        return s == x.shape[-2] and self.routing.flat_block(
            s, self.training, x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.runs_flat(x):
            params = [t for layer in self.children()
                      for t in _layer_params(layer)]
            return _FlatBlock.apply(self, x, *params)
        for layer in self.children():
            if self.remat and torch.is_grad_enabled():
                y = checkpoint(layer, x, use_reentrant=False,
                               context_fn=_remat_contexts,
                               preserve_rng_state=False)
            else:
                y = layer(x)
            x = torch.cat([x, y.to(x.dtype)], 1)
            x = x.contiguous(memory_format=CL)
        return x


def _layer_params(layer: DenseLayer) -> tuple:
    return (layer.norm1.weight, layer.norm1.bias, layer.conv1.weight,
            layer.norm2.weight, layer.norm2.bias, layer.conv2.weight)


class _FlatBlock(torch.autograd.Function):
    """A flat :class:`DenseBlock`'s call.  The forward fills the buffer,
    updates the running statistics once and keeps the final buffer (the
    output) and the data-parallel group.  The backward holds one cotangent
    buffer dbuf (the output's gradient) and walks the layers in reverse:
    K1 and K4 read layer i's cotangent g_i = dbuf[..., C_in:C_in+48] in
    place; h_i and norm2's affine are recomputed from the buffer's prefix
    inside :func:`recompute` (the forward's group, so that train-mode
    statistics are the global batch's again); K1-K4 give dh, dw1, dw2 and
    the affine's gradient; autograd through that recomputation (norm1,
    ReLU, ``conv_bn_stats``) carries dh and the affine's gradient to the
    prefix and the norms' parameters; and dbuf[..., :C_in] += the prefix's
    gradient.  Each kernel runs once per layer per step."""

    @staticmethod
    def forward(ctx, block, x, *params):
        b, c0, s, _ = x.shape
        layers = list(block.children())
        buf = x.new_empty((b, s, s, c0 + GROWTH * len(layers)))
        buf[..., :c0].copy_(x.permute(0, 2, 3, 1))
        for i, layer in enumerate(layers):
            c_in = c0 + GROWTH * i
            nhwc = layer.front(buf[..., :c_in].permute(0, 3, 1, 2))
            dense_sandwich_packed(nhwc, layer.weights(nhwc),
                                  out=buf[..., c_in:c_in + GROWTH])
        out = buf.permute(0, 3, 1, 2)
        ctx.block = block
        ctx.mesh = mesh_lib.current()
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, gy):
        out, = ctx.saved_tensors
        layers = list(ctx.block.children())
        buf = out.permute(0, 2, 3, 1)
        dbuf = gy.permute(0, 2, 3, 1).to(buf.dtype).clone(
            memory_format=torch.contiguous_format)
        c0 = buf.shape[-1] - GROWTH * len(layers)
        grads = []
        for i in reversed(range(len(layers))):
            layer = layers[i]
            c_in = c0 + GROWTH * i
            with torch.enable_grad(), recompute(ctx.mesh):
                pre = buf[..., :c_in].detach().requires_grad_()
                nhwc = layer.front(pre.permute(0, 3, 1, 2))
                scale, shift = layer.norm2_affine(nhwc)
            dh, dw1, dscale, dshift, dw2 = dense_sandwich_bwd(
                nhwc.detach(), layer.conv1.weight, scale.detach(),
                shift.detach(), layer.conv2.weight,
                dbuf[..., c_in:c_in + GROWTH])
            params = _layer_params(layer)[:5]
            wrt = [pre] + [p for p in params if p.requires_grad]
            outs = [(o, g) for o, g in ((nhwc, dh), (scale, dscale),
                                        (shift, dshift)) if o.requires_grad]
            got = iter(torch.autograd.grad(
                [o for o, _ in outs], wrt, [g for _, g in outs],
                allow_unused=True))
            dpre = next(got)
            if dpre is not None:
                dbuf[..., :c_in] += dpre
            dp = [next(got) if p.requires_grad else None for p in params]
            if params[2].requires_grad:
                dp[2] = dw1 if dp[2] is None else dw1 + dp[2]
            grads.append(dp + [dw2 if layer.conv2.weight.requires_grad
                               else None])
        dx = dbuf[..., :c0].permute(0, 3, 1, 2).contiguous(memory_format=CL)
        return (None, dx, *[g for gs in reversed(grads) for g in gs])


class Transition(nn.Module):
    """torchvision _Transition: BN -> ReLU -> 1x1 conv -> 2x2 avg-pool."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm = nn.BatchNorm2d(in_ch)
        self.conv = nn.Conv2d(in_ch, out_ch, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(batch_norm(x, self.norm).to(x.dtype))
        return F.avg_pool2d(conv(h, self.conv), 2, 2)


def pad_br(x: torch.Tensor) -> torch.Tensor:
    """ZeroPad2d((0, 1, 0, 1)): one zero row at the bottom and one zero
    column at the right of an NCHW map."""
    return F.pad(x, (0, 1, 0, 1)).contiguous(memory_format=CL)


class Encoder(nn.Module):
    """DenseNet-161-style encoder: 226x226x3 -> conv7/2 -> maxpool ->
    dense(6, bn 57) @57 -> trans -> dense(12, bn 29) @29 -> trans ->
    dense(36, bn 15) @15 -> trans -> 8x8x1056.  Input and output are NCHW
    in channels-last memory, in the compute dtype.  ``routing`` and ``remat``
    (``ModelConfig.remat``) go to the three dense blocks, each of which
    picks the flat or the plain form per call on its actual input
    (:meth:`DenseBlock.runs_flat`)."""

    def __init__(self, routing: Routing = Routing(), remat: bool = False):
        super().__init__()
        opts = {"routing": routing, "remat": remat}
        self.conv_e1 = nn.Conv2d(3, 96, 7, stride=2, padding=3)
        self.dense_e2 = DenseBlock(6, 96, 57, **opts)
        self.trans_e2 = Transition(384, 192)
        self.dense_e3 = DenseBlock(12, 192, 29, **opts)
        self.trans_e3 = Transition(768, 384)
        self.dense_e4 = DenseBlock(36, 384, 15, **opts)
        self.trans_e4 = Transition(2112, 1056)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv(x.contiguous(memory_format=CL), self.conv_e1)
        x = F.max_pool2d(x, 3, 2, 1).contiguous(memory_format=CL)
        x = self.trans_e2(pad_br(self.dense_e2(x)))
        x = self.trans_e3(pad_br(self.dense_e3(x)))
        x = self.trans_e4(pad_br(self.dense_e4(x)))
        return x
