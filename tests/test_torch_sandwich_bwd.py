"""Port's sandwich backward on CPU tensors (the composition of the plain
versions of its four kernels K1-K4, which chip_smoke.py holds the CUDA
kernels against on the card) against the JAX package's TPU backward
kernels run interpreted: ``_bwd_kernel`` (B3), the flat-frame pair
``_kernel_flat`` / ``_bwd_kernel_flat`` (B2f / B2b) and the NHWC pair (B5f
/ B5b); the shifted-window semantics of K1's dr and K4's dw2 at the image
edge; plus the autograd Function and ``conv_bn_stats``.  Bar: gradients
normalized by their max, 5e-4 in float32 (as tests/test_dense_sandwich.py
holds the TPU kernels), 2e-2 in bfloat16 (the backward's bf16 bar: both
sides round r and dz to bf16, and another summation order of z moves a
rounding by one bf16 ulp)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rel_l2
from md_rdm_tpu.kernels import dense_sandwich as jds
from md_rdm_tpu.kernels.dense_sandwich_nhwc import (sandwich_nhwc,
                                                    sandwich_nhwc_bwd)
from md_rdm_tpu_torch.kernels import dense_sandwich as ds

TOL = 5e-4
BF16_TOL = 2e-2


def _inputs(b, s, c_in, seed=1):
    """JAX layouts (HWIO), as tests/test_dense_sandwich.py builds them, and
    a cotangent g [B, S, S, 48]."""
    rng = np.random.default_rng(seed)
    c_mid = 48 * s
    xr = rng.standard_normal((b, s, s, c_in)).clip(0).astype(np.float32)
    w1 = (rng.standard_normal((1, 1, c_in, c_mid)) * 0.05).astype(np.float32)
    w2 = (rng.standard_normal((3, 3, c_mid, 48)) * 0.05).astype(np.float32)
    scale = (rng.standard_normal(c_mid) * 0.1 + 1.0).astype(np.float32)
    shift = (rng.standard_normal(c_mid) * 0.1).astype(np.float32)
    g = rng.standard_normal((b, s, s, 48)).astype(np.float32)
    return (xr, w1, scale, shift, w2), g


def _port(xr, w1, scale, shift, w2):
    """JAX layouts -> the port's: x NHWC, conv weights OIHW."""
    return (torch.from_numpy(xr),
            torch.from_numpy(np.ascontiguousarray(w1.transpose(3, 2, 0, 1))),
            torch.from_numpy(scale), torch.from_numpy(shift),
            torch.from_numpy(np.ascontiguousarray(w2.transpose(3, 2, 0, 1))))


def _to_jax_layout(grads):
    """Port gradients -> the JAX ones' layouts (HWIO conv weights)."""
    dx, dw1, dscale, dshift, dw2 = (t.detach().float().numpy() for t in grads)
    return (dx, dw1.transpose(2, 3, 1, 0), dscale, dshift,
            dw2.transpose(2, 3, 1, 0))


def _assert_close(got, want, names=("dx", "dw1", "dscale", "dshift", "dw2"),
                  tol=TOL):
    for gg, ww, name in zip(got, want, names):
        ww = np.asarray(ww, np.float32)
        assert gg.shape == ww.shape, (name, gg.shape, ww.shape)
        den = float(np.max(np.abs(ww))) + 1e-9
        np.testing.assert_allclose(gg / den, ww / den, rtol=tol, atol=tol,
                                   err_msg=name)


def _launches():
    return [fn.launches for fn in ds.BWD_KERNELS]


@pytest.mark.parametrize("b,s,c_in", [(2, 15, 96), (2, 29, 192),
                                      (1, 57, 336)])
def test_plain_backward_matches_jax_bwd_kernel(b, s, c_in):
    """B3: ``_pallas_sandwich_bwd`` interpreted."""
    args, g = _inputs(b, s, c_in)
    want = jds._pallas_sandwich_bwd(*[jnp.asarray(a) for a in args],
                                    jnp.asarray(g), interpret=True)
    before = _launches()
    got = ds.dense_sandwich_bwd(*_port(*args), torch.from_numpy(g))
    assert _launches() == before   # CPU: no launch
    assert got[0].dtype == torch.float32
    assert all(t.dtype == torch.float32 for t in got[1:])
    _assert_close(_to_jax_layout(got), want)


@pytest.mark.parametrize("b,s,c_in", [(2, 15, 96), (2, 29, 192)])
def test_plain_backward_matches_jax_bwd_kernel_bf16(b, s, c_in):
    """B3 in bfloat16: x and g in bf16 through ``_pallas_sandwich_bwd``
    interpreted and through the port's composed plain stages."""
    args, g = _inputs(b, s, c_in)
    bf = jnp.bfloat16
    want = jds._pallas_sandwich_bwd(
        jnp.asarray(args[0]).astype(bf), *[jnp.asarray(a) for a in args[1:]],
        jnp.asarray(g).astype(bf), interpret=True)
    pargs = list(_port(*args))
    pargs[0] = pargs[0].to(torch.bfloat16)
    got = ds.dense_sandwich_bwd(*pargs, torch.from_numpy(g).to(torch.bfloat16))
    assert got[0].dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for t in got[1:])
    _assert_close(_to_jax_layout(got), want, tol=BF16_TOL)


def _to_flat(x):
    """NHWC -> lead-frame flat stack [B, C, ZT] (zero borders)."""
    b, s, _, c = x.shape
    f, _w, zt = jds._geometry_flat(s)
    xp = jnp.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    return jnp.pad(xp.transpose(0, 3, 1, 2).reshape(b, c, f * f),
                   ((0, 0), (0, 0), (jds.LEAD, zt - jds.LEAD - f * f)))


def _from_flat(xs, s):
    """Lead-frame flat stack -> NHWC interior."""
    f, _w, _zt = jds._geometry_flat(s)
    b, c, _ = xs.shape
    fr = np.asarray(xs)[:, :, jds.LEAD:jds.LEAD + f * f].reshape(b, c, f, f)
    return fr[:, :, 1:s + 1, 1:s + 1].transpose(0, 2, 3, 1)


def test_forward_and_backward_match_jax_flat_kernels():
    """B2f / B2b: ``dense_sandwich_flat`` with the Pallas forward and
    backward, interpreted, on the lead-frame stack; the port computes the
    same function on NHWC."""
    s = 15
    args, g = _inputs(2, s, 96, seed=4)
    xs = _to_flat(jnp.asarray(args[0]))
    jargs = (xs,) + tuple(jnp.asarray(a) for a in args[1:])
    fn = lambda *a: jds.dense_sandwich_flat(  # noqa: E731
        *a, s=s, interpret=True, pallas_bwd=True)
    y, vjp = jax.vjp(fn, *jargs)
    dxs, dw1, dscale, dshift, dw2 = vjp(_to_flat(jnp.asarray(g)))
    pargs = _port(*args)
    y_port = ds.dense_sandwich(*pargs)
    assert rel_l2(y_port.numpy(), _from_flat(y, s)) < 1e-5
    got = _to_jax_layout(ds.dense_sandwich_bwd(*pargs, torch.from_numpy(g)))
    _assert_close(got, (_from_flat(dxs, s), dw1, dscale, dshift, dw2))


def test_backward_matches_jax_flat_kernels_bf16():
    """B2b in bfloat16: ``dense_sandwich_flat``'s Pallas backward,
    interpreted on the bf16 lead-frame stack, against the port's composed
    plain stages."""
    s = 15
    args, g = _inputs(2, s, 96, seed=4)
    bf = jnp.bfloat16
    xs = _to_flat(jnp.asarray(args[0]).astype(bf))
    jargs = (xs,) + tuple(jnp.asarray(a) for a in args[1:])
    fn = lambda *a: jds.dense_sandwich_flat(  # noqa: E731
        *a, s=s, interpret=True, pallas_bwd=True)
    _, vjp = jax.vjp(fn, *jargs)
    dxs, dw1, dscale, dshift, dw2 = vjp(_to_flat(jnp.asarray(g).astype(bf)))
    pargs = list(_port(*args))
    pargs[0] = pargs[0].to(torch.bfloat16)
    got = _to_jax_layout(ds.dense_sandwich_bwd(
        *pargs, torch.from_numpy(g).to(torch.bfloat16)))
    want = (_from_flat(dxs.astype(jnp.float32), s), dw1, dscale, dshift, dw2)
    _assert_close(got, want, tol=BF16_TOL)


def test_nhwc_kernels_match_port():
    """B5f / B5b: ``sandwich_nhwc`` and ``sandwich_nhwc_bwd`` interpreted
    against the port's forward and backward."""
    args, g = _inputs(2, 15, 144, seed=5)
    jargs = [jnp.asarray(a) for a in args]
    y = sandwich_nhwc(*jargs, interpret=True)
    want = sandwich_nhwc_bwd(*jargs, jnp.asarray(g), interpret=True)
    pargs = _port(*args)
    assert rel_l2(ds.dense_sandwich(*pargs).numpy(), np.asarray(y)) < 1e-5
    _assert_close(_to_jax_layout(ds.dense_sandwich_bwd(
        *pargs, torch.from_numpy(g))), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_matches_autograd_of_plain_forward(dtype):
    """On CPU tensors the Function's backward is the plain backward; in
    float32 it equals autograd through the plain forward.  In bfloat16 the
    plain forward rounds z before the affine and autograd rounds each
    convolution's gradient, so the bar is bf16's."""
    args, g = _inputs(2, 15, 96, seed=6)
    leaves = [t.clone().requires_grad_() for t in _port(*args)]
    leaves[0] = leaves[0].detach().to(dtype).requires_grad_()
    gy = torch.from_numpy(g).to(dtype)
    y = ds.dense_sandwich(*leaves)
    assert type(y.grad_fn).__name__ == "SandwichFunctionBackward"
    got = torch.autograd.grad(y, leaves, gy)
    want = torch.autograd.grad(ds.dense_sandwich_reference(*leaves), leaves,
                               gy)
    tol = 1e-6 if dtype == torch.float32 else 2e-2
    for a, b, name in zip(got, want, ("dx", "dw1", "dscale", "dshift",
                                      "dw2")):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert rel_l2(a.float().numpy(), b.float().numpy()) < tol, name


def test_function_saves_no_intermediate():
    """The Function keeps its inputs for the backward, nothing of z's
    size (the backward recomputes it)."""
    args, _ = _inputs(1, 15, 96, seed=7)
    leaves = [t.clone().requires_grad_() for t in _port(*args)]
    y = ds.dense_sandwich(*leaves)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 5
    assert all(a is b or a.data_ptr() == b.data_ptr()
               for a, b in zip(saved, leaves))


@pytest.mark.parametrize("s,c_in,b", [(57, 96, 1), (15, 384, 2)])
def test_conv_bn_stats_matches_jax(s, c_in, b):
    args, _ = _inputs(b, s, c_in, seed=8)
    jm, jv = jds.conv_bn_stats(jnp.asarray(args[0]), jnp.asarray(args[1]))
    pargs = _port(*args)
    m, v = ds.conv_bn_stats(pargs[0], pargs[1])
    assert m.dtype == v.dtype == torch.float32
    assert rel_l2(m.numpy(), np.asarray(jm)) < 1e-5
    assert rel_l2(v.numpy(), np.asarray(jv)) < 1e-5
    # and the statistics of the materialized z (biased variance)
    z = torch.nn.functional.conv2d(pargs[0].permute(0, 3, 1, 2), pargs[1])
    assert rel_l2(v.numpy(), z.var((0, 2, 3), unbiased=False).numpy()) < 1e-4


def test_conv_bn_stats_gradients_match_jax():
    """The statistics are differentiable in x and w1, as in JAX."""
    args, _ = _inputs(2, 15, 96, seed=9)
    rng = np.random.default_rng(10)
    cm, cv = (rng.standard_normal(720).astype(np.float32) for _ in range(2))

    def jloss(x, w1):
        m, v = jds.conv_bn_stats(x, w1)
        return jnp.sum(m * cm) + jnp.sum(v * cv)

    jgx, jgw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(args[0]),
                                               jnp.asarray(args[1]))
    x, w1 = (t.requires_grad_() for t in _port(*args)[:2])
    m, v = ds.conv_bn_stats(x, w1)
    gx, gw = torch.autograd.grad((m * torch.from_numpy(cm)).sum()
                                 + (v * torch.from_numpy(cv)).sum(), (x, w1))
    assert rel_l2(gx.numpy(), np.asarray(jgx)) < 1e-5
    assert rel_l2(gw.numpy().transpose(2, 3, 1, 0), np.asarray(jgw)) < 1e-5


@pytest.mark.parametrize("s", [1, 9, 15])
@pytest.mark.parametrize("kind", ["dr", "dw2"])
def test_shifted_window_at_image_edge(kind, s):
    """The im2col of g that K1 (dr) and K4 (dw2) read, with every tap's
    window crossing the border of an odd-sized image (S = 1: only the
    centre tap sees a pixel): dr = G @ w2_rows(w2) is conv2's transpose,
    dw2 = r^T @ G is ``torch.nn.grad.conv2d_weight``."""
    rng = np.random.default_rng(11 + s)
    b, c_mid = 2, 40
    g = torch.from_numpy(rng.standard_normal((b, s, s, 48)).astype(np.float32))
    g4 = g.permute(0, 3, 1, 2)
    if kind == "dr":
        w2 = torch.from_numpy(
            rng.standard_normal((48, c_mid, 3, 3)).astype(np.float32))
        got = ds.g_columns(g) @ ds.w2_rows(w2, torch.float32)
        want = torch.nn.functional.conv_transpose2d(g4, w2, padding=1)
        want = want.permute(0, 2, 3, 1).reshape(-1, c_mid)
    else:
        r = torch.from_numpy(
            rng.standard_normal((b * s * s, c_mid)).astype(np.float32))
        got = ds.bwd_dw2_reference(r, g)
        r4 = r.view(b, s, s, c_mid).permute(0, 3, 1, 2)
        want = torch.nn.grad.conv2d_weight(r4, (48, c_mid, 3, 3), g4,
                                           padding=1)
    assert got.shape == want.shape
    assert rel_l2(got.numpy(), want.numpy()) < 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stage_wrappers_run_plain_stages_on_cpu(dtype):
    """Each kernel wrapper on CPU tensors returns its plain stage's result,
    in the stated dtypes and layouts, and launches nothing; the backward is
    their composition."""
    args, g = _inputs(2, 9, 96, seed=12)
    pargs = list(_port(*args))
    pargs[0] = pargs[0].to(dtype)
    gt = torch.from_numpy(g).to(dtype)
    x, w1 = pargs[:2]
    before = _launches()
    r, dz, dscale, dshift = ds.bwd_recompute(*pargs, gt)
    want = ds.bwd_recompute_reference(*pargs, gt)
    for a, b in zip((r, dz, dscale, dshift), want):
        assert torch.equal(a, b)
    assert r.shape == dz.shape == (2 * 9 * 9, 9 * 48)
    assert r.dtype == dz.dtype == dtype
    assert dscale.dtype == dshift.dtype == torch.float32
    assert bool((r >= 0).all())
    dx = ds.bwd_dx(dz, w1, x.shape)
    dw1 = ds.bwd_dw1(x, dz)
    dw2 = ds.bwd_dw2(r, gt)
    assert torch.equal(dx, ds.bwd_dx_reference(dz, w1, x.shape))
    assert torch.equal(dw1, ds.bwd_dw1_reference(x, dz))
    assert torch.equal(dw2, ds.bwd_dw2_reference(r, gt))
    assert dx.dtype == dtype and dx.shape == x.shape
    assert dw1.shape == (9 * 48, 96, 1, 1) and dw2.shape == (48, 9 * 48, 3, 3)
    assert _launches() == before
    for a, b in zip(ds.dense_sandwich_bwd(*pargs, gt),
                    (dx, dw1, dscale, dshift, dw2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("stage", ["bwd_recompute", "bwd_dx", "bwd_dw1",
                                   "bwd_dw2"])
def test_stage_wrappers_reject_other_devices(stage):
    args, g = _inputs(1, 9, 96)
    x, w1, scale, shift, w2 = (t.to("meta") for t in _port(*args))
    gm = torch.from_numpy(g).to("meta")
    rows = torch.empty((81, 9 * 48), device="meta")
    call = {"bwd_recompute": lambda: ds.bwd_recompute(x, w1, scale, shift,
                                                      w2, gm),
            "bwd_dx": lambda: ds.bwd_dx(rows, w1, x.shape),
            "bwd_dw1": lambda: ds.bwd_dw1(x, rows),
            "bwd_dw2": lambda: ds.bwd_dw2(rows, gm)}[stage]
    with pytest.raises(ValueError, match="device"):
        call()


def test_bwd_wrapper_rejects_other_devices():
    args, g = _inputs(1, 15, 96)
    pargs = _port(*args)
    with pytest.raises(ValueError, match="device"):
        ds.dense_sandwich_bwd(pargs[0].to("meta"), *pargs[1:],
                              torch.from_numpy(g))


def test_bwd_flop_and_byte_counts():
    """The bound's operands, checked against the JAX package's count:
    327.7 / 532.5 GFLOP at batch 16, S=57, C_in 96 / 336; 2.581 TFLOP over
    the six S=57 layers."""
    for c_in in (96, 336):
        assert ds.sandwich_bwd_flops(16, 57, c_in, 2736) == \
            jds.sandwich_bwd_flops(16, 57, c_in, 2736)
    assert round(ds.sandwich_bwd_flops(16, 57, 96, 2736) / 1e9, 1) == 327.7
    assert round(ds.sandwich_bwd_flops(16, 57, 336, 2736) / 1e9, 1) == 532.5
    total = sum(ds.sandwich_bwd_flops(16, 57, 96 + 48 * i, 2736)
                for i in range(6))
    assert round(total / 1e12, 3) == 2.581
    n = ds.sandwich_bwd_bytes(1, 15, 96, 720, 2)
    assert n == (2 * (2 * 225 * 96 + 225 * 48 + 96 * 720 + 9 * 720 * 48)
                 + 4 * (4 * 720 + 96 * 720 + 9 * 720 * 48))


@pytest.mark.parametrize("c_in", [96, 336])
def test_bwd_stage_work_adds_up(c_in):
    """The four kernels' operations add up to the backward's; each kernel's
    bytes count its own inputs and outputs, r and dz included."""
    work = ds.bwd_stage_work(16, 57, c_in, 2736, 2)
    assert list(work) == [fn.__name__ for fn in ds.BWD_KERNELS]
    assert sum(f for f, _ in work.values()) == ds.sandwich_bwd_flops(
        16, 57, c_in, 2736)
    pix = 16 * 57 * 57
    assert work["bwd_dw2"] == (2 * pix * 2736 * 432,
                               2 * (pix * 2736 + pix * 48) + 4 * 2736 * 432)
    # K1 writes r and dz: 2 * P * C_mid elements in the compute dtype
    assert work["bwd_recompute"][1] > 2 * 2 * pix * 2736
