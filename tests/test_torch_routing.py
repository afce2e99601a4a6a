"""``ModelConfig.fused_dense`` in the port against the JAX package, on the
CPU.

The routing (``models/routing.py``) against JAX's routing functions for
every mode but "on" / "auto" (the port's table is its own, from H100
measurement), and the kernel launches per call it gives; routed S=29 and S=15
dense layers and blocks at their true widths against the JAX layers with
``fused="interpret"`` (the TPU kernels interpreted: the function the
port's kernels compute) on the same weights, in train mode (outputs,
updated running statistics, gradients) and eval mode; the decoders' S=8
block, routed in eval only (against the JAX decoder's unrouted block);
the forward-routed, backward-unrouted split ("on_all"); "off"; norm2's
batch statistics at the routed sizes; and ``cli.train --fused_dense``
reaching the model.  On CPU tensors every sandwich wrapper runs its
plain version.

Bars.  float32: outputs 1e-4 relL2, running statistics 1e-5, gradients
1e-3 (a ReLU input within rounding of 0 takes the other branch under
another summation order).  bfloat16: outputs 1e-2 and gradients 2e-2, the
bars of ``test_torch_sandwich_fwd.py`` / ``test_torch_sandwich_bwd.py``
(both sides round r once after norm2's affine, and y once; the sums run
in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import nhwc_to_torch, randomize_norms, rel_l2, \
    torch_to_nhwc
from md_rdm_tpu.kernels import dense_sandwich as jds
from md_rdm_tpu.models import densenet as jdn
from md_rdm_tpu_torch.cli import train as cli_train
from md_rdm_tpu_torch.core.config import ModelConfig
from md_rdm_tpu_torch.kernels import dense_sandwich as ds
from md_rdm_tpu_torch.models import densenet as tdn
from md_rdm_tpu_torch.models import routing as rt
from md_rdm_tpu_torch.models.rdm import DepthEstimationNet
from md_rdm_tpu_torch.models.routing import Routing
from md_rdm_tpu_torch.weights import from_jax_variables, to_jax_variables

MODES = ("off", "on_all", "on_all_bwd", "interpret")
TOL = {torch.float32: {"out": 1e-4, "grads": 1e-3, "stats": 1e-5},
       torch.bfloat16: {"out": 1e-2, "grads": 2e-2, "stats": 1e-5}}
JAX_DT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
BWD_STAGES = ("dense_sandwich_bwd", "bwd_recompute", "bwd_dx", "bwd_dw1",
              "bwd_dw2", "bwd_recompute_reference", "bwd_dx_reference",
              "bwd_dw1_reference", "bwd_dw2_reference")


# ---- the routing -----------------------------------------------------------

DTS = (torch.float32, torch.bfloat16)


@pytest.mark.parametrize("mode", MODES)
def test_routes_equal_jax(mode):
    """Every mode but "on" routes as in the JAX package, given as is and
    resolved."""
    for s in (57, 29, 15, 8):
        assert (s in rt.ENCODER_SIZES) == jds.supported_spatial(s)
        for r in (Routing(mode), Routing(Routing(mode).fused)):
            for dt in DTS:
                assert r.bwd(s, dt) == jds.bwd_routes(s, mode), (s, r)
                for train in (False, True):
                    assert (r.fwd(s, train, dt)
                            == jds.routes(s, train, mode)), (s, train, r)


def test_on_follows_the_port_tables():
    """"on" (and "auto", which resolves to it on every device, and is
    ``ModelConfig()``'s) routes exactly the sizes in the port's measured
    table, per mode of the step and dtype, and the backward at its train
    sizes in either mode; the eval sizes are ones the kernels take (the
    encoder's and the decoders' S=8), the train and flat sizes the
    encoder's (the JAX package's) only, and S=57 is in every layers entry.
    The kernel module holds no routing."""
    assert Routing("auto") == Routing("on") == Routing()
    assert Routing.of(ModelConfig()) == Routing()
    assert Routing("interpret") == Routing("on_all_bwd")
    assert set(rt.MEASURED) == {(t, dt) for t in (False, True) for dt in DTS}
    on = Routing("on")
    for dt in DTS:
        for train in (False, True):
            sizes = rt.MEASURED[train, dt]
            assert 57 in sizes.layers
            assert sizes.layers <= (rt.ENCODER_SIZES if train
                                    else rt.ENCODER_SIZES | {8})
            assert sizes.flat <= rt.ENCODER_SIZES
            for s in (57, 29, 15, 8):
                assert on.fwd(s, train, dt) == (s in sizes.layers)
        for s in (57, 29, 15, 8):
            assert on.bwd(s, dt) == (s in rt.MEASURED[True, dt].layers)
    assert not any(hasattr(ds, n) for n in ("routes", "bwd_routes",
                                            "flat_routes", "SUPPORTED"))


@pytest.mark.parametrize("fused,want", [("off", "off"), ("auto", "on"),
                                        ("on_all", "on_all"),
                                        ("interpret", "on_all_bwd")])
def test_model_config_reaches_every_dense_layer(fused, want):
    """The model's one routing, resolved, reaches every dense layer of the
    model: the encoder's and each decoder's, a relative one's too."""
    model = DepthEstimationNet(ModelConfig(fused_dense=fused,
                                           decoder_ids=(1, 6)))
    layers = [m for m in model.modules() if isinstance(m, tdn.DenseLayer)]
    assert len(layers) == 54 + 2 * 24
    assert {m.routing.fused for m in layers} == {want}
    assert {id(m.routing) for m in layers} == {id(model.encoder.dense_e2
                                                   .routing)}


def test_cli_fused_dense_reaches_the_model():
    """``cli.train --fused_dense off``: the parsed flag goes through
    ``build_config`` into the model the trainer builds."""
    from md_rdm_tpu_torch.training.module import DepthTrainer
    args = cli_train.build_parser().parse_args(
        ["--dataset", "synthetic", "--fused_dense", "off", "--device", "cpu"])
    config = cli_train.build_config(args)
    assert config.model.fused_dense == "off"
    model = DepthTrainer(config, device="cpu").init(seed=0).model
    modes = {m.routing.fused for m in model.modules()
             if isinstance(m, tdn.DenseLayer)}
    assert modes == {"off"}


# Dense layers per block: the encoder's three, and each decoder's S=8 one.
ENCODER_LAYERS = {57: 6, 29: 12, 15: 36}
DECODER_LAYERS = 24


@pytest.mark.parametrize("decoders,dtype,train,want", [
    ((1,), torch.float32, False, 78), ((1, 6, 7, 8, 9), torch.float32, False,
                                       174),
    ((1,), torch.bfloat16, False, 18), ((1,), torch.float32, True, 18),
    ((1,), torch.bfloat16, True, 6)],
    ids=["live-f32-eval", "optimal-f32-eval", "live-bf16-eval",
         "live-f32-train", "live-bf16-train"])
def test_default_launches_per_call(decoders, dtype, train, want):
    """The default configuration's kernel launches, from the layer counts
    per block and the routing's decisions: each of F1-F3 per forward, and
    in train each of K1-K4 per step (the same layers: in train the
    default routes both ways or neither)."""
    routing = Routing.of(ModelConfig(decoder_ids=decoders))
    blocks = {**ENCODER_LAYERS, 8: DECODER_LAYERS * len(decoders)}
    for bwd in (False, True) if train else (False,):
        assert sum(n for s, n in blocks.items()
                   if routing.launches(s, train, dtype, bwd)) == want


# ---- routed layers and blocks against the JAX package -----------------------

def _x(shape, seed, dtype):
    """Seeded NHWC input, rounded to ``dtype``'s values (float32 numpy)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(dtype).float().numpy()


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float32)


def _train_pair(jax_module, torch_module, x, seed, dtype):
    """Init the JAX module, randomize its norms, load the port's; one
    train-mode forward of both on ``x`` in ``dtype`` with a fixed
    cotangent.  Returns {name: (port, jax)} for out, dx, grads, stats."""
    v = randomize_norms(jax_module.init(jax.random.PRNGKey(seed),
                                        jnp.asarray(x), False), seed)
    torch_module.load_state_dict(
        from_jax_variables(v["params"], v["batch_stats"]), strict=True)
    v = jax.tree_util.tree_map(jnp.asarray, v)
    xj = jnp.asarray(x).astype(JAX_DT[dtype])

    def f(params, xj, cot):
        out, upd = jax_module.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, xj, True,
            mutable=["batch_stats"])
        loss = jnp.sum(out.astype(jnp.float32) * cot)
        return loss, (out, upd["batch_stats"])

    shape = jax.eval_shape(lambda p, xj: f(p, xj, 0.0)[1][0], v["params"],
                           xj).shape
    cot = np.random.default_rng(seed + 100).standard_normal(shape).astype(
        np.float32)
    (_, (out, stats)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(v["params"], xj, jnp.asarray(cot))
    base = torch.from_numpy(x).to(dtype).requires_grad_()
    torch_module.train()
    y = torch_module(base.permute(0, 3, 1, 2))
    (y.float() * nhwc_to_torch(cot)).sum().backward()
    grads = to_jax_variables({n: p.grad for n, p in
                              torch_module.named_parameters()})["params"]
    port_stats = to_jax_variables(torch_module.state_dict())["batch_stats"]
    return {"out": (torch_to_nhwc(y), np.asarray(out, np.float32)),
            "dx": (base.grad.float().numpy(), np.asarray(gx, np.float32)),
            "grads": (dict(_leaves(grads)), dict(_leaves(gp))),
            "stats": (dict(_leaves(port_stats)), dict(_leaves(stats))),
            "old_stats": dict(_leaves(v["batch_stats"]))}


def _check(r, dtype, per_tensor_grads=True):
    tol = TOL[dtype]
    assert rel_l2(*r["out"]) < tol["out"]
    assert rel_l2(*r["dx"]) < tol["grads"]
    got, want = r["grads"]
    assert set(got) == set(want)
    if per_tensor_grads:
        for k in want:
            assert rel_l2(got[k], want[k]) < tol["grads"], k
    else:
        keys = sorted(want)
        assert rel_l2(np.concatenate([got[k].ravel() for k in keys]),
                      np.concatenate([want[k].ravel() for k in keys])
                      ) < tol["grads"]
    got, want = r["stats"]
    assert set(got) == set(want)
    for k in want:
        assert rel_l2(got[k], want[k]) < tol["stats"], k
        assert not np.allclose(want[k], r["old_stats"][k]), k


DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                                 ids=["f32", "bf16"])
DT_IDS = {torch.float32: "f32", torch.bfloat16: "bf16"}.get


@DTYPES
@pytest.mark.parametrize("s,c_in,b", [(29, 192, 2), (15, 384, 2),
                                      (15, 2064, 1)])
def test_routed_layer_matches_jax_interpret(s, c_in, b, dtype):
    """A routed layer (forward and backward through the sandwich's plain
    stages) against the JAX layer running the TPU kernels interpreted:
    output, running statistics, dx and every parameter's gradient."""
    r = _train_pair(jdn.DenseLayer(s, 48, dtype=JAX_DT[dtype],
                                   fused="interpret"),
                    tdn.DenseLayer(c_in, s, routing=Routing("on_all_bwd")),
                    _x((b, s, s, c_in), s + c_in, dtype), s, dtype)
    assert r["out"][0].shape == (b, s, s, 48)
    _check(r, dtype)


@DTYPES
@pytest.mark.parametrize("s,c_in,n", [(29, 192, 3), (15, 384, 2)])
def test_routed_block_matches_jax_interpret(s, c_in, n, dtype):
    """A routed block; its parameters' gradients are held together, as
    ``test_torch_train.py`` holds a block's: in bfloat16 a layer's
    rounding reaches the next layer's input, and single small tensors (a
    norm's bias) move past the bar alone."""
    r = _train_pair(jdn.DenseBlock(n, s, 48, dtype=JAX_DT[dtype],
                                   fused="interpret"),
                    tdn.DenseBlock(n, c_in, s,
                                   routing=Routing("on_all_bwd", "off")),
                    _x((1, s, s, c_in), s, dtype), s + 1, dtype)
    assert r["out"][0].shape == (1, s, s, c_in + n * 48)
    _check(r, dtype, per_tensor_grads=False)


@DTYPES
@pytest.mark.parametrize("s,c_in", [(29, 720), (15, 2064)])
def test_routed_layer_eval_matches_jax_interpret(s, c_in, dtype):
    """Eval mode (norm2 folded on its running statistics), the last layer
    of each block; and the routed port against its unrouted layer."""
    x = _x((1, s, s, c_in), s, dtype)
    jl = jdn.DenseLayer(s, 48, dtype=JAX_DT[dtype], fused="interpret")
    v = randomize_norms(jl.init(jax.random.PRNGKey(s), jnp.asarray(x),
                                False), s)
    want = np.asarray(jl.apply(v, jnp.asarray(x).astype(JAX_DT[dtype]),
                               False), np.float32)
    sd = from_jax_variables(v["params"], v["batch_stats"])
    got = {}
    for mode in ("on", "on_all", "off"):
        layer = tdn.DenseLayer(c_in, s, routing=Routing(mode)).eval()
        layer.load_state_dict(sd)
        with torch.no_grad():
            got[mode] = torch_to_nhwc(layer(
                torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2)))
    tol = TOL[dtype]["out"]
    assert rel_l2(got["on_all"], want) < tol
    assert rel_l2(got["on_all"], got["off"]) < tol
    if Routing("on").fwd(s, False, dtype):
        np.testing.assert_array_equal(got["on"], got["on_all"])
    else:
        np.testing.assert_array_equal(got["on"], got["off"])


# ---- the decoders' S=8 dense block ------------------------------------------

def _sandwich_calls(monkeypatch):
    """Record each ``dense_sandwich_packed`` call a dense layer makes."""
    calls = []
    orig = tdn.dense_sandwich_packed
    monkeypatch.setattr(tdn, "dense_sandwich_packed", lambda *a: (
        calls.append(a[0].shape), orig(*a))[1])
    return calls


@pytest.mark.parametrize("dtype", [
    dt for dt in (torch.float32, torch.bfloat16)
    if 8 in rt.MEASURED[False, dt].layers], ids=DT_IDS)
@pytest.mark.parametrize("c_in,n,b", [(1056, 3, 2), (2160, 1, 1)])
def test_decoder_block_routed_eval_matches_jax(monkeypatch, c_in, n, b,
                                               dtype):
    """The decoders' dense block (bn_size 8 at S=8; its first three
    layers, and its last) in eval under "on": every layer through the
    sandwich's plain stages, against the JAX decoder's unrouted
    ``DenseBlock(n, 8, 48)`` on the same randomized weights, and against
    the port's unrouted block ("off")."""
    x = _x((b, 8, 8, c_in), c_in + n, dtype)
    jb = jdn.DenseBlock(n, 8, 48, dtype=JAX_DT[dtype])
    v = randomize_norms(jb.init(jax.random.PRNGKey(n), jnp.asarray(x),
                                False), c_in)
    want = np.asarray(jb.apply(v, jnp.asarray(x).astype(JAX_DT[dtype]),
                               False), np.float32)
    sd = from_jax_variables(v["params"], v["batch_stats"])
    calls = _sandwich_calls(monkeypatch)
    got = {}
    for mode in ("on", "off"):
        block = tdn.DenseBlock(n, c_in, 8, routing=Routing(mode)).eval()
        block.load_state_dict(sd)
        with torch.no_grad():
            got[mode] = torch_to_nhwc(block(
                torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2)))
    assert calls == [(b, 8, 8, c_in + 48 * i) for i in range(n)]
    assert got["on"].shape == (b, 8, 8, c_in + 48 * n)
    tol = TOL[dtype]["out"]
    assert rel_l2(got["on"], want) < tol
    assert rel_l2(got["on"], got["off"]) < tol


@DTYPES
def test_decoder_layer_unrouted_in_train(monkeypatch, dtype):
    """Under "on" an S=8 dense layer runs the separate ops in train mode
    (no sandwich call, no folded batch statistics), forward and backward,
    and goes through the sandwich in eval exactly where the eval table
    holds S=8 for the dtype."""
    on = Routing("on")
    calls = _sandwich_calls(monkeypatch)
    stats = []
    orig = tdn.conv_bn_stats
    monkeypatch.setattr(tdn, "conv_bn_stats", lambda *a: (
        stats.append(1), orig(*a))[1])
    layer = tdn.DenseLayer(1056, 8, routing=on)
    x = torch.randn(2, 1056, 8, 8).to(dtype).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    layer.train()(x).float().sum().backward()
    assert calls == [] and stats == []
    assert x.grad is not None
    with torch.no_grad():
        layer.eval()(x)
    assert len(calls) == int(on.fwd(8, False, dtype))
    assert not on.fwd(8, True, dtype)
    assert not on.bwd(8, dtype)


# ---- the forward-routed, backward-unrouted split ----------------------------

def _stage_calls(monkeypatch):
    """Count the calls of every backward stage of the sandwich (kernel
    wrappers and plain versions)."""
    calls = []
    for name in BWD_STAGES:
        fn = getattr(ds, name)
        monkeypatch.setattr(ds, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append(_n), _f(*a, **k))[1])
    return calls


def _block_grads(mode, dtype=torch.float32):
    torch.manual_seed(0)
    block = tdn.DenseBlock(2, 384, 15, routing=Routing(mode, "off"))
    x = torch.randn(2, 384, 15, 15, generator=torch.Generator().manual_seed(
        1)).to(dtype).contiguous(memory_format=torch.channels_last)
    x.requires_grad_()
    y = block.train()(x)
    y.float().square().sum().backward()
    return y.detach(), x.grad, {n: p.grad for n, p in
                                block.named_parameters()}, block.state_dict()


def test_on_all_runs_no_backward_stage_and_equals_on_all_bwd(monkeypatch):
    """Under "on_all" the forward takes the sandwich and the backward is
    autograd through the plain ops: no K1-K4 stage runs, kernel or plain
    version.  Its gradients equal "on_all_bwd"'s, whose backward runs the
    four stages per layer."""
    calls = _stage_calls(monkeypatch)
    y1, dx1, g1, sd1 = _block_grads("on_all")
    assert calls == []
    y2, dx2, g2, sd2 = _block_grads("on_all_bwd")
    assert calls.count("dense_sandwich_bwd") == 2
    assert calls.count("bwd_recompute_reference") == 2
    assert torch.equal(y1, y2)
    assert rel_l2(dx1, dx2) < 1e-3
    assert set(g1) == set(g2)
    for k in g1:
        assert rel_l2(g1[k], g2[k]) < 1e-3, k
    for k in sd1:
        if "running" in k:
            assert torch.equal(sd1[k], sd2[k]), k


def test_off_calls_no_sandwich(monkeypatch):
    """Under "off" no layer reaches a sandwich wrapper or norm2's folded
    statistics, in eval or train, at any of the three sizes."""
    calls = []
    for mod, names in ((tdn, ("dense_sandwich_packed", "conv_bn_stats",
                              "pack_weights")),
                       (ds, ("dense_sandwich", "fwd_expand", "fwd_taps",
                             "fwd_tapsum") + BWD_STAGES)):
        for name in names:
            monkeypatch.setattr(mod, name, lambda *a, _n=name, **k:
                                calls.append(_n))
    for s in (57, 29, 15):
        layer = tdn.DenseLayer(96, s, routing=Routing("off"))
        x = torch.randn(1, 96, s, s, requires_grad=True)
        layer.train()(x).sum().backward()
        with torch.no_grad():
            layer.eval()(x)
    assert calls == []


@pytest.mark.parametrize("mode,s", [("on_all", 15), ("on_all_bwd", 29),
                                    ("interpret", 15), ("on", 57)])
def test_routed_layer_calls_the_sandwich(monkeypatch, mode, s):
    """The routed layer goes through the sandwich in both modes of the
    step, and K1-K4 run where ``Routing.bwd`` says so."""
    calls = _stage_calls(monkeypatch)
    packed = []
    orig = tdn.dense_sandwich_packed
    monkeypatch.setattr(tdn, "dense_sandwich_packed", lambda *a: (
        packed.append(a[2]), orig(*a))[1])
    routing = Routing(mode)
    layer = tdn.DenseLayer(96, s, routing=routing)
    x = torch.randn(1, 96, s, s, requires_grad=True)
    layer.train()(x).sum().backward()
    with torch.no_grad():
        layer.eval()(x)
    bwd = routing.bwd(s, torch.float32)
    assert packed == [bwd, bwd]
    assert ("dense_sandwich_bwd" in calls) == bwd


# ---- norm2's statistics -----------------------------------------------------

def _stats_inputs(s, c_in, b):
    rng = np.random.default_rng(s + c_in)
    x = np.abs(rng.standard_normal((b, s, s, c_in))).astype(np.float32)
    w1 = (rng.standard_normal((48 * s, c_in, 1, 1)) / c_in ** .5).astype(
        np.float32)
    cm, cv = (rng.standard_normal(48 * s).astype(np.float32)
              for _ in range(2))
    return x, w1, cm, cv


@pytest.mark.parametrize("s,c_in,b", [(29, 192, 2), (15, 384, 2),
                                      (15, 2064, 1)])
def test_conv_bn_stats_matches_jax_at_routed_sizes(s, c_in, b):
    """norm2's statistics from the covariance, and their gradients, at
    1e-5 against the JAX package's ``conv_bn_stats``, up to the widest
    S=15 layer."""
    x, w1, cm, cv = _stats_inputs(s, c_in, b)

    def jloss(x, w):
        m, v = jds.conv_bn_stats(x, w)
        return (m * cm).sum() + (v * cv).sum(), (m, v)

    (_, (jm, jv)), (jgx, jgw) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w1[:, :, 0, 0].T[None, None]))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w1).requires_grad_()
    m, v = ds.conv_bn_stats(xt, wt)
    gx, gw = torch.autograd.grad((m * torch.from_numpy(cm)).sum()
                                 + (v * torch.from_numpy(cv)).sum(),
                                 (xt, wt))
    assert rel_l2(m.detach().numpy(), np.asarray(jm)) < 1e-5
    assert rel_l2(v.detach().numpy(), np.asarray(jv)) < 1e-5
    assert rel_l2(gx.numpy(), np.asarray(jgx)) < 1e-5
    assert rel_l2(gw[:, :, 0, 0].numpy(), np.asarray(jgw)[0, 0].T) < 1e-5


def test_conv_bn_stats_exact_at_the_widest_layer():
    """At the widest layer (S=15, C_in 2,064) the covariance's statistics
    hold at 1e-5 against z = x W materialized and reduced in float64."""
    x, w1, _, _ = _stats_inputs(15, 2064, 2)
    m, v = ds.conv_bn_stats(torch.from_numpy(x), torch.from_numpy(w1))
    z = x.reshape(-1, 2064).astype(np.float64) @ w1[:, :, 0, 0].T.astype(
        np.float64)
    assert rel_l2(m.numpy(), z.mean(0)) < 1e-5
    assert rel_l2(v.numpy(), z.var(0)) < 1e-5
