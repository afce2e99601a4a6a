"""The port's growth-conv matmul formulation (``md_rdm_tpu_torch/kernels/
growth_conv.py``) against the JAX package's ``md_rdm_tpu/kernels/
growth_conv.py`` and against ``F.conv2d``, and its routing in the encoder
(``ModelConfig.growth_matmul``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_parity import rel_l2
from md_rdm_tpu.kernels import growth_conv as jgc
from md_rdm_tpu.models import densenet as jdn
from md_rdm_tpu_torch.core.config import ModelConfig
from md_rdm_tpu_torch.kernels import growth_conv as tgc
from md_rdm_tpu_torch.models import densenet as tdn
from md_rdm_tpu_torch.models import routing as rt
from md_rdm_tpu_torch.models.rdm import DepthEstimationNet
from md_rdm_tpu_torch.models.routing import Routing

# float32: max abs against JAX and F.conv2d (sums of up to 9 * 24 products
# of O(1) terms); bfloat16: relL2, the port rounding the product's output
# to bfloat16 where JAX keeps float32
F32_TOL = 1e-5
BF16_TOL = 1e-2


def _inputs(b, s, c, g=48, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((b, c, s, s)).clip(0).astype(np.float32)
    w2 = (rng.standard_normal((g, c, 3, 3)) * 0.1).astype(np.float32)
    return z, w2


def _jax(z, w2, dt):
    """JAX's function on the same tensors (NHWC / HWIO), back as NCHW
    float32."""
    out = jgc.growth_conv_matmul(
        jnp.asarray(z.transpose(0, 2, 3, 1), dt),
        jnp.asarray(w2.transpose(2, 3, 1, 0), dt))
    assert out.dtype == dt
    return np.asarray(out.astype(jnp.float32)).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("s,c", [(57, 16), (29, 24), (15, 24), (8, 32)])
def test_matches_jax_and_conv_float32(s, c):
    z, w2 = _inputs(2, s, c, seed=s)
    zt = torch.from_numpy(z).contiguous(memory_format=torch.channels_last)
    got = tgc.growth_conv_matmul(zt, torch.from_numpy(w2))
    assert got.shape == (2, 48, s, s) and got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_allclose(got, _jax(z, w2, jnp.float32), rtol=0,
                               atol=F32_TOL)
    conv = F.conv2d(torch.from_numpy(z), torch.from_numpy(w2),
                    padding=1).numpy()
    np.testing.assert_allclose(got, conv, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("s,c", [(57, 16), (29, 24), (15, 24), (8, 32)])
def test_matches_jax_and_conv_bfloat16(s, c):
    z, w2 = _inputs(2, s, c, seed=s + 1)
    zb = torch.from_numpy(z).bfloat16()
    got = tgc.growth_conv_matmul(zb, torch.from_numpy(w2))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert rel_l2(got, _jax(z, w2, jnp.bfloat16)) < BF16_TOL
    # the convolution of the same bfloat16 operands, in float32
    conv = F.conv2d(zb.float(), torch.from_numpy(w2).bfloat16().float(),
                    padding=1).numpy()
    assert rel_l2(got, conv) < BF16_TOL


def test_gradients_match_conv():
    z, w2 = _inputs(2, 15, 24, seed=3)
    grads = []
    for fn in (tgc.growth_conv_matmul,
               lambda a, b: F.conv2d(a, b, padding=1)):
        zt = torch.from_numpy(z).requires_grad_()
        wt = torch.from_numpy(w2).requires_grad_()
        fn(zt, wt).abs().sum().backward()
        grads.append((zt.grad.numpy(), wt.grad.numpy()))
    (gz, gw), (cz, cw) = grads
    assert rel_l2(gz, cz) < 1e-5 and rel_l2(gw, cw) < 1e-5


@pytest.mark.parametrize("mode", ["auto", "on", "on_all", "off"])
def test_routes_equal_jax(mode):
    """The routing takes the layers the JAX model's ``growth_routes``
    does: at the encoder's sizes under the mode as the JAX package
    resolves it off the TPU, at the decoders' S=8 under its decoders'
    dense block's own growth mode, the default "off"."""
    r = Routing(growth=mode)
    jmode = "off" if mode == "auto" else mode
    assert jdn.DenseBlock.__dataclass_fields__["growth"].default == "off"
    for s in (8, 15, 29, 57):
        for train in (False, True):
            assert r.growth_conv(s) == jgc.growth_routes(
                s, train, jmode if s in rt.ENCODER_SIZES else "off")
    assert r.growth == jmode


def _block_pair(train: bool):
    """An S=15 block with every 3x3 conv cuDNN's, and one with every 3x3
    conv the formulation's (the sandwich kernels take no layer of
    either: ``fused_dense="off"``), on the same weights."""
    torch.manual_seed(0)
    plain = tdn.DenseBlock(3, 32, 15, routing=Routing("off"))
    routed = tdn.DenseBlock(3, 32, 15, routing=Routing("off",
                                                       growth="on_all"))
    routed.load_state_dict(plain.state_dict())
    for block in (plain, routed):
        block.train(train)
        for m in block.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                g = torch.Generator().manual_seed(m.num_features)
                m.running_mean.normal_(0, 0.5, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    return plain, routed


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_dense_block_on_all_equals_default(train):
    """An S=15 encoder block with every layer's growth conv routed equals
    the default block with the same weights, forward (and in train mode
    the input's gradient and the running statistics), at 1e-5."""
    plain, routed = _block_pair(train)
    x = torch.randn(2, 32, 15, 15, generator=torch.Generator().manual_seed(1)
                    ).relu().contiguous(memory_format=torch.channels_last)
    outs = []
    for block in (plain, routed):
        xi = x.clone().requires_grad_(train)
        y = block(xi)
        if train:
            y.square().sum().backward()
        outs.append((y.detach(), xi.grad, block.state_dict()))
    (y0, g0, sd0), (y1, g1, sd1) = outs
    assert y0.shape == (2, 32 + 3 * 48, 15, 15)
    assert rel_l2(y1, y0) < 1e-5
    if train:
        assert rel_l2(g1, g0) < 1e-5
        for k in sd0:
            if "running" in k:
                assert rel_l2(sd1[k], sd0[k]) < 1e-5, k


def test_model_routes_the_encoders_s29_and_s15_layers(monkeypatch):
    """growth_matmul="on_all" routes the encoder layers the sandwich does
    not take (under fused_dense="off", the S=29 and S=15 blocks' 12 + 36
    layers and S=57's 6) and no decoder layer; the default routes none;
    the routed encoder's features equal the default's."""
    calls = []
    orig = tdn.growth_conv_matmul
    monkeypatch.setattr(tdn, "growth_conv_matmul",
                        lambda z, w: calls.append(z.shape[-1]) or orig(z, w))
    x = torch.from_numpy(np.random.default_rng(4).random(
        (1, 226, 226, 3), dtype=np.float32))
    feats = []
    for mode in ("auto", "on_all", "on"):
        torch.manual_seed(0)
        model = DepthEstimationNet(ModelConfig(
            growth_matmul=mode, fused_dense="off")).eval()
        with torch.no_grad():
            feats.append(model.encoder(x.permute(0, 3, 1, 2)))
        counts = {s: calls.count(s) for s in set(calls)}
        calls.clear()
        assert counts == ({57: 6, 29: 12, 15: 36} if mode == "on_all"
                          else {}), mode
    assert rel_l2(feats[1], feats[0]) < 1e-5
    assert torch.equal(feats[2], feats[0])


ENCODER_LAYERS = {57: 6, 29: 12, 15: 36}


@pytest.mark.parametrize("fused,dtype", [
    ("on_all", torch.float32), ("auto", torch.float32),
    ("auto", torch.bfloat16)], ids=["on_all-f32", "auto-f32", "auto-bf16"])
def test_sandwich_takes_precedence_over_growth_matmul(monkeypatch, fused,
                                                      dtype):
    """With both routings on (growth_matmul="on_all"), a layer the
    sandwich takes never reaches the growth formulation: in eval the
    formulation gets exactly the encoder layers ``Routing.fwd`` leaves out
    (none under "on_all"; under the bf16 default the S=15 block's 36),
    and the sandwich every other layer."""
    growth, sandwich = [], []
    orig_g, orig_s = tdn.growth_conv_matmul, tdn.dense_sandwich_packed
    monkeypatch.setattr(tdn, "growth_conv_matmul", lambda z, w: (
        growth.append(z.shape[-1]), orig_g(z, w))[1])
    monkeypatch.setattr(tdn, "dense_sandwich_packed", lambda x, *a: (
        sandwich.append(x.shape[1]), orig_s(x, *a))[1])
    x = torch.from_numpy(np.random.default_rng(4).random(
        (1, 226, 226, 3), dtype=np.float32))
    torch.manual_seed(0)
    model = DepthEstimationNet(ModelConfig(
        growth_matmul="on_all", fused_dense=fused)).eval()
    with torch.no_grad():
        model.encoder(x.permute(0, 3, 1, 2).to(dtype))
    want_g = {s: n for s, n in ENCODER_LAYERS.items()
              if not Routing(fused).fwd(s, False, dtype)}
    if fused == "on_all":
        assert want_g == {}
    if dtype == torch.bfloat16:
        assert want_g == {15: 36}
    assert {s: growth.count(s) for s in set(growth)} == want_g
    assert {s: sandwich.count(s) for s in set(sandwich)} == {
        s: n for s, n in ENCODER_LAYERS.items() if s not in want_g}
