"""Port's encoder building blocks against the JAX package's, eval mode,
with randomized BatchNorm statistics.  JAX weights reach the port through
``from_jax_variables``.  Bar: relL2 < 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import nhwc_to_torch, randomize_norms, rel_l2, \
    torch_to_nhwc
from md_rdm_tpu.models import densenet as jdn
from md_rdm_tpu_torch.core.config import ModelConfig
from md_rdm_tpu_torch.kernels import dense_sandwich as ds
from md_rdm_tpu_torch.models import densenet as tdn
from md_rdm_tpu_torch.models.routing import Routing
from md_rdm_tpu_torch.weights import from_jax_variables

TOL = 1e-4


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pair(jax_module, torch_module, x, seed=1):
    """Init the JAX module, randomize its norms, load the port's module,
    run both in eval on ``x`` (NHWC numpy); returns (port, jax) NHWC."""
    v = jax_module.init(jax.random.PRNGKey(seed), jnp.asarray(x), False)
    v = randomize_norms(v, seed)
    torch_module.load_state_dict(
        from_jax_variables(v["params"], v["batch_stats"]), strict=True)
    want = np.asarray(jax_module.apply(v, jnp.asarray(x), False))
    with torch.no_grad():
        got = torch_to_nhwc(torch_module.eval()(nhwc_to_torch(x)))
    return got, want


@pytest.mark.parametrize("s,c_in,bn,fused", [
    (57, 96, 57, "off"),        # routed to the sandwich in the port
    (57, 144, 57, "interpret"),  # ... against the JAX TPU kernel path
    (15, 96, 15, "off"),         # routed too (eval, float32), against
    (29, 192, 29, "off"),        # JAX's unrouted layer
])
def test_dense_layer(s, c_in, bn, fused):
    b = 1 if s == 57 else 2
    x = _x((b, s, s, c_in), seed=s)
    got, want = _pair(jdn.DenseLayer(bn, 48, fused=fused),
                      tdn.DenseLayer(c_in, bn), x)
    assert got.shape == (b, s, s, 48)
    assert rel_l2(got, want) < TOL


@pytest.mark.parametrize("mode", ["auto", "on", "on_all", "on_all_bwd",
                                  "interpret", "off"])
def test_routing_follows_the_eval_table(mode):
    """Each eval layer at S = 57/29/15 goes through the sandwich (norm2
    folded) exactly when the routing of ``fused_dense=mode`` says so.  On
    CPU tensors the wrapper runs its plain version."""
    calls = []
    orig = tdn.dense_sandwich_packed
    tdn.dense_sandwich_packed = (
        lambda *a: calls.append(a[0].shape) or orig(*a))
    routing = Routing.of(ModelConfig(fused_dense=mode))
    try:
        with torch.no_grad():
            for s, bn in ((57, 57), (29, 29), (15, 15)):
                layer = tdn.DenseLayer(96, bn, routing=routing).eval()
                layer(torch.zeros(1, 96, s, s))
    finally:
        tdn.dense_sandwich_packed = orig
    assert calls == [(1, s, s, 96) for s in (57, 29, 15)
                     if routing.fwd(s, False, torch.float32)]


def test_sandwich_weights_kept_until_a_weight_changes():
    """The routed layer's layout holds the weights of the call that made it:
    the same values while nothing changes, the new ones after an in-place
    change, a load or a change of dtype (a layout made at each call, so
    none is ever stale, and a captured forward lays out the weights of
    its replay), and one that carries gradients under autograd."""
    layer = tdn.DenseLayer(96, 15).eval()

    def fresh(dt):
        n = layer.norm2
        return ds.pack_weights(layer.conv1.weight,
                               *tdn.fold(n, n.running_mean, n.running_var),
                               layer.conv2.weight, dt)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    with torch.no_grad():
        first = layer.sandwich_weights(torch.float32)
        assert same(layer.sandwich_weights(torch.float32), first)
        assert same(first, fresh(torch.float32))
        layer.norm2.running_var.fill_(4.0)
        scaled = layer.sandwich_weights(torch.float32)
        assert not same(scaled, first) and same(scaled, fresh(torch.float32))
        assert torch.allclose(scaled.scale, first.scale / 2)
        layer.load_state_dict(tdn.DenseLayer(96, 15).state_dict())
        loaded = layer.sandwich_weights(torch.float32)
        assert not same(loaded, scaled)
        assert torch.equal(loaded.w1t, layer.conv1.weight[:, :, 0, 0].t())
        bf = layer.sandwich_weights(torch.bfloat16)
        assert bf.w1t.dtype == torch.bfloat16 and same(bf,
                                                       fresh(torch.bfloat16))
    grad = layer.sandwich_weights(torch.float32)
    assert same(grad, loaded)
    assert grad.scale.requires_grad


@pytest.mark.parametrize("s,bn", [(57, 57), (15, 15)])
def test_dense_block_two_layers(s, bn):
    x = _x((1, s, s, 96), seed=bn + 1)
    got, want = _pair(jdn.DenseBlock(2, bn, 48), tdn.DenseBlock(2, 96, bn), x)
    assert got.shape == (1, s, s, 96 + 2 * 48)
    assert rel_l2(got, want) < TOL


def test_transition():
    x = _x((2, 16, 16, 96), seed=3)
    got, want = _pair(jdn.Transition(48), tdn.Transition(96, 48), x)
    assert got.shape == (2, 8, 8, 48)
    assert rel_l2(got, want) < TOL


def test_pad_br():
    x = _x((2, 7, 7, 5), seed=4)
    got = torch_to_nhwc(tdn.pad_br(nhwc_to_torch(x)))
    np.testing.assert_array_equal(got, np.asarray(jdn.pad_br(jnp.asarray(x))))


def test_dense_block_keeps_channels_last():
    """The S=57 kernel reads the concat stack as NHWC without a copy."""
    block = tdn.DenseBlock(2, 96, 15).eval()
    x = torch.zeros(1, 96, 15, 15).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        y = block(x)
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert y.permute(0, 2, 3, 1).is_contiguous()
