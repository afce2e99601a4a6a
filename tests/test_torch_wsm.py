"""The port's WSM layer and cascade against flax, with random
non-symmetric kernels (a transposed-conv kernel loaded without its spatial
flip keeps its shape and gives wrong maps), and the weight mapping both
ways."""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import nhwc_to_torch, rel_l2, torch_to_nhwc
from md_rdm_tpu.models import wsm as jwsm
from md_rdm_tpu_torch.core import trace
from md_rdm_tpu_torch.models import wsm as twsm
from md_rdm_tpu_torch.weights import from_jax_variables, to_jax_variables

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
from torch_replica import TorchWSMLayer  # noqa: E402

BAR = 1e-5


def _random_params(params, seed):
    """Every leaf replaced by seeded normals: kernels at 1/sqrt(fan_in),
    biases N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v)
            elif k == "kernel":
                fan_in = int(np.prod(v.shape[:-1]))
                out[k] = (rng.standard_normal(v.shape)
                          / np.sqrt(fan_in)).astype(np.float32)
            else:
                out[k] = (0.1 * rng.standard_normal(v.shape)).astype(
                    np.float32)
        return out

    return walk(params)


def _stage_args(stage):
    """(c, strip, raw, spatial) of a cascade stage at full width."""
    c, strip = twsm.WSM_STAGES[stage - 1]
    raw = twsm.FIRST_STAGE_INPUT if stage == 1 else 2 * c
    return c, strip, raw, strip // 2


def _layer_pair(c, strip, raw, x, seed):
    """The flax stage with seeded random parameters, and the port's stage
    loaded with them."""
    jmod = jwsm.WSMLayer(c, strip)
    params = _random_params(
        jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], seed)
    tmod = twsm.WSMLayer(c, strip, raw)
    tmod.load_state_dict(from_jax_variables(params, {}), strict=True)
    return jmod, params, tmod


@pytest.mark.parametrize("c,strip,raw,spatial,batch", [
    (32, 16, 64, 8, 1),          # narrow
    (1664, 16, 2208, 8, 1),      # the first stage at full width
] + [_stage_args(stage) + (2,) for stage in (1, 2, 3, 4)])
def test_wsm_layer(c, strip, raw, spatial, batch):
    x = np.random.default_rng(c).standard_normal(
        (batch, spatial, spatial, raw)).astype(np.float32)
    jmod, params, tmod = _layer_pair(c, strip, raw, x, c + 1)
    k = params["deconv1"]["kernel"]
    assert not np.allclose(k, k[::-1, ::-1])
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod(nhwc_to_torch(x))
    assert tuple(got.shape) == (batch, c, 2 * spatial, 2 * spatial)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert rel_l2(torch_to_nhwc(got), want) < BAR


@pytest.mark.parametrize("c,strip,raw,spatial", [
    (32, 16, 64, 8),             # narrow
    _stage_args(1),              # the first stage at full width
])
def test_wsm_layer_grad(c, strip, raw, spatial):
    """A scalar loss's gradients through the port's products (autograd)
    against jax.grad through the flax stage: the input's and every
    parameter's, the latter mapped as the weights are."""
    rng = np.random.default_rng(c + 2)
    x = rng.standard_normal((2, spatial, spatial, raw)).astype(np.float32)
    r = rng.standard_normal((2, 2 * spatial, 2 * spatial, c)).astype(
        np.float32)
    jmod, params, tmod = _layer_pair(c, strip, raw, x, c + 3)

    def loss(p, xin):
        return jnp.sum(jmod.apply({"params": p}, xin) * r)

    want_p, want_x = jax.grad(loss, (0, 1))(params, jnp.asarray(x))
    xt = nhwc_to_torch(x).requires_grad_(True)
    (tmod(xt) * nhwc_to_torch(r)).sum().backward()
    assert rel_l2(torch_to_nhwc(xt.grad), np.asarray(want_x)) < BAR
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, want_p), {})
    got = {k: v.grad for k, v in tmod.named_parameters()}
    assert set(got) == set(want)
    for name in want:
        assert rel_l2(got[name].numpy(), want[name].numpy()) < BAR, name


def test_cascade_counts_products():
    """Every stage of a 3-stage cascade runs as products: 3 wsm.gemm; of
    its 3x3 and 5x5 convolutions the shapes of TAP_SHAPES (the third
    stage's 5x5) run as tap products: 1 wsm.gemm.kxk."""
    tmod = twsm.WSMCascade(3)
    x = torch.zeros(1, twsm.FIRST_STAGE_INPUT, 8, 8).contiguous(
        memory_format=torch.channels_last)
    names = ("wsm.gemm", "wsm.gemm.kxk")
    before = trace.snapshot()["counters"]
    with torch.no_grad():
        out = tmod(x)
    after = trace.snapshot()["counters"]
    assert tuple(out.shape) == (1, 416, 64, 64)
    assert twsm.TAP_SHAPES == {(5, 104, 64)}
    assert [after.get(k, 0) - before.get(k, 0) for k in names] == [3, 1]


def test_cascade_two_stages():
    """Stages chain with the reference's channel ladder (2208 -> 1664 ->
    832) and module names WSM_1, WSM_2."""
    x = np.random.default_rng(3).standard_normal((1, 8, 8, 2208)).astype(
        np.float32)
    jmod = jwsm.WSMCascade(2)
    params = _random_params(
        jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"], 4)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = twsm.WSMCascade(2)
    tmod.load_state_dict(from_jax_variables(params, {}), strict=True)
    with torch.no_grad():
        got = tmod(nhwc_to_torch(x))
    assert tuple(got.shape) == (1, 832, 32, 32)
    assert rel_l2(torch_to_nhwc(got), want) < BAR
    assert len(twsm.WSMCascade(0)) == 0


@pytest.mark.parametrize("stage", [1, 2])
def test_keys_equal_reference(stage):
    ch, size = twsm.WSM_STAGES[stage - 1]
    raw = twsm.FIRST_STAGE_INPUT if stage == 1 else 2 * ch
    got = twsm.WSMLayer(ch, size, raw).state_dict()
    ref = TorchWSMLayer(ch, size, stage).state_dict()
    assert list(got) == list(ref)
    assert all(got[k].shape == ref[k].shape for k in ref)


def test_weight_mapping_round_trip():
    """to_jax_variables inverts from_jax_variables on WSM leaves, both
    ways, the flipped transposed-conv kernel included."""
    jmod = jwsm.WSMLayer(32, 16)
    params = _random_params(jmod.init(
        jax.random.PRNGKey(2), jnp.zeros((1, 8, 8, 64)))["params"], 7)
    tree = {"d_7": {"wsm_block": {"WSM_1": params}}}
    sd = from_jax_variables(tree, {})
    assert "d_7.wsm_block.WSM_1.deconv1.0.weight" in sd
    assert "d_7.wsm_block.WSM_1.wsm_wx3.1.weight" in sd
    back = to_jax_variables(sd)["params"]
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    want = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=str(key))
    again = from_jax_variables(back, {})
    assert list(again) == list(sd)
    for name in sd:
        assert torch.equal(again[name], sd[name]), name
    # the torch weight is the flax kernel flipped: (in, out, kh, kw)
    w = sd["d_7.wsm_block.WSM_1.deconv1.0.weight"].numpy()
    np.testing.assert_array_equal(
        w, params["deconv1"]["kernel"][::-1, ::-1].transpose(2, 3, 0, 1))
