"""The whole encoder with every dense layer routed (``fused_dense=
"on_all_bwd"``) against the JAX encoder with ``fused="interpret"`` (its
TPU kernels interpreted at all 54 layers), float32, batch 1, on the CPU.

Weights are made in the port (``init_parameters``, randomized BatchNorm)
and sent to JAX by ``to_jax_variables``.  The JAX side jits one eval
forward and one train-mode value_and_grad of the interpreted kernels,
about 1.5 min together, so this module stays in the slow tier.

Bars: eval and train features 1e-4 relL2, updated running statistics
1e-4 per tensor.  The input gradient and the parameters' gradients (held
together) are ill-conditioned through 54 train-mode layers at init, as
the whole model's are (``test_torch_train.py``): the port's own move by
~1% relL2 between one and the default number of CPU threads, so they are
held to five times that measured floor, never looser than 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import nhwc_to_torch, rel_l2, torch_to_nhwc
from md_rdm_tpu.models import densenet as jdn
from md_rdm_tpu_torch.models import densenet as tdn
from md_rdm_tpu_torch.models.rdm import init_parameters, randomize_batchnorm
from md_rdm_tpu_torch.models.routing import Routing
from md_rdm_tpu_torch.weights import to_jax_variables

FLOOR_FACTOR = 5


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float32)


@pytest.fixture(scope="module")
def pair():
    enc = tdn.Encoder(Routing("on_all_bwd", "off"))
    init_parameters(enc, 0)
    randomize_batchnorm(enc, 1)
    sd = {k: v.clone() for k, v in enc.state_dict().items()}
    v = jax.tree_util.tree_map(jnp.asarray, to_jax_variables(sd))
    rng = np.random.default_rng(2)
    x = rng.random((1, 226, 226, 3), dtype=np.float32)
    cot = rng.standard_normal((1, 8, 8, 1056)).astype(np.float32)
    jenc = jdn.Encoder(fused="interpret")
    want_eval = np.asarray(jax.jit(lambda v, x: jenc.apply(v, x, False))(
        v, jnp.asarray(x)))

    def f(params, xj):
        out, upd = jenc.apply({"params": params,
                               "batch_stats": v["batch_stats"]}, xj, True,
                              mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, upd["batch_stats"])

    (_, (out, stats)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(v["params"], jnp.asarray(x))
    with torch.no_grad():
        got_eval = torch_to_nhwc(enc.eval()(nhwc_to_torch(x)))

    def train(threads):
        """The port's train-mode pass from ``sd`` at ``threads`` threads:
        output, dx, gradients, updated statistics."""
        saved = torch.get_num_threads()
        torch.set_num_threads(threads)
        enc.load_state_dict(sd)
        enc.zero_grad(set_to_none=True)
        xt = torch.from_numpy(x).requires_grad_()
        y = enc.train()(xt.permute(0, 3, 1, 2))
        (y * nhwc_to_torch(cot)).sum().backward()
        torch.set_num_threads(saved)
        grads = to_jax_variables({n: p.grad for n, p in
                                  enc.named_parameters()})["params"]
        stats = to_jax_variables(enc.state_dict())["batch_stats"]
        return (torch_to_nhwc(y), xt.grad.numpy(),
                _flat(dict(_leaves(grads))), dict(_leaves(stats)))

    one = train(1)
    y, dx, grads, port_stats = train(torch.get_num_threads())
    want_grads = dict(_leaves(gp))
    return {"eval": (got_eval, want_eval),
            "train": (y, np.asarray(out)),
            "dx": (dx, np.asarray(gx)), "dx_floor": rel_l2(one[1], dx),
            "grads": (grads, _flat(want_grads)),
            "grads_floor": rel_l2(one[2], grads),
            "stats": (port_stats, dict(_leaves(stats)))}


def _flat(leaves):
    return np.concatenate([leaves[k].ravel() for k in sorted(leaves)])


def test_encoder_eval_matches_jax_interpret(pair):
    got, want = pair["eval"]
    assert got.shape == (1, 8, 8, 1056)
    assert rel_l2(got, want) < 1e-4


def test_encoder_train_matches_jax_interpret(pair):
    assert rel_l2(*pair["train"]) < 1e-4
    got, want = pair["stats"]
    assert set(got) == set(want)
    for k in want:
        assert rel_l2(got[k], want[k]) < 1e-4, k
    for k in ("dx", "grads"):
        bar = max(1e-3, FLOOR_FACTOR * pair[f"{k}_floor"])
        assert rel_l2(*pair[k]) < bar, (k, pair[f"{k}_floor"])
