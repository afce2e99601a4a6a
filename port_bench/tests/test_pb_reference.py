"""The plain reference against md_rdm_tpu_torch on the CPU at batch 1:
the served forward of both configurations, and one train step of live
(batch 2) with its BatchNorm running statistics."""
import json

import numpy as np
import pytest
import torch

from port_bench.lib import synthetic
from port_bench.lib.spec import BENCH_DIR
from port_bench.lib.weights import seeded_state_dict
from port_bench.reference.decompose import recombination
from port_bench.reference.model import ReferenceModel
from port_bench.reference.train import (LOG_NAMES, make_optimizer,
                                        train_step)

SEED = 2 ** 31 + 101


def fields(config):
    return json.loads((BENCH_DIR / "configs" / f"{config}.json").read_text())


@pytest.mark.parametrize("config", ["live", "optimal"])
def test_forward_against_the_port(config):
    from md_rdm_tpu_torch.core.config import ModelConfig
    from md_rdm_tpu_torch.inference import Predictor
    f = fields(config)["model"]
    sd = seeded_state_dict(f, SEED, "cpu")
    x = synthetic.images(synthetic.generator(SEED, "cpu", 0), 1, "cpu")
    port = Predictor(sd, ModelConfig.from_dict(f), device="cpu")
    got, got_decode = port(x.numpy())
    ref = ReferenceModel(f)
    ref.load_state_dict(sd)
    with torch.no_grad():
        yhat, decode, _, _ = ref.eval()(x)
        want = recombination(list(yhat)).numpy()
    assert np.isfinite(want).all()
    np.testing.assert_array_equal(got_decode, decode.numpy())
    # the optimal set's quantization and ALS see last-bit differences of
    # the port's grouped loop (the port's own bar for the final map: 1e-3)
    tol = 1e-6 if config == "live" else 1e-3
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < tol


def test_train_step_against_the_port():
    from md_rdm_tpu_torch.core.config import Config, ModelConfig
    from md_rdm_tpu_torch.training.module import DepthTrainer
    f = fields("live")
    sd = seeded_state_dict(f["model"], SEED, "cpu")
    x = synthetic.images(synthetic.generator(SEED, "cpu", 0), 2, "cpu")
    y = synthetic.depths(synthetic.generator(SEED, "cpu", 1), 2, "cpu")
    trainer = DepthTrainer(Config(model=ModelConfig.from_dict(f["model"])),
                           device="cpu")
    state = trainer.init(weights=sd)
    _, logs = trainer.train_step(state, x, y)
    ref = ReferenceModel(f["model"])
    ref.load_state_dict(sd)
    opt = make_optimizer(ref, f["train"])
    want = train_step(ref, opt, x, y)
    for name in LOG_NAMES:
        assert float(logs[name]) == pytest.approx(want[name], rel=1e-5)
    port = dict(state.model.named_parameters())
    for name, p in ref.named_parameters():
        if p.numel():
            step = port[name].detach() - sd[name]
            want_step = p.detach() - sd[name]
            # Adam's first step is lr * sign(g) where |g| >> eps: the
            # steps agree except where a gradient is rounding noise
            agree = (torch.sign(step) == torch.sign(want_step)).float()
            assert agree.mean() > 0.95, name
    port_buffers = dict(state.model.named_buffers())
    for name, b in ref.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(port_buffers[name], b, rtol=1e-4,
                                       atol=1e-5, msg=name)
