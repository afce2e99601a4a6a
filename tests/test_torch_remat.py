"""``ModelConfig.remat`` in the port: each encoder dense layer run under
``torch.utils.checkpoint`` (the JAX ``nn.remat(DenseLayer)``), on the CPU.

A rematerialized block against the same block without remat, unrouted,
forward-routed and routed both ways, in both dtypes: the same outputs and
gradients and the running statistics updated once (bit for bit: the same
ops run again on the same inputs), the layers really run again, and a
routed layer's forward stages run once per step all the same; no
checkpoint where autograd records nothing; the config and the CLI
reaching the encoder's blocks and not the decoder's; and two gloo ranks
(``tests/_torch_dist.py``, job ``blocks``) whose backward runs outside
``core.mesh.active``, held against one process (remat blocks and the
flat block), with the group dropped from the recomputation as a planted
fault that must miss the bars (the flat block) or be refused by
``checkpoint`` (a rematerialized block).  The rematerialized block against the JAX
``DenseBlock(remat=True)`` is in ``test_torch_flat.py``
(``test_blocks_match_jax_dense_block``).  Blocks: ``tests/_torch_blocks.py``.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

import _torch_blocks as tb
from _torch_blocks import two_threads  # noqa: F401 (autouse fixture)
from _torch_parity import rel_l2
from md_rdm_tpu_torch.cli import train as cli_train
from md_rdm_tpu_torch.core.config import ModelConfig
from md_rdm_tpu_torch.kernels import dense_sandwich as ds
from md_rdm_tpu_torch.models import densenet as tdn
from md_rdm_tpu_torch.models.rdm import DepthEstimationNet
from md_rdm_tpu_torch.models.routing import Routing

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_dist  # noqa: E402

DTYPES = pytest.mark.parametrize("dtype", tb.DTYPES, ids=["f32", "bf16"])
FUSED = pytest.mark.parametrize("fused", ["off", "on_all", "on_all_bwd"])
STAGES = ("fwd_stages_reference", "dense_sandwich_reference",
          "bwd_recompute_reference", "bwd_dx_reference", "bwd_dw1_reference",
          "bwd_dw2_reference")


def _block(fused, remat):
    return tdn.DenseBlock(tb.LAYERS, tb.C0, tb.BN,
                          routing=Routing(fused, "off"), remat=remat)


@DTYPES
@FUSED
def test_remat_equals_the_block_without(dtype, fused):
    """Outputs, the input's and every parameter's gradient and the
    running statistics of a rematerialized block equal the block's without
    remat bit for bit; the statistics moved, once."""
    state = tb.port_state(1)
    x, cot = tb.x_cot(dtype, seed=2)
    got = tb.run(_block(fused, True), state, x, cot, dtype)
    want = tb.run(_block(fused, False), state, x, cot, dtype)
    np.testing.assert_array_equal(got["out"], want["out"])
    np.testing.assert_array_equal(got["dx"], want["dx"])
    for k, v in want["grads"].items():
        assert torch.equal(got["grads"][k], v), k
    for k, v in want["state"].items():
        assert torch.equal(got["state"][k], v), k
        if "running" in k:
            assert not torch.equal(v, state[k]), k


def _count(monkeypatch, module, names):
    calls = {n: 0 for n in names}
    for name in names:
        fn = getattr(module, name)

        def counted(*a, _n=name, _f=fn, **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(module, name, counted)
    return calls


@FUSED
def test_remat_runs_the_layers_again_but_no_forward_stage(monkeypatch,
                                                          fused):
    """With remat each layer's norm1 runs twice a step (the forward and
    the backward's recomputation), and yet each sandwich stage (forward
    and backward, kernels' plain versions on the CPU) runs as often as
    without: a routed layer's recomputation launches no forward kernel."""
    stages = _count(monkeypatch, ds, STAGES)
    norms = _count(monkeypatch, tdn, ("batch_norm",))
    state = tb.port_state()
    x, cot = tb.x_cot(torch.float32)
    seen = {}
    for remat in (False, True):
        tb.run(_block(fused, remat), state, x, cot, torch.float32)
        seen[remat] = (dict(stages), dict(norms))
        for calls in (stages, norms):
            calls.update({k: 0 for k in calls})
    assert seen[True][0] == seen[False][0]
    n = tb.LAYERS if fused != "off" else 0
    assert seen[False][0] == {
        "fwd_stages_reference": n,
        "dense_sandwich_reference": n if fused == "on_all" else 0,
        **{k: n if fused == "on_all_bwd" else 0 for k in STAGES[2:]}}
    # norm1 (and, unrouted, norm2) once more per layer
    per_layer = 1 if fused != "off" else 2
    assert seen[True][1]["batch_norm"] == (
        seen[False][1]["batch_norm"] + per_layer * tb.LAYERS)


def test_no_checkpoint_where_autograd_records_nothing(monkeypatch):
    calls = _count(monkeypatch, tdn, ("checkpoint",))
    block = _block("on_all_bwd", True)
    x = torch.zeros(1, tb.C0, tb.S, tb.S)
    with torch.no_grad():
        block.train()(x)
        block.eval()(x)
    assert calls["checkpoint"] == 0
    block.train()(x.requires_grad_())
    assert calls["checkpoint"] == tb.LAYERS


@pytest.mark.parametrize("remat", [True, False])
def test_model_config_reaches_the_encoder_blocks(remat):
    """``ModelConfig.remat`` (default True, as in the JAX package) reaches
    the three encoder blocks; the decoder's block has no remat, as in
    JAX (``md_rdm_tpu/models/decoder.py``)."""
    assert ModelConfig().remat is True
    model = DepthEstimationNet(ModelConfig(remat=remat))
    assert [b.remat for b in (model.encoder.dense_e2, model.encoder.dense_e3,
                              model.encoder.dense_e4)] == [remat] * 3
    assert model.d_1.dense_layer.remat is False


def test_cli_no_remat_reaches_the_model():
    from md_rdm_tpu_torch.training.module import DepthTrainer
    args = cli_train.build_parser().parse_args(
        ["--dataset", "synthetic", "--no_remat", "--device", "cpu"])
    config = cli_train.build_config(args)
    assert config.model.remat is False
    model = DepthTrainer(config, device="cpu").init(seed=0).model
    assert not any(m.remat for m in model.encoder.modules()
                   if isinstance(m, tdn.DenseBlock))


# ---- data-parallel: two gloo ranks --------------------------------------------

ROWS = 4
THREADS = 2
TOL = {"out": 1e-5, "grads": 1e-3, "stats": 1e-5}


def _one_process(name, case):
    """The block without remat or flat layout (the plain routed or
    unrouted block), in one process on every row."""
    fused = "off" if name == "remat_off" else "on_all_bwd"
    block = _block(fused, False)
    block.load_state_dict(case["state"], strict=True)
    block.train()
    x = case["x"].clone().requires_grad_()
    y = block(x.permute(0, 3, 1, 2))
    (y * case["cot"].permute(0, 3, 1, 2)).sum().backward()
    return {"out": y.detach().permute(0, 2, 3, 1), "dx": x.grad,
            "grads": {n: p.grad for n, p in block.named_parameters()},
            "state": block.state_dict()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("remat_dist")
    rng = np.random.default_rng(9)
    state = tb.port_state(3)
    inputs = {name: {
        "state": state,
        "x": torch.from_numpy(rng.standard_normal(
            (ROWS, tb.S, tb.S, tb.C0)).astype(np.float32)),
        "cot": torch.from_numpy(rng.standard_normal(
            (ROWS, tb.S, tb.S, tb.C_FINAL)).astype(np.float32))}
        for name in _torch_dist.BLOCKS}
    torch.save(inputs, out / "blocks_in.pt")
    ctx = tmp.start_processes(
        _torch_dist.worker, nprocs=_torch_dist.WORLD, join=False,
        start_method="spawn",
        args=(str(out / "rendezvous"), str(out), ("blocks",), THREADS))
    try:
        saved = torch.get_num_threads()
        torch.set_num_threads(THREADS)
        ref = {name: _one_process(name, inputs[name]) for name in inputs}
        torch.set_num_threads(saved)
    finally:
        while not ctx.join(timeout=600):
            pass
    got = [torch.load(out / f"rank{r}.pt", weights_only=False)["blocks"]
           for r in range(_torch_dist.WORLD)]
    return got, ref


def _errors(got, want):
    return {"out": rel_l2(torch.cat([g["out"] for g in got]), want["out"]),
            "dx": rel_l2(torch.cat([g["dx"] for g in got]), want["dx"]),
            "grads": max(rel_l2(got[0]["grads"][k], w)
                         for k, w in want["grads"].items()),
            "stats": max(rel_l2(g["state"][k], w) for g in got
                         for k, w in want["state"].items()
                         if "running" in k)}


@pytest.mark.parametrize("name", sorted(_torch_dist.BLOCKS))
def test_two_ranks_equal_one_process(ranks, name):
    """Each block on 2 ranks of 2 rows, its backward outside
    ``core.mesh.active``, against the plain block on the 4 rows in one
    process: outputs and input gradients (rows concatenated), parameter
    gradients (summed over the ranks, equal on both) and the running
    statistics (updated once, with the global batch's statistics)."""
    got, ref = ranks
    rows = [g[(name, False)] for g in got]
    err = _errors(rows, ref[name])
    for k, tol in TOL.items():
        assert err[k] < tol, err
    assert err["dx"] < TOL["grads"], err
    for k in ref[name]["grads"]:
        assert torch.equal(rows[0]["grads"][k], rows[1]["grads"][k]), k


@pytest.mark.parametrize("name", ["flat", "remat_routed", "remat_off"])
def test_recompute_without_the_group_misses_the_bar(ranks, name):
    """The bar has teeth: a recomputation that takes each rank's rows
    alone (the forward's group not kept) moves the flat block's gradients
    past it while its outputs and statistics stay right; in a
    rematerialized block it runs other ops than the forward did (no
    collective), which ``checkpoint`` refuses on every rank."""
    got, ref = ranks
    rows = [g[(name, True)] for g in got]
    if name != "flat":
        for r in rows:
            assert r.keys() == {"error"}
            assert "CheckpointError" in r["error"], r["error"]
        return
    err = _errors(rows, ref[name])
    assert err["out"] < TOL["out"] and err["stats"] < TOL["stats"], err
    assert err["grads"] > 10 * TOL["grads"], err
