"""The optimal decoder set (1, 6, 7, 8, 9) against the benchmark's plain
reference held to the port's own ALS iterates, on the CPU at batch 2,
and the port's records of its relative tail.

The port's forward on seeded weights and the reference
(``port_bench/reference/held.py``) held to the iterates the port kept
and run on the quantized matrices the port kept (``core/trace.py``):
equal decodes, and the quantized entries off, the final map's gap and
the choice's RMSE gap ten times under the limits of the benchmark's cell
``optimal.serve_b16``; the cell's faults (``port_bench/lib/
plants_relative.py``) one page left at its starting fill, every choice
forced to iterate 1 and one edge of kernel B4's table moved read above
them.  The kept read against ``snapshot()``; on the CPU no device span
and no error; the live model's forward enters no device span and moves
no counter.
"""
import json

import numpy as np
import pytest
import torch

from md_rdm_tpu_torch.core import trace
from md_rdm_tpu_torch.core.config import ModelConfig
from md_rdm_tpu_torch.inference import Predictor
from md_rdm_tpu_torch.ops.decompose import recombination
from port_bench.drivers.serve_held import (by_decoder, kept_names,
                                           quantized_by_decoder,
                                           quantized_names)
from port_bench.lib import synthetic
from port_bench.lib.compare import serve_numbers
from port_bench.lib.plants_relative import planted
from port_bench.lib.spec import BENCH_DIR
from port_bench.lib.weights import seeded_state_dict
from port_bench.reference.decompose import recombination as ref_recombination
from port_bench.reference.held import HeldModel

SEED = 2 ** 31 + 7
LIMITS = json.loads((BENCH_DIR / "limits" / "optimal.serve_b16.json")
                    .read_text())


def _fields(name):
    return json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())[
        "model"]


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    trace.reset()
    yield
    trace.reset()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def optimal():
    """The port's model and encoder features, the reference's heads, on
    one seeded batch of 2."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    f = _fields("optimal")
    sd = seeded_state_dict(f, SEED, "cpu")
    x = synthetic.images(synthetic.generator(SEED, "cpu", 0), 2, "cpu")
    model = Predictor(sd, ModelConfig.from_dict(f), device="cpu").model
    ref = HeldModel(f)
    ref.load_state_dict(sd)
    ref.eval()
    with torch.no_grad():
        feats = model.encoder(x.permute(0, 3, 1, 2))
        heads = ref.heads(x)
    torch.set_num_threads(n)
    return f["decoder_ids"], model, feats, ref, heads


def _port(model, feats):
    """The rest of the port's forward, as ``Predictor`` serves it."""
    with torch.no_grad():
        maps, decode, _ = model.decoder_maps(feats)
        return recombination(list(model.fuse(maps))), decode


def _numbers(optimal, final, decode):
    """``drivers/serve_held.py``'s check of one call."""
    ids, _, _, ref, heads = optimal
    kept = {n: trace.kept(n) for n in kept_names(ids) + quantized_names(ids)}
    with torch.no_grad():
        (yhat, rd, _, rp), fills = ref.held(
            heads, by_decoder(ids, kept),
            quantized_by_decoder(ids, kept, final.shape[0]))
    out = serve_numbers(list(final.numpy()), list(decode.numpy()),
                        list(ref_recombination(list(yhat)).numpy()),
                        list(rd.numpy()), list(rp.numpy()))
    out["quantize_flips"] = sum(f.flips for f in fills.values())
    out["choice_gap"] = max(g for f in fills.values() for g in f.gaps)
    return out


def test_the_port_against_the_held_reference(optimal):
    _, model, feats, _, _ = optimal
    final, decode = _port(model, feats)
    got = _numbers(optimal, final, decode)
    assert got["decode_flips"] == 0 and got["near_flips"] == 0
    assert got["map_left_out"] == 0
    for number in ("quantize_flips", "map_gap", "choice_gap"):
        assert got[number] * 10 < LIMITS[number], (number, got)


@pytest.mark.parametrize("fault,number", [("one_page", "map_gap"),
                                          ("first_iterate", "choice_gap"),
                                          ("one_edge", "quantize_flips")])
def test_a_fault_reads_above_the_limit(optimal, fault, number):
    _, model, feats, _, _ = optimal
    with planted(fault):
        final, decode = _port(model, feats)
    got = _numbers(optimal, final, decode)
    assert got[number] > LIMITS[number], got


def test_the_kept_read_and_the_relative_records(optimal):
    """``trace.kept`` against ``snapshot()["kept"]``, which leaves the
    quantized matrices out; the relative tail's counters of one forward,
    and its WSM stages' (decoders 7-9 run 1 + 2 + 3 stages as products,
    decoder 9's third-stage 5x5 as tap products); no device span on the
    CPU."""
    ids, model, feats, _, _ = optimal
    stages = {}
    with torch.no_grad():
        model.decoder_maps(feats, stages)
    snap = trace.snapshot()
    names = kept_names(ids)
    assert names == ["als.quadratic.d6.best_iter", "als.pages.best_iter"]
    assert {n: trace.kept(n).tolist() for n in names} == snap["kept"]
    assert len(snap["kept"]["als.pages.best_iter"]) == 1 + 4 + 16
    assert quantized_names(ids) == ["als.quadratic.d6.sparse",
                                    "als.pages.sparse"]
    assert torch.equal(trace.kept("als.quadratic.d6.sparse"),
                       stages["sparse_6"])
    assert torch.equal(trace.kept("als.pages.sparse"), torch.cat(
        [stages[f"sparse_{d}"] for d in (7, 8, 9)]))
    assert trace.kept("als.pages.sparse").shape == (2 * 21, 256, 64)
    assert trace.kept("als.quadratic.d7.best_iter") is None
    assert snap["counters"] == {"relative.tails": 1,
                                "relative.pages": 2 * (1 + 4 + 16),
                                "relative.als_steps": 30 + 100,
                                "wsm.gemm": 1 + 2 + 3, "wsm.gemm.kxk": 1}
    assert not any(n.startswith("relative.") for n in snap["spans"])
    assert trace.read_device() == {}


def test_live_enters_no_device_span(monkeypatch):
    """The live model's forward (decoder 1 alone) enters no device span
    and moves no counter on the CPU, where the kernel wrappers count
    nothing: its captured graph gains no node."""
    entered = []
    span = trace.device_span

    def seen(name, device):
        entered.append(name)
        return span(name, device)

    monkeypatch.setattr(trace, "device_span", seen)
    f = _fields("live")
    pred = Predictor(seeded_state_dict(f, SEED, "cpu"),
                     ModelConfig.from_dict(f), device="cpu")
    x = synthetic.images(synthetic.generator(SEED, "cpu", 0), 1, "cpu")
    final, decode = pred(x.numpy())
    assert np.isfinite(final).all() and decode.shape == (1, 1, 8, 8)
    snap = trace.snapshot()
    assert entered == [] and snap["counters"] == {} and snap["kept"] == {}
    assert not any(n.startswith("relative.") for n in snap["spans"])


def test_device_spans_record_only_on_the_card():
    """On the CPU a device span times nothing, and the read has nothing
    to add."""
    with trace.device_span("relative.als", torch.device("cpu")):
        torch.ones(3).sum()
    assert trace.read_device() == {}
    assert trace.snapshot()["spans"] == {}
