"""``split_share`` (``metrics/split_share.py``): the share of F1 and F2
launches that split K, from the program's counters; nothing where the
program counts no split (a program older than the split, or without the
registry)."""
import sys

import pytest

from port_bench.lib import spec
from md_rdm_tpu_torch.core import trace


@pytest.fixture(autouse=True)
def empty_registry():
    trace.reset()
    yield
    trace.reset()


def _read():
    return spec.reader("split_share.serve")(None)


def test_in_the_benchmark_for_every_cell():
    bench = spec.load_benchmark()
    metrics = {m["name"]: m for m in bench["per_layer"]}
    for part, cell, moves in (("serve", "live.serve_b16", "serve_img_per_s"),
                              ("frame", "live.frame_b1", "frame_p95_ms"),
                              ("train", "live.train_b16", "train_img_per_s")):
        m = metrics[f"split_share.{part}"]
        assert (m["workloads"], m["moves"], m["source"], m["unit"]) == (
            [cell], moves, "program_counter", "%")
        assert m["layer"] == metrics["dense_fwd_roofline.serve"]["layer"]


def test_launches_without_split_counters_read_none():
    """A program older than the split counts launches alone."""
    trace.count("kernel.fwd_expand.launches", 54)
    trace.count("kernel.fwd_taps.launches", 54)
    assert _read() is None


def test_nothing_recorded_reads_none():
    assert _read() is None


def test_a_program_without_the_registry_reads_none(monkeypatch):
    import md_rdm_tpu_torch.core
    monkeypatch.setitem(sys.modules, "md_rdm_tpu_torch.core.trace", None)
    monkeypatch.delattr(md_rdm_tpu_torch.core, "trace")
    trace.count("kernel.fwd_expand.launches", 2)
    trace.count("kernel.fwd_expand.split", 1)
    assert _read() is None


@pytest.mark.parametrize("expand,taps,want", [
    ((54, 0), (54, 0), 0.0),        # counted, none split
    ((54, 36), (54, 54), 83.33333333333333),
    ((108, 108), (108, 108), 100.0)])
def test_share_of_f1_and_f2_launches(expand, taps, want):
    for name, (launches, split) in (("fwd_expand", expand),
                                    ("fwd_taps", taps)):
        trace.count(f"kernel.{name}.launches", launches)
        trace.count(f"kernel.{name}.split", split)
    trace.count("kernel.fwd_tapsum.launches", 1000)   # F3 never splits
    assert _read() == pytest.approx(want)
