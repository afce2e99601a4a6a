"""On the card, at each cell's own size, through ``run.run_cell``: the
control (the plain reference in TF32 in the program's place,
``lib/plants.py``) comes out not correct on three seeds, and so do the
train cell's planted faults; a sound run of each cell comes out correct.

    python -m pytest port_bench/tests -m card
"""
import pytest

from port_bench.lib.plants import planted
from port_bench.lib.spec import load_benchmark

CELLS = [w["name"] for w in load_benchmark()["workloads"]]
SEEDS = (2 ** 31 + 301, 2 ** 31 + 302, 2 ** 31 + 303)
TRAIN_FAULTS = ("half_batch", "half_replayed", "stale_bn")


def run(workload, seed):
    from port_bench.run import run_cell
    return run_cell(workload, seed, 1.0, False)


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(card, workload):
    for seed in SEEDS:
        with planted("control"):
            out = run(workload, seed)
        assert out["correct"] is False, (seed, out["checks"])


@pytest.mark.card
@pytest.mark.parametrize("fault", TRAIN_FAULTS)
def test_a_captured_step_fault_is_not_correct(card, fault):
    with planted(fault):
        out = run("live.train_b16", SEEDS[0])
    assert out["correct"] is False, out["checks"]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_on_the_card_is_correct(card, workload):
    out = run(workload, SEEDS[0])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["kind"].startswith("NVIDIA")
