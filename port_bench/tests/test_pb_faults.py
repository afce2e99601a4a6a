"""Runs of the harness on the CPU at batch 2, past its look for a card:
sound, they come out correct; with the timed path broken underneath
(``lib/plants.py``), not.

The faults each cell can have: an answer altered where it is produced
(serving), half of the batch left out (batches over 1), a train step
that leaves its state unchanged, and two that only the captured train
step could have: half of the batch left out, or the BatchNorm running
statistics left as they are, from the second step on (on the CPU the
steps run eagerly; the plant counts them).  One card, so no exchange
between cards to leave out.
"""
import pytest

from port_bench.lib.plants import planted

SEED = 2 ** 31 + 5


def run(workload, batch=2):
    from port_bench.run import run_cell
    return run_cell(workload, SEED, 0.0, False, device="cpu", batch=batch)


FAULTS = [("live.serve_b16", "altered"), ("live.serve_b16", "half_batch"),
          ("live.frame_b1", "altered"),
          ("live.train_b16", "unchanged"), ("live.train_b16", "half_batch"),
          ("live.train_b16", "half_replayed"), ("live.train_b16", "stale_bn")]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f}" for w, f in FAULTS])
def test_a_fault_is_not_correct(workload, fault):
    with planted(fault):
        out = run(workload, batch=1 if workload.endswith("b1") else 2)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("workload", ["live.serve_b16", "live.frame_b1"])
def test_a_sound_run_is_correct(workload):
    out = run(workload, batch=1 if workload.endswith("b1") else 2)
    assert out["correct"] is True, out["checks"]
    assert list(out)[-1] == "checks"


def test_plants_are_undone():
    from md_rdm_tpu_torch import inference
    from md_rdm_tpu_torch.training.module import DepthTrainer
    before = (inference._predict, inference.Predictor, DepthTrainer.update)
    for name in ("control", "half_batch", "stale_bn"):
        with planted(name):
            pass
    assert (inference._predict, inference.Predictor,
            DepthTrainer.update) == before
