"""The per-layer readers and the work counts on hand-built records."""
import pytest

from port_bench.lib import peaks, timing, work
from port_bench.lib.spec import reader


def test_sandwich_counts_by_hand():
    # b=1, s=2, c_in=3, c_mid=4, growth 48: 2 * 4 px * 4 * (3 + 432)
    assert work.sandwich_flops(1, 2, 3, 4) == 2 * 4 * 4 * 435
    assert work.sandwich_bytes(1, 2, 3, 4, 4) == (
        (12 + 12 + 9 * 4 * 48 + 4 * 48) * 4 + 32)
    assert work.sandwich_bwd_bytes(1, 2, 3, 4, 4) == (
        (24 + 4 * 48 + 12 + 9 * 4 * 48) * 4
        + (8 + 12 + 9 * 4 * 48 + 8) * 4)


def test_block_bounds():
    fwd = sum(work.block_bound_s(p, 16, "float32", False)
              for p in work.ENCODER_BLOCKS)
    assert fwd == pytest.approx(27.0777e-3, rel=1e-4)
    layers = sum(len(work.block_layers(p)) for p in work.ENCODER_BLOCKS)
    assert layers == 54
    # each layer of the forward is bound by its operations at batch 16
    s, c_in, c_mid = work.block_layers("encoder.dense_e2")[0]
    f = work.sandwich_flops(16, s, c_in, c_mid)
    assert peaks.bound_s(f, 1, "float32") == f / 67e12
    train = work.block_bound_s("encoder.dense_e2", 16, "float32", True)
    assert train > 2.9 * work.block_bound_s("encoder.dense_e2", 16,
                                            "float32", False)


def test_model_flops():
    live = work.model_flops_per_image({"decoder_ids": [1]})
    # 1.894 TFLOP a batch of 16
    assert live == pytest.approx(118.37e9, rel=1e-3)
    opt = work.model_flops_per_image({"decoder_ids": [1, 6, 7, 8, 9]})
    assert opt > live


def test_readers_on_a_hand_built_record():
    rec = {"mode": "serve", "dtype": "float32", "busy_s": 0.45,
           "wall_s": 0.5, "calls": 8, "images": 128,
           "enqueue_ms": [3.0, 1.0, 2.0],
           "blocks": [{"path": "a", "busy_s_per_call": 0.02,
                       "bound_s": 0.01},
                      {"path": "b", "busy_s_per_call": 0.03,
                       "bound_s": 0.015}],
           "blocks_train": False, "flops_per_image": 1e11}
    assert reader("enqueue_ms.serve")(rec) == 2.0
    assert reader("device_ms.serve")(rec) == pytest.approx(56.25)
    assert reader("idle_share.serve")(rec) == pytest.approx(10.0)
    assert reader("dense_fwd_roofline.serve")(rec) == pytest.approx(50.0)
    assert reader("dense_bwd_roofline.train")(rec) is None
    assert reader("mfu.serve")(rec) == pytest.approx(
        100 * 1e11 * 256 / 67e12)
    train = dict(rec, mode="train", blocks_train=True)
    assert reader("mfu.train")(train) == pytest.approx(
        300 * 1e11 * 256 / 67e12)
    assert reader("dense_bwd_roofline.train")(train) == pytest.approx(50.0)
    assert reader("dense_fwd_roofline.serve")(train) is None


def test_readers_find_nothing_in_an_empty_record():
    for name in ("enqueue_ms.serve", "device_ms.train", "idle_share.frame",
                 "dense_fwd_roofline.serve", "mfu.train"):
        assert reader(name)({}) is None


def test_busy_union_and_idle_gaps():
    device = [(0, 10, "k1"), (5, 20, "k2"), (30, 40, "k1")]
    host = [(0, 100, "outer"), (21, 29, "inner"), (41, 60, "sync")]
    red = timing.reduce_events(device, host, 0, 50)
    assert red["busy_s"] == pytest.approx(30e-6)
    assert red["by_name"] == pytest.approx({"k1": 20e-6, "k2": 15e-6})
    assert red["gaps"] == pytest.approx({"inner": 10e-6, "sync": 10e-6})


def test_a_map_check_with_no_image_to_judge_fails():
    import numpy as np
    from port_bench.lib.compare import serve_numbers
    m = np.ones((1, 128, 128), np.float32)
    d, rd = np.ones((1, 8, 8)), np.full((1, 8, 8), 2.0)
    near = np.zeros((3, 8, 8))          # every pair of every pixel near
    out = serve_numbers([m, m], [d, d], [m, m], [rd, rd], [near, near])
    assert out["decode_flips"] == 0 and out["map_gap"] == float("inf")
    assert out["map_left_out"] == 1.0
    out = serve_numbers([m, m + 1], [d, rd], [m, m], [rd, rd], [near, near])
    assert out["map_left_out"] == 0.5 and out["map_gap"] == 1.0


def test_step_gradients_from_adams_moments():
    """Each step's gradient norm, worked out from AdamW's first moments,
    equals the gradient's own."""
    import torch
    from port_bench.drivers.train import step_grads
    torch.manual_seed(0)
    w = torch.nn.Parameter(torch.randn(50))
    opt = torch.optim.AdamW([w], lr=1e-2, weight_decay=0.01)
    moments, want = [], []
    for k in range(3):
        opt.zero_grad()
        ((w - k) ** 3).sum().backward()
        want.append(float(w.grad.double().norm()))
        opt.step()
        moments.append({"w": opt.state[w]["exp_avg"].clone()})
    got = [g["w"] for g in step_grads(moments)]
    assert got == pytest.approx(want, rel=1e-5)


def test_train_numbers_read_each_part_of_the_state():
    from port_bench.lib.compare import replay_numbers, train_numbers
    want = {"losses": [{"loss": 1.0}] * 3,
            "grads": [{"a": 1.0, "b": 2.0}] * 3,
            "changes": {"a": 1.0, "b": 1.0},
            "bn_changes": {"n.running_mean": 0.5, "n.running_var": 0.5}}
    same = train_numbers(want, want)
    assert all(same[k] == 0 for k in (
        "loss_gap", "grad_gap", "change_gap", "bn_change_gap"))
    stale = dict(want, bn_changes={"n.running_mean": 0.5,
                                   "n.running_var": 0.0})
    assert train_numbers(stale, want)["bn_change_gap"] == 1.0
    step = {"losses": [{"loss": 2.0}], "grads": {"a": 1.0, "b": 2.0},
            "changes": {"a": 1.0, "b": 3.0}, "moment2": {"a": 1.0, "b": 1.0}}
    assert set(replay_numbers(step, step).values()) == {0.0}
    half = dict(step, grads={"a": 0.5, "b": 2.0},
                moment2={"a": 1.0, "b": 0.0})
    out = replay_numbers(half, step)
    assert out["replay_grad_gap"] == 0.5 / 1.5
    assert out["replay_moment2_gap"] == 1.0
