#!/usr/bin/env python3
"""Smoke run of the PyTorch port (md_rdm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each:
  1. device     - the card's name and power limit (nvidia-smi), torch's name;
  2. build      - compiles every kernel of the serving and train paths from
                  csrc/, one nvcc per source, all at once;
  3. kernel     - the forward kernel against its plain PyTorch version on
                  the card, at S=57/29/15, batch 16, float32 and bfloat16,
                  TF32 off;
  4. kernel_bwd - the four backward kernels (K1 recompute, K2 dx, K3 dw1,
                  K4 dw2), each against its plain stage fed the plain K1
                  outputs, then the composed backward against the plain
                  backward, at every S=57 layer and the first S=29 and
                  S=15 layers, batch 16, both dtypes; the autograd
                  Function's gradients against autograd through the plain
                  forward;
  5. serve      - Predictor(ModelConfig()) with seeded random weights answers
                  4 requests of batch 16 in float32 and in bfloat16, under
                  PyTorch's default TF32 settings (the model turns TF32 off
                  for itself); the kernel must launch 6 times per forward;
                  then the same weights on the CPU (plain versions) against
                  the card's float32 run on a batch of 2;
  6. train      - DepthTrainer(Config()) from seeded weights takes 3 steps
                  of batch 16 in float32 and 3 in bfloat16 on synthetic
                  data; each step must launch the forward kernel and each
                  backward kernel 6 times; then one
                  float32 step of batch 2 on the card against the CPU port;
  7. times      - forward kernel, plain version, bound and the cuDNN
                  sequence for each S=57 layer shape; the backward per
                  layer (composed and per kernel, plain, bound, library,
                  transient peak memory); serving forward and train step
                  time, img/s and the host time to enqueue;
  8. profile    - device busy share and top kernels of the served forward
                  and of one train step, from torch.profiler;
  9. kernel_lloyd  - the fused comparison + quantization kernel (B4)
                  against its plain version on the card, bit for bit, at
                  N = 16/64/256 (the three launches of a batch-16
                  optimal-set forward, map sizes 16/32/64) and N = 1024
                  (size 128); seeded inputs with negatives, zeros and
                  ratios exactly on thresholds;
  10. serve_optimal - Predictor(ModelConfig(decoder_ids=(1, 6, 7, 8, 9),
                  fusion_eps=1e-2)) with seeded random weights answers 4
                  requests of batch 16 in float32 and in bfloat16; each
                  forward must launch B1 6 times and B4 3 times and give
                  finite maps; then the card's float32 run against the CPU
                  port on a batch of 2, stage by stage (maps, quantized
                  matrices, ALS fills, final map);
  11. times_optimal - B4 per launch shape (kernel, plain, bucketize +
                  gather, bound); the optimal-set forward per dtype (CUDA
                  events, img/s, host enqueue) and its profile.
Then one {"kernels": [...]} line, the card's name and power limit on a line
of their own, and the closing {"ok": true, ...} line.  Every failed check
raises, so the script exits non-zero without the closing line.  It needs a
CUDA card and the repository beside it; it never falls back to the CPU.
``--backward-only`` runs phases 1, 2, 4 and the backward times and stops
without the closing line (for work on the backward kernels).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
BATCH = 16
# Normalized L2 error of the kernel against its plain version.  float32:
# both accumulate in float32 (the kernel in another order), TF32 is off.
# bfloat16: the kernel rounds z to bfloat16 once, after the affine; the
# plain version rounds the 1x1 output to bfloat16 before the affine too,
# and both sum 2736 bfloat16 products in other orders.
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# Backward kernels against their plain versions, each stage alone and
# composed.  float32: sums over up to 52k pixels per weight gradient, in
# another order and with atomics whose order changes from run to run.
# bfloat16: r and dz rounded once each.  K1's dz is held where the kernel's
# ReLU mask (r > 0) equals the plain one; where they differ, both r values
# must lie within MASK_FLIP_R of 0 (a rounding flip of a = z*scale+shift
# around 0), and the flips are counted.
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
MASK_FLIP_R = 1e-4
# The autograd Function (both kernels) against autograd through the plain
# forward: in bfloat16 the plain forward also rounds z, and autograd rounds
# each convolution's gradient, to bfloat16.
FN_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# The card against the CPU port, float32: PARITY.md's bar for every stage.
SERVE_TOL = 1e-3
# One float32 train step, card against CPU port, batch 2.  The loss terms,
# running statistics and the head's gradients (upstream of every ReLU in
# the backward) are held to fixed bars.  The whole-model gradient is not:
# a ReLU input within rounding of 0 takes the other branch under another
# summation order, and through 78 train-mode BatchNorms the float32
# gradient moves by 1-2% between two orders on the CPU alone (one
# thread against the default).  The card's gradients and updated
# parameters are held to FLOOR_FACTOR times that floor, measured in the
# run, and never looser than the fixed bars.
TRAIN_TOL = {"loss": 1e-4, "head_grads": 1e-4, "grads": 1e-3,
             "params": 1e-5, "stats": 1e-4}
FLOOR_FACTOR = 5
TRAIN_STEPS = 3
# Published H100 SXM peaks (NVIDIA data sheet, dense).
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
# C_in of the six S=57 layers, the ones the serving path routes through
# the kernel.
S57_LAYERS = tuple(96 + 48 * i for i in range(6))
# Kernel-check shapes (S, C_in): every S=57 layer, and the first and last
# layer of the S=29 and S=15 blocks.
CHECK_SHAPES = tuple((57, c) for c in S57_LAYERS) + (
    (29, 192), (29, 720), (15, 384), (15, 2064))
# Backward-check shapes: every S=57 layer and the first S=29 and S=15 ones
# (the backward kernel takes C_in up to 384).
BWD_SHAPES = tuple((57, c) for c in S57_LAYERS) + ((29, 192), (15, 384))
DTYPES = (torch.float32, torch.bfloat16)
# The authors' optimal decoder set, served with the fusion floor its
# ModelConfig comment recommends (a faithful tail turns non-positive
# values into NaN).
OPTIMAL = (1, 6, 7, 8, 9)
OPTIMAL_EPS = 1e-2
# B4 launch shapes: (matrices N, Lloyd table size); the first three are one
# batch-16 optimal-set forward (d7, d8, d9), the last decoder 10's.
LLOYD_SHAPES = ((BATCH, 16), (4 * BATCH, 32), (16 * BATCH, 64),
                (64 * BATCH, 128))
DT_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want).clamp_min(1e-30))


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def enqueue_ms(fn, iters: int = 3) -> float:
    """Host time to enqueue one ``fn()`` onto an idle card (the device
    finishes later).  Where it reaches the device time of ``fn``, the host,
    not the card, sets the rate."""
    total = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * total / iters


def sandwich_inputs(s: int, c_in: int, dt: torch.dtype, seed: int):
    """Layer inputs on the card: x >= 0 (after norm1 + ReLU), weights at
    1/sqrt(fan_in) scale, a folded-BN affine near identity."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    c_mid = 48 * s
    dev = "cuda"
    x = torch.randn(BATCH, s, s, c_in, generator=g, device=dev).relu_()
    w1 = torch.randn(c_mid, c_in, 1, 1, generator=g, device=dev) / c_in ** .5
    w2 = torch.randn(48, c_mid, 3, 3, generator=g, device=dev) / (
        9 * c_mid) ** .5
    scale = 1.0 + 0.1 * torch.randn(c_mid, generator=g, device=dev)
    shift = 0.1 * torch.randn(c_mid, generator=g, device=dev)
    return x.to(dt), w1, scale, shift, w2


def library_sandwich(x, w1, scale, shift, w2):
    """The cuDNN sequence computing the sandwich: 1x1 conv, affine, ReLU,
    3x3 conv, on the channels-last activation (a sequence of PyTorch
    calls; no single call computes the function)."""
    dt = x.dtype
    z = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w1.to(dt))
    z = torch.relu(z * scale.to(dt)[:, None, None]
                   + shift.to(dt)[:, None, None])
    return torch.nn.functional.conv2d(z, w2.to(dt), padding=1)


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    info = {"phase": "device", "nvidia_smi": smi,
            "torch_name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "capability": list(torch.cuda.get_device_capability(0))}
    emit(info)
    return smi


def phase_build():
    from md_rdm_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build(["dense_sandwich", "dense_sandwich_bwd", "lloyd"])
    secs = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "smem" in ln]
             for n, (_, log) in _build.BUILD_LOG.items()}
    emit({"phase": "build", "seconds": secs, "ptxas": ptxas})


def phase_kernel():
    from md_rdm_tpu_torch.core.device import no_tf32
    from md_rdm_tpu_torch.kernels.dense_sandwich import (
        dense_sandwich, dense_sandwich_reference)
    rows = []
    with torch.inference_mode(), no_tf32():
        for i, (s, c_in) in enumerate(CHECK_SHAPES):
            for dt in DTYPES:
                args = sandwich_inputs(s, c_in, dt, SEED + i)
                got = dense_sandwich(*args)
                want = dense_sandwich_reference(*args)
                torch.cuda.synchronize()
                check(got.shape == want.shape and got.dtype == dt,
                      f"kernel output {tuple(got.shape)} {got.dtype}")
                err = rel_l2(got, want)
                row = {"s": s, "c_in": c_in, "dtype": DT_NAME[dt],
                       "rel_l2": err, "tol": TOL[dt],
                       "max_abs_err": float((got.float() - want.float())
                                            .abs().max())}
                rows.append(row)
                check(bool(torch.isfinite(got).all()), f"non-finite {row}")
                check(err < TOL[dt], f"kernel disagrees with plain {row}")
    emit({"phase": "kernel", "checks": rows})
    return rows


def bwd_inputs(s: int, c_in: int, dt: torch.dtype, seed: int):
    """:func:`sandwich_inputs` plus a cotangent g ~ N(0, 1)."""
    args = sandwich_inputs(s, c_in, dt, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 7919)
    gy = torch.randn(BATCH, s, s, 48, generator=g, device="cuda").to(dt)
    return args, gy


GRAD_NAMES = ("dx", "dw1", "dscale", "dshift", "dw2")
BWD_STAGES = ("bwd_recompute", "bwd_dx", "bwd_dw1", "bwd_dw2")


def _max_abs(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def stage_checks(args, gy, dt):
    """Each backward kernel against its plain stage on the card, K2-K4 fed
    the plain K1 outputs so that each kernel is held alone.  Returns one
    row per kernel."""
    from md_rdm_tpu_torch.kernels import dense_sandwich as ds
    x, w1 = args[:2]
    with torch.no_grad():
        r, dz, dscale, dshift = ds.bwd_recompute_reference(*args, gy)
        k1 = ds.bwd_recompute(*args, gy)
        pairs = {"bwd_dx": (ds.bwd_dx(dz, w1, x.shape),
                            ds.bwd_dx_reference(dz, w1, x.shape)),
                 "bwd_dw1": (ds.bwd_dw1(x, dz), ds.bwd_dw1_reference(x, dz)),
                 "bwd_dw2": (ds.bwd_dw2(r, gy), ds.bwd_dw2_reference(r, gy))}
    torch.cuda.synchronize()
    rows = {}
    for name, (got, want) in pairs.items():
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"{name} output {tuple(got.shape)}")
        rows[name] = {"rel_l2": rel_l2(got, want),
                      "max_abs_err": _max_abs(got, want)}
    kr, kdz, kds, kdh = k1
    check(kr.shape == r.shape and kr.dtype == dt and kdz.dtype == dt,
          f"bwd_recompute r {tuple(kr.shape)} {kr.dtype}")
    flip = (kr > 0) != (r > 0)
    if flip.any():
        near = max(float(kr[flip].float().abs().max()),
                   float(r[flip].float().abs().max()))
        check(near < MASK_FLIP_R,
              f"bwd_recompute ReLU mask differs away from a = 0 ({near})")
    keep = ~flip
    errs = {"r": rel_l2(kr, r), "dz": rel_l2(kdz[keep], dz[keep]),
            "dscale": rel_l2(kds, dscale), "dshift": rel_l2(kdh, dshift)}
    rows["bwd_recompute"] = {
        "rel_l2": max(errs.values()), **{f"rel_l2_{k}": v
                                         for k, v in errs.items()},
        "mask_flips": int(flip.sum()),
        "max_abs_err": max(_max_abs(kr, r), _max_abs(kdz[keep], dz[keep]),
                           _max_abs(kds, dscale), _max_abs(kdh, dshift))}
    for name, row in rows.items():
        check(row["rel_l2"] < BWD_TOL[dt] and np.isfinite(row["max_abs_err"]),
              f"{name} disagrees with its plain stage {row}")
    return {n: rows[n] for n in BWD_STAGES}


def phase_kernel_bwd():
    from md_rdm_tpu_torch.core.device import no_tf32
    from md_rdm_tpu_torch.kernels.dense_sandwich import (
        dense_sandwich, dense_sandwich_bwd, dense_sandwich_bwd_reference,
        dense_sandwich_reference)
    rows, fn_rows = [], []
    with no_tf32():
        for i, (s, c_in) in enumerate(BWD_SHAPES):
            for dt in DTYPES:
                args, gy = bwd_inputs(s, c_in, dt, SEED + 50 + i)
                stages = stage_checks(args, gy, dt)
                with torch.no_grad():
                    got = dense_sandwich_bwd(*args, gy)
                    want = dense_sandwich_bwd_reference(*args, gy)
                torch.cuda.synchronize()
                row = {"s": s, "c_in": c_in, "dtype": DT_NAME[dt],
                       "tol": BWD_TOL[dt]}
                for name, a, b in zip(GRAD_NAMES, got, want):
                    check(a.shape == b.shape, f"{name} {tuple(a.shape)}")
                    check(bool(torch.isfinite(a).all()), f"{name} non-finite")
                    row[name] = rel_l2(a, b)
                row["max_abs_err"] = max(_max_abs(a, b)
                                         for a, b in zip(got, want))
                row["stages"] = stages
                rows.append(row)
                check(all(row[n] < BWD_TOL[dt] for n in GRAD_NAMES),
                      f"backward kernels disagree with plain {row}")
        # the Function (forward and backward kernels) against autograd
        # through the plain forward, at the first S=57 layer
        for dt in DTYPES:
            args, gy = bwd_inputs(57, S57_LAYERS[0], dt, SEED + 90)
            leaves = [a.clone().requires_grad_() for a in args]
            got = torch.autograd.grad(dense_sandwich(*leaves), leaves, gy)
            want = torch.autograd.grad(dense_sandwich_reference(*leaves),
                                       leaves, gy)
            row = {"s": 57, "c_in": S57_LAYERS[0], "dtype": DT_NAME[dt],
                   "tol": FN_TOL[dt]}
            row.update({n: rel_l2(a, b)
                        for n, a, b in zip(GRAD_NAMES, got, want)})
            fn_rows.append(row)
            check(all(row[n] < FN_TOL[dt] for n in GRAD_NAMES),
                  f"autograd Function disagrees with plain autograd {row}")
    emit({"phase": "kernel_bwd", "checks": rows, "function": fn_rows})
    return rows


def _finite_rel(got: np.ndarray, want: np.ndarray):
    fg, fw = np.isfinite(got), np.isfinite(want)
    check(np.array_equal(fg, fw), "non-finite positions differ")
    g, w = got[fw].astype(np.float64), want[fw].astype(np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def phase_serve():
    from md_rdm_tpu_torch.core.config import ModelConfig
    from md_rdm_tpu_torch.inference import Predictor
    from md_rdm_tpu_torch.kernels.dense_sandwich import dense_sandwich
    from md_rdm_tpu_torch.models.rdm import (DepthEstimationNet,
                                             init_parameters,
                                             randomize_batchnorm)
    from md_rdm_tpu_torch.ops.decompose import recombination

    model = DepthEstimationNet(ModelConfig())
    init_parameters(model, SEED)
    randomize_batchnorm(model, SEED + 1)
    sd = model.state_dict()
    preds = {dt: Predictor(sd, ModelConfig(compute_dtype=DT_NAME[dt]),
                           device="cuda") for dt in DTYPES}
    rng = np.random.default_rng(SEED)
    requests = [rng.random((BATCH, 226, 226, 3), dtype=np.float32)
                for _ in range(4)]

    served = []
    tf32 = {"cudnn": torch.backends.cudnn.allow_tf32,
            "matmul": torch.backends.cuda.matmul.allow_tf32}
    dense_sandwich.launches = 0
    for dt in DTYPES:
        for req in requests:
            before = dense_sandwich.launches
            t0 = time.perf_counter()
            final, decode = preds[dt](req)
            secs = time.perf_counter() - t0
            per_fwd = dense_sandwich.launches - before
            check(per_fwd == 6, f"{per_fwd} kernel launches in a forward")
            check(final.shape == (BATCH, 1, 128, 128), f"map {final.shape}")
            check(decode.shape == (BATCH, 1, 8, 8), f"decode {decode.shape}")
            served.append({"dtype": DT_NAME[dt], "seconds": secs,
                           "launches": per_fwd,
                           "finite": float(np.isfinite(final).mean())})
    main_launches = dense_sandwich.launches
    per_forward = {r["launches"] for r in served}

    # the same weights and images through the CPU port (plain versions)
    x2 = torch.from_numpy(requests[0][:2])
    cpu = Predictor(sd, ModelConfig(), device="cpu")
    with torch.inference_mode():
        y_c, d_c, p_c = cpu.model(x2)
        y_g, d_g, p_g = preds[torch.float32].model(x2.cuda())
        f_c = recombination(list(y_c)).numpy()
        f_g = recombination(list(y_g)).cpu().numpy()
        d_c, d_g, p_c = d_c.numpy(), d_g.cpu().numpy(), p_c.numpy()
    near = np.any(np.abs(p_c - 0.5) < 1e-5, axis=1, keepdims=True)
    exact = (d_c == d_g) | near
    check(bool(exact.all()), f"decode differs at {np.argwhere(~exact)[:5]}")
    err = _finite_rel(f_g, f_c)
    check(err < SERVE_TOL, f"card vs CPU final map relL2 {err}")
    emit({"phase": "serve", "caller_tf32": tf32, "requests": served,
          "main_path_launches": main_launches,
          "cpu_vs_card": {"final_rel_l2": err, "tol": SERVE_TOL,
                          "decode_mismatch_near_half": int((d_c != d_g).sum()),
                          "finite": float(np.isfinite(f_g).mean())}})
    return preds, requests, main_launches, per_forward.pop()


def train_batch(batch: int, seed: int):
    """Synthetic batch made with numpy from the seed: images uniform in
    [0, 1), depth uniform in [0.5, 9.5) with an invalid (zero) corner."""
    rng = np.random.default_rng(seed)
    x = rng.random((batch, 226, 226, 3), dtype=np.float32)
    y = rng.random((batch, 1, 226, 226), dtype=np.float32) * 9 + 0.5
    y[:, :, :5, :5] = 0.0
    return x, y


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().double().cpu().reshape(-1)
                      for t in tensors])


def phase_train():
    """3 train steps of batch 16 per dtype through DepthTrainer, each
    launching the forward kernel and each backward kernel 6 times; then one
    float32 step of batch 2 on the card against the CPU port from the same
    weights."""
    from md_rdm_tpu_torch.core.config import Config, ModelConfig
    from md_rdm_tpu_torch.kernels.dense_sandwich import (BWD_KERNELS,
                                                         dense_sandwich)
    from md_rdm_tpu_torch.training.module import DepthTrainer

    x, y = train_batch(BATCH, SEED + 3)
    xd, yd = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    states, steps = {}, []
    dense_sandwich.launches = 0
    for fn in BWD_KERNELS:
        fn.launches = 0
    for dt in DTYPES:
        trainer = DepthTrainer(Config(model=ModelConfig(
            compute_dtype=DT_NAME[dt])), device="cuda")
        state = trainer.init(seed=SEED)
        model = state.model
        params0 = _flat(p for p in model.parameters() if p.numel())
        stats0 = _flat(b for n, b in model.named_buffers() if "running" in n)
        for i in range(TRAIN_STEPS):
            f0 = dense_sandwich.launches
            b0 = [fn.launches for fn in BWD_KERNELS]
            t0 = time.perf_counter()
            state, logs = trainer.train_step(state, xd, yd)
            logs = {k: float(v) for k, v in logs.items()}
            secs = time.perf_counter() - t0
            row = {"dtype": DT_NAME[dt], "step": i + 1, "seconds": secs,
                   "fwd_launches": dense_sandwich.launches - f0,
                   "bwd_launches": {fn.__name__: fn.launches - n
                                    for fn, n in zip(BWD_KERNELS, b0)},
                   "logs": logs}
            steps.append(row)
            check(all(np.isfinite(v) for v in logs.values()),
                  f"non-finite log {row}")
            check(row["fwd_launches"] == 6
                  and set(row["bwd_launches"].values()) == {6},
                  f"kernel launches per step {row}")
        params = _flat(p for p in model.parameters() if p.numel())
        stats = _flat(b for n, b in model.named_buffers() if "running" in n)
        check(state.step == TRAIN_STEPS, f"step count {state.step}")
        check(not torch.equal(params, params0), "parameters did not move")
        check(not torch.equal(stats, stats0), "running stats did not move")
        states[dt] = (trainer, state)
    launches = {"forward": dense_sandwich.launches,
                **{fn.__name__: fn.launches for fn in BWD_KERNELS}}

    # one float32 step of batch 2, card against the CPU port (at the
    # default thread count, and single-threaded for the rounding floor)
    x2, y2 = train_batch(2, SEED + 4)
    runs = {}
    threads = torch.get_num_threads()
    for name, dev, n_threads in (("cpu", "cpu", threads),
                                 ("cpu_1thread", "cpu", 1),
                                 ("cuda", "cuda", threads)):
        torch.set_num_threads(n_threads)
        trainer = DepthTrainer(Config(), device=dev)
        state = trainer.init(seed=SEED)
        seen = {}
        hook = state.model.d_1.register_forward_hook(
            lambda _m, _i, out: seen.update(
                decode=out[0].detach().cpu().numpy(),
                probs=out[1].detach().cpu().numpy()))
        state, logs = trainer.train_step(state, x2, y2)
        hook.remove()
        model = state.model
        named = [(n, p) for n, p in model.named_parameters() if p.numel()]
        runs[name] = {
            "logs": {k: float(v) for k, v in logs.items()},
            "grads": _flat(p.grad for _, p in named),
            "head": _flat(p.grad for n, p in named
                          if n.startswith(("weight_layer.", "d_1.conv2."))),
            "params": _flat(p for _, p in named),
            "stats": _flat(b for n, b in model.named_buffers()
                           if "running" in n), **seen}
    torch.set_num_threads(threads)
    c, g, c1 = runs["cpu"], runs["cuda"], runs["cpu_1thread"]
    loss_rel = {k: abs(g["logs"][k] - c["logs"][k]) / max(abs(c["logs"][k]),
                                                           1e-30)
                for k in ("loss", "MSE", "Ord_Loss", "Fine_Detail")}
    errs = {k: rel_l2(g[k], c[k])
            for k in ("head", "grads", "params", "stats")}
    floor = {k: rel_l2(c1[k], c[k]) for k in ("grads", "params")}
    bars = {"head": TRAIN_TOL["head_grads"], "stats": TRAIN_TOL["stats"],
            **{k: max(TRAIN_TOL[k], FLOOR_FACTOR * floor[k])
               for k in ("grads", "params")}}
    near = np.any(np.abs(c["probs"] - 0.5) < 1e-5, axis=1, keepdims=True)
    exact = (c["decode"] == g["decode"]) | near
    emit({"phase": "train", "steps": steps, "main_path_launches": launches,
          "cpu_vs_card": {"loss_rel": loss_rel, "rel_l2": errs,
                          "cpu_floor_rel_l2": floor, "bars": bars,
                          "cpu_threads": threads,
                          "decode_mismatch_near_half":
                              int((c["decode"] != g["decode"]).sum())}})
    check(all(v < TRAIN_TOL["loss"] for v in loss_rel.values()),
          f"card vs CPU loss terms {loss_rel}")
    for k, bar in bars.items():
        check(errs[k] < bar, f"card vs CPU {k} relL2 {errs[k]} (bar {bar})")
    check(bool(exact.all()), f"train decode differs at "
                             f"{np.argwhere(~exact)[:5]}")
    return states, (xd, yd), launches


def phase_times(preds, requests, smi):
    from md_rdm_tpu_torch.core.device import no_tf32
    from md_rdm_tpu_torch.kernels.dense_sandwich import (
        dense_sandwich_packed, dense_sandwich_reference, pack_weights,
        sandwich_bytes, sandwich_flops)
    rows = []
    with torch.inference_mode(), no_tf32():
        for dt in DTYPES:
            for i, c_in in enumerate(S57_LAYERS):
                args = sandwich_inputs(57, c_in, dt, 100 + i)
                # laid out once, as the serving path's layers keep them
                packed = pack_weights(*args[1:], dt)
                iters = 10 if dt == torch.float32 else 20
                t = {"ms": [], "plain_ms": [], "library_ms": []}
                for _ in range(2):   # in turns: kernel, plain, library
                    t["ms"].append(cuda_ms(
                        lambda: dense_sandwich_packed(args[0], packed),
                        iters))
                    t["plain_ms"].append(cuda_ms(
                        lambda: dense_sandwich_reference(*args), iters))
                    t["library_ms"].append(cuda_ms(
                        lambda: library_sandwich(*args), iters))
                flops = sandwich_flops(BATCH, 57, c_in, 57 * 48)
                nbytes = sandwich_bytes(BATCH, 57, c_in, 57 * 48,
                                        args[0].element_size())
                bound = 1e3 * max(flops / PEAK_FLOPS[dt], nbytes / PEAK_BYTES)
                rows.append({"s": 57, "c_in": c_in, "dtype": DT_NAME[dt],
                             **{k: min(v) for k, v in t.items()},
                             "bound_ms": bound,
                             "bound_by": ("operations"
                                          if flops / PEAK_FLOPS[dt]
                                          >= nbytes / PEAK_BYTES
                                          else "bytes"),
                             "gflop": flops / 1e9, "mbytes": nbytes / 1e6})
    emit({"phase": "times_kernel", "card": smi, "rows": rows})

    serving = []
    with torch.inference_mode():
        for dt in DTYPES:
            x = torch.from_numpy(requests[0]).cuda()
            torch.cuda.reset_peak_memory_stats()   # this dtype's forwards
            fwd_ms = cuda_ms(lambda: preds[dt].predict(x), iters=5)
            t0 = time.perf_counter()
            for req in requests:
                preds[dt](req)
            req_ms = 1e3 * (time.perf_counter() - t0) / len(requests)
            serving.append({"dtype": DT_NAME[dt], "batch": BATCH,
                            "forward_ms": fwd_ms,
                            "img_per_s": BATCH * 1e3 / fwd_ms,
                            "enqueue_ms": enqueue_ms(
                                lambda: preds[dt].predict(x)),
                            "request_ms": req_ms,
                            "request_img_per_s": BATCH * 1e3 / req_ms})
    emit({"phase": "times_serve", "card": smi, "rows": serving})
    return rows


def _bound(flops: int, nbytes: int, dt) -> dict:
    by_ops = flops / PEAK_FLOPS[dt] >= nbytes / PEAK_BYTES
    return {"bound_ms": 1e3 * max(flops / PEAK_FLOPS[dt],
                                  nbytes / PEAK_BYTES),
            "bound_by": "operations" if by_ops else "bytes",
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6}


def phase_times_bwd(smi):
    """Per S=57 layer: the backward composed (its four kernels) against the
    plain backward and autograd through :func:`library_sandwich` (its graph
    built once, so z is saved there and not recomputed), with the
    function's bound and the transient peak memory of one call; then each
    kernel fed the plain K1 outputs against its plain stage, its own bound
    and one PyTorch call computing the same product (none for K1)."""
    from md_rdm_tpu_torch.core.device import no_tf32
    from md_rdm_tpu_torch.kernels import dense_sandwich as ds
    rows = []
    with no_tf32():
        for dt in DTYPES:
            for i, c_in in enumerate(S57_LAYERS):
                args, gy = bwd_inputs(57, c_in, dt, 200 + i)
                x, w1, _, _, w2 = args
                packed = ds.pack_weights(*args[1:], dt)
                leaves = [a.clone().requires_grad_() for a in args]
                lib_out = library_sandwich(*leaves)
                iters = 3 if dt == torch.float32 else 5
                t = {"ms": [], "plain_ms": [], "library_ms": []}
                kernel = lambda: ds.dense_sandwich_bwd(  # noqa: E731
                    *args, gy, packed.w1t)
                plain = lambda: ds.dense_sandwich_bwd_reference(  # noqa: E731
                    *args, gy)
                lib = lambda: torch.autograd.grad(  # noqa: E731
                    lib_out, leaves, gy.permute(0, 3, 1, 2),
                    retain_graph=True)
                for _ in range(2):   # in turns: kernel, plain, library
                    with torch.no_grad():
                        t["ms"].append(cuda_ms(kernel, iters, warmup=1))
                        t["plain_ms"].append(cuda_ms(plain, iters, warmup=1))
                    t["library_ms"].append(cuda_ms(lib, iters, warmup=1))
                del lib_out, leaves
                with torch.no_grad():
                    torch.cuda.synchronize()
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    grads = kernel()
                    torch.cuda.synchronize()
                    peak = torch.cuda.max_memory_allocated() - base
                    del grads
                    stages = _stage_times(ds, args, gy, packed, dt, iters)
                row = {"s": 57, "c_in": c_in, "dtype": DT_NAME[dt],
                       **{k: min(v) for k, v in t.items()},
                       **_bound(ds.sandwich_bwd_flops(BATCH, 57, c_in,
                                                      57 * 48),
                                ds.sandwich_bwd_bytes(BATCH, 57, c_in,
                                                      57 * 48,
                                                      x.element_size()), dt),
                       "transient_peak_gb": peak / 1e9, "kernels": stages}
                rows.append(row)
    emit({"phase": "times_kernel_bwd", "card": smi, "rows": rows})
    return rows


def _stage_times(ds, args, gy, packed, dt, iters):
    """Each backward kernel, its plain stage and its library call, timed in
    turns on the plain K1 outputs."""
    x, w1, _, _, w2 = args
    r, dz, _, _ = ds.bwd_recompute_reference(*args, gy)
    c_mid, c_in = w1.shape[:2]
    w1m = w1.reshape(c_mid, c_in).to(dt)
    xm = x.reshape(-1, c_in)
    r4 = r.view(*x.shape[:3], c_mid).permute(0, 3, 1, 2)
    g4 = gy.permute(0, 3, 1, 2)
    fns = {
        "bwd_recompute": (lambda: ds.bwd_recompute(*args, gy, packed.w1t),
                          lambda: ds.bwd_recompute_reference(*args, gy),
                          None),
        "bwd_dx": (lambda: ds.bwd_dx(dz, w1, x.shape),
                   lambda: ds.bwd_dx_reference(dz, w1, x.shape),
                   lambda: torch.mm(dz, w1m)),
        "bwd_dw1": (lambda: ds.bwd_dw1(x, dz),
                    lambda: ds.bwd_dw1_reference(x, dz),
                    lambda: torch.mm(dz.t(), xm)),
        "bwd_dw2": (lambda: ds.bwd_dw2(r, gy),
                    lambda: ds.bwd_dw2_reference(r, gy),
                    lambda: torch.nn.grad.conv2d_weight(r4, w2.shape, g4,
                                                        padding=1)),
    }
    work = ds.bwd_stage_work(BATCH, 57, c_in, c_mid, x.element_size())
    out = {}
    for name, (kernel, plain, lib) in fns.items():
        t = {"ms": [], "plain_ms": [], "library_ms": []}
        for _ in range(2):   # in turns: kernel, plain, library
            t["ms"].append(cuda_ms(kernel, iters, warmup=1))
            t["plain_ms"].append(cuda_ms(plain, iters, warmup=1))
            if lib is not None:
                t["library_ms"].append(cuda_ms(lib, iters, warmup=1))
        out[name] = {k: (min(v) if v else None) for k, v in t.items()}
        out[name].update(_bound(*work[name], dt))
    return out


def phase_times_train(states, batch, smi):
    """Train step at batch 16: device time over back-to-back steps (CUDA
    events), img/s, and the host time to enqueue one step."""
    rows = []
    for dt in DTYPES:
        trainer, state = states[dt]
        step = lambda: trainer.train_step(state, *batch)  # noqa: E731
        torch.cuda.reset_peak_memory_stats()   # this dtype's steps
        ms = cuda_ms(step, iters=3, warmup=1)
        rows.append({"dtype": DT_NAME[dt], "batch": BATCH, "step_ms": ms,
                     "img_per_s": BATCH * 1e3 / ms,
                     "enqueue_ms": enqueue_ms(step, iters=2),
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    emit({"phase": "times_train", "card": smi, "rows": rows})
    return rows


def profile_window(fn, reps: int) -> dict:
    """torch.profiler over ``reps`` back-to-back calls of ``fn`` after one
    warm-up: device busy time (union of the kernels' and copies' intervals)
    against the window's wall time, device operations per call, and the
    kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    dev = sorted(((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda r: r[0])
    busy, end, by_name = 0.0, float("-inf"), {}
    for lo, hi, name in dev:
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
        n, us = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, us + hi - lo)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return {"calls": reps, "wall_ms_per_call": wall_us / 1e3 / reps,
            "device_busy_ms_per_call": busy / 1e3 / reps,
            "idle_share": (1.0 - busy / wall_us) if dev else None,
            "device_ops_per_call": len(dev) / reps,
            "top": [{"name": name[:100], "per_call": n / reps,
                     "ms_per_call": us / 1e3 / reps}
                    for name, (n, us) in top]}


def device_ms(fn, reps: int, attempts: int = 3) -> float:
    """Device busy time per call of ``fn`` from the profiler; a window in
    which the profiler recorded no device activity is taken again."""
    for _ in range(attempts):
        busy = profile_window(fn, reps)["device_busy_ms_per_call"]
        if busy > 0:
            return busy
    raise RuntimeError("chip_smoke: the profiler recorded no device time")


def phase_profile(preds, requests, states, batch, smi):
    """Three served forwards and one train step per dtype."""
    rows = []
    x = torch.from_numpy(requests[0]).cuda()
    with torch.inference_mode():
        for dt in DTYPES:
            rows.append({"path": "serve_forward", "dtype": DT_NAME[dt],
                         **profile_window(lambda: preds[dt].predict(x), 3)})
    for dt in DTYPES:
        trainer, state = states[dt]
        rows.append({"path": "train_step", "dtype": DT_NAME[dt],
                     **profile_window(
                         lambda: trainer.train_step(state, *batch), 1)})
    emit({"phase": "profile", "card": smi, "rows": rows})


def lloyd_inputs(n: int, size: int, seed: int):
    """Seeded 16x16 pages and 8x8 halves on the card: log-normal values
    with negatives and zeros mixed in, a quarter of the halves exactly 1
    and a third of the pages exactly on a threshold, so that ratios land
    on thresholds inside and outside the windows."""
    from md_rdm_tpu_torch.ops.quantize import level_table
    rng = np.random.default_rng(seed)
    dn = np.exp(rng.normal(0, 0.4, (n, 1, 16, 16))).astype(np.float32)
    dn_1 = np.exp(rng.normal(0, 0.4, (n, 1, 8, 8))).astype(np.float32)
    for a in (dn.reshape(-1), dn_1.reshape(-1)):
        a[rng.choice(a.size, a.size // 50, replace=False)] *= -1
        a[rng.choice(a.size, a.size // 200, replace=False)] = 0.0
    dn_1.reshape(-1)[rng.choice(dn_1.size, dn_1.size // 4,
                                replace=False)] = 1.0
    q, _ = level_table(size)
    idx = rng.choice(dn.size, dn.size // 3, replace=False)
    dn.reshape(-1)[idx] = rng.choice(q, idx.size)
    return torch.from_numpy(dn).cuda(), torch.from_numpy(dn_1).cuda()


def phase_kernel_lloyd():
    """B4 against its plain version on the card and on the CPU: equal bit
    for bit; the output never requires grad."""
    from md_rdm_tpu_torch.kernels.lloyd import (
        fused_comparison_quantize, fused_comparison_quantize_reference)
    rows = []
    for i, (n, size) in enumerate(LLOYD_SHAPES):
        dn, dn_1 = lloyd_inputs(n, size, SEED + 300 + i)
        got = fused_comparison_quantize(dn.requires_grad_(), dn_1, size)
        torch.cuda.synchronize()
        with torch.no_grad():
            want = fused_comparison_quantize_reference(dn, dn_1, size)
            cpu = fused_comparison_quantize_reference(dn.cpu(), dn_1.cpu(),
                                                      size)
        check(tuple(got.shape) == (n, 256, 64), f"B4 output {got.shape}")
        row = {"n": n, "size": size,
               "max_abs_err": float((got - want).abs().max()),
               "bit_equal_plain": bool(torch.equal(got, want)),
               "bit_equal_cpu": bool(torch.equal(got.cpu(), cpu)),
               "requires_grad": got.requires_grad}
        rows.append(row)
        check(row["max_abs_err"] == 0 and row["bit_equal_plain"],
              f"B4 disagrees with its plain version {row}")
        check(row["bit_equal_cpu"], f"B4 disagrees with the CPU port {row}")
        check(not got.requires_grad, "B4 output requires grad")
    emit({"phase": "kernel_lloyd", "checks": rows})
    return rows


def straddle_flips(got, want, ratio_got, ratio_want, thresholds,
                   near: float = 1e-5):
    """Quantized matrices of two runs: the same level unless a threshold
    lies between their ratios (or within ``near`` of them).  Returns
    (entries in another bin with no threshold between the ratios, entries
    in another bin)."""
    got, want = np.asarray(got), np.asarray(want)
    lo = np.minimum(ratio_got, ratio_want).astype(np.float64) - near
    hi = np.maximum(ratio_got, ratio_want).astype(np.float64) + near
    q = np.asarray(thresholds, np.float64)
    straddle = (np.searchsorted(q, hi, side="right")
                > np.searchsorted(q, lo, side="left"))
    differ = got != want
    return int((differ & ~straddle).sum()), int(differ.sum())


def als_tie_match(got, sparse, num_iters: int, group_ids):
    """Match ALS fills ``got`` (N, ...) to the iterates of the same
    quantized input, the loop of ops/als.py unrolled in float32 on the CPU:
    per selection group, the nearest iterate whose RMSE lies within 1e-6
    of the group's minimum (iterates tied at float32 equality differ by up
    to percents, and another summation order may pick another one).
    Returns (the worst group's relL2 to it, the most iterates tied)."""
    s = torch.as_tensor(sparse, dtype=torch.float32).cpu()
    n, h, w = s.shape
    gid = torch.as_tensor(group_ids).long().cpu()
    onehot = (gid[None] == torch.arange(int(gid.max()) + 1)[:, None]).float()
    denom = onehot.sum(1) * h * w

    def step(r, f):
        return torch.matmul(r, f) / ((f * f).sum((1, 2), keepdim=True) + 0.05)

    def rmse(p, q):
        sq = ((torch.matmul(p, q.reshape(n, 1, w)) - s) ** 2).sum((1, 2))
        return torch.sqrt((onehot @ sq) / denom)

    def norm(p):
        return p / torch.exp(torch.log(p).sum(1, keepdim=True) / (h * h))

    p, q = torch.ones(n, h, 1), torch.ones(n, w, 1)
    outs, recs = [norm(p)], [rmse(p, q)]
    for _ in range(num_iters):
        p = step(s, q)
        recs.append(rmse(p, q))
        outs.append(norm(p))
        q = step(s.reshape(n, w, h), p)
    recs = torch.stack(recs)
    g = torch.as_tensor(got).double().cpu().reshape(n, -1)
    worst, most = 0.0, 0
    for k in range(recs.shape[1]):
        rows = gid == k
        tied = torch.nonzero(recs[:, k] <= recs[:, k].min() + 1e-6)[:, 0]
        most = max(most, len(tied))
        worst = max(worst, min(rel_l2(g[rows], outs[t].reshape(n, -1)[rows])
                               for t in tied.tolist()))
    return worst, most


def _stage_groups(config, stages, did):
    """(selection group ids, iterations) of a relative decoder's fills."""
    from md_rdm_tpu_torch.core.config import DECODER_SIZES
    n = stages[f"sparse_{did}"].shape[0]
    size = DECODER_SIZES[did]
    if size == 8:
        return torch.zeros(n, dtype=torch.long), config.als_iters_quadratic
    pages = (size // 16) ** 2
    return torch.arange(n) % pages, config.als_iters_rect


def phase_serve_optimal():
    """The optimal set served at batch 16 in both dtypes through the
    Predictor, counted launches per forward; then the card against the CPU
    port, float32, batch 2, stage by stage."""
    from md_rdm_tpu_torch.core.config import DECODER_SIZES, ModelConfig
    from md_rdm_tpu_torch.inference import Predictor
    from md_rdm_tpu_torch.kernels.dense_sandwich import dense_sandwich
    from md_rdm_tpu_torch.kernels.lloyd import fused_comparison_quantize
    from md_rdm_tpu_torch.models.decoder import cross_scale_pages
    from md_rdm_tpu_torch.models.rdm import (DepthEstimationNet,
                                             init_parameters,
                                             randomize_batchnorm)
    from md_rdm_tpu_torch.ops.comparison import (comparison_cross_scale,
                                                 comparison_v1)
    from md_rdm_tpu_torch.ops.decompose import recombination
    from md_rdm_tpu_torch.ops.quantize import level_table

    def config(dt):
        return ModelConfig(decoder_ids=OPTIMAL, fusion_eps=OPTIMAL_EPS,
                           compute_dtype=DT_NAME[dt])

    model = DepthEstimationNet(config(torch.float32))
    init_parameters(model, SEED)
    randomize_batchnorm(model, SEED + 1)
    sd = model.state_dict()
    del model
    preds = {dt: Predictor(sd, config(dt), device="cuda") for dt in DTYPES}
    rng = np.random.default_rng(SEED + 5)
    requests = [rng.random((BATCH, 226, 226, 3), dtype=np.float32)
                for _ in range(4)]

    served = []
    dense_sandwich.launches = fused_comparison_quantize.launches = 0
    for dt in DTYPES:
        for req in requests:
            b1 = dense_sandwich.launches
            b4 = fused_comparison_quantize.launches
            t0 = time.perf_counter()
            final, decode = preds[dt](req)
            secs = time.perf_counter() - t0
            row = {"dtype": DT_NAME[dt], "seconds": secs,
                   "b1_launches": dense_sandwich.launches - b1,
                   "b4_launches": fused_comparison_quantize.launches - b4,
                   "finite": float(np.isfinite(final).mean())}
            served.append(row)
            check(row["b1_launches"] == 6 and row["b4_launches"] == 3,
                  f"kernel launches in an optimal-set forward {row}")
            check(final.shape == (BATCH, 1, 128, 128), f"map {final.shape}")
            check(decode.shape == (BATCH, 1, 8, 8), f"decode {decode.shape}")
            check(row["finite"] == 1.0, f"non-finite optimal-set map {row}")
    launches = {"dense_sandwich": dense_sandwich.launches,
                "fused_comparison_quantize":
                    fused_comparison_quantize.launches}

    # the card's float32 run against the CPU port, stage by stage
    x2 = torch.from_numpy(requests[0][:2])
    cfg = config(torch.float32)
    cpu = Predictor(sd, cfg, device="cpu")
    st_c, st_g = {}, {}
    with torch.inference_mode():
        y_c, d_c, p_c = cpu.model(x2, stages=st_c)
        y_g, d_g, _ = preds[torch.float32].model(x2.cuda(), stages=st_g)
        f_c = recombination(list(y_c)).numpy()
        f_g = recombination(list(y_g)).cpu().numpy()
        host = {k: v.cpu() for k, v in st_g["maps"].items()}
        f_tail = recombination(list(cpu.model.fuse(host))).numpy()
    near = np.any(np.abs(p_c.numpy() - 0.5) < 1e-5, axis=1, keepdims=True)
    check(bool(((d_c.numpy() == d_g.cpu().numpy()) | near).all()),
          "optimal-set decode differs away from P = 0.5")
    stages, flipped = {}, []
    for did in OPTIMAL[1:]:
        size = DECODER_SIZES[did]
        m_c, m_g = st_c[f"map_{did}"], st_g[f"map_{did}"].cpu()
        ratio_c, ratio_g = ((comparison_v1(m_c), comparison_v1(m_g))
                            if size == 8 else
                            (comparison_cross_scale(*cross_scale_pages(
                                m, size)[:2]) for m in (m_c, m_g)))
        unexplained, flips = straddle_flips(
            st_g[f"sparse_{did}"].cpu().numpy(),
            st_c[f"sparse_{did}"].numpy(), ratio_g.numpy(),
            ratio_c.numpy(), level_table(size)[0])
        gid, iters = _stage_groups(cfg, st_c, did)
        fill_c, fill_g = st_c[f"filled_{did}"], st_g[f"filled_{did}"].cpu()
        tie_err, tied = als_tie_match(fill_g, st_c[f"sparse_{did}"], iters,
                                      gid)
        fill_rel = max(rel_l2(a, b) for a, b in zip(fill_g, fill_c))
        if fill_rel > 1e-4:
            flipped.append(did)
        stages[did] = {"map_rel_l2": rel_l2(m_g, m_c),
                       "quantized_in_other_bin": flips,
                       "quantized_unexplained": unexplained,
                       "quantized_entries": int(ratio_c.numel()),
                       "fill_tie_rel_l2": tie_err, "most_tied": tied,
                       "fill_vs_cpu_max_rel_l2": fill_rel}
        check(stages[did]["map_rel_l2"] < SERVE_TOL, f"d{did} map {stages}")
        check(unexplained == 0, f"d{did} quantized bins {stages}")
        check(tie_err < SERVE_TOL, f"d{did} ALS fill {stages}")
    final_rel = _finite_rel(f_g, f_c)
    tail_rel = _finite_rel(f_g, f_tail)
    emit({"phase": "serve_optimal", "requests": served,
          "main_path_launches": launches,
          "cpu_vs_card": {"stages": stages, "tie_flips": flipped,
                          "final_rel_l2": final_rel,
                          "final_vs_cpu_tail_on_card_maps": tail_rel,
                          "tol": SERVE_TOL}})
    # the final map against the CPU port, and after a tie flip (which the
    # faithful tail amplifies) also against the CPU tail on the card's maps
    check(final_rel < SERVE_TOL and (tail_rel < SERVE_TOL or not flipped),
          f"optimal-set final map, card vs CPU: {final_rel} / {tail_rel}")
    return preds, requests, launches


def library_lloyd(dn, dn_1, size):
    """One PyTorch formulation of B4 that needs no hand kernel: the
    comparison, then torch.bucketize against the thresholds and a gather
    from the level table (NaN ratios bucket last here, not first)."""
    from md_rdm_tpu_torch.ops.comparison import comparison_cross_scale
    from md_rdm_tpu_torch.ops.quantize import level_table
    q, level = (torch.as_tensor(t.copy(), device=dn.device)
                for t in level_table(size))
    r = comparison_cross_scale(dn, dn_1)
    return level[torch.bucketize(r, q, right=True)]


def phase_times_optimal(preds, requests, smi):
    """B4 at the three launch shapes of a batch-16 forward: kernel, plain
    version, library formulation (device time and time per call), bound;
    then the optimal-set forward."""
    from md_rdm_tpu_torch.kernels.lloyd import (
        fused_comparison_quantize, fused_comparison_quantize_reference,
        lloyd_bytes, lloyd_ops)
    rows = []
    with torch.inference_mode():
        for i, (n, size) in enumerate(LLOYD_SHAPES[:3]):
            dn, dn_1 = lloyd_inputs(n, size, SEED + 400 + i)
            fns = {"": lambda: fused_comparison_quantize(dn, dn_1, size),
                   "plain_": lambda: fused_comparison_quantize_reference(
                       dn, dn_1, size),
                   "library_": lambda: library_lloyd(dn, dn_1, size)}
            # device time from the profiler (the calls are too short for
            # back-to-back events to see past the host), and the time per
            # call back to back (CUDA events: host-bound at these sizes)
            t = {}
            for _ in range(2):   # in turns: kernel, plain, library
                for key, fn in fns.items():
                    t.setdefault(key + "ms", []).append(device_ms(fn, 20))
                    t.setdefault(key + "call_ms", []).append(
                        cuda_ms(fn, 20))
            nbytes, ops = lloyd_bytes(n), lloyd_ops(n)
            by_bytes = nbytes / PEAK_BYTES >= ops / PEAK_FLOPS[torch.float32]
            rows.append({"n": n, "size": size,
                         **{k: min(v) for k, v in t.items()},
                         "bound_ms": 1e3 * max(
                             nbytes / PEAK_BYTES,
                             ops / PEAK_FLOPS[torch.float32]),
                         "bound_by": "bytes" if by_bytes else "operations",
                         "mbytes": nbytes / 1e6, "gop": ops / 1e9})
    emit({"phase": "times_lloyd", "card": smi, "rows": rows})

    serving = []
    with torch.inference_mode():
        for dt in DTYPES:
            x = torch.from_numpy(requests[0]).cuda()
            torch.cuda.reset_peak_memory_stats()   # this dtype's forwards
            fwd_ms = cuda_ms(lambda: preds[dt].predict(x), iters=5)
            t0 = time.perf_counter()
            for req in requests:
                preds[dt](req)
            req_ms = 1e3 * (time.perf_counter() - t0) / len(requests)
            serving.append({"dtype": DT_NAME[dt], "batch": BATCH,
                            "decoder_ids": list(OPTIMAL),
                            "forward_ms": fwd_ms,
                            "img_per_s": BATCH * 1e3 / fwd_ms,
                            "enqueue_ms": enqueue_ms(
                                lambda: preds[dt].predict(x)),
                            "request_ms": req_ms,
                            "request_img_per_s": BATCH * 1e3 / req_ms,
                            "peak_mem_gb":
                                torch.cuda.max_memory_allocated() / 1e9})
        emit({"phase": "times_serve_optimal", "card": smi, "rows": serving})
        x = torch.from_numpy(requests[0]).cuda()
        prof = [{"path": "serve_optimal_forward", "dtype": DT_NAME[dt],
                 **profile_window(lambda: preds[dt].predict(x), 3)}
                for dt in DTYPES]
    emit({"phase": "profile_optimal", "card": smi, "rows": prof})
    return rows


def _totals(rows):
    """Float32 (the default compute dtype) sums over the six S=57 layers."""
    f32 = [r for r in rows if r["dtype"] == "float32"]
    return {k: sum(r[k] for r in f32)
            for k in ("ms", "plain_ms", "library_ms", "bound_ms")}


# One PyTorch call computing each backward kernel's product (its library
# time); K1's function has none.
BWD_LIBRARY = {
    "bwd_recompute": None,
    "bwd_dx": "torch.mm(dz, w1 as [C_mid, C_in])",
    "bwd_dw1": "torch.mm(dz^T, x), output in the compute dtype",
    "bwd_dw2": "torch.nn.grad.conv2d_weight(r, g), output in the compute "
               "dtype",
}


def kernels_line(checks, bwd_checks, time_rows, bwd_rows, serve_launches,
                 per_forward, train_launches, lloyd_checks, lloyd_rows,
                 optimal_launches):
    """One entry per ported kernel.  Headline numbers of the sandwich
    kernels are float32, summed over the six S=57 layers of one forward or
    one backward at batch 16; B4's are summed over the three launches of
    one batch-16 optimal-set forward; per-shape rows follow.  ``launches``
    adds the counts of the main paths' runs: the served requests of both
    configurations and the train steps."""
    src = "md_rdm_tpu/kernels/"
    fwd, bwd = _totals(time_rows), _totals(bwd_rows)
    lloyd = {k: sum(r[k] for r in lloyd_rows)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    b1_optimal = optimal_launches["dense_sandwich"]
    b4 = optimal_launches["fused_comparison_quantize"]
    bwd_entries = []
    for name in BWD_STAGES:
        f32 = [r["kernels"][name] for r in bwd_rows
               if r["dtype"] == "float32"]
        tot = {k: (sum(r[k] for r in f32)
                   if all(r[k] is not None for r in f32) else None)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        gflop = sum(r["gflop"] for r in f32)
        mbytes = sum(r["mbytes"] for r in f32)
        bwd_entries.append({
            "name": name,
            "route": "cuda",
            "source": "md_rdm_tpu_torch/csrc/dense_sandwich_bwd.cu",
            "replaces": src + "dense_sandwich.py:245",
            "also_replaces": [
                src + "dense_sandwich.py:542 (_bwd_kernel_flat)",
                src + "dense_sandwich_nhwc.py:168 (_bwd_kernel)"],
            "launches": train_launches[name],
            "launches_per_step": train_launches[name] // (
                TRAIN_STEPS * len(DTYPES)),
            "max_abs_err": max(c["stages"][name]["max_abs_err"]
                               for c in bwd_checks
                               if c["dtype"] == "float32"),
            **tot,
            "bound_by": ("operations" if gflop * 1e9 / PEAK_FLOPS[
                torch.float32] >= mbytes * 1e6 / PEAK_BYTES else "bytes"),
            "library": BWD_LIBRARY[name],
            "headline": "float32, sum over the six S=57 layers, batch 16; "
                        "K2-K4 fed the plain K1 outputs",
            "shapes": [{"c_in": r["c_in"], "dtype": r["dtype"],
                        **r["kernels"][name]} for r in bwd_rows],
        })
    bwd_entries[0]["backward"] = {
        **bwd,
        "library": "torch.autograd.grad through the cuDNN sequence "
                   "(z saved, not recomputed)",
        "headline": "float32, the four kernels composed, sum over the six "
                    "S=57 layers, batch 16",
        "shapes": [{k: v for k, v in r.items() if k != "kernels"}
                   for r in bwd_rows],
        "checks": bwd_checks,
    }
    return {"kernels": [{
        "name": "dense_sandwich",
        "route": "cuda",
        "source": "md_rdm_tpu_torch/csrc/dense_sandwich.cu",
        "replaces": src + "dense_sandwich.py:131",
        "also_replaces": [src + "dense_sandwich.py:452 (_kernel_flat)",
                          src + "dense_sandwich_nhwc.py:65 (_kernel)"],
        "launches": serve_launches + train_launches["forward"] + b1_optimal,
        "launches_serve": serve_launches,
        "launches_train": train_launches["forward"],
        "launches_serve_optimal": b1_optimal,
        "launches_per_forward": per_forward,
        "max_abs_err": max(c["max_abs_err"] for c in checks
                           if c["dtype"] == "float32"),
        **fwd,
        "bound_by": "operations",
        "library": "sequence: F.conv2d 1x1, affine, ReLU, F.conv2d 3x3",
        "headline": "float32, sum over the six S=57 layers, batch 16",
        "shapes": time_rows,
        "checks": checks,
    }, *bwd_entries, {
        "name": "fused_comparison_quantize",
        "route": "cuda",
        "source": "md_rdm_tpu_torch/csrc/lloyd.cu",
        "replaces": src + "lloyd.py:34",
        "launches": b4,
        "launches_per_forward": b4 // (4 * len(DTYPES)),
        "max_abs_err": max(c["max_abs_err"] for c in lloyd_checks),
        **lloyd,
        "bound_by": "bytes",
        "library": "comparison_cross_scale, torch.bucketize, level gather",
        "headline": "sum over the three launches of one batch-16 "
                    "optimal-set forward (N = 16, 64, 256)",
        "shapes": lloyd_rows,
        "checks": lloyd_checks,
    }]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import md_rdm_tpu_torch  # noqa: F401  (fails outside the repository)
    smi = phase_device()
    phase_build()
    if "--backward-only" in sys.argv[1:]:
        phase_kernel_bwd()
        phase_times_bwd(smi)
        return 0
    checks = phase_kernel()
    bwd_checks = phase_kernel_bwd()
    lloyd_checks = phase_kernel_lloyd()
    preds, requests, serve_launches, per_forward = phase_serve()
    opt_preds, opt_requests, optimal_launches = phase_serve_optimal()
    states, batch, train_launches = phase_train()
    time_rows = phase_times(preds, requests, smi)
    bwd_rows = phase_times_bwd(smi)
    phase_times_train(states, batch, smi)
    phase_profile(preds, requests, states, batch, smi)
    lloyd_rows = phase_times_optimal(opt_preds, opt_requests, smi)
    emit(kernels_line(checks, bwd_checks, time_rows, bwd_rows,
                      serve_launches, per_forward, train_launches,
                      lloyd_checks, lloyd_rows, optimal_launches))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
