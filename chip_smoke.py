#!/usr/bin/env python3
"""Smoke run of the PyTorch port (md_rdm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each:
  1. device     - the card's name and power limit (nvidia-smi), torch's name;
  2. build      - compiles every kernel of the serving and train paths from
                  csrc/, one nvcc per source, and the host resize library
                  (csrc/host_ops.cc, g++), all at once;
  3. kernel     - the three forward kernels (F1 expand, F2 taps, F3
                  tapsum), each against its plain stage fed the plain
                  output of the stage before, then composed against the
                  plain sandwich, at every S=57 layer, the first, a
                  middle and the last layer of the S=29 and S=15 blocks
                  and three layers of the decoders' S=8 block (C_in
                  1,056, 1,584, 2,160), batch 1 and 16, float32 and
                  bfloat16, TF32 off, with F1's and F2's split of K as
                  the rule picks it; two
                  calls and the captured call bit-equal;
  4. kernel_bwd - the four backward kernels (K1 recompute, K2 dx, K3 dw1,
                  K4 dw2), each against its plain stage fed the plain K1
                  outputs, then the composed backward against the plain
                  backward, at the same layers but S=8's (whose backward
                  runs no kernel), batch 16, both dtypes;
                  the autograd Function's gradients against autograd
                  through the plain forward at the first and last;
  5. serve      - Predictor(ModelConfig()) with seeded random weights answers
                  4 requests of batch 16 in float32 and in bfloat16, under
                  PyTorch's default TF32 settings (the model turns TF32 off
                  for itself); each forward kernel must launch once per
                  routed layer per forward;
                  then the same weights on the CPU (plain versions) against
                  the card's float32 run on a batch of 2;
  6. train      - DepthTrainer(Config()) from seeded weights takes 3 steps
                  of batch 16 in float32 and 3 in bfloat16 on synthetic
                  data; each step must launch each forward and each
                  backward kernel once per routed layer; then one
                  float32 step of batch 2 on the card against the CPU port;
  7. times      - the forward per S=57 layer (composed and per kernel,
                  plain, bound, the cuDNN sequence, transient peak
                  memory); F1 and F2 per dense block (the decoders' too)
                  at batch 1 and 16,
                  split as the rule picks and unsplit; the backward per
                  layer (composed and per kernel, plain, bound, library,
                  transient peak memory); serving forward and train step
                  time, img/s and the host time to enqueue;
  8. profile    - device busy share and top kernels of the served forward
                  and of one train step, from torch.profiler;
  9. kernel_lloyd  - the fused comparison + quantization kernel (B4)
                  against its plain version on the card and the CPU port,
                  bit for bit: one launch over the three segments of a
                  batch-16 optimal-set forward (maps of 16/32/64, 336
                  pages), one over decoder 10's (128, 1,024 pages), and
                  the one-segment entry on pages at N = 16/64/256/1024;
                  seeded inputs with negatives, zeros, NaN, +-inf, -0.0
                  and ratios exactly on thresholds;
  10. serve_optimal - Predictor(ModelConfig(decoder_ids=(1, 6, 7, 8, 9),
                  fusion_eps=1e-2)) with seeded random weights answers 4
                  requests of batch 16 in float32 and in bfloat16; each
                  forward must launch each B1 kernel once per routed
                  layer and B4 once
                  and give
                  finite maps; then the card's float32 run against the CPU
                  port on a batch of 2, stage by stage (maps, quantized
                  matrices, ALS fills, final map);
  11. times_optimal - B4's one launch per forward (with a store-only fill
                  of its output's size) and the one-segment entry per page
                  count (kernel, plain, bucketize + gather, bound); the
                  optimal-set forward per
                  dtype (CUDA events, img/s, host enqueue) and its
                  profile;
  12. train_optimal - DepthTrainer on the optimal set (fusion_eps 1e-2)
                  from seeded weights: 3 steps of batch 16 per dtype, each
                  launching each B1 and backward kernel once per routed
                  layer and B4
                  once, with finite losses and exact zero gradients for
                  the relative decoders; step time, img/s, host enqueue,
                  peak memory and idle share per dtype; then one float32
                  step of batch 2 on the card against the CPU port
                  (train_optimal_vs_cpu);
  13. loop      - Trainer.fit on the optimal set in float32 under a
                  temporary run directory: warm-up, 2 epochs of 4 synthetic
                  batches of 16, validation on 24 samples at batch 16, top-1
                  checkpoints, plateau patience 0; the run's files,
                  Predictor.from_checkpoint against the best epoch's
                  weights bit for bit, Trainer.restore; the loop's step
                  time against the bare step, checkpoint bytes and save
                  seconds;
  14. cli       - the entry points a user starts, through main(argv) in
                  this process: cli.train on the live model in float32
                  (synthetic, 64 images, batch 16: a warm-up and 4 steps,
                  each launching each forward and backward kernel once
                  per routed layer, and one val forward launching each
                  forward kernel once per routed layer), its run
                  directory and checkpoint; cli.evaluate
                  on that checkpoint (96 images, a grid PNG checked by its
                  header, best.txt, images/s over the warm batches), and
                  on 2 images on the card against the same command on the
                  CPU (metric averages and maps); cli.train --dev on
                  the optimal set in bfloat16 (1 B4 launch per step and
                  per val forward); the CLI's step time against the bare
                  step of times_train;
  15. augment   - on-device augmentation: the host resize library built
                  from csrc/host_ops.cc (its C++ against its numpy version
                  on a 480 x 640 frame); the augmentation of batch 16 of
                  raw (250, 333) uint8 and float32 on the card against the
                  CPU port on the same factors (max abs 1e-5, mask flips
                  only within 1e-4 of the frame's edge), its time and host
                  enqueue; host ms and wire bytes per batch of 16 of the
                  host recipe and of the raw path over the same frames;
                  cli.train --augment device on the live model in float32
                  (synthetic, 64 images, batch 16: a warm-up and 4 steps of
                  raw uint8 batches, each step launching each forward and
                  backward kernel once per routed layer), its step time
                  against the bare
                  step and the --augment host step of cli; one augmented
                  batch-2 step against the CPU port (loss terms); the
                  live model with growth_matmul="on_all" against the
                  default (encoder features, maps) and the S=29 / 15
                  blocks timed both ways;
  16. distributed - data-parallel training (core/mesh.py): Trainer on
                  the live model in float32, 3 steps of batch 16 in a
                  1-rank NCCL group against the same steps without a
                  group (the first step's gradients, running statistics,
                  parameters and losses; the parameters and statistics
                  after 3 steps; then 5 more steps of each, timed;
                  collectives and bytes per step); one float32 step of
                  batch 16 in 2 spawned ranks (NCCL on two cards, else
                  gloo with both on cuda:0) on the live model and on the
                  optimal set, each rank on 8 rows launching each B1 and
                  backward kernel once per routed layer (and B4 once),
                  held against the
                  1-process step on the 16 rows; the live 2-rank step
                  again with each planted fault (BatchNorm on each
                  rank's rows alone; gradients left unaveraged), each of
                  which must fail a bar; cli.train --dev under
                  torch.distributed.run (one process per card): one run
                  directory, one checkpoint, launches per rank;
  17. routing   - (run after phase 11) ModelConfig.fused_dense at the
                  S=29 and S=15 blocks, batch 16, per dtype: each block's
                  sandwiches timed as one call over its layers (kernels,
                  plain, cuDNN; forward and backward, against the
                  block's bound) and norm2's batch statistics per layer
                  in both forms; the whole block per mode (eval forward
                  off / on_all, train forward + backward off / on_all /
                  on_all_bwd); the decoders' S=8 block (24 layers, C_in
                  1,056) in eval at batch 1 and 16, routed against
                  unrouted as device time of captured launches, its
                  launches and its output against the unrouted block's;
                  the tables those times call for
                  against the port's; then (routing_model) the live
                  model served and trained under off, on (the tables)
                  and on_all_bwd: launches per forward and step (54 of
                  each kernel under on_all_bwd, none under off), ms,
                  img/s, enqueue, the first forward's seconds and
                  resident memory; the card against the CPU port under
                  on_all_bwd (a batch-2 map and a batch-2 float32 step).
  18. flat      - (run after phase 16) ModelConfig.flat_block and
                  ModelConfig.remat: F3 writing into a 48-channel slot of
                  a block buffer (S=57, C_final 384; S=15, C_final 2,112)
                  and K1 / K4 reading the cotangent from such a slot,
                  against the same kernels' contiguous launches (bit for
                  bit; the atomically summed outputs within 1e-5), and
                  composed against the plain versions, with their times;
                  each encoder block (S=57 / 29 / 15, batch 16, per dtype)
                  flat (_FlatBlock) against unflat under on_all_bwd:
                  one train call held (outputs, gradients, running
                  statistics), then eval and train timed with enqueue and
                  device operations and busy time per call, and the flat
                  sizes of models/routing.py checked against the
                  sizes flat won or lost by over FLAT_TIE in every turn;
                  then (remat) the live train
                  step with remat off and on per dtype: launches (equal),
                  peak memory at batch 16 and 32, gradients and running
                  statistics against remat off, step ms and enqueue;
                  then (flat_model) the live model with flat_block on_all
                  served and trained per dtype, its counts set to 0
                  before and read after: every forward kernel once per
                  layer with F3 strided each time, every backward kernel
                  once per layer with K1 and K4 strided each time, its map
                  and losses against the unflat model.
  19. graph     - (run last, in a process of its own: see graph_in_child)
                  the port's counterpart of jax.jit
                  (core/graphs.py), captured against eager on the same
                  weights and inputs: Predictor (live and optimal, both
                  dtypes, batch 16) against capture=False, every call's
                  output (bit for bit, else GRAPH_SERVE_TOL) and launches
                  (a replay's kernels traced); Trainer's steps (live and
                  optimal, both dtypes, remat on; the live model's with
                  remat off too) against capture=False, 3 steps of batch
                  16 from the same weights and batches, each from the
                  captured state, logs, parameters, running statistics
                  (FLOOR_FACTOR x a second eager state's floor, never
                  under TRAIN_TOL) and launches per step (the third a
                  replay, traced); the eval step likewise; the captured
                  live step's memory at batch 16 and 32; on the live
                  float32 step set_lr between replays (against an eager
                  step at the new lr, and one at the old that must miss
                  the bar) and Trainer.restore (the replays after it
                  against eager steps from the same checkpoint); three
                  --augment device steps on the same factors; Trainer.fit
                  as in phase 13, without checkpoints; cli.evaluate on a
                  checkpoint of the seeded live model, captured and eager
                  (averages, maps, launches, images/s).  Times
                  (eager and captured in turns: CUDA events, img/s, host
                  enqueue, idle share, the host operations that take the
                  most host time; the train steps with remat on), each
                  graph pool's bytes and the peak memory of a call.
  20. wsm       - (run after phase 11) each WSM stage of an optimal-set
                  forward (stages 1-3) at batch 16 in float32, TF32 off:
                  its matrix products (models/wsm.py) against the cuDNN
                  sequence they replace (library_wsm): the output
                  (WSM_TOL), captured device time in turns (ms,
                  library_ms) beside the bound, the peak memory an eager
                  call adds, the counters wsm.gemm and wsm.gemm.kxk; each
                  part (input adjustment, transposed conv, 1x1 branches,
                  3x3, 5x5, strips) timed both ways beside its bound; the
                  3x3 and 5x5 in both forms (tap products, cuDNN on the
                  contiguous channels-last columns) and the form
                  TAP_SHAPES gives the shape.
Phases 5, 10, 13-15, 17 and 18 serve through Predictor and train through
Trainer on their defaults, so on the card their forwards and loop steps
are captured too.  A kernel's wrapper counts a launch where it runs (a
call run eagerly or into a capture), never on a replay, which runs no
Python: each call of a main path is held to its path's launches where it
ran the path's Python and to none where it replayed a graph (REPLAYS
counts the replays), and a replay's kernels are counted by name in a
profiler trace (traced_launches) and held against an eager call's
launches: in phases 5 and 10 after their requests, and in phase 19 for
the configurations of phases 13-15 (the Trainer's steps, eval step and
cli.evaluate's forward).
DepthTrainer's steps (phases 6, 12, 17's train steps, 18's remat steps)
stay eager, as the JAX package's module functions are not jitted;
phase 16 compares eager steps (the group's collectives are not
captured).
A "routed layer" is one that models/routing.py's Routing.launches takes
for the phase's fused_dense and flat_block modes, dtype and mode of the
step (F1-F3; with its backward, K1-K4); every phase derives its
expected launches from that (routed_layers) and checks them exactly.
Then one {"kernels": [...]} line, the card's name and power limit on a line
of their own, and the closing {"ok": true, ...} line.  Every failed check
raises, so the script exits non-zero without the closing line.  It needs a
CUDA card and the repository beside it; it never falls back to the CPU.
``--forward-only`` runs phases 1, 2, 3 and the forward times,
``--backward-only`` phases 1, 2, 4 and the backward times,
``--lloyd-only`` phases 1, 2, 9 and B4's times,
``--train-optimal-only`` phases 1, 2, 12 and 13, ``--cli-only``
phases 1, 2 and 14 (with no bare step to compare the CLI's with), and
``--augment-only`` phases 1, 2 and 15 (likewise), ``--distributed-only``
phases 1, 2 and 16, ``--routing-only`` phases 1, 2, 3 at the S=29, S=15
and S=8 layers only, 4 at the S=29 and S=15 layers, and 17,
``--flat-only`` phases 1, 2 and 18,
``--graph-only`` phases 1, 2 and 19, ``--wsm-only`` phases 1, 2 and 20,
``--split-only`` phases 1, 2, 3,
the split sweep (F1 and F2 timed at every split of K the rule may take,
at three layers of each encoder block and of the decoders' block,
``phase_split_sweep``) and the forward times; they
stop without the closing line (for
work on one part).  ``--distributed-cli-rank <dir> -- <flags>`` is one
rank of phase 16's cli.train run, started by torch.distributed.run.
"""
from __future__ import annotations

import contextlib
import gc
import io
import json
import os
import struct
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
BATCH = 16
# Normalized L2 error of the forward kernels against their plain versions,
# each stage alone and composed.  float32: both accumulate in float32 (the
# kernels in another order), TF32 is off.  bfloat16: the kernels round r to
# bfloat16 once, after the affine; the plain sandwich rounds the 1x1 output
# to bfloat16 before the affine too, and both sum 2736 bfloat16 products in
# other orders.  F1's r is held like K1's (MASK_FLIP_R below).
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
# One float32 train step, card against CPU port, batch 2.  The loss terms
# and running statistics are held to fixed bars.  The gradients are not:
# a ReLU input within rounding of 0 takes the other branch under another
# summation order, and through 78 train-mode BatchNorms the float32
# gradient moves by 1-2% between two orders on the CPU alone (one
# thread against the default); on some batches the head's gradients
# move by 3.3e-3 so too.  The card's gradients (the whole model's and
# the head's) and updated parameters are held to FLOOR_FACTOR times that
# floor, measured in the run, and never looser than the fixed bars.
TRAIN_TOL = {"loss": 1e-4, "head_grads": 1e-4, "grads": 1e-3,
             "params": 1e-5, "stats": 1e-4}
FLOOR_FACTOR = 5
TRAIN_STEPS = 3
# Published H100 SXM peaks (NVIDIA data sheet, dense).
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
# The live encoder's dense blocks: (S, layers, C_in of the first layer);
# each layer's C_mid is 48 * S.
ENCODER_BLOCKS = ((57, 6, 96), (29, 12, 192), (15, 36, 384))
# C_in of the six S=57 layers.
S57_LAYERS = tuple(96 + 48 * i for i in range(6))
# The first, a middle and the last layer of the S=29 and S=15 blocks, the
# routing phase's checks.
ROUTING_SHAPES = ((29, 192), (29, 432), (29, 720),
                  (15, 384), (15, 1200), (15, 2064))
# The dense block every decoder opens with: (S, layers, C_in of the first
# layer); bn_size 8, so its C_mid is 48 * S too.
DECODER_BLOCK = (8, 24, 1056)
# Its first, twelfth and last layer: the S=8 kernel checks and split rows.
DECODER_SHAPES = ((8, 1056), (8, 1584), (8, 2160))
# Kernel-check shapes (S, C_in), forward: every S=57 layer, ROUTING_SHAPES
# and DECODER_SHAPES; backward: all but the S=8 layers, whose backward
# runs no kernel (the kernels take any C_in that is a multiple of 48 from
# 96, so the backward runs at the last layers' 720 and 2,064 too).
BWD_SHAPES = tuple((57, c) for c in S57_LAYERS) + ROUTING_SHAPES
CHECK_SHAPES = BWD_SHAPES + DECODER_SHAPES
DTYPES = (torch.float32, torch.bfloat16)
# The authors' optimal decoder set, served with the fusion floor its
# ModelConfig comment recommends (a faithful tail turns non-positive
# values into NaN).
OPTIMAL = (1, 6, 7, 8, 9)
OPTIMAL_EPS = 1e-2
# B4's one-segment shapes: (pages N, Lloyd table size); the first three
# are the pages of one batch-16 optimal-set forward (d7, d8, d9), the last
# decoder 10's.
LLOYD_SHAPES = ((BATCH, 16), (4 * BATCH, 32), (16 * BATCH, 64),
                (64 * BATCH, 128))
# B4's segments (map sizes) in one optimal-set forward (d7, d8, d9), and
# decoder 10's
LLOYD_FORWARD = (16, 32, 64)
LLOYD_D10 = (128,)
DT_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def routed_layers(train: bool, dt=torch.float32, mode: str = "auto",
                  bwd: bool = False, flat: str = "auto",
                  decoders: int = 1) -> int:
    """Dense layers of one call of a model with ``decoders`` decoders (the
    live model: 1) that launch each forward kernel (with ``bwd``: each
    backward kernel) under ``ModelConfig.fused_dense`` ``mode`` and
    ``ModelConfig.flat_block`` ``flat``, in eval or train: the launches
    each phase expects, derived from the port's routing
    (``Routing.launches``)."""
    from md_rdm_tpu_torch.models.routing import Routing
    r = Routing(mode, flat)
    blocks = [(s, n) for s, n, _ in ENCODER_BLOCKS]
    blocks.append((DECODER_BLOCK[0], DECODER_BLOCK[1] * decoders))
    return sum(n for s, n in blocks if r.launches(s, train, dt, bwd))


# the script's start: each phase's line carries its time since (t_s)
STARTED = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - STARTED}
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


def graph_ms(fn, iters: int, reps: int = 3) -> float:
    """Device time of one ``fn()`` from ``iters`` calls captured as one
    CUDA graph, the least of ``reps`` timed replays: what the served
    forward's replay pays, without the host's launch time, which a small
    kernel's eager calls would measure instead."""
    fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    del graph
    return best


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


def sandwich_inputs(s: int, c_in: int, dt: torch.dtype, seed: int,
                    batch: int = BATCH):
    """Layer inputs on the card: x >= 0 (after norm1 + ReLU), weights at
    1/sqrt(fan_in) scale, a folded-BN affine near identity."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    c_mid = 48 * s
    dev = "cuda"
    x = torch.randn(batch, s, s, c_in, generator=g, device=dev).relu_()
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
    """nvcc for each CUDA source and g++ for the host resize library, all
    started together."""
    import threading

    from md_rdm_tpu_torch.core import trace
    from md_rdm_tpu_torch.data import native
    from md_rdm_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    host = threading.Thread(target=native.available)
    host.start()
    _build.build(["dense_sandwich", "lloyd"])
    host.join()
    secs = time.perf_counter() - t0
    check(native.available(),
          f"host resize library not built: {native.BUILD_ERROR}")
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "smem" in ln]
             for n, log in _build.BUILD_LOG.items()}
    spans = trace.snapshot()["spans"]
    emit({"phase": "build", "seconds": secs, "ptxas": ptxas,
          "nvcc_s": {n: spans[f"kernel.build.{n}"]["total_s"]
                     for n in _build.BUILD_LOG},
          "host_library": native._target().name})


FWD_STAGES = ("fwd_expand", "fwd_taps", "fwd_tapsum")


def mask_flips(got, want, who):
    """ReLU mask flips between two r: positions where one is > 0 and the
    other not.  Each must have both values within MASK_FLIP_R of 0 (a
    rounding flip of a = z*scale+shift around 0).  Returns the flip mask
    and the largest |r| at a flip."""
    flip = (got > 0) != (want > 0)
    near = 0.0
    if flip.any():
        near = max(float(got[flip].float().abs().max()),
                   float(want[flip].float().abs().max()))
        check(near < MASK_FLIP_R,
              f"{who} ReLU mask differs away from a = 0 ({near})")
    return flip, near


def fwd_stage_checks(args, dt):
    """Each forward kernel against its plain stage on the card, F2 and F3
    fed the plain output of the stage before, so that each kernel is held
    alone.  Returns one row per kernel."""
    from md_rdm_tpu_torch.kernels import dense_sandwich as ds
    x, w1, scale, shift, w2 = args
    b, s = x.shape[:2]
    r = ds.fwd_expand_reference(x, w1, scale, shift)
    taps = ds.fwd_taps_reference(r, w2).view(b, s, s, ds.GK)
    pairs = {"fwd_expand": (ds.fwd_expand(x, w1, scale, shift), r),
             "fwd_taps": (ds.fwd_taps(r, w2).view(b, s, s, ds.GK), taps),
             "fwd_tapsum": (ds.fwd_tapsum(taps, dt),
                            ds.fwd_tapsum_reference(taps, dt))}
    torch.cuda.synchronize()
    rows = {}
    for name, (got, want) in pairs.items():
        check(got.shape == want.shape and got.dtype == want.dtype
              and bool(torch.isfinite(got).all()),
              f"{name} output {tuple(got.shape)} {got.dtype}")
        row = {"rel_l2": rel_l2(got, want), "max_abs_err": _max_abs(got, want)}
        if name == "fwd_expand":
            flip, near = mask_flips(got, want, name)
            row.update(mask_flips=int(flip.sum()), flip_max_abs_r=near)
        check(row["rel_l2"] < TOL[dt],
              f"{name} disagrees with its plain stage {row}")
        rows[name] = row
    return rows


def fwd_splits_of(x, c_mid: int) -> dict:
    """The blocks a tile F1 and F2 take for layer input ``x`` on this card
    (``dense_sandwich.card_splits``)."""
    from md_rdm_tpu_torch.kernels import dense_sandwich as ds
    b, s, _, c_in = x.shape
    p, i = b * s * s, x.device.index
    return {"fwd_expand": ds.card_splits(False, p, c_mid, c_in, x.dtype, i),
            "fwd_taps": ds.card_splits(True, p, ds.GK, c_mid, x.dtype, i)}


def replayed_equal(fn, want) -> bool:
    """Whether ``fn()`` captured (core.graphs: eager, capture and replay,
    replay) gives ``want`` bit for bit on both replays."""
    from md_rdm_tpu_torch.core.graphs import Graphs
    graphs = Graphs("cuda")
    outs = [graphs.run("sandwich", fn) for _ in range(3)]
    torch.cuda.synchronize()
    return all(torch.equal(o, want) for o in outs[1:])


def phase_kernel(shapes=CHECK_SHAPES, batches=(1, BATCH)):
    """Forward kernels against their plain stages and the plain sandwich,
    at batch 1 and 16; where F1 or F2 splits K (``splits``), two calls
    must be bit-equal and the captured call bit-equal to the eager one
    (``deterministic``, checked at every shape)."""
    from md_rdm_tpu_torch.core.device import no_tf32
    from md_rdm_tpu_torch.kernels.dense_sandwich import (
        dense_sandwich, dense_sandwich_reference, pack_weights,
        dense_sandwich_packed)
    rows = []
    with torch.inference_mode(), no_tf32():
        for batch in batches:
            for s, c_in in shapes:
                i = CHECK_SHAPES.index((s, c_in))
                for dt in DTYPES:
                    args = sandwich_inputs(s, c_in, dt, SEED + i, batch)
                    stages = fwd_stage_checks(args, dt)
                    got = dense_sandwich(*args)
                    want = dense_sandwich_reference(*args)
                    packed = pack_weights(*args[1:], dt)

                    def call():
                        return dense_sandwich_packed(args[0], packed)

                    again = call()
                    replayed = replayed_equal(call, again)
                    torch.cuda.synchronize()
                    check(got.shape == want.shape and got.dtype == dt,
                          f"kernel output {tuple(got.shape)} {got.dtype}")
                    err = rel_l2(got, want)
                    row = {"batch": batch, "s": s, "c_in": c_in,
                           "dtype": DT_NAME[dt], "rel_l2": err,
                           "tol": TOL[dt], "max_abs_err": _max_abs(got, want),
                           "splits": fwd_splits_of(args[0], 48 * s),
                           "deterministic": bool(torch.equal(got, again)),
                           "replay_equal": replayed, "stages": stages}
                    rows.append(row)
                    check(bool(torch.isfinite(got).all()), f"non-finite {row}")
                    check(err < TOL[dt], f"kernels disagree with plain {row}")
                    check(row["deterministic"] and replayed,
                          f"forward not bit-equal call to call {row}")
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
    flip, _ = mask_flips(kr, r, "bwd_recompute")
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


def phase_kernel_bwd(shapes=BWD_SHAPES):
    from md_rdm_tpu_torch.core.device import no_tf32
    from md_rdm_tpu_torch.kernels.dense_sandwich import (
        dense_sandwich, dense_sandwich_bwd, dense_sandwich_bwd_reference,
        dense_sandwich_reference)
    rows, fn_rows = [], []
    with no_tf32():
        for s, c_in in shapes:
            i = BWD_SHAPES.index((s, c_in))
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
        # through the plain forward, at the first and the last layer checked
        for (s, c_in), dt in ((shape, dt) for shape in dict.fromkeys(
                (shapes[0], shapes[-1])) for dt in DTYPES):
            args, gy = bwd_inputs(s, c_in, dt, SEED + 90)
            leaves = [a.clone().requires_grad_() for a in args]
            got = torch.autograd.grad(dense_sandwich(*leaves), leaves, gy)
            want = torch.autograd.grad(dense_sandwich_reference(*leaves),
                                       leaves, gy)
            row = {"s": s, "c_in": c_in, "dtype": DT_NAME[dt],
                   "tol": FN_TOL[dt]}
            row.update({n: rel_l2(a, b)
                        for n, a, b in zip(GRAD_NAMES, got, want)})
            fn_rows.append(row)
            check(all(row[n] < FN_TOL[dt] for n in GRAD_NAMES),
                  f"autograd Function disagrees with plain autograd {row}")
    emit({"phase": "kernel_bwd", "checks": rows, "function": fn_rows})
    return rows


def fwd_counters():
    """The forward's launch counters: dense_sandwich counts one per
    sandwich call, each of F1-F3 its own launches."""
    from md_rdm_tpu_torch.kernels.dense_sandwich import (FWD_KERNELS,
                                                         dense_sandwich)
    return (dense_sandwich,) + FWD_KERNELS


def counts(fns, counter: str = "launches") -> dict:
    """The registry's ``kernel.<name>.<counter>`` of each wrapper."""
    from md_rdm_tpu_torch.core import trace
    got = trace.snapshot()["counters"]
    return {fn.__name__: got.get(f"kernel.{fn.__name__}.{counter}", 0)
            for fn in fns}


def reset_counts(fns, counter: str = "launches") -> None:
    from md_rdm_tpu_torch.core import trace
    for name, n in counts(fns, counter).items():
        trace.count(f"kernel.{name}.{counter}", -n)


def since(fns, before: dict) -> dict:
    return {k: v - before[k] for k, v in counts(fns).items()}


# Graph replays so far (core.graphs.CudaGraph.replay, counted from main()'s
# start).  A wrapper counts a launch where it runs: eagerly, or into a
# capture.  A replay runs the captured kernels with no Python, so its
# wrappers count nothing; its kernels are counted by name in a profiler
# trace of the device (traced_launches).
REPLAYS = [0]
# the kernel each wrapper launches, as the profiler names it
KERNEL_SYMBOLS = {name: name for name in (
    "fwd_expand", "fwd_taps", "fwd_tapsum", "bwd_recompute", "bwd_dx",
    "bwd_dw1", "bwd_dw2")}
KERNEL_SYMBOLS["fused_comparison_quantize"] = "lloyd_kernel"


def count_replays() -> None:
    from md_rdm_tpu_torch.core.graphs import CudaGraph
    replay = CudaGraph.replay

    def counted(self):
        REPLAYS[0] += 1
        replay(self)

    CudaGraph.replay = counted


def call_launches(fns, call):
    """(``call()``, the launches of ``fns`` its wrappers counted, the graph
    replays it ran)."""
    before, replays = counts(fns), REPLAYS[0]
    out = call()
    return out, since(fns, before), REPLAYS[0] - replays


def ran_or_replayed(launches: dict, replays: int, want: dict) -> bool:
    """A call's counted launches against one call of its path: ``want``
    where the call ran the path's Python (eagerly, or into a capture, whose
    replay is then its work), none where it replayed a graph."""
    return launches == want or (replays > 0 and not any(launches.values()))


def kernel_counts(want: dict) -> dict:
    """``want`` without the counters that count no kernel (the sandwich
    call's: F1-F3 count its kernels)."""
    return {k: v for k, v in want.items() if k in KERNEL_SYMBOLS}


def traced_launches(fns, call):
    """(``call()``, the launches of the kernels among ``fns`` in it, counted
    by kernel name in a torch.profiler trace of the device, the graph
    replays it ran): what a replay launched, where the wrappers count
    nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    replays = REPLAYS[0]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = call()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    found = {}
    for fn in fns:
        sym = KERNEL_SYMBOLS.get(fn.__name__)
        if sym is not None:
            pat = re.compile(rf"::{sym}[<(]")
            found[fn.__name__] = sum(1 for n in names if pat.search(n))
    return out, found, REPLAYS[0] - replays


def _finite_rel(got: np.ndarray, want: np.ndarray):
    fg, fw = np.isfinite(got), np.isfinite(want)
    check(np.array_equal(fg, fw), "non-finite positions differ")
    g, w = got[fw].astype(np.float64), want[fw].astype(np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def phase_serve():
    from md_rdm_tpu_torch.core.config import ModelConfig
    from md_rdm_tpu_torch.inference import Predictor
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
    fwd = fwd_counters()
    reset_counts(fwd)
    for dt in DTYPES:
        want = {fn.__name__: routed_layers(False, dt) for fn in fwd}
        for req in requests:
            t0 = time.perf_counter()
            (final, decode), per_fwd, replays = call_launches(
                fwd, lambda: preds[dt](req))
            secs = time.perf_counter() - t0
            check(ran_or_replayed(per_fwd, replays, want),
                  f"kernel launches in a forward {per_fwd}, {replays} "
                  f"replays")
            check(final.shape == (BATCH, 1, 128, 128), f"map {final.shape}")
            check(decode.shape == (BATCH, 1, 8, 8), f"decode {decode.shape}")
            served.append({"dtype": DT_NAME[dt], "seconds": secs,
                           "launches": per_fwd, "replays": replays,
                           "finite": float(np.isfinite(final).mean())})
    main_launches = counts(fwd)
    per_forward = {dt: next(r["launches"]["dense_sandwich"] for r in served
                            if r["dtype"] == dt) for dt in map(DT_NAME.get,
                                                               DTYPES)}
    replayed = served_replays(preds, requests, fwd, {
        dt: {fn.__name__: routed_layers(False, dt) for fn in fwd}
        for dt in DTYPES})

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
          "main_path_launches": main_launches, "replay_traced": replayed,
          "cpu_vs_card": {"final_rel_l2": err, "tol": SERVE_TOL,
                          "decode_mismatch_near_half": int((d_c != d_g).sum()),
                          "finite": float(np.isfinite(f_g).mean())}})
    return preds, requests, main_launches, per_forward


def served_replays(preds, requests, fns, want) -> dict:
    """One more served forward per dtype, a replay of the main path's
    graph, its kernels counted in a profiler trace and held against one
    forward's launches (``want[dt]``)."""
    out = {}
    with torch.inference_mode():
        for dt in DTYPES:
            x = torch.from_numpy(requests[0]).cuda()
            before = counts(fns)
            _, traced, replays = traced_launches(
                fns, lambda: preds[dt].predict(x))
            row = {"kernels": traced, "replays": replays,
                   "wrappers": since(fns, before)}
            out[DT_NAME[dt]] = row
            check(replays == 1 and not any(row["wrappers"].values())
                  and traced == kernel_counts(want[dt]),
                  f"a replayed forward launched {row}, want "
                  f"{kernel_counts(want[dt])}")
    return out


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
    launching each forward kernel and each backward kernel once per routed
    layer; then one
    float32 step of batch 2 on the card against the CPU port from the same
    weights."""
    from md_rdm_tpu_torch.core.config import Config, ModelConfig
    from md_rdm_tpu_torch.kernels.dense_sandwich import BWD_KERNELS
    from md_rdm_tpu_torch.training.module import DepthTrainer

    x, y = train_batch(BATCH, SEED + 3)
    xd, yd = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    states, steps = {}, []
    fwd = fwd_counters()
    reset_counts(fwd + BWD_KERNELS)
    for dt in DTYPES:
        trainer = DepthTrainer(Config(model=ModelConfig(
            compute_dtype=DT_NAME[dt])), device="cuda")
        state = trainer.init(seed=SEED)
        model = state.model
        params0 = _flat(p for p in model.parameters() if p.numel())
        stats0 = _flat(b for n, b in model.named_buffers() if "running" in n)
        for i in range(TRAIN_STEPS):
            f0, b0 = counts(fwd), counts(BWD_KERNELS)
            t0 = time.perf_counter()
            state, logs = trainer.train_step(state, xd, yd)
            logs = {k: float(v) for k, v in logs.items()}
            secs = time.perf_counter() - t0
            row = {"dtype": DT_NAME[dt], "step": i + 1, "seconds": secs,
                   "fwd_launches": since(fwd, f0),
                   "bwd_launches": since(BWD_KERNELS, b0),
                   "logs": logs}
            steps.append(row)
            check(all(np.isfinite(v) for v in logs.values()),
                  f"non-finite log {row}")
            check(set(row["fwd_launches"].values())
                  == {routed_layers(True, dt)}
                  and set(row["bwd_launches"].values())
                  == {routed_layers(True, dt, bwd=True)},
                  f"kernel launches per step {row}")
        params = _flat(p for p in model.parameters() if p.numel())
        stats = _flat(b for n, b in model.named_buffers() if "running" in n)
        check(state.step == TRAIN_STEPS, f"step count {state.step}")
        check(not torch.equal(params, params0), "parameters did not move")
        check(not torch.equal(stats, stats0), "running stats did not move")
        states[dt] = (trainer, state)
    launches = counts(fwd + BWD_KERNELS)
    # each dtype's backward launches a step, as measured (every step of a
    # dtype was checked to launch the same)
    per_step = {r["dtype"]: r["bwd_launches"] for r in steps}
    emit({"phase": "train", "steps": steps, "main_path_launches": launches,
          "cpu_vs_card": step_vs_cpu(ModelConfig(), SEED + 4)})
    return states, (xd, yd), launches, per_step


def step_vs_cpu(model_config, seed: int) -> dict:
    """One float32 step of batch 2 from the same seeded weights, card
    against the CPU port (at the default thread count, and single-threaded
    for the rounding floor): loss terms and running statistics at fixed
    bars, the head's and the whole model's gradients and the parameters at
    FLOOR_FACTOR times the CPU's own floor, never under the fixed bars;
    the DORN decode equal away from P = 0.5."""
    from md_rdm_tpu_torch.core.config import Config
    from md_rdm_tpu_torch.training.module import DepthTrainer

    x2, y2 = train_batch(2, seed)
    runs = {}
    threads = torch.get_num_threads()
    for name, dev, n_threads in (("cpu", "cpu", threads),
                                 ("cpu_1thread", "cpu", 1),
                                 ("cuda", "cuda", threads)):
        torch.set_num_threads(n_threads)
        trainer = DepthTrainer(Config(model=model_config), device=dev)
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
    floor = {k: rel_l2(c1[k], c[k]) for k in ("head", "grads", "params")}
    bars = {"stats": TRAIN_TOL["stats"],
            **{k: max(TRAIN_TOL[k], FLOOR_FACTOR * floor[k])
               for k in ("grads", "params")},
            "head": max(TRAIN_TOL["head_grads"],
                        FLOOR_FACTOR * floor["head"])}
    near = np.any(np.abs(c["probs"] - 0.5) < 1e-5, axis=1, keepdims=True)
    exact = (c["decode"] == g["decode"]) | near
    out = {"loss_rel": loss_rel, "rel_l2": errs, "cpu_floor_rel_l2": floor,
           "bars": bars, "cpu_threads": threads,
           "decode_mismatch_near_half": int((c["decode"]
                                             != g["decode"]).sum())}
    check(all(v < TRAIN_TOL["loss"] for v in loss_rel.values()),
          f"card vs CPU loss terms {out}")
    for k, bar in bars.items():
        check(errs[k] < bar, f"card vs CPU {k} relL2 {errs[k]} (bar {bar})")
    check(bool(exact.all()), f"train decode differs at "
                             f"{np.argwhere(~exact)[:5]}")
    return out


def phase_times_kernel(smi):
    """Per S=57 layer: the forward composed (its three kernels) against
    the plain sandwich and the cuDNN sequence, with the function's bound
    and the transient peak memory of one call; then each kernel fed the
    plain output of the stage before against its plain stage, its own
    bound and one PyTorch call computing the same product (F2 only).
    Then F1 and F2 per dense block at batch 1 and 16, split as the rule
    picks and unsplit (``split_block_times``), with the registry's split
    and launch counters of F1 and F2 so far."""
    from md_rdm_tpu_torch.core.device import no_tf32
    from md_rdm_tpu_torch.kernels import dense_sandwich as ds
    rows = []
    with torch.inference_mode(), no_tf32():
        for dt in DTYPES:
            for i, c_in in enumerate(S57_LAYERS):
                args = sandwich_inputs(57, c_in, dt, 100 + i)
                x = args[0]
                # laid out once, as the serving path's layers keep them
                packed = ds.pack_weights(*args[1:], dt)
                iters = 10 if dt == torch.float32 else 20
                kernel = lambda: ds.dense_sandwich_packed(x, packed)  # noqa
                t = time_turns({"": (
                    kernel, lambda: ds.dense_sandwich_reference(*args),
                    lambda: library_sandwich(*args))}, iters, warmup=2)[""]
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                y = kernel()
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - base
                del y
                c_mid = 57 * 48
                r = ds.fwd_expand_reference(*args[:4])
                taps = ds.fwd_taps_reference(r, args[4]).view(
                    BATCH, 57, 57, ds.GK)
                stages = time_turns({
                    "fwd_expand": (
                        lambda: ds.fwd_expand(*args[:4], packed.w1t),
                        lambda: ds.fwd_expand_reference(*args[:4]), None),
                    "fwd_taps": (
                        lambda: ds.fwd_taps(r, args[4], packed.w2n),
                        lambda: ds.fwd_taps_reference(r, args[4]),
                        lambda: torch.mm(r, packed.w2n)),
                    "fwd_tapsum": (
                        lambda: ds.fwd_tapsum(taps, dt),
                        lambda: ds.fwd_tapsum_reference(taps, dt), None),
                }, iters, ds.fwd_stage_work(BATCH, 57, c_in, c_mid,
                                            x.element_size()), dt)
                del r, taps
                rows.append({
                    "s": 57, "c_in": c_in, "dtype": DT_NAME[dt], **t,
                    **_bound(ds.sandwich_flops(BATCH, 57, c_in, c_mid),
                             ds.sandwich_bytes(BATCH, 57, c_in, c_mid,
                                               x.element_size()), dt),
                    "transient_peak_gb": peak / 1e9, "kernels": stages})
    blocks = [split_block_times(dt, batch) for batch in (1, BATCH)
              for dt in DTYPES]
    emit({"phase": "times_kernel", "card": smi, "rows": rows,
          "blocks": blocks,
          "split_counters": counts(ds.SPLIT_KERNELS, "split"),
          "launch_counters": counts(ds.SPLIT_KERNELS)})
    return rows


def split_block_times(dt, batch: int) -> dict:
    """F1 and F2 over every layer of each encoder dense block and of the
    decoders' (DECODER_BLOCK) at ``batch``, each kernel alone (F2 fed F1's
    r), with the blocks a tile the rule picks (``ms``) and unsplit
    (``unsplit_ms``, s = 1), in turns, device time of captured launches
    (``graph_ms``), summed over the block's layers; their bound, and the
    rule's splits per layer."""
    from md_rdm_tpu_torch.core.device import no_tf32
    from md_rdm_tpu_torch.kernels import dense_sandwich as ds
    out = {"batch": batch, "dtype": DT_NAME[dt], "blocks": []}
    with torch.inference_mode(), no_tf32():
        for s, n, c0 in ENCODER_BLOCKS + (DECODER_BLOCK,):
            c_mid = 48 * s
            tot = {k: {"ms": 0.0, "unsplit_ms": 0.0, "bound_ms": 0.0,
                       "splits": []} for k in ("fwd_expand", "fwd_taps")}
            iters = 20 if batch == 1 else 5
            for layer in range(n):
                c_in = c0 + 48 * layer
                args = sandwich_inputs(s, c_in, dt, 300 + layer, batch)
                packed = ds.pack_weights(*args[1:], dt)
                r = ds.fwd_expand(*args[:4], packed.w1t)
                work = ds.fwd_stage_work(batch, s, c_in, c_mid,
                                         args[0].element_size())
                split = fwd_splits_of(args[0], c_mid)
                calls = {
                    "fwd_expand": lambda k: ds.fwd_expand(
                        *args[:4], packed.w1t, splits=k),
                    "fwd_taps": lambda k: ds.fwd_taps(
                        r, args[4], packed.w2n, splits=k)}
                for name, fn in calls.items():
                    ms, unsplit = [], []
                    for _ in range(2):   # in turns
                        ms.append(graph_ms(lambda: fn(split[name]), iters))
                        unsplit.append(graph_ms(lambda: fn(1), iters))
                    row = tot[name]
                    row["ms"] += min(ms)
                    row["unsplit_ms"] += min(unsplit)
                    row["bound_ms"] += _bound(*work[name], dt)["bound_ms"]
                    row["splits"].append(split[name])
                del r
            out["blocks"].append({"s": s, "layers": n, **tot})
    return out


def phase_split_sweep(smi):
    """F1 and F2 at every blocks-a-tile s the rule may take (1 to
    MAX_CLUSTER, at least MIN_SLICE_K k tiles a slice, clusters the card
    holds), at the first, a middle and the last layer of each encoder
    dense block and of the decoders' (DECODER_SHAPES), batch 1 and 16,
    both dtypes: device time per s (``graph_ms``),
    each s's output against s = 1's (TOL) and two calls bit-equal, the
    card's clusters, the rule's modelled time and choice against the
    fastest measured.  The rule's constants (``dense_sandwich.ALONE``,
    ``SPLIT_COST``, ``MAX_CLUSTER``) are fitted to these rows."""
    from md_rdm_tpu_torch.core.device import no_tf32
    from md_rdm_tpu_torch.kernels import dense_sandwich as ds
    # (S, layer, C_in): three layers of each encoder block, and
    # DECODER_SHAPES
    layers = [(s, i, c0 + 48 * i) for s, n, c0 in ENCODER_BLOCKS
              for i in sorted({0, n // 2, n - 1})]
    s8, _, c8 = DECODER_BLOCK
    layers += [(s8, (c - c8) // 48, c) for _, c in DECODER_SHAPES]
    rows = []
    with torch.inference_mode(), no_tf32():
        for dt in DTYPES:
            for batch in (1, BATCH):
                for s, layer, c_in in layers:
                    c_mid = 48 * s
                    args = sandwich_inputs(s, c_in, dt, 400 + layer, batch)
                    packed = ds.pack_weights(*args[1:], dt)
                    r = ds.fwd_expand(*args[:4], packed.w1t)
                    p = batch * s * s
                    for name, taps, nn, k, fn in (
                            ("fwd_expand", False, c_mid, c_in,
                             lambda m: ds.fwd_expand(
                                 *args[:4], packed.w1t, splits=m)),
                            ("fwd_taps", True, ds.GK, c_mid,
                             lambda m: ds.fwd_taps(
                                 r, args[4], packed.w2n, splits=m))):
                        rows.append(sweep_row(ds, name, taps, fn, dt,
                                              batch, s, c_in, p, nn, k))
                    del r
    emit({"phase": "split_sweep", "card": smi, "rows": rows})
    return rows


def sweep_row(ds, name, taps, fn, dt, batch, s, c_in, p, n, k):
    tiles, kt = ds.product_tiles(p, n, k, dt)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 20 if batch == 1 else 5
    one = fn(1)
    ms, clusters, model = {}, {}, {}
    for m in range(1, max(1, min(ds.MAX_CLUSTER,
                                 kt // ds.MIN_SLICE_K)) + 1):
        c = ds.card_clusters(taps, m, dt, 0)
        if c <= 0:
            check(m > 1, f"{name}: the card holds no block")
            continue
        got, again = fn(m), fn(m)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"{name} s={m} not bit-equal")
        err = rel_l2(got, one)
        check(err < TOL[dt], f"{name} s={m} against s=1: {err}")
        clusters[m] = c
        model[m] = ds.split_time(tiles, kt, m, c, sms, dt)
        ms[m] = graph_ms(lambda: fn(m), iters)
    rule = ds.card_splits(taps, p, n, k, dt, 0)
    best = min(ms, key=ms.get)
    return {"kernel": name, "dtype": DT_NAME[dt], "batch": batch, "s": s,
            "c_in": c_in, "tiles": tiles, "k_tiles": kt, "sms": sms,
            "rule": rule, "best": best, "rule_over_best": ms[rule] / ms[best],
            "rule_over_unsplit": ms[rule] / ms[1], "ms": ms,
            "clusters": clusters, "model": model}


def phase_times_serve(preds, requests, smi):
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


def time_turns(fns, iters: int, work=None, dt=None, warmup: int = 1):
    """Each entry's (kernel, plain, library) calls timed in turns, twice,
    the lesser of the two kept: ms, plain_ms, library_ms (None where no
    library call is given); with ``work`` (name -> (operations, bytes)) the
    entry's bound too."""
    out = {}
    for name, (kernel, plain, lib) in fns.items():
        t = {"ms": [], "plain_ms": [], "library_ms": []}
        for _ in range(2):   # in turns: kernel, plain, library
            t["ms"].append(cuda_ms(kernel, iters, warmup))
            t["plain_ms"].append(cuda_ms(plain, iters, warmup))
            if lib is not None:
                t["library_ms"].append(cuda_ms(lib, iters, warmup))
        out[name] = {k: (min(v) if v else None) for k, v in t.items()}
        if work is not None:
            out[name].update(_bound(*work[name], dt))
    return out


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
    return time_turns(fns, iters, ds.bwd_stage_work(
        BATCH, 57, c_in, c_mid, x.element_size()), dt)


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


def profile_window(fn, reps: int, host_top: bool = False) -> dict:
    """torch.profiler over ``reps`` back-to-back calls of ``fn`` after one
    warm-up: device busy time (union of the kernels' and copies' intervals)
    against the window's wall time, device operations per call, and the
    kernels that take the most device time; with ``host_top`` the host
    operations that take the most host time of their own (``self``: the
    time in none of their children), per call."""
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
    extra = {}
    if host_top:
        rows = sorted((e for e in prof.key_averages()
                       if e.device_type == DeviceType.CPU),
                      key=lambda e: -e.self_cpu_time_total)[:8]
        extra["host_top"] = [{"name": e.key[:80], "per_call": e.count / reps,
                              "self_ms_per_call":
                              e.self_cpu_time_total / 1e3 / reps}
                             for e in rows]
    return {**extra, "calls": reps, "wall_ms_per_call": wall_us / 1e3 / reps,
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


# ----------------------------------------------------------------- routing ---
# The blocks whose routing the phase measures, and the fused_dense modes
# of its whole-model runs: none, the tables, every layer both ways.
ROUTING_BLOCKS = ENCODER_BLOCKS[1:]
ROUTING_MODES = ("off", "on", "on_all_bwd")
ROUTING_ITERS = 3


def _block_bound(flops_fn, bytes_fn, s: int, n: int, c0: int, dt,
                 batch: int = BATCH) -> dict:
    """A block's bound at ``batch``: the sum over its layers of each
    layer's bound (the larger of its operations over the peak and its
    bytes over the memory rate)."""
    rows = [_bound(flops_fn(batch, s, c, 48 * s),
                   bytes_fn(batch, s, c, 48 * s, dt.itemsize), dt)
            for c in range(c0, c0 + 48 * n, 48)]
    return {"bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": sorted({r["bound_by"] for r in rows}),
            "gflop": sum(r["gflop"] for r in rows),
            "mbytes": sum(r["mbytes"] for r in rows)}


def sandwich_block_times(s: int, n: int, c0: int, dt) -> dict:
    """The sandwiches of one block's n layers at batch 16, each timed as
    one call over the layers: the forward kernels (weights packed once, as
    the serving path keeps them) against the plain sandwich and the cuDNN
    sequence; the backward kernels against the plain backward and
    autograd through the cuDNN sequence (its graphs built once); each
    with the block's bound.  Then norm2's train-mode statistics forward
    and backward per layer: the port's covariance form
    (``conv_bn_stats``) against z materialized (:func:`stats_z`)."""
    from md_rdm_tpu_torch.kernels import dense_sandwich as ds
    layers = [bwd_inputs(s, c0 + 48 * i, dt, SEED + 300 + i)
              for i in range(n)]
    packed = [ds.pack_weights(*args[1:], dt) for args, _ in layers]

    def each(fn):
        return lambda: [fn(i) for i in range(n)]

    out = {"s": s, "layers": n, "dtype": DT_NAME[dt]}
    with torch.inference_mode():
        out["forward"] = {**time_turns({"": (
            each(lambda i: ds.dense_sandwich_packed(layers[i][0][0],
                                                    packed[i])),
            each(lambda i: ds.dense_sandwich_reference(*layers[i][0])),
            each(lambda i: library_sandwich(*layers[i][0])))},
            ROUTING_ITERS)[""], **_block_bound(
                ds.sandwich_flops, ds.sandwich_bytes, s, n, c0, dt)}
    leaves = [[a.clone().requires_grad_() for a in args]
              for args, _ in layers]
    graphs = [library_sandwich(*lv) for lv in leaves]
    out["backward"] = {**time_turns({"": (
        each(lambda i: ds.dense_sandwich_bwd(*layers[i][0], layers[i][1],
                                             packed[i].w1t)),
        each(lambda i: ds.dense_sandwich_bwd_reference(*layers[i][0],
                                                       layers[i][1])),
        each(lambda i: torch.autograd.grad(
            graphs[i], leaves[i], layers[i][1].permute(0, 3, 1, 2),
            retain_graph=True)))}, ROUTING_ITERS)[""], **_block_bound(
                ds.sandwich_bwd_flops, ds.sandwich_bwd_bytes, s, n, c0, dt)}
    del graphs
    stats = []
    for i, ((x, w1, *_), _) in enumerate(layers):
        xg, wg = x.clone().requires_grad_(), w1.clone().requires_grad_()
        row = {"c_in": x.shape[-1]}
        for form, fn in (("cov", ds.conv_bn_stats), ("z", stats_z)):
            def fwd_bwd():
                m, v = fn(xg, wg)
                torch.autograd.grad(m.sum() + v.sum(), (xg, wg))
            row[f"{form}_ms"] = cuda_ms(fwd_bwd, ROUTING_ITERS, warmup=1)
        row["faster"] = "cov" if row["cov_ms"] <= row["z_ms"] else "z"
        stats.append(row)
    out["stats"] = {
        "cov_ms": sum(r["cov_ms"] for r in stats),
        "z_ms": sum(r["z_ms"] for r in stats),
        "z_faster_layers": sum(r["faster"] == "z" for r in stats),
        "layers": stats}
    return out


def stats_z(x, w1):
    """norm2's train-mode statistics the other way, timed beside the
    port's ``conv_bn_stats`` (the covariance): z = x W materialized in
    float32 and reduced with ``var_mean``."""
    z = x.reshape(-1, x.shape[-1]).float() @ w1.reshape(
        w1.shape[0], -1).float().t()
    var, mean = torch.var_mean(z, 0, unbiased=False)
    return mean, var


def dense_block_times(s: int, n: int, c0: int, dt) -> dict:
    """One seeded dense block (randomized BatchNorm statistics) at batch
    16, timed as one call per fused_dense mode, in turns, twice, the
    lesser kept: the eval forward ("off": the cuDNN sequence; "on_all":
    the forward kernels) and the train forward + backward with the
    batch statistics ("off"; "on_all": the forward kernels, autograd's
    backward; "on_all_bwd": the backward kernels too)."""
    from md_rdm_tpu_torch.core.device import no_tf32
    from md_rdm_tpu_torch.models import densenet as tdn
    from md_rdm_tpu_torch.models.rdm import (init_parameters,
                                             randomize_batchnorm)
    from md_rdm_tpu_torch.models.routing import Routing
    base = tdn.DenseBlock(n, c0, s)
    init_parameters(base, SEED)
    randomize_batchnorm(base, SEED + 1)
    g = torch.Generator(device="cuda").manual_seed(SEED + 400 + s)
    h = torch.randn(BATCH, c0, s, s, generator=g, device="cuda").to(
        dt).contiguous(memory_format=torch.channels_last)
    hg = h.detach().requires_grad_()
    blocks = {}
    for mode in ("off", "on_all", "on_all_bwd"):
        blk = tdn.DenseBlock(n, c0, s, routing=Routing(mode, "off"))
        blk.load_state_dict(base.state_dict())
        blocks[mode] = blk.cuda()

    def train(blk):
        return lambda: blk(hg).float().square().mean().backward()

    t = {}
    with no_tf32():
        for _ in range(2):   # in turns
            for mode, blk in blocks.items():
                if mode != "on_all_bwd":   # the same eval forward as on_all
                    blk.eval()
                    with torch.no_grad():
                        t.setdefault(f"eval_ms_{mode}", []).append(
                            cuda_ms(lambda: blk(h), ROUTING_ITERS))
                blk.train()
                t.setdefault(f"train_ms_{mode}", []).append(
                    cuda_ms(train(blk), ROUTING_ITERS, warmup=1))
    out = {"s": s, "layers": n, "dtype": DT_NAME[dt],
           **{k: min(v) for k, v in t.items()}}
    out["eval_wins"] = out["eval_ms_on_all"] < out["eval_ms_off"]
    best = min(("off", "on_all", "on_all_bwd"),
               key=lambda m: out[f"train_ms_{m}"])
    out["train_best"] = best
    return out


@contextlib.contextmanager
def eval_routed(s: int):
    """The port's eval sizes with size ``s`` in them for both dtypes while
    the block runs: what ``fused_dense`` "on" does where ``s`` is in
    ``models/routing.py``'s ``MEASURED`` eval layers, measurable before it
    is."""
    from md_rdm_tpu_torch.models import routing as rt
    kept = rt.MEASURED
    rt.MEASURED = {(train, dt): sizes if train else sizes._replace(
        layers=sizes.layers | {s}) for (train, dt), sizes in kept.items()}
    try:
        yield
    finally:
        rt.MEASURED = kept


def decoder_block_times(dt) -> dict:
    """The decoders' dense block (DECODER_BLOCK: 24 layers, C_in 1,056,
    bn_size 8, S=8), seeded, randomized BatchNorm statistics, eval, at
    batch 1 and 16: the whole block routed (``fused_dense`` "on" with S=8
    in the eval table, :func:`eval_routed`: norm1 and ReLU, then F1-F3 per
    layer) against unrouted ("off": BatchNorm, ReLU, cuDNN's 1x1 and 3x3
    convolutions), each the device time of captured launches
    (``graph_ms``), in turns, the lesser of two kept; the launches of one
    routed call (each forward kernel once per layer; none unrouted) and
    the routed output against the unrouted one (FN_TOL: in bfloat16 the
    unrouted layer also rounds z before norm2)."""
    from md_rdm_tpu_torch.kernels import dense_sandwich as ds
    from md_rdm_tpu_torch.models import densenet as tdn
    from md_rdm_tpu_torch.models.rdm import (init_parameters,
                                             randomize_batchnorm)
    from md_rdm_tpu_torch.models.routing import Routing
    s, n, c0 = DECODER_BLOCK
    blocks = {}
    for mode in ("on", "off"):
        blk = tdn.DenseBlock(n, c0, s, routing=Routing(mode, "off"))
        init_parameters(blk, SEED)
        randomize_batchnorm(blk, SEED + 1)
        blocks[mode] = blk.cuda().eval()
    fwd = fwd_counters()
    rows = []
    for batch in (1, BATCH):
        g = torch.Generator(device="cuda").manual_seed(SEED + 500 + batch)
        h = torch.randn(batch, c0, s, s, generator=g, device="cuda").to(
            dt).contiguous(memory_format=torch.channels_last)
        iters = 20 if batch == 1 else 5
        with torch.inference_mode(), eval_routed(s):
            before = counts(fwd)
            routed = blocks["on"](h)
            launches = since(fwd, before)
            before = counts(fwd)
            plain = blocks["off"](h)
            unrouted_launches = since(fwd, before)
            t = {"routed": [], "unrouted": []}
            for mode in ("on", "off", "off", "on"):   # in turns
                t["routed" if mode == "on" else "unrouted"].append(
                    graph_ms(lambda: blocks[mode](h), iters))
        err = rel_l2(routed, plain)
        row = {"s": s, "layers": n, "c_in": c0, "batch": batch,
               "dtype": DT_NAME[dt], "routed_ms": min(t["routed"]),
               "unrouted_ms": min(t["unrouted"]), "turns_ms": t,
               "launches": launches, "rel_l2": err, "tol": FN_TOL[dt],
               **_block_bound(ds.sandwich_flops, ds.sandwich_bytes, s, n,
                              c0, dt, batch)}
        row["routed_over_unrouted"] = row["routed_ms"] / row["unrouted_ms"]
        rows.append(row)
        check(launches == {fn.__name__: n for fn in fwd}
              and not any(unrouted_launches.values()),
              f"decoder block: launches {launches} {unrouted_launches}")
        check(err < FN_TOL[dt], f"decoder block: routed against "
                                f"unrouted {row}")
    return {"dtype": DT_NAME[dt], "batches": rows,
            "eval_wins": all(r["routed_ms"] < r["unrouted_ms"]
                             for r in rows)}


def routing_model(smi) -> tuple:
    """The live ModelConfig() under each of ROUTING_MODES, per dtype:
    served forward and train step through Predictor and DepthTrainer,
    with the launches of one forward and one step (each as the routing
    says: 54 of each kernel under on_all_bwd, none under off), ms, img/s,
    host enqueue, the first forward's host seconds and the memory it
    leaves resident (the packed weights).  Then the card against the CPU
    port under on_all_bwd: a batch-2 served map and a batch-2 float32 train
    step.  Returns (rows, checks, launches)."""
    from md_rdm_tpu_torch.core.config import Config, ModelConfig
    from md_rdm_tpu_torch.inference import Predictor
    from md_rdm_tpu_torch.kernels.dense_sandwich import BWD_KERNELS
    from md_rdm_tpu_torch.models.rdm import (DepthEstimationNet,
                                             init_parameters,
                                             randomize_batchnorm)
    from md_rdm_tpu_torch.ops.decompose import recombination
    from md_rdm_tpu_torch.training.module import DepthTrainer

    model = DepthEstimationNet(ModelConfig())
    init_parameters(model, SEED)
    randomize_batchnorm(model, SEED + 1)
    sd = model.state_dict()
    del model
    req = np.random.default_rng(SEED + 14).random((BATCH, 226, 226, 3),
                                                  dtype=np.float32)
    x = torch.from_numpy(req).cuda()
    xt, yt = train_batch(BATCH, SEED + 3)
    xd, yd = torch.from_numpy(xt).cuda(), torch.from_numpy(yt).cuda()
    fwd = fwd_counters()
    fns = fwd + BWD_KERNELS
    total = {fn.__name__: 0 for fn in fns}
    rows = []
    for mode in ROUTING_MODES:
        for dt in DTYPES:
            cfg = ModelConfig(compute_dtype=DT_NAME[dt], fused_dense=mode)
            want_fwd = routed_layers(False, dt, mode)
            want_step = {fn.__name__: routed_layers(True, dt, mode)
                         for fn in fwd}
            want_step.update({fn.__name__: routed_layers(True, dt, mode,
                                                         bwd=True)
                              for fn in BWD_KERNELS})
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            pred = Predictor(sd, cfg, device="cuda")
            before = counts(fns)
            final, _ = pred(req)
            first_s = time.perf_counter() - t0
            per_fwd = since(fns, before)
            resident = torch.cuda.memory_allocated() - base
            row = {"mode": mode, "dtype": DT_NAME[dt],
                   "forward_launches": per_fwd,
                   "first_forward_s": first_s,
                   "resident_gb": resident / 1e9,
                   "finite": float(np.isfinite(final).mean())}
            check(per_fwd == {fn.__name__: want_fwd if fn in fwd else 0
                              for fn in fns},
                  f"routing: launches in a forward {row}")
            check(row["finite"] == 1.0, f"routing: non-finite map {row}")
            with torch.inference_mode():
                ms = cuda_ms(lambda: pred.predict(x), ROUTING_ITERS)
                row.update(forward_ms=ms, img_per_s=BATCH * 1e3 / ms,
                           enqueue_ms=enqueue_ms(lambda: pred.predict(x)))
            del pred, final
            torch.cuda.empty_cache()
            trainer = DepthTrainer(Config(model=cfg), device="cuda")
            state = trainer.init(seed=SEED)
            before = counts(fns)
            state, logs = trainer.train_step(state, xd, yd)
            row["step_launches"] = since(fns, before)
            row["logs"] = {k: float(v) for k, v in logs.items()}
            check(row["step_launches"] == want_step,
                  f"routing: launches in a step {row}")
            check(all(np.isfinite(v) for v in row["logs"].values()),
                  f"routing: non-finite log {row}")
            step = lambda: trainer.train_step(state, xd, yd)  # noqa: E731
            ms = cuda_ms(step, ROUTING_ITERS, warmup=1)
            row.update(step_ms=ms, step_img_per_s=BATCH * 1e3 / ms,
                       step_enqueue_ms=enqueue_ms(step, iters=2))
            for n in total:
                total[n] += (row["forward_launches"][n]
                             + row["step_launches"][n])
            rows.append(row)
            del trainer, state, step
            torch.cuda.empty_cache()

    # the card against the CPU port, every layer routed both ways
    cfg = ModelConfig(fused_dense="on_all_bwd")
    x2 = torch.from_numpy(req[:2])
    with torch.inference_mode():
        y_c, d_c, p_c = Predictor(sd, cfg, device="cpu").model(x2)
        y_g, d_g, _ = Predictor(sd, cfg, device="cuda").model(x2.cuda())
        f_c = recombination(list(y_c)).numpy()
        f_g = recombination(list(y_g)).cpu().numpy()
        d_c, d_g, p_c = d_c.numpy(), d_g.cpu().numpy(), p_c.numpy()
    near = np.any(np.abs(p_c - 0.5) < 1e-5, axis=1, keepdims=True)
    check(bool(((d_c == d_g) | near).all()),
          "routing: on_all_bwd decode differs, card vs CPU")
    err = _finite_rel(f_g, f_c)
    check(err < SERVE_TOL, f"routing: on_all_bwd card vs CPU final map "
                           f"relL2 {err}")
    checks = {"serve": {"final_rel_l2": err, "tol": SERVE_TOL,
                        "decode_mismatch_near_half":
                            int((d_c != d_g).sum())},
              # phase_train's batch, and one where the CPU alone moves
              # the head's gradients by 3.3e-3 between thread counts
              "train": {f"seed+{k}": step_vs_cpu(cfg, SEED + k)
                        for k in (4, 7)}}
    return rows, checks, total


def measured_tables(blocks, decoder) -> dict:
    """The tables the block times call for, per dtype: a size enters the
    eval table where its routed block's eval forward wins (the decoders'
    S=8 block: captured, at batch 1 and 16 both), the train table where a
    routed train step (on_all or on_all_bwd) beats "off", and the backward
    table where on_all_bwd is the fastest of the three (the S=8 block is
    not timed in train, so it enters neither)."""
    out = {}
    for dt in DTYPES:
        rows = [b for b in blocks if b["dtype"] == DT_NAME[dt]]
        dec = [d for d in decoder if d["dtype"] == DT_NAME[dt]]
        out[DT_NAME[dt]] = {
            "eval": sorted([b["s"] for b in rows if b["eval_wins"]]
                           + [DECODER_BLOCK[0] for d in dec
                              if d["eval_wins"]]),
            "train": sorted(b["s"] for b in rows
                            if b["train_best"] != "off"),
            "bwd": sorted(b["s"] for b in rows
                          if b["train_best"] == "on_all_bwd")}
    return out


def phase_routing(smi) -> dict:
    """The S=29 and S=15 blocks through the sandwich kernels: their
    sandwiches' times (kernels, plain, cuDNN) and statistics per dtype,
    the whole blocks timed per fused_dense mode; the decoders' S=8 block
    routed against unrouted (:func:`decoder_block_times`); the tables
    those times call for against the port's; then the live model per mode
    (:func:`routing_model`).  Returns the launches of its main-path runs
    and its rows for the kernels line."""
    from md_rdm_tpu_torch.core.device import no_tf32
    from md_rdm_tpu_torch.models import routing as rt
    sandwiches, blocks = [], []
    t0 = time.perf_counter()
    with no_tf32():
        for dt in DTYPES:
            for s, n, c0 in ROUTING_BLOCKS:
                sandwiches.append(sandwich_block_times(s, n, c0, dt))
                torch.cuda.empty_cache()
                blocks.append(dense_block_times(s, n, c0, dt))
                torch.cuda.empty_cache()
        decoder = [decoder_block_times(dt) for dt in DTYPES]
    # the train sizes are also the backward's
    tables = {DT_NAME[dt]: {
        "eval": sorted(rt.MEASURED[False, dt].layers),
        "train": sorted(rt.MEASURED[True, dt].layers),
        "bwd": sorted(rt.MEASURED[True, dt].layers)} for dt in DTYPES}
    measured = measured_tables(blocks, decoder)
    # the S=57 block is measured by times_kernel / times_kernel_bwd
    agree = all(sorted(set(tables[d][k]) - {57}) == measured[d][k]
                for d in measured for k in measured[d])
    out = {"phase": "routing", "card": smi, "sandwiches": sandwiches,
           "blocks": blocks, "decoder_block": decoder, "tables": tables,
           "measured_tables": measured, "tables_agree": agree,
           "seconds": time.perf_counter() - t0}
    emit(out)
    t0 = time.perf_counter()
    rows, checks, launches = routing_model(smi)
    model = {"phase": "routing_model", "card": smi, "model": rows,
             "cpu_vs_card_on_all_bwd": checks,
             "main_path_launches": launches,
             "seconds": time.perf_counter() - t0}
    emit(model)
    return {**out, **model}


# -------------------------------------------------------------------- flat ---
# ModelConfig.flat_block and ModelConfig.remat (phase 18).  The strided
# kernels are checked at a slot of the S=57 and S=15 blocks' buffers
# (C_final 384 and 2,112): channels [C_final - 96, C_final - 48), the
# output of the next-to-last layer, whose C_in is C_final - 96.
FLAT_SLOTS = ((57, 384), (15, 2112))
# K1's dscale / dshift and K4's dw2 are float32 sums that the kernels add
# with atomics, in an order that changes from launch to launch: a strided
# launch is held to this relL2 against the contiguous launch (F3's y and
# K1's r and dz bit for bit), beside two contiguous launches' own spread.
ATOMIC_TOL = 1e-5
FLAT_ITERS = 5
FLAT_TURNS = 5
# Flat wins a block where it is faster by more than this share in every
# turn (flat against unflat timed one after the other), and loses where
# it is slower by more in every turn; else the two tie, which either
# table entry agrees with.  Host-bound bf16 blocks move by up to 2x
# between turns and runs (the routing phase's S=15 eval: 6.50-13.03 ms
# between runs; this phase's: 0.45-1.29 flat / unflat between turns).
FLAT_TIE = 0.10
# Layers of one live-encoder call, all of which a flat model routes.
ENCODER_LAYERS = sum(n for _, n, _ in ENCODER_BLOCKS)


def strided_counts() -> dict:
    from md_rdm_tpu_torch.kernels.dense_sandwich import STRIDED_KERNELS
    return counts(STRIDED_KERNELS, "strided")


def reset_strided() -> None:
    from md_rdm_tpu_torch.kernels.dense_sandwich import STRIDED_KERNELS
    reset_counts(STRIDED_KERNELS, "strided")


def strided_checks() -> list:
    """F3 writing into a slot of a block buffer, and K1 and K4 reading the
    cotangent from a slot of the block's cotangent, against the same
    kernels' contiguous launches on the same inputs, batch 16, both
    dtypes: F3's y and K1's r and dz bit for bit, the channels around the
    slot untouched and the cotangent unread-from-written, K1's dscale /
    dshift and K4's dw2 within ATOMIC_TOL.  Then the forward kernels
    composed into a slot and the backward kernels composed on a slot
    against the plain sandwich and the plain backward."""
    from md_rdm_tpu_torch.kernels import dense_sandwich as ds
    rows = []
    with torch.no_grad():
        for s, c_final in FLAT_SLOTS:
            c_in = c_final - 96
            sl = slice(c_in, c_in + 48)
            for dt in DTYPES:
                args, _ = bwd_inputs(s, c_in, dt, SEED + 600 + s)
                x, w1, scale, shift, w2 = args
                g = torch.Generator(device="cuda").manual_seed(SEED + 700 + s)
                buf = torch.randn(BATCH, s, s, c_final, generator=g,
                                  device="cuda").to(dt)
                dbuf = torch.randn(BATCH, s, s, c_final, generator=g,
                                   device="cuda").to(dt)
                buf0, dbuf0 = buf.clone(), dbuf.clone()
                gs = dbuf[..., sl]
                gc = gs.contiguous()
                r = ds.fwd_expand_reference(x, w1, scale, shift)
                taps = ds.fwd_taps_reference(r, w2).view(BATCH, s, s, ds.GK)
                y_c = ds.fwd_tapsum(taps, dt)
                y_s = ds.fwd_tapsum(taps, dt, buf[..., sl])
                k1_s = ds.bwd_recompute(*args, gs)
                k1_c = ds.bwd_recompute(*args, gc)
                k1_c2 = ds.bwd_recompute(*args, gc)
                dw2_s = ds.bwd_dw2(k1_c[0], gs)
                dw2_c = ds.bwd_dw2(k1_c[0], gc)
                dw2_c2 = ds.bwd_dw2(k1_c[0], gc)
                torch.cuda.synchronize()
                row = {
                    "s": s, "c_final": c_final, "c_in": c_in,
                    "dtype": DT_NAME[dt],
                    "f3_equal": bool(torch.equal(y_s, y_c)),
                    "f3_writes_its_slot_only": bool(
                        torch.equal(buf[..., :c_in], buf0[..., :c_in])
                        and torch.equal(buf[..., c_in + 48:],
                                        buf0[..., c_in + 48:])),
                    "f3_ldy": ds.row_stride(y_s),
                    "k1_r_dz_equal": bool(torch.equal(k1_s[0], k1_c[0])
                                          and torch.equal(k1_s[1], k1_c[1])),
                    "k1_rel_l2_dscale_dshift": max(
                        rel_l2(k1_s[2], k1_c[2]), rel_l2(k1_s[3], k1_c[3])),
                    "k1_rel_l2_contiguous_twice": max(
                        rel_l2(k1_c2[2], k1_c[2]), rel_l2(k1_c2[3], k1_c[3])),
                    "k4_rel_l2": rel_l2(dw2_s, dw2_c),
                    "k4_rel_l2_contiguous_twice": rel_l2(dw2_c2, dw2_c),
                    "cotangent_untouched": bool(torch.equal(dbuf, dbuf0)),
                    "atomic_tol": ATOMIC_TOL}
                check(row["f3_equal"] and row["f3_writes_its_slot_only"]
                      and row["f3_ldy"] == c_final and row["k1_r_dz_equal"]
                      and row["cotangent_untouched"]
                      and row["k1_rel_l2_dscale_dshift"] < ATOMIC_TOL
                      and row["k4_rel_l2"] < ATOMIC_TOL,
                      f"flat: strided kernels differ from contiguous {row}")
                # composed: the forward into a slot, the backward on a slot
                out = torch.zeros(BATCH, s, s, c_final, dtype=dt,
                                  device="cuda")
                ds.dense_sandwich_packed(x, ds.pack_weights(
                    w1, scale, shift, w2, dt), out=out[..., sl])
                want = ds.dense_sandwich_reference(*args)
                got = ds.dense_sandwich_bwd(*args, gs)
                want_b = ds.dense_sandwich_bwd_reference(*args, gs)
                torch.cuda.synchronize()
                row["forward"] = {"rel_l2": rel_l2(out[..., sl], want),
                                  "max_abs_err": _max_abs(out[..., sl],
                                                          want),
                                  "tol": TOL[dt]}
                row["backward"] = {
                    **{n: rel_l2(a, b)
                       for n, a, b in zip(GRAD_NAMES, got, want_b)},
                    "max_abs_err": max(_max_abs(a, b)
                                       for a, b in zip(got, want_b)),
                    "tol": BWD_TOL[dt]}
                check(row["forward"]["rel_l2"] < TOL[dt]
                      and all(row["backward"][n] < BWD_TOL[dt]
                              for n in GRAD_NAMES),
                      f"flat: strided kernels disagree with plain {row}")
                rows.append(row)
    return rows


def strided_times() -> dict:
    """float32, batch 16, summed over FLAT_SLOTS' layers: the forward
    kernels composed into a slot against the plain sandwich written into
    it and the cuDNN sequence; the backward kernels composed on a slot's
    cotangent against the plain backward and autograd through the cuDNN
    sequence; each with its bound."""
    from md_rdm_tpu_torch.kernels import dense_sandwich as ds
    dt = torch.float32
    fwd, bwd = [], []
    for s, c_final in FLAT_SLOTS:
        c_in = c_final - 96
        sl = slice(c_in, c_in + 48)
        args, _ = bwd_inputs(s, c_in, dt, SEED + 600 + s)
        p = ds.pack_weights(*args[1:], dt)
        buf = torch.zeros(BATCH, s, s, c_final, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(SEED + 700 + s)
        gs = torch.randn(BATCH, s, s, c_final, generator=g,
                         device="cuda")[..., sl]
        c_mid = 48 * s
        with torch.inference_mode():
            fwd.append(time_turns({"": (
                lambda: ds.dense_sandwich_packed(args[0], p, out=buf[..., sl]),
                lambda: ds.fwd_stages_reference(*args, buf[..., sl]),
                lambda: library_sandwich(*args))}, FLAT_ITERS,
                {"": (ds.sandwich_flops(BATCH, s, c_in, c_mid),
                      ds.sandwich_bytes(BATCH, s, c_in, c_mid, 4))}, dt)[""])
        leaves = [a.clone().requires_grad_() for a in args]
        graph = library_sandwich(*leaves)
        gnchw = gs.permute(0, 3, 1, 2)
        bwd.append(time_turns({"": (
            lambda: ds.dense_sandwich_bwd(*args, gs, p.w1t),
            lambda: ds.dense_sandwich_bwd_reference(*args, gs),
            lambda: torch.autograd.grad(graph, leaves, gnchw,
                                        retain_graph=True))},
            FLAT_ITERS,
            {"": (ds.sandwich_bwd_flops(BATCH, s, c_in, c_mid),
                  ds.sandwich_bwd_bytes(BATCH, s, c_in, c_mid, 4))},
            dt)[""])
        del graph, leaves

    def total(rows):
        by_ops = (sum(r["gflop"] for r in rows) * 1e9 / PEAK_FLOPS[dt]
                  >= sum(r["mbytes"] for r in rows) * 1e6 / PEAK_BYTES)
        return {**{k: sum(r[k] for r in rows)
                   for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
                "bound_by": "operations" if by_ops else "bytes",
                "layers": [{"s": s, "c_in": c - 96, **r}
                           for (s, c), r in zip(FLAT_SLOTS, rows)]}
    return {"forward": total(fwd), "backward": total(bwd)}


def flat_block_times(s: int, n: int, c0: int, dt) -> dict:
    """One seeded dense block (randomized BatchNorm statistics) at batch
    16 under fused_dense on_all_bwd, flat (_FlatBlock, flat_block
    on_all) against unflat (flat_block off): one train call (forward and
    backward with a seeded cotangent) from the same state, then one eval
    forward, held to each other (outputs TOL, gradients and running
    statistics BWD_TOL: in bfloat16 every gradient as one vector); then
    the eval forward and the train forward + backward of each timed as
    one call, in FLAT_TURNS turns (the least kept, and each turn's ratio
    flat / unflat), with the host time to enqueue one call and the device
    operations and busy time per call (torch.profiler)."""
    from md_rdm_tpu_torch.core.device import no_tf32
    from md_rdm_tpu_torch.models import densenet as tdn
    from md_rdm_tpu_torch.models.rdm import (init_parameters,
                                             randomize_batchnorm)
    from md_rdm_tpu_torch.models.routing import Routing
    base = tdn.DenseBlock(n, c0, s)
    init_parameters(base, SEED)
    randomize_batchnorm(base, SEED + 1)
    g = torch.Generator(device="cuda").manual_seed(SEED + 800 + s)
    cl = torch.channels_last
    h = torch.randn(BATCH, c0, s, s, generator=g, device="cuda").to(
        dt).contiguous(memory_format=cl)
    cot = torch.randn(BATCH, c0 + 48 * n, s, s, generator=g,
                      device="cuda").to(dt).contiguous(memory_format=cl)
    blocks = {form: tdn.DenseBlock(n, c0, s,
                                   routing=Routing("on_all_bwd", flat))
              for form, flat in (("unflat", "off"), ("flat", "on_all"))}
    got = {}
    with no_tf32():
        for form, blk in blocks.items():
            blk.load_state_dict(base.state_dict())
            blk.cuda().train()
            hg = h.detach().requires_grad_()
            y = blk(hg)
            y.backward(cot)
            got[form] = {"out": y.detach(), "dx": hg.grad,
                         "grads": _flat(p.grad for p in blk.parameters()),
                         "stats": _flat(b for k, b in blk.named_buffers()
                                        if "running" in k)}
            blk.eval()
            with torch.no_grad():
                got[form]["eval"] = blk(h)
        check(blocks["flat"].runs_flat(h)
              and blocks["flat"].train().runs_flat(h),
              f"flat: the S={s} block does not run flat")
        grad_names = [k for k, _ in blocks["flat"].named_parameters()]
        f, u = got["flat"], got["unflat"]
        per = [rel_l2(a, b) for a, b in zip(
            torch.split(f["grads"], [p.numel() for p in
                                     blocks["flat"].parameters()]),
            torch.split(u["grads"], [p.numel() for p in
                                     blocks["unflat"].parameters()]))]
        errs = {"out": rel_l2(f["out"], u["out"]),
                "eval_out": rel_l2(f["eval"], u["eval"]),
                "dx": rel_l2(f["dx"], u["dx"]),
                "grads": rel_l2(f["grads"], u["grads"]),
                "grads_max_per_tensor": max(per),
                "grads_max_tensor": grad_names[int(np.argmax(per))],
                "stats": rel_l2(f["stats"], u["stats"])}
        bars = {"out": TOL[dt], "eval_out": TOL[dt], "dx": BWD_TOL[dt],
                "grads": BWD_TOL[dt], "stats": BWD_TOL[dt]}
        if dt == torch.float32:
            bars["grads_max_per_tensor"] = BWD_TOL[dt]
        out = {"s": s, "layers": n, "dtype": DT_NAME[dt], "errors": errs,
               "bars": bars}
        check(all(errs[k] < bar for k, bar in bars.items()),
              f"flat: block disagrees with the unflat block {out}")
        del got
        hg = h.detach().requires_grad_()
        t = {}
        for _ in range(FLAT_TURNS):
            for form, blk in blocks.items():
                blk.eval()
                with torch.no_grad():
                    t.setdefault(f"eval_ms_{form}", []).append(
                        cuda_ms(lambda: blk(h), FLAT_ITERS))
                blk.train()
                t.setdefault(f"train_ms_{form}", []).append(
                    cuda_ms(lambda: blk(hg).backward(cot), FLAT_ITERS,
                            warmup=1))
        out.update({k: min(v) for k, v in t.items()})
        for form, blk in blocks.items():
            blk.eval()
            with torch.no_grad():
                out[f"eval_enqueue_ms_{form}"] = enqueue_ms(lambda: blk(h))
                prof = profile_window(lambda: blk(h), 3)
            out[f"eval_ops_{form}"] = prof["device_ops_per_call"]
            out[f"eval_device_ms_{form}"] = prof["device_busy_ms_per_call"]
            blk.train()
            out[f"train_enqueue_ms_{form}"] = enqueue_ms(
                lambda: blk(hg).backward(cot), iters=2)
            prof = profile_window(lambda: blk(hg).backward(cot), 1)
            out[f"train_ops_{form}"] = prof["device_ops_per_call"]
            out[f"train_device_ms_{form}"] = prof["device_busy_ms_per_call"]
    for mode in ("eval", "train"):
        turns = [f / u for f, u in zip(t[f"{mode}_ms_flat"],
                                       t[f"{mode}_ms_unflat"])]
        out[f"{mode}_flat_over_unflat"] = (out[f"{mode}_ms_flat"]
                                           / out[f"{mode}_ms_unflat"])
        out[f"{mode}_turns_flat_over_unflat"] = turns
        out[f"{mode}_wins"] = all(r < 1.0 - FLAT_TIE for r in turns)
        out[f"{mode}_loses"] = all(r > 1.0 + FLAT_TIE for r in turns)
    return out


def flat_tables_agree(blocks) -> tuple:
    """The tables the block times call for (a size enters where flat won
    every turn), and whether the port's tables agree: each size that won
    is in its table, and none that lost; a tie may be either."""
    from md_rdm_tpu_torch.models import routing as rt
    measured, agree = {}, True
    for dt in DTYPES:
        for mode, train in (("eval", False), ("train", True)):
            sizes = rt.MEASURED[train, dt].flat
            rows = [b for b in blocks if b["dtype"] == DT_NAME[dt]]
            measured.setdefault(DT_NAME[dt], {})[mode] = sorted(
                b["s"] for b in rows if b[f"{mode}_wins"])
            agree &= all(not (b[f"{mode}_wins"] or b[f"{mode}_loses"])
                         or (b["s"] in sizes) == b[f"{mode}_wins"]
                         for b in rows)
    return measured, agree


def remat_steps() -> list:
    """The live model's train step (ModelConfig() but remat) with remat off
    and on, per dtype, from the same seeded weights on the same batch:
    at batch 16 the first step's launches, its peak memory, its
    gradients and running statistics (remat on against off, at BWD_TOL or
    FLOOR_FACTOR times the spread of two remat-off steps, whichever is
    larger), the step time over back-to-back steps with its enqueue, and
    one profiled step (device busy ms, idle share, device operations);
    at batch 32 the first step's peak memory (the batch's second half
    gives the faithful fusion tail's NaN loss: the row measures memory).
    ``step_gb`` is the step's own: its peak less what was allocated
    before it (the model, and ~0.8 GB that the first setting's timing
    leaves allocated on the card), and the memory per sample is its
    growth from batch 16 to 32."""
    from md_rdm_tpu_torch.core.config import Config, ModelConfig
    from md_rdm_tpu_torch.kernels.dense_sandwich import BWD_KERNELS
    from md_rdm_tpu_torch.training.module import DepthTrainer
    fns = fwd_counters() + BWD_KERNELS
    xs, ys = train_batch(2 * BATCH, SEED + 3)
    rows = []
    for dt in DTYPES:
        for batch in (BATCH, 2 * BATCH):
            xd = torch.from_numpy(xs[:batch]).cuda()
            yd = torch.from_numpy(ys[:batch]).cuda()
            runs = {}
            for name in (("off", "off_again", "on") if batch == BATCH
                         else ("off", "on")):
                gc.collect()   # the last setting's model and optimizer
                torch.cuda.empty_cache()
                trainer = DepthTrainer(Config(model=ModelConfig(
                    compute_dtype=DT_NAME[dt], remat=name == "on")),
                    device="cuda")
                state = trainer.init(seed=SEED)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                resident = torch.cuda.memory_allocated()
                before = counts(fns)
                state, logs = trainer.train_step(state, xd, yd)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated()
                row = {"launches": since(fns, before),
                       "peak_gb": peak / 1e9, "resident_gb": resident / 1e9,
                       "step_gb": (peak - resident) / 1e9,
                       "logs": {k: float(v) for k, v in logs.items()}}
                if batch == BATCH:
                    model = state.model
                    row["grads"] = _flat(p.grad for p in model.parameters()
                                         if p.numel())
                    row["stats"] = _flat(b for k, b in model.named_buffers()
                                         if "running" in k)
                    if name != "off_again":
                        step = lambda: trainer.train_step(  # noqa: E731
                            state, xd, yd)
                        row["step_ms"] = cuda_ms(step, iters=3, warmup=1)
                        row["img_per_s"] = batch * 1e3 / row["step_ms"]
                        row["enqueue_ms"] = enqueue_ms(step, iters=2)
                        prof = profile_window(step, 1)
                        row.update({k: prof[k] for k in (
                            "device_busy_ms_per_call", "idle_share",
                            "device_ops_per_call")})
                        del step
                runs[name] = row
                del trainer, state
            out = {"dtype": DT_NAME[dt], "batch": batch}
            for name in ("off", "on"):
                r = runs[name]
                out[name] = {k: r[k] for k in r
                             if k not in ("grads", "stats")}
            check(runs["on"]["launches"] == runs["off"]["launches"],
                  f"remat: launches per step differ {out}")
            if batch == BATCH:
                floor = rel_l2(runs["off_again"]["grads"],
                               runs["off"]["grads"])
                bar = max(BWD_TOL[dt], FLOOR_FACTOR * floor)
                out["grads_rel_l2"] = rel_l2(runs["on"]["grads"],
                                             runs["off"]["grads"])
                out["grads_floor_rel_l2"] = floor
                out["grads_bar"] = bar
                out["stats_rel_l2"] = rel_l2(runs["on"]["stats"],
                                             runs["off"]["stats"])
                out["stats_bar"] = BWD_TOL[dt]
                check(out["grads_rel_l2"] < bar
                      and out["stats_rel_l2"] < BWD_TOL[dt],
                      f"remat: the step differs from remat off {out}")
            rows.append(out)
    total = torch.cuda.get_device_properties(0).total_memory / 1e9
    for dt in DTYPES:
        r16, r32 = [next(r for r in rows if r["dtype"] == DT_NAME[dt]
                         and r["batch"] == b) for b in (BATCH, 2 * BATCH)]
        for name in ("off", "on"):
            per = (r32[name]["step_gb"] - r16[name]["step_gb"]) / BATCH
            r16[name]["gb_per_sample"] = per
            r16[name]["largest_batch_extrapolated"] = (
                int(BATCH + (total - r16[name]["peak_gb"]) // per)
                if per > 0 else None)
        r16["card_gb"] = total
    return rows


def flat_model() -> tuple:
    """The slice's own path: the live model with fused_dense on_all_bwd and
    flat_block on_all (every encoder block one buffer), per dtype, served
    (one forward of batch 16) and trained (one step of batch 16) through
    Predictor and DepthTrainer, with every count set to 0 before and read
    after: each forward kernel once per layer a forward, F3 strided each
    time, and each backward kernel once per layer a step, K1 and K4
    strided each time; the map and the step's losses against the unflat
    model (on_all_bwd) on the card."""
    from md_rdm_tpu_torch.core.config import Config, ModelConfig
    from md_rdm_tpu_torch.inference import Predictor
    from md_rdm_tpu_torch.kernels.dense_sandwich import BWD_KERNELS
    from md_rdm_tpu_torch.models.rdm import (DepthEstimationNet,
                                             init_parameters,
                                             randomize_batchnorm)
    from md_rdm_tpu_torch.training.module import DepthTrainer
    model = DepthEstimationNet(ModelConfig())
    init_parameters(model, SEED)
    randomize_batchnorm(model, SEED + 1)
    sd = model.state_dict()
    del model
    req = np.random.default_rng(SEED + 14).random((BATCH, 226, 226, 3),
                                                  dtype=np.float32)
    xt, yt = train_batch(BATCH, SEED + 3)
    xd, yd = torch.from_numpy(xt).cuda(), torch.from_numpy(yt).cuda()
    fns = fwd_counters() + BWD_KERNELS
    rows, total = [], {}
    for dt in DTYPES:
        res = {}
        for form in ("flat", "unflat"):
            cfg = ModelConfig(compute_dtype=DT_NAME[dt],
                              fused_dense="on_all_bwd",
                              flat_block="on_all" if form == "flat"
                              else "off")
            pred = Predictor(sd, cfg, device="cuda")
            trainer = DepthTrainer(Config(model=cfg), device="cuda")
            state = trainer.init(seed=SEED)
            reset_counts(fns)
            reset_strided()
            final, _ = pred(req)
            fwd_n, fwd_s = counts(fns), strided_counts()
            reset_counts(fns)
            reset_strided()
            state, logs = trainer.train_step(state, xd, yd)
            step_n, step_s = counts(fns), strided_counts()
            res[form] = {"final": final,
                         "logs": {k: float(v) for k, v in logs.items()},
                         "forward_launches": fwd_n,
                         "forward_strided": fwd_s,
                         "step_launches": step_n, "step_strided": step_s}
            del pred, trainer, state
            torch.cuda.empty_cache()
        f = res["flat"]
        want_fwd = {fn.__name__: ENCODER_LAYERS if fn in fwd_counters()
                    else 0 for fn in fns}
        want_step = {fn.__name__: ENCODER_LAYERS for fn in fns}
        err = _finite_rel(f["final"], res["unflat"]["final"])
        loss_rel = {k: abs(v - res["unflat"]["logs"][k])
                    / max(abs(res["unflat"]["logs"][k]), 1e-30)
                    for k, v in f["logs"].items()}
        row = {"dtype": DT_NAME[dt],
               **{k: f[k] for k in ("forward_launches", "forward_strided",
                                    "step_launches", "step_strided")},
               "final_rel_l2_vs_unflat": err, "serve_tol": SERVE_TOL,
               "loss_rel_vs_unflat": loss_rel, "loss_tol": TRAIN_TOL["loss"]}
        check(f["forward_launches"] == want_fwd
              and f["step_launches"] == want_step
              and f["forward_strided"]["fwd_tapsum"] == ENCODER_LAYERS
              and f["step_strided"] == {
                  "fwd_tapsum": ENCODER_LAYERS,
                  "bwd_recompute": ENCODER_LAYERS,
                  "bwd_dw2": ENCODER_LAYERS},
              f"flat: launches of the flat model {row}")
        check(err < SERVE_TOL and all(v < TRAIN_TOL["loss"]
                                      for v in loss_rel.values()),
              f"flat: the flat model differs from the unflat one {row}")
        for part in ("forward_strided", "step_strided"):
            for k, v in f[part].items():
                total[k] = total.get(k, 0) + v
        rows.append(row)
    return rows, total


def phase_flat(smi) -> dict:
    """Phase 18: the strided kernels against their contiguous selves, the
    flat blocks against the unflat ones per size, mode and dtype with the
    tables those times call for, remat's step and memory, and the flat
    model's launches.  Returns its rows for the kernels line."""
    from md_rdm_tpu_torch.core.device import no_tf32
    from md_rdm_tpu_torch.models import routing as rt
    t0 = time.perf_counter()
    with no_tf32():
        checks = strided_checks()
        times = strided_times()
    blocks = []
    for dt in DTYPES:
        for s, n, c0 in ENCODER_BLOCKS:
            blocks.append(flat_block_times(s, n, c0, dt))
            torch.cuda.empty_cache()
    measured, agree = flat_tables_agree(blocks)
    tables = {DT_NAME[dt]: {"eval": sorted(rt.MEASURED[False, dt].flat),
                            "train": sorted(rt.MEASURED[True, dt].flat)}
              for dt in DTYPES}
    out = {"phase": "flat", "card": smi, "strided_checks": checks,
           "strided_times": times, "blocks": blocks, "tables": tables,
           "measured_tables": measured, "tie_share": FLAT_TIE,
           "tables_agree": agree, "seconds": time.perf_counter() - t0}
    emit(out)
    check(agree, f"flat: the tables {tables} disagree with the measured "
                 f"{measured} outside the ties")
    t0 = time.perf_counter()
    remat = remat_steps()
    emit({"phase": "remat", "card": smi, "rows": remat,
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    model_rows, launches = flat_model()
    emit({"phase": "flat_model", "card": smi, "rows": model_rows,
          "main_path_strided_launches": launches,
          "seconds": time.perf_counter() - t0})
    return {"checks": checks, "times": times, "launches": launches}


def lloyd_arrays(shape, size: int, seed: int, specials: bool = False):
    """Seeded maps of ``shape`` (B, 1, H, W) and halves (B, 1, H/2, W/2)
    on the card: log-normal values with negatives and zeros mixed in, a
    quarter of the halves exactly 1 and a third of the maps exactly on a
    threshold, so that ratios land on thresholds inside and outside the
    windows; with ``specials``, NaN, +inf, -inf and -0.0 in both too."""
    from md_rdm_tpu_torch.ops.quantize import level_table
    rng = np.random.default_rng(seed)
    b, _, h, w = shape
    dn = np.exp(rng.normal(0, 0.4, shape)).astype(np.float32)
    dn_1 = np.exp(rng.normal(0, 0.4, (b, 1, h // 2, w // 2))).astype(
        np.float32)
    for a in (dn.reshape(-1), dn_1.reshape(-1)):
        a[rng.choice(a.size, a.size // 50, replace=False)] *= -1
        a[rng.choice(a.size, a.size // 200, replace=False)] = 0.0
    dn_1.reshape(-1)[rng.choice(dn_1.size, dn_1.size // 4,
                                replace=False)] = 1.0
    q, _ = level_table(size)
    idx = rng.choice(dn.size, dn.size // 3, replace=False)
    dn.reshape(-1)[idx] = rng.choice(q, idx.size)
    if specials:
        for a in (dn.reshape(-1), dn_1.reshape(-1)):
            idx = rng.choice(a.size, 4 * max(1, a.size // 1000),
                             replace=False).reshape(4, -1)
            for i, v in zip(idx, (np.nan, np.inf, -np.inf, -0.0)):
                a[i] = v
    return torch.from_numpy(dn).cuda(), torch.from_numpy(dn_1).cuda()


def lloyd_inputs(n: int, size: int, seed: int):
    """N seeded 16x16 pages and 8x8 halves on the card (lloyd_arrays)."""
    return lloyd_arrays((n, 1, 16, 16), size, seed)


def lloyd_segments(sizes, seed: int, specials: bool = False):
    """B4's segments: seeded batch-16 maps of each size and their halves
    on the card (lloyd_arrays)."""
    return [(*lloyd_arrays((BATCH, 1, s, s), s, seed + s, specials), s)
            for s in sizes]


def phase_kernel_lloyd():
    """B4 against its plain version on the card and on the CPU: equal bit
    for bit; the output never requires grad.  The many-segment entry over
    one forward's segments and decoder 10's, then the one-segment entry
    on pages."""
    from md_rdm_tpu_torch.kernels.lloyd import (
        fused_comparison_quantize, fused_comparison_quantize_many,
        fused_comparison_quantize_many_reference,
        fused_comparison_quantize_reference)
    rows = []

    def held(row, got, want, cpu):
        row.update({"max_abs_err": float((got - want).abs().max()),
                    "bit_equal_plain": bool(torch.equal(got, want)),
                    "bit_equal_cpu": bool(torch.equal(got.cpu(), cpu)),
                    "requires_grad": got.requires_grad})
        rows.append(row)
        check(row["max_abs_err"] == 0 and row["bit_equal_plain"],
              f"B4 disagrees with its plain version {row}")
        check(row["bit_equal_cpu"], f"B4 disagrees with the CPU port {row}")
        check(not got.requires_grad, "B4 output requires grad")

    for i, sizes in enumerate((LLOYD_FORWARD, LLOYD_D10)):
        segs = lloyd_segments(sizes, SEED + 320 + i, specials=True)
        pages = sum(BATCH * (s // 16) ** 2 for s in sizes)
        got = fused_comparison_quantize_many(
            [(d.requires_grad_(), dh, s) for d, dh, s in segs])
        torch.cuda.synchronize()
        with torch.no_grad():
            want = fused_comparison_quantize_many_reference(segs)
            cpu = fused_comparison_quantize_many_reference(
                [(d.detach().cpu(), dh.cpu(), s) for d, dh, s in segs])
        check(tuple(got.shape) == (pages, 256, 64), f"B4 output {got.shape}")
        held({"entry": "many", "sizes": list(sizes), "n": pages}, got, want,
             cpu)
    for i, (n, size) in enumerate(LLOYD_SHAPES):
        dn, dn_1 = lloyd_inputs(n, size, SEED + 300 + i)
        got = fused_comparison_quantize(dn.requires_grad_(), dn_1, size)
        torch.cuda.synchronize()
        with torch.no_grad():
            want = fused_comparison_quantize_reference(dn, dn_1, size)
            cpu = fused_comparison_quantize_reference(dn.cpu(), dn_1.cpu(),
                                                      size)
        check(tuple(got.shape) == (n, 256, 64), f"B4 output {got.shape}")
        held({"entry": "one", "n": n, "size": size}, got, want, cpu)
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
    fwd = fwd_counters()
    fns = fwd + (fused_comparison_quantize,)
    want = {dt: {fn.__name__: (1 if fn is fused_comparison_quantize
                               else routed_layers(False, dt,
                                                  decoders=len(OPTIMAL)))
                 for fn in fns} for dt in DTYPES}
    reset_counts(fns)
    for dt in DTYPES:
        for req in requests:
            t0 = time.perf_counter()
            (final, decode), got, replays = call_launches(
                fns, lambda: preds[dt](req))
            secs = time.perf_counter() - t0
            row = {"dtype": DT_NAME[dt], "seconds": secs,
                   "b1_launches": {k: v for k, v in got.items()
                                   if k != "fused_comparison_quantize"},
                   "b4_launches": got["fused_comparison_quantize"],
                   "replays": replays,
                   "finite": float(np.isfinite(final).mean())}
            served.append(row)
            check(ran_or_replayed(got, replays, want[dt]),
                  f"kernel launches in an optimal-set forward {row}")
            check(final.shape == (BATCH, 1, 128, 128), f"map {final.shape}")
            check(decode.shape == (BATCH, 1, 8, 8), f"decode {decode.shape}")
            check(row["finite"] == 1.0, f"non-finite optimal-set map {row}")
    launches = counts(fns)
    replayed = served_replays(preds, requests, fns, want)

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
          "main_path_launches": launches, "replay_traced": replayed,
          "cpu_vs_card": {"stages": stages, "tie_flips": flipped,
                          "final_rel_l2": final_rel,
                          "final_vs_cpu_tail_on_card_maps": tail_rel,
                          "tol": SERVE_TOL}})
    # the final map against the CPU port, and after a tie flip (which the
    # faithful tail amplifies) also against the CPU tail on the card's maps
    check(final_rel < SERVE_TOL and (tail_rel < SERVE_TOL or not flipped),
          f"optimal-set final map, card vs CPU: {final_rel} / {tail_rel}")
    return preds, requests, launches, served[0]["b4_launches"]


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


def library_lloyd_many(segments):
    """library_lloyd over B4's segments: each map paged (split_matrix),
    compared, bucketized and gathered, then the cat."""
    from md_rdm_tpu_torch.kernels.lloyd import segment_pages
    return torch.cat([library_lloyd(*segment_pages(d, dh), s)
                      for d, dh, s in segments])


def time_lloyd(fns, nbytes: int, ops: int) -> dict:
    """Device time (profiler) and time per call (CUDA events, host-bound
    at these sizes) of each of ``fns`` (kernel "", plain, library), taken
    twice in turns; the bound."""
    t = {}
    for _ in range(2):
        for key, fn in fns.items():
            t.setdefault(key + "ms", []).append(device_ms(fn, 20))
            t.setdefault(key + "call_ms", []).append(cuda_ms(fn, 20))
    by_bytes = nbytes / PEAK_BYTES >= ops / PEAK_FLOPS[torch.float32]
    return {**{k: min(v) for k, v in t.items()},
            "bound_ms": 1e3 * max(nbytes / PEAK_BYTES,
                                  ops / PEAK_FLOPS[torch.float32]),
            "bound_by": "bytes" if by_bytes else "operations",
            "mbytes": nbytes / 1e6, "gop": ops / 1e9}


def phase_times_lloyd(smi):
    """B4: the one launch of a batch-16 optimal-set forward (kernel, plain
    version, library formulation, bound, a store-only fill of its output's
    size); the one-segment entry at the forward's page counts.  Returns (the one
    launch's row, the per-shape rows)."""
    from md_rdm_tpu_torch.kernels.lloyd import (
        fused_comparison_quantize, fused_comparison_quantize_many,
        fused_comparison_quantize_many_reference,
        fused_comparison_quantize_reference, lloyd_bytes, lloyd_ops)
    rows = []
    with torch.inference_mode():
        segs = lloyd_segments(LLOYD_FORWARD, SEED + 420)
        pages = sum(BATCH * (s // 16) ** 2 for s in LLOYD_FORWARD)
        forward = {"sizes": list(LLOYD_FORWARD), "n": pages,
                   "launches": 1, **time_lloyd(
                       {"": lambda: fused_comparison_quantize_many(segs),
                        "plain_": lambda:
                            fused_comparison_quantize_many_reference(segs),
                        "library_": lambda: library_lloyd_many(segs)},
                       lloyd_bytes(pages), lloyd_ops(pages))}
        # the card's own fill kernel writing a buffer of the output's size:
        # what the stores alone cost
        buf = torch.empty((pages, 256, 64), device="cuda")
        forward["fill_ms"] = min(device_ms(lambda: buf.fill_(0.5), 20)
                                 for _ in range(2))
        del buf
        # the L2 holds the whole output, so the fill can beat bound_ms
        forward["over_fill"] = forward["ms"] / forward["fill_ms"]
        for i, (n, size) in enumerate(LLOYD_SHAPES[:3]):
            dn, dn_1 = lloyd_inputs(n, size, SEED + 400 + i)
            rows.append({"n": n, "size": size, **time_lloyd(
                {"": lambda: fused_comparison_quantize(dn, dn_1, size),
                 "plain_": lambda: fused_comparison_quantize_reference(
                     dn, dn_1, size),
                 "library_": lambda: library_lloyd(dn, dn_1, size)},
                lloyd_bytes(n), lloyd_ops(n))})
    emit({"phase": "times_lloyd", "card": smi, "forward": forward,
          "rows": rows})
    return forward, rows


def phase_times_optimal(preds, requests, smi):
    """The optimal-set forward per dtype: CUDA events, img/s, host
    enqueue, request time, peak memory; then its profile."""
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


def optimal_train_config(dt, **model):
    from md_rdm_tpu_torch.core.config import Config, ModelConfig
    return Config(model=ModelConfig(decoder_ids=OPTIMAL,
                                    fusion_eps=OPTIMAL_EPS,
                                    compute_dtype=DT_NAME[dt], **model))


def path_counters():
    """Every launch counter of a train step of the optimal set: the
    forward's (B1), the backward's (B2b/B3) and B4's."""
    from md_rdm_tpu_torch.kernels.dense_sandwich import BWD_KERNELS
    from md_rdm_tpu_torch.kernels.lloyd import fused_comparison_quantize
    return fwd_counters() + BWD_KERNELS + (fused_comparison_quantize,)


def relative_named(model, what):
    """(name, tensor) of the relative decoders' non-empty parameters
    (``what="params"``) or running statistics (``"stats"``)."""
    prefixes = tuple(f"d_{d}." for d in OPTIMAL if d > 5)
    items = (model.named_parameters() if what == "params"
             else model.named_buffers())
    return [(n, t) for n, t in items if n.startswith(prefixes) and t.numel()
            and (what == "params" or "running" in n)]


def recording_maps(model, seen: dict) -> None:
    """Record on ``seen`` the decoder maps each forward of ``model`` fuses
    (by id, on the host)."""
    inner = model.decoder_maps

    def decoder_maps(*args, **kwargs):
        out = inner(*args, **kwargs)
        seen.update({d: m.detach().float().cpu() for d, m in out[0].items()})
        return out

    model.decoder_maps = decoder_maps


def tail_loss_grads(model, maps, y):
    """The CPU port's fusion tail and MSE + fine-detail loss on given
    decoder maps: (those loss terms, the fusion weights' gradients).  The
    ordinal loss does not depend on the fusion weights."""
    from md_rdm_tpu_torch.core.config import SIDConfig
    from md_rdm_tpu_torch.losses import mse_loss
    from md_rdm_tpu_torch.ops.resize import resize_bicubic
    from md_rdm_tpu_torch.training.module import (compute_final_depth,
                                                  mask_target)
    ym = mask_target(resize_bicubic(torch.as_tensor(y), 128))
    with torch.enable_grad():
        final, fine = compute_final_depth(model.fuse(maps), ym, True,
                                          SIDConfig())
        mse = mse_loss(final, ym)
        weights = [p for p in model.weight_layer.parameters() if p.numel()]
        grads = torch.autograd.grad(mse + fine, weights)
    return {"MSE": mse.item(), "Fine_Detail": fine.item()}, _flat(grads)


def phase_train_optimal(smi):
    """The optimal set, fusion_eps 1e-2, trained through DepthTrainer:
    3 steps of batch 16 per dtype, each launching each B1 and backward
    kernel once per routed layer and B4 once, with finite losses and exact
    zero
    gradients for the relative decoders; then, per dtype, step time (CUDA
    events), img/s, host enqueue, peak memory and the profiler's idle
    share.  Then one float32 step of batch 2 on the card against the CPU
    port."""
    from md_rdm_tpu_torch.training.module import DepthTrainer

    x, y = train_batch(BATCH, SEED + 6)
    xd, yd = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    fns = path_counters()
    steps, rows, launches = [], [], {}
    for dt in DTYPES:
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        trainer = DepthTrainer(optimal_train_config(dt), device="cuda")
        state = trainer.init(seed=SEED)
        model = state.model
        rel_params = relative_named(model, "params")
        rel_stats0 = _flat(t for _, t in relative_named(model, "stats"))
        params0 = _flat(p for p in model.parameters() if p.numel())
        reset_counts(fns)
        for i in range(TRAIN_STEPS):
            before = counts(fns)
            t0 = time.perf_counter()
            state, logs = trainer.train_step(state, xd, yd)
            logs = {k: float(v) for k, v in logs.items()}
            secs = time.perf_counter() - t0
            nonzero = sum(int(torch.count_nonzero(p.grad))
                          for _, p in rel_params)
            row = {"dtype": DT_NAME[dt], "step": i + 1, "seconds": secs,
                   "launches": since(fns, before), "logs": logs,
                   "relative_grad_nonzero": nonzero}
            steps.append(row)
            k = len(OPTIMAL)
            want = {fn.__name__: routed_layers(True, dt, decoders=k)
                    for fn in fwd_counters()}
            want.update({fn.__name__: routed_layers(True, dt, bwd=True,
                                                    decoders=k)
                         for fn in fns if fn.__name__.startswith("bwd_")},
                        fused_comparison_quantize=1)
            check(row["launches"] == want,
                  f"kernel launches in an optimal train step {row}")
            check(all(np.isfinite(v) for v in logs.values()),
                  f"non-finite log {row}")
            check(nonzero == 0, f"relative decoders got a gradient {row}")
        for k, v in counts(fns).items():
            launches[k] = launches.get(k, 0) + v
        check(state.step == TRAIN_STEPS, f"step count {state.step}")
        check(not torch.equal(_flat(p for p in model.parameters()
                                    if p.numel()), params0),
              "parameters did not move")
        check(not torch.equal(_flat(t for _, t in relative_named(
            model, "stats")), rel_stats0),
              "relative decoders' running statistics did not move")

        step = lambda: trainer.train_step(state, xd, yd)  # noqa: E731
        ms = cuda_ms(step, iters=3, warmup=1)
        enq = enqueue_ms(step, iters=2)
        prof = profile_window(step, 1)
        peak = torch.cuda.max_memory_allocated()
        rows.append({"dtype": DT_NAME[dt], "batch": BATCH,
                     "decoder_ids": list(OPTIMAL), "step_ms": ms,
                     "img_per_s": BATCH * 1e3 / ms, "enqueue_ms": enq,
                     "peak_mem_gb": peak / 1e9,
                     "peak_mem_own_gb": (peak - resident) / 1e9,
                     "device_busy_ms": prof["device_busy_ms_per_call"],
                     "profiled_wall_ms": prof["wall_ms_per_call"],
                     "idle_share": prof["idle_share"],
                     "device_ops": prof["device_ops_per_call"],
                     "top": prof["top"][:6]})
        del trainer, state, model, rel_params, step
        torch.cuda.empty_cache()

    cmp = optimal_step_vs_cpu()
    emit({"phase": "train_optimal", "card": smi, "steps": steps,
          "main_path_launches": launches, "times": rows,
          "cpu_vs_card": cmp})
    return launches, rows


def optimal_step_vs_cpu() -> dict:
    """One float32 optimal-set step of batch 2 on the card and on the CPU
    port (twice: default threads, and one thread for the rounding floor),
    from the same seeded weights.  Bars as in phase_train; the relative
    decoders' running statistics at TRAIN_TOL["stats"], their gradients
    exactly 0.  A Lloyd threshold between the two runs' ratios, or an ALS
    tie, moves a relative map and with it the fusion weights' gradients
    and the loss terms: those are held against the CPU tail on the card's
    own maps, where the relative maps differ.  d_1.conv2's gradient reads
    decoder 1's train-mode features, which on some batches are as
    ill-conditioned as the whole model's gradient (the CPU moves it by
    3e-3 between one thread and eight on this one): it is held to
    FLOOR_FACTOR times its own measured floor, never looser than
    TRAIN_TOL["head_grads"]."""
    from md_rdm_tpu_torch.training.module import DepthTrainer

    x2, y2 = train_batch(2, SEED + 7)
    runs, threads = {}, torch.get_num_threads()
    for name, dev, n_threads in (("cpu", "cpu", threads),
                                 ("cpu_1thread", "cpu", 1),
                                 ("cuda", "cuda", threads)):
        torch.set_num_threads(n_threads)
        trainer = DepthTrainer(optimal_train_config(torch.float32),
                               device=dev)
        state = trainer.init(seed=SEED)
        seen = {}
        recording_maps(state.model, seen)
        state, logs = trainer.train_step(state, x2, y2)
        model = state.model
        named = [(n, p) for n, p in model.named_parameters() if p.numel()]
        runs[name] = {
            "logs": {k: float(v) for k, v in logs.items()},
            "grads": _flat(p.grad for _, p in named),
            "head": _flat(p.grad for n, p in named
                          if n.startswith("d_1.conv2.")),
            "fusion": _flat(p.grad for n, p in named
                            if n.startswith("weight_layer.")),
            "params": _flat(p for _, p in named),
            "stats": _flat(b for n, b in model.named_buffers()
                           if "running" in n),
            "rel_stats": _flat(t for _, t in relative_named(model, "stats")),
            "rel_grad_nonzero": sum(int(torch.count_nonzero(p.grad))
                                    for _, p in relative_named(model,
                                                               "params")),
            "maps": seen}
        del trainer, state, model, named
    torch.set_num_threads(threads)
    c, g, c1 = runs["cpu"], runs["cuda"], runs["cpu_1thread"]
    # the CPU port's tail on the card's maps, from the initial weights
    from md_rdm_tpu_torch.models.rdm import DepthEstimationNet, init_parameters
    fresh = DepthEstimationNet(optimal_train_config(torch.float32).model)
    init_parameters(fresh, SEED)
    tail_logs, tail_fusion = tail_loss_grads(fresh, g["maps"], y2)
    map_rel = {d: rel_l2(g["maps"][d], c["maps"][d]) for d in OPTIMAL}
    moved = any(map_rel[d] > 1e-4 for d in OPTIMAL if d > 5)
    loss_rel = {k: abs(g["logs"][k] - c["logs"][k]) / max(abs(c["logs"][k]),
                                                           1e-30)
                for k in ("loss", "MSE", "Ord_Loss", "Fine_Detail")}
    tail_rel = {k: abs(g["logs"][k] - v) / max(abs(v), 1e-30)
                for k, v in tail_logs.items()}
    errs = {k: rel_l2(g[k], c[k])
            for k in ("head", "fusion", "grads", "params", "stats",
                      "rel_stats")}
    errs["fusion_vs_tail_on_card_maps"] = rel_l2(g["fusion"], tail_fusion)
    floor = {k: rel_l2(c1[k], c[k]) for k in ("head", "grads", "params")}
    bars = {"stats": TRAIN_TOL["stats"], "rel_stats": TRAIN_TOL["stats"],
            "fusion_vs_tail_on_card_maps": TRAIN_TOL["head_grads"],
            "head": max(TRAIN_TOL["head_grads"],
                        FLOOR_FACTOR * floor["head"]),
            **{k: max(TRAIN_TOL[k], FLOOR_FACTOR * floor[k])
               for k in ("grads", "params")}}
    out = {"loss_rel": loss_rel, "loss_rel_vs_tail_on_card_maps": tail_rel,
           "rel_l2": errs, "cpu_floor_rel_l2": floor, "bars": bars,
           "map_rel_l2": {str(d): v for d, v in map_rel.items()},
           "relative_maps_moved": moved, "cpu_threads": threads,
           "rel_grad_nonzero": {k: r["rel_grad_nonzero"]
                                for k, r in runs.items()}}
    emit({"phase": "train_optimal_vs_cpu", **out})
    check(all(r["rel_grad_nonzero"] == 0 for r in runs.values()),
          f"relative decoders got a gradient {out['rel_grad_nonzero']}")
    check(all(v < SERVE_TOL for v in map_rel.values()),
          f"card vs CPU decoder maps {map_rel}")
    if moved:
        check(all(v < TRAIN_TOL["loss"] for v in tail_rel.values())
              and loss_rel["Ord_Loss"] < TRAIN_TOL["loss"],
              f"card vs CPU tail on the card's maps, loss terms {tail_rel}")
    else:
        check(all(v < TRAIN_TOL["loss"] for v in loss_rel.values()),
              f"card vs CPU loss terms {loss_rel}")
        bars["fusion"] = TRAIN_TOL["head_grads"]
    for k, bar in bars.items():
        check(errs[k] < bar, f"card vs CPU {k} relL2 {errs[k]} (bar {bar})")
    return out


LOOP_TRAIN, LOOP_VAL, LOOP_EPOCHS = 64, 24, 2


def _clone(tree):
    """A copy of a state_dict tree with every tensor cloned in place."""
    if torch.is_tensor(tree):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree


def phase_loop(smi, bare_step_ms: float):
    """Trainer.fit on the optimal set in float32 under a temporary run
    directory: warm-up, 2 epochs of 4 synthetic batches of 16, validation
    on 24 samples at batch 16 (a short tail), top-1 checkpoints, plateau
    patience 0.  Then the run's files, Predictor.from_checkpoint against
    the best epoch's in-memory weights (bit for bit), and Trainer.restore
    (step, optimizer, scheduler)."""
    import tempfile

    from md_rdm_tpu_torch.core.config import Config, DataConfig, TrainConfig
    from md_rdm_tpu_torch.data.base import DataLoader
    from md_rdm_tpu_torch.data.synthetic import SyntheticDepthDataset
    from md_rdm_tpu_torch.inference import Predictor
    from md_rdm_tpu_torch.training.loop import Trainer

    model_cfg = optimal_train_config(torch.float32).model
    train_ds = SyntheticDepthDataset("train", size=LOOP_TRAIN, seed=SEED,
                                     cache=True)
    val_ds = SyntheticDepthDataset("val", size=LOOP_VAL, seed=SEED + 1,
                                   cache=True)
    fns = path_counters()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_loop_") as tmp:
        def config(**train):
            return Config(
                model=model_cfg,
                data=DataConfig(batch_size=BATCH, eval_batch_size=BATCH),
                train=TrainConfig(max_epochs=LOOP_EPOCHS, save_top_k=1,
                                  plateau_patience=0, seed=SEED,
                                  checkpoint_dir=tmp, log_every=2, **train))

        trainer = Trainer(config(), device="cuda")
        saved = {}
        save = trainer.ckpt.save

        def keeping_save(epoch, state, metrics, extra=None):
            # a copy on the card (milliseconds) of what the save writes
            saved[epoch] = {"model": _clone(state.model.state_dict()),
                            "optimizer": _clone(state.optimizer.state_dict()),
                            "step": state.step,
                            "extra": json.loads(json.dumps(extra))}
            return save(epoch, state, metrics, extra)

        trainer.ckpt.save = keeping_save
        train = DataLoader(train_ds, batch_size=BATCH, shuffle=True,
                           drop_last=True, num_workers=2, seed=SEED)
        val = DataLoader(val_ds, batch_size=BATCH, num_workers=2)
        sample_x, sample_y = next(iter(DataLoader(train_ds, BATCH)))
        reset_counts(fns)
        with per_call_launches(fns) as calls:
            t0 = time.perf_counter()
            trainer.warmup(sample_x, sample_y)
            warm_s = time.perf_counter() - t0
            state = trainer.init_state()
            t0 = time.perf_counter()
            state = trainer.fit(state, train, val)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
        launches = counts(fns)
        trainer.close()

        # the warm-up's one step, the run's steps, its validation batches
        steps = 1 + LOOP_EPOCHS * LOOP_TRAIN // BATCH
        val = LOOP_EPOCHS * -(-LOOP_VAL // BATCH)
        k = len(OPTIMAL)
        want_step = {n: (1 if n == "fused_comparison_quantize" else
                         routed_layers(True, bwd=True, decoders=k)
                         if n.startswith("bwd_")
                         else routed_layers(True, decoders=k))
                     for n in launches}
        want_val = {n: (1 if n == "fused_comparison_quantize" else
                        0 if n.startswith("bwd_")
                        else routed_layers(False, decoders=k))
                    for n in launches}
        check(len(calls["train_step"]) == steps
              and len(calls["eval_step"]) == val,
              f"loop: {len(calls['train_step'])} steps, "
              f"{len(calls['eval_step'])} validation batches")
        _cli_launch_checks(calls, want_step, want_val, "loop")
        # every launch of the run was made inside a step or a validation
        # batch
        check(all(launches[n] == sum(c[n] for k in ("train_step",
                                                     "eval_step")
                                     for c in calls[k]) for n in launches),
              f"kernel launches in the loop {launches}")

        run = trainer.workdir
        recs = [json.loads(line) for line in
                (run / "logs" / "metrics.jsonl").read_text().splitlines()]
        epochs = [r for r in recs if "epoch_train_step_time_s" in r]
        vals = [r for r in recs if "val_delta1" in r]
        lrs = [r["lr"] for r in recs if "lr" in r]
        ckpts = [r for r in recs if "checkpoint_save_s" in r]
        kept = trainer.ckpt.all_steps()
        best = trainer.ckpt.best_step()
        check((run / "config.json").exists(), "no config.json")
        check(len(epochs) == LOOP_EPOCHS and len(vals) == LOOP_EPOCHS
              and len(lrs) == LOOP_EPOCHS, f"epoch logs {len(recs)}")
        check(len(kept) == 1 and best == kept[0] and best in saved,
              f"kept checkpoints {kept}, best {best}")
        check(all(np.isfinite(v) for r in vals for k, v in r.items()
                  if k.startswith("val_")), f"non-finite val metrics {vals}")
        check(state.step == LOOP_EPOCHS * LOOP_TRAIN // BATCH,
              f"loop step count {state.step}")

        # the best epoch's weights, from the file and from memory
        xv, _ = next(iter(DataLoader(val_ds, BATCH)))
        from_file = Predictor.from_checkpoint(str(run / "checkpoints"),
                                              model_cfg, device="cuda")
        out_file = from_file(xv)
        del from_file
        out_mem = Predictor(saved[best]["model"], model_cfg,
                            device="cuda")(xv)
        bit_equal = all(np.array_equal(a, b)
                        for a, b in zip(out_file, out_mem))
        check(bit_equal, "Predictor.from_checkpoint differs from the best "
                         "epoch's in-memory weights")
        check(np.isfinite(out_file[0]).all(), "non-finite served map")

        # resume: step, optimizer and scheduler of the best epoch
        del state
        torch.cuda.empty_cache()
        again = Trainer(config(resume=str(run / "checkpoints")),
                        device="cuda")
        epoch, restored = again.restore(again.module.init(seed=SEED + 9))
        want = saved[best]
        opt_got = restored.optimizer.state_dict()
        opt_equal = (opt_got["param_groups"] == want["optimizer"][
            "param_groups"] and all(
            torch.equal(opt_got["state"][i][k], t)
            for i, s in want["optimizer"]["state"].items()
            for k, t in s.items()))
        model_equal = all(torch.equal(restored.model.state_dict()[k], v)
                          for k, v in want["model"].items())
        sched_equal = (again.scheduler.state_dict()
                       == want["extra"]["scheduler"])
        again.close()
        check(again.workdir == run, f"resumed into {again.workdir}")
        check(epoch == best and restored.step == want["step"],
              f"restored epoch {epoch} step {restored.step}")
        check(opt_equal and model_equal and sched_equal,
              f"restore: optimizer {opt_equal} model {model_equal} "
              f"scheduler {sched_equal}")
        del again, restored, saved, want
    torch.cuda.empty_cache()
    step_s = [r["epoch_train_step_time_s"] for r in epochs]
    row = {"dtype": "float32", "batch": BATCH, "decoder_ids": list(OPTIMAL),
           "warmup_s": warm_s, "fit_s": fit_s,
           "step_time_s": step_s,
           "images_per_sec": [r["epoch_train_images_per_sec"] for r in epochs],
           "bare_step_ms": bare_step_ms,
           "loop_over_bare": [1e3 * s / bare_step_ms for s in step_s],
           "checkpoint_save_s": [r["checkpoint_save_s"] for r in ckpts],
           "checkpoint_bytes": [r["checkpoint_bytes"] for r in ckpts],
           "saved_epochs": [r["step"] for r in ckpts], "best_epoch": best,
           "lr": lrs, "val_delta1": [r["val_delta1"] for r in vals]}
    emit({"phase": "loop", "card": smi, "main_path_launches": launches,
          "rows": [row], "from_checkpoint_bit_equal": bit_equal,
          "restore": {"epoch": epoch, "optimizer": opt_equal,
                      "model": model_equal, "scheduler": sched_equal}})
    return launches


# The cli phase: the port's entry points as a user starts them.  Train set
# of --synthetic_size 64 (4 steps of batch 16; its val split is 16 images,
# one forward of batch 16); evaluate scores 96 images on the card (6
# batches of 16: the first is the cold one, the next 4 are timed from the
# start of one to the start of the next), and the first 2 on the card and
# on the CPU.
CLI_TRAIN_SIZE = 64
CLI_EVAL_IMAGES = 96
CLI_CPU_IMAGES = 2


def _entry_points():
    """(class, method, kind) of the calls whose launches and times the
    phases read: the Trainer's train and eval steps (captured or eager),
    DepthTrainer.predict_step (cli.evaluate's eager forward) and the graph
    that replays it (its captured forward, ``Graphs.run("predict")``)."""
    from md_rdm_tpu_torch.core.graphs import Graphs
    from md_rdm_tpu_torch.training.loop import Trainer
    from md_rdm_tpu_torch.training.module import DepthTrainer
    return ((Trainer, "_train_step", "train_step"),
            (Trainer, "_eval_step", "eval_step"),
            (DepthTrainer, "predict_step", "predict_step"),
            (Graphs, "run", "predict_step"))


@contextlib.contextmanager
def each_call(around):
    """While the block runs, each outermost call of an entry point (a
    forward warmed or captured inside ``Graphs.run`` is one call) runs as
    ``around(kind, call, via)``, ``call()`` making it, ``via`` the
    method's qualified name; ``Graphs.run`` of another name than
    "predict" passes through."""
    depth = [0]
    points = _entry_points()
    saved = [getattr(cls, attr) for cls, attr, _ in points]

    def wrap(kind, method, graph_run, via):
        def wrapped(self, *args, **kwargs):
            if depth[0] or (graph_run and args[0] != "predict"):
                return method(self, *args, **kwargs)
            depth[0] += 1
            try:
                return around(kind, lambda: method(self, *args, **kwargs),
                              via)
            finally:
                depth[0] -= 1
        return wrapped

    for (cls, attr, kind), method in zip(points, saved):
        setattr(cls, attr, wrap(kind, method, attr == "run",
                                f"{cls.__name__}.{attr}"))
    try:
        yield
    finally:
        for (cls, attr, _), method in zip(points, saved):
            setattr(cls, attr, method)


@contextlib.contextmanager
def per_call_launches(fns, trace=None):
    """Record the launches of ``fns`` made inside each train step, eval
    step and forward call while the block runs (:func:`each_call`):
    {kind: [per call {name: launches}], "replays": {kind: [per call graph
    replays]}, "traced": {kind: kernel launches of the traced call}}; the
    wrappers' counts, and for the call of each kind that ``trace``
    ({kind: index}) names the kernels in a profiler trace
    (:func:`traced_launches`)."""
    calls = {"train_step": [], "eval_step": [], "predict_step": []}
    calls["replays"] = {k: [] for k in list(calls)}
    calls["traced"] = {}
    trace = trace or {}

    def around(kind, call, via):
        if trace.get(kind) == len(calls[kind]):
            before = counts(fns)
            out, calls["traced"][kind], replays = traced_launches(fns, call)
            launches = since(fns, before)
        else:
            out, launches, replays = call_launches(fns, call)
        calls[kind].append(launches)
        calls["replays"][kind].append(replays)
        return out

    with each_call(around):
        yield calls


@contextlib.contextmanager
def recorded_predictions():
    """Each forward call of cli.evaluate while the block runs, as (host
    clock at its start with the card idle, its map on the CPU, the method
    called: ``Graphs.run`` where the forward is captured): the starts of
    two calls in a row bound one whole batch of the evaluate loop (data,
    forward, metrics, grid)."""
    calls = []

    def around(kind, call, via):
        if kind != "predict_step":
            return call()
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = call()
        calls.append((start, out.detach().float().cpu(), via))
        return out

    with each_call(around):
        yield calls


def run_cli(main, argv):
    """``main(argv)`` in this process with its standard output captured;
    (result, output lines)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    return result, out.getvalue().splitlines()


def png_size(path) -> tuple:
    """(width, height) from a PNG's IHDR chunk, read without an imaging
    library."""
    with open(path, "rb") as f:
        head = f.read(24)
    check(head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR",
          f"{path} is not a PNG")
    return struct.unpack(">II", head[16:24])


def cli_within_bar(name: str, got: float, want: float, images: int) -> bool:
    """The card's metric average against the CPU's: the serving bar
    (SERVE_TOL relative); a delta metric counts pixels, so one pixel's
    flip, 1 / (128 * 128 * images), is within it too."""
    bar = SERVE_TOL * abs(want)
    if name.startswith("delta"):
        bar = max(bar, 1.0 / (128 * 128 * images))
    return abs(got - want) <= bar


def _run_losses(run: Path, what: str):
    """(records, losses) of a CLI run's logs/metrics.jsonl; every loss
    must be finite."""
    recs = [json.loads(line) for line in
            (run / "logs" / "metrics.jsonl").read_text().splitlines()]
    losses = [v for r in recs for k, v in r.items()
              if k.endswith("loss") or k.endswith("Loss")]
    check(len(losses) > 0 and all(np.isfinite(losses)),
          f"{what}: losses {losses}")
    return recs, losses


def _cli_launch_checks(calls, want_step, want_eval, what):
    """Every train_step and eval_step call of a CLI run launched each
    kernel as often as ``want_step`` / ``want_eval`` say, or replayed a
    graph (:func:`ran_or_replayed`); the first call of each ran."""
    for name, want in (("train_step", want_step), ("eval_step", want_eval)):
        check(len(calls[name]) > 0 and calls[name][0] == want,
              f"{what}: {name} calls {calls[name][:1]}, want {want}")
        for i, (got, replays) in enumerate(zip(calls[name],
                                               calls["replays"][name])):
            check(ran_or_replayed(got, replays, want),
                  f"{what}: {name} call {i} launched {got} with {replays} "
                  f"replays, want {want}")


def phase_cli(smi, bare_step_ms=None):
    """The CLIs in this process, through main(argv): cli.train trains the
    live model at batch 16 in float32 (a warm-up and 4 steps), cli.evaluate
    scores its checkpoint on the card and, on the first 2 images, against
    the same command on the CPU (averages and maps); cli.train --dev trains the optimal set in
    bfloat16 (the CLI's default precision).  Launches are counted per
    train, eval and predict call."""
    import tempfile

    from md_rdm_tpu_torch.cli import evaluate as cli_evaluate
    from md_rdm_tpu_torch.cli import train as cli_train

    fns = path_counters()
    fwd = {fn.__name__ for fn in fwd_counters()}
    names = [fn.__name__ for fn in fns]
    b4 = "fused_comparison_quantize"

    def want(fwd_n, bwd_n, b4_n):
        return {n: (b4_n if n == b4 else fwd_n if n in fwd
                    else bwd_n) for n in names}

    total = {n: 0 for n in names}
    out = {"phase": "cli", "card": smi}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        # 1. the live model, float32, batch 16
        reset_counts(fns)
        t0 = time.perf_counter()
        with per_call_launches(fns) as calls:
            state, lines = run_cli(cli_train.main, [
                "--dataset", "synthetic", "--synthetic_size",
                str(CLI_TRAIN_SIZE), "--batch_size", str(BATCH),
                "--eval_batch_size", str(BATCH), "--precision", "32",
                "--max_epochs", "1", "--seed", str(SEED),
                "--workdir", f"{tmp}/live"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = counts(fns)
        f32 = torch.float32
        live_step = want(routed_layers(True, f32),
                         routed_layers(True, f32, bwd=True), 0)
        live_eval = want(routed_layers(False, f32), 0, 0)
        _cli_launch_checks(calls, live_step, live_eval, "live")
        steps = CLI_TRAIN_SIZE // BATCH
        check(state.step == steps, f"live: step count {state.step}")
        # the warm-up's one step, then the run's (captured)
        check(len(calls["train_step"]) == steps + 1,
              f"live: {len(calls['train_step'])} train steps")
        del state
        run = Path(tmp) / "live" / "rd" / "run_0"
        recs, losses = _run_losses(run, "live")
        ckpts = sorted(run.glob("checkpoints/*/state.pt"))
        check((run / "config.json").exists(), "live: no config.json")
        check(len(ckpts) == 1, f"live: checkpoints {ckpts}")
        step_s = next(r["epoch_train_step_time_s"] for r in recs
                      if "epoch_train_step_time_s" in r)
        out["train_live"] = {
            "dtype": "float32", "batch": BATCH, "steps": steps,
            "seconds": seconds, "launches": launches,
            "per_train_step": calls["train_step"][0],
            "per_val_forward": calls["eval_step"][0],
            "step_time_s": step_s, "bare_step_ms": bare_step_ms,
            "cli_over_bare": (1e3 * step_s / bare_step_ms
                              if bare_step_ms else None),
            "images_per_sec": next(r["epoch_train_images_per_sec"]
                                   for r in recs
                                   if "epoch_train_images_per_sec" in r),
            "losses": losses, "stdout": lines}
        for n in names:
            total[n] += launches[n]

        # 2. cli.evaluate on that checkpoint: the card, then card vs CPU
        ckdir = str(run / "checkpoints")
        grid, best = f"{tmp}/grid.png", f"{tmp}/best.txt"

        def evaluate(images, device=None, extra=()):
            argv = ["--checkpoint", ckdir, "--dataset", "synthetic",
                    "--num_images", str(images), "--batch_size", str(BATCH),
                    *extra] + (["--device", device] if device else [])
            return run_cli(cli_evaluate.main, argv)

        batches = -(-CLI_EVAL_IMAGES // BATCH)
        reset_counts(fns)
        with per_call_launches(fns) as calls:
            with recorded_predictions() as timed:
                avgs, lines = evaluate(CLI_EVAL_IMAGES, extra=(
                    "--grid_out", grid, "--best_txt", best))
            with recorded_predictions() as on_card:
                small, _ = evaluate(CLI_CPU_IMAGES)
        launches = counts(fns)
        forwards = len(calls["predict_step"])
        check(forwards == batches + 1 and all(
            ran_or_replayed(c, r, live_eval) for c, r in zip(
                calls["predict_step"], calls["replays"]["predict_step"])),
              f"evaluate: launches per forward {calls['predict_step']}")
        for n in names:
            total[n] += launches[n]
        check(all(np.isfinite(v) for v in avgs.values()),
              f"evaluate: non-finite averages {avgs}")
        # the warm batches: from the start of batch 1 to that of the last
        starts = [t for t, _, _ in timed]
        batch_ms = [1e3 * (b - a) for a, b in zip(starts[1:], starts[2:])]
        check(all(via == "Graphs.run" for _, _, via in timed),
              "evaluate: a forward on the card not captured")
        check(len(starts) == batches and len(batch_ms) == batches - 2,
              f"evaluate: {len(starts)} forwards")
        width, height = png_size(grid)
        every = max(CLI_EVAL_IMAGES // 9, 1)
        rows = sum((i * BATCH) % every == 0 for i in range(batches))
        check((width, height) == (384, 128 * rows),
              f"evaluate: grid {width} x {height}")
        check(Path(best).exists() and "rms=" in Path(best).read_text(),
              "evaluate: no best.txt")
        with recorded_predictions() as on_cpu:
            cpu, _ = evaluate(CLI_CPU_IMAGES, device="cpu")
        agree = {k: cli_within_bar(k, small[k], cpu[k], CLI_CPU_IMAGES)
                 for k in cpu}
        # the maps themselves: the largest pixel error over the CPU map's
        # largest magnitude, and relL2
        (_, card_map, _), = on_card
        (_, cpu_map, _), = on_cpu
        check(card_map.shape == cpu_map.shape == (CLI_CPU_IMAGES, 1, 128,
                                                  128),
              f"evaluate: maps {card_map.shape} {cpu_map.shape}")
        map_max = float((card_map - cpu_map).abs().max()
                        / cpu_map.abs().max().clamp_min(1e-30))
        map_rel = rel_l2(card_map, cpu_map)
        out["evaluate"] = {
            "images": CLI_EVAL_IMAGES, "batch": BATCH,
            "warm_batches": len(batch_ms), "batch_ms": batch_ms,
            "batch_ms_median": float(np.median(batch_ms)),
            "images_per_sec": BATCH * len(batch_ms) / (1e-3 * sum(batch_ms)),
            "averages": avgs,
            "grid_png": [width, height], "launches": launches,
            "card_vs_cpu": {"images": CLI_CPU_IMAGES, "card": small,
                            "cpu": cpu, "within_bar": agree,
                            "map_max_err_over_max_abs": map_max,
                            "map_rel_l2": map_rel, "tol": SERVE_TOL},
            "stdout": lines}
        check(all(agree.values()), f"evaluate: card vs CPU {agree}")
        check(map_max < SERVE_TOL and map_rel < SERVE_TOL,
              f"evaluate: card vs CPU maps {map_max} {map_rel}")

        # 3. the optimal set, bfloat16 (the CLI's default), --dev
        torch.cuda.empty_cache()
        reset_counts(fns)
        t0 = time.perf_counter()
        with per_call_launches(fns) as calls:
            state, lines = run_cli(cli_train.main, [
                "--decoders", *map(str, OPTIMAL), "--fusion_eps",
                str(OPTIMAL_EPS), "--dataset", "synthetic", "--batch_size",
                str(BATCH), "--eval_batch_size", str(BATCH), "--dev",
                "--seed", str(SEED), "--workdir", f"{tmp}/optimal"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = counts(fns)
        bf16 = torch.bfloat16
        k = len(OPTIMAL)
        _cli_launch_checks(
            calls, want(routed_layers(True, bf16, decoders=k),
                        routed_layers(True, bf16, bwd=True, decoders=k), 1),
            want(routed_layers(False, bf16, decoders=k), 0, 1), "optimal")
        check(state.step == 1, f"optimal: step count {state.step}")
        del state
        run = Path(tmp) / "optimal" / "rd" / "run_0"
        cfg = json.loads((run / "config.json").read_text())["config"]
        check(cfg["model"]["compute_dtype"] == "bfloat16"
              and tuple(cfg["model"]["decoder_ids"]) == OPTIMAL,
              f"optimal: config {cfg['model']}")
        _, losses = _run_losses(run, "optimal")
        out["train_optimal"] = {
            "dtype": "bfloat16", "batch": BATCH,
            "decoder_ids": list(OPTIMAL), "seconds": seconds,
            "launches": launches,
            "per_train_step": calls["train_step"][0],
            "per_val_forward": calls["eval_step"][0],
            "train_steps": len(calls["train_step"]),
            "val_forwards": len(calls["eval_step"]),
            "losses": losses, "stdout": lines}
        for n in names:
            total[n] += launches[n]
    torch.cuda.empty_cache()
    out["main_path_launches"] = total
    emit(out)
    return total, out["train_live"]["step_time_s"]


# The augment phase.  The card's augmentation against the CPU port's on the
# same factors, max abs (both compute the affine's float32 values the same
# way, so positions agree; the jitter's per-image mean luma sums in
# another order); a mask flip (read on depth: >= 1 inside the frame, 0
# outside) only where the source coordinate lies within MASK_EDGE of the
# frame's edge.  The C++ host resize against its numpy version: the bar
# of tests/test_native.py.  growth: the bars of serve and of kernel.
AUG_TOL = 1e-5
MASK_EDGE = 1e-4
NATIVE_TOL = 2e-3
RAW_HW = (250, 333)
FRAME = (480, 640)
HOST_FRAMES = 96
HOST_WORKERS = 6
GROWTH_FEAT_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def raw_batch(batch: int, seed: int, wire: str, invalid: bool = True):
    """A raw batch at RAW_HW made with numpy from the seed: rgb uint8 (or
    float32 in [0, 1]), depth in [0.5, 9.5), with an invalid (zero) corner
    if ``invalid``."""
    rng = np.random.default_rng(seed)
    shape = (batch,) + RAW_HW
    x = (rng.integers(0, 256, shape + (3,)).astype(np.uint8)
         if wire == "uint8" else rng.random(shape + (3,), np.float32))
    y = rng.random((batch, 1) + RAW_HW, np.float32) * 9 + 0.5
    if invalid:
        y[:, :, :20, :20] = 0.0
    return x, y


def source_edge_distance(factors, in_hw, out_hw, base):
    """Each output pixel's source coordinate's distance to the frame's
    edge, (B, oh, ow), from the port's own affine (on the CPU)."""
    from md_rdm_tpu_torch.data import augment as aug
    f = factors.cpu()
    a = aug.build_affine(in_hw, out_hw, base, f[:, 0], f[:, 1],
                         f[:, 2] > 0.5)[:, :, :, None, None]
    yy = torch.arange(out_hw[0], dtype=torch.float32)[:, None]
    xx = torch.arange(out_hw[1], dtype=torch.float32)[None, :]
    sy = aug._dot2(a[:, 0, 0], yy, a[:, 0, 1], xx) + a[:, 0, 2]
    sx = aug._dot2(a[:, 1, 0], yy, a[:, 1, 1], xx) + a[:, 1, 2]
    h, w = in_hw
    return torch.stack([sy.abs(), (sy - (h - 1)).abs(), sx.abs(),
                        (sx - (w - 1)).abs()]).amin(0)


def native_checks():
    """The host resize library: built from csrc/host_ops.cc on this
    machine, and its C++ against its numpy version on a camera frame."""
    from md_rdm_tpu_torch.data import native
    check(native.available(),
          f"host resize library not built: {native.BUILD_ERROR}")
    rng = np.random.default_rng(SEED)
    img = rng.integers(0, 256, FRAME + (3,)).astype(np.uint8)
    dep = rng.uniform(0.5, 10, FRAME).astype(np.float32)
    rh, rw = 333, 444      # the (250, 333) fill size of a 480 x 640 frame
    errs = {
        "resize_u8_to_f32": float(np.abs(
            native.resize_u8_to_f32(img, rh, rw)
            - native._resize_numpy(img.astype(np.float32), rh, rw)
            * (1.0 / 255.0)).max()),
        "resize_f32": float(np.abs(native.resize_f32(dep, rh, rw)
                                   - native._resize_numpy(dep, rh, rw)
                                   ).max())}
    check(all(e < NATIVE_TOL for e in errs.values()),
          f"host resize C++ vs numpy {errs}")
    return {"library": native._target().name, "max_abs_vs_numpy": errs,
            "tol": NATIVE_TOL}


def augment_checks():
    """The augmentation on the card against the CPU port on the same
    factors (drawn on the card): batch 16 of raw uint8 and float32, and
    uint8 with a base resize that reaches past the frame (the mask; the
    default keeps every crop inside it).  Depth has no invalid pixel here,
    so a zero is the fill."""
    from md_rdm_tpu_torch.data.augment import augment_with, draw_factors
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for wire, base in (("uint8", None), ("float32", None), ("uint8", 0.7)):
        x, y = raw_batch(BATCH, SEED + 10, wire, invalid=False)
        factors = draw_factors(gen, BATCH, "cuda")
        gx, gy = augment_with(torch.from_numpy(x).cuda(),
                              torch.from_numpy(y).cuda(), factors,
                              base_resize=base)
        cx, cy = augment_with(torch.from_numpy(x), torch.from_numpy(y),
                              factors.cpu(), base_resize=base)
        gx, gy = gx.cpu(), gy.cpu()
        check(gx.shape == (BATCH, 226, 226, 3) and gy.shape == (
            BATCH, 1, 226, 226) and gx.dtype == torch.float32,
              f"augment shapes {gx.shape} {gy.shape} {gx.dtype}")
        flips = (gy == 0) != (cy == 0)
        dist = source_edge_distance(factors, RAW_HW, (226, 226),
                                    base or 250.0 / min(RAW_HW))
        far = dist[flips[:, 0]]
        keep = ~flips
        keep3 = keep[:, 0, :, :, None].expand_as(gx)
        row = {"wire": wire, "base_resize": base,
               "max_abs_rgb": float((gx - cx)[keep3].abs().max()),
               "max_abs_depth": float((gy - cy)[keep].abs().max()),
               "mask_flips": int(flips.sum()),
               "flip_max_edge_distance": (float(far.max()) if far.numel()
                                          else None),
               "out_of_frame": float((cy == 0).float().mean()),
               "finite": bool(torch.isfinite(gx).all()
                              and torch.isfinite(gy).all()),
               "tol": AUG_TOL}
        rows.append(row)
        check(row["finite"], f"augment: non-finite output {row}")
        check(row["max_abs_rgb"] <= AUG_TOL
              and row["max_abs_depth"] <= AUG_TOL,
              f"augment: card vs CPU {row}")
        check(far.numel() == 0 or float(far.max()) <= MASK_EDGE,
              f"augment: mask flips away from the edge {row}")
        check((row["out_of_frame"] > 0) == (base is not None),
              f"augment: the fill {row}")
    return rows


def augment_times():
    """augment_batch alone at batch 16 (uint8 wire): CUDA events over
    back-to-back calls, the host enqueue, the profiler's device busy time
    and operations per call, and the least time for its bytes (raw batch
    read once, augmented batch written once)."""
    from md_rdm_tpu_torch.data.augment import augment_batch
    x, y = raw_batch(BATCH, SEED + 11, "uint8")
    xd, yd = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def run():
        return augment_batch(gen, xd, yd)

    nbytes = x.nbytes + y.nbytes + BATCH * 226 * 226 * 4 * 4
    prof = profile_window(run, 10)
    return {"batch": BATCH, "raw_hw": list(RAW_HW), "ms": cuda_ms(run, 20),
            "enqueue_ms": enqueue_ms(run, 5),
            "device_busy_ms": prof["device_busy_ms_per_call"],
            "device_ops": prof["device_ops_per_call"],
            "idle_share": prof["idle_share"], "top": prof["top"][:5],
            "bound_ms": 1e3 * nbytes / PEAK_BYTES, "bound_by": "bytes",
            "mbytes": nbytes / 1e6}


class _Frames:
    """Pre-rendered camera frames (uint8 rgb, as NYU's files hold them, and
    float32 depth), read by ``get_raw``."""

    def __init__(self, n: int):
        from md_rdm_tpu_torch.data.synthetic import SyntheticDepthDataset
        ds = SyntheticDepthDataset("train", size=n, output_size=FRAME,
                                   seed=SEED, correlated=True)
        self.items = []
        for i in range(n):
            rgb, depth = ds.get_raw(i)
            self.items.append((np.clip(np.rint(rgb * 255), 0, 255)
                               .astype(np.uint8), depth))

    def __len__(self):
        return len(self.items)

    def get_raw(self, index: int):
        return self.items[index]


class _NYURecipe:
    """NYU's host train recipe (``data/nyu.py::training_preprocess``: PIL
    jitter, resize, rotate, resize, crop, flip on the host) on frames."""

    resize, output_size = 250, (226, 226)

    def __init__(self, frames):
        self.frames = frames
        self.rng = np.random.default_rng(SEED)

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, index: int):
        from md_rdm_tpu_torch.data.nyu import NYUDataset
        return NYUDataset.training_preprocess(self,
                                              *self.frames.get_raw(index))


def host_pipelines():
    """Host ms per batch of 16, and bytes per batch on the wire, of the
    host recipe and of the raw path (RawResizeDataset, uint8 wire) over the
    same 480 x 640 frames with the same loader workers (the host clock over
    every batch of one pass)."""
    from md_rdm_tpu_torch.data.base import DataLoader
    from md_rdm_tpu_torch.data.raw import RawResizeDataset
    frames = _Frames(HOST_FRAMES)
    out = {"frames": HOST_FRAMES, "frame_hw": list(FRAME), "batch": BATCH,
           "workers": HOST_WORKERS}
    for name, ds in (("host_recipe", _NYURecipe(frames)),
                     ("raw_uint8", RawResizeDataset(
                         frames, raw_hw=RAW_HW, keep_uint8=True))):
        loader = DataLoader(ds, BATCH, num_workers=HOST_WORKERS)
        t0 = time.perf_counter()
        batches = [(x.nbytes + y.nbytes, x.dtype.name, x.shape)
                   for x, y in loader]
        secs = time.perf_counter() - t0
        out[name] = {"ms_per_batch": 1e3 * secs / len(batches),
                     "wire_mbytes_per_batch": batches[0][0] / 1e6,
                     "x_dtype": batches[0][1],
                     "x_shape": list(batches[0][2])}
    return out


def augmented_step_vs_cpu() -> dict:
    """One float32 train_step_device_aug of batch 2 with fixed factors, on
    the card and on the CPU port from the same weights: the loss terms."""
    from md_rdm_tpu_torch.core.config import Config
    from md_rdm_tpu_torch.data.augment import draw_factors
    from md_rdm_tpu_torch.training.module import DepthTrainer
    x, y = raw_batch(2, SEED + 12, "uint8")
    factors = draw_factors(torch.Generator().manual_seed(SEED + 12), 2)
    logs = {}
    for dev in ("cpu", "cuda"):
        trainer = DepthTrainer(Config(), device=dev)
        state = trainer.init(seed=SEED)
        _, got = trainer.train_step_device_aug(state, x, y, factors=factors)
        logs[dev] = {k: float(v) for k, v in got.items()}
        del trainer, state
    c, g = logs["cpu"], logs["cuda"]
    rel = {k: abs(g[k] - c[k]) / max(abs(c[k]), 1e-30)
           for k in ("loss", "MSE", "Ord_Loss", "Fine_Detail")}
    check(all(v < TRAIN_TOL["loss"] for v in rel.values()),
          f"augmented step: card vs CPU loss terms {rel}")
    return {"loss_rel": rel, "bar": TRAIN_TOL["loss"], "card": g, "cpu": c}


def growth_finding(smi) -> dict:
    """The live model with growth_matmul="on_all" against the default, on
    the card, eval mode, batch 16, both dtypes: encoder features (and in
    float32 the final maps) from the same weights; the S=29 and S=15
    blocks timed both ways (eval forward, and train forward + backward).
    Both models take fused_dense="off", so that every dense layer's 3x3
    conv is the formulation's or cuDNN's, not the sandwich kernels'."""
    from md_rdm_tpu_torch.core.config import ModelConfig
    from md_rdm_tpu_torch.core.device import no_tf32
    from md_rdm_tpu_torch.models.rdm import (DepthEstimationNet,
                                             init_parameters,
                                             randomize_batchnorm)
    from md_rdm_tpu_torch.ops.decompose import recombination
    base = DepthEstimationNet(ModelConfig())
    init_parameters(base, SEED)
    randomize_batchnorm(base, SEED + 1)
    sd = base.state_dict()
    x = torch.from_numpy(np.random.default_rng(SEED + 13).random(
        (BATCH, 226, 226, 3), dtype=np.float32)).cuda()
    rows, times = [], []
    for dt in DTYPES:
        out = {}
        models = {}
        for mode in ("auto", "on_all"):
            model = DepthEstimationNet(ModelConfig(
                compute_dtype=DT_NAME[dt], growth_matmul=mode,
                fused_dense="off"))
            model.load_state_dict(sd)
            model = models[mode] = model.cuda().eval()
            stages = {}
            with torch.no_grad():
                yhat, _, _ = model(x, stages)
                out[mode] = (stages["encoder"].float(),
                             recombination(list(yhat)).float())
        feat = rel_l2(out["on_all"][0], out["auto"][0])
        fmap = rel_l2(out["on_all"][1], out["auto"][1])
        # the final map is held in float32 only: in bfloat16 the hard
        # DORN decode flips where P is near 0.5 (ROADMAP queue 3)
        map_tol = SERVE_TOL if dt == torch.float32 else None
        row = {"dtype": DT_NAME[dt], "encoder_rel_l2": feat,
               "map_rel_l2": fmap, "feat_tol": GROWTH_FEAT_TOL[dt],
               "map_tol": map_tol}
        rows.append(row)
        check(feat < GROWTH_FEAT_TOL[dt]
              and (map_tol is None or fmap < map_tol),
              f"growth on_all vs default {row}")
        for s, c_in, block in ((29, 192, "dense_e3"), (15, 384, "dense_e4")):
            h = torch.randn(BATCH, c_in, s, s, device="cuda").relu().to(
                dt).contiguous(memory_format=torch.channels_last)
            t = {"dtype": DT_NAME[dt], "s": s}
            for mode, model in models.items():
                blk = getattr(model.encoder, block)
                hg = h.detach().requires_grad_()

                def fwd_bwd():
                    blk(hg).float().square().mean().backward()

                # float32 means float32 here too, as in the model's forward
                with no_tf32():
                    with torch.no_grad():
                        t[f"eval_ms_{mode}"] = cuda_ms(lambda: blk(h), 5)
                    blk.train()
                    t[f"train_ms_{mode}"] = cuda_ms(fwd_bwd, 3)
                    blk.eval()
            times.append(t)
        del models
        torch.cuda.empty_cache()
    return {"card": smi, "checks": rows, "blocks": times}


def phase_augment(smi, bare_step_ms=None, host_step_s=None):
    """On-device augmentation: the host resize library, the augmentation
    on the card against the CPU port and its time, the host recipe against
    the raw path, cli.train --augment device on the live model in float32
    at batch 16 (launches counted per call), one augmented batch-2 step
    against the CPU port; then the growth-conv formulation's finding."""
    import tempfile

    from md_rdm_tpu_torch.cli import train as cli_train

    out = {"phase": "augment", "card": smi, "native": native_checks(),
           "checks": augment_checks(), "times": augment_times(),
           "host": host_pipelines()}
    fns = path_counters()
    fwd = {fn.__name__ for fn in fwd_counters()}
    step_want = {fn.__name__: (0 if fn.__name__ == "fused_comparison_"
                               "quantize" else routed_layers(True)
                               if fn.__name__ in fwd
                               else routed_layers(True, bwd=True))
                 for fn in fns}
    val_want = {n: (routed_layers(False) if n in fwd else 0)
                for n in step_want}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_aug_") as tmp:
        reset_counts(fns)
        t0 = time.perf_counter()
        with per_call_launches(fns) as calls:
            state, lines = run_cli(cli_train.main, [
                "--dataset", "synthetic", "--augment", "device",
                "--synthetic_size", str(CLI_TRAIN_SIZE), "--batch_size",
                str(BATCH), "--eval_batch_size", str(BATCH), "--precision",
                "32", "--max_epochs", "1", "--seed", str(SEED),
                "--save_top_k", "0", "--workdir", tmp])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = counts(fns)
        _cli_launch_checks(calls, step_want, val_want, "augment")
        steps = CLI_TRAIN_SIZE // BATCH
        check(state.step == steps, f"augment: step count {state.step}")
        check(len(calls["train_step"]) == steps + 1,
              f"augment: {len(calls['train_step'])} train steps")
        del state
        recs, losses = _run_losses(Path(tmp) / "rd" / "run_0", "augment")
        step_s = next(r["epoch_train_step_time_s"] for r in recs
                      if "epoch_train_step_time_s" in r)
    torch.cuda.empty_cache()
    out["train_cli"] = {
        "dtype": "float32", "batch": BATCH, "steps": steps,
        "seconds": seconds, "launches": launches,
        "per_train_step": calls["train_step"][0],
        "per_val_forward": calls["eval_step"][0],
        "step_time_s": step_s, "bare_step_ms": bare_step_ms,
        "over_bare": 1e3 * step_s / bare_step_ms if bare_step_ms else None,
        "host_augment_step_time_s": host_step_s,
        "over_host_augment": step_s / host_step_s if host_step_s else None,
        "losses": losses, "stdout": lines}
    out["step_vs_cpu"] = augmented_step_vs_cpu()
    out["growth"] = growth_finding(smi)
    out["main_path_launches"] = launches
    emit(out)
    return launches


# ------------------------------------------------------------ distributed ---
DIST_STEPS = TRAIN_STEPS
DIST_TIMED = 5
DIST_PROFILED = 2
# The data-parallel step against the 1-process step on the same rows, both
# on the card, float32, each quantity held to FLOOR_FACTOR times the
# card's own floor and never looser than these bars.  The floor is the
# 1-process step on the same rows in reversed order against the rows in
# order: every sum over the batch (BatchNorm statistics, weight
# gradients, loss means) then runs in another order, as the data-parallel
# path's sums do, and the whole-model float32 step amplifies such
# rounding (ReLU inputs within rounding of 0 flip), the more so over
# several Adam steps.
DIST_TOL = {"loss": 1e-4, "stats": 1e-4, "grads": 1e-3, "params": 1e-5}
LOSS_TERMS = ("loss", "MSE", "Ord_Loss", "Fine_Detail")


def _flat32(tensors) -> torch.Tensor:
    return torch.cat([t.detach().float().reshape(-1) for t in tensors])


def step_vectors(model) -> dict:
    """A model's non-empty parameters, their gradients and its running
    statistics, each as one float32 vector on its device."""
    named = [(n, p) for n, p in model.named_parameters() if p.numel()]
    return {"params": _flat32(p for _, p in named),
            "grads": _flat32(p.grad for _, p in named),
            "stats": _flat32(b for n, b in model.named_buffers()
                             if "running" in n)}


def _errors(got_vec: dict, got_logs: dict, want_vec: dict,
            want_logs: dict) -> dict:
    """relL2 of each vector and the relative error of each loss term."""
    errs = {k: rel_l2(got_vec[k], want_vec[k]) for k in want_vec}
    errs.update({k: abs(got_logs[k] - want_logs[k])
                 / max(abs(want_logs[k]), 1e-30) for k in LOSS_TERMS})
    return errs


def _held(got: tuple, want: tuple, reordered: tuple) -> dict:
    """A step's (vectors, logs) against the 1-process step's, each error
    with its bar: FLOOR_FACTOR x the floor (``reordered``: the same
    1-process step on the rows in reversed order), never looser than
    DIST_TOL."""
    errs = _errors(*got, *want)
    floor = _errors(*reordered, *want)
    bars = {k: max(DIST_TOL["loss" if k in LOSS_TERMS else k],
                   FLOOR_FACTOR * floor[k]) for k in errs}
    return {"errors": errs, "floor": floor, "bars": bars,
            "ok": all(errs[k] < bars[k] for k in errs)}


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def one_rank_group(tmp: str) -> dict:
    """Trainer on the live model, float32: 3 steps of batch 16 from seeded
    weights in a 1-rank NCCL group, against the same steps without a group
    (and on the rows in reversed order: the floor); then DIST_TIMED more
    steps of each, timed, and a profiled warm-up and DIST_PROFILED steps.
    Launches are counted over the group's run.  The two are not bit-equal
    although a 1-rank sum is the identity: under a group, BatchNorm takes
    its statistics in explicit autograd ops (two passes, each through an
    all-reduce), not in one ``F.batch_norm``, and rounds otherwise."""
    import torch.distributed as dist

    from md_rdm_tpu_torch.core import mesh as mesh_lib
    from md_rdm_tpu_torch.core.config import Config, TrainConfig
    from md_rdm_tpu_torch.training.loop import Trainer

    x, y = train_batch(BATCH, SEED + 11)
    fns = path_counters()

    def run(mesh, name, rows=slice(None)):
        # eager both ways: the group's step is not captured
        trainer = Trainer(Config(train=TrainConfig(
            seed=SEED, checkpoint_dir=f"{tmp}/{name}")), mesh=mesh,
            capture=False)
        state = trainer.init_state()
        xd, yd = trainer._put(np.ascontiguousarray(x[rows]),
                              np.ascontiguousarray(y[rows]))
        calls, nbytes = mesh.counts.calls, mesh.counts.bytes
        logs = []
        for i in range(DIST_STEPS):
            state, lg = trainer._train_step(state, xd, yd)
            logs.append({k: float(v) for k, v in lg.items()})
            if i == 0:
                first = step_vectors(state.model)
        per_step = ((mesh.counts.calls - calls) / DIST_STEPS,
                    (mesh.counts.bytes - nbytes) / DIST_STEPS)
        vec = step_vectors(state.model)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DIST_TIMED):
            state, lg = trainer._train_step(state, xd, yd)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / DIST_TIMED
        prof = profile_window(lambda: trainer._train_step(state, xd, yd),
                              DIST_PROFILED)
        n_params = sum(p.numel() for p in state.model.parameters())
        trainer.close()
        del state, trainer
        torch.cuda.empty_cache()
        return {"logs": logs, "first": first, "vec": vec,
                "collectives": per_step,
                "step_ms": ms, "n_params": n_params, "profile": prof}

    card = torch.device("cuda", 0)
    plain = run(mesh_lib.Mesh(device=card), "plain")
    reordered = run(mesh_lib.Mesh(device=card), "reordered",
                    slice(None, None, -1))
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
        world_size=1, device_id=card)
    try:
        mesh = mesh_lib.create_mesh(1, card)
        check(mesh.group is not None, "no 1-rank group")
        reset_counts(fns)
        group = run(mesh, "group")
        launches = counts(fns)
    finally:
        dist.destroy_process_group()
    # the first step's gradients, parameters, running statistics and
    # losses; the parameters and statistics after the steps (the
    # gradients of the third step are not held: two orders of the same
    # rows give gradients 89% apart by then)
    held = {"first_step": _held(
        *((r["first"], r["logs"][0]) for r in (group, plain, reordered))),
        f"after_{DIST_STEPS}_steps": _held(
        *(({k: r["vec"][k] for k in ("params", "stats")}, r["logs"][-1])
          for r in (group, plain, reordered)))}
    held["ok"] = all(h["ok"] for h in held.values())
    bit_equal = {k: bool(torch.equal(group["first"][k], plain["first"][k]))
                 for k in group["first"]}
    bit_equal["logs"] = group["logs"] == plain["logs"]
    calls, nbytes = group["collectives"]
    return {"launches": launches, "held": held, "bit_equal": bit_equal,
            "losses_group": [lg["loss"] for lg in group["logs"]],
            "losses_plain": [lg["loss"] for lg in plain["logs"]],
            "collectives_per_step": calls, "bytes_per_step": nbytes,
            "gradient_bytes_per_step": 4 * group["n_params"],
            "step_ms_group": group["step_ms"],
            "step_ms_no_group": plain["step_ms"],
            "profile_group": group["profile"],
            "profile_no_group": plain["profile"],
            "group_over_no_group": group["step_ms"] / plain["step_ms"]}


# Faults planted in the live 2-rank step, each of which its bars must
# catch: BatchNorm on each rank's rows alone (the group's context never
# read), and gradients left unaveraged.
DIST_FAULTS = {"per_rank_norm": ("current", lambda: None),
               "unaveraged_gradients": ("average_gradients",
                                        lambda mesh, params: None)}


@contextlib.contextmanager
def planted(fault: str):
    """``core.mesh`` with the function behind ``fault`` stubbed out."""
    from md_rdm_tpu_torch.core import mesh as mesh_lib

    name, stub = DIST_FAULTS[fault]
    saved = getattr(mesh_lib, name)
    setattr(mesh_lib, name, stub)
    try:
        yield
    finally:
        setattr(mesh_lib, name, saved)


def _rank_step(mesh, cfg, seed: int, faults=()) -> dict:
    """One float32 train step of the global batch of BATCH rows, this
    rank's rows, from seeded weights, then the same step with each planted
    fault in ``faults``; rank 0 then holds each against the 1-process step
    on all rows (and on them in reversed order: the floor)."""
    from md_rdm_tpu_torch.core import mesh as mesh_lib
    from md_rdm_tpu_torch.training.module import DepthTrainer

    fns = path_counters()
    x, y = train_batch(BATCH, seed)
    xs, ys = mesh_lib.shard_batch(mesh, x), mesh_lib.shard_batch(mesh, y)

    def step():
        """(vectors, logs, seconds, launches) of one step from the seeded
        weights."""
        trainer = DepthTrainer(cfg, mesh=mesh)
        state = trainer.init(seed=SEED)
        reset_counts(fns)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, logs = trainer.train_step(state, xs, ys)
        torch.cuda.synchronize()
        seconds, launches = time.perf_counter() - t0, counts(fns)
        vec = step_vectors(state.model)
        del state, trainer
        torch.cuda.empty_cache()
        return vec, {k: float(v) for k, v in logs.items()}, seconds, launches

    vec, logs, seconds, launches = step()
    out = {"rows": BATCH // mesh.world_size,
           "seconds_processes_sharing_one_card": seconds,
           "launches": launches, "logs": logs}
    planted_steps = {}
    for fault in faults:
        with planted(fault):
            planted_steps[fault] = step()[:2]
    if mesh.is_main:
        refs = []
        for rows in (slice(None), slice(None, None, -1)):
            one = DepthTrainer(cfg, device=mesh.device)
            st = one.init(seed=SEED)
            st, lg = one.train_step(st, np.ascontiguousarray(x[rows]),
                                    np.ascontiguousarray(y[rows]))
            refs.append((step_vectors(st.model),
                         {k: float(v) for k, v in lg.items()}))
            del st, one
            torch.cuda.empty_cache()
        out["held"] = _held((vec, out["logs"]), *refs)
        out["planted"] = {}
        for fault, got in planted_steps.items():
            held = _held(got, *refs)
            held["failed"] = sorted(k for k in held["errors"]
                                    if held["errors"][k] >= held["bars"][k])
            out["planted"][fault] = held
    del vec, planted_steps
    torch.cuda.empty_cache()
    mesh.barrier()
    return out


def _dist_rank(rank: int, world: int, init_file: str, out_dir: str,
               backend: str) -> None:
    """One rank of the 2-rank phase (a spawned process): the live model's
    step with and without each planted fault, then the optimal set's, on
    the batches of phases 6 and 12; its results to rank<r>.json.  (On
    the batch from seed SEED + 13 the fine-detail loss is NaN, the
    1-process step's too: two of its uniform-noise depth maps go negative
    under the bicubic resize to the ordinal target's 8x8, whose SID label
    is then NaN, as in the JAX package; ROADMAP queue 3.)"""
    import torch.distributed as dist

    from md_rdm_tpu_torch.core import mesh as mesh_lib
    from md_rdm_tpu_torch.core.config import Config

    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    extra = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world, **extra)
    try:
        mesh = mesh_lib.create_mesh(world, dev)
        res = {"device": str(dev), "backend": backend,
               "live": _rank_step(mesh, Config(), SEED + 3, DIST_FAULTS),
               "optimal": _rank_step(mesh, optimal_train_config(
                   torch.float32), SEED + 6)}
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def two_ranks(tmp: str) -> dict:
    """The 2-rank steps in two spawned processes: NCCL on two cards where
    there are two, else gloo with both processes on cuda:0."""
    import torch.multiprocessing as mp

    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    ctx = mp.start_processes(_dist_rank, nprocs=2, join=False,
                             start_method="spawn",
                             args=(2, f"{tmp}/rendezvous", tmp, backend))
    while not ctx.join(timeout=900):
        pass
    return {"backend": backend,
            "ranks": [json.loads(Path(tmp, f"rank{r}.json").read_text())
                      for r in range(2)]}


def distributed_cli_rank(argv) -> int:
    """A rank of ``cli.train`` under torch.distributed.run (chip_smoke.py
    --distributed-cli-rank <dir> -- <cli flags>): the CLI's main with the
    kernels' launches counted, written to <dir>/rank<r>.json."""
    from md_rdm_tpu_torch.cli import train as cli_train

    out_dir = argv[argv.index("--distributed-cli-rank") + 1]
    fns = path_counters()
    reset_counts(fns)
    state = cli_train.main(argv[argv.index("--") + 1:])
    rank = int(os.environ["RANK"])
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(
        {"launches": counts(fns), "step": state.step}))
    return 0


def cli_under_launcher(tmp: str) -> dict:
    """cli.train --dataset synthetic --dev on the live model in float32,
    under python -m torch.distributed.run (one process per card): its run
    directory, its checkpoint and each rank's launches."""
    nproc = min(torch.cuda.device_count(), 2)
    work = Path(tmp, "cli")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), str(Path(__file__).resolve()),
           "--distributed-cli-rank", tmp, "--",
           "--dataset", "synthetic", "--dev", "--devices", str(nproc),
           "--precision", "32", "--batch_size", str(BATCH),
           "--eval_batch_size", str(BATCH), "--seed", str(SEED),
           "--workdir", str(work)]
    t0 = time.perf_counter()
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if done.returncode:
        print(done.stdout[-4000:], done.stderr[-4000:], file=sys.stderr)
    check(done.returncode == 0, f"torch.distributed.run cli.train exit "
                                f"{done.returncode}")
    runs = sorted((work / "rd").iterdir())
    check([r.name for r in runs] == ["run_0"], f"run directories {runs}")
    cfg = json.loads((runs[0] / "config.json").read_text())
    ckpts = sorted(runs[0].glob("checkpoints/*/state.pt"))
    check(cfg["world_size"] == nproc and len(cfg["devices"]) == nproc,
          f"config.json world {cfg['world_size']} {cfg['devices']}")
    check(len(ckpts) == 1, f"checkpoints {ckpts}")
    ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text())
             for r in range(nproc)]
    return {"nproc_per_node": nproc, "seconds": seconds,
            "run_dir": runs[0].name, "checkpoint": str(
                ckpts[0].relative_to(runs[0])),
            "checkpoint_bytes": ckpts[0].stat().st_size,
            "devices": cfg["devices"], "ranks": ranks,
            "stdout_tail": done.stdout.splitlines()[-3:]}


def phase_distributed(smi) -> dict:
    """Data-parallel training (``core/mesh.py``): the 1-rank NCCL group
    against no group; 2 ranks against 1 process on the live model and the
    optimal set; cli.train under torch.distributed.run.  Returns the
    launches of the phase's main paths, summed over its processes."""
    import tempfile

    fns = path_counters()
    names = [fn.__name__ for fn in fns]
    fwd = {fn.__name__ for fn in fwd_counters()}
    b4 = "fused_comparison_quantize"
    step = {n: 0 if n == b4 else routed_layers(True) if n in fwd
            else routed_layers(True, bwd=True) for n in names}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp:
        one = one_rank_group(tmp)
        emit({"phase": "distributed_one_rank_nccl", "card": smi, **one})
        check(one["held"]["ok"], f"1-rank group vs no group {one['held']}")
        check(one["launches"] == {n: step[n] * (
            DIST_STEPS + DIST_TIMED + 1 + DIST_PROFILED) for n in names},
              f"1-rank group launches {one['launches']}")
        two = two_ranks(tmp)
        emit({"phase": "distributed_two_ranks", "card": smi, **two})
        cli = cli_under_launcher(tmp)
        emit({"phase": "distributed_cli", "card": smi, **cli})
    for case, b4_n in (("live", 0), ("optimal", 1)):
        r0, r1 = (r[case] for r in two["ranks"])
        check(r0["logs"] == r1["logs"], f"{case}: ranks' logs differ")
        check(r0["held"]["ok"], f"{case}: 2 ranks vs 1 process "
                                f"{r0['held']}")
        check(set(r0["planted"]) == (set(DIST_FAULTS) if case == "live"
                                     else set()),
              f"{case}: planted faults {sorted(r0['planted'])}")
        for fault, held in r0["planted"].items():
            want = {"grads", "stats"} if fault == "per_rank_norm" else {
                "grads"}
            check(want <= set(held["failed"]),
                  f"{case}: planted {fault} failed only {held['failed']}")
        for r in (r0, r1):
            want = {n: b4_n if n == b4 else step[n] for n in names}
            check(r["launches"] == want, f"{case}: launches {r['launches']}")
    for r in cli["ranks"]:
        check(r["step"] == 1, f"cli under torchrun: step {r['step']}")
        # a two-step warm-up, one step and one val forward
        check(all(r["launches"][n] == (0 if n == b4 else 3 * step[n] + (
            routed_layers(False) if n in fwd else 0)) for n in names),
              f"cli under torchrun: launches {r['launches']}")
    total = dict(one["launches"])
    for rank in two["ranks"]:
        for case in ("live", "optimal"):
            for n in names:
                total[n] += rank[case]["launches"][n]
    for rank in cli["ranks"]:
        for n in names:
            total[n] += rank["launches"][n]
    return total


def _totals(rows):
    """Float32 (the default compute dtype) sums over the six S=57 layers."""
    f32 = [r for r in rows if r["dtype"] == "float32"]
    return {k: sum(r[k] for r in f32)
            for k in ("ms", "plain_ms", "library_ms", "bound_ms")}


SOURCE = "md_rdm_tpu_torch/csrc/dense_sandwich.cu"
# One PyTorch call computing each sandwich kernel's function (its library
# time), where there is one.
STAGE_LIBRARY = {
    "fwd_expand": None,
    "fwd_taps": "torch.mm(r, w2n), output in the compute dtype",
    "fwd_tapsum": None,
    "bwd_recompute": None,
    "bwd_dx": "torch.mm(dz, w1 as [C_mid, C_in])",
    "bwd_dw1": "torch.mm(dz^T, x), output in the compute dtype",
    "bwd_dw2": "torch.nn.grad.conv2d_weight(r, g), output in the compute "
               "dtype",
}


def stage_entry(name, time_rows, check_rows, launches, replaces, headline):
    """One sandwich kernel's entry: float32 sums over the six S=57 layers
    of its time rows, the largest float32 error of its checks, per-shape
    rows."""
    f32 = [r["kernels"][name] for r in time_rows if r["dtype"] == "float32"]
    tot = {k: (sum(r[k] for r in f32)
               if all(r[k] is not None for r in f32) else None)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    by_ops = (sum(r["gflop"] for r in f32) * 1e9 / PEAK_FLOPS[torch.float32]
              >= sum(r["mbytes"] for r in f32) * 1e6 / PEAK_BYTES)
    return {"name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(c["stages"][name]["max_abs_err"]
                               for c in check_rows
                               if c["dtype"] == "float32"),
            **tot, "bound_by": "operations" if by_ops else "bytes",
            "library": STAGE_LIBRARY[name], "headline": headline,
            "shapes": [{"c_in": r["c_in"], "dtype": r["dtype"],
                        **r["kernels"][name]} for r in time_rows]}


def flat_entries(flat) -> list:
    """B2f (``_kernel_flat``) and flat B2b (``_bwd_kernel_flat``): the
    block-native I/O, F1-F3 with F3 writing into the block's buffer by row
    stride, K1-K4 with K1 and K4 reading the cotangent's slot by row
    stride."""
    src = "md_rdm_tpu/kernels/dense_sandwich.py:"
    out = []
    for name, part, line, kernels, lib in (
            ("dense_sandwich_flat", "forward", "452", ("fwd_tapsum",),
             "sequence: F.conv2d 1x1, affine, ReLU, F.conv2d 3x3"),
            ("dense_sandwich_flat_bwd", "backward", "542",
             ("bwd_recompute", "bwd_dw2"),
             "torch.autograd.grad through the cuDNN sequence")):
        t = flat["times"][part]
        f32 = [c for c in flat["checks"] if c["dtype"] == "float32"]
        out.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": src + line,
            "launches": flat["launches"][kernels[0]],
            "launches_strided": {k: flat["launches"][k] for k in kernels},
            "max_abs_err": max(c[part]["max_abs_err"] for c in f32),
            **{k: t[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                 "bound_by")},
            "library": lib,
            "headline": f"float32, the {part} kernels composed on a slot of "
                        "the block's buffer (S=57 C_in 288 of 384, S=15 "
                        "C_in 2,016 of 2,112), batch 16, summed",
            "strided": kernels,
            "shapes": t["layers"],
            "checks": flat["checks"]})
    return out


def kernels_line(checks, bwd_checks, time_rows, bwd_rows, serve_launches,
                 per_forward, per_step, train_launches, lloyd_checks,
                 lloyd_forward,
                 lloyd_rows, optimal_launches, b4_per_forward,
                 train_optimal_launches,
                 loop_launches, cli_launches, augment_launches,
                 distributed_launches, routing, flat):
    """One entry per ported kernel.  Headline numbers of the sandwich
    kernels are float32, summed over the six S=57 layers of one forward or
    one backward at batch 16; B4's are its one launch in a batch-16
    optimal-set forward, with the one-segment entry's rows per page count
    after it.  ``launches``
    adds the counts of the main paths' runs: the served requests of both
    configurations, the train steps of both, the loop, the CLIs, the
    CLI's training on device-augmented batches, the data-parallel
    phase's processes (``launches_distributed``) and the routing phase's
    live model per fused_dense mode (``launches_routing``).  B1's three
    kernels are listed under its entry, and the S=29 / S=15 blocks'
    sandwiches (``routing_blocks``) under B1's and the backward's.  B2f's
    and flat B2b's entries are F3 writing by row stride and K1 / K4
    reading by row stride (phase 18): their launches are the strided
    ones of the flat model's run, their times the composed kernels on a
    slot at two layers (``FLAT_SLOTS``), float32."""
    src = "md_rdm_tpu/kernels/"
    fwd, bwd = _totals(time_rows), _totals(bwd_rows)
    lloyd = {k: lloyd_forward[k]
             for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    b4 = optimal_launches["fused_comparison_quantize"]
    routed = routing["main_path_launches"]
    trained = (train_optimal_launches, loop_launches, cli_launches,
               augment_launches, distributed_launches,
               {**routed, "fused_comparison_quantize": 0})

    def blocks(part):
        return [{"s": r["s"], "layers": r["layers"], "dtype": r["dtype"],
                 **r[part]} for r in routing["sandwiches"]]

    def fwd_launches(name):
        return (serve_launches[name] + train_launches[name]
                + optimal_launches[name] + sum(t[name] for t in trained))

    fwd_entries = [stage_entry(
        name, time_rows, checks, fwd_launches(name),
        src + "dense_sandwich.py:131",
        "float32, sum over the six S=57 layers, batch 16; F2 and F3 fed "
        "the plain output of the stage before") for name in FWD_STAGES]
    for entry in fwd_entries:
        entry["launches_distributed"] = distributed_launches[entry["name"]]
        entry["launches_routing"] = routed[entry["name"]]
    bwd_entries = []
    for name in BWD_STAGES:
        entry = stage_entry(
            name, bwd_rows, bwd_checks,
            train_launches[name] + sum(t[name] for t in trained),
            src + "dense_sandwich.py:245",
            "float32, sum over the six S=57 layers, batch 16; K2-K4 fed the "
            "plain K1 outputs")
        entry.update(also_replaces=[
            src + "dense_sandwich_nhwc.py:168 (_bwd_kernel)"],
            launches_per_step={dt: n[name] for dt, n in per_step.items()},
            launches_train=train_launches[name],
            launches_train_optimal=train_optimal_launches[name],
            launches_loop=loop_launches[name],
            launches_cli=cli_launches[name],
            launches_augment=augment_launches[name],
            launches_distributed=distributed_launches[name],
            launches_routing=routed[name])
        bwd_entries.append(entry)
    bwd_entries[0]["backward"] = {
        **bwd,
        "library": "torch.autograd.grad through the cuDNN sequence "
                   "(z saved, not recomputed)",
        "headline": "float32, the four kernels composed, sum over the six "
                    "S=57 layers, batch 16",
        "shapes": [{k: v for k, v in r.items() if k != "kernels"}
                   for r in bwd_rows],
        "routing_blocks": blocks("backward"),
        "checks": bwd_checks,
    }
    return {"kernels": [{
        "name": "dense_sandwich",
        "route": "cuda",
        "source": SOURCE,
        "replaces": src + "dense_sandwich.py:131",
        "also_replaces": [src + "dense_sandwich_nhwc.py:65 (_kernel)"],
        "launches": fwd_launches("dense_sandwich"),
        "launches_serve": serve_launches["dense_sandwich"],
        "launches_train": train_launches["dense_sandwich"],
        "launches_serve_optimal": optimal_launches["dense_sandwich"],
        "launches_train_optimal": train_optimal_launches["dense_sandwich"],
        "launches_loop": loop_launches["dense_sandwich"],
        "launches_cli": cli_launches["dense_sandwich"],
        "launches_augment": augment_launches["dense_sandwich"],
        "launches_distributed": distributed_launches["dense_sandwich"],
        "launches_routing": routed["dense_sandwich"],
        "launches_per_forward": per_forward,
        "max_abs_err": max(c["max_abs_err"] for c in checks
                           if c["dtype"] == "float32"),
        **fwd,
        "bound_by": "operations",
        "library": "sequence: F.conv2d 1x1, affine, ReLU, F.conv2d 3x3",
        "headline": "float32, F1-F3 composed, sum over the six S=57 "
                    "layers, batch 16",
        "stages": fwd_entries,
        "shapes": [{k: v for k, v in r.items() if k != "kernels"}
                   for r in time_rows],
        "routing_blocks": blocks("forward"),
        "checks": checks,
    }, *bwd_entries, *flat_entries(flat), {
        "name": "fused_comparison_quantize",
        "route": "cuda",
        "source": "md_rdm_tpu_torch/csrc/lloyd.cu",
        "replaces": src + "lloyd.py:34",
        "launches": b4 + sum(t["fused_comparison_quantize"]
                             for t in trained),
        "launches_serve_optimal": b4,
        "launches_train_optimal":
            train_optimal_launches["fused_comparison_quantize"],
        "launches_loop": loop_launches["fused_comparison_quantize"],
        "launches_cli": cli_launches["fused_comparison_quantize"],
        "launches_augment": augment_launches["fused_comparison_quantize"],
        "launches_distributed":
            distributed_launches["fused_comparison_quantize"],
        "launches_per_forward": b4_per_forward,
        "max_abs_err": max(c["max_abs_err"] for c in lloyd_checks),
        **lloyd,
        "bound_by": lloyd_forward["bound_by"],
        "library": "per segment split_matrix paging, "
                   "comparison_cross_scale, torch.bucketize, level gather; "
                   "then torch.cat",
        "headline": "the one launch of a batch-16 optimal-set forward "
                    "(segments of 16/32/64, 336 pages)",
        "forward": lloyd_forward,
        "shapes": lloyd_rows,
        "checks": lloyd_checks,
    }]}


# ------------------------------------------------------------------- graph ---
# Phase 19: the port's counterpart of jax.jit (core/graphs.py), captured
# against eager on the same weights and inputs.  A captured forward runs
# the eager forward's kernels in the same order; where it is not bit for
# bit the eager one's it is held at GRAPH_SERVE_TOL relL2: cuBLAS and
# cuDNN may pick another algorithm or workspace for the capturing stream.
# A train step is not bit for bit even eager against eager: the backward
# kernels' split sums are atomic, as are cuDNN's weight gradients.  Adam
# moves a parameter by about lr whatever its gradient's size, and the
# optimal set's relative maps are quantized, so two eager runs part
# within a few steps (on an H100 80GB HBM3 at 700 W: parameters 2.6e-4
# relL2 apart after 3 live f32 steps, the optimal set's loss terms
# 1e-2).  So
# before each step the eager states take the captured state's weights,
# statistics and optimizer state, and the step is held from the same
# state: its losses, parameters and running statistics to FLOOR_FACTOR
# times the floor, a second eager state's distance from the first (the
# largest seen so far in the run), never looser than TRAIN_TOL's fixed
# bars; their bit equality is reported.
GRAPH_SERVE_TOL = 1e-6
GRAPH_STEPS = 3
# (model, dtype, remat) of the train checks: both sets and both dtypes with
# remat on (the default), the live model's with remat off too
GRAPH_TRAIN = tuple((m, dt, remat) for m in ("live", "optimal")
                    for dt in DTYPES for remat in (True, False)
                    if remat or m == "live")
# the live step's seeds without a NaN row (ROADMAP queue 3)
GRAPH_SEEDS = (3, 6, 11)


def _graph_model(name: str, dt, **model):
    from md_rdm_tpu_torch.core.config import ModelConfig
    if name == "optimal":
        return ModelConfig(decoder_ids=OPTIMAL, fusion_eps=OPTIMAL_EPS,
                           compute_dtype=DT_NAME[dt], **model)
    return ModelConfig(compute_dtype=DT_NAME[dt], **model)


def _agree(got, want) -> dict:
    """Tensors (or trees of them) against each other: bit equality and
    relL2, None entries skipped."""
    got = [t for t in torch.utils._pytree.tree_leaves(got)
           if isinstance(t, torch.Tensor)]
    want = [t for t in torch.utils._pytree.tree_leaves(want)
            if isinstance(t, torch.Tensor)]
    check(len(got) == len(want), "graph: output structures differ")
    return {"bit_equal": all(torch.equal(a, b) for a, b in zip(got, want)),
            "rel_l2": max((rel_l2(a.float(), b.float())
                           for a, b in zip(got, want)), default=0.0)}


def _timed(fns: dict, iters: int, profile_reps: int,
           enqueue_iters: int = 2) -> dict:
    """Each entry timed in turns (a, b, b, a): CUDA events (the lesser of
    the two), host enqueue of one call, and a profiled window (for the
    captured entry with the host operations that take the most host
    time)."""
    names = list(fns)
    ms = {n: [] for n in names}
    for n in names + names[::-1]:
        ms[n].append(cuda_ms(fns[n], iters, warmup=0))
    out = {}
    for n in names:
        prof = profile_window(fns[n], profile_reps,
                              host_top=n == "captured")
        out[n] = {"ms": min(ms[n]), "ms_turns": ms[n],
                  "img_per_s": BATCH * 1e3 / min(ms[n]),
                  "host_ms": enqueue_ms(fns[n], iters=enqueue_iters),
                  "device_busy_ms": prof["device_busy_ms_per_call"],
                  "profiled_wall_ms": prof["wall_ms_per_call"],
                  "idle_share": prof["idle_share"],
                  "device_ops": prof["device_ops_per_call"],
                  "top": prof["top"][:8], "host_top": prof.get("host_top")}
    return out


def _peak(fn) -> dict:
    """One call of ``fn`` after the allocator's free cache is emptied: the
    peak of allocated memory during it (a replay allocates nothing in its
    pool), the part of that peak the call added, and the memory reserved
    after it (allocated tensors, the pools of the live graphs, and the
    blocks an eager call left cached): the call's footprint."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return {"peak_gb": peak / 1e9, "own_gb": (peak - resident) / 1e9,
            "reserved_gb": torch.cuda.memory_reserved() / 1e9}


def _reserved_during(fn):
    """(fn's result, bytes the allocator reserved while it ran, its free
    cache emptied first, as a capture empties it): around a capture, the
    graph's pool."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.memory_reserved() - before


def graph_serve(fns) -> list:
    """Per set and dtype: Predictor captured against capture=False on the
    same weights, batch 16: four calls each (the captured one warms,
    captures, replays twice) on three batches, every call's output and
    launches against the eager call's; times, idle share, pool bytes and
    peak memory of a call."""
    import copy

    from md_rdm_tpu_torch.inference import Predictor
    from md_rdm_tpu_torch.models.rdm import (DepthEstimationNet,
                                             init_parameters,
                                             randomize_batchnorm)
    rows = []
    rng = np.random.default_rng(SEED + 19)
    xs = [torch.from_numpy(rng.random((BATCH, 226, 226, 3),
                                      dtype=np.float32)).cuda()
          for _ in range(3)]
    order = (0, 1, 2, 0)
    for name in ("live", "optimal"):
        model = DepthEstimationNet(_graph_model(name, torch.float32))
        init_parameters(model, SEED)
        randomize_batchnorm(model, SEED + 1)
        sd = model.state_dict()
        del model
        for dt in DTYPES:
            captured = Predictor(sd, _graph_model(name, dt))
            check(captured.graphs is not None,
                  "graph: the Predictor's capture default")
            # capture=False on the same model: the Predictor without its
            # graphs
            eager = copy.copy(captured)
            eager.graphs = None
            preds = {"eager": eager, "captured": captured}
            del eager, captured
            outs = {k: [] for k in preds}
            launches = {k: [] for k in preds}
            replays = {k: [] for k in preds}
            pool = traced = None
            with torch.inference_mode():
                for k, pred in preds.items():
                    for n, i in enumerate(order):
                        def call(pred=pred, i=i):
                            return pred.predict(xs[i])
                        if k == "captured" and n == 1:      # the capture
                            (out, got, reps), pool = _reserved_during(
                                lambda: call_launches(fns, call))
                        elif k == "captured" and n == len(order) - 1:
                            before = counts(fns)
                            out, traced, reps = traced_launches(fns, call)
                            got = since(fns, before)
                        else:
                            out, got, reps = call_launches(fns, call)
                        launches[k].append(got)
                        replays[k].append(reps)
                        outs[k].append(out)
                # every kept result against the eager call's, after the
                # last call: a result that aliased the graph's outputs
                # would hold the last replay's
                agree = [_agree(c, e) for c, e in zip(outs["captured"],
                                                      outs["eager"])]
                del outs, pred
                calls = {k: (lambda p=p: p.predict(xs[0]))
                         for k, p in preds.items()}
                times = _timed(calls, 2, 1)
                peak = {k: _peak(fn) for k, fn in calls.items()}
                del calls
            eager = launches["eager"][0]
            row = {"set": name, "dtype": DT_NAME[dt], "batch": BATCH,
                   "calls": agree,
                   "launches_eager": eager,
                   "launches_captured": launches["captured"],
                   "replays_captured": replays["captured"],
                   "replay_traced": traced,
                   "graphs": len(preds["captured"].graphs),
                   "pool_reserved_gb": pool / 1e9, "peak": peak,
                   "times": times,
                   "captured_over_eager": times["captured"]["ms"]
                   / times["eager"]["ms"]}
            rows.append(row)
            emit({"phase": "graph", "part": "serve", **row})
            check(all(a["bit_equal"] or a["rel_l2"] <= GRAPH_SERVE_TOL
                      for a in agree),
                  f"graph: captured forward differs from eager {row}")
            # eager calls and the captured warm-up and capture run the
            # path's Python; the replays none, their kernels traced
            check(all(c == eager for c in launches["eager"])
                  and launches["captured"][:2] == [eager, eager]
                  and replays["captured"] == [0, 1, 1, 1]
                  and all(ran_or_replayed(c, r, eager) for c, r in zip(
                      launches["captured"], replays["captured"]))
                  and traced == kernel_counts(eager),
                  f"graph: launches per call {launches} {replays}, "
                  f"replay traced {traced}")
            check(len(preds["captured"].graphs) == 1,
                  f"graph: {len(preds['captured'].graphs)} graphs")
            del preds
            torch.cuda.empty_cache()
    return rows


def _seeded_weights(model_cfg) -> dict:
    """The state_dict of ``init_parameters(model, SEED)`` (made on the CPU,
    as DepthTrainer.init makes it), on the card."""
    from md_rdm_tpu_torch.models.rdm import DepthEstimationNet, init_parameters
    model = DepthEstimationNet(model_cfg)
    init_parameters(model, SEED)
    return {k: v.cuda() for k, v in model.state_dict().items()}


def _on_card(trainer, weights):
    """trainer.module.init(weights) with the model built on the card: no
    default initialization on the CPU before the weights are loaded."""
    with torch.device("cuda"):
        return trainer.module.init(weights)


def _twin(trainer, state):
    """A second state with ``state``'s weights (a copy on the card) and a
    fresh optimizer built as DepthTrainer.init builds it."""
    import copy

    from md_rdm_tpu_torch.training.module import TrainState
    from md_rdm_tpu_torch.training.optim import make_optimizer
    t = trainer.config.train
    model = copy.deepcopy(state.model)
    return TrainState(model, make_optimizer(
        model, t.learning_rate, t.weight_decay, fast_modules=t.fast_modules,
        fast_multiplier=t.fast_lr_multiplier), state.step)


def _step_errors(got, want, got_logs, want_logs) -> dict:
    """A state after a step against another: the loss terms' largest
    relative error, the parameters' and running statistics' relL2, and
    the bit equality of the logs, parameters and statistics."""
    def vectors(model):
        named = [(n, p) for n, p in model.named_parameters() if p.numel()]
        return (_flat32(p for _, p in named),
                _flat32(b for n, b in model.named_buffers()
                        if "running" in n))

    (gp, gs), (wp, ws) = vectors(got.model), vectors(want.model)
    return {"loss": max(abs(float(got_logs[k]) - float(want_logs[k]))
                        / max(abs(float(want_logs[k])), 1e-30)
                        for k in LOSS_TERMS),
            "params": rel_l2(gp, wp), "stats": rel_l2(gs, ws),
            "bit_equal": {"logs": _agree(got_logs, want_logs)["bit_equal"],
                          "params": bool(torch.equal(gp, wp)),
                          "stats": bool(torch.equal(gs, ws))}}


def _step_held(states, logs, seen: dict) -> dict:
    """The captured state against the eager one after a step, each error
    held to FLOOR_FACTOR x the floor (the second eager state's error, the
    largest in ``seen`` so far, which this updates), never looser than
    TRAIN_TOL.  ``states`` and ``logs``: (captured, eager, floor)."""
    err = _step_errors(states[0], states[1], logs[0], logs[1])
    floor = _step_errors(states[2], states[1], logs[2], logs[1])
    keys = ("loss", "params", "stats")
    seen.update({k: max(seen.get(k, 0.0), floor[k]) for k in keys})
    bars = {k: max(TRAIN_TOL[k], FLOOR_FACTOR * seen[k]) for k in keys}
    return {"errors": {k: err[k] for k in bars},
            "floor": {k: floor[k] for k in bars}, "bars": bars,
            "bit_equal": err["bit_equal"],
            "floor_bit_equal": floor["bit_equal"],
            "ok": all(err[k] < bars[k] for k in bars)}


def _sync(src, dst) -> None:
    """``dst``'s weights, statistics, optimizer state (lr included) and
    step count made copies of ``src``'s."""
    import copy

    from md_rdm_tpu_torch.training.optim import load_optimizer_state
    dst.model.load_state_dict(src.model.state_dict())
    load_optimizer_state(dst.optimizer,
                         copy.deepcopy(src.optimizer.state_dict()))
    dst.step = src.step


def _steps(trainers, states, x, y, fns, trace: bool = False) -> dict:
    """One step of each (captured, eager, floor) trainer on its state,
    the eager states first made copies of the captured one (:func:`_sync`):
    the states, the logs and the counted launches of each; the captured
    step's graph replays, the bytes reserved during it, and with ``trace``
    its kernels counted in a profiler trace (:func:`traced_launches`)."""
    for st in states[1:]:
        _sync(states[0], st)
    run = {"states": [], "logs": [], "launches": [], "pool": None,
           "traced": None}
    for i, (t, st) in enumerate(zip(trainers, states)):
        def call(t=t, st=st):
            return t._train_step(st, x, y)
        if i == 0 and trace:
            before = counts(fns)
            (st, lg), run["traced"], replays = traced_launches(fns, call)
            got = since(fns, before)
        elif i == 0:
            ((st, lg), got, replays), run["pool"] = _reserved_during(
                lambda: call_launches(fns, call))
        else:
            (st, lg), got, _ = call_launches(fns, call)
        if i == 0:
            run["replays"] = replays
        run["states"].append(st)
        run["logs"].append(lg)
        run["launches"].append(got)
    return run


def _launches_held(run, replayed: bool) -> dict:
    """A captured step's launches against the eager steps': every eager
    step's equal, the captured one's equal where it ran the step's Python
    (``replayed`` False: its warm-up and its capture), none where it
    replayed, and a traced replay's kernels equal to an eager step's."""
    got, want = run["launches"][0], run["launches"][1]
    ok = all(c == want for c in run["launches"][1:])
    if replayed:
        ok = ok and run["replays"] > 0 and not any(got.values())
    else:
        ok = ok and got == want
    if run["traced"] is not None:
        ok = ok and run["traced"] == kernel_counts(want)
    return {"launches_held": ok, "replays": run["replays"],
            "replay_traced": run["traced"]}


def _trainers(tmp: str, name: str, model_cfg, data=(), train=()):
    """(captured, eager, floor) Trainers of one config, each in its own run
    directory, the last two capture=False; ``data`` and ``train``: more
    DataConfig / TrainConfig fields."""
    from md_rdm_tpu_torch.core.config import Config, DataConfig, TrainConfig
    from md_rdm_tpu_torch.training.loop import Trainer
    cfg = Config(model=model_cfg,
                 data=DataConfig(batch_size=BATCH, eval_batch_size=BATCH,
                                 **dict(data)),
                 train=TrainConfig(seed=SEED, run_dirs=False, save_top_k=0,
                                   checkpoint_dir=f"{tmp}/{name}",
                                   **dict(train)))
    trio = tuple(Trainer(cfg, workdir=f"{tmp}/{name}/{key}",
                         capture=None if key == "captured" else False)
                 for key in ("captured", "eager", "floor"))
    for t, want in zip(trio, (True, False, False)):
        written = json.loads((t.workdir / "config.json").read_text())
        check(t.captured is want and written["captured"] is want,
              f"graph: {name} trainer captured {written['captured']}")
    return trio


def _close(trainers) -> None:
    for t in trainers:
        t.close()


def graph_train(tmp: str, fns) -> dict:
    """Per (set, dtype, remat): 3 steps of batch 16 through Trainer
    captured and capture=False (twice: the floor) from the same weights
    and batches, each step's logs, parameters, statistics and launches
    held (the third step a replay, its kernels traced); each graph pool's
    bytes; with remat on (the default) the eval step captured against
    eager, the steps timed in turns and their peak memory, and on the
    live model the captured step's memory at batch 32
    (:func:`_captured_memory`).  On the live float32 step also
    set_lr between replays and Trainer.restore (:func:`graph_lr_restore`);
    then the augmented step."""
    batches = [tuple(torch.from_numpy(a).cuda()
                     for a in train_batch(BATCH, SEED + k))
               for k in GRAPH_SEEDS]
    rows, extra, weights = [], {}, {}
    for name, dt, remat in GRAPH_TRAIN:
        trainers = _trainers(tmp, f"{name}_{DT_NAME[dt]}_{remat}",
                             _graph_model(name, dt, remat=remat))
        if name not in weights:
            weights = {name: _seeded_weights(_graph_model(name, dt))}
        first = _on_card(trainers[0], weights[name])
        states = [first, _twin(trainers[1], first), _twin(trainers[2], first)]
        steps, pool, seen = [], None, {}
        for i, (x, y) in enumerate(batches):
            run = _steps(trainers, states, x, y, fns, trace=i == 2)
            states, logs = run["states"], run["logs"]
            if i == 1:    # the capture
                pool = run["pool"]
            held = _step_held(states, logs, seen)
            steps.append({"step": i + 1, **held,
                          **_launches_held(run, replayed=i == 2),
                          "loss": float(logs[0]["loss"])})
            check(held["ok"] and steps[-1]["launches_held"],
                  f"graph: {name} {DT_NAME[dt]} remat {remat} step {i + 1}"
                  f" {steps[-1]} launches {run['launches']}")
        sc, se = states[:2]
        check(sc.step == se.step == GRAPH_STEPS and len(sc.graphs) == 1,
              f"graph: step counts {sc.step} {se.step}")
        if (name, dt, remat) == ("live", torch.float32, True):
            extra = graph_lr_restore(trainers, states, batches, fns, seen)
        row = {"set": name, "dtype": DT_NAME[dt], "remat": remat,
               "batch": BATCH, "steps": steps, "launches_per_step":
               run["launches"][1], "pool_reserved_gb": pool / 1e9}
        if remat:    # the default: timed
            row["eval"] = _eval_held(trainers, states, batches[0], fns)
            x, y = batches[0]
            tc, te = trainers[:2]
            calls = {"eager": lambda: te._train_step(se, x, y),
                     "captured": lambda: tc._train_step(sc, x, y)}
            row["peak"] = {k: _peak(fn) for k, fn in calls.items()}
            row["times"] = _timed(calls, 1, 1, enqueue_iters=1)
            row["captured_over_eager"] = (row["times"]["captured"]["ms"]
                                          / row["times"]["eager"]["ms"])
            del calls, tc, te
            if name == "live":
                row["memory"] = _captured_memory(trainers[0], weights[name],
                                                 pool)
        rows.append(row)
        emit({"phase": "graph", "part": "train", **row})
        _close(trainers)
        del trainers, first, states, sc, se, logs, run
        torch.cuda.empty_cache()
    extra["augment"] = graph_augment(tmp, fns)
    return {"rows": rows, **extra}


def _eval_held(trainers, states, batch, fns) -> dict:
    """Trainer's eval step captured against eager on one batch, from the
    captured state's weights: one eager call and three captured ones
    (warm-up, capture, a replay with its kernels traced), each captured
    output against the eager one's (bit for bit, else GRAPH_SERVE_TOL)."""
    tc, te = trainers[:2]
    sc, se = states[:2]
    _sync(sc, se)
    x, y = batch
    w = torch.ones(x.shape[0], device=x.device)
    want_out, want, _ = call_launches(fns, lambda: te._eval_step(se, x, y, w))
    agree, launches, replays, traced = [], [], [], None
    for n in range(3):
        def call():
            return tc._eval_step(sc, x, y, w)
        if n == 2:
            before = counts(fns)
            out, traced, reps = traced_launches(fns, call)
            got = since(fns, before)
        else:
            out, got, reps = call_launches(fns, call)
        agree.append(_agree(out, want_out))
        launches.append(got)
        replays.append(reps)
    out = {"calls": agree, "launches_eager": want,
           "launches_captured": launches, "replays_captured": replays,
           "replay_traced": traced}
    check(all(a["bit_equal"] or a["rel_l2"] <= GRAPH_SERVE_TOL
              for a in agree)
          and launches[:2] == [want, want] and replays == [0, 1, 1]
          and not any(launches[2].values())
          and traced == kernel_counts(want),
          f"graph: captured eval step against eager {out}")
    return out


def _captured_memory(trainer, weights, pool16: int) -> dict:
    """A captured step's footprint at batch 16 and 32, as phase 18 takes an
    eager step's: a fresh state's allocated memory after its first
    (eager) step, then the bytes its capture reserves at batch 32 (the
    graph's pool), against ``pool16`` (the batch-16 capture's); the growth
    per sample and the batch it extrapolates to on this card.  The batch's
    second half gives the faithful fusion tail's NaN loss: the row
    measures memory."""
    xs, ys = train_batch(2 * BATCH, SEED + 3)
    x, y = torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    state = _on_card(trainer, weights)
    state, _ = trainer._train_step(state, x, y)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() - base
    _, pool32 = _reserved_during(lambda: trainer._train_step(state, x, y))
    check(len(state.graphs) == 1, "graph: batch-32 step not captured")
    total = torch.cuda.get_device_properties(0).total_memory
    per = (pool32 - pool16) / BATCH
    out = {"resident_gb": resident / 1e9, "pool_gb": {
        BATCH: pool16 / 1e9, 2 * BATCH: pool32 / 1e9},
        "gb_per_sample": per / 1e9, "card_gb": total / 1e9,
        "largest_batch_extrapolated": (
            int(BATCH + (total - resident - pool16) // per)
            if per > 0 else None)}
    del state
    torch.cuda.empty_cache()
    return out


def _update_rel(after, before, ref_after, ref_before) -> float:
    """relL2 of one step's parameter update against another's."""
    return rel_l2(after - before, ref_after - ref_before)


def graph_lr_restore(trainers, states, batches, fns, seen) -> dict:
    """set_lr between replays, then Trainer.restore, on the live float32
    states after their steps (the captured one replaying).  The lr check
    compares the updates that the states make from one state: under Adam
    an update is about lr in size per parameter, so the stale lr's is ten
    times the new one's."""
    from md_rdm_tpu_torch.training.checkpoint import CheckpointManager
    from md_rdm_tpu_torch.training.optim import get_lr, set_lr
    tc, te = trainers[:2]
    x, y = batches[1]
    # a fourth state, a copy of the captured one, keeps the old lr: where
    # a replay ignored set_lr it would step as this one does
    stale = _twin(te, states[0])
    _sync(states[0], stale)
    held_lr = states[0].optimizer.param_groups[0]["lr"]
    new_lr = 0.1 * get_lr(states[0].optimizer)
    set_lr(states[0].optimizer, new_lr)

    def params(st):
        return _flat32(p for p in st.model.parameters() if p.numel())

    for st in states[1:]:
        _sync(states[0], st)
    before = [params(st) for st in (*states, stale)]
    run = _steps(trainers, states, x, y, fns)
    states, logs = run["states"], run["logs"]
    stale, _ = te._train_step(stale, x, y)
    after = [params(st) for st in (*states, stale)]
    rel = [_update_rel(after[i], before[i], after[1], before[1])
           for i in (0, 2, 3)]
    del before, after
    bar = max(TRAIN_TOL["params"], FLOOR_FACTOR * rel[1])
    lr = {"new_lr": new_lr, "lr_tensor_kept":
          states[0].optimizer.param_groups[0]["lr"] is held_lr,
          "update_rel_l2": {"captured": rel[0], "floor": rel[1],
                            "old_lr": rel[2], "bar": bar},
          "step": _step_held(states, logs, seen)}
    emit({"phase": "graph", "part": "set_lr", **lr})
    check(rel[0] <= bar and lr["lr_tensor_kept"] and lr["step"]["ok"],
          f"graph: a replay after set_lr {lr}")
    check(rel[2] > bar, f"graph: the set_lr check cannot see a stale lr "
                        f"{lr}")
    del stale

    # restore: every state from one checkpoint of the captured state, the
    # captured one moved on a step first
    tc.ckpt.save_top_k = 1
    tc.ckpt.save(0, states[0], {"delta1": 0.5})
    states[0], _ = tc._train_step(states[0], x, y)
    _, states[0] = tc.restore(states[0])
    dropped = states[0].graphs is None
    kept = states[0].optimizer.param_groups[0]["lr"] is held_lr
    for st in states[1:]:
        CheckpointManager(str(tc.ckpt.directory)).restore(st)
    after, seen_after = [], {}
    for i, (xb, yb) in enumerate(batches):
        run = _steps(trainers, states, xb, yb, fns, trace=i == 2)
        states = run["states"]
        after.append({**_step_held(states, run["logs"], seen_after),
                      **_launches_held(run, replayed=i == 2)})
    restore = {"graphs_dropped": dropped, "lr_tensor_kept": kept,
               "steps_after": after, "graphs_after": len(states[0].graphs)}
    emit({"phase": "graph", "part": "restore", **restore})
    check(dropped and kept and len(states[0].graphs) == 1
          and all(a["ok"] and a["launches_held"] for a in after),
          f"graph: restore {restore}")
    return {"set_lr": lr, "restore": restore}


def graph_augment(tmp: str, fns) -> dict:
    """Three --augment device steps of the live float32 model, captured
    and eager (twice), on the same raw uint8 batches and the same factors
    (the loops' generators seeded alike)."""
    trainers = _trainers(tmp, "augment", _graph_model("live", torch.float32),
                         data={"augment_backend": "device"})
    first = trainers[0].init_state()
    states = [first, _twin(trainers[1], first), _twin(trainers[2], first)]
    steps, seen = [], {}
    for i, k in enumerate(GRAPH_SEEDS):
        x, y = (torch.from_numpy(a).cuda()
                for a in raw_batch(BATCH, SEED + k, "uint8"))
        run = _steps(trainers, states, x, y, fns, trace=i == 2)
        states = run["states"]
        steps.append({"step": i + 1, **_step_held(states, run["logs"], seen),
                      **_launches_held(run, replayed=i == 2)})
        check(steps[-1]["ok"] and steps[-1]["launches_held"],
              f"graph: augmented step {steps[-1]}")
    check(len(states[0].graphs) == 1, "graph: augmented step not captured")
    out = {"steps": steps}
    emit({"phase": "graph", "part": "augment", **out})
    _close(trainers)
    del trainers, first, states
    torch.cuda.empty_cache()
    return out


def graph_loop(tmp: str) -> dict:
    """Trainer.fit as in phase 13 (the optimal set, float32, 2 epochs of 4
    batches of 16, validation on 24 samples, plateau patience 0), captured
    against capture=False (twice: the floor), without checkpoints: the lr
    sequences, the parameters and statistics after the fit held as a
    step's, both step times."""
    from md_rdm_tpu_torch.data.base import DataLoader
    from md_rdm_tpu_torch.data.synthetic import SyntheticDepthDataset
    train_ds = SyntheticDepthDataset("train", size=LOOP_TRAIN, seed=SEED,
                                     cache=True)
    val_ds = SyntheticDepthDataset("val", size=LOOP_VAL, seed=SEED + 1,
                                   cache=True)
    sample_x, sample_y = next(iter(DataLoader(train_ds, BATCH)))
    runs, vecs = {}, {}
    trainers = _trainers(tmp, "loop", _graph_model("optimal", torch.float32),
                         train={"max_epochs": LOOP_EPOCHS,
                                "plateau_patience": 0, "log_every": 2})
    # the captured trainer warms up as cli.train's does (its throwaway
    # state's graphs go with it); the eager ones start from copies of the
    # captured one's first state
    trainers[0].warmup(sample_x, sample_y)
    first = trainers[0].init_state()
    starts = [first] + [_twin(t, first) for t in trainers[1:]]
    del first
    for key, trainer in zip(("captured", "eager", "floor"), trainers):
        state = starts.pop(0)
        t0 = time.perf_counter()
        state = trainer.fit(state, DataLoader(
            train_ds, batch_size=BATCH, shuffle=True, drop_last=True,
            num_workers=2, seed=SEED), DataLoader(val_ds, batch_size=BATCH,
                                                  num_workers=2))
        torch.cuda.synchronize()
        log, = trainer.workdir.rglob("metrics.jsonl")
        recs = [json.loads(line) for line in log.read_text().splitlines()]
        runs[key] = {
            "fit_s": time.perf_counter() - t0,
            "step_time_s": [r["epoch_train_step_time_s"] for r in recs
                            if "epoch_train_step_time_s" in r],
            "lr": [r["lr"] for r in recs if "lr" in r],
            "val_delta1": [r["val_delta1"] for r in recs
                           if "val_delta1" in r],
            "graphs": len(state.graphs) if state.graphs else 0}
        named = [p for p in state.model.parameters() if p.numel()]
        vecs[key] = (_flat32(named), _flat32(
            b for n, b in state.model.named_buffers() if "running" in n))
        trainer.close()
        del state, named
        torch.cuda.empty_cache()
    for i, k in enumerate(("params", "stats")):
        err = rel_l2(vecs["captured"][i], vecs["eager"][i])
        floor = rel_l2(vecs["floor"][i], vecs["eager"][i])
        runs[k] = {"rel_l2": err, "floor": floor,
                   "bit_equal": bool(torch.equal(vecs["captured"][i],
                                                 vecs["eager"][i])),
                   "bar": max(TRAIN_TOL[k], FLOOR_FACTOR * floor)}
    del vecs
    lrs = [runs[k]["lr"] for k in ("captured", "eager", "floor")]
    runs["lr_changed"] = lrs[0][-1] < lrs[0][0]
    emit({"phase": "graph", "part": "loop", **runs})
    # the eager runs' own lr sequences may part on a val metric at the
    # plateau threshold; where they agree the captured one must too
    check((lrs[0] == lrs[1] or lrs[1] != lrs[2])
          and all(runs[k]["rel_l2"] < runs[k]["bar"]
                  for k in ("params", "stats"))
          and runs["captured"]["graphs"] == 3,
          f"graph: loop captured against eager {runs}")
    del trainers
    return runs


@contextlib.contextmanager
def eager_cli():
    """cli.evaluate's forward and metrics eager on the card inside the
    block, as the JAX CLI's are under ``jax.disable_jit``: the CLI asks
    ``core.graphs.capture_default`` at each run."""
    from md_rdm_tpu_torch.core import graphs
    saved = graphs.capture_default
    graphs.capture_default = lambda device, capture, who: False
    try:
        yield
    finally:
        graphs.capture_default = saved


def graph_cli(tmp: str, fns) -> dict:
    """cli.evaluate on a checkpoint of the seeded live model, captured
    (the default) and eager (:func:`eager_cli`): averages, the maps of
    every batch, launches per forward, images/s over the warm batches."""
    from md_rdm_tpu_torch.cli import evaluate as cli_evaluate
    from md_rdm_tpu_torch.core.config import Config
    from md_rdm_tpu_torch.training.checkpoint import CheckpointManager
    from md_rdm_tpu_torch.training.module import DepthTrainer
    ckdir = f"{tmp}/cli_checkpoints"
    state = DepthTrainer(Config(), device="cuda").init(seed=SEED)
    CheckpointManager(ckdir).save(0, state, {"delta1": 0.0})
    del state
    torch.cuda.empty_cache()
    out = {}
    batches = -(-CLI_EVAL_IMAGES // BATCH)
    for key in ("captured", "eager"):
        # the captured run's last forward (a replay) traced; its start is
        # the last that the timed batches read
        trace = {"predict_step": batches - 1} if key == "captured" else None
        with per_call_launches(fns, trace) as calls, \
                recorded_predictions() as timed, \
                (eager_cli() if key == "eager" else contextlib.nullcontext()):
            avgs, _ = run_cli(cli_evaluate.main, [
                "--checkpoint", ckdir, "--dataset", "synthetic",
                "--num_images", str(CLI_EVAL_IMAGES), "--batch_size",
                str(BATCH)])
        starts = [t for t, _, _ in timed]
        batch_ms = [1e3 * (b - a) for a, b in zip(starts[1:], starts[2:])]
        check(all((via == "Graphs.run") == (key == "captured")
                  for _, _, via in timed), f"graph: cli {key} forwards")
        out[key] = {"averages": avgs, "maps": [m for _, m, _ in timed],
                    "launches": calls["predict_step"],
                    "replays": calls["replays"]["predict_step"],
                    "replay_traced": calls["traced"].get("predict_step"),
                    "batch_ms": batch_ms,
                    "images_per_sec": BATCH * len(batch_ms)
                    / (1e-3 * sum(batch_ms))}
    maps = _agree(out["captured"].pop("maps"), out["eager"].pop("maps"))
    equal = out["captured"]["averages"] == out["eager"]["averages"]
    within = {k: cli_within_bar(k, out["captured"]["averages"][k], v,
                                CLI_EVAL_IMAGES)
              for k, v in out["eager"]["averages"].items()}
    eager, cap = out["eager"], out["captured"]
    want = eager["launches"][0]
    out.update(maps=maps, averages_equal=equal, within_bar=within)
    emit({"phase": "graph", "part": "cli", **out})
    check(all(within.values()) and maps["rel_l2"] <= GRAPH_SERVE_TOL
          and all(c == want for c in eager["launches"])
          and cap["launches"][:2] == [want, want]
          and all(ran_or_replayed(c, r, want) for c, r in zip(
              cap["launches"], cap["replays"]))
          and not any(cap["launches"][-1].values())
          and cap["replay_traced"] == kernel_counts(want)
          and len(eager["launches"]) == len(cap["launches"]) == batches,
          f"graph: cli.evaluate captured against eager {out}")
    return out


# The WSM stages of an optimal-set forward (decoders 7-9 run stages 1,
# 1-2 and 1-3), and the bar of a stage's products against the cuDNN
# sequence they replace: both float32, TF32 off, summed in other orders.
WSM_PHASE_STAGES = (1, 2, 3)
WSM_TOL = 1e-5


def library_wsm(layer, x):
    """The F.conv2d sequence a WSM stage ran before its products: cuDNN's
    1x1, transposed, 3x3, 5x5 and strip convolutions on NCHW views of
    channels-last activations, the strips tiled, the five branches
    concatenated."""
    from md_rdm_tpu_torch.models.densenet import conv
    F = torch.nn.functional
    cl = torch.channels_last
    dt = x.dtype
    x = conv(x, layer.input_adjustment_layer)
    de = layer.deconv1[0]
    up = F.conv_transpose2d(x, de.weight.to(dt), de.bias.to(dt),
                            stride=2).contiguous(memory_format=cl)
    s = layer.strip_size
    o11 = conv(up, layer.conv1_1)
    o21 = conv(conv(up, layer.conv1_2), layer.conv2_1)
    o22 = conv(conv(up, layer.conv1_3), layer.conv2_2)
    col = conv(F.pad(conv(up, layer.conv1_4), (0, 0, 1, 1)),
               layer.wsm_wx3[1])
    row = conv(F.pad(conv(up, layer.conv1_5), (1, 1, 0, 0)),
               layer.wsm_3xh[1])
    b, cw, h, _ = col.shape
    out = torch.cat([o11, o21, o22, row.expand(b, cw, s, row.shape[3]),
                     col.expand(b, cw, h, s)], 1)
    return out.contiguous(memory_format=cl)


def wsm_work(c: int, raw: int, n: int, batch: int) -> dict:
    """Float32 operations and bytes (inputs and weights read once, outputs
    written once) of each part of a stage of width c on raw channels at
    n x n: part -> (operations, bytes)."""
    q, w, s = c // 4, c // 8, 2 * n
    px_in, px = batch * n * n, batch * s * s
    work = {"adj": (2 * px_in * raw * c, px_in * (raw + c) + raw * c),
            "deconv": (2 * px_in * c * 4 * c, (px_in + px) * c + 4 * c * c),
            "1x1": (2 * px * c * c, 2 * px * c + c * c),
            "3x3": (2 * px * q * q * 9, 2 * px * q + 9 * q * q),
            "5x5": (2 * px * q * q * 25, 2 * px * q + 25 * q * q),
            "strips": (2 * 2 * batch * s * 3 * s * w * w,
                       2 * (px * w + batch * s * w + 3 * s * w * w))}
    return {k: (f, 4 * b) for k, (f, b) in work.items()}


def wsm_parts(layer, x) -> dict:
    """Each part of a stage: (the stage's products, the cuDNN call they
    replace), on the inputs the stage computes for it."""
    from md_rdm_tpu_torch.models import wsm
    from md_rdm_tpu_torch.models.densenet import conv
    F = torch.nn.functional
    cl = torch.channels_last
    b, raw, n, _ = x.shape
    ia, de = layer.input_adjustment_layer, layer.deconv1[0]
    c, s = de.in_channels, 2 * n
    q = c // 4
    rows = x.permute(0, 2, 3, 1).reshape(-1, raw)
    w_in = ia.weight.view(c, raw).t()
    h = torch.addmm(ia.bias, rows, w_in)
    h_cl = conv(x, ia)
    w_de = de.weight.view(c, 4 * c)

    def deconv():
        up = torch.mm(h, w_de).view(b, n, n, c, 2, 2)
        return up.permute(0, 1, 4, 2, 5, 3).reshape(-1, c)

    up, branches = deconv(), (layer.conv1_1, layer.conv1_2, layer.conv1_3,
                              layer.conv1_4, layer.conv1_5)
    up_cl = F.conv_transpose2d(h_cl, de.weight, de.bias, stride=2
                               ).contiguous(memory_format=cl)
    w1 = torch.cat([m.weight.view(-1, c) for m in branches])
    b1 = torch.cat([m.bias for m in branches])
    p = torch.addmm(b1, up, w1.t()).view(b, s, s, c)
    budget = p.numel()
    mid = {name: conv(up_cl, m) for name, m in
           (("3x3", layer.conv1_2), ("5x5", layer.conv1_3),
            ("col", layer.conv1_4), ("row", layer.conv1_5))}
    wx3, w3h = layer.wsm_wx3[1], layer.wsm_3xh[1]

    return {
        "adj": (lambda: torch.addmm(ia.bias, rows, w_in),
                lambda: conv(x, ia)),
        "deconv": (deconv, lambda: F.conv_transpose2d(
            h_cl, de.weight, de.bias, stride=2).contiguous(memory_format=cl)),
        "1x1": (lambda: torch.addmm(b1, up, w1.t()),
                lambda: [conv(up_cl, m) for m in branches]),
        "3x3": (lambda: wsm._square_conv(p[..., q:2 * q], layer.conv2_1,
                                         budget),
                lambda: conv(mid["3x3"], layer.conv2_1)),
        "5x5": (lambda: wsm._square_conv(p[..., 2 * q:3 * q],
                                         layer.conv2_2, budget),
                lambda: conv(mid["5x5"], layer.conv2_2)),
        "strips": (lambda: layer.strips(p, budget), lambda: (
            conv(F.pad(mid["col"], (0, 0, 1, 1)), wx3),
            conv(F.pad(mid["row"], (1, 1, 0, 0)), w3h))),
    }, {"p": p, "budget": budget}


def wsm_kxk_forms(layer, p, budget) -> dict:
    """Both forms of the stage's 3x3 and 5x5 on its columns of the 1x1
    product, captured (the lesser of two turns): tap products and cuDNN on
    the contiguous channels-last copy; the form TAP_SHAPES gives the shape,
    and whether the faster form is it (a report: ties move between runs)."""
    from md_rdm_tpu_torch.models import wsm
    from md_rdm_tpu_torch.models.densenet import conv
    c = p.shape[3]
    q = c // 4
    out = {}
    for name, lay, z in (("3x3", layer.conv2_1, p[..., q:2 * q]),
                         ("5x5", layer.conv2_2, p[..., 2 * q:3 * q])):
        k = lay.kernel_size[0]
        frames = torch.nn.functional.pad(z, (0, 0) + (k // 2,) * 4)
        wm = lay.weight.permute(1, 2, 3, 0).reshape(-1, k * k * q)
        forms = {
            "taps": lambda f=frames, wm=wm, k=k, lay=lay: wsm._tap_conv(
                f, wm, k, k, lay.bias, budget),
            "cudnn": lambda z=z, lay=lay: conv(
                z.permute(0, 3, 1, 2).contiguous(
                    memory_format=torch.channels_last), lay)}
        err = rel_l2(forms["taps"](), forms["cudnn"]().permute(0, 2, 3, 1))
        t = {f: [] for f in forms}
        for f in ("taps", "cudnn", "cudnn", "taps"):
            t[f].append(graph_ms(forms[f], 5))
        ms = {f: min(v) for f, v in t.items()}
        taken = ("taps" if (k, q, z.shape[1]) in wsm.TAP_SHAPES
                 else "cudnn")
        out[name] = {"shape": [k, q, z.shape[1]], "form": taken,
                     "taps_ms": ms["taps"], "cudnn_ms": ms["cudnn"],
                     "faster": min(ms, key=ms.get),
                     "taken_is_faster": taken == min(ms, key=ms.get),
                     "taps_vs_cudnn_rel_l2": err}
        check(err < WSM_TOL, f"wsm: taps against cuDNN {name} {out[name]}")
    return out


def phase_wsm(smi) -> list:
    """Each WSM stage of an optimal-set forward at batch 16 in float32,
    TF32 off, eager and captured: the stage's products against the cuDNN
    sequence they replace (``library_wsm``): output (WSM_TOL), device time
    of captured calls in turns (``ms``, ``library_ms``), the peak memory
    an eager call adds, its counters (one ``wsm.gemm``, one
    ``wsm.gemm.kxk`` per 3x3 or 5x5 at TAP_SHAPES); each part timed both
    ways beside its bound; both forms of the 3x3 and 5x5."""
    from md_rdm_tpu_torch.core import trace
    from md_rdm_tpu_torch.core.device import no_tf32
    from md_rdm_tpu_torch.models import wsm
    from md_rdm_tpu_torch.models.rdm import init_parameters
    rows = []
    for stage in WSM_PHASE_STAGES:
        c, s = wsm.WSM_STAGES[stage - 1]
        raw = wsm.FIRST_STAGE_INPUT if stage == 1 else 2 * c
        n = s // 2
        layer = wsm.WSMLayer(c, s, raw)
        init_parameters(layer, SEED + stage)
        g = torch.Generator().manual_seed(SEED + 600 + stage)
        with torch.no_grad():    # init_parameters zeroes them
            for m in layer.modules():
                if getattr(m, "bias", None) is not None:
                    m.bias.normal_(0.0, 0.1, generator=g)
        layer = layer.cuda().eval()
        g = torch.Generator(device="cuda").manual_seed(SEED + 600 + stage)
        x = torch.randn(BATCH, raw, n, n, generator=g, device="cuda"
                        ).contiguous(memory_format=torch.channels_last)
        work = wsm_work(c, raw, n, BATCH)
        with no_tf32(), torch.inference_mode():
            check(not torch.backends.cuda.matmul.allow_tf32,
                  "wsm: TF32 on in the products")
            kxk = sum((k, c // 4, s) in wsm.TAP_SHAPES for k in (3, 5))
            names = ("wsm.gemm", "wsm.gemm.kxk")
            before = trace.snapshot()["counters"]
            got = layer(x)
            after = trace.snapshot()["counters"]
            counters = {k: after.get(k, 0) - before.get(k, 0)
                        for k in names}
            want = library_wsm(layer, x)
            err = rel_l2(got, want)
            peak = {"peak_mb": _peak(lambda: layer(x))["own_gb"] * 1e3,
                    "library_peak_mb":
                        _peak(lambda: library_wsm(layer, x))["own_gb"]
                        * 1e3}
            t = {"ms": [], "library_ms": []}
            for which in ("ms", "library_ms", "library_ms", "ms"):
                fn = ((lambda: layer(x)) if which == "ms"
                      else (lambda: library_wsm(layer, x)))
                t[which].append(graph_ms(fn, 5))
            parts, state = wsm_parts(layer, x)
            part_rows = {}
            for name, (mine, lib) in parts.items():
                pt = {"ms": [], "library_ms": []}
                for which in ("ms", "library_ms", "library_ms", "ms"):
                    pt[which].append(graph_ms(
                        mine if which == "ms" else lib, 5))
                part_rows[name] = {k: min(v) for k, v in pt.items()}
                part_rows[name].update(_bound(*work[name], torch.float32))
            forms = wsm_kxk_forms(layer, state["p"], state["budget"])
        flops = sum(f for f, _ in work.values())
        nbytes = sum(b for _, b in work.values())
        row = {"stage": stage, "c": c, "raw": raw, "size_in": n,
               "batch": BATCH, "dtype": "float32",
               "ms": min(t["ms"]), "library_ms": min(t["library_ms"]),
               "turns_ms": t, "rel_l2": err, "tol": WSM_TOL,
               **_bound(flops, nbytes, torch.float32), **peak,
               "counters": counters, "parts": part_rows,
               "kxk_forms": forms}
        rows.append(row)
        emit({"phase": "wsm", "card": smi, **row})
        check(err < WSM_TOL, f"wsm: stage {stage} against cuDNN {err}")
        check(counters == {"wsm.gemm": 1, "wsm.gemm.kxk": kxk},
              f"wsm: stage {stage} counters {counters}")
        del layer, x, got, want, parts, state
        torch.cuda.empty_cache()
    return rows


def graph_in_child() -> None:
    """Phase 19 in a process of its own (``--graph-only``), which counts
    replays' kernels in profiler traces: late in one long process the
    profiler's device trace drops kernel records (47-53 of a live f32
    forward's 54 F1 launches, eager or replayed, in whole runs of this
    script on an H100 80GB HBM3; all of them in a fresh process)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    sys.stdout.flush()
    done = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--graph-only"])
    check(done.returncode == 0,
          f"graph: phase 19's process exited {done.returncode}")


def phase_graph(smi) -> dict:
    """Phase 19: cli.evaluate, serve, train, set_lr, restore, the
    augmented step and the loop, captured against eager."""
    import tempfile
    fns = path_counters()
    out, seconds = {"phase": "graph", "card": smi}, {}
    t0 = time.perf_counter()

    def timed(part, fn, *args):
        t = time.perf_counter()
        out[part] = fn(*args)
        seconds[part] = time.perf_counter() - t

    with tempfile.TemporaryDirectory(prefix="chip_smoke_graph_") as tmp:
        # cli first: run last, its traced replay lost one layer's kernel
        # records (77 of 78 F1-F3 launches, in two runs on an H100 80GB
        # HBM3; 78 in a fresh process), as graph_in_child describes
        timed("cli", graph_cli, tmp, fns)
        timed("serve", graph_serve, fns)
        timed("train", graph_train, tmp, fns)
        timed("loop", graph_loop, tmp)
    torch.cuda.empty_cache()
    emit({"phase": "graph", "part": "done", "card": smi,
          "seconds": time.perf_counter() - t0, "seconds_by_part": seconds})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import md_rdm_tpu_torch  # noqa: F401  (fails outside the repository)
    if "--distributed-cli-rank" in sys.argv[1:]:
        return distributed_cli_rank(sys.argv)
    count_replays()
    smi = phase_device()
    phase_build()
    if "--split-only" in sys.argv[1:]:
        phase_kernel()
        phase_split_sweep(smi)
        phase_times_kernel(smi)
        return 0
    if "--forward-only" in sys.argv[1:]:
        phase_kernel()
        phase_times_kernel(smi)
        return 0
    if "--backward-only" in sys.argv[1:]:
        phase_kernel_bwd()
        phase_times_bwd(smi)
        return 0
    if "--lloyd-only" in sys.argv[1:]:
        phase_kernel_lloyd()
        phase_times_lloyd(smi)
        return 0
    if "--cli-only" in sys.argv[1:]:
        phase_cli(smi)
        return 0
    if "--augment-only" in sys.argv[1:]:
        phase_augment(smi)
        return 0
    if "--distributed-only" in sys.argv[1:]:
        phase_distributed(smi)
        return 0
    if "--routing-only" in sys.argv[1:]:
        phase_kernel(ROUTING_SHAPES + DECODER_SHAPES)
        phase_kernel_bwd(ROUTING_SHAPES)
        phase_routing(smi)
        return 0
    if "--flat-only" in sys.argv[1:]:
        phase_flat(smi)
        return 0
    if "--graph-only" in sys.argv[1:]:
        phase_graph(smi)
        return 0
    if "--wsm-only" in sys.argv[1:]:
        phase_wsm(smi)
        return 0
    if "--train-optimal-only" in sys.argv[1:]:
        _, times = phase_train_optimal(smi)
        phase_loop(smi, next(r["step_ms"] for r in times
                             if r["dtype"] == "float32"))
        return 0
    checks = phase_kernel()
    bwd_checks = phase_kernel_bwd()
    lloyd_checks = phase_kernel_lloyd()
    preds, requests, serve_launches, per_forward = phase_serve()
    (opt_preds, opt_requests, optimal_launches,
     b4_per_forward) = phase_serve_optimal()
    states, batch, train_launches, per_step = phase_train()
    time_rows = phase_times_kernel(smi)
    phase_times_serve(preds, requests, smi)
    bwd_rows = phase_times_bwd(smi)
    train_times = phase_times_train(states, batch, smi)
    phase_profile(preds, requests, states, batch, smi)
    lloyd_forward, lloyd_rows = phase_times_lloyd(smi)
    phase_times_optimal(opt_preds, opt_requests, smi)
    del preds, opt_preds, states, batch
    torch.cuda.empty_cache()
    phase_wsm(smi)
    torch.cuda.empty_cache()
    routing = phase_routing(smi)
    torch.cuda.empty_cache()
    train_optimal_launches, optimal_times = phase_train_optimal(smi)
    loop_launches = phase_loop(smi, next(
        r["step_ms"] for r in optimal_times if r["dtype"] == "float32"))
    bare_f32 = next(r["step_ms"] for r in train_times
                    if r["dtype"] == "float32")
    cli_launches, host_step_s = phase_cli(smi, bare_f32)
    augment_launches = phase_augment(smi, bare_f32, host_step_s)
    torch.cuda.empty_cache()
    distributed_launches = phase_distributed(smi)
    torch.cuda.empty_cache()
    flat = phase_flat(smi)
    graph_in_child()
    emit(kernels_line(checks, bwd_checks, time_rows, bwd_rows,
                      serve_launches, per_forward, per_step, train_launches,
                      lloyd_checks, lloyd_forward, lloyd_rows,
                      optimal_launches, b4_per_forward,
                      train_optimal_launches, loop_launches, cli_launches,
                      augment_launches, distributed_launches, routing,
                      flat))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
