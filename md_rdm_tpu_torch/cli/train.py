"""Training CLI - the reference's train.py flag surface, on CUDA cards.

Port of ``md_rdm_tpu/cli/train.py``, with the same flag names and
defaults.  Reference flags (train.py:9-26): --seed --precision --gpus --dev
--overfit --min_epochs --max_epochs --metrics --worker
--find_learning_rate --detect_anomaly --learning_rate --batch_size
--nyu_path.

Mapping onto the port: --device {cuda,cpu} picks the device (the card by
default; it raises without one); --gpus N -> --devices N sets
``data_parallel``: N processes started by ``torchrun --nproc_per_node N``
train data-parallel, one card each over NCCL (with --device cpu: CPU
processes over gloo, the role of the JAX CLI's --platform cpu
--host_devices N), and N > 1 without a launcher raises; only rank 0
prints and writes the run directory; --precision 16 -> bfloat16 compute;
--detect_anomaly -> ``debug_nans`` (autograd anomaly detection);
--profile writes rank 0's ``torch.profiler`` trace under
``<run>/profile``; --fused_dense routes the dense layers through the
sandwich kernels, --flat_block runs a routed dense block as one in-place
buffer and --growth_matmul runs the encoder's growth convs as one matmul
each (``models/routing.py`` says what each value does); --remat /
--no_remat rematerialize the encoder's dense layers in the backward (the
default: on); --augment device ships raw uint8 batches
(``data/raw.py``) that each train step augments on the device
(``data/augment.py``); --find_learning_rate runs an LR range sweep
(exponential ramp, pick the steepest-descent point - the tuner.lr_find
equivalent, train.py:74-80).

Usage:
    python -m md_rdm_tpu_torch.cli.train --nyu_path /data/nyu --max_epochs 5
    python -m md_rdm_tpu_torch.cli.train --dataset synthetic --dev
    torchrun --nproc_per_node 2 -m md_rdm_tpu_torch.cli.train \\
        --dataset synthetic --dev --devices 2
    python -m md_rdm_tpu_torch.cli.train --dataset synthetic --dev \\
        --device cpu --batch_size 2 --precision 32
"""
from __future__ import annotations

import argparse
import random
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Trains mono depth estimation models (CUDA)")
    p.add_argument("--seed", default=None, type=int, help="Random seed")
    p.add_argument("--precision", default=16, type=int, choices=(16, 32),
                   help="16 = bfloat16 conv compute (default, matching the "
                        "reference's AMP-16 default), 32 = float32")
    p.add_argument("--devices", "--gpus", dest="devices", type=int,
                   default=-1,
                   help="Data-parallel width: the number of processes "
                        "torchrun starts (-1 = as many as it starts, 1 "
                        "without torchrun); anything else raises")
    p.add_argument("--dev", action="store_true",
                   help="Fast dev run: 1 batch per train/val epoch")
    p.add_argument("--overfit", action="store_true",
                   help="Overfit a single batch")
    p.add_argument("--min_epochs", default=1, type=int)
    p.add_argument("--max_epochs", default=1, type=int)
    p.add_argument("--metrics", nargs="+",
                   default=["delta1", "delta2", "delta3", "mse", "mae",
                            "log10", "rmse"])
    p.add_argument("--worker", default=6, type=int,
                   help="Data loader worker threads")
    p.add_argument("--find_learning_rate", action="store_true")
    p.add_argument("--detect_anomaly", action="store_true",
                   help="Enable autograd anomaly detection")
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--fast_modules", nargs="*", default=[],
                   help="Top-level parameter groups trained at "
                        "--fast_lr_multiplier x the base LR - the legacy "
                        "1x/10x param-group recipe (main.py:156-162). "
                        "E.g. --fast_modules weight_layer")
    p.add_argument("--fast_lr_multiplier", type=float, default=10.0,
                   help="LR multiplier for --fast_modules groups "
                        "(reference uses 10x, main.py:157)")
    p.add_argument("--fusion_init", default="abs_randn",
                   choices=("abs_randn", "normalized", "primary"),
                   help="Fusion-weight init: abs_randn = faithful "
                        "|N(0,1)| (RDM_Net.py:449-456); normalized = "
                        "slot weights sum to 1; primary = first candidate "
                        "1.0, rest 0.01 (start ~= first decoder alone)")
    p.add_argument("--save_top_k", type=int, default=1,
                   help="keep the k best checkpoints on the monitored "
                        "metric (Lightning ModelCheckpoint save_top_k, "
                        "train.py:43); 0 disables checkpointing")
    p.add_argument("--plateau_patience", type=int, default=2,
                   help="ReduceLROnPlateau patience in epochs (reference "
                        "train.py:44 hardcodes 2; raise for from-scratch "
                        "runs where val_delta1 moves slowly)")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--eval_batch_size", type=int, default=1,
                   help="Validation batch size (reference module.py:24-28 "
                        "evaluates at 1; padded tails are masked out of "
                        "the metrics)")
    p.add_argument("--val_samples", type=int, default=None,
                   help="Draw N validation samples per epoch with "
                        "replacement (the WeightedRandomSampler role, "
                        "reference main.py:83-85,102-104). Default: 3200 "
                        "for kitti - the reference's choice - else off; "
                        "0 disables explicitly")
    p.add_argument("--nyu_path", type=str, default=None,
                   help="Path to NYU data set")
    p.add_argument("--dataset", type=str, default="nyu",
                   help="One of nyu/kitti/floorplan3d/structured3d/"
                        "synthetic, or a '+'-joined mix (e.g. "
                        "'nyu+floorplan3d') trained as one shuffled "
                        "ConcatDataset (reference dataloader.py:42-61)")
    p.add_argument("--dataset_type", type=str, default="sparse_2_dense")
    p.add_argument("--synthetic_size", type=int, default=0,
                   help="Synthetic train-set size (0 = 4*batch_size)")
    p.add_argument("--data_path", type=str, default=None,
                   help="Dataset root (non-NYU datasets)")
    p.add_argument("--decoders", type=int, nargs="+", default=[1],
                   help="Decoder ids to instantiate (1-10)")
    p.add_argument("--augment", choices=("host", "device"), default="host",
                   help="device: the host ships raw uint8 batches and the "
                        "train step augments them on the device")
    p.add_argument("--remat", dest="remat", action="store_true",
                   default=True,
                   help="Run each encoder dense layer again in the "
                        "backward, keeping only its input "
                        "(torch.utils.checkpoint; the default)")
    p.add_argument("--no_remat", dest="remat", action="store_false")
    p.add_argument("--fused_dense", default="auto",
                   choices=("auto", "on", "on_all", "on_all_bwd", "off",
                            "interpret"),
                   help="Dense layers through the sandwich kernels "
                        "(kernels/dense_sandwich.py): auto = on, the "
                        "H100-measured tables; on_all: every encoder layer "
                        "forward; on_all_bwd / interpret: forward and "
                        "backward; off: none")
    p.add_argument("--growth_matmul", default="auto",
                   choices=("auto", "on", "on_all", "off"),
                   help="on_all: the growth convs of the encoder layers "
                        "that --fused_dense leaves out, as one matmul each "
                        "(kernels/growth_conv.py); on: the "
                        "measured-profitable sizes (none); auto = off")
    p.add_argument("--flat_block", default="auto",
                   choices=("auto", "on", "on_all", "off", "interpret"),
                   help="Encoder dense blocks as one in-place buffer "
                        "(models/routing.py) where every "
                        "layer routes through the kernels: auto = on "
                        "where --fused_dense routes, the H100-measured "
                        "tables; on_all: every such block; interpret: "
                        "S=57; off: none")
    p.add_argument("--fusion_eps", type=float, default=0.0,
                   help="Stabilization floor for the fine-detail fusion "
                        "tail (0 = faithful reference semantics; 1e-2 "
                        "recommended when training relative decoders - "
                        "the faithful path NaNs, see ModelConfig)")
    p.add_argument("--soft_decode", action="store_true",
                   help="Differentiable DORN decode (sum of probs)")
    p.add_argument("--linear_metrics", action="store_true",
                   help="Score exp(final) instead of the log-space map "
                        "(fixed mode; faithful default pins delta1 ~ 0)")
    p.add_argument("--workdir", type=str, default="result")
    p.add_argument("--no_run_dirs", dest="run_dirs", action="store_false",
                   default=True,
                   help="Write into --workdir directly instead of the "
                        "result/<name>/run_N convention (utils.py:49-59)")
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--download", action="store_true")
    p.add_argument("--profile", action="store_true",
                   help="Write a torch.profiler trace of the run to "
                        "<run>/profile")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="Device to train on (default: the CUDA card; "
                        "raises without one)")
    return p


def _dataset_pair(name, args, index=0):
    """(train_ds, val_ds) for one dataset name.  ``index`` distinguishes
    repeated members of a '+'-mix (seeds differ so e.g.
    synthetic+synthetic is two distinct scene sets).  Each loader is
    imported here, so that the synthetic path needs neither PIL nor
    h5py."""
    if name == "synthetic" or (name == "nyu" and args.nyu_path is None):
        from md_rdm_tpu_torch.data.synthetic import SyntheticDepthDataset
        n = args.synthetic_size or 4 * args.batch_size
        # correlated: rgb rendered from the depth field, so depth is
        # learnable; cached: generation would bound a small host otherwise
        train_ds = SyntheticDepthDataset("train", size=n, seed=10 * index,
                                         correlated=True, cache=True)
        val_ds = SyntheticDepthDataset("val", size=max(n // 4, 2),
                                       seed=10 * index + 1,
                                       correlated=True, cache=True)
    elif name == "nyu":
        from md_rdm_tpu_torch.data.nyu import NYUDataset
        train_ds = NYUDataset(args.nyu_path, dataset_type=args.dataset_type,
                              split="train", output_size=(226, 226),
                              download=args.download)
        val_ds = NYUDataset(args.nyu_path, dataset_type="labeled",
                            split="val", output_size=(226, 226),
                            download=args.download)
    elif name == "kitti":
        from md_rdm_tpu_torch.data.kitti import KITTIDataset
        train_ds = KITTIDataset(args.data_path, "train")
        val_ds = KITTIDataset(args.data_path, "val")
    elif name == "floorplan3d":
        from md_rdm_tpu_torch.data.floorplan3d import Floorplan3DDataset
        train_ds = Floorplan3DDataset(args.data_path, args.dataset_type,
                                      "train")
        val_ds = Floorplan3DDataset(args.data_path, args.dataset_type, "val")
    elif name == "structured3d":
        from md_rdm_tpu_torch.data.structured3d import Structured3DDataset
        train_ds = Structured3DDataset(args.data_path, split="train")
        val_ds = Structured3DDataset(args.data_path, split="val")
    else:
        raise SystemExit(f"unknown dataset {name!r}")
    return train_ds, val_ds


def make_datasets(args):
    """(train_loader, val_loader) for ``args.dataset``: the same datasets
    and loaders as the JAX CLI, so a seed gives the same batches.  Under
    ``--augment device`` the train set yields raw uint8 batches
    (``data/raw.py``); a '+' mix is refused there, since its ConcatDataset
    has no raw samples (the JAX CLI fails on it too)."""
    from md_rdm_tpu_torch.data.base import DataLoader

    names = args.dataset.split("+")
    if args.augment == "device" and len(names) > 1:
        raise SystemExit(
            f"--augment device takes one dataset, not the mix "
            f"{args.dataset!r}: a ConcatDataset has no raw samples")
    pairs = [_dataset_pair(n, args, i) for i, n in enumerate(names)]
    if len(pairs) == 1:
        train_ds, val_ds = pairs[0]
    else:
        # '+'-mix: one shuffled ConcatDataset (dataloader.py:42-61).  When
        # member output sizes differ, the primary member's preprocessing
        # overrides the others (the reference's transform-override feature)
        # so every sample lands at one collatable shape.
        from md_rdm_tpu_torch.data.base import ConcatDataset
        train_ds = ConcatDataset([p[0] for p in pairs],
                                 seed=args.seed or 0)
        val_ds = ConcatDataset([p[1] for p in pairs],
                               seed=(args.seed or 0) + 1)
        if len({tuple(getattr(p[0], "output_size", ()))
                for p in pairs}) > 1:
            train_ds.transform = pairs[0][0].transform
            val_ds.transform = pairs[0][1].transform

    primary = names[0]
    if args.augment == "device":
        # the host decodes and standardizes to a fixed raw size only; the
        # random spatial and color recipe runs in the train step
        from md_rdm_tpu_torch.data.raw import RawResizeDataset
        hw = (250, 333) if primary in ("nyu", "synthetic") else (250, 444)
        train_ds = RawResizeDataset(train_ds, raw_hw=hw, keep_uint8=True,
                                    cache=primary == "synthetic")

    train_loader = DataLoader(train_ds, args.batch_size, shuffle=True,
                              num_workers=args.worker, drop_last=True)
    # WeightedRandomSampler role (main.py:83-85): kitti validates on 3200
    # uniformly-resampled (with replacement) images per epoch at the TRAIN
    # batch size (main.py:102-104); other datasets stream the whole val set
    val_samples = args.val_samples
    if val_samples is None:
        val_samples = 3200 if primary == "kitti" else 0
    if val_samples:
        val_loader = DataLoader(val_ds, args.batch_size,
                                num_workers=args.worker,
                                sample_weights=np.ones(len(val_ds)),
                                num_samples=val_samples,
                                seed=args.seed or 0)
    else:
        val_loader = DataLoader(val_ds, args.eval_batch_size, shuffle=False,
                                num_workers=1)
    return train_loader, val_loader


def find_learning_rate(trainer, state, loader, lo=1e-7, hi=1.0,
                       num_steps=50) -> float:
    """LR range test (the tuner.lr_find equivalent): ramp the LR
    exponentially, one train step each, track the loss, and suggest the LR
    at the steepest loss descent (1e-4 when fewer than 3 losses are
    finite).  The sweep trains ``state`` in place.  Under on-device
    augmentation the raw batches go through the augmented step, their
    factors drawn from a generator of the sweep's own, seeded 0.  Under a
    group every rank sweeps its rows and reads the global loss."""
    import torch

    from md_rdm_tpu_torch.training.optim import set_lr

    lrs = np.exp(np.linspace(np.log(lo), np.log(hi), num_steps))
    losses = []
    gen = (torch.Generator(device=trainer.device).manual_seed(0)
           if trainer._device_augment else None)
    it = iter(loader)
    for lr in lrs:
        set_lr(state.optimizer, float(lr))
        try:
            x, y = next(it)
        except StopIteration:
            it = iter(loader)
            x, y = next(it)
        xd, yd = trainer._put(x, y)
        if gen is not None:
            state, logs = trainer.module.train_step_device_aug(
                state, xd, yd, gen)
        else:
            state, logs = trainer.module.train_step(state, xd, yd)
        losses.append(float(logs["loss"]))
        if not np.isfinite(losses[-1]):
            break
    losses = np.asarray(losses)
    valid = np.isfinite(losses)
    if valid.sum() < 3:
        return 1e-4
    grad = np.gradient(losses[valid], np.log(lrs[: valid.sum()]))
    return float(lrs[:valid.sum()][np.argmin(grad)])


def build_config(args):
    """Typed Config from parsed CLI args (separated from main for tests)."""
    from md_rdm_tpu_torch.core.config import (
        Config, DataConfig, ModelConfig, SIDConfig, TrainConfig)

    # per-dataset SID discretization constants (computations.py:559-631);
    # synthetic scenes are NYU-like depth ranges; a '+'-mix follows its
    # primary (first) member
    primary_ds = args.dataset.split("+")[0]
    sid_dataset = "nyu" if primary_ds == "synthetic" else primary_ds
    return Config(
        sid=SIDConfig.for_dataset(sid_dataset),
        model=ModelConfig(
            decoder_ids=tuple(args.decoders),
            compute_dtype="bfloat16" if args.precision == 16 else "float32",
            remat=args.remat,
            soft_ordinal_decode=args.soft_decode,
            fusion_init=args.fusion_init,
            fusion_eps=args.fusion_eps,
            fused_dense=args.fused_dense,
            growth_matmul=args.growth_matmul,
            flat_block=args.flat_block),
        data=DataConfig(dataset=args.dataset,
                        dataset_type=args.dataset_type,
                        path=args.nyu_path or args.data_path,
                        batch_size=args.batch_size,
                        eval_batch_size=args.eval_batch_size,
                        num_workers=args.worker,
                        augment_backend=args.augment,
                        download=args.download),
        train=TrainConfig(
            learning_rate=args.learning_rate,
            fast_modules=tuple(args.fast_modules),
            fast_lr_multiplier=args.fast_lr_multiplier,
            run_dirs=args.run_dirs,
            plateau_patience=args.plateau_patience,
            min_epochs=args.min_epochs, max_epochs=args.max_epochs,
            metrics_space="linear" if args.linear_metrics else "faithful",
            seed=args.seed, metrics=tuple(args.metrics),
            overfit=args.overfit, dev=args.dev,
            debug_nans=args.detect_anomaly,
            checkpoint_dir=args.workdir, resume=args.resume,
            save_top_k=args.save_top_k,
            data_parallel=args.devices),
    )


def _start_profile(trainer):
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if trainer.device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _stop_profile(prof, trainer) -> None:
    prof.stop()
    out = trainer.workdir / "profile"
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
    print(f"wrote {out / 'trace.json'}")


def main(argv=None):
    args = build_parser().parse_args(argv)

    from md_rdm_tpu_torch.core.mesh import create_mesh, destroy_mesh

    # the group first: a missing card or launcher raises before any
    # dataset is read
    mesh = create_mesh(args.devices, args.device)
    try:
        return _train(args, mesh)
    finally:
        destroy_mesh(mesh)


def _train(args, mesh):
    say = print if mesh.is_main else (lambda *a, **k: None)
    # every rank draws the same batches: rank 0's seed
    args.seed = mesh.broadcast_object(
        random.randrange(4294967295) if args.seed is None else args.seed)
    say(f"random seed: {args.seed}")
    np.random.seed(args.seed)

    from md_rdm_tpu_torch.training.loop import Trainer

    config = build_config(args)
    trainer = Trainer(config, workdir=args.workdir, mesh=mesh)
    try:
        train_loader, val_loader = make_datasets(args)
        if not args.find_learning_rate:
            # build the kernels and run throwaway steps (Trainer.warmup)
            # BEFORE the real state exists: peak memory stays at one
            # state's footprint
            xw, yw = next(iter(train_loader))
            t0 = time.perf_counter()
            trainer.warmup(xw, yw)
            say(f"warmup done in {time.perf_counter() - t0:.1f}s")

        # the port's init needs no sample; the batch is drawn all the same
        # (it advances the loader's epoch, as the JAX CLI's draw does), so
        # a seed gives the batches of the JAX CLI
        next(iter(val_loader))
        state = trainer.init_state()
        if args.resume:
            _, state = trainer.restore(state)

        prof = (_start_profile(trainer)
                if args.profile and mesh.is_main else None)
        try:
            if args.find_learning_rate:
                suggested = find_learning_rate(trainer, state, train_loader)
                say(f"Old learning rate: {args.learning_rate}")
                say(f"Suggested learning rate: {suggested}")
                return None
            return trainer.fit(state, train_loader, val_loader)
        finally:
            if prof is not None:
                _stop_profile(prof, trainer)
    finally:
        trainer.close()


if __name__ == "__main__":
    main()
