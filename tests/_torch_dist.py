"""Rank processes for ``tests/test_torch_distributed.py``.

Each rank joins a gloo group over a ``file://`` rendezvous, runs the jobs
it is given on the CPU, and saves what they return to ``rank<r>.pt`` in
the output directory.  Torch and the port only: the ranks are spawned and
start from a fresh import, and the comparisons with the JAX package run
in the test process.  The whole live-model step is held against the
1-process step inside the ranks (each decode in one of them), so that no
0.7 GB state crosses the disk.
"""
import contextlib
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from md_rdm_tpu_torch.core import config as tcfg
from md_rdm_tpu_torch.core import mesh as tmesh
from md_rdm_tpu_torch.models import densenet as tdn
from md_rdm_tpu_torch.models.routing import Routing
from md_rdm_tpu_torch.models.rdm import (DepthEstimationNet, Weights,
                                         init_parameters)
from md_rdm_tpu_torch.training import loop as tloop
from md_rdm_tpu_torch.training.module import DepthTrainer, TrainState
from md_rdm_tpu_torch.training.optim import make_optimizer

WORLD = 2
# The live model with each DORN decode: the default hard decode counts
# P > 0.5, and at batch 4 a rounding flip of one pixel's count moves the
# MSE term by 1.4e-5 relative between two thread counts of one process,
# past the 1e-5 loss bar; the soft (differentiable) decode moves it by
# 6e-8 and is held to that bar.
STEP_CONFIGS = {
    "soft": tcfg.Config(model=tcfg.ModelConfig(soft_ordinal_decode=True)),
    "hard": tcfg.Config()}
LOSS_TERMS = ("loss", "MSE", "Ord_Loss", "Fine_Detail")
# Faults planted in the 2-rank step (soft decode), each of which the
# whole-step bars must catch: BatchNorm on this rank's rows alone, and
# gradients left unaveraged.
FAULTS = {"per_rank_norm": ("current", lambda: None),
          "unaveraged_gradients": ("average_gradients",
                                   lambda mesh, params: None)}


@contextlib.contextmanager
def planted(fault: str):
    """``core.mesh`` with the function behind ``fault`` stubbed out."""
    name, stub = FAULTS[fault]
    saved = getattr(tmesh, name)
    setattr(tmesh, name, stub)
    try:
        yield
    finally:
        setattr(tmesh, name, saved)


def step_inputs():
    """The seeded live-model weights and the global batch of 4 rows."""
    model = DepthEstimationNet(tcfg.ModelConfig())
    init_parameters(model, 0)
    rng = np.random.default_rng(4)
    x = rng.random((4, 226, 226, 3), dtype=np.float32)
    y = rng.random((4, 1, 226, 226), dtype=np.float32) * 9 + 0.5
    y[:, :, :5, :5] = 0.0
    return model.state_dict(), torch.from_numpy(x), torch.from_numpy(y)


def one_step(mesh, weights, x, y, decode="soft", threads=None):
    """One live-model train step from ``weights`` on this mesh's rows of
    (x, y) (at ``threads`` threads): its logs, one float32 vector each of
    the parameters, running statistics and gradients (in named order,
    with the statistics' names), and the collectives it made."""
    saved = torch.get_num_threads()
    torch.set_num_threads(threads or saved)
    try:
        trainer = DepthTrainer(STEP_CONFIGS[decode], mesh=mesh)
        state = trainer.init(weights)
        calls, nbytes = mesh.counts.calls, mesh.counts.bytes
        state, logs = trainer.train_step(
            state, tmesh.shard_batch(mesh, x), tmesh.shard_batch(mesh, y))
    finally:
        torch.set_num_threads(saved)
    model = state.model
    stats = [(n, b) for n, b in model.named_buffers() if "running" in n]
    return {"logs": {k: float(v) for k, v in logs.items()},
            "params": _flat(p for _, p in model.named_parameters()),
            "stats": _flat(b for _, b in stats),
            "stat_sizes": [(n, b.numel()) for n, b in stats],
            "param_names": [n for n, _ in model.named_parameters()],
            "grads": _flat(p.grad for _, p in model.named_parameters()
                           if p.grad is not None),
            "grad_none": [n for n, p in model.named_parameters()
                          if p.grad is None],
            "collectives": (mesh.counts.calls - calls,
                            mesh.counts.bytes - nbytes)}


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """Normalized L2 error ||got - want|| / ||want|| in float64."""
    got, want = got.double(), want.double()
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


def _same_on_every_rank(mesh, tensors) -> bool:
    """Whether rank 0's tensors equal this rank's, bit for bit."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    mine = flat.clone()
    dist.broadcast(flat, 0)
    return bool(torch.equal(flat, mine))


def _stat_errors(got: dict, want: dict) -> dict:
    """relL2 of the running statistics over all of them and the largest
    relL2 of one tensor."""
    worst, at = 0.0, 0
    for _, n in want["stat_sizes"]:
        worst = max(worst, rel(got["stats"][at:at + n],
                               want["stats"][at:at + n]))
        at += n
    return {"stats": rel(got["stats"], want["stats"]),
            "stats_worst_tensor": worst}


def _against(got: dict, want: dict) -> dict:
    """A step's errors against the 1-process step ``want``: the loss
    terms' relative errors, every log's absolute error, and relL2 of
    gradients, parameters and running statistics."""
    return {"logs": {k: abs(got["logs"][k] - want["logs"][k])
                     / abs(want["logs"][k]) for k in LOSS_TERMS},
            "logs_abs": {k: abs(got["logs"][k] - want["logs"][k])
                         for k in want["logs"]},
            "grads": rel(got["grads"], want["grads"]),
            "params": rel(got["params"], want["params"]),
            **_stat_errors(got, want)}


def holder(decode: str) -> int:
    """The rank that holds ``decode``'s 2-rank step against the 1-process
    step (and, for the soft decode, the planted faults')."""
    return list(STEP_CONFIGS).index(decode) % WORLD


def job_step(mesh, out: Path):
    """Each rank first runs the 1-process step of the decode it holds on
    all 4 rows, at two thread counts: the second, one thread, gives the
    rounding floor.  (The 2-rank step's own floor, one thread against
    two, measured 3.7x smaller in its gradients, so it is not run.)
    Then the 2-rank step with each decode and with each planted fault;
    the holder compares each with its 1-process step as it comes.  Only
    logs and errors leave the process (a state is 0.7 GB)."""
    weights, x, y = step_inputs()
    mine = [d for d in STEP_CONFIGS if holder(d) == mesh.rank]
    one, floors = {}, {}
    for decode in mine:
        one[decode] = one_step(tmesh.Mesh(device="cpu"), weights, x, y,
                               decode)
        floors[decode] = _against(one_step(tmesh.Mesh(device="cpu"),
                                           weights, x, y, decode, 1),
                                  one[decode])
    res = {}
    for decode in STEP_CONFIGS:
        two = one_step(mesh, weights, x, y, decode)
        res[decode] = {
            "logs": two["logs"], "collectives": two["collectives"],
            "same_as_rank0": _same_on_every_rank(
                mesh, [two["params"], two["stats"], two["grads"]])}
        if decode not in mine:
            continue
        ref = one[decode]
        res[decode].update(
            one_logs=ref["logs"], errors=_against(two, ref),
            floors=floors[decode],
            grad_none=(two["grad_none"], ref["grad_none"]),
            n_stats=len(ref["stat_sizes"]),
            moved={"params": rel(two["params"], _flat(
                       weights[n] for n in ref["param_names"])),
                   "stats": rel(ref["stats"], _flat(
                       weights[n] for n, _ in ref["stat_sizes"]))})
    for fault in FAULTS:
        with planted(fault):
            step = one_step(mesh, weights, x, y)
        res[fault] = {"logs": step["logs"]}
        if "soft" in mine:
            res[fault]["errors"] = _against(step, one["soft"])
    return res


# The layers the layer jobs run: S=57's routed by the default tables, and
# (``tests/test_torch_routing_dist.py``) an S=29 and an S=15 layer routed
# forward and backward, whose norm2 statistics take the covariance and the
# z form at 2 rows a rank.
LAYERS = {"dense57": lambda: tdn.DenseLayer(96, 57),
          "transition": lambda: tdn.Transition(96, 48),
          "dense29_routed": lambda: tdn.DenseLayer(
              192, 29, routing=Routing("on_all_bwd")),
          "dense15_routed": lambda: tdn.DenseLayer(
              384, 15, routing=Routing("on_all_bwd"))}


def _layer(name):
    return LAYERS[name]()


def job_layers(mesh, out: Path, inputs: str = "layers_in.pt"):
    """Each layer of ``inputs`` in train mode on this rank's rows,
    the loss sum(out * cot) over the global batch: this rank's output and
    input-gradient rows, the parameter gradients summed over the ranks,
    and the updated running statistics."""
    inp = torch.load(out / inputs, weights_only=True)
    res = {}
    for name, case in inp.items():
        layer = _layer(name)
        layer.load_state_dict(case["state"], strict=True)
        layer.train()
        x = tmesh.shard_batch(mesh, case["x"]).clone().requires_grad_()
        cot = tmesh.shard_batch(mesh, case["cot"])
        with tmesh.active(mesh):
            y = layer(x.permute(0, 3, 1, 2))
            (y * cot.permute(0, 3, 1, 2)).sum().backward()
        grads = {n: p.grad for n, p in layer.named_parameters()}
        for g in grads.values():
            mesh.all_reduce_(g)
        res[name] = {"out": y.detach().permute(0, 2, 3, 1).contiguous(),
                     "dx": x.grad, "grads": grads,
                     "state": layer.state_dict()}
    return res


def _loop_config(out: Path, **data):
    return tcfg.Config(
        data=tcfg.DataConfig(**data),
        train=tcfg.TrainConfig(metrics=("delta1", "mse"), seed=3,
                               data_parallel=WORLD, plateau_patience=0,
                               max_epochs=2, save_top_k=1,
                               checkpoint_dir=str(out / "runs")))


def job_loop(mesh, out: Path):
    """A Trainer of the group: the padded eval of a 3-row batch, the
    augmentation factors of two steps of 2 rows per rank, a run
    directory, and ``fit`` through stubbed epochs (its logs, schedule and
    checkpoint)."""
    weights, x, y = step_inputs()
    trainer = tloop.Trainer(_loop_config(out, augment_backend="device"),
                            device="cpu")
    res = {"workdir": str(trainer.workdir),
           "batch_multiple": trainer.batch_multiple}
    state = trainer.module.init(weights)
    x3, y3 = x[:3].numpy(), y[:3].numpy()
    res["eval"] = trainer.eval_epoch(state, [(x3, y3)], 0)
    res["factors"] = [trainer._factors(trainer._aug_gen, 2)
                      for _ in range(2)]

    vals = iter([0.5, 0.4])

    def train_epoch(state, loader, epoch):
        return state, {"loss": 1.0, "step_time_s": 0.1}

    def eval_epoch(state, loader, epoch):
        return {"delta1": next(vals), "mse": 1.0}

    trainer.train_epoch, trainer.eval_epoch = train_epoch, eval_epoch
    model = torch.nn.Module()
    model.weight_layer = Weights(tcfg.ModelConfig().vector_sizes)
    small = TrainState(model, make_optimizer(model, 1e-3), 0)
    trainer.fit(small, None, None)
    res["lr"] = small.optimizer.param_groups[0]["lr"]
    trainer.close()
    try:
        tmesh.create_mesh(WORLD + 1, "cpu")
    except ValueError as e:
        res["mismatch"] = str(e)
    return res


# The blocks of ``tests/test_torch_remat.py``'s job: S=15, C0 96, bn_size
# 2, 3 layers, rematerialized (routed both ways, and unrouted) and flat.
BLOCKS = {
    "remat_routed": lambda: tdn.DenseBlock(
        3, 96, 2, routing=Routing("on_all_bwd", "off"), remat=True),
    "remat_off": lambda: tdn.DenseBlock(3, 96, 2, routing=Routing("off"),
                                        remat=True),
    "flat": lambda: tdn.DenseBlock(3, 96, 2,
                                   routing=Routing("on_all_bwd", "on_all"))}


@contextlib.contextmanager
def recompute_without_group():
    """The planted fault of the blocks job: the backward's recomputation
    takes this rank's rows alone, as it would if the forward's group were
    not kept."""
    saved = tdn.recompute
    tdn.recompute = lambda mesh: saved(None)
    try:
        yield
    finally:
        tdn.recompute = saved


def job_blocks(mesh, out: Path):
    """Each block of ``blocks_in.pt`` in train mode on this rank's rows:
    the forward inside ``core.mesh.active``, the backward after it, outside
    (the recomputation must keep the forward's group by itself); then
    again with the group not kept (:func:`recompute_without_group`), where
    an error raised is recorded.  Output and input-gradient rows,
    parameter gradients summed over the ranks, updated running
    statistics."""
    inp = torch.load(out / "blocks_in.pt", weights_only=True)
    res = {}
    for fault in (False, True):
        for name, case in inp.items():
            block = BLOCKS[name]()
            block.load_state_dict(case["state"], strict=True)
            block.train()
            x = tmesh.shard_batch(mesh, case["x"]).clone().requires_grad_()
            cot = tmesh.shard_batch(mesh, case["cot"])
            try:
                with (recompute_without_group() if fault
                      else contextlib.nullcontext()):
                    with tmesh.active(mesh):
                        y = block(x.permute(0, 3, 1, 2))
                    (y * cot.permute(0, 3, 1, 2)).sum().backward()
            except Exception as e:   # noqa: BLE001 (recorded, then held)
                if not fault:
                    raise
                res[(name, fault)] = {"error": f"{type(e).__name__}: {e}"}
                continue
            grads = {n: p.grad for n, p in block.named_parameters()}
            for g in grads.values():
                mesh.all_reduce_(g)
            res[(name, fault)] = {
                "out": y.detach().permute(0, 2, 3, 1).contiguous(),
                "dx": x.grad, "grads": grads, "state": block.state_dict()}
    return res


JOBS = {"step": job_step, "layers": job_layers, "loop": job_loop,
        "routed_layers": lambda mesh, out: job_layers(mesh, out,
                                                      "routed_in.pt"),
        "blocks": job_blocks}


def worker(rank: int, init_file: str, out: str, jobs, threads: int):
    torch.set_num_threads(threads)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=WORLD)
    try:
        mesh = tmesh.create_mesh(WORLD, "cpu")
        res = {job: JOBS[job](mesh, Path(out)) for job in jobs}
        torch.save(res, Path(out) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
