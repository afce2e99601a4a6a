"""Training traffic: ``Trainer.train_epoch`` over a loader of seeded
batches, the captured step.

Traffic parameters: ``batch``, ``pool`` (seeded batches of images and
depth, cycled), ``first_steps`` (set-up steps, one ``train_epoch`` call of
one batch each: the first runs eagerly, the second captures the step and
replays it, the third replays; the reference follows them, and the check
reads each step's logged losses and gradient, and the state after them:
parameters, BatchNorm statistics, AdamW's moments), ``trace_steps`` (steps of the
profiled ``train_epoch``), ``block_calls`` (profiled forward + backward
calls of each encoder dense block), ``log_every`` (the loop's logging
period).

End to end: ``train_img_per_s``, every image of every step the window's
``train_epoch`` completed, over the time from the window's start to its
return (``train_epoch`` syncs at its end).
"""
from __future__ import annotations

import json
import tempfile
import time
from pathlib import Path

import torch

from port_bench.lib import synthetic
from port_bench.lib.compare import replay_numbers, train_numbers
from port_bench.lib.context import Context
from port_bench.lib.weights import seeded_state_dict
from port_bench.reference.model import ReferenceModel
from port_bench.reference.train import LOG_NAMES, make_optimizer, train_step

BETA1, BETA2 = 0.9, 0.999


def make_pool(ctx: Context):
    """(images, depth) numpy batches; every row differs."""
    n, b = int(ctx.cell.traffic["pool"]), ctx.batch_size
    gx = synthetic.generator(ctx.seed, ctx.device, 0)
    gy = synthetic.generator(ctx.seed, ctx.device, 1)
    x = synthetic.images(gx, n * b, ctx.device).cpu().numpy()
    y = synthetic.depths(gy, n * b, ctx.device).cpu().numpy()
    return [(x[i * b:(i + 1) * b], y[i * b:(i + 1) * b]) for i in range(n)]


class Loader:
    """The pool's batches from ``start``, cycled, until ``deadline`` (host
    clock) or ``steps`` batches."""

    def __init__(self, pool, start: int, deadline: float = float("inf"),
                 steps: int = 10 ** 9):
        self.pool, self.start = pool, start
        self.deadline, self.steps = deadline, steps
        self.yielded = 0

    def __iter__(self):
        i = self.start
        while self.yielded < self.steps and time.perf_counter() < self.deadline:
            self.yielded += 1
            yield self.pool[i % len(self.pool)]
            i += 1


def leaf_norms(named) -> dict:
    return {k: float(torch.linalg.vector_norm(v.detach().double()))
            for k, v in named}


def diff_norms(a: dict, b: dict, scale: float = 1.0) -> dict:
    """||a[k] - scale b[k]|| per leaf, in float64."""
    return leaf_norms((k, a[k].double() - scale * b[k].double()) for k in a)


def moment(opt, p, key: str) -> torch.Tensor:
    """AdamW's ``key`` moment of ``p``; zeros where it never stepped."""
    return opt.state.get(p, {}).get(key, torch.zeros_like(p))


def bn_stats(model) -> dict:
    """The model's BatchNorm running means and variances, by name."""
    return {k: b for k, b in model.named_buffers()
            if k.endswith(("running_mean", "running_var"))}


def host_state(model, opt, full: bool) -> dict:
    """Host copies of AdamW's first moments (``m``) and, with ``full``,
    of the parameters, the BatchNorm statistics and the second moments
    (``params``, ``bn``, ``v``), by name."""
    def host(t):
        return t.detach().to("cpu", copy=True)
    params = [(k, p) for k, p in model.named_parameters() if p.numel()]
    out = {"m": {k: host(moment(opt, p, "exp_avg")) for k, p in params}}
    if full:
        out.update(params={k: host(p) for k, p in params},
                   bn={k: host(b) for k, b in bn_stats(model).items()},
                   v={k: host(moment(opt, p, "exp_avg_sq"))
                      for k, p in params})
    return out


def end_reading(model, start) -> dict:
    """Norms per leaf after the first steps: each parameter's and each
    BatchNorm statistic's change from ``start`` (the seeded state_dict)."""
    params = [(k, p) for k, p in model.named_parameters() if p.numel()]
    return {"changes": leaf_norms((k, p - start[k]) for k, p in params),
            "bn_changes": leaf_norms((k, b - start[k])
                                     for k, b in bn_stats(model).items())}


class Session:
    """Set-up: the seeded weights into a ``Trainer``'s state, the pool,
    the first steps, with what the check needs read from them."""

    def __init__(self, ctx: Context):
        from md_rdm_tpu_torch.core.config import (Config, DataConfig,
                                                  ModelConfig, TrainConfig)
        from md_rdm_tpu_torch.training.loop import Trainer
        self.ctx = ctx
        t = ctx.cell.traffic
        self.pool = make_pool(ctx)
        fields = ctx.cell.config.get("train", {})
        config = Config(
            model=ModelConfig.from_dict(ctx.model_fields),
            data=DataConfig(dataset="synthetic", batch_size=ctx.batch_size),
            train=TrainConfig(
                learning_rate=float(fields.get("learning_rate", 1e-4)),
                weight_decay=float(fields.get("weight_decay", 0.01)),
                log_every=int(t.get("log_every", 10)),
                checkpoint_dir=str(Path(tempfile.gettempdir())
                                   / "port_bench" / ctx.cell.name)))
        self.trainer = Trainer(config, device=ctx.device)
        sd = seeded_state_dict(ctx.model_fields, ctx.seed, ctx.device)
        self.state = self.trainer.module.init(weights=sd)
        self.losses, self.states = [], []
        first = int(t["first_steps"])
        for k in range(first):
            self.state, _ = self.trainer.train_epoch(
                self.state, Loader(self.pool, k, steps=1), epoch=k)
            self.losses.append(self._logged(k + 1))
            self.states.append(host_state(self.state.model,
                                          self.state.optimizer,
                                          full=k >= first - 2))
        self.ends = end_reading(self.state.model, sd)
        del sd
        ctx.sync()
        self.next_batch = first

    def _logged(self, step: int) -> dict:
        """The loss terms the loop logged for ``step`` (its first step of
        an epoch is logged), as its logger wrote them."""
        log = self.trainer.workdir / "logs" / "metrics.jsonl"
        for line in reversed(log.read_text().splitlines()):
            rec = json.loads(line)
            if rec.get("step") == step and "train_loss" in rec:
                return {n: rec[f"train_{n}"] for n in LOG_NAMES}
        raise RuntimeError(f"port_bench: no logged step {step} in {log}")

    def window(self, seconds: float):
        t0 = time.perf_counter()
        loader = Loader(self.pool, self.next_batch, deadline=t0 + seconds)
        self.state, _ = self.trainer.train_epoch(self.state, loader, epoch=9)
        t1 = time.perf_counter()
        self.next_batch += loader.yielded
        images = loader.yielded * self.ctx.batch_size
        return {"train_img_per_s": images / (t1 - t0)}, images

    def trace(self):
        from port_bench.drivers.serve import block_inputs
        from port_bench.lib import timing, work
        ctx, t = self.ctx, self.ctx.cell.traffic
        steps = int(t["trace_steps"])

        def epoch():
            loader = Loader(self.pool, self.next_batch, steps=steps)
            self.state, _ = self.trainer.train_epoch(self.state, loader,
                                                     epoch=9)
            self.next_batch += steps

        prof = timing.profile_window(epoch, 1)
        model = self.state.model
        paths = list(work.ENCODER_BLOCKS)
        x0 = torch.from_numpy(self.pool[0][0]).to(ctx.device)
        with torch.no_grad():
            inputs = block_inputs(model, paths, lambda: model(x0))
        blocks = []
        for path in paths:
            block = model.get_submodule(path)
            params = [p for p in block.parameters() if p.requires_grad]
            x = inputs[path].requires_grad_(True)

            def fwd_bwd(block=block, x=x, params=params):
                out = block(x)
                torch.autograd.grad(out, [x] + params, torch.ones_like(out))

            b = timing.profile_window(fwd_bwd, int(t["block_calls"]))
            blocks.append({
                "path": path, "busy_s_per_call": b["busy_s"] / b["calls"],
                "bound_s": work.block_bound_s(path, ctx.batch_size,
                                              ctx.dtype, train=True)})
        return {"mode": "train", "dtype": ctx.dtype,
                "busy_s": prof["busy_s"], "wall_s": prof["wall_s"],
                "calls": steps, "images": steps * ctx.batch_size,
                "blocks": blocks, "blocks_train": True,
                "flops_per_image": work.model_flops_per_image(
                    ctx.model_fields),
                "breakdown": prof["breakdown"]}

    def check(self):
        """Frees the program, then runs the reference's first steps from
        the same seeded state on the same batches, and its last step again
        from the program's state before it (the replayed step alone), and
        compares."""
        ctx = self.ctx
        self.trainer = self.state = None
        ctx.free()
        steps = len(self.losses)
        grads = step_grads([s["m"] for s in self.states])
        want = reference_steps(ctx, self.pool, steps)
        numbers = train_numbers({"losses": self.losses, "grads": grads,
                                 **self.ends}, want)
        before, after = self.states[-2:]
        got = {"losses": self.losses[-1:], "grads": grads[-1],
               "changes": diff_norms(after["params"], before["params"]),
               "moment2": diff_norms(after["v"], before["v"], BETA2)}
        ctx.free()
        numbers.update(replay_numbers(got, reference_replay(
            ctx, self.pool[steps - 1], before, steps - 1)))
        return {**numbers, "near_pairs": want["near"]}


def step_grads(moments) -> list:
    """Each step's gradient norm per leaf, from AdamW's first moments
    after each step: g_k = (m_k - beta1 m_(k-1)) / (1 - beta1)."""
    out, before = [], {}
    for m in moments:
        out.append(diff_norms(m, before, BETA1) if before else
                   leaf_norms(m.items()))
        out[-1] = {k: v / (1 - BETA1) for k, v in out[-1].items()}
        before = m
    return out


def reference(ctx: Context, override=None):
    """The reference model from the seeded state_dict, with the entries
    of ``override`` in its place, and its AdamW."""
    fields = ctx.model_fields
    sd = seeded_state_dict(fields, ctx.seed, ctx.device)
    for k, v in (override or {}).items():
        sd[k] = v.to(ctx.device)
    ref = ReferenceModel(fields).to(ctx.device)
    ref.load_state_dict(sd)
    return ref, make_optimizer(ref, ctx.cell.config.get("train", {})), sd


def reference_steps(ctx: Context, pool, steps: int) -> dict:
    """The reference's readings of the first steps
    (``reference.train.train_step``), as :func:`compare.train_numbers`
    takes them, and ``near``: its ordinal pairs near 0.5 over the
    steps."""
    ref, opt, sd = reference(ctx)
    out = {"losses": [], "grads": [], "near": 0.0}
    for k in range(steps):
        x, y = (torch.from_numpy(a).to(ctx.device) for a in pool[k])
        out["losses"].append(train_step(ref, opt, x, y))
        out["near"] += out["losses"][-1].pop("near_pairs", 0.0)
        out["grads"].append(leaf_norms(
            (n, p.grad) for n, p in ref.named_parameters() if p.numel()))
    out.update(end_reading(ref, sd))
    return out


def reference_replay(ctx: Context, batch, before: dict, step: int) -> dict:
    """The reference's step on ``batch`` from the program's state
    ``before`` it (parameters, BatchNorm statistics, AdamW's moments after
    ``step`` steps), read as :func:`compare.replay_numbers` takes it."""
    ref, opt, _ = reference(ctx, {**before["params"], **before["bn"]})
    params = [(k, p) for k, p in ref.named_parameters() if p.numel()]
    for k, p in params:
        opt.state[p] = {"step": torch.tensor(float(step)), **{
            key: before[src][k].to(ctx.device, copy=True)
            for key, src in (("exp_avg", "m"), ("exp_avg_sq", "v"))}}
    x, y = (torch.from_numpy(a).to(ctx.device) for a in batch)
    losses = train_step(ref, opt, x, y)
    losses.pop("near_pairs", None)
    after = host_state(ref, opt, full=True)
    return {"losses": [losses],
            "grads": leaf_norms((k, p.grad) for k, p in params),
            "changes": diff_norms(after["params"], before["params"]),
            "moment2": diff_norms(after["v"], before["v"], BETA2)}
