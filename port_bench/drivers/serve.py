"""Serving traffic: one caller sends a batch through
``Predictor.__call__`` (numpy in, numpy out) and the next when it returns.

Traffic parameters: ``batch`` (images a call), ``pool`` (seeded batches,
cycled), ``warm_calls`` (set-up calls: the first runs eagerly, the second
captures the CUDA graph, later ones replay), ``check_calls`` (window calls
sampled from the seed and compared with the reference), ``trace_calls``
(profiled calls), ``enqueue_calls`` (calls timed for their enqueue alone),
``block_calls`` (profiled calls of each encoder dense block).

End to end: ``serve_img_per_s`` (every image returned over the window)
and ``frame_p95_ms`` (the 95th percentile of a call's latency).
"""
from __future__ import annotations

import itertools
import time
import numpy as np
import torch

from port_bench.lib import synthetic
from port_bench.lib.compare import serve_numbers
from port_bench.lib.context import Context, Reservoir
from port_bench.lib.weights import seeded_state_dict
from port_bench.reference.model import ReferenceModel


def make_pool(ctx: Context):
    gen = synthetic.generator(ctx.seed, ctx.device, 0)
    return [synthetic.images(gen, ctx.batch_size, ctx.device).cpu().numpy()
            for _ in range(int(ctx.cell.traffic["pool"]))]


def block_inputs(model, paths, run):
    """The inputs each named submodule of ``model`` gets during ``run()``,
    detached copies."""
    got, hooks = {}, []
    for path in paths:
        def pre(mod, args, path=path):
            got.setdefault(path, args[0].detach().clone())
        hooks.append(model.get_submodule(path).register_forward_pre_hook(pre))
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return got


class Session:
    """Set-up: the seeded weights into a ``Predictor``, the pool, the
    warm calls."""

    def __init__(self, ctx: Context):
        from md_rdm_tpu_torch.core.config import ModelConfig
        from md_rdm_tpu_torch.inference import Predictor
        self.ctx = ctx
        t = ctx.cell.traffic
        self.pool = make_pool(ctx)
        sd = seeded_state_dict(ctx.model_fields, ctx.seed, ctx.device)
        self.predictor = Predictor(sd, ModelConfig.from_dict(
            ctx.model_fields), device=ctx.device)
        del sd
        for i in range(int(t.get("warm_calls", 3))):
            self.predictor(self.pool[i % len(self.pool)])
        ctx.sync()
        self.sample = Reservoir(ctx.seed, int(t["check_calls"]))

    def window(self, seconds: float):
        pool, call = self.pool, self.predictor
        lat = []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        i = 0
        while True:
            p = i % len(pool)
            ts = time.perf_counter()
            final, decode = call(pool[p])
            te = time.perf_counter()
            lat.append(te - ts)
            self.sample.offer(i, (p, final, decode))
            i += 1
            if te >= deadline:
                break
        images = i * self.ctx.batch_size
        return {"serve_img_per_s": images / (te - t0),
                "frame_p95_ms": 1e3 * float(np.percentile(lat, 95))}, images

    def trace(self):
        """Profiled calls, enqueue times and the encoder blocks alone."""
        from port_bench.lib import timing, work
        ctx, t = self.ctx, self.ctx.cell.traffic
        pool, pred = self.pool, self.predictor
        calls = int(t["trace_calls"])
        it = itertools.count()
        prof = timing.profile_window(
            lambda: pred(pool[next(it) % len(pool)]), calls)
        host = torch.from_numpy(pool[0])
        enq = timing.enqueue_ms(lambda: pred.predict(host),
                                int(t["enqueue_calls"]))
        model = pred.model
        paths = list(work.ENCODER_BLOCKS)
        with torch.inference_mode():
            inputs = block_inputs(
                model, paths,
                lambda: model(host.to(ctx.device)))
            blocks = []
            for path in paths:
                block, x = model.get_submodule(path), inputs[path]
                b = timing.profile_window(lambda: block(x),
                                          int(t["block_calls"]))
                blocks.append({
                    "path": path, "busy_s_per_call": b["busy_s"] / b["calls"],
                    "bound_s": work.block_bound_s(path, ctx.batch_size,
                                                  ctx.dtype, train=False)})
        return {"mode": "serve", "dtype": ctx.dtype,
                "busy_s": prof["busy_s"], "wall_s": prof["wall_s"],
                "calls": calls, "images": calls * ctx.batch_size,
                "enqueue_ms": enq, "blocks": blocks, "blocks_train": False,
                "flops_per_image": work.model_flops_per_image(
                    ctx.model_fields),
                "breakdown": prof["breakdown"]}

    def check(self):
        """Frees the program, then runs the reference over the sampled
        calls' batches and compares."""
        ctx = self.ctx
        sampled = self.sample.items()
        self.predictor = None
        ctx.free()
        ref = reference_model(ctx)
        maps, decodes, rmaps, rdecodes, rmargins = [], [], [], [], []
        with torch.no_grad():
            for p, final, decode in sampled:
                rf, rd, rp = reference_serve(ref, self.pool[p], ctx.device)
                maps += list(final)
                decodes += list(decode)
                rmaps += list(rf)
                rdecodes += list(rd)
                rmargins += list(rp)
        return serve_numbers(maps, decodes, rmaps, rdecodes, rmargins)


def reference_model(ctx: Context) -> ReferenceModel:
    ref = ReferenceModel(ctx.model_fields)
    ref.load_state_dict(seeded_state_dict(ctx.model_fields, ctx.seed,
                                          ctx.device))
    return ref.to(ctx.device).eval()


def reference_serve(ref: ReferenceModel, images: np.ndarray, device):
    """(log maps, decodes, ordinal margins) of the reference, numpy."""
    from port_bench.reference.decompose import recombination
    yhat, decode, _, margin = ref(torch.from_numpy(images).to(device))
    return (recombination(list(yhat)).cpu().numpy(), decode.cpu().numpy(),
            margin.cpu().numpy())
