"""What the check has to catch, put in the program's place for a run.

``planted(name)`` patches ``md_rdm_tpu_torch`` for the duration of a
``with`` block, so that :func:`port_bench.run.run_cell` drives the whole
run (set-up, window, the comparison that decides ``correct``) with the
timed path broken underneath:

* ``control``: the plain reference in the program's place, in the nearest
  precision below the configuration's (float32 with TF32 on, where the
  configuration states float32 with TF32 off): ``Predictor`` serves the
  reference's maps, ``Trainer`` steps the reference with
  ``torch.optim.AdamW``.
* ``altered``: one answer altered where it is produced (a served map's
  pixel and a decode count).
* ``half_batch``: half of each batch left out, the mean taken over the
  rest (serving: the first half's answers repeated over the batch).
* ``unchanged``: a train step that leaves its state unchanged.
* ``half_replayed``: the captured train step (the second call of the
  step and every replay) on half of each batch.
* ``stale_bn``: the captured train step leaves the BatchNorm running
  statistics as they are.

Tests plant these on the CPU at a small batch; ``calibrate.py`` on the
card at the cell's size.  The benchmark's own runs plant nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
from pathlib import Path
from typing import Callable, Dict

import torch


@contextlib.contextmanager
def tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class ControlPredictor:
    """``Predictor``'s interface around the plain reference, in TF32."""

    def __init__(self, state_dict, model_config, device="cuda"):
        from port_bench.reference.model import ReferenceModel
        self.device = device
        self.ref = ReferenceModel(dataclasses.asdict(model_config))
        self.ref.load_state_dict(state_dict)
        self.ref.to(device).eval()

    @torch.no_grad()
    def __call__(self, images):
        from port_bench.reference.decompose import recombination
        with tf32():
            yhat, decode, _, _ = self.ref(
                torch.from_numpy(images).to(self.device))
            final = recombination(list(yhat))
        return final.cpu().numpy(), decode.cpu().numpy()


@dataclasses.dataclass
class ControlState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer


class ControlTrainer:
    """``Trainer``'s interface around the plain reference's step, in
    TF32, logging each step's terms as the loop's logger does."""

    def __init__(self, config, device="cuda"):
        self.config, self.device = config, device
        self.workdir = Path(config.train.checkpoint_dir) / "control"
        (self.workdir / "logs").mkdir(parents=True, exist_ok=True)
        (self.workdir / "logs" / "metrics.jsonl").write_text("")
        self.module = self
        self.step = 0

    def init(self, weights) -> ControlState:
        from port_bench.reference.model import ReferenceModel
        from port_bench.reference.train import make_optimizer
        ref = ReferenceModel(dataclasses.asdict(self.config.model))
        ref.load_state_dict(weights)
        ref.to(self.device)
        t = self.config.train
        return ControlState(ref, make_optimizer(
            ref, {"learning_rate": t.learning_rate,
                  "weight_decay": t.weight_decay}))

    def train_epoch(self, state: ControlState, loader, epoch: int):
        from port_bench.reference.train import train_step
        log = self.workdir / "logs" / "metrics.jsonl"
        for x, y in loader:
            with tf32():
                terms = train_step(state.model, state.optimizer,
                                   torch.from_numpy(x).to(self.device),
                                   torch.from_numpy(y).to(self.device))
            self.step += 1
            with log.open("a") as f:
                f.write(json.dumps({"step": self.step, **{
                    f"train_{k}": v for k, v in terms.items()}}) + "\n")
        return state, {}


def control(patch) -> None:
    from md_rdm_tpu_torch import inference
    from md_rdm_tpu_torch.training import loop
    patch(inference, "Predictor", ControlPredictor)
    patch(loop, "Trainer", ControlTrainer)


def altered(patch) -> None:
    from md_rdm_tpu_torch import inference
    predict = inference._predict

    def wrong(model, images):
        final, decode = predict(model, images)
        final[0, 0, 5, 7] += 0.25
        decode[0, 0, 3, 3] += 1
        return final, decode

    patch(inference, "_predict", wrong)


def _counted_update(patch, body) -> None:
    """``DepthTrainer.update`` as ``body(update, call, self, state, x,
    y)``, ``call`` counting from 1: on the card the first call runs
    eagerly and the second is captured, so calls from the second on are
    what every replay runs."""
    from md_rdm_tpu_torch.training.module import DepthTrainer
    update, calls = DepthTrainer.update, [0]

    def counted(self, state, x, y):
        calls[0] += 1
        return body(update, calls[0], self, state, x, y)

    patch(DepthTrainer, "update", counted)


def half_batch(patch) -> None:
    from md_rdm_tpu_torch import inference
    predict = inference._predict

    def half_served(model, images):
        final, decode = predict(model, images[: images.shape[0] // 2])
        return final.repeat(2, 1, 1, 1), decode.repeat(2, 1, 1, 1)

    patch(inference, "_predict", half_served)
    _counted_update(patch, lambda update, call, self, state, x, y: update(
        self, state, x[: x.shape[0] // 2], y[: y.shape[0] // 2]))


def half_replayed(patch) -> None:
    def body(update, call, self, state, x, y):
        rows = x.shape[0] // 2 if call >= 2 else x.shape[0]
        return update(self, state, x[:rows], y[:rows])

    _counted_update(patch, body)


def stale_bn(patch) -> None:
    from md_rdm_tpu_torch.models import densenet
    update_stats, stale = densenet.update_running_stats, [False]

    def stats(norm, mean, var):
        if not stale[0]:
            update_stats(norm, mean, var)

    def body(update, call, self, state, x, y):
        stale[0] = call >= 2
        return update(self, state, x, y)

    patch(densenet, "update_running_stats", stats)
    _counted_update(patch, body)


def unchanged(patch) -> None:
    from md_rdm_tpu_torch.training.module import DepthTrainer
    init = DepthTrainer.init

    def still(self, *a, **k):
        state = init(self, *a, **k)
        state.optimizer.step = lambda *a, **k: None
        return state

    patch(DepthTrainer, "init", still)


PLANTS: Dict[str, Callable] = {
    f.__name__: f for f in (control, altered, half_batch, half_replayed,
                            stale_bn, unchanged)}


@contextlib.contextmanager
def planted(name: str):
    """``PLANTS[name]`` in the program's place inside the block."""
    undo = []

    def patch(obj, attr, value):
        undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    try:
        PLANTS[name](patch)
        yield
    finally:
        for obj, attr, old in reversed(undo):
            setattr(obj, attr, old)
