"""What a driver is given: the cell, the run's seed and the device."""
from __future__ import annotations

import dataclasses
import gc
from typing import Optional

import torch

from port_bench.lib.spec import Cell


@dataclasses.dataclass
class Context:
    cell: Cell
    seed: int
    device: str = "cuda"
    # a test's smaller batch (``None``: the traffic's own)
    batch: Optional[int] = None

    @property
    def model_fields(self):
        return self.cell.config["model"]

    @property
    def dtype(self) -> str:
        return self.model_fields.get("compute_dtype", "float32")

    @property
    def batch_size(self) -> int:
        return self.batch or int(self.cell.traffic["batch"])

    def sync(self) -> None:
        if self.device != "cpu":
            torch.cuda.synchronize()

    def free(self) -> None:
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()


class Reservoir:
    """``k`` of a window's calls, drawn from the seed (reservoir
    sampling): :meth:`offer` every call in order, :meth:`items` at the
    end, in call order."""

    def __init__(self, seed: int, k: int):
        import numpy as np
        self.rng = np.random.default_rng([int(seed), 0x5A4D])
        self.k = k
        self.kept = []

    def offer(self, index: int, item) -> None:
        if len(self.kept) < self.k:
            self.kept.append((index, item))
            return
        j = int(self.rng.integers(0, index + 1))
        if j < self.k:
            self.kept[j] = (index, item)

    def items(self):
        return [item for _, item in sorted(self.kept, key=lambda p: p[0])]
