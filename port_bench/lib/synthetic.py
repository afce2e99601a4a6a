"""Seeded inputs, made on the device in bulk: smooth positive fields.

A frozen, vectorised form of ``md_rdm_tpu_torch/data/synthetic.py``'s
field (a sum of four 2-D cosines with random frequencies, phases and
amplitudes per map), drawn from one generator on the device.  Images are
three independent fields per frame scaled to [0, 1]; depth is one field
scaled to [0.5, 10) m with a zeroed (invalid) 5x5 corner, as NYU's holes.
Uniform noise would give maps that a bicubic resize drives negative (the
SID label of a negative depth is NaN); these fields stay positive.
"""
from __future__ import annotations

import math

import torch

SIZE = 226
DEPTH_MIN, DEPTH_MAX = 0.5, 10.0
CORNER = 5


def _fields(gen: torch.Generator, n: int, size: int,
            device) -> torch.Tensor:
    """(n, size, size) sums of four cosines, each scaled to [0, 1]."""
    r = torch.rand(n, 4, 5, generator=gen, device=device)
    fy, fx = 0.5 + 2.5 * r[..., 0], 0.5 + 2.5 * r[..., 1]
    phase = 2 * math.pi * (r[..., 2] + r[..., 3])
    amp = 0.2 + 0.8 * r[..., 4]
    grid = torch.arange(size, device=device, dtype=torch.float32) / size
    arg = (2 * math.pi * (fy[..., None, None] * grid[:, None]
                          + fx[..., None, None] * grid[None, :])
           + phase[..., None, None])
    f = (amp[..., None, None] * torch.cos(arg)).sum(1)
    lo = f.amin(dim=(1, 2), keepdim=True)
    hi = f.amax(dim=(1, 2), keepdim=True)
    return (f - lo) / (hi - lo + 1e-6)


def images(gen: torch.Generator, n: int, device) -> torch.Tensor:
    """(n, 226, 226, 3) float32 in [0, 1]."""
    return torch.stack([_fields(gen, n, SIZE, device) for _ in range(3)], -1)


def depths(gen: torch.Generator, n: int, device) -> torch.Tensor:
    """(n, 1, 226, 226) float32 in [0.5, 10), the corner 0."""
    y = DEPTH_MIN + (DEPTH_MAX - DEPTH_MIN) * 0.999 * _fields(
        gen, n, SIZE, device)[:, None]
    y[:, :, :CORNER, :CORNER] = 0.0
    return y


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A device generator for one stream of a run's inputs: the images of
    the pool, the depth of the pool, ... each from its own seed."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream) % (2 ** 63))
