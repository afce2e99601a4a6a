"""Seeded weights, made on the device in a few large calls.

One generator on the device draws every normal and every uniform number
the state_dict needs in two calls; each tensor is a slice of them, scaled.
The shapes come from the plain reference built on the meta device, whose
state_dict keys are the port's.  The same seed on the same device gives
the same state_dict, so the benchmark makes it again for the reference
instead of keeping a copy.

* convolution and transposed-convolution kernels: N(0, 1/fan_in);
* convolution biases: 0, except decoder 1's head, whose first ordinal
  pair is set to (-10, +10), so that every pixel's DORN decode counts at
  least one pair: an empty decode makes the faithful fusion tail's
  geometric mean 0 and the map NaN, which no trained model serves;
* BatchNorm: weight U(0.5, 1.5), bias N(0, 0.2), running mean N(0, 0.5),
  running variance U(0.5, 1.5) (non-trivial statistics, so that eval-mode
  runs test the folded norms for real);
* fusion weights: |N(0, 1)|.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict

import torch
import torch.nn as nn

from port_bench.reference.model import ReferenceModel


def _plan(model_fields: Dict):
    """(key, shape, kind, scale) for every state_dict entry, in order."""
    with torch.device("meta"):
        ref = ReferenceModel(model_fields)
    plan = []
    for mname, mod in ref.named_modules():
        prefix = f"{mname}." if mname else ""
        for pname, t in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            key, shape = prefix + pname, tuple(t.shape)
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
                if pname == "weight":
                    fan_in = (t[:, 0] if isinstance(mod, nn.ConvTranspose2d)
                              else t[0]).numel()
                    plan.append((key, shape, "normal", 1 / math.sqrt(fan_in)))
                else:
                    plan.append((key, shape, "zero", 0.0))
            elif isinstance(mod, nn.BatchNorm2d):
                kind = {"weight": "uniform", "bias": "normal",
                        "running_mean": "normal", "running_var": "uniform",
                        "num_batches_tracked": "count"}[pname]
                plan.append((key, shape, kind,
                             {"bias": 0.2, "running_mean": 0.5}.get(pname,
                                                                    1.0)))
            else:
                plan.append((key, shape, "abs_normal", 1.0))
    return plan


def seeded_state_dict(model_fields: Dict, seed: int,
                      device) -> "OrderedDict[str, torch.Tensor]":
    """The configuration's state_dict from ``seed``, float32 on
    ``device``."""
    plan = _plan(model_fields)
    count = {"normal": 0, "uniform": 0}
    for _, shape, kind, _ in plan:
        k = "uniform" if kind == "uniform" else "normal"
        if kind in ("normal", "uniform", "abs_normal"):
            count[k] += math.prod(shape)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    pools = {
        "normal": torch.randn(count["normal"], generator=gen, device=device),
        "uniform": torch.rand(count["uniform"], generator=gen,
                              device=device)}
    used = {"normal": 0, "uniform": 0}
    sd = OrderedDict()
    for key, shape, kind, scale in plan:
        n = math.prod(shape)
        if kind == "zero":
            sd[key] = torch.zeros(shape, device=device)
        elif kind == "count":
            sd[key] = torch.zeros(shape, dtype=torch.long, device=device)
        else:
            pool = "uniform" if kind == "uniform" else "normal"
            t = pools[pool][used[pool]:used[pool] + n].view(shape)
            used[pool] += n
            if kind == "uniform":
                t = t + 0.5
            elif kind == "abs_normal":
                t = t.abs()
            else:
                t = t * scale
            sd[key] = t
    head = sd.get("d_1.conv2.bias")
    if head is not None:
        head[0], head[1] = -10.0, 10.0
    return sd
