"""Timing on the card: frozen copies of ``chip_smoke.py``'s ``cuda_ms``,
``enqueue_ms`` and ``profile_window``, the last one extended with the
longest idle gaps and what the host was doing in them.

``profile_window`` runs ``torch.profiler`` over back-to-back calls: the
device's busy time is the union of its kernels' and copies' intervals,
the idle share 1 - busy / wall over the profiled stretch.  Profile several
calls in a fresh process: one call counts the window's edges, and traces
late in a long process lose records.
"""
from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, List, Tuple

import torch

# host operations looked at, back from a gap, for the one open around it
SCAN = 4096


def cuda_ms(fn: Callable, iters: int, warmup: int = 2) -> float:
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


def enqueue_ms(fn: Callable, iters: int = 3) -> List[float]:
    """Host milliseconds to enqueue each of ``iters`` calls of ``fn()``
    onto an idle card (the device finishes later).  Where it reaches the
    device time of ``fn``, the host, not the card, sets the rate."""
    out = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return out


def _union(intervals: List[Tuple[float, float]]):
    """Merged, sorted intervals."""
    merged: List[List[float]] = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def _top(pairs: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(pairs.items(), key=lambda kv: -kv[1])
            [:n]]


def reduce_events(device: List[Tuple[float, float, str]],
                  host: List[Tuple[float, float, str]],
                  t_lo: float, t_hi: float) -> Dict:
    """Busy seconds, device operations by name and the idle gaps by the
    innermost host operation open at each gap's midpoint, from the
    profiler's events (microseconds) within [t_lo, t_hi]."""
    merged = _union([(lo, hi) for lo, hi, _ in device])
    busy_us = sum(hi - lo for lo, hi in merged)
    by_name: Dict[str, float] = {}
    for lo, hi, name in device:
        by_name[name[:120]] = by_name.get(name[:120], 0.0) + (hi - lo) / 1e6
    edges = [t_lo] + [x for lh in merged for x in lh] + [t_hi]
    gaps: Dict[str, float] = {}
    host = sorted(host)
    starts = [h[0] for h in host]
    for lo, hi in zip(edges[0::2], edges[1::2]):
        if hi <= lo:
            continue
        mid = 0.5 * (lo + hi)
        # the latest-starting host operation still open at the midpoint
        # is the innermost of those nested around it
        inner = "(no host operation)"
        for i in range(bisect.bisect_right(starts, mid) - 1,
                       max(-1, bisect.bisect_right(starts, mid) - 1
                           - SCAN), -1):
            if host[i][1] >= mid:
                inner = host[i][2][:120]
                break
        gaps[inner] = gaps.get(inner, 0.0) + (hi - lo) / 1e6
    return {"busy_s": busy_us / 1e6, "device_ops": len(device),
            "by_name": by_name, "gaps": gaps}


def profile_window(fn: Callable, reps: int) -> Dict:
    """``torch.profiler`` over ``reps`` back-to-back calls of ``fn`` after
    one unprofiled call: busy and wall seconds, idle share, device
    operations per call, and the breakdown (device operations by time,
    idle gaps by host operation), at most ten entries each."""
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
        wall_s = time.perf_counter() - t0
    device, host = [], []
    for e in prof.events():
        row = (e.time_range.start, e.time_range.end, e.name)
        (device if e.device_type == DeviceType.CUDA else host).append(row)
    if not device:
        raise RuntimeError("the profiler recorded no device activity")
    t_lo = min(min(r[0] for r in device), min((r[0] for r in host),
                                               default=float("inf")))
    t_hi = max(r[1] for r in device)
    red = reduce_events(device, host, t_lo, t_hi)
    return {"calls": reps, "wall_s": wall_s, "busy_s": red["busy_s"],
            "idle_share": 1.0 - red["busy_s"] / wall_s,
            "device_ops_per_call": red["device_ops"] / reps,
            "breakdown": {"device_ops": _top(red["by_name"]),
                          "idle_gaps": _top(red["gaps"])}}
