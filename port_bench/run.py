"""Run one cell of the benchmark of ``md_rdm_tpu_torch`` once.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, traffic, limits and metrics come from
``BENCHMARK.json`` and the files it names (``lib/spec.py``).  Set-up (the
imports, the seeded weights and inputs, the program's construction and
its warm calls, in which every kernel is built and every graph captured)
is timed from the start of this process; then the window runs for
``--seconds``; with ``--trace 1`` a profiled stretch and the encoder's
dense blocks follow.  Last, the program is freed and the plain reference
judges the window's outputs.  The last line of standard output is the
result; the last lines of standard error are the compared numbers, each
beside its limit.

Exits with 3, printing no result, without a CUDA card (or with fewer than
the cell asks for), and with 4 if JAX or the JAX package is loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the program's caches stay inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(ROOT / ".cache" / sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from port_bench.lib.context import Context  # noqa: E402
from port_bench.lib.guard import loaded_forbidden  # noqa: E402
from port_bench.lib.spec import (driver, load_benchmark, reader,  # noqa: E402
                                 resolve)


def card() -> dict:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    name, _, limit = out[0].partition(",") if out else ("", "", "")
    return {"name": name.strip(), "power_limit": limit.strip()}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", batch=None) -> dict:
    """One run of a cell: the result's fields, before printing.  Tests
    call this with ``device="cpu"`` and a small ``batch``."""
    cell = resolve(workload, load_benchmark())
    ctx = Context(cell, seed % 2 ** 63, device, batch)
    if device != "cpu":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    session = driver(cell).Session(ctx)
    setup_s = time.perf_counter() - T_START
    e2e, attempted = session.window(seconds)
    peak = torch.cuda.max_memory_reserved() if device != "cpu" else 0
    e2e.update({"setup_s": setup_s, "peak_mem_gb": peak / 1e9})
    record = session.trace() if trace else None
    numbers = session.check()

    metrics, extra = {}, {}
    if trace:
        for m in cell.per_layer:
            value = reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = {"busy_s": record["busy_s"], "window_s": record["wall_s"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    checks = {}
    for name, limit in cell.limits.items():
        value = numbers[name]
        checks[name] = {"value": value, "limit": limit}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    out = {"correct": correct, "attempted": attempted, "failed": 0,
           "metrics": metrics,
           "device": {"platform": "gpu" if device != "cpu" else "cpu",
                      "kind": (torch.cuda.get_device_name(0)
                               if device != "cpu" else "cpu"),
                      "count": cell.chips if device != "cpu" else 0,
                      "memory_peak_bytes": peak, **extra}}
    if trace:
        out["breakdown"] = record["breakdown"]
    out["counts"] = {k: v for k, v in numbers.items() if k not in checks}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = resolve(args.workload, load_benchmark()).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()} "
              f"(available: {torch.cuda.is_available()})", file=sys.stderr)
        return 3
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = loaded_forbidden()
    if found:
        print(f"port_bench: the process holds {found}", file=sys.stderr)
        return 4
    out["card"] = card()
    out["checks"] = out.pop("checks")
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
