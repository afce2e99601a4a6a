"""Readings that the limits of ``limits/<cell>.json`` are set from.

    python3 port_bench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--plant control|altered|half_batch|half_replayed|stale_bn|unchanged] \
        [--seconds 1]

Each seed is one run of the cell through ``run.run_cell``, in this
process, with the plant (``lib/plants.py``) in the program's place, or
with none: the numbers its check compares, each beside its limit, and
whether it came out correct.  Prints one JSON line per seed.  Needs the
card, as the runs do.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from port_bench.lib.plants import PLANTS, planted  # noqa: E402
from port_bench.run import run_cell  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--plant", choices=sorted(PLANTS))
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_bench: calibrate needs a CUDA card", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        with planted(args.plant) if args.plant else contextlib.nullcontext():
            out = run_cell(args.workload, seed, args.seconds, False)
        print(json.dumps({"workload": args.workload, "plant": args.plant,
                          "seed": seed, "correct": out["correct"],
                          "checks": out["checks"], "counts": out["counts"],
                          "reserved_gb": torch.cuda.memory_reserved() / 1e9}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
