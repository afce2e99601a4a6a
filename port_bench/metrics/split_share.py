"""The share of F1 and F2 launches that split K across a thread-block
cluster, in percent: the program's ``kernel.fwd_expand.split`` and
``kernel.fwd_taps.split`` counters over their ``.launches``, over the
run's eager and captured calls (a replay runs no Python).  Nothing on a
program that counts no split."""
from port_bench.metrics._spans import snapshot

KERNELS = ("fwd_expand", "fwd_taps")


def read(rec):
    counters = (snapshot() or {"counters": {}})["counters"]
    splits = [counters.get(f"kernel.{k}.split") for k in KERNELS]
    launches = sum(counters.get(f"kernel.{k}.launches", 0) for k in KERNELS)
    if all(n is None for n in splits) or not launches:
        return None
    return 100.0 * sum(n or 0 for n in splits) / launches
