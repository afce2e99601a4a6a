"""Model FLOPs utilization of the profiled stretch, in percent: the
forward's FLOPs per image (3x for a train step; recomputation not
counted) times the images per second, over the peak of the compute
dtype."""
from port_bench.lib.peaks import PEAK_FLOPS


def read(rec):
    if not rec.get("wall_s") or not rec.get("flops_per_image"):
        return None
    factor = 3 if rec.get("mode") == "train" else 1
    rate = rec["images"] / rec["wall_s"]
    return 100.0 * factor * rec["flops_per_image"] * rate / PEAK_FLOPS[
        rec["dtype"]]
