"""Device busy milliseconds per call or step: the union of the device's
intervals in the profiled stretch, over its calls."""


def read(rec):
    if not rec.get("calls") or not rec.get("busy_s"):
        return None
    return 1e3 * rec["busy_s"] / rec["calls"]
