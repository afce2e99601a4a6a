"""The device's idle share of the profiled stretch, in percent."""


def read(rec):
    if not rec.get("wall_s") or "busy_s" not in rec:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["wall_s"])
