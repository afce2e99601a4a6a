"""A roofline share of the encoder's dense blocks: the sum of their
bounds over the sum of their device busy times per call, in percent."""


def share(rec, train: bool):
    blocks = rec.get("blocks")
    if not blocks or rec.get("blocks_train") != train:
        return None
    busy = sum(b["busy_s_per_call"] for b in blocks)
    if busy <= 0:
        return None
    return 100.0 * sum(b["bound_s"] for b in blocks) / busy
