"""Host milliseconds to enqueue one call (``Predictor.predict`` on a host
tensor, no sync), the median over the traced calls."""
import statistics


def read(rec):
    enq = rec.get("enqueue_ms")
    return statistics.median(enq) if enq else None
