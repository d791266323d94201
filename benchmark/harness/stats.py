"""The arithmetic of the end-to-end metrics."""


def whole_batch_rate(batches, start: float, close: float) -> tuple[float, float, int]:
    """Queries per second over the batches that began in [start, close),
    counted until the last of them ended: (rate, window end, queries)."""
    inside = [b for b in batches if start <= b.start < close]
    if not inside:
        return 0.0, start, 0
    end = max(b.end for b in inside)
    n = sum(len(b.queries) for b in inside)
    return n / (end - start), end, n
