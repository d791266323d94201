"""The program's own spans (``lean_explore_tpu_torch.util.profiling``)
matched to what the benchmark timed: each engine batch's spans, each
index-build call's, and the ``lx.*`` host ranges of the profiled stretch.
A program without spans gives None, and so does every reader built on
these."""

import bisect

from harness.trace import merged


def program_spans(ctx):
    """Every finished span of the program's ring, read once a run."""
    if not hasattr(ctx, "program_spans"):
        try:
            from lean_explore_tpu_torch.util.profiling import recent_spans
        except ImportError:
            ctx.program_spans = None
        else:
            ctx.program_spans = recent_spans()
    return ctx.program_spans


def batch_spans(ctx, traced: bool = False):
    """For each of the window's engine batches (outside the profiled
    stretch unless ``traced``), the spans of the outermost ``search_batch``
    span that began inside it: the spans under the same root that began
    while it ran. None where no batch has such a span."""
    spans = program_spans(ctx)
    if not spans:
        return None
    by_root: dict[int, list] = {}
    for s in spans:
        by_root.setdefault(s.root, []).append(s)
    roots = sorted((s for s in spans if s.name == "search_batch"), key=lambda s: s.start_ns)
    out = []
    for b in ctx.batches:
        if b.traced and not traced:
            continue
        lo, hi = b.start * 1e9, b.end * 1e9
        inside = [s for s in roots if lo <= s.start_ns <= hi]
        if inside:
            top = inside[0]
            out.append([s for s in by_root[top.root] if top.start_ns <= s.start_ns <= top.end_ns])
    return out or None


def mean_per_batch(ctx, value):
    """The mean of ``value(spans)`` over the batches of ``batch_spans``
    for which it is not None."""
    values = [v for v in (value(b) for b in batch_spans(ctx) or []) if v is not None]
    return sum(values) / len(values) if values else None


def call_spans(ctx):
    """For each index-build call outside the profiled stretch, the spans
    that began inside it. None where no call has any."""
    spans = program_spans(ctx)
    if not spans:
        return None
    traced = set(getattr(ctx, "traced_calls", ()))
    spans = sorted(spans, key=lambda s: s.start_ns)
    starts = [s.start_ns for s in spans]
    out = []
    for i, (t0, t1, _) in enumerate(ctx.calls):
        if i in traced:
            continue
        inside = spans[bisect.bisect_left(starts, t0 * 1e9):bisect.bisect_right(starts, t1 * 1e9)]
        if inside:
            out.append(inside)
    return out or None


def idle_under_us(trace, prefix: str) -> float | None:
    """Device idle time of the profiled stretch, in microseconds, while a
    host range whose name starts with ``prefix`` ran; None without device
    events or without such a range."""
    if trace is None or not trace.device:
        return None
    ranges = merged([(s, e) for n, s, e in trace.host if n.startswith(prefix)])
    if not ranges:
        return None
    busy = merged([(s, e) for n, s, e in trace.device if not n.startswith("lx.")])
    edges = [trace.begin_us] + [x for iv in busy for x in iv] + [trace.end_us]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    total, j = 0.0, 0
    for a, b in idle:
        while j < len(ranges) and ranges[j][1] <= a:
            j += 1
        k = j
        while k < len(ranges) and ranges[k][0] < b:
            total += min(b, ranges[k][1]) - max(a, ranges[k][0])
            k += 1
    return total
