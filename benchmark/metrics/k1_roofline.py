"""K1's share of its roofline: the least time its bytes take at the card's
published bandwidth (``harness.counts.k1_bound_s``), over its mean device
time a launch in the profiled stretch (one launch an engine batch)."""

from harness import counts


def read(ctx):
    traced = [b for b in ctx.all_batches if b.traced and b.dense_ids is not None]
    if ctx.trace is None or not traced:
        return None
    us = ctx.trace.kernel_us("ring_carry_kernel", "max_over_groups_kernel")
    if us <= 0:
        return None
    m, s = ctx.cfg["model"], ctx.cfg["serving"]
    n = ctx.cfg["deployment"]["declarations"]
    bound = sum(counts.k1_bound_s(n, m["hidden_size"], len(b.queries), s["dense_bins"]) for b in traced)
    return 100.0 * bound * 1e6 / us
