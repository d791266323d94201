"""Ms a profiled batch in which the card was idle while the host was inside
one of the rerank's ``lx.rerank/*`` ranges (its tokenisation, packing,
launches, the cascade's stages and sort), on the profiler's clock."""

from harness.spans import idle_under_us


def read(ctx):
    idle = idle_under_us(ctx.trace, "lx.rerank/")
    if idle is None:
        return None
    traced = sum(1 for b in ctx.all_batches if b.traced) or 1
    return idle / 1000.0 / traced
