"""Model FLOPs the profiled batches needed (``harness.readers.batch_flops``)
over the stretch's length and the card's published bf16 peak."""

from harness import counts
from harness.readers import batch_flops
from reference import text


def read(ctx):
    traced = [b for b in ctx.all_batches if b.traced]
    if ctx.trace is None or not traced:
        return None
    tok = text.Tokenizer(ctx.vocab)
    flops = sum(batch_flops(b, ctx.cfg, ctx.traffic, tok) for b in traced)
    return 100.0 * flops / (ctx.trace.window_us / 1e6) / counts.BF16_FLOP_PER_S
