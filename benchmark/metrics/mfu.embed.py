"""Model FLOPs of the profiled index-build calls, on their documents' real
tokens, over the stretch's length and the card's published bf16 peak."""

from harness import counts
from reference import text


def read(ctx):
    if ctx.trace is None:
        return None
    s, m = ctx.cfg["serving"], ctx.cfg["model"]
    tok = text.Tokenizer(ctx.vocab)
    docs = [d.informalization for i in ctx.traced_calls if i in ctx.captured
            for d in ctx.captured[i][0]]
    if not docs:
        return None
    flops = sum(counts.sequence_flops(m, len(r)) for r in text.document_rows(tok, docs, s["embed_max_length"]))
    return 100.0 * flops / (ctx.trace.window_us / 1e6) / counts.BF16_FLOP_PER_S
