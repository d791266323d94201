"""Share of the rerank's padded tokens that are real: over every bucket of
the window's batches, the prefix and suffix tokens counted by the
``rerank/pack`` spans over the padded ones (groups x (prefix bucket +
documents x suffix bucket))."""

from harness.spans import batch_spans


def read(ctx):
    real = padded = 0
    for spans in batch_spans(ctx, traced=True) or []:
        for s in spans:
            if s.name == "rerank/pack":
                c = s.counters
                real += c.get("prefix_tokens", 0) + c.get("suffix_tokens", 0)
                padded += c.get("prefix_tokens_padded", 0) + c.get("suffix_tokens_padded", 0)
    return 100.0 * real / padded if padded else None
