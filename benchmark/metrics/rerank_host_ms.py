"""Mean ms a batch of the rerank's host steps: the walls of its
``rerank/tokenize`` (pair text, tokens, shared prefixes), ``rerank/pack``
(the padded bucket arrays) and ``rerank/select`` (the cascade's sort
between its stages) spans."""

from harness.spans import mean_per_batch

HOST = ("rerank/tokenize", "rerank/pack", "rerank/select")


def read(ctx):
    def host(spans):
        walls = [s.wall_ms for s in spans if s.name in HOST]
        return sum(walls) if walls else None

    return mean_per_batch(ctx, host)
