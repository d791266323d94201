"""Mean ms an index-build call of host work before and after the card:
the walls of its ``encode/tokenize`` and ``store/set_embeddings`` spans."""

from harness.spans import call_spans

HOST = ("encode/tokenize", "store/set_embeddings")


def read(ctx):
    calls = [sum(s.wall_ms for s in spans if s.name in HOST) for spans in call_spans(ctx) or []]
    return sum(calls) / len(calls) if calls else None
