"""Share of the profiled stretch in which no operation ran on the card."""

from harness.readers import idle_percent


def read(ctx):
    return idle_percent(ctx)
