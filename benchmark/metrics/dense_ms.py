"""Mean ms a batch in the engine's ``dense`` stage (``StageTimings``, host clock)."""

from harness.readers import stage_mean_ms


def read(ctx):
    return stage_mean_ms(ctx, "dense")
