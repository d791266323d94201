"""Mean ms a batch in the engine's ``lexical`` stage (``StageTimings``, host clock)."""

from harness.readers import stage_mean_ms


def read(ctx):
    return stage_mean_ms(ctx, "lexical")
