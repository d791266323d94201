"""Mean ms a batch in the engine's ``fuse`` stage (``StageTimings``, host clock)."""

from harness.readers import stage_mean_ms


def read(ctx):
    return stage_mean_ms(ctx, "fuse")
