"""Mean ms a batch in which encode's worker thread waited: wall less its
thread's CPU time over the ``encode/tokenize`` and ``encode/forward``
spans (the interpreter lock, a core, the tokenizer's lock, a blocking
call)."""

from harness.spans import mean_per_batch


def read(ctx):
    def wait(spans):
        waits = [s.wait_ms for s in spans if s.name.startswith("encode/")]
        return sum(waits) if waits and None not in waits else None

    return mean_per_batch(ctx, wait)
