"""Mean ms a batch of the card's time over the rerank's launches: the CUDA
events of its ``rerank/device`` spans, from just before the first scorer
launch to the end of the last."""

from harness.spans import mean_per_batch


def read(ctx):
    def device(spans):
        times = [s.device_ms for s in spans if s.name == "rerank/device"]
        return sum(times) if times and None not in times else None

    return mean_per_batch(ctx, device)
