"""Per-stage timing and optional device traces
(lean_explore_tpu/util/profiling.py).

Every batch carries a stage breakdown (encode / lexical / dense / fuse /
rerank). A stage that ends in a device result the host reads includes the
device time, because reading the result waits for it. ``device_trace``
captures a ``torch.profiler`` trace of any region.
"""

import contextlib
import logging
import os
import time
from dataclasses import dataclass, field
from pathlib import Path

logger = logging.getLogger(__name__)


@dataclass
class StageTimings:
    """Millisecond wall-clock per named stage."""

    stages: dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed_ms = (time.perf_counter() - start) * 1000.0
            self.stages[name] = self.stages.get(name, 0.0) + elapsed_ms

    def total_ms(self) -> float:
        return sum(self.stages.values())

    def as_dict(self) -> dict[str, float]:
        return dict(self.stages)


@contextlib.contextmanager
def device_trace(log_dir: str | Path | None):
    """Capture a ``torch.profiler`` trace (CPU and, with a card, CUDA
    activities) into ``log_dir`` as a Chrome trace when it is set; a no-op
    otherwise. View it in chrome://tracing or Perfetto. Usage:

        with device_trace("/tmp/trace"):
            asyncio.run(engine.search_batch(...))
    """
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()  # the region's kernels end inside the trace
    path = out / f"{os.getpid()}.{time.time_ns()}.pt.trace.json"
    prof.export_chrome_trace(str(path))
    logger.info("Device trace written to %s", path)
