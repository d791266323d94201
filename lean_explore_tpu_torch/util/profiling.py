"""Per-stage wall-clock timing (lean_explore_tpu/util/profiling.py).

Every batch carries a stage breakdown (encode / lexical / dense / fuse /
rerank). A stage that ends in a device result the host reads includes the
device time, because reading the result waits for it.
"""

import contextlib
import time
from dataclasses import dataclass, field


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
