"""The device trace of a steady stretch: ``torch.profiler`` over whole
batches, reduced to device intervals, per-kernel time and idle gaps.

``union_us`` is a frozen copy of ``_union_us`` in
``scripts/profile_torch_serving.py`` at commit 4369825.
"""

import bisect
import time
from dataclasses import dataclass, field


def union_us(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if start > end:
            total += stop - start
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


def merged(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for start, stop in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], stop)
        else:
            out.append([start, stop])
    return [(a, b) for a, b in out]


@dataclass
class Trace:
    """Device and host events of one traced stretch, in microseconds on
    one clock, with the stretch's own bounds."""

    window_us: float
    begin_us: float
    end_us: float
    device: list[tuple[str, float, float]] = field(default_factory=list)
    host: list[tuple[str, float, float]] = field(default_factory=list)

    def busy_us(self) -> float:
        return union_us([(s, e) for _, s, e in self.device])

    def kernel_us(self, *names: str) -> float:
        return sum(e - s for n, s, e in self.device if any(k in n for k in names))

    def top_ops(self, n: int = 10) -> list[list]:
        by: dict[str, float] = {}
        for name, s, e in self.device:
            by[name] = by.get(name, 0.0) + (e - s)
        return [[k, v / 1e6] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """Idle time between device intervals, summed by what the host was
        in at each gap's middle: the innermost ``bench.*`` range and the
        latest-started other host operation still running."""
        busy = merged([(s, e) for _, s, e in self.device])
        edges = [self.begin_us] + [x for iv in busy for x in iv] + [self.end_us]
        spans = sorted((s, e, n_) for n_, s, e in self.host if n_.startswith("bench."))
        ops = sorted((s, e, n_) for n_, s, e in self.host if not n_.startswith("bench."))
        span_starts = [s for s, _, _ in spans]
        op_starts = [s for s, _, _ in ops]
        by: dict[str, float] = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b - a <= 0:
                continue
            mid = (a + b) / 2
            key = f"{_covering(spans, span_starts, mid, 'outside a batch')} / " \
                  f"{_covering(ops, op_starts, mid, 'python')}"
            by[key] = by.get(key, 0.0) + (b - a)
        return [[k, v / 1e6] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _covering(events, starts, t: float, default: str, look: int = 64) -> str:
    """The latest-started event of ``events`` (sorted by start) that is
    still running at ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - look, -1), -1):
        if events[j][1] >= t:
            return events[j][2]
    return default


class Profiler:
    """Starts ``torch.profiler`` on request and reads it when stopped."""

    def __init__(self):
        self.prof = None
        self.trace: Trace | None = None
        self._t0 = 0.0

    @staticmethod
    def _make():
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        try:  # host events of every thread: the engine's stages run in workers
            from torch._C._profiler import _ExperimentalConfig

            return profile(activities=acts, experimental_config=_ExperimentalConfig(profile_all_threads=True))
        except TypeError:
            return profile(activities=acts)

    def prime(self) -> None:
        """Start and stop once during set-up: the first start initialises
        the device tracer, which takes seconds."""
        import torch

        with self._make():
            if torch.cuda.is_available():
                torch.ones(1, device="cuda").add_(1)
                torch.cuda.synchronize()

    def start(self) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof = self._make()
        self.prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window_us = (time.perf_counter() - self._t0) * 1e6
        self.prof.stop()
        self.trace = read_events(self.prof, window_us)
        self.prof = None


def read_events(prof, window_us: float) -> Trace:
    """Device and host events from the profiler's raw results."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        stop = start + e.duration_ns() / 1e3
        name = e.name()
        if e.device_type() == cuda:
            if not name.startswith("bench."):  # the ranges' copies on the device's timeline
                device.append((name, start, stop))
        else:
            host.append((name, start, stop))
    if not device and not host:
        return Trace(window_us, 0.0, window_us)
    everything = device + host
    begin = min(s for _, s, _ in everything)
    # The stretch's bounds on the trace's clock: it began when the profiler
    # did and lasted window_us.
    return Trace(window_us, begin, begin + window_us, device, host)
