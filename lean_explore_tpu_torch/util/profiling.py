"""Spans, counters, per-stage timing and device traces
(lean_explore_tpu/util/profiling.py, grown).

``span(name)`` marks one step of the program, in any thread: its name, its
parent and root spans, its start and end on ``time.perf_counter_ns()``,
the CPU time of its thread over it (when it starts and ends on one
thread), the counters added inside it (``count``) and, with ``device`` on
CUDA, a pair of CUDA events around the work it launched. Parentage follows
a ``ContextVar``, so a span opened in ``asyncio.to_thread`` or in a task of
``asyncio.gather`` finds the span that was open where the work was handed
off. Finished spans go to one bounded ring per process, read with
``recent_spans()``; the device events are resolved there, never while the
work runs. While a ``torch.profiler`` is recording, each span is also a host
range named ``lx.<name>`` on the profiler's clock, beside the kernels.

Every batch also carries a stage breakdown (encode / lexical / dense /
fuse / rerank, ``StageTimings``), each stage a span. A stage that ends in a
device result the host reads includes the device time, because reading the
result waits for it. ``device_trace`` captures a ``torch.profiler`` trace
of any region.
"""

import collections
import contextlib
import contextvars
import itertools
import logging
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

logger = logging.getLogger(__name__)

RING_SIZE = 100_000

_ring: collections.deque = collections.deque(maxlen=RING_SIZE)
_ids = itertools.count(1)
_current: contextvars.ContextVar = contextvars.ContextVar("lean_explore_span", default=None)
_count_lock = threading.Lock()


@dataclass(frozen=True)
class SpanRecord:
    """A finished span as ``recent_spans`` returns it. ``thread`` is the
    ident of the thread it began on; ``cpu_ns`` is None when it ended on
    another thread, ``device_ms`` when it recorded no device events."""

    name: str
    id: int
    parent: int | None
    root: int
    thread: int
    start_ns: int
    end_ns: int
    cpu_ns: int | None
    device_ms: float | None
    counters: dict

    @property
    def wall_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def wait_ms(self) -> float | None:
        """Wall time in which the span's thread did not run: waiting for the
        interpreter lock, a core, a lock or a blocking call."""
        return None if self.cpu_ns is None else self.wall_ms - self.cpu_ns / 1e6


def _mirror_range(name: str):
    """An ``lx.<name>`` host range while a profiler records, else None. A
    function-scope range: a user-scope one (``record_function``) gets a
    copy on the device's timeline, which would count as device work.
    Without torch loaded no profiler can record."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd.profiler._is_profiler_enabled:
        return None
    rng = torch._C._profiler._RecordFunctionFast("lx." + name)
    rng.__enter__()
    return rng


def _cuda_stream(device):
    """The current stream of ``device`` when it is a CUDA device, else None."""
    if device is None:
        return None
    import torch

    device = torch.device(device)
    return torch.cuda.current_stream(device) if device.type == "cuda" else None


class Span:
    """One open span; ``span(...)`` makes it, ``with`` opens and closes it."""

    __slots__ = ("name", "id", "parent", "root", "start_ns", "end_ns", "cpu_ns",
                 "counters", "_device", "_stream", "_events", "_range", "_thread", "_token")

    def __init__(self, name: str, device=None):
        self.name = name
        self.counters: dict | None = None
        self._device = device
        self._events = None

    def __enter__(self) -> "Span":
        parent = _current.get()
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.root = parent.root if parent is not None else self.id
        self._token = _current.set(self)
        self._range = _mirror_range(self.name)
        self._stream = _cuda_stream(self._device)
        if self._stream is not None:
            import torch

            self._events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self._events[0].record(self._stream)
        self._thread = threading.get_ident()
        # The CPU clock is read inside the wall clock's readings.
        self.start_ns = time.perf_counter_ns()
        self.cpu_ns = time.thread_time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        cpu = time.thread_time_ns()
        self.end_ns = time.perf_counter_ns()
        self.cpu_ns = cpu - self.cpu_ns if threading.get_ident() == self._thread else None
        if self._events is not None:
            self._events[1].record(self._stream)
        if self._range is not None:
            self._range.__exit__(None, None, None)
        _current.reset(self._token)
        _ring.append(self)
        return False

    def record(self) -> SpanRecord:
        device_ms = None
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            device_ms = start.elapsed_time(end)
        return SpanRecord(self.name, self.id, self.parent, self.root, self._thread, self.start_ns,
                          self.end_ns, self.cpu_ns, device_ms, dict(self.counters or {}))


def span(name: str, *, device=None) -> Span:
    """A span named ``name`` (``with span(...) as s:``; ``s.id``, ``s.root``).
    ``device``, the work's device, also records CUDA events on its current
    stream at entry and exit when it is a CUDA device: the device time
    between them is the span's ``device_ms``."""
    return Span(name, device)


def count(key: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``key`` of the innermost open span (threads
    that share a span add under a lock)."""
    current = _current.get()
    if current is None:
        return
    with _count_lock:
        if current.counters is None:
            current.counters = {}
        current.counters[key] = current.counters.get(key, 0) + n


def recent_spans() -> list[SpanRecord]:
    """The finished spans still in the ring, oldest first, as resolved
    copies: reading a device span waits for its end event."""
    return [s.record() for s in tuple(_ring)]


@dataclass
class StageTimings:
    """Millisecond wall-clock per named stage; each stage is a span."""

    stages: dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        s = Span(name).__enter__()
        try:
            yield
        finally:
            s.__exit__()
            elapsed_ms = (s.end_ns - s.start_ns) / 1e6
            self.stages[name] = self.stages.get(name, 0.0) + elapsed_ms

    def total_ms(self) -> float:
        return sum(self.stages.values())

    def as_dict(self) -> dict[str, float]:
        return dict(self.stages)


@contextlib.contextmanager
def device_trace(log_dir: str | Path | None):
    """Capture a ``torch.profiler`` trace (CPU and, with a card, CUDA
    activities) into ``log_dir`` as a Chrome trace when it is set; a no-op
    otherwise. View it in chrome://tracing or Perfetto; the program's spans
    appear as ``lx.<name>`` ranges. Usage:

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
