"""Calls that have to run on the main thread (the profiler's start and
stop), asked for from the batcher's thread and run where the main thread
waits."""

import queue
import threading
import time


class MainThread:
    def __init__(self):
        self.ident = threading.get_ident()
        self.q: queue.Queue = queue.Queue()

    def call(self, fn):
        """Run ``fn`` on the main thread and return its result."""
        if threading.get_ident() == self.ident:
            return fn()
        done, box = threading.Event(), {}
        self.q.put((fn, done, box))
        done.wait()
        if "error" in box:
            raise box["error"]
        return box.get("result")

    def pump(self, until: float) -> None:
        """Run queued calls until ``until`` (perf_counter seconds)."""
        while True:
            left = until - time.perf_counter()
            if left <= 0:
                return
            try:
                fn, done, box = self.q.get(timeout=left)
            except queue.Empty:
                return
            try:
                box["result"] = fn()
            except BaseException as error:  # noqa: BLE001 - handed back to the caller
                box["error"] = error
            finally:
                done.set()

    def wait(self, event: threading.Event, timeout: float) -> bool:
        deadline = time.perf_counter() + timeout
        while not event.is_set() and time.perf_counter() < deadline:
            self.pump(min(time.perf_counter() + 0.02, deadline))
        return event.is_set()
