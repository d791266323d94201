"""The general load generators: each reads its parameters from a traffic
file and drives the system for one window.

- ``closed``: ``clients`` callers, each sending its next query through
  ``SearchBatcher.submit_search`` when its last one is answered.
- ``index_embed``: the extraction's embedding loop, ``embed_sync`` on
  ``batch_size`` pending informalizations, then ``set_embeddings``.
"""

import threading
import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Request:
    text: str
    done: float | None = None
    ok: bool = False
    future: object = None


@dataclass
class Window:
    start: float
    close: float
    end: float = 0.0  # when the last batch that began before ``close`` ended
    requests: list[Request] = field(default_factory=list)
    calls: list[tuple[float, float, int]] = field(default_factory=list)  # index build


def _submit(batcher, req: Request, traffic, on_done):
    fut = batcher.submit_search(req.text, traffic["limit"], traffic["rerank_top"], None, True)
    req.future = fut

    def done(f):
        if f.cancelled():
            return  # dropped unsent at the window's end
        req.done = time.perf_counter()
        req.ok = f.exception() is None
        on_done(req)

    fut.add_done_callback(done)


def run_closed(batcher, queries: list[str], traffic: dict, seconds: float, main, started,
               grace_s: float = 60.0) -> Window:
    """``started()`` counts the requests of every engine batch begun so far."""
    lock = threading.Lock()
    finished = threading.Event()
    state = {"next": 0, "outstanding": 0}
    win = Window(start=time.perf_counter(), close=0.0)
    win.close = win.start + seconds

    def send():
        with lock:
            text = queries[state["next"] % len(queries)]
            state["next"] += 1
            state["outstanding"] += 1
            req = Request(text)
            win.requests.append(req)
        _submit(batcher, req, traffic, on_done)

    def on_done(req):
        with lock:
            state["outstanding"] -= 1
            closing = req.done >= win.close and not state.get("closing")
            if closing:
                state["closing"] = True
        if req.done < win.close:
            send()
        elif closing:
            # The last batch that began in the window is answering (this
            # runs on the batcher's thread before its next batch). The
            # requests still queued are dropped unsent, in arrival order
            # after those of every batch begun so far; the batcher skips
            # cancelled requests, so no batch runs after the window.
            with lock:
                queued = win.requests[started():]
            for r in queued:
                if r.future is not None:
                    r.future.cancel()
            finished.set()

    async def fill():
        # Every client's first request is queued from the batcher's own
        # loop in one step, so the first batch drains a full queue as every
        # later one does.
        for _ in range(traffic["clients"]):
            send()

    win.start = time.perf_counter()
    win.close = win.start + seconds
    batcher.submit_coroutine(fill()).result()
    main.wait(finished, seconds + grace_s)
    return win


def run_index_embed(store, todo, client, traffic: dict, seconds: float, on_call=None) -> Window:
    """The loop of ``extract.embeddings.generate_embeddings`` over the
    pending rows, until a call would begin after the window closes."""
    from torch.profiler import record_function

    step = traffic["batch_size"]
    win = Window(start=time.perf_counter(), close=0.0)
    win.close = win.start + seconds
    index = 0
    while index < len(todo):
        t0 = time.perf_counter()
        if t0 >= win.close:
            break
        if on_call:
            on_call("start", len(win.calls))
            t0 = time.perf_counter()
        batch = todo[index:index + step]
        with record_function("bench.embed_sync"):
            vectors = client.embed_sync([d.informalization for d in batch])
        with record_function("bench.set_embeddings"):
            store.set_embeddings((d.id, np.asarray(v)) for d, v in zip(batch, vectors))
        t1 = time.perf_counter()
        win.calls.append((t0, t1, len(batch)))
        if on_call:
            on_call("end", len(win.calls) - 1, vectors=vectors, batch=batch)
        index += step
    win.end = win.calls[-1][1] if win.calls else win.start
    return win
