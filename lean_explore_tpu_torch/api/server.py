"""Self-hosted HTTP server for the ``/api/v2`` search contract, on the
port's ``Service`` (lean_explore_tpu/api/server.py).

The openapi.yaml contract (``GET /search``, ``GET /declarations/{id}``,
Bearer auth) over a local index, so ``ApiClient``, the CLI's ``search``
and ``mcp serve --backend api`` can run against a self-hosted deployment:

    python -m lean_explore_tpu_torch.api.server --data-dir /path/to/artifacts \
        --port 8080 --api-key secret --warmup --warmup-batch 128

Request coalescing: the serving stack is batch-first (one embedding
forward, one dense retrieval kernel and one grouped reranker forward per
``Service.search_batch``), so concurrent requests are queued and drained
into engine batches. The batcher waits ``--coalesce-ms`` after the first
pending request (or until ``--max-batch``, default
``Config.SERVE_QUERY_BATCH``), groups the requests that share
``(rerank_top, packages)``, runs one ``search_batch`` a group at the
group's largest limit and slices each answer to its own. Every engine
call runs on the batcher's own event-loop thread (and the engine's
worker threads), never on an HTTP handler thread.

Contract:
    GET {base}/search?q=...&limit=20[&packages=A,B][&rerank_top=N]
        -> SearchResponse JSON (results: full SearchResult rows)
    GET {base}/declarations/{id}   -> SearchResult JSON | 404
    GET /healthz                   -> {"status": "ok", ...}   (no auth)

``{base}`` defaults to ``/api/v2``; run ``ApiClient(base_url=
"http://host:port/api/v2", api_key=...)`` against it. ``main`` serves on
CUDA unless the environment asks for the CPU
(``util.platform.requested_device``).
"""

import argparse
import asyncio
import collections
import concurrent.futures
import itertools
import json
import logging
import math
import sys
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

from lean_explore_tpu_torch.config import Config
from lean_explore_tpu_torch.util.profiling import span

logger = logging.getLogger(__name__)

MAX_LIMIT = 100
# Cap the cross-encoder pool: an unbounded rerank_top would let one request
# demand ~40x the default device work (and a new padded batch shape),
# stalling every queued request behind the single batcher loop.
MAX_RERANK_TOP = 100
MAX_QUERY_CHARS = 2000
REQUEST_TIMEOUT_S = 300.0
# Idle keep-alive connections are dropped after this long so they don't pin
# handler threads forever (HTTP/1.1 keep-alive otherwise blocks in readline).
IDLE_CONNECTION_TIMEOUT_S = 60.0
# Service.search's default: an absent
# rerank_top param means "server-side rerank of the top 50", NOT "no rerank"
# (which is what rerank_top=None means engine-side).
DEFAULT_RERANK_TOP = 50

_SHUTDOWN = object()


@dataclass
class _PendingSearch:
    """One queued /search request awaiting a device batch."""

    query: str
    limit: int
    rerank_top: int | None
    packages: tuple[str, ...] | None
    # False when rerank_top is the server-side default rather than a client
    # ask — such requests may degrade to no-rerank if the checkpoint is
    # absent (lexical/dense-only deployments) instead of erroring.
    rerank_explicit: bool = False
    future: concurrent.futures.Future = field(
        default_factory=concurrent.futures.Future
    )
    request_id: int = 0
    submitted_ns: int = field(default_factory=time.perf_counter_ns)

    @property
    def group_key(self) -> tuple:
        # Only the arguments that change the ENGINE's work split a device
        # batch. limit is host-side truncation (sliced per request after
        # the batch), and rerank_explicit only selects the degradation
        # policy on FileNotFoundError — neither forfeits coalescing.
        return (self.rerank_top, self.packages)


class SearchBatcher:
    """Coalesces concurrent search requests into ``search_batch`` calls.

    Owns a private asyncio loop on a daemon thread; HTTP handler threads
    submit work and block on ``concurrent.futures.Future`` results. All
    Service/engine coroutines run on this single loop, which also
    serializes device access (one pipeline at a time on one card, as
    util/embedding_server.py's lock).
    """

    def __init__(
        self,
        service,
        coalesce_ms: float = 5.0,
        max_batch: int | None = None,
    ):
        self.service = service
        self.coalesce_s = max(coalesce_ms, 0.0) / 1000.0
        self.max_batch = max_batch or Config.SERVE_QUERY_BATCH
        # Latched on the first FileNotFoundError from the rerank stage so
        # model-free deployments don't re-run the full retrieval pipeline
        # twice per batch forever.
        self._rerank_unavailable = False
        self.batches_run = 0
        self.requests_served = 0
        self.engine_seconds = 0.0  # time inside search_batch (device pipelines)
        self.batch_sizes: list[int] = []  # last 1000 drain group sizes
        # Last 1000 requests' (request id, root span id of their engine
        # batch, ms from submit_search to the start of that batch).
        self.queue_waits: collections.deque = collections.deque(maxlen=1000)
        self._request_ids = itertools.count(1)
        self._queue: asyncio.Queue | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._ready = threading.Event()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run_loop, name="search-batcher", daemon=True
        )
        self._thread.start()
        self._ready.wait()

    def stop(self) -> None:
        if self._loop is None:
            return
        self._loop.call_soon_threadsafe(self._queue.put_nowait, _SHUTDOWN)
        self._thread.join(timeout=10)

    def _run_loop(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        self._queue = asyncio.Queue()
        self._ready.set()
        loop.run_until_complete(self._batcher())
        loop.close()

    # ------------------------------------------------------------ submission
    def submit_search(
        self,
        query: str,
        limit: int,
        rerank_top: int | None,
        packages: tuple[str, ...] | None,
        rerank_explicit: bool = False,
    ) -> concurrent.futures.Future:
        pending = _PendingSearch(
            query, limit, rerank_top, packages, rerank_explicit,
            request_id=next(self._request_ids),
        )
        self._loop.call_soon_threadsafe(self._queue.put_nowait, pending)
        return pending.future

    def submit_coroutine(self, coro) -> concurrent.futures.Future:
        """Run an arbitrary Service coroutine on the batcher loop."""
        return asyncio.run_coroutine_threadsafe(coro, self._loop)

    def queue_wait_ms(self, percentile: float) -> float | None:
        """A percentile (nearest rank) of the queue waits in the window, or
        None before the first request is served."""
        waits = sorted(wait for _, _, wait in tuple(self.queue_waits))
        if not waits:
            return None
        return waits[max(math.ceil(percentile / 100.0 * len(waits)) - 1, 0)]

    # ------------------------------------------------------------ batch loop
    async def _batcher(self) -> None:
        while True:
            first = await self._queue.get()
            if first is _SHUTDOWN:
                return
            batch = [first]
            deadline = self._loop.time() + self.coalesce_s
            while len(batch) < self.max_batch:
                timeout = deadline - self._loop.time()
                if timeout <= 0:
                    break
                try:
                    item = await asyncio.wait_for(self._queue.get(), timeout)
                except asyncio.TimeoutError:
                    break
                if item is _SHUTDOWN:
                    for pending in batch:
                        pending.future.cancel()
                    return
                batch.append(item)

            groups: dict[tuple, list[_PendingSearch]] = {}
            for pending in batch:
                if pending.future.cancelled():
                    continue  # client gave up (timeout); don't bill the device
                groups.setdefault(pending.group_key, []).append(pending)
            for (rerank_top, packages), group in groups.items():
                await self._run_group(rerank_top, packages, group)

    async def _run_group(
        self,
        rerank_top: int | None,
        packages: tuple[str, ...] | None,
        group: list[_PendingSearch],
    ) -> None:
        """One engine batch for ``group`` in a ``batcher/group`` span, the
        root of the batch's spans; each request's wait is kept in
        ``queue_waits`` under that root."""
        with span("batcher/group") as batch_span:
            started_ns = time.perf_counter_ns()
            for pending in group:
                wait_ms = (started_ns - pending.submitted_ns) / 1e6
                self.queue_waits.append((pending.request_id, batch_span.root, wait_ms))
            # Default-rerank requests degrade to no-rerank on model-free
            # (lexical/dense-only) deployments; EXPLICIT rerank_top asks still
            # error honestly. Once latched, skip the doomed first attempt.
            if self._rerank_unavailable and rerank_top:
                non_explicit = [p for p in group if not p.rerank_explicit]
                for pending in group:
                    if pending.rerank_explicit and not pending.future.done():
                        pending.future.set_exception(
                            FileNotFoundError("reranker checkpoint unavailable")
                        )
                if not non_explicit:
                    return
                group, rerank_top = non_explicit, 0
            queries = [p.query for p in group]
            # One engine call serves every limit in the group: limit is
            # host-side result truncation, so run at the group max and slice
            # per request below.
            max_limit = max(p.limit for p in group)
            kwargs = dict(
                limit=max_limit,
                rerank_top=rerank_top,
                packages=list(packages) if packages else None,
            )
            t_start = self._loop.time()
            try:
                try:
                    responses = await self.service.search_batch(queries, **kwargs)
                except FileNotFoundError as error:
                    if not rerank_top:
                        raise
                    logger.warning(
                        "rerank unavailable (%s); serving default requests "
                        "without rerank from now on",
                        error,
                    )
                    self._rerank_unavailable = True
                    for pending in group:
                        if pending.rerank_explicit and not pending.future.done():
                            pending.future.set_exception(error)
                    group = [p for p in group if not p.rerank_explicit]
                    if not group:
                        return
                    queries = [p.query for p in group]
                    responses = await self.service.search_batch(
                        queries, **{**kwargs, "rerank_top": 0}
                    )
                self.batches_run += 1
                self.requests_served += len(group)
                self.engine_seconds += self._loop.time() - t_start
                self.batch_sizes.append(len(group))
                del self.batch_sizes[:-1000]
                for pending, response in zip(group, responses):
                    if pending.future.done():
                        continue  # cancelled while the batch ran
                    if pending.limit < len(response.results):
                        response = response.model_copy(
                            update={
                                "results": response.results[: pending.limit],
                                "count": pending.limit,
                            }
                        )
                    pending.future.set_result(response)
            except Exception as error:  # noqa: BLE001 — server boundary
                logger.exception("search batch failed")
                for pending in group:
                    if not pending.future.done():
                        pending.future.set_exception(error)


# ------------------------------------------------------------------ handler
def make_handler(batcher: SearchBatcher, api_key: str | None, base_path: str):
    base = base_path.rstrip("/")

    class SearchAPIHandler(BaseHTTPRequestHandler):
        # HTTP/1.1 keep-alive: every response carries Content-Length, so
        # persistent connections are safe and clients skip per-request TCP
        # setup (the default HTTP/1.0 closes after each response). The
        # socket timeout bounds idle connections so they don't pin handler
        # threads forever.
        protocol_version = "HTTP/1.1"
        timeout = IDLE_CONNECTION_TIMEOUT_S

        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _authorized(self) -> bool:
            if not api_key:
                return True
            import hmac

            return hmac.compare_digest(
                self.headers.get("Authorization") or "", f"Bearer {api_key}"
            )

        def do_GET(self):  # noqa: N802 — http.server API
            split = urlsplit(self.path)
            path = split.path
            if path == "/healthz":
                self._send(
                    200,
                    {
                        "status": "ok",
                        "batches_run": batcher.batches_run,
                        "requests_served": batcher.requests_served,
                        "engine_seconds": round(batcher.engine_seconds, 3),
                        "mean_batch": round(
                            batcher.requests_served
                            / max(batcher.batches_run, 1),
                            1,
                        ),
                        "queue_wait_ms_p50": batcher.queue_wait_ms(50),
                        "queue_wait_ms_p95": batcher.queue_wait_ms(95),
                    },
                )
                return
            if not path.startswith(base + "/"):
                self._send(404, {"error": "not found"})
                return
            if not self._authorized():
                self._send(401, {"error": "missing or invalid API key"})
                return
            route = path[len(base):]
            if route == "/search":
                self._handle_search(parse_qs(split.query))
            elif route.startswith("/declarations/"):
                self._handle_get_by_id(route[len("/declarations/"):])
            else:
                self._send(404, {"error": "not found"})

        def _handle_search(self, params: dict) -> None:
            query = (params.get("q") or [""])[0]
            if not query:
                self._send(400, {"error": "missing required parameter: q"})
                return
            if len(query) > MAX_QUERY_CHARS:
                self._send(400, {"error": "query too long"})
                return
            try:
                limit = int((params.get("limit") or ["20"])[0])
                rerank_raw = (params.get("rerank_top") or [None])[0]
                rerank_top = (
                    DEFAULT_RERANK_TOP if rerank_raw is None else int(rerank_raw)
                )
            except ValueError:
                self._send(400, {"error": "limit/rerank_top must be integers"})
                return
            limit = max(1, min(limit, MAX_LIMIT))
            rerank_top = min(rerank_top, MAX_RERANK_TOP)
            packages_raw = (params.get("packages") or [""])[0]
            packages = (
                tuple(p.strip() for p in packages_raw.split(",") if p.strip())
                or None
            )
            future = batcher.submit_search(
                query,
                limit,
                rerank_top,
                packages,
                rerank_explicit=rerank_raw is not None,
            )
            try:
                response = future.result(timeout=REQUEST_TIMEOUT_S)
            except concurrent.futures.TimeoutError:
                # Cancel so the batcher drops it at the next drain instead
                # of spending device time on an abandoned request.
                future.cancel()
                self._send(503, {"error": "search timed out"})
                return
            except Exception as error:  # noqa: BLE001 — server boundary
                self._send(500, {"error": str(error)})
                return
            # NOT exclude_none: SearchResult's optional fields (docstring,
            # dependencies, informalization) are required-but-nullable in the
            # wire schema — ApiClient validation needs them present as null.
            self._send(200, response.model_dump(mode="json"))

        def _handle_get_by_id(self, raw_id: str) -> None:
            try:
                declaration_id = int(raw_id)
            except ValueError:
                self._send(400, {"error": "declaration id must be an integer"})
                return
            future = batcher.submit_coroutine(
                batcher.service.get_by_id(declaration_id)
            )
            try:
                result = future.result(timeout=REQUEST_TIMEOUT_S)
            except concurrent.futures.TimeoutError:
                future.cancel()
                self._send(503, {"error": "lookup timed out"})
                return
            except Exception as error:  # noqa: BLE001 — server boundary
                self._send(500, {"error": str(error)})
                return
            if result is None:
                self._send(404, {"error": f"declaration {declaration_id} not found"})
                return
            self._send(200, result.model_dump(mode="json"))

        def log_message(self, fmt, *args):
            logger.info("%s - %s", self.address_string(), fmt % args)

    return SearchAPIHandler


def serve(
    service,
    host: str = "127.0.0.1",
    port: int = 8080,
    api_key: str | None = None,
    base_path: str = "/api/v2",
    coalesce_ms: float = 5.0,
    max_batch: int | None = None,
) -> ThreadingHTTPServer:
    """Build (but don't start) the server; call ``serve_forever()`` on it.

    The returned server carries its started ``SearchBatcher`` as
    ``server.batcher``; call ``server.batcher.stop()`` after shutdown.
    """
    batcher = SearchBatcher(service, coalesce_ms=coalesce_ms, max_batch=max_batch)
    handler = make_handler(batcher, api_key, base_path)

    class _BurstHTTPServer(ThreadingHTTPServer):
        # This server exists to absorb request BURSTS into device batches;
        # the socketserver default backlog of 5 drops SYNs under exactly
        # that load, and dropped SYNs retransmit after ~1s — the kernel
        # would serialize the burst before coalescing ever sees it.
        request_queue_size = 256

    # Bind before starting the batcher thread: a failed bind (port in use)
    # must not leak a live event-loop thread per attempt.
    server = _BurstHTTPServer((host, port), handler)
    batcher.start()
    server.batcher = batcher
    logger.info(
        "search API server on %s:%d (base %s, coalesce %.1f ms, max batch %d)",
        host,
        port,
        base_path,
        coalesce_ms,
        batcher.max_batch,
    )
    return server


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Self-hosted Lean Explore search API server (/api/v2)."
    )
    parser.add_argument("--data-dir", default=None, help="Index artifact dir")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument(
        "--api-key",
        default=None,
        help="If set, require 'Authorization: Bearer <key>' on API routes.",
    )
    parser.add_argument("--base-path", default="/api/v2")
    parser.add_argument(
        "--coalesce-ms",
        type=float,
        default=5.0,
        help="Batching window after the first pending request.",
    )
    parser.add_argument(
        "--max-batch",
        type=int,
        default=None,
        help=f"Max coalesced batch (default SERVE_QUERY_BATCH="
        f"{Config.SERVE_QUERY_BATCH}).",
    )
    parser.add_argument("--warmup", action="store_true")
    parser.add_argument(
        "--warmup-batch",
        type=int,
        default=1,
        help="Warm the serving path at this batch size before serving.",
    )
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)

    from lean_explore_tpu_torch.util.logging import setup_logging

    setup_logging(args.verbose)

    data_dir = args.data_dir or Config.ACTIVE_CACHE_PATH
    from pathlib import Path

    if not (Path(data_dir) / "declarations.db").exists():
        print(
            "Error: index artifacts not found.\nRun `lean-explore-torch data fetch` "
            f"or pass --data-dir.\nExpected directory: {data_dir}",
            file=sys.stderr,
        )
        raise SystemExit(1)

    from lean_explore_tpu_torch.search.engine import SearchEngine
    from lean_explore_tpu_torch.search.service import Service
    from lean_explore_tpu_torch.util.platform import requested_device

    service = Service(engine=SearchEngine(data_dir, device=requested_device()))
    if args.warmup:
        logger.info("Warming the serving path (all batch buckets) ...")
        # all_buckets: coalesced drains vary in size at runtime; warm every
        # standard bucket so no live request pays a first launch.
        elapsed_ms = asyncio.run(
            service.warmup(batch=args.warmup_batch, all_buckets=True)
        )
        logger.info("Warmup done in %d ms", elapsed_ms)

    server = serve(
        service,
        host=args.host,
        port=args.port,
        api_key=args.api_key,
        base_path=args.base_path,
        coalesce_ms=args.coalesce_ms,
        max_batch=args.max_batch,
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        logger.info("shutting down")
        server.shutdown()
    finally:
        server.batcher.stop()


if __name__ == "__main__":
    main()
