"""The port's spans and counters (``util/profiling.py``) on the CPU.

Spans nest across ``asyncio.gather`` and ``asyncio.to_thread``, record
their thread's CPU time, land in one bounded ring, appear as ``lx.*``
ranges only while a profiler records, and sit at the engine's layer
boundaries: a tiny engine batch counts exactly the tokens the grouped
reranker packs, the cascade's stages share their batch's root, and the
HTTP batcher keeps each request's queue wait under its batch's root.
"""

import asyncio
import contextvars
import sys
import threading
import time

import numpy as np
import pytest
import torch

from lean_explore_tpu_torch.api import server as port_server
from lean_explore_tpu_torch.api.server import SearchBatcher
from lean_explore_tpu_torch.util import profiling
from lean_explore_tpu_torch.util.profiling import StageTimings, count, recent_spans, span
from tests.test_torch_api_server import Running, build_setup, http_get, port_service

STAGES = {"encode", "lexical", "dense", "fuse", "rerank"}
QUERIES = ["nat add comm", "list map function", "prime numbers", "sum of numbers"]


def _since(t0_ns: int) -> list:
    return [s for s in recent_spans() if s.start_ns >= t0_ns]


def _by_name(spans) -> dict:
    out: dict = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_spans_nest_across_gather_and_to_thread():
    def work(i):
        with span(f"thread{i}"):
            count("items", i + 1)
            count("items", 10)
            return threading.get_ident()

    async def task(i):
        with span(f"task{i}"):
            return await asyncio.to_thread(work, i)

    async def main():
        with span("root") as root:
            idents = await asyncio.gather(task(0), task(1))
        return root, idents

    t0 = time.perf_counter_ns()
    root, idents = asyncio.run(main())
    got = {s.name: s for s in _since(t0)}
    assert got["root"].parent is None and got["root"].root == root.id == root.root
    for i in (0, 1):
        assert got[f"task{i}"].parent == root.id
        assert got[f"thread{i}"].parent == got[f"task{i}"].id
        assert got[f"thread{i}"].root == root.id
        assert got[f"thread{i}"].counters == {"items": i + 11}
    assert threading.get_ident() not in idents
    assert got["root"].thread == threading.get_ident()
    assert {got["thread0"].thread, got["thread1"].thread} <= set(idents)
    # the innermost span is open only inside its block
    assert profiling._current.get() is None


def test_threads_sharing_a_span_lose_no_count_and_share_no_id():
    def add():
        for _ in range(2000):
            count("n")
            with span("inner"):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.perf_counter_ns()
        with span("shared"):
            threads = [threading.Thread(target=contextvars.copy_context().run, args=(add,))
                       for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    got = _by_name(_since(t0))
    (shared,) = got["shared"]
    assert shared.counters == {"n": 16 * 2000}
    inner = got["inner"]
    assert len(inner) == 16 * 2000 and len({s.id for s in inner}) == len(inner)
    assert all(s.parent == shared.id for s in inner)


def test_thread_cpu_time_is_at_most_the_wall():
    t0 = time.perf_counter_ns()
    with span("busy"):
        # spin until this thread has run 20 ms, however busy the host
        deadline = time.thread_time_ns() + 20_000_000
        while time.thread_time_ns() < deadline:
            pass
    with span("sleeping"):
        time.sleep(0.05)
    got = {s.name: s for s in _since(t0)}
    for s in got.values():
        assert 0 <= s.cpu_ns <= s.end_ns - s.start_ns
        assert s.wait_ms >= 0 and s.device_ms is None
    assert got["sleeping"].wait_ms >= 45.0
    assert got["busy"].cpu_ns >= 20_000_000


def test_the_ring_keeps_the_newest_spans_up_to_its_bound():
    assert profiling._ring.maxlen == profiling.RING_SIZE == 100_000
    for _ in range(profiling.RING_SIZE + 5):
        with span("filler"):
            pass
    with span("last"):
        pass
    spans = recent_spans()
    assert len(spans) == profiling.RING_SIZE
    assert spans[-1].name == "last" and all(s.name == "filler" for s in spans[:-1])
    assert [s.id for s in spans] == sorted(s.id for s in spans)


def test_lx_ranges_appear_only_under_a_profiler():
    from torch.profiler import ProfilerActivity, profile

    with span("unprofiled") as outside:
        torch.ones(4).add_(1)
    assert outside._range is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("profiled"):
            with span("profiled/inner"):
                torch.ones(4).add_(1)
    names = {e.name for e in prof.events()}
    assert {"lx.profiled", "lx.profiled/inner"} <= names
    assert not any(n.startswith("lx.unprofiled") for n in names)
    # function-scope ranges: no copies on a device's timeline
    assert all(e.scope == 0 for e in prof.events() if e.name.startswith("lx."))


def test_stage_timings_keep_their_keys_and_each_stage_is_a_span():
    timings = StageTimings()
    t0 = time.perf_counter_ns()
    for name in ("encode", "dense", "fuse", "encode"):
        with timings.stage(name):
            time.sleep(0.001)
    got = timings.as_dict()
    assert list(got) == ["encode", "dense", "fuse"]
    spans = _by_name(_since(t0))
    for name, ms in got.items():
        assert ms == pytest.approx(sum(s.wall_ms for s in spans[name]))
    assert len(spans["encode"]) == 2 and timings.total_ms() == pytest.approx(sum(got.values()))


# ----------------------------------------------------------------- engine


@pytest.fixture(scope="module")
def service(tmp_path_factory):
    return port_service(*build_setup(tmp_path_factory.mktemp("torch_tracing")))


def _capture_packed(client, monkeypatch) -> list:
    """The arrays each grouped scorer call receives."""
    seen = []
    make = client._sharded_scorer

    def capturing(chunk):
        scorer = make(chunk)

        def run(replicas, prefix_ids, prefix_mask, suffix_ids, suffix_mask, pos_offset):
            seen.append((prefix_mask.copy(), suffix_mask.copy()))
            return scorer(replicas, prefix_ids, prefix_mask, suffix_ids, suffix_mask, pos_offset)

        return run

    monkeypatch.setattr(client, "_sharded_scorer", capturing)
    return seen


def _batch_spans(t0_ns: int):
    """The spans of the one engine batch begun after ``t0_ns``."""
    spans = _since(t0_ns)
    (root,) = [s for s in spans if s.name == "search_batch"]
    return root, [s for s in spans if s.root == root.root]


def test_engine_batch_spans_and_rerank_pack_counters_match_the_packed_arrays(service, monkeypatch):
    client = service.engine.reranker_client
    packed = _capture_packed(client, monkeypatch)
    timings = StageTimings()
    t0 = time.perf_counter_ns()
    responses = asyncio.run(service.search_batch(QUERIES, limit=5, rerank_top=12, timings=timings))
    assert all(r.results for r in responses)
    root, spans = _batch_spans(t0)
    assert root.parent is None and root.counters == {"queries": len(QUERIES)}
    assert set(timings.as_dict()) == STAGES
    names = _by_name(spans)
    for name in ("encode/tokenize", "encode/forward", "fuse/signals", "rerank/tokenize",
                 "rerank/pack", "rerank/device", *STAGES):
        assert name in names, name
    by_id = {s.id: s for s in spans}
    assert by_id[names["encode/forward"][0].parent].name == "encode"
    assert by_id[names["rerank/tokenize"][0].parent].name == "rerank"
    assert by_id[names["fuse/signals"][0].parent].name == "rerank"
    assert all(s.device_ms is None for s in spans)  # no card
    # each stage's milliseconds are its spans' walls
    for stage, ms in timings.as_dict().items():
        assert ms == pytest.approx(sum(s.wall_ms for s in names[stage]))

    packs = names["rerank/pack"]
    assert len(packs) == len(packed) >= 1
    docs_per_group = [min(len(r.results), 12) for r in responses]
    for pack, (prefix_mask, suffix_mask) in zip(packs, packed):
        c = pack.counters
        groups = c["groups"]
        assert c["groups_padded"] == prefix_mask.shape[0] >= groups
        assert c["docs_padded"] == suffix_mask.shape[0] * suffix_mask.shape[1]
        assert c["prefix_tokens_padded"] == prefix_mask.size
        assert c["suffix_tokens_padded"] == suffix_mask.size
        assert c["prefix_tokens"] == int(prefix_mask[:groups].sum())
        # real documents carry at least one token; pad documents one
        # placeholder token each, which the counters leave out
        real_docs = int(suffix_mask[:groups].any(axis=2).sum())
        assert c["docs"] <= real_docs
        placeholders = groups * suffix_mask.shape[1] - c["docs"]
        assert c["suffix_tokens"] == int(suffix_mask[:groups].sum()) - placeholders
    assert sum(p.counters["groups"] for p in packs) == len(QUERIES)
    assert sum(p.counters["docs"] for p in packs) >= sum(docs_per_group)


def test_cascade_stages_share_their_batch_root(service, monkeypatch):
    monkeypatch.setenv("LEAN_EXPLORE_RERANK_CASCADE", "4,3")
    t0 = time.perf_counter_ns()
    asyncio.run(service.search_batch(QUERIES, limit=5, rerank_top=8))
    root, spans = _batch_spans(t0)
    names = _by_name(spans)
    by_id = {s.id: s for s in spans}
    for name in ("rerank/stage1", "rerank/select", "rerank/stage2"):
        (stage,) = names[name]
        assert by_id[stage.parent].name == "rerank" and stage.root == root.root
    stage1, select, stage2 = (names[n][0] for n in ("rerank/stage1", "rerank/select", "rerank/stage2"))
    assert stage1.end_ns <= select.start_ns and select.end_ns <= stage2.start_ns
    for stage in (stage1, stage2):
        children = [s for s in spans if s.parent == stage.id]
        assert {"rerank/tokenize", "rerank/pack", "rerank/device"} <= {s.name for s in children}
        assert sum(s.wall_ms for s in children) <= stage.wall_ms
    # stage 1 cuts each suffix to 4 tokens
    (pack1,) = [s for s in spans if s.name == "rerank/pack" and s.parent == stage1.id]
    assert pack1.counters["suffix_tokens"] <= 4 * pack1.counters["docs"]


def test_batcher_keeps_each_request_s_queue_wait_under_its_batch_root(service):
    batcher = SearchBatcher(service, coalesce_ms=200.0)
    batcher.start()
    try:
        t0 = time.perf_counter_ns()
        futures = [batcher.submit_search(q, 5, 10, None) for q in QUERIES]
        for f in futures:
            assert f.result(timeout=120).results
    finally:
        batcher.stop()
    spans = _since(t0)
    (group,) = [s for s in spans if s.name == "batcher/group"]
    (batch,) = [s for s in spans if s.name == "search_batch"]
    assert group.parent is None and batch.root == group.id
    waits = list(batcher.queue_waits)
    assert [rid for rid, _, _ in waits] == [1, 2, 3, 4]
    assert all(root == group.id and wait >= 0 for _, root, wait in waits)
    # Every request was submitted after t0 and waited until its group began.
    assert max(w for _, _, w in waits) <= (group.start_ns - t0) / 1e6
    assert batcher.queue_wait_ms(50) <= batcher.queue_wait_ms(95) == max(w for _, _, w in waits)


def test_healthz_reports_the_queue_wait(service):
    running = Running(port_server.serve, service, coalesce_ms=1.0)
    try:
        status, before = http_get(running.url + "/healthz", None)
        assert status == 200
        assert before["queue_wait_ms_p50"] is None and before["queue_wait_ms_p95"] is None
        status, _ = http_get(running.base + "/search?q=nat+add&limit=3&rerank_top=0")
        assert status == 200
        status, after = http_get(running.url + "/healthz", None)
        assert after["requests_served"] == 1
        assert 0 <= after["queue_wait_ms_p50"] <= after["queue_wait_ms_p95"]
        assert np.isfinite(after["queue_wait_ms_p95"])
    finally:
        running.close()
