"""The port's HTTP search API (server and ApiClient) against the JAX
package's, on the CPU.

Both servers run on 127.0.0.1 over one artifact directory, built by the
JAX package from a small synthetic store, with the same tiny float32
checkpoints (``tests.helpers.make_tiny_model_dir``) loaded by each
package's own clients. The same requests must give the same status codes
and JSON bodies, apart from ``processing_time_ms`` and the health
counters. The coalescing batcher, its rerank-unavailable latch and
``ApiClient`` in both directions are held the same way.

The other surface tests (``test_torch_mcp.py``, ``test_torch_cli.py``)
build their services with the helpers of this module.
"""

import asyncio
import concurrent.futures
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from lean_explore_tpu.api import ApiClient as JaxApiClient
from lean_explore_tpu.api import server as jax_server
from lean_explore_tpu.index import build_index_artifacts
from lean_explore_tpu.models import Declaration, DeclarationStore
from lean_explore_tpu.search.engine import SearchEngine as JaxEngine
from lean_explore_tpu.search.service import Service as JaxService
from lean_explore_tpu.util.embedding_client import EmbeddingClient as JaxEmbedder
from lean_explore_tpu.util.reranker_client import RerankerClient as JaxReranker
from lean_explore_tpu_torch.api import ApiClient
from lean_explore_tpu_torch.api import server as port_server
from lean_explore_tpu_torch.models.search_types import SearchResponse, SearchResult
from lean_explore_tpu_torch.search.engine import SearchEngine
from lean_explore_tpu_torch.search.service import Service
from lean_explore_tpu_torch.util.embedding_client import EmbeddingClient
from lean_explore_tpu_torch.util.reranker_client import RerankerClient
from tests.helpers import make_tiny_model_dir

KEY = "test-key"
WORDS = [
    "nat", "add", "mul", "list", "map", "comm", "sum", "prime", "function",
    "continuous", "addition", "multiplication", "element", "numbers",
]
N_DECLS = 60


def declarations(n: int = N_DECLS, dim: int = 64) -> list[Declaration]:
    """A synthetic store: three packages, bold-titled informalizations on
    most rows, a None docstring on every fourth and no embedding on every
    ninth."""
    rng = np.random.default_rng(7)
    names = [
        f"Pkg{i % 3}.{WORDS[i % len(WORDS)].capitalize()}.{WORDS[(i * 5) % len(WORDS)]}{i}"
        for i in range(n)
    ]
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    return [
        Declaration(
            name=name,
            module=f"Pkg{i % 3}.Mod{i % 5}",
            docstring=None if i % 4 == 0 else f"doc of {name}",
            source_text=f"def {name} := x",
            source_link=f"https://example/{i}",
            dependencies=json.dumps(names[i + 1 : i + 1 + i % 3]) if i % 2 else None,
            informalization=(
                f"**The {WORDS[i % len(WORDS)]} {WORDS[(i * 7) % len(WORDS)]}.** "
                f"{WORDS[(i * 11) % len(WORDS)]} of numbers"
                if i % 5
                else None
            ),
            informalization_embedding=vecs[i].tolist() if i % 9 else None,
        )
        for i, name in enumerate(names)
    ]


def build_setup(root):
    """(artifact dir, embedder dir, reranker dir) under ``root``."""
    embed_dir = make_tiny_model_dir(root / "embedder", seed=0)
    rerank_dir = make_tiny_model_dir(root / "reranker", seed=1)
    data = root / "artifacts"
    data.mkdir()
    store = DeclarationStore(data / "declarations.db", create=True)
    store.insert_many(declarations())
    build_index_artifacts(store, data)
    store.close()
    return data, embed_dir, rerank_dir


def jax_service(data, embed_dir, rerank_dir, service_cls=JaxService, **engine_kw):
    """The JAX Service in float32; ``rerank_dir=None`` leaves the reranker
    to the engine's lazy default of ``engine_kw``."""
    reranker = None
    if rerank_dir is not None:
        reranker = JaxReranker(
            str(rerank_dir), model_dir=rerank_dir, dtype="float32", max_length=256
        )
    engine = JaxEngine(
        data,
        embedding_client=JaxEmbedder(str(embed_dir), model_dir=embed_dir, dtype="float32"),
        reranker_client=reranker,
        dense_dtype="float32",
        preload_metadata=True,
        **engine_kw,
    )
    return service_cls(engine)


def port_service(data, embed_dir, rerank_dir, service_cls=Service, **engine_kw):
    """The port's Service on the CPU in float32, as ``jax_service``."""
    reranker = None
    if rerank_dir is not None:
        reranker = RerankerClient(
            str(rerank_dir), model_dir=rerank_dir, dtype=torch.float32,
            max_length=256, device="cpu",
        )
    engine = SearchEngine(
        data,
        embedding_client=EmbeddingClient(
            str(embed_dir), model_dir=embed_dir, dtype=torch.float32, device="cpu"
        ),
        reranker_client=reranker,
        dense_dtype="float32",
        preload_metadata=True,
        device="cpu",
        **engine_kw,
    )
    return service_cls(engine)


class Running:
    """A server of either package serving on a daemon thread."""

    def __init__(self, serve, service, **kw):
        self.server = serve(service, port=0, api_key=KEY, **kw)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.base = f"{self.url}/api/v2"

    def close(self):
        self.server.shutdown()
        self.server.batcher.stop()
        self.server.server_close()


def http_get(url: str, key: str | None = KEY) -> tuple[int, dict]:
    headers = {"Authorization": f"Bearer {key}"} if key else {}
    try:
        with urllib.request.urlopen(urllib.request.Request(url, headers=headers), timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as error:
        return error.code, json.loads(error.read())


def without_timing(body: dict) -> dict:
    return {k: v for k, v in body.items() if k != "processing_time_ms"}


class CountingService:
    """Mixin recording each ``search_batch`` call's queries and kwargs."""

    def __init__(self, engine):
        super().__init__(engine)
        self.batch_calls: list[tuple[list[str], dict]] = []

    async def search_batch(self, queries, **kwargs):
        self.batch_calls.append((list(queries), dict(kwargs)))
        return await super().search_batch(queries, **kwargs)


class JaxCounting(CountingService, JaxService):
    pass


class PortCounting(CountingService, Service):
    pass


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return build_setup(tmp_path_factory.mktemp("torch_api"))


@pytest.fixture(scope="module")
def servers(setup):
    jax = Running(jax_server.serve, jax_service(*setup), coalesce_ms=1.0)
    port = Running(port_server.serve, port_service(*setup), coalesce_ms=1.0)
    yield jax, port
    jax.close()
    port.close()


REQUESTS = {
    "search": ("/api/v2/search?q=nat+add+comm&limit=5", KEY),
    "search_default_limit": ("/api/v2/search?q=list+map+function", KEY),
    "search_packages": ("/api/v2/search?q=prime+numbers&limit=8&packages=Pkg0,Pkg2", KEY),
    "search_rerank_0": ("/api/v2/search?q=sum+of+numbers&limit=6&rerank_top=0", KEY),
    "search_rerank_50": ("/api/v2/search?q=sum+of+numbers&limit=6&rerank_top=50", KEY),
    "search_rerank_over_max": ("/api/v2/search?q=continuous+function&rerank_top=500", KEY),
    "search_limit_over_max": ("/api/v2/search?q=nat&limit=1000&rerank_top=0", KEY),
    "search_limit_zero": ("/api/v2/search?q=mul&limit=0&rerank_top=0", KEY),
    "search_by_name": ("/api/v2/search?q=Pkg0.List.add3&limit=3", KEY),
    "search_blank": ("/api/v2/search?q=%20&limit=3", KEY),
    "declaration": ("/api/v2/declarations/3", KEY),
    "declaration_none_docstring": ("/api/v2/declarations/1", KEY),
    "declaration_404": ("/api/v2/declarations/99999", KEY),
    "declaration_bad_id": ("/api/v2/declarations/abc", KEY),
    "missing_q": ("/api/v2/search?limit=3", KEY),
    "bad_limit": ("/api/v2/search?q=nat&limit=x", KEY),
    "bad_rerank_top": ("/api/v2/search?q=nat&rerank_top=y", KEY),
    "query_too_long": ("/api/v2/search?q=" + "a" * 2001, KEY),
    "no_key": ("/api/v2/search?q=nat", None),
    "wrong_key": ("/api/v2/declarations/3", "other"),
    "unknown_route": ("/api/v2/nothing", KEY),
    "outside_base": ("/other", KEY),
}


@pytest.mark.parametrize("name", list(REQUESTS))
def test_same_status_and_body_as_jax(servers, name):
    path, key = REQUESTS[name]
    jax, port = servers
    want_status, want = http_get(jax.url + path, key)
    got_status, got = http_get(port.url + path, key)
    assert got_status == want_status
    assert without_timing(got) == without_timing(want)
    if name.startswith("search") and name != "search_blank":
        assert got_status == 200 and got["count"] > 0


def test_healthz(servers):
    jax, port = servers
    want_status, want = http_get(jax.url + "/healthz", None)
    got_status, got = http_get(port.url + "/healthz", None)
    assert got_status == want_status == 200
    assert got["status"] == want["status"] == "ok"
    # the port also reports the batcher's queue wait
    assert set(got) == set(want) | {"queue_wait_ms_p50", "queue_wait_ms_p95"}


def test_coalesced_burst_is_one_engine_batch_sliced_per_request(setup):
    """Six concurrent requests with limits 1-6 run as one search_batch at
    limit 6 in each package's server, and each answer is the direct
    batch's answer cut to its own limit."""
    queries = ["nat add", "list map", "prime numbers", "sum of numbers", "mul comm", "element"]
    jax = Running(jax_server.serve, jax_service(*setup, service_cls=JaxCounting), coalesce_ms=500.0)
    port = Running(port_server.serve, port_service(*setup, service_cls=PortCounting), coalesce_ms=500.0)
    try:
        answers = {}
        for label, running in (("jax", jax), ("port", port)):
            with concurrent.futures.ThreadPoolExecutor(len(queries)) as pool:
                futures = [
                    pool.submit(
                        http_get,
                        f"{running.base}/search?q={q.replace(' ', '+')}&limit={i + 1}",
                    )
                    for i, q in enumerate(queries)
                ]
                answers[label] = [f.result() for f in futures]
            batcher = running.server.batcher
            assert batcher.batches_run == 1 and batcher.batch_sizes == [len(queries)]
        calls = port.server.batcher.service.batch_calls
        assert len(calls) == 1
        batch_queries, kwargs = calls[0]
        assert sorted(batch_queries) == sorted(queries)
        assert kwargs == {"limit": len(queries), "rerank_top": 50, "packages": None}
        direct = asyncio.run(
            port_service(*setup).search_batch(queries, limit=len(queries))
        )
        for i, ((status, got), (_, want), full) in enumerate(
            zip(answers["port"], answers["jax"], direct)
        ):
            assert status == 200 and got["count"] == len(got["results"]) == i + 1
            assert got["results"] == [r.model_dump(mode="json") for r in full.results[: i + 1]]
            assert without_timing(got) == without_timing(want)
    finally:
        jax.close()
        port.close()


def test_rerank_unavailable_latch_matches_jax(setup, tmp_path):
    """A missing reranker checkpoint: a request on the server's default
    rerank_top degrades to no rerank and latches; an explicit rerank_top
    fails with 500 from then on; rerank_top=0 is served. Each answer equals
    JAX's."""
    data, embed_dir, _ = setup
    missing = str(tmp_path / "no-reranker")
    jax = Running(
        jax_server.serve,
        jax_service(data, embed_dir, None, reranker_model_name=missing),
        coalesce_ms=1.0,
    )
    port = Running(
        port_server.serve,
        port_service(data, embed_dir, None, reranker_model_name=missing),
        coalesce_ms=1.0,
    )
    try:
        for path in (
            "/search?q=nat+add&limit=4",
            "/search?q=nat+add&limit=4&rerank_top=5",
            "/search?q=list+map&limit=4&rerank_top=0",
            "/search?q=prime&limit=4",
        ):
            want_status, want = http_get(jax.base + path)
            got_status, got = http_get(port.base + path)
            assert got_status == want_status
            assert without_timing(got) == without_timing(want)
            assert port.server.batcher._rerank_unavailable
        status, body = http_get(port.base + "/search?q=nat&rerank_top=5")
        assert status == 500 and body == {"error": "reranker checkpoint unavailable"}
    finally:
        jax.close()
        port.close()


def test_port_client_against_jax_server_and_jax_client_against_port(servers):
    jax, port = servers
    for server in (jax, port):
        for query, packages in (("nat add comm", None), ("prime numbers", ["Pkg1"])):
            got = asyncio.run(
                ApiClient(api_key=KEY, base_url=server.base).search(
                    query, limit=7, rerank_top=0, packages=packages
                )
            )
            want = asyncio.run(
                JaxApiClient(api_key=KEY, base_url=server.base).search(
                    query, limit=7, packages=packages
                )
            )
            assert isinstance(got, SearchResponse) and got.count == len(got.results) > 0
            assert without_timing(got.model_dump()) == without_timing(want.model_dump())
        hit = asyncio.run(ApiClient(api_key=KEY, base_url=server.base).get_by_id(3))
        assert hit.model_dump() == asyncio.run(
            JaxApiClient(api_key=KEY, base_url=server.base).get_by_id(3)
        ).model_dump()
        assert asyncio.run(ApiClient(api_key=KEY, base_url=server.base).get_by_id(99999)) is None
        with pytest.raises(urllib.error.HTTPError) as raised:
            asyncio.run(ApiClient(api_key="wrong", base_url=server.base).get_by_id(3))
        assert raised.value.code == 401
        with pytest.raises(urllib.error.HTTPError) as raised:
            asyncio.run(ApiClient(api_key="wrong", base_url=server.base).search("nat"))
        assert raised.value.code == 401


def test_client_key_and_base_url(monkeypatch):
    monkeypatch.delenv("LEANEXPLORE_API_KEY", raising=False)
    with pytest.raises(ValueError, match="API key required"):
        ApiClient()
    monkeypatch.setenv("LEANEXPLORE_API_KEY", "from-env")
    client = ApiClient(base_url="http://h:1/api/v2/")
    assert client.api_key == "from-env" and client.base_url == "http://h:1/api/v2"
    assert client._headers == {"Authorization": "Bearer from-env"}
    assert ApiClient(api_key="given").api_key == "given"
    assert ApiClient().base_url == JaxApiClient().base_url


def test_wire_types_ignore_unknown_keys_and_dump_like_pydantic():
    from lean_explore_tpu.models import SearchResponse as JaxResponse
    from lean_explore_tpu.models import SearchResult as JaxResult

    row = {
        "id": 4, "name": "A.b", "module": "A", "docstring": None, "source_text": "s",
        "source_link": "l", "dependencies": None, "informalization": "**T.** x",
        "score": 0.5,
    }
    got = SearchResult.from_dict(row)
    want = JaxResult(**row)
    assert got.model_dump() == want.model_dump()
    response = SearchResponse(query="q", results=[got], count=1)
    jax_response = JaxResponse(query="q", results=[want], count=1)
    for kw in ({}, {"mode": "json"}, {"exclude_none": True}, {"mode": "json", "exclude_none": True}):
        assert response.model_dump(**kw) == jax_response.model_dump(**kw)
    assert "docstring" not in response.model_dump(exclude_none=True)["results"][0]
    copy = response.model_copy(update={"results": [], "count": 0})
    assert copy.model_dump() == jax_response.model_copy(update={"results": [], "count": 0}).model_dump()
    assert response.count == 1
    with pytest.raises(ValueError):
        response.model_dump(mode="yaml")
