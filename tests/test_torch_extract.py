"""The port's extraction stages (lean_explore_tpu_torch/extract: types,
packages, github, doc_parser, doc_gen4, informalize, the CLI's
run_pipeline; util/openrouter_client) against the JAX package's, on the
inputs the JAX tests build (tests/extract/).

Two kinds of check:

- The JAX tests themselves, run on the port: each of tests/extract/'s
  modules below is executed again from its source with the JAX package's
  extraction modules and store replaced by the port's, and its test classes
  are collected here (``_on_port``). Their fixtures, inputs and assertions
  are the JAX tests' own.
- Side by side: both packages' stages on the same inputs (the doc-gen4
  databases of ``_make_docgen_db``, randomized RenderedCode blobs, the
  informalizer with one fake LLM, doc-gen4's subprocess layer faked, the
  OpenRouter client against one local server, the whole pipeline to a
  served query) give equal results: the stores' rows with their ids, the
  prompts, the commands, the requests and the served ids.
"""

import asyncio
import json
import random
import sqlite3
import threading
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest

from lean_explore_tpu.extract import doc_gen4 as jax_doc_gen4
from lean_explore_tpu.extract import doc_parser as jax_dp
from lean_explore_tpu.extract import informalize as jax_inf
from lean_explore_tpu.models import DeclarationStore as JaxStore
from lean_explore_tpu_torch.extract import doc_gen4, doc_parser, informalize
from lean_explore_tpu_torch.extract import packages as port_packages
from lean_explore_tpu_torch.models.store import DeclarationStore
from lean_explore_tpu_torch.util import openrouter_client
from tests.extract import test_blob_parity as blob_cases
from tests.extract.test_doc_parser import _make_docgen_db, tag_const, tag_simple, text
from tests.extract.test_pipeline_e2e import FakeOpenRouter
from tests.extract.test_pipeline_e2e import lean_root as _jax_lean_root_fixture

REPO = Path(__file__).resolve().parent.parent
lean_root = _jax_lean_root_fixture


# ----------------------------------------------------------------------
# The JAX tests, run on the port
# ----------------------------------------------------------------------

_REWRITES = (
    ("lean_explore_tpu.extract", "lean_explore_tpu_torch.extract"),
    ("from lean_explore_tpu.models import", "from lean_explore_tpu_torch.models.store import"),
)


def _on_port(name: str) -> types.ModuleType:
    """tests/extract/<name>.py executed with the port's modules in place of
    the JAX package's extraction modules and store."""
    path = REPO / "tests" / "extract" / f"{name}.py"
    source = path.read_text()
    for old, new in _REWRITES:
        source = source.replace(old, new)
    module = types.ModuleType(f"tests.extract.{name}_on_port")
    module.__file__ = str(path)
    exec(compile(source, str(path), "exec"), module.__dict__)  # noqa: S102
    return module


def _collect(module: types.ModuleType, skip=()) -> None:
    for attr, value in vars(module).items():
        if attr.startswith("Test") and isinstance(value, type) and attr not in skip:
            assert attr not in globals(), attr
            globals()[attr] = value
    for attr in ("src_tree",):
        if hasattr(module, attr):
            globals()[attr] = getattr(module, attr)


_collect(_on_port("test_doc_parser"))
_collect(_on_port("test_doc_parser_depth"))
_collect(_on_port("test_blob_parity"))
_collect(_on_port("test_informalize"))
# The embedding and CLI classes of this module are held by
# tests/test_torch_index_build.py.
_collect(_on_port("test_embeddings_and_stages"),
         skip=("TestGenerateEmbeddings", "TestPipelineCli"))


def test_the_port_modules_ran_the_jax_tests():
    assert TestSqliteFormat.test_detect_and_parse.__globals__["dp"] is doc_parser  # noqa: F821
    assert TestLayers.test_simple_chain.__globals__["inf"] is informalize  # noqa: F821


# ----------------------------------------------------------------------
# Side by side
# ----------------------------------------------------------------------


def _rows(path) -> list[tuple]:
    conn = sqlite3.connect(str(path))
    try:
        return conn.execute("SELECT * FROM declarations ORDER BY id").fetchall()
    finally:
        conn.close()


def _richer_workspace(root: Path) -> Path:
    """The e2e test's workspace plus a second module, a Verso-only and a
    markdown docstring, deep and shared type blobs, an attribute range, a
    projection sharing its parent's source and a module outside the
    prefixes."""
    ws = root / "mathlib"
    build = ws / ".lake" / "build"
    build.mkdir(parents=True)
    pkg = ws / ".lake" / "packages" / "mathlib4" / "Mathlib"
    pkg.mkdir(parents=True)
    (pkg / "Algebra.lean").write_text(
        "import Mathlib.Basic\n"
        "@[simp]\n"
        "theorem Group.mul_one (g : G) : g * 1 = g := by simp\n"
        "structure Scheme extends LRS where\n"
        "def ℝ.sqrt_le : ∀ x, √x ≤ x := sorry\n"
    )
    url = "https://github.com/leanprover-community/mathlib4/blob/abc/Mathlib/Algebra.lean"
    deep = text("leaf")
    for _ in range(300):
        deep = tag_simple(0, deep)
    rows = [
        dict(module="Mathlib.Algebra", name="Group.mul_one", start=2, end=2,
             docstring="mul one", source_url=url,
             type_blob=tag_const("Group", tag_const("Mul.mul", text("g * 1")))),
        dict(module="Mathlib.Algebra", name="Scheme", start=4, end=4, source_url=url,
             type_blob=deep),
        dict(module="Mathlib.Algebra", name="Scheme.toLRS", start=4, end=4, source_url=url),
        dict(module="Mathlib.Algebra", name="ℝ.sqrt_le", start=5, end=5, source_url=url,
             type_blob=tag_const("ℝ.sqrt_le", tag_const("Real.sqrt", text("√")))),
        dict(module="Other.Thing", name="Other.x", start=1, end=1, source_url=url),
    ]
    _make_docgen_db(build / "api-docs.db", rows)
    return root


@pytest.mark.parametrize("workspace", ["e2e", "richer"])
def test_parsed_store_rows_equal_jax_s(workspace, lean_root, tmp_path, monkeypatch):
    root = lean_root if workspace == "e2e" else _richer_workspace(tmp_path / "richer")
    for module in (doc_parser, port_packages, jax_dp):
        monkeypatch.setattr(module, "get_extraction_order", lambda: ["mathlib"])
    want_store = JaxStore(tmp_path / "jax.db", create=True)
    got_store = DeclarationStore(tmp_path / "port.db", create=True)
    assert doc_parser.extract_declarations(got_store, root) == jax_dp.extract_declarations(
        want_store, root
    )
    want_store.close()
    got_store.close()
    rows = _rows(tmp_path / "port.db")
    assert rows == _rows(tmp_path / "jax.db") and len(rows) >= 3


def test_bmp_docs_equal_jax_s(tmp_path):
    pkg = tmp_path / "pkg"
    (pkg / "Std").mkdir(parents=True)
    (pkg / "Std" / "A.lean").write_text("def std.a := 1\n@[inline]\ndef std.b := 2\n")
    bmp = tmp_path / "Std.A.bmp"
    link = "https://github.com/x/pkg/blob/main/Std/A.lean#L{}-L{}"
    bmp.write_text(json.dumps({"name": "Std.A", "declarations": [
        {"info": {"name": "std.a", "doc": "doc", "sourceLink": link.format(1, 1)},
         "header": '<a href="x#Nat.add">Nat.add</a><a href="y#std.a">self</a>'},
        {"info": {"name": "std.b", "sourceLink": link.format(2, 2)}, "header": ""},
        {"info": {"name": "Bad.mk", "sourceLink": link.format(1, 1)}, "header": ""},
    ]}))
    args = ([bmp], tmp_path, {"pkg": pkg}, ["Std"])
    got = [vars(d) for d in doc_parser.parse_bmp_docs(*args)]
    assert got == [d.model_dump() for d in jax_dp.parse_bmp_docs(*args)]


def test_random_blobs_decode_like_jax():
    rng = random.Random(7)
    for _ in range(300):
        blob = blob_cases.random_tagged_text(rng)
        assert doc_parser.extract_type_dependencies(blob) == jax_dp.extract_type_dependencies(blob)
        cut = blob[: rng.randrange(len(blob) + 1)]
        assert doc_parser.extract_type_dependencies(cut) == jax_dp.extract_type_dependencies(cut)


class RecordingLLM:
    """The e2e test's fake, recording each prompt; fails ``flaky``'s
    declarations once."""

    def __init__(self, flaky=()):
        self.fake, self.prompts, self.flaky = FakeOpenRouter(), [], set(flaky)

    async def generate(self, prompt, model, temperature=0.3):
        self.prompts.append((prompt, model, temperature))
        for name in list(self.flaky):
            if f"Declaration name: {name}\n" in prompt:
                self.flaky.discard(name)
                raise RuntimeError("flaky")
        return await self.fake.generate(prompt, model, temperature)


def _chain_rows():
    """Declarations in layers, a cycle, an external dependency, a long
    dependency description and a malformed dependencies column."""
    rows = []
    for i in range(12):
        deps = [f"D.n{j}" for j in range(max(0, i - 3), i)] + ["External.x"]
        rows.append(dict(name=f"D.n{i}", module="M", source_text=f"theorem n{i} := {i}",
                         source_link=f"l{i}", dependencies=json.dumps(deps),
                         docstring=None if i % 3 else f"doc {i}"))
    rows.append(dict(name="C.a", module="M", source_text="a", source_link="la",
                     dependencies=json.dumps(["C.b"])))
    rows.append(dict(name="C.b", module="M", source_text="b", source_link="lb",
                     dependencies=json.dumps(["C.a"])))
    rows.append(dict(name="Bad.deps", module="M", source_text="x", source_link="lx",
                     dependencies="{not json"))
    rows.append(dict(name="Done.one", module="M", source_text="y", source_link="ly",
                     informalization="**Done.** " + "long " * 80))
    rows.append(dict(name="Cached.one", module="M", source_text="z", source_link="lz",
                     dependencies=json.dumps(["Done.one"])))
    return rows


def _informalize(inf, store_cls, declaration_cls, tmp_path, tag):
    (tmp_path / tag / "prior").mkdir(parents=True)
    prior = store_cls(tmp_path / tag / "prior" / "declarations.db", create=True)
    prior.insert_many([declaration_cls(name="Cached.one", module="M", source_text="z",
                                       source_link="lz", informalization="**Cached.** z")])
    prior.close()
    store = store_cls(tmp_path / f"{tag}.db", create=True)
    store.insert_many([declaration_cls(**row) for row in _chain_rows()])
    llm = RecordingLLM(flaky=["D.n5"])
    layers = [[d.name for d in layer]
              for layer in inf.build_dependency_layers(list(store.iter_missing_informalization()))]
    done = asyncio.run(inf.informalize_declarations(
        store, client=llm, model="m", max_concurrent=3, commit_batch_size=4
    ))
    store.close()
    return done, layers, sorted(llm.prompts), _rows(tmp_path / f"{tag}.db")


def test_informalize_equals_jax_s(tmp_path, monkeypatch):
    """Same layers, prompts (and model and temperature), cache hits and
    stored texts; the declaration the LLM fails once stays missing in
    both."""
    from lean_explore_tpu.models import Declaration as JaxDeclaration
    from lean_explore_tpu_torch.models.store import Declaration

    monkeypatch.setattr(jax_inf, "discover_database_files",
                        lambda: [tmp_path / "jax" / "prior" / "declarations.db"])
    monkeypatch.setattr(informalize, "discover_database_files",
                        lambda: [tmp_path / "port" / "prior" / "declarations.db"])
    got = _informalize(informalize, DeclarationStore, Declaration, tmp_path, "port")
    want = _informalize(jax_inf, JaxStore, JaxDeclaration, tmp_path, "jax")
    assert got == want
    done, layers, prompts, rows = got
    assert done == len(rows) - 2  # D.n5 failed, Done.one was done
    assert len(layers) > 4 and sorted(layers[-1]) == ["C.a", "C.b"]
    assert not any("Cached.one" in p for p, _, _ in prompts)
    assert informalize.PROMPT_PATH.read_text() == jax_inf.PROMPT_PATH.read_text()


class _StubLLMServer:
    """A local chat-completions server: records each request and answers
    with the prompt's declaration name, failing with a 500 the first
    ``failures`` requests."""

    def __init__(self, failures: int = 0):
        self.requests, self.failures = [], failures
        owner = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                owner.requests.append((self.path, self.headers["Authorization"], body))
                if owner.failures:
                    owner.failures -= 1
                    self.send_response(500)
                    self.end_headers()
                    return
                prompt = body["messages"][0]["content"]
                reply = {"choices": [{"message": {"content": f"echo {len(prompt)}"}}]}
                data = json.dumps(reply).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}/api/v1/"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


def test_openrouter_client_retries_and_sends_jax_s_request(monkeypatch):
    """A 500 then an answer: the port retries after the scaled wait and
    returns the content; its request equals the JAX client's (httpx) to
    the same server, and a server that always fails raises after 3
    attempts."""
    from lean_explore_tpu.util.openrouter_client import OpenRouterClient as JaxClient

    waits = []
    monkeypatch.setattr(openrouter_client, "backoff_seconds",
                        lambda n: waits.append(n) or 0.01)
    with _StubLLMServer(failures=1) as server:
        client = openrouter_client.OpenRouterClient(api_key="k", base_url=server.url)
        got = asyncio.run(client.generate("hello", model="m", max_tokens=5))
        want = asyncio.run(JaxClient(api_key="k", base_url=server.url)
                           .generate("hello", model="m", max_tokens=5))
        assert got == want == "echo 5"
        assert waits == [1]
        assert len(server.requests) == 3
        assert server.requests[0] == server.requests[1] == server.requests[2]
        assert server.requests[0] == (
            "/api/v1/chat/completions", "Bearer k",
            {"model": "m", "messages": [{"role": "user", "content": "hello"}],
             "temperature": 0.3, "max_tokens": 5},
        )
    with _StubLLMServer(failures=99) as server:
        client = openrouter_client.OpenRouterClient(api_key="k", base_url=server.url)
        with pytest.raises(Exception, match="500"):
            asyncio.run(client.generate("x", model="m"))
        assert len(server.requests) == 3
    monkeypatch.delenv("OPENROUTER_API_KEY", raising=False)
    with pytest.raises(ValueError, match="OPENROUTER_API_KEY"):
        openrouter_client.OpenRouterClient()


def test_backoff_is_tenacity_s():
    from tenacity import wait_exponential

    wait = wait_exponential(multiplier=1, min=2, max=30)
    for n in range(1, 9):
        state = types.SimpleNamespace(attempt_number=n)
        assert openrouter_client.backoff_seconds(n) == wait(state)


def test_informalize_through_the_client_under_the_semaphore(monkeypatch):
    """The stage with the port's client against a local server: every
    declaration answered, at most ``max_concurrent`` requests in flight."""
    in_flight, peak, lock = [0], [0], threading.Lock()
    post = openrouter_client.OpenRouterClient._post

    def counting_post(self, payload):
        with lock:
            in_flight[0] += 1
            peak[0] = max(peak[0], in_flight[0])
        try:
            return post(self, payload)
        finally:
            with lock:
                in_flight[0] -= 1

    monkeypatch.setattr(openrouter_client.OpenRouterClient, "_post", counting_post)
    from lean_explore_tpu_torch.models.store import Declaration

    store = DeclarationStore(":memory:", create=True)
    store.insert_many([Declaration(name=f"N.d{i}", module="M", source_text=f"s{i}",
                                   source_link=f"l{i}") for i in range(40)])
    with _StubLLMServer() as server:
        client = openrouter_client.OpenRouterClient(api_key="k", base_url=server.url)
        done = asyncio.run(informalize.informalize_declarations(
            store, client=client, max_concurrent=4, use_cache=False))
        assert len(server.requests) == 40
    assert done == 40 and 1 <= peak[0] <= 4
    assert all(d.informalization.startswith("echo ") for d in store.iter_all())


class FakeSubprocess:
    """doc-gen4's subprocess layer, faked: records each command; ``lake
    update`` fails ``update_failures`` times first."""

    PIPE = STDOUT = object()

    def __init__(self, update_failures=0):
        self.calls, self.update_failures = [], update_failures

    def run(self, cmd, cwd=None, env=None, capture_output=False, text=False):
        self.calls.append(("run", tuple(cmd), Path(cwd).name))
        code = 0
        if cmd[:2] == ["lake", "update"] and self.update_failures:
            self.update_failures -= 1
            code = 1
        return types.SimpleNamespace(returncode=code, stdout="", stderr="err")

    def Popen(self, cmd, cwd=None, **kw):  # noqa: N802 — subprocess's name
        self.calls.append(("Popen", tuple(cmd), Path(cwd).name))
        return types.SimpleNamespace(stdout=iter(["building\n"]), wait=lambda: 0,
                                     returncode=1 if cmd[-1].startswith("Formal") else 0)


def fake_doc_gen4(monkeypatch, module, toolchain="leanprover/lean4:v4.29.0", **kw):
    """Fakes ``module``'s subprocess layer, toolchain fetch and sleep;
    returns the fake."""
    fake = FakeSubprocess(**kw)
    monkeypatch.setattr(module, "subprocess", fake)
    monkeypatch.setattr(module, "get_package_toolchain", lambda config: (toolchain, "main"))
    monkeypatch.setattr(module.time, "sleep", lambda s: None)
    return fake


@pytest.mark.parametrize("toolchain", ["leanprover/lean4:v4.29.0", "leanprover/lean4:v4.24.0"])
def test_doc_gen4_runs_jax_s_commands(toolchain, tmp_path, monkeypatch):
    """Every workspace, in dependency order: the same lake commands, the
    same lean-toolchain and lakefile pins, the same retries."""
    roots = {}
    for tag, module in (("port", doc_gen4), ("jax", jax_doc_gen4)):
        root = tmp_path / tag
        for name in port_packages.get_extraction_order():
            (root / name).mkdir(parents=True)
            (root / name / "lakefile.lean").write_text(
                'require «doc-gen4» from git\n  "https://github.com/leanprover/doc-gen4"\n'
            )
        fake = fake_doc_gen4(monkeypatch, module, toolchain, update_failures=2)
        module.run_doc_gen4(root)
        roots[tag] = (fake.calls, {p.relative_to(root).as_posix(): p.read_text()
                                   for p in sorted(root.rglob("*")) if p.is_file()})
    assert roots["port"] == roots["jax"]
    calls = roots["port"][0]
    assert sum(c[1] == ("lake", "update") for c in calls) == 7  # 2 retries + 5 packages
    suffix = ":docInfo" if "v4.29" in toolchain else ":docs"
    assert all(c[1][-1].endswith(suffix) for c in calls if c[0] == "Popen")
    with pytest.raises(FileNotFoundError):
        doc_gen4.run_package("mathlib", tmp_path / "missing")


def test_github_helpers_on_a_stubbed_url_layer(monkeypatch):
    """Toolchain and tag lookups through a stubbed ``urlopen``: JAX's
    results and URLs; a failure is wrapped in GitHubFetchError."""
    from lean_explore_tpu.extract import github as jax_github
    from lean_explore_tpu_torch.extract import github

    tags = [[{"name": f"v1.{i}.0"} for i in range(100)], [{"name": "v2.0.0-rc3"},
                                                          {"name": "v1.10.1"}]]

    class Reply:
        def __init__(self, body):
            self.body = body

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def read(self):
            return self.body

    def fake_urlopen(request, timeout):
        url = request.full_url
        seen.append(url)
        if url.endswith("lean-toolchain"):
            return Reply(b"leanprover/lean4:v4.29.0-rc2\n")
        if "page=" in url:
            return Reply(json.dumps(tags[int(url.rsplit("=", 1)[1]) - 1]).encode())
        raise OSError("no route")

    results = {}
    for tag, module in (("port", github), ("jax", jax_github)):
        seen = []
        monkeypatch.setattr(module.urllib.request, "urlopen", fake_urlopen)
        url = "https://github.com/leanprover-community/mathlib4.git"
        results[tag] = (module.fetch_lean_toolchain(url, "main"), module.fetch_latest_tag(url),
                        list(seen))
        with pytest.raises(module.GitHubFetchError):
            module._get("https://example.invalid/x")
    assert results["port"] == results["jax"]
    assert results["port"][:2] == ("leanprover/lean4:v4.29.0-rc2", "v1.99.0")


def _pipeline_kwargs(lean_root):
    return dict(run_docgen=False, run_parse=True, run_informalize=True, run_embed=True,
                run_index=True, lean_root=lean_root, informalize_model="fake/model",
                max_concurrent=4, embed_batch_size=8, limit=None)


def _served(engine_cls, service_cls, extraction, store_cls, clients, query, load):
    store = store_cls(extraction / "declarations.db")
    try:
        engine = engine_cls(extraction, store=store, artifacts=load(extraction), **clients)
        response = asyncio.run(service_cls(engine).search(query, limit=5))
        return [(r.id, r.name, r.informalization, r.docstring) for r in response.results]
    finally:
        store.close()


def test_pipeline_to_a_served_query_equals_jax_s(lean_root, tmp_path, monkeypatch):
    """tests/extract/test_pipeline_e2e.py's run on both packages: parse,
    informalize (its fake LLM), embed (a tiny checkpoint), index, one
    served query; the same stores, ids and served results."""
    import torch

    from lean_explore_tpu.config import Config as JaxConfig
    from lean_explore_tpu.extract import packages as jax_packages
    from lean_explore_tpu.extract.__main__ import run_pipeline as jax_run_pipeline
    from lean_explore_tpu.index import load_index_artifacts as jax_load
    from lean_explore_tpu.search.engine import SearchEngine as JaxEngine
    from lean_explore_tpu.search.service import Service as JaxService
    from lean_explore_tpu.util import EmbeddingClient as JaxEmbedder
    from lean_explore_tpu.util import RerankerClient as JaxReranker
    from lean_explore_tpu_torch.config import Config
    from lean_explore_tpu_torch.extract.__main__ import run_pipeline
    from lean_explore_tpu_torch.index.artifacts import load_index_artifacts
    from lean_explore_tpu_torch.search.engine import SearchEngine
    from lean_explore_tpu_torch.search.service import Service
    from lean_explore_tpu_torch.util.embedding_client import EmbeddingClient
    from lean_explore_tpu_torch.util.reranker_client import RerankerClient
    from tests.helpers import make_tiny_model_dir

    for module in (doc_parser, port_packages, jax_dp, jax_packages):
        monkeypatch.setattr(module, "get_extraction_order", lambda: ["mathlib"])
    tiny = make_tiny_model_dir(tmp_path / "tiny_model", with_st_prompt=True)
    for config in (Config, JaxConfig):
        monkeypatch.setattr(config, "EMBEDDING_MODEL_NAME", str(tiny))
        monkeypatch.setattr(config, "DATA_DIRECTORY", tmp_path / "data")
        monkeypatch.setattr(config, "CACHE_DIRECTORY", tmp_path / "cache")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")

    jax_llm, real = FakeOpenRouter(), jax_inf.informalize_declarations
    monkeypatch.setattr(jax_inf, "informalize_declarations",
                        lambda store, **kw: real(store, **{**kw, "client": jax_llm}))
    want_dir, got_dir = tmp_path / "jax", tmp_path / "port"
    want_dir.mkdir()
    got_dir.mkdir()
    asyncio.run(jax_run_pipeline(want_dir, **_pipeline_kwargs(lean_root)))
    port_llm = FakeOpenRouter()
    asyncio.run(run_pipeline(got_dir, **_pipeline_kwargs(lean_root),
                             informalize_client=port_llm))
    assert port_llm.calls == jax_llm.calls == 3
    # Every column equal but the embedding, which the default (bf16) clients
    # round differently: within tests/test_torch_reranker_client.py's 2^-8.
    got_rows, want_rows = _rows(got_dir / "declarations.db"), _rows(want_dir / "declarations.db")
    assert [r[:-1] for r in got_rows] == [r[:-1] for r in want_rows]
    np.testing.assert_allclose(*(np.stack([np.frombuffer(r[-1], "<f4") for r in rows])
                                 for rows in (got_rows, want_rows)), atol=2.0**-8, rtol=0)

    query = "nat add comm"
    want = _served(JaxEngine, JaxService, want_dir, JaxStore, dict(
        embedding_client=JaxEmbedder(str(tiny), dtype="float32"),
        reranker_client=JaxReranker(str(tiny), dtype="float32")), query, jax_load)
    got = _served(SearchEngine, Service, got_dir, DeclarationStore, dict(
        embedding_client=EmbeddingClient(str(tiny), dtype=torch.float32, device="cpu"),
        reranker_client=RerankerClient(str(tiny), dtype=torch.float32, device="cpu")),
        query, lambda d: load_index_artifacts(d, device="cpu"))
    assert got == want
    assert got[0][1] == "Nat.add_comm" and got[0][2].startswith("**The nat add comm")


def test_chip_smoke_phase_8_host_stages(tmp_path, monkeypatch):
    """chip_smoke.py phase 8's host stages at a small size on the CPU: its
    doc-gen4 workspace parses (in both packages, to the same rows) and
    informalizes back to ``make_corpus``'s declarations, through the
    in-process client and through OpenRouterClient against its stub
    server; the BPE reader's round trip over the corpus."""
    import chip_smoke
    from lean_explore_tpu_torch.train.synthetic import make_corpus

    corpus = make_corpus(n_decls=300, n_concepts=30, n_eval=8, seed=0, body_sentences=5)
    informalizer = chip_smoke.CorpusInformalizer(corpus)
    extraction, seconds = chip_smoke.run_extraction_stages(
        corpus, tmp_path / "chain", stages=("parse", "informalize"),
        informalize_client=informalizer)
    assert chip_smoke.hold_store_to_corpus(extraction, corpus) == {}
    assert informalizer.calls == 300 and set(seconds) == {"workspace", "parse", "informalize"}

    monkeypatch.setattr(jax_dp, "get_extraction_order", lambda: ["mathlib"])
    want_store = JaxStore(tmp_path / "jax.db", create=True)
    jax_dp.extract_declarations(want_store, tmp_path / "chain" / "lean")
    want_store.close()
    parsed = [row[:7] for row in _rows(tmp_path / "jax.db")]
    assert [row[:7] for row in _rows(extraction / "declarations.db")] == parsed
    # Each type names its declaration alone: no dependencies are stored.
    assert all(row[6] is None for row in parsed)

    small = make_corpus(n_decls=60, n_concepts=10, n_eval=4, seed=1, body_sentences=5)
    with chip_smoke.StubOpenRouter(small) as stub:
        client = openrouter_client.OpenRouterClient(api_key="k", base_url=stub.url)
        extraction, _ = chip_smoke.run_extraction_stages(
            small, tmp_path / "http", stages=("parse", "informalize"), informalize_client=client)
    chip_smoke.hold_store_to_corpus(extraction, small)
    assert sorted(stub.served) == sorted(d.name for d in small.declarations)
    rates = chip_smoke.check_bpe_reader(corpus, REPO, "cpu")
    assert rates["bpe_tokens_per_doc"] > 0
