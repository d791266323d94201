"""The port's Service.search_batch vs the JAX SearchEngine, on the CPU.

Both read one artifact directory, built by the JAX package from a small
synthetic store, and load the same tiny float32 checkpoints
(``tests.helpers.make_tiny_model_dir``) through their own loaders and
tokenizers. The slice as a whole must return the same result ids in the
same order; the reranker scores behind them agree to 1e-5 (the trunk
tolerance of tests/test_torch_qwen3.py), far inside the gaps that order
these results.
"""

import asyncio
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from lean_explore_tpu.index import build_index_artifacts
from lean_explore_tpu.models import Declaration, DeclarationStore
from lean_explore_tpu.search.engine import SearchEngine as JaxEngine
from lean_explore_tpu.search.service import Service as JaxService
from lean_explore_tpu.util.embedding_client import EmbeddingClient as JaxEmbedder
from lean_explore_tpu.util.reranker_client import RerankerClient as JaxReranker
from lean_explore_tpu_torch.config import Config
from lean_explore_tpu_torch.search.engine import SearchEngine
from lean_explore_tpu_torch.search.service import Service
from lean_explore_tpu_torch.util.embedding_client import EmbeddingClient
from lean_explore_tpu_torch.util.reranker_client import RerankerClient
from tests.helpers import make_tiny_model_dir

REPO = Path(__file__).resolve().parent.parent
WORDS = [
    "nat", "add", "mul", "list", "map", "comm", "sum", "prime", "function",
    "continuous", "addition", "multiplication", "element", "numbers",
]
QUERIES = [
    "nat add comm",
    "list map function",
    "prime numbers",
    "sum of two natural numbers",
    "continuous function",
    "",
    "multiplication applies to each element",
]


def _declarations(n: int, dim: int):
    rng = np.random.default_rng(11)
    names = [
        f"Pkg{i % 3}.{WORDS[i % len(WORDS)].capitalize()}.{WORDS[(i * 5) % len(WORDS)]}_{WORDS[(i * 3) % len(WORDS)]}{i}"
        for i in range(n)
    ]
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    return [
        Declaration(
            name=name,
            module=f"Pkg{i % 3}.Mod{i % 5}",
            source_text=f"def {name} := x",
            source_link=f"https://example/{i}",
            dependencies=json.dumps(names[i + 1 : i + 1 + i % 3]) if i % 2 else None,
            informalization=(
                f"the {WORDS[i % len(WORDS)]} of {WORDS[(i * 7) % len(WORDS)]} "
                f"{WORDS[(i * 11) % len(WORDS)]}"
            ),
            informalization_embedding=vecs[i].tolist() if i % 9 else None,
        )
        for i, name in enumerate(names)
    ]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_engine")
    embed_dir = make_tiny_model_dir(root / "embedder", seed=0)
    rerank_dir = make_tiny_model_dir(root / "reranker", seed=1)
    data = root / "artifacts"
    data.mkdir()
    store = DeclarationStore(data / "declarations.db", create=True)
    store.insert_many(_declarations(90, 64))
    build_index_artifacts(store, data)
    store.close()
    return data, embed_dir, rerank_dir


def _jax_service(data, embed_dir, rerank_dir, dense_dtype="float32", rerank_dtype="float32", **kw):
    engine = JaxEngine(
        data,
        **kw,
        embedding_client=JaxEmbedder(str(embed_dir), model_dir=embed_dir, dtype="float32"),
        reranker_client=JaxReranker(
            str(rerank_dir), model_dir=rerank_dir, dtype=rerank_dtype, max_length=256
        ),
        dense_dtype=dense_dtype,
        preload_metadata=True,
    )
    return JaxService(engine)


def _torch_service(data, embed_dir, rerank_dir, dense_dtype="float32", rerank_dtype=torch.float32, **kw):
    engine = SearchEngine(
        data,
        **kw,
        embedding_client=EmbeddingClient(
            str(embed_dir), model_dir=embed_dir, dtype=torch.float32, device="cpu"
        ),
        reranker_client=RerankerClient(
            str(rerank_dir), model_dir=rerank_dir, dtype=rerank_dtype,
            max_length=256, device="cpu",
        ),
        dense_dtype=dense_dtype,
        preload_metadata=True,
        device="cpu",
    )
    return Service(engine)


@pytest.mark.parametrize(
    "rerank_top,env",
    [
        (50, {}),
        (0, {}),
        (50, {"LEAN_EXPLORE_RERANK_CASCADE": "4,2"}),
        (50, {"LEAN_EXPLORE_RERANKER_INT8": "1"}),
        (50, {"LEAN_EXPLORE_FUSED_QKV": "1"}),
    ],
    ids=["50", "0", "cascade_4_2", "int8_reranker", "fused_qkv"],
)
def test_search_batch_same_ids_as_jax(setup, monkeypatch, rerank_top, env):
    """Each variable is read by both packages: the cascade per rerank call,
    the int8 reranker and the fused projections of both clients at load.

    The int8 reranker loads bf16 and quantizes (both clients take
    dtype=None), so its trunk runs in bf16, where the two packages round
    differently (XLA on the CPU keeps f32 inside its fusions; the port
    rounds each op): P(true) differs by up to 1.2e-3. The tiny random
    reranker scores every pair within a few hundredths of 0.5, and such a
    difference reordered 2-3 of the 7 queries' results, int8 or plain bf16
    alike. That case therefore scores with the committed trained reranker
    (runs/reranker/checkpoint), whose scores the bf16 rounding does not
    reorder."""
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    int8 = "LEAN_EXPLORE_RERANKER_INT8" in env
    if int8:
        setup = (*setup[:2], REPO / "runs" / "reranker" / "checkpoint")
    jax_service = _jax_service(*setup, rerank_dtype=None if int8 else "float32")
    service = _torch_service(*setup, rerank_dtype=None if int8 else torch.float32)
    reranker = service.engine.reranker_client
    assert reranker.int8 == int8
    fused = "LEAN_EXPLORE_FUSED_QKV" in env
    for client in (reranker, service.engine.embedding_client):
        assert ("qkv_proj" in client.params["layers"]) == fused
    want = asyncio.run(jax_service.search_batch(QUERIES, rerank_top=rerank_top))
    got = asyncio.run(service.search_batch(QUERIES, rerank_top=rerank_top))
    assert len(got) == len(want) == len(QUERIES)
    for g, w in zip(got, want):
        assert g.query == w.query
        assert [r.id for r in g.results] == [r.id for r in w.results]
        assert g.count == w.count
        assert [r.model_dump() for r in g.results] == [
            r.model_dump() for r in w.results
        ]
    assert any(r.count for r in got)


def test_search_batch_int8_same_ids_as_jax(setup, monkeypatch):
    """The int8 corpus through both engines: the same result ids and
    payloads. The port's engine takes the dtype from Config.CORPUS_DTYPE
    (LEAN_EXPLORE_CORPUS_DTYPE) when none is passed."""
    want = asyncio.run(
        _jax_service(*setup, dense_dtype="int8").search_batch(QUERIES, rerank_top=0)
    )
    monkeypatch.setattr(Config, "CORPUS_DTYPE", "int8")
    service = _torch_service(*setup, dense_dtype=None)
    assert service.engine._artifacts.dense.embeddings.dtype == torch.int8
    got = asyncio.run(service.search_batch(QUERIES, rerank_top=0))
    for g, w in zip(got, want):
        assert [r.model_dump() for r in g.results] == [
            r.model_dump() for r in w.results
        ]
    assert any(r.count for r in got)


def test_grouped_rerank_scores_match_jax(setup):
    _, _, rerank_dir = setup
    jax_client = JaxReranker(
        str(rerank_dir), model_dir=rerank_dir, dtype="float32", max_length=256
    )
    port_client = RerankerClient(
        str(rerank_dir), model_dir=rerank_dir, dtype=torch.float32,
        max_length=256, device="cpu",
    )
    queries = ["nat add comm", "list map"]
    docs = [
        ["Nat.add_comm: the sum of two numbers", "List.map: applies a function", "x"],
        ["List.map: applies a function to each element"],
    ]
    want = jax_client.rerank_grouped_sync(queries, docs)
    got = port_client.rerank_grouped_sync(queries, docs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5)


def test_get_by_id_and_warmup(setup):
    service = _torch_service(*setup)
    assert asyncio.run(service.get_by_id(3)).id == 3
    assert asyncio.run(service.get_by_id(10_000)) is None
    assert asyncio.run(service.warmup(batch=2)) >= 0


def test_default_device_needs_cuda(setup, monkeypatch):
    """Entry points run on CUDA unless asked for the CPU, and never fall
    back quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SearchEngine(setup[0])


def test_get_by_name_matches_jax(setup):
    jax_engine = _jax_service(*setup).engine
    engine = _torch_service(*setup).engine
    name = engine.store.get_by_id(5).name
    for query in (name, "No.such.name"):
        want = asyncio.run(jax_engine.get_by_name(query))
        got = asyncio.run(engine.get_by_name(query))
        assert (got is None) == (want is None)
        if got is not None:
            assert got.model_dump() == want.model_dump() and got.name == name


def test_use_local_data_resolves_as_jax(setup, tmp_path, monkeypatch):
    """``use_local_data`` opens Config.ACTIVE_DATA_PATH, resolved as JAX's:
    a data directory holding declarations.db, else its newest complete
    timestamped extraction (an incomplete newer one skipped), else
    ``<data>/<version>``."""
    import shutil

    from lean_explore_tpu import config as jax_config
    from lean_explore_tpu_torch import config as port_config

    data, embed_dir, rerank_dir = setup
    root = tmp_path / "data"
    shutil.copytree(data, root / "20260101_000000")
    (root / "20260202_000000").mkdir()
    (root / "20260202_000000" / "declarations.db").write_bytes(b"")
    (root / "notes").mkdir()
    resolved = port_config._resolve_active_data_path(root, "v9")
    assert resolved == jax_config._resolve_active_data_path(root, "v9")
    assert resolved == root / "20260101_000000"
    for directory in (data, tmp_path / "empty"):
        assert port_config._resolve_active_data_path(
            directory, "v9"
        ) == jax_config._resolve_active_data_path(directory, "v9")
    monkeypatch.setattr(jax_config.Config, "ACTIVE_DATA_PATH", resolved)
    monkeypatch.setattr(port_config.Config, "ACTIVE_DATA_PATH", resolved)
    jax_service = _jax_service(None, embed_dir, rerank_dir, use_local_data=True)
    service = _torch_service(None, embed_dir, rerank_dir, use_local_data=True)
    assert service.engine.data_dir == jax_service.engine.data_dir == resolved
    want = asyncio.run(jax_service.search_batch(QUERIES[:3], rerank_top=0))
    got = asyncio.run(service.search_batch(QUERIES[:3], rerank_top=0))
    assert [[r.model_dump() for r in g.results] for g in got] == [
        [r.model_dump() for r in w.results] for w in want
    ]


NAME_CONFIGS = {
    "bm25_only": dict(dense_k=0, rerank_top=0),
    "dense_only": dict(bm25_k=0, rerank_top=0),
    "hybrid_no_rerank": dict(rerank_top=0),
    "full_pipeline": dict(rerank_top=10),
}


@pytest.fixture(scope="module")
def name_setup(tmp_path_factory):
    """A small index of the committed 20k chain's regime (``make_corpus``
    with its 1,200 concepts, embedded by the JAX package with the committed
    runs/embedder checkpoint at length 64 and packed by its
    ``build_index_artifacts``), both engines on it with the committed
    float32 checkpoints (embedder length 64, reranker 128, as
    scripts/eval_query_classes.py serves them), and the three name classes
    of ``make_name_queries``."""
    from lean_explore_tpu_torch.train.synthetic import make_corpus, make_name_queries

    runs = REPO / "runs"
    embed_dir, rerank_dir = runs / "embedder" / "checkpoint", runs / "reranker" / "checkpoint"
    corpus = make_corpus(n_decls=150, n_concepts=1200, n_eval=8, seed=0)
    data = tmp_path_factory.mktemp("torch_engine_names")
    jax_embedder = JaxEmbedder(str(embed_dir), model_dir=embed_dir, max_length=64, dtype="float32")
    vecs = jax_embedder.embed_sync([d.informalization for d in corpus.declarations])
    store = DeclarationStore(data / "declarations.db", create=True)
    store.insert_many([
        Declaration(
            name=d.name, module=d.module, source_text=d.source_text,
            source_link=d.source_link, dependencies=d.dependencies,
            informalization=d.informalization, informalization_embedding=v.tolist(),
        )
        for d, v in zip(corpus.declarations, vecs)
    ])
    build_index_artifacts(store, data)
    store.close()
    jax_engine = JaxEngine(
        data, embedding_client=jax_embedder, dense_dtype="float32",
        reranker_client=JaxReranker(
            str(rerank_dir), model_dir=rerank_dir, dtype="float32", max_length=128
        ),
    )
    engine = SearchEngine(
        data, dense_dtype="float32", device="cpu",
        embedding_client=EmbeddingClient(
            str(embed_dir), model_dir=embed_dir, max_length=64, dtype=torch.float32,
            device="cpu",
        ),
        reranker_client=RerankerClient(
            str(rerank_dir), model_dir=rerank_dir, max_length=128, dtype=torch.float32,
            device="cpu",
        ),
    )
    classes = make_name_queries(corpus, np.random.default_rng(3), n_per_class=6)
    return jax_engine, engine, classes


@pytest.mark.parametrize("config", list(NAME_CONFIGS))
@pytest.mark.parametrize("qclass", ["name_exact", "name_fragment", "name_typo"])
def test_name_queries_same_results_as_jax(name_setup, qclass, config):
    """Name search, the reference's headline use case: exact dotted names
    (the raw BM25 index), spaced name fragments (the spaced index) and
    names with one typo (the fuzzy-name boost), in each engine
    configuration of scripts/eval_query_classes.py, give the JAX engine's
    results: the same ids in the same order and the same payloads."""
    jax_engine, engine, classes = name_setup
    queries = [q for q, _ in classes[qclass]]
    want = asyncio.run(jax_engine.search_batch(queries, limit=10, **NAME_CONFIGS[config]))
    got = asyncio.run(engine.search_batch(queries, limit=10, **NAME_CONFIGS[config]))
    assert [[r.model_dump() for r in g] for g in got] == [
        [r.model_dump() for r in w] for w in want
    ]
    if config != "dense_only":
        hits = sum(g[0].name == t for g, (_, t) in zip(got, classes[qclass]) if g)
        assert hits >= len(queries) - 1, (qclass, config, hits)
