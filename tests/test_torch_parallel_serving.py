"""Serving on a mesh through the port (``lean_explore_tpu_torch.parallel``)
against the JAX package's mesh (tests/parallel/test_sharded_rerank.py and
test_sharded_serving.py), on the CPU.

JAX runs on the 8 virtual host devices of tests/conftest.py, the port on
8 virtual CPU devices (the same ``XLA_FLAGS`` count). The model clients
load the same tiny float32 checkpoints (``tests.helpers.
make_tiny_model_dir``); both engines read one artifact directory.

Tolerance: scores within 1e-5 in float32, the JAX tests' own (each device
runs the one-device program on its rows; only f32 sum orders differ,
within a few 2^-24 relative through two layers of width 64). Result ids
must be equal and in the same order.

It also pins the fault this mesh repairs: LEAN_EXPLORE_MESH_SHAPE used to
leave the port's serving path on one device without a word. Now it shards
the index and splits both clients' batches, and a shape that needs more
devices than there are raises.
"""

import asyncio
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lean_explore_tpu.config import Config as JaxConfig
from lean_explore_tpu.index import build_index_artifacts
from lean_explore_tpu.index import load_index_artifacts as jax_load_index_artifacts
from lean_explore_tpu.models import Declaration, DeclarationStore
from lean_explore_tpu.models import qwen3 as jq
from lean_explore_tpu.parallel import make_mesh as jax_make_mesh
from lean_explore_tpu.parallel.rerank import (
    make_sharded_grouped_scorer as jax_sharded_scorer,
)
from lean_explore_tpu.parallel.rerank import rerank_data_mesh as jax_rerank_data_mesh
from lean_explore_tpu.parallel.rerank import replicate_params as jax_replicate_params
from lean_explore_tpu.search.engine import SearchEngine as JaxEngine
from lean_explore_tpu.search.service import Service as JaxService
from lean_explore_tpu.util.embedding_client import EmbeddingClient as JaxEmbedder
from lean_explore_tpu.util.reranker_client import RerankerClient as JaxReranker
from lean_explore_tpu_torch.config import Config
from lean_explore_tpu_torch.extract.embeddings import _embed_mesh
from lean_explore_tpu_torch.index.artifacts import load_index_artifacts
from lean_explore_tpu_torch.index.dense import DenseIndex
from lean_explore_tpu_torch.models import hf_loader
from lean_explore_tpu_torch.models import qwen3 as tq
from lean_explore_tpu_torch.models.store import DeclarationStore as TorchStore
from lean_explore_tpu_torch.parallel import (
    SERVE_AXES,
    ShardedDenseIndex,
    make_mesh,
    make_sharded_grouped_scorer,
    rerank_data_mesh,
    replicate_params,
    serve_mesh_from_config,
)
from lean_explore_tpu_torch.search.engine import SearchEngine
from lean_explore_tpu_torch.search.service import Service
from lean_explore_tpu_torch.util.embedding_client import EmbeddingClient
from lean_explore_tpu_torch.util.reranker_client import RerankerClient
from tests.helpers import make_tiny_model_dir

ATOL = 1e-5
TOKEN_TRUE, TOKEN_FALSE = 3, 4
QUERIES = ["nat add comm", "list map", "prime numbers", "the sum"]
DOCS = [
    ["the sum of two natural numbers", "continuous function map", "prime numbers of a b"],
    ["function map of a list", "the sum of two numbers"],
    ["prime numbers of a b", "nat add of two", "continuous prime function",
     "list map function"],
    ["the sum of two", "addition of natural numbers"],
]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return make_tiny_model_dir(tmp_path_factory.mktemp("mesh") / "m", with_st_prompt=True)


@pytest.fixture
def mesh_shape(monkeypatch):
    """Set LEAN_EXPLORE_MESH_SHAPE's value in both packages' Config."""

    def set_shape(value: str) -> None:
        monkeypatch.setattr(Config, "MESH_SHAPE", value)
        monkeypatch.setattr(JaxConfig, "MESH_SHAPE", value)

    return set_shape


def _grouped_inputs(g=8, d=3, p_len=6, s_len=5, seed=0):
    rng = np.random.default_rng(seed)
    prefix_ids = rng.integers(5, 500, size=(g, p_len)).astype(np.int32)
    prefix_mask = np.ones((g, p_len), dtype=np.int32)
    prefix_mask[1, 4:] = 0
    suffix_ids = rng.integers(5, 500, size=(g, d, s_len)).astype(np.int32)
    suffix_mask = np.ones((g, d, s_len), dtype=np.int32)
    suffix_mask[2, 1, 3:] = 0
    offs = prefix_mask.sum(axis=1).astype(np.int32)
    return prefix_ids, prefix_mask, suffix_ids, suffix_mask, offs


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_dp_scorer_matches_one_device_and_jax(n_devices):
    config = jq.Qwen3Config.tiny()
    jparams = jq.init_params(config, jax.random.PRNGKey(0))
    params = hf_loader.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    tconfig = tq.Qwen3Config.tiny()
    arrays = _grouped_inputs()
    chunk = 8 // n_devices if n_devices < 8 else 1
    kw = dict(token_true=TOKEN_TRUE, token_false=TOKEN_FALSE, group_chunk=chunk)
    p_ids, p_mask, s_ids, s_mask, offs = (torch.from_numpy(a) for a in arrays)
    with torch.no_grad():
        pk, pv = tq.prefix_kv(params, tconfig, p_ids, p_mask)
        want = tq.rerank_scores_grouped(
            params, tconfig, pk, pv, p_mask, s_ids, s_mask, offs, **kw
        ).numpy()
    mesh = rerank_data_mesh(devices=[torch.device("cpu")] * n_devices)
    assert mesh.shape == {"data": n_devices}
    replicas = replicate_params(params, mesh)
    assert list(replicas) == [torch.device("cpu")]  # one copy on a repeated device
    got = make_sharded_grouped_scorer(tconfig, mesh, **kw)(replicas, *arrays)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    jmesh = jax_rerank_data_mesh(devices=jax.devices()[:n_devices])
    jax_got = jax_sharded_scorer(config, jmesh, **kw)(
        jax_replicate_params(jparams, jmesh), *arrays
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_got), atol=ATOL)
    with pytest.raises(ValueError, match="not a multiple"):
        make_sharded_grouped_scorer(tconfig, mesh, **kw)(
            replicas, *(a[: n_devices * chunk - 1] for a in arrays)
        )


def _rerankers(ckpt, port_mesh: bool):
    port = RerankerClient(
        str(ckpt), model_dir=ckpt, dtype=torch.float32, device="cpu",
        mesh=rerank_data_mesh() if port_mesh else None,
    )
    jax_client = JaxReranker(
        str(ckpt), model_dir=ckpt, dtype="float32", mesh=jax_rerank_data_mesh()
    )
    return port, jax_client


def test_reranker_client_mesh_matches_no_mesh_and_jax(ckpt):
    plain, jax_client = _rerankers(ckpt, port_mesh=False)
    sharded, _ = _rerankers(ckpt, port_mesh=True)
    assert sharded.mesh.shape == {"data": 8}
    want = plain.rerank_grouped_sync(QUERIES, DOCS)
    got = sharded.rerank_grouped_sync(QUERIES, DOCS)
    jax_got = jax_client.rerank_grouped_sync(QUERIES, DOCS)
    for g_row, w_row, j_row in zip(got, want, jax_got):
        np.testing.assert_allclose(g_row, w_row, atol=ATOL)
        np.testing.assert_allclose(g_row, j_row, atol=ATOL)
    assert set(sharded._sharded_scorers) == {4}  # cached per chunk


def test_cascade_on_mesh_matches_no_mesh_and_jax(ckpt):
    """Both cascade stages run through the data-parallel grouped scorer."""
    plain, jax_client = _rerankers(ckpt, port_mesh=False)
    sharded, _ = _rerankers(ckpt, port_mesh=True)
    queries = ["nat add comm", "list map"]
    docs = [
        ["the sum of two natural numbers and more words here",
         "continuous function map of numbers", "prime numbers of a b",
         "addition of natural numbers the sum"],
        ["function map of a list of many words", "the sum of two numbers",
         "nat add of two", "continuous prime function"],
    ]
    kw = dict(stage1_doc_tokens=4, keep=2)
    want = plain.rerank_grouped_cascade_sync(queries, docs, **kw)
    got = sharded.rerank_grouped_cascade_sync(queries, docs, **kw)
    jax_got = jax_client.rerank_grouped_cascade_sync(queries, docs, **kw)
    for g_row, w_row, j_row in zip(got, want, jax_got):
        np.testing.assert_allclose(g_row, w_row, atol=ATOL)
        np.testing.assert_allclose(g_row, j_row, atol=ATOL)


def test_embedding_client_mesh_matches_one_device_and_jax(ckpt):
    """11 texts in batches of 8 over a (8, 1) mesh: the last batch pads to
    a multiple of the data axis with rows that keep one valid token."""
    texts = [f"nat add {i} the sum of two" for i in range(11)]
    single = EmbeddingClient(str(ckpt), dtype=torch.float32, batch_size=8, device="cpu")
    mesh = make_mesh((8, 1), axis_names=SERVE_AXES)
    sharded = EmbeddingClient(
        str(ckpt), dtype=torch.float32, batch_size=8, device="cpu", mesh=mesh
    )
    assert sharded.batch_size == 8
    assert EmbeddingClient(
        str(ckpt), dtype=torch.float32, batch_size=12, device="cpu", mesh=mesh
    ).batch_size == 8  # rounded down to a multiple of data
    want = single.embed_sync(texts, is_query=True)
    got = sharded.embed_sync(texts, is_query=True)
    assert got.shape == want.shape == (11, 64)
    np.testing.assert_allclose(got, want, atol=ATOL)
    jax_client = JaxEmbedder(
        str(ckpt), dtype="float32", batch_size=8,
        mesh=jax_make_mesh((8, 1), axis_names=("data", "corpus")),
    )
    np.testing.assert_allclose(got, jax_client.embed_sync(texts, is_query=True), atol=ATOL)


@pytest.fixture(scope="module")
def artifact_dir(ckpt, tmp_path_factory):
    """40 declarations embedded by the tiny float32 embedder, indexed by the
    JAX package: JAX's own end-to-end mesh test's set-up, with an
    in-vocabulary word (``extra<i>``) in place of the number that makes each
    text its own, so no two documents score alike and the order of ties
    (which each package breaks its own way) never decides a result."""
    path = tmp_path_factory.mktemp("mesh_arts")
    emb = JaxEmbedder(str(ckpt), dtype="float32")
    store = DeclarationStore(path / "declarations.db", create=True)
    texts = [
        f"**Fact {i}.** the sum of two natural numbers extra{i}"
        if i % 2
        else f"**Fact {i}.** continuous function map of a list extra{i}"
        for i in range(40)
    ]
    store.insert_many([
        Declaration(
            name=f"Nat.fact{i}", module="Nat.Basic", source_text=f"def f{i} := {i}",
            source_link=f"https://x/{i}",
            dependencies=json.dumps([f"Nat.fact{(i + 1) % 40}"]),
            informalization=texts[i], informalization_embedding=None,
        )
        for i in range(40)
    ])
    vecs = emb.embed_sync(texts)
    store.set_embeddings(list(zip(range(1, 41), (v.tolist() for v in vecs))))
    build_index_artifacts(store, path)
    store.close()
    return path


def _port_search(artifact_dir, ckpt, on_mesh: bool, queries, **kw):
    data_mesh = rerank_data_mesh() if on_mesh else None
    engine = SearchEngine(
        artifact_dir,
        store=TorchStore(artifact_dir / "declarations.db"),
        artifacts=load_index_artifacts(artifact_dir, device="cpu", mesh=None if on_mesh else False),
        embedding_client=EmbeddingClient(
            str(ckpt), dtype=torch.float32, device="cpu", mesh=data_mesh
        ),
        reranker_client=RerankerClient(
            str(ckpt), model_dir=ckpt, dtype=torch.float32, device="cpu", mesh=data_mesh
        ),
        device="cpu",
    )
    assert isinstance(engine._artifacts.dense, ShardedDenseIndex if on_mesh else DenseIndex)
    return asyncio.run(Service(engine).search_batch(queries, **kw))


@pytest.mark.parametrize("rerank_top", [8, 0])
def test_search_batch_on_a_2x4_mesh_gives_jax_s_ids(artifact_dir, ckpt, mesh_shape, rerank_top):
    """Service.search_batch with LEAN_EXPLORE_MESH_SHAPE=2,4: the sharded
    index feeds the data-parallel reranker, and the result ids equal the
    JAX engine's on its mesh and the port's on one device."""
    queries = ["sum of natural numbers", "continuous map", "Nat.fact3", ""]
    kw = dict(limit=5, rerank_top=rerank_top)
    mesh_shape("2,4")
    jax_engine = JaxEngine(
        str(artifact_dir),
        store=DeclarationStore(artifact_dir / "declarations.db"),
        artifacts=jax_load_index_artifacts(str(artifact_dir)),
        embedding_client=JaxEmbedder(str(ckpt), dtype="float32"),
        reranker_client=JaxReranker(
            str(ckpt), model_dir=ckpt, dtype="float32", mesh=jax_rerank_data_mesh()
        ),
    )
    want = asyncio.run(JaxService(jax_engine).search_batch(queries, **kw))
    got = _port_search(artifact_dir, ckpt, True, queries, **kw)
    single = _port_search(artifact_dir, ckpt, False, queries, **kw)
    for g, w, s in zip(got, want, single):
        assert [r.id for r in g.results] == [r.id for r in w.results] == [r.id for r in s.results]
        assert g.count == w.count
    assert sum(g.count for g in got) > 0


def test_engine_wires_a_data_mesh_of_8(ckpt, mesh_shape, tmp_path):
    """LEAN_EXPLORE_MESH_SHAPE gives both lazy clients a flat data mesh over
    the serving mesh's devices."""
    mesh_shape("2,4")
    engine = SearchEngine.__new__(SearchEngine)
    engine.device = "cpu"
    engine._reranker_client = None
    engine._reranker_model_name = str(ckpt)
    engine._embedding_client = None
    engine._embedding_model_name = str(ckpt)
    for client in (engine.reranker_client, engine.embedding_client):
        assert client.mesh is not None and client.mesh.shape == {"data": 8}


def test_mesh_shape_now_shards_and_too_large_raises(artifact_dir, ckpt, mesh_shape):
    """The fault repaired: the setting takes effect on every serving path,
    or raises; nothing runs on one device quietly."""
    mesh_shape("")
    assert serve_mesh_from_config("cpu") is None
    assert isinstance(load_index_artifacts(artifact_dir, device="cpu").dense, DenseIndex)
    mesh_shape("2,4")
    mesh = serve_mesh_from_config("cpu")
    assert mesh.shape == {"data": 2, "corpus": 4}
    dense = load_index_artifacts(artifact_dir, device="cpu").dense
    assert isinstance(dense, ShardedDenseIndex) and dense.n == 40
    assert dense.mesh.shape == {"data": 2, "corpus": 4}
    assert isinstance(
        load_index_artifacts(artifact_dir, device="cpu", mesh=False).dense, DenseIndex
    )
    explicit = load_index_artifacts(
        artifact_dir, device="cpu", mesh=make_mesh((1, 8), axis_names=SERVE_AXES)
    ).dense
    assert explicit.mesh.shape == {"data": 1, "corpus": 8}
    mesh_shape("4,4")
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        load_index_artifacts(artifact_dir, device="cpu")
    engine = SearchEngine.__new__(SearchEngine)
    engine.device, engine._reranker_client = "cpu", None
    engine._reranker_model_name = str(ckpt)
    with pytest.raises(ValueError, match="needs 16 devices"):
        engine.reranker_client


def test_int8_sharded_artifacts_match_jax_s(artifact_dir, mesh_shape):
    """An int8 corpus through the artifact loader on the (2, 4) mesh: K2's
    plain twin per shard, JAX's ids and scores within one packing
    quantum."""
    mesh_shape("2,4")
    port = load_index_artifacts(artifact_dir, dense_dtype="int8", device="cpu").dense
    jax_index = jax_load_index_artifacts(str(artifact_dir), dense_dtype="int8").dense
    assert port.method == jax_index.method == "fused_int8"
    q = np.random.default_rng(3).standard_normal((5, 64)).astype(np.float32)
    got_s, got_ids = port.search(q, k=10)
    want_s, want_ids = jax_index.search(jnp.asarray(q), k=10)
    np.testing.assert_array_equal(got_ids, np.asarray(want_ids))
    np.testing.assert_allclose(got_s, np.asarray(want_s), atol=ATOL)


def test_extract_stage_s_embed_mesh(mesh_shape):
    mesh_shape("2,4")
    mesh = _embed_mesh("cpu")
    assert mesh is not None and mesh.shape == {"data": 8, "corpus": 1}
    mesh_shape("")
    assert _embed_mesh("cpu") is None
