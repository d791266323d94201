"""The port's index build (index.artifacts.build_index_artifacts,
DenseIndex.save, extract.embeddings, extract.index and the extract CLI)
against the JAX package on the same store, on the CPU.

The artifact files do not depend on the framework: from one store both
packages write byte-identical ``.npy`` and ``.npz`` files and manifests
equal apart from ``created_unix``, and each package loads the other's.
The embedding stage writes exactly the rows its client's ``embed_sync``
gives, and the JAX stage's within the trunk tolerance of
tests/test_torch_qwen3.py (1e-5).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from lean_explore_tpu.extract.embeddings import generate_embeddings as jax_generate
from lean_explore_tpu.index import build_index_artifacts as jax_build
from lean_explore_tpu.index import load_index_artifacts as jax_load
from lean_explore_tpu.index.dense import DenseIndex as JaxDenseIndex
from lean_explore_tpu.models import DeclarationStore as JaxStore
from lean_explore_tpu.util.embedding_client import EmbeddingClient as JaxEmbedder
from lean_explore_tpu_torch.config import Config, is_complete_index
from lean_explore_tpu_torch.extract import __main__ as cli
from lean_explore_tpu_torch.extract.embeddings import generate_embeddings
from lean_explore_tpu_torch.extract.index import build_indices
from lean_explore_tpu_torch.index.artifacts import (
    build_index_artifacts,
    load_index_artifacts,
)
from lean_explore_tpu_torch.index.dense import DenseIndex
from lean_explore_tpu_torch.models.store import Declaration, DeclarationStore
from lean_explore_tpu_torch.train.synthetic import make_corpus
from lean_explore_tpu_torch.util.embedding_client import EmbeddingClient
from tests.extract.test_pipeline_e2e import FakeOpenRouter, lean_root  # noqa: F401
from tests.helpers import make_tiny_model_dir
from tests.test_torch_extract import fake_doc_gen4

ARTIFACT_FILES = (
    "dense_embeddings.npy", "dense_ids.npy", "bm25_name_spaced.npz",
    "bm25_name_raw.npz", "bm25_ids.npy",
)
# Words of the tiny checkpoints' vocabulary (tests/helpers.py), so the
# embedding stage reads real tokens.
TEXTS = [
    "the sum of two natural numbers", "list map applies a function",
    "prime numbers", "continuous function", "addition is commutative",
    "multiplication applies to each element", "nat add comm", "list map",
]


def _declarations(n: int, dim: int, *, embedded=True) -> list[Declaration]:
    """A small synthetic corpus with explicit ids (not from 1), random
    embeddings on two rows of three, and one row with no informalization."""
    rng = np.random.default_rng(4)
    decls = make_corpus(n_decls=n, n_concepts=max(12, n // 3), n_eval=4).declarations
    out = []
    for i, d in enumerate(decls):
        vec = rng.standard_normal(dim).astype(np.float32) * (1 + i % 4)
        out.append(dataclasses.replace(
            d,
            id=3 * i + 5,
            informalization=None if i == 7 else d.informalization,
            informalization_embedding=vec.tolist() if embedded and i % 3 else None,
        ))
    return out


@pytest.fixture()
def store(tmp_path):
    (tmp_path / "src").mkdir()
    s = DeclarationStore(tmp_path / "src" / "declarations.db", create=True)
    s.insert_many(_declarations(40, 24))
    yield s
    s.close()


def _manifest(directory) -> dict:
    manifest = json.loads((directory / "manifest.json").read_text())
    assert isinstance(manifest.pop("created_unix"), int)
    return manifest


def test_artifacts_are_jax_s_byte_for_byte(store, tmp_path):
    got = build_index_artifacts(store, tmp_path / "port")
    jax_store = JaxStore(store.path)
    want = jax_build(jax_store, tmp_path / "jax")
    jax_store.close()
    for name in ARTIFACT_FILES:
        assert (tmp_path / "port" / name).read_bytes() == (
            tmp_path / "jax" / name
        ).read_bytes(), name
    assert _manifest(tmp_path / "port") == _manifest(tmp_path / "jax")
    got.pop("created_unix"), want.pop("created_unix")
    assert got == want
    assert (got["n_declarations"], got["n_embedded"], got["embedding_dim"]) == (40, 26, 24)


def test_empty_dense_index_is_jax_s(tmp_path):
    path = tmp_path / "src" / "declarations.db"
    path.parent.mkdir()
    with DeclarationStore(path, create=True) as s:
        s.insert_many(_declarations(10, 8, embedded=False))
        build_index_artifacts(s, tmp_path / "port", embedding_dim=8)
    with JaxStore(path) as s:
        jax_build(s, tmp_path / "jax", embedding_dim=8)
    for name in ARTIFACT_FILES:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert _manifest(tmp_path / "port") == _manifest(tmp_path / "jax")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_dense_save_equals_jax(dtype, tmp_path):
    rng = np.random.default_rng(8)
    mat = rng.standard_normal((700, 32)).astype(np.float32)  # pads to 1024 rows
    ids = rng.permutation(5000)[:700]
    DenseIndex.build(mat, ids, dtype=dtype, device="cpu").save(tmp_path / "port")
    JaxDenseIndex.build(mat, ids, dtype=dtype).save(tmp_path / "jax")
    for name in ("dense_embeddings.npy", "dense_ids.npy"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    saved = np.load(tmp_path / "port" / "dense_embeddings.npy")
    assert saved.dtype == np.float32 and saved.shape == (700, 32)


def test_each_package_loads_the_other_s_artifacts(store, tmp_path):
    build_index_artifacts(store, tmp_path / "port")
    with JaxStore(store.path) as jax_store:
        jax_build(jax_store, tmp_path / "jax")
    for built_by in ("port", "jax"):
        directory = tmp_path / built_by
        port = load_index_artifacts(directory, device="cpu")
        jax = jax_load(directory, mesh=False)
        np.testing.assert_array_equal(port.dense.row_embeddings(), np.asarray(jax.dense.embeddings)[: jax.dense.n])
        np.testing.assert_array_equal(port.dense.ids, jax.dense.ids)
        np.testing.assert_array_equal(port.bm25_ids, jax.bm25_ids)
        for name in ("bm25_spaced", "bm25_raw"):
            p, j = getattr(port, name), getattr(jax, name)
            assert p.vocab == j.vocab
            for field in ("indptr", "doc_indices", "tf_values", "doc_lengths"):
                np.testing.assert_array_equal(getattr(p, field), getattr(j, field))
        assert port.manifest == jax.manifest


@pytest.fixture(scope="module")
def tiny_embedder(tmp_path_factory):
    return make_tiny_model_dir(tmp_path_factory.mktemp("tiny") / "embedder", seed=2)


def _text_store(path, texts, start_id=1) -> DeclarationStore:
    path.parent.mkdir(parents=True, exist_ok=True)
    s = DeclarationStore(path, create=True)
    s.insert_many([
        Declaration(id=start_id + i, name=f"Pkg.decl{i}", module="Pkg", source_text="x",
                    source_link="l", informalization=t)
        for i, t in enumerate(texts)
    ])
    return s


def _embeddings(store) -> dict[int, np.ndarray]:
    return {
        d.id: np.asarray(d.informalization_embedding, dtype=np.float32)
        for d in store.iter_embedded()
    }


def test_generate_embeddings_writes_embed_sync_rows(tiny_embedder, tmp_path):
    client = EmbeddingClient(str(tiny_embedder), dtype=torch.float32, device="cpu",
                             max_length=32)
    with _text_store(tmp_path / "a.db", TEXTS) as s:
        assert generate_embeddings(s, client=client, batch_size=3, use_cache=False, limit=5) == 5
        assert len(_embeddings(s)) == 5
        assert generate_embeddings(s, client=client, batch_size=3, use_cache=False) == 3
        assert generate_embeddings(s, client=client, use_cache=False) == 0
        got = _embeddings(s)
    want = client.embed_sync(TEXTS)
    np.testing.assert_array_equal(np.stack([got[i + 1] for i in range(len(TEXTS))]), want)

    jax_client = JaxEmbedder(str(tiny_embedder), model_dir=tiny_embedder, max_length=32,
                             dtype="float32")
    with _text_store(tmp_path / "b.db", TEXTS) as s:
        jax_generate(s, client=jax_client, batch_size=3, use_cache=False)
        jax_rows = _embeddings(s)
    np.testing.assert_allclose(
        np.stack([jax_rows[i + 1] for i in range(len(TEXTS))]), want, atol=1e-5
    )


class _Recorder:
    def __init__(self, dim):
        self.dim, self.seen = dim, []

    def embed_sync(self, texts):
        self.seen.extend(texts)
        return np.full((len(texts), self.dim), 7.0, dtype=np.float32)


def test_generate_embeddings_reuses_the_cache(tmp_path, monkeypatch):
    data = tmp_path / "data"
    monkeypatch.setattr(Config, "DATA_DIRECTORY", data)
    monkeypatch.setattr(Config, "CACHE_DIRECTORY", tmp_path / "cache")
    prior = _text_store(data / "20260101_000000" / "declarations.db", TEXTS[:4])
    cached = {i + 1: np.arange(4, dtype=np.float32) + i for i in range(4)}
    prior.set_embeddings(list(cached.items()))
    prior.close()
    recorder = _Recorder(4)
    with _text_store(tmp_path / "new.db", TEXTS[2:], start_id=50) as s:
        assert generate_embeddings(s, client=recorder, batch_size=2) == len(TEXTS) - 2
        got = _embeddings(s)
    assert recorder.seen == TEXTS[4:]
    for j, text in enumerate(TEXTS[2:]):
        i = TEXTS.index(text)
        want = cached[i + 1] if i < 4 else np.full(4, 7.0, np.float32)
        np.testing.assert_array_equal(got[50 + j], want)


def test_build_indices_copies_the_database(store, tmp_path):
    out = tmp_path / "artifacts"
    manifest = build_indices(store, out)
    assert is_complete_index(out)
    assert (out / "declarations.db").read_bytes() == (tmp_path / "src" / "declarations.db").read_bytes()
    assert manifest["n_declarations"] == 40
    assert build_indices(store, tmp_path / "src")["n_declarations"] == 40  # in place: no copy


def test_cli_embeds_and_indexes_the_latest_extraction(tiny_embedder, tmp_path, monkeypatch):
    data = tmp_path / "data"
    monkeypatch.setattr(Config, "DATA_DIRECTORY", data)
    monkeypatch.setattr(Config, "CACHE_DIRECTORY", tmp_path / "cache")
    monkeypatch.setattr(Config, "EMBEDDING_MODEL_NAME", str(tiny_embedder))
    monkeypatch.setattr(Config, "EMBEDDING_MAX_LENGTH", 32)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert cli.main(["--embed", "--index", "--use-latest"]) == 1  # nothing to reuse yet
    older = data / "20250101_000000"
    older.mkdir(parents=True)
    _text_store(data / "20260101_000000" / "declarations.db", TEXTS).close()
    assert cli.main(["--embed", "--index", "--use-latest", "--batch-size", "3"]) == 0
    latest = Config.get_latest_extraction_path()
    assert latest.name == "20260101_000000"
    assert is_complete_index(latest) and not is_complete_index(older)
    assert Config.get_latest_database_path() == latest / "declarations.db"
    artifacts = load_index_artifacts(latest, device="cpu")
    client = EmbeddingClient(str(tiny_embedder), max_length=32, device="cpu")
    want = client.embed_sync(TEXTS)
    want /= np.linalg.norm(want, axis=1, keepdims=True)
    np.testing.assert_array_equal(artifacts.dense.row_embeddings(), want)
    assert artifacts.manifest["n_embedded"] == len(TEXTS)


@pytest.mark.parametrize(
    "argv", [[], ["--run-doc-gen4"], ["--parse", "--embed"], ["--informalize"]]
)
def test_cli_runs_the_stages_it_is_given(argv, lean_root, tiny_embedder, tmp_path, monkeypatch):
    """The CLI on tests/extract/test_pipeline_e2e.py's fake lean root, with
    doc-gen4's subprocess layer faked and a stand-in for the OpenRouter
    client: every stage without flags (Lake's commands, three parsed,
    informalized and embedded declarations, a complete index), else only
    the stages named."""
    from lean_explore_tpu_torch.extract import doc_gen4, doc_parser, packages
    from lean_explore_tpu_torch.util import openrouter_client

    monkeypatch.setattr(Config, "DATA_DIRECTORY", tmp_path / "data")
    monkeypatch.setattr(Config, "CACHE_DIRECTORY", tmp_path / "cache")
    monkeypatch.setattr(Config, "PACKAGES_ROOT", lean_root)
    monkeypatch.setattr(Config, "EMBEDDING_MODEL_NAME", str(tiny_embedder))
    monkeypatch.setattr(Config, "EMBEDDING_MAX_LENGTH", 32)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    for module in (packages, doc_parser, doc_gen4):
        monkeypatch.setattr(module, "get_extraction_order", lambda: ["mathlib"])
    lake = fake_doc_gen4(monkeypatch, doc_gen4)
    llm = FakeOpenRouter()
    monkeypatch.setattr(openrouter_client, "OpenRouterClient", lambda: llm)

    assert cli.main(argv) == 0
    (extraction,) = (tmp_path / "data").iterdir()
    with DeclarationStore(extraction / "declarations.db") as store:
        rows = list(store.iter_all())
    ran = {"docgen": bool(lake.calls), "parse": bool(rows), "informalize": llm.calls > 0,
           "embed": any(r.informalization_embedding for r in rows),
           "index": is_complete_index(extraction)}
    want = {
        (): dict.fromkeys(ran, True),
        ("--run-doc-gen4",): dict.fromkeys(ran, False) | {"docgen": True},
        ("--parse", "--embed"): dict.fromkeys(ran, False) | {"parse": True},
        ("--informalize",): dict.fromkeys(ran, False),
    }[tuple(argv)]
    assert ran == want
    if not argv:
        assert ("run", ("lake", "update"), "mathlib") in lake.calls
        assert len(rows) == llm.calls == 3
        assert all(r.informalization.startswith("**The ") for r in rows)


def test_multi_device_embed_mesh_raises(store, monkeypatch):
    monkeypatch.setattr(Config, "MESH_SHAPE", "1,2")
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        generate_embeddings(store, use_cache=False)
    monkeypatch.setattr(Config, "MESH_SHAPE", "1")
    assert Config.mesh_shape() == (1, 1)


def test_default_device_needs_cuda(store, tiny_embedder, tmp_path, monkeypatch):
    """The embed stage, the artifact load and the CLI run on CUDA unless
    asked for the CPU, and never fall back quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with _text_store(tmp_path / "t.db", TEXTS) as s:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            generate_embeddings(s, model_name=str(tiny_embedder), use_cache=False)
    build_index_artifacts(store, tmp_path / "art")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_index_artifacts(tmp_path / "art")
    monkeypatch.setattr(Config, "DATA_DIRECTORY", tmp_path / "data")
    monkeypatch.setattr(Config, "CACHE_DIRECTORY", tmp_path / "cache")
    monkeypatch.setattr(Config, "EMBEDDING_MODEL_NAME", str(tiny_embedder))
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.delenv("XLA_FLAGS", raising=False)
    _text_store(tmp_path / "data" / "20260101_000000" / "declarations.db", TEXTS).close()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--embed", "--use-latest"])
