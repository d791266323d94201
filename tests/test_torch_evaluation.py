"""Quality evaluation through both packages on one rebuilt index, on the CPU.

A small corpus of the 200k chain's regime (``make_corpus`` with its
6,000 concepts and seed, 5 body sentences) is embedded through the port's
index-build path with the committed ``runs/scale200k`` embedder in float32
and packed by the port's ``build_indices``. The JAX and the port engines,
each with its own float32 clients on the committed checkpoints, then
evaluate the held-out queries on that one artifact directory:
``evaluate_engine`` must give equal recall@1, recall@10 and MRR@10, and
``search_batch`` the same top-1 name for every query, with the full
rerank and under a cascade arm (LEAN_EXPLORE_RERANK_CASCADE=24,8, the
chain's point on the coverage cliff; at rerank_top 20 it prunes 12 of 20).
The JAX embedding stage's rows agree with the port's within the trunk
tolerance of tests/test_torch_qwen3.py (1e-5).
"""

import asyncio
import importlib.util
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from lean_explore_tpu import evaluation as jax_evaluation
from lean_explore_tpu.extract.embeddings import generate_embeddings as jax_generate
from lean_explore_tpu.models import DeclarationStore as JaxStore
from lean_explore_tpu.models.tokenizer import unk_fraction as jax_unk_fraction
from lean_explore_tpu.search.engine import SearchEngine as JaxEngine
from lean_explore_tpu.util.embedding_client import EmbeddingClient as JaxEmbedder
from lean_explore_tpu.util.reranker_client import RerankerClient as JaxReranker
from lean_explore_tpu_torch import evaluation
from lean_explore_tpu_torch.extract.embeddings import generate_embeddings
from lean_explore_tpu_torch.extract.index import build_indices
from lean_explore_tpu_torch.models.store import Declaration, DeclarationStore
from lean_explore_tpu_torch.models.tokenizer import unk_fraction
from lean_explore_tpu_torch.search.engine import SearchEngine
from lean_explore_tpu_torch.train.synthetic import make_corpus
from lean_explore_tpu_torch.util.embedding_client import EmbeddingClient
from lean_explore_tpu_torch.util.reranker_client import RerankerClient

REPO = Path(__file__).resolve().parent.parent
CHAIN = REPO / "runs" / "scale200k"
EMBEDDER, RERANKER = CHAIN / "embedder" / "checkpoint", CHAIN / "reranker" / "checkpoint"
# The chain's serving lengths (docs/training.md, runs/scale200k/trunc_probe.json).
EMB_MAX_LENGTH, RR_MAX_LENGTH = 128, 192
RERANK_TOP = 20
CASCADE_POINT = "24,8"


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_eval")
    corpus = make_corpus(
        n_decls=150, n_concepts=6000, n_eval=16, seed=0, body_sentences=5
    )
    port_embedder = EmbeddingClient(
        str(EMBEDDER), max_length=EMB_MAX_LENGTH, dtype=torch.float32, device="cpu"
    )
    jax_embedder = JaxEmbedder(
        str(EMBEDDER), model_dir=EMBEDDER, max_length=EMB_MAX_LENGTH, dtype="float32"
    )
    (root / "store").mkdir()
    store = DeclarationStore(root / "store" / "declarations.db", create=True)
    store.insert_many(corpus.declarations)
    evaluation.guard_store_vocab(store, port_embedder.tokenizer)
    shutil.copy(store.path, root / "jax.db")
    assert generate_embeddings(store, client=port_embedder, use_cache=False) == 150
    build_indices(store, root / "index")
    store.close()
    return corpus, root, port_embedder, jax_embedder


def _embeddings(store) -> np.ndarray:
    return np.stack([d.informalization_embedding for d in store.iter_all()])


def test_jax_embedding_stage_agrees(chain):
    _, root, _, jax_embedder = chain
    with JaxStore(root / "jax.db") as jax_store:
        jax_generate(jax_store, client=jax_embedder, use_cache=False)
        want = _embeddings(jax_store)
    with DeclarationStore(root / "index" / "declarations.db") as port_store:
        got = _embeddings(port_store)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.fixture(scope="module")
def jax_engine(chain):
    _, root, _, jax_embedder = chain
    return JaxEngine(
        root / "index", embedding_client=jax_embedder, dense_dtype="float32",
        reranker_client=JaxReranker(
            str(RERANKER), model_dir=RERANKER, max_length=RR_MAX_LENGTH, dtype="float32"
        ),
    )


@pytest.fixture(scope="module")
def jax_metrics(chain, jax_engine):
    return jax_evaluation.evaluate_engine(
        jax_engine, chain[0].eval_queries, rerank_top=RERANK_TOP, batch=8
    )


@pytest.fixture(scope="module")
def jax_cascade_metrics(chain, jax_engine):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LEAN_EXPLORE_RERANK_CASCADE", CASCADE_POINT)
        return jax_evaluation.evaluate_engine(
            jax_engine, chain[0].eval_queries, rerank_top=RERANK_TOP, batch=8
        )


def test_evaluate_engine_same_metrics_under_a_cascade_arm(
    chain, jax_cascade_metrics, monkeypatch
):
    corpus, root, port_embedder, _ = chain
    reranker = RerankerClient(
        str(RERANKER), max_length=RR_MAX_LENGTH, dtype=torch.float32, device="cpu"
    )
    port = SearchEngine(
        root / "index", embedding_client=port_embedder, dense_dtype="float32",
        device="cpu", reranker_client=reranker,
    )
    keeps = []
    cascade = reranker.rerank_grouped_cascade_sync
    monkeypatch.setattr(
        reranker, "rerank_grouped_cascade_sync",
        lambda q, d, **kw: keeps.append(kw) or cascade(q, d, **kw),
    )
    monkeypatch.setenv("LEAN_EXPLORE_RERANK_CASCADE", CASCADE_POINT)
    got = evaluation.evaluate_engine(port, corpus.eval_queries, rerank_top=RERANK_TOP, batch=8)
    assert got == jax_cascade_metrics
    assert keeps and all(kw == dict(stage1_doc_tokens=24, keep=8) for kw in keeps)


def test_evaluate_engine_same_metrics_and_top1_as_jax(chain, jax_engine, jax_metrics):
    corpus, root, port_embedder, _ = chain
    port = SearchEngine(
        root / "index", embedding_client=port_embedder, dense_dtype="float32",
        device="cpu",
        reranker_client=RerankerClient(
            str(RERANKER), max_length=RR_MAX_LENGTH, dtype=torch.float32, device="cpu"
        ),
    )
    labeled = corpus.eval_queries
    got = evaluation.evaluate_engine(port, labeled, rerank_top=RERANK_TOP, batch=8)
    assert got == jax_metrics
    assert got["n_queries"] == 16 and got["recall_at_10"] > 0.5

    queries = [q for q, _ in labeled]
    port_top = asyncio.run(port.search_batch(queries, limit=1, rerank_top=RERANK_TOP))
    jax_top = asyncio.run(jax_engine.search_batch(queries, limit=1, rerank_top=RERANK_TOP))
    assert [r[0].name for r in port_top] == [r[0].name for r in jax_top]


def test_eval_script_gives_jax_s_metrics_on_the_cpu(jax_metrics, jax_cascade_metrics):
    """scripts/eval_torch_quality.py rebuilds the same corpus through the
    port (store, embed, build_indices, load) and measures the JAX engine's
    numbers, with the full rerank and under the cascade point."""
    spec = importlib.util.spec_from_file_location(
        "eval_torch_quality", REPO / "scripts" / "eval_torch_quality.py"
    )
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    report = script.main([
        "--embedder", str(EMBEDDER), "--reranker", str(RERANKER),
        "--n-decls", "150", "--n-concepts", "6000", "--n-eval", "16",
        "--body-sentences", "5", "--emb-max-length", str(EMB_MAX_LENGTH),
        "--rr-max-length", str(RR_MAX_LENGTH), "--rerank-top", str(RERANK_TOP),
        "--device", "cpu", "--points", CASCADE_POINT,
    ])
    assert report["results"]["full_pipeline"] == jax_metrics
    assert report["results"]["cascade_24_8"] == jax_cascade_metrics
    assert "LEAN_EXPLORE_RERANK_CASCADE" not in os.environ
    assert report["task"]["emb_max_length"] == EMB_MAX_LENGTH
    assert report["task"]["rr_max_length"] == RR_MAX_LENGTH
    assert {"store", "embed", "embed_docs_per_s", "build", "load", "eval"} <= set(
        report["seconds"]
    )


def _store(path, texts) -> DeclarationStore:
    s = DeclarationStore(path, create=True)
    s.insert_many([
        Declaration(name=f"A.d{i}", module="A", source_text="x", source_link="l",
                    informalization=t)
        for i, t in enumerate(texts)
    ])
    return s


def test_guard_store_vocab_raises_on_a_mismatched_store(chain, tmp_path):
    _, _, port_embedder, jax_embedder = chain
    texts = ["zq xv wj ky", "the qqq of a zzz", "plain words of nothing"]
    with _store(tmp_path / "bad.db", texts) as s:
        with pytest.raises(SystemExit, match="vocabulary mismatch"):
            evaluation.guard_store_vocab(s, port_embedder.tokenizer)
        with pytest.raises(SystemExit, match="vocabulary mismatch"):
            jax_evaluation.guard_store_vocab(s, jax_embedder.tokenizer)
    assert unk_fraction(port_embedder.tokenizer, texts) == jax_unk_fraction(
        jax_embedder.tokenizer, texts
    )


def test_guard_skips_declarations_without_informalization(chain, tmp_path):
    """The kept divergence (ROADMAP C): the port's guard samples only rows
    that have an informalization; the JAX guard hands None to the
    tokenizer and fails."""
    corpus, _, port_embedder, jax_embedder = chain
    texts = [None, None, *(d.informalization for d in corpus.declarations[:5])]
    with _store(tmp_path / "partial.db", texts) as s:
        evaluation.guard_store_vocab(s, port_embedder.tokenizer)
        with pytest.raises((TypeError, ValueError)):
            jax_evaluation.guard_store_vocab(s, jax_embedder.tokenizer)
    with _store(tmp_path / "none.db", [None, None]) as s:
        evaluation.guard_store_vocab(s, port_embedder.tokenizer)  # nothing to sample


def test_chip_smoke_holds_phase_6_to_the_committed_record():
    """chip_smoke.py's phase 6 compares against the committed JAX numbers
    and corpus of the 200k chain, which the chip copy leaves out."""
    import chip_smoke

    record = json.loads((CHAIN / "cascade_eval.json").read_text())
    full = record["results"]["full_pipeline"]
    assert chip_smoke.CHAIN_REFERENCE == {
        k: full[k] for k in ("recall_at_1", "recall_at_10", "mrr_at_10")
    }
    task = json.loads((CHAIN / "embedder" / "eval.json").read_text())["task"]
    corpus = chip_smoke.CHAIN_CORPUS
    assert (corpus["n_decls"], corpus["n_concepts"], corpus["body_sentences"]) == (
        task["n_decls"], task["n_concepts"], task["body_sentences"]
    ) == (record["task"]["n_decls"], 6000, record["task"]["body_sentences"])
    assert corpus["n_eval"] == full["n_queries"] == record["task"]["n_eval"]
    top50 = json.loads((CHAIN / "rerank_top_eval.json").read_text())["results"]["top50"]
    assert chip_smoke.CHAIN_RERANK_TOP == 50
    assert {k: top50[k] for k in chip_smoke.CHAIN_REFERENCE} == chip_smoke.CHAIN_REFERENCE
    assert chip_smoke.CHAIN_RR_MAX_LENGTH == json.loads(
        (CHAIN / "trunc_probe.json").read_text()
    )["task"]["max_length"]
    assert (chip_smoke.CHAIN_EMB_MAX_LENGTH, chip_smoke.CHAIN_RR_MAX_LENGTH) == (
        EMB_MAX_LENGTH, RR_MAX_LENGTH
    )
    assert chip_smoke.chain_checkpoints(REPO) == (EMBEDDER, RERANKER)
    with pytest.raises(FileNotFoundError, match="committed checkpoint"):
        chip_smoke.chain_checkpoints(REPO / "no_such_dir")


def test_chip_smoke_holds_the_cascade_arms_to_the_committed_record():
    """Phase 6's cascade arms: the points of the committed record, each held
    to its own row."""
    import chip_smoke

    rows = json.loads((CHAIN / "cascade_eval.json").read_text())["results"]
    assert chip_smoke.CHAIN_CASCADE_POINTS == ("48,16", "48,25", "24,8")
    assert chip_smoke.CHAIN_CASCADE_REFERENCE == {
        f"cascade_{p.replace(',', '_')}": {
            k: rows[f"cascade_{p.replace(',', '_')}"][k] for k in chip_smoke.CHAIN_REFERENCE
        }
        for p in chip_smoke.CHAIN_CASCADE_POINTS
    }
    assert set(chip_smoke.CHAIN_CASCADE_REFERENCE) | {"full_pipeline"} == set(rows)
    cliff = json.loads((REPO / chip_smoke.CHAIN_CLIFF).read_text())
    assert chip_smoke.CHAIN_DIVERGENT_ARM == f"cascade_{cliff['point'].replace(',', '_')}"
    assert (cliff["cap"], cliff["keep"], cliff["rr_max_length"]) == (24, 8, RR_MAX_LENGTH)


@pytest.mark.parametrize("points", [["48"], ["0,8"], ["a,b"], ["48,25", "4,-1"]])
def test_eval_script_rejects_a_bad_point_at_once(points):
    spec = importlib.util.spec_from_file_location(
        "eval_torch_quality", REPO / "scripts" / "eval_torch_quality.py"
    )
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    with pytest.raises(SystemExit, match="must be '<cap>,<keep>' positive ints"):
        script.parse_args(["--points", *points])


def test_evaluate_engine_needs_labeled_pairs():
    with pytest.raises(ValueError, match="eval split is empty"):
        evaluation.evaluate_engine(object(), [])
