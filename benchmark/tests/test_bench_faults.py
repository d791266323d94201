"""A run with the timed path broken underneath has to come out not
correct: one case for each fault a search or index-build cell can have.
(The cells run on one chip, so there is no exchange between chips to
leave out.) The look for a chip is skipped: the run drives the port's CPU
path at the tiny size."""

import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import tiny


def _run(cell_name: str) -> dict:
    import run
    from harness.spec import Spec

    spec = Spec(tiny.ROOT)
    cell = spec.cell(cell_name)
    cfg = tiny.tiny_config(cell["config"])
    run.configure_environment(Path(tempfile.gettempdir()) / "bench_tiny", cfg)
    with tempfile.TemporaryDirectory() as work:
        return run.run_cell(spec, cell, 33, 3.0, False, torch.device("cpu"), Path(work), cfg=cfg,
                            traffic=tiny.tiny_traffic(cell["traffic"]))


def _stale_embeddings(monkeypatch):
    """A step that returns its state unchanged: the encoder answers every
    call after the first with the first call's vectors."""
    from lean_explore_tpu_torch.util.embedding_client import EmbeddingClient

    orig = EmbeddingClient.embed_device
    first = {}

    def stale(self, texts, is_query=False):
        out = orig(self, texts, is_query)
        key = (len(texts), is_query)
        first.setdefault(key, out)
        return first[key]

    monkeypatch.setattr(EmbeddingClient, "embed_device", stale)


def _half_batch(monkeypatch):
    """Half of the batch left out: the engine answers the first half and
    hands each query of the second half the answer of its counterpart."""
    from lean_explore_tpu_torch.search.engine import SearchEngine

    orig = SearchEngine.search_batch

    async def half(self, queries, **kw):
        n = (len(queries) + 1) // 2
        out = await orig(self, queries[:n], **kw)
        return out + out[: len(queries) - n]

    monkeypatch.setattr(SearchEngine, "search_batch", half)


def _altered_scores(monkeypatch):
    """An answer altered where it is produced: the reranker reports each
    group's scores in reverse."""
    from lean_explore_tpu_torch.util.reranker_client import RerankerClient

    orig = RerankerClient.rerank_grouped_sync

    def reversed_scores(self, queries, docs_grouped, **kw):
        return [list(reversed(s)) for s in orig(self, queries, docs_grouped, **kw)]

    monkeypatch.setattr(RerankerClient, "rerank_grouped_sync", reversed_scores)


def _swapped_answer(monkeypatch):
    """An answer altered where it is produced: the second and the last
    result of every answer trade places."""
    from lean_explore_tpu_torch.search.engine import SearchEngine

    orig = SearchEngine._take_results

    def swapped(ordered, limit):
        out = orig(ordered, limit)
        if len(out) > 2:
            out[1], out[-1] = out[-1], out[1]
        return out

    monkeypatch.setattr(SearchEngine, "_take_results", staticmethod(swapped))


def _short_pool(monkeypatch):
    """Half of the work left out: the engine reranks its top 10 candidates
    where the traffic asks for 50."""
    from lean_explore_tpu_torch.search.engine import SearchEngine

    orig = SearchEngine.search_batch

    async def short(self, queries, **kw):
        return await orig(self, queries, **dict(kw, rerank_top=10))

    monkeypatch.setattr(SearchEngine, "search_batch", short)


def _no_lexical(monkeypatch):
    """A stage left out: the lexical stage finds nothing, so the pool comes
    from the dense candidates alone."""
    from lean_explore_tpu_torch.search.engine import SearchEngine

    def nothing(self, query, bm25_k):
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.float64)

    monkeypatch.setattr(SearchEngine, "_retrieve_bm25_arrays", nothing)


def _stale_documents(monkeypatch):
    """The index build's step returning its state unchanged: every call
    answers the first call's vectors."""
    from lean_explore_tpu_torch.util.embedding_client import EmbeddingClient

    orig = EmbeddingClient.embed_sync
    first = []

    def stale(self, texts, is_query=False):
        out = orig(self, texts, is_query)
        if not first:
            first.append(out)
        return first[0][: len(texts)]

    monkeypatch.setattr(EmbeddingClient, "embed_sync", stale)


def _half_documents(monkeypatch):
    """Half of the index build's batch left out: the second half of each
    call gets the mean of the first half's vectors."""
    from lean_explore_tpu_torch.util.embedding_client import EmbeddingClient

    orig = EmbeddingClient.embed_sync

    def half(self, texts, is_query=False):
        n = (len(texts) + 1) // 2
        out = orig(self, texts[:n], is_query)
        mean = out.mean(axis=0, keepdims=True)
        return np.concatenate([out, np.repeat(mean, len(texts) - n, axis=0)])

    monkeypatch.setattr(EmbeddingClient, "embed_sync", half)


def _lost_write(monkeypatch):
    """An answer altered where it is produced: the store writes each
    embedding with its first component negated."""
    from lean_explore_tpu_torch.models.store import DeclarationStore

    orig = DeclarationStore.set_embeddings

    def altered(self, items):
        out = []
        for decl_id, vec in items:
            vec = np.array(vec, dtype=np.float32)
            vec[0] = -vec[0]
            out.append((decl_id, vec))
        return orig(self, out)

    monkeypatch.setattr(DeclarationStore, "set_embeddings", altered)


@pytest.mark.parametrize("cell", ["qwen3-0.6b.closed", "qwen3-0.6b-cascade.closed"])
@pytest.mark.parametrize("fault", [_stale_embeddings, _half_batch, _altered_scores, _swapped_answer,
                                   _short_pool, _no_lexical])
def test_search_faults_are_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    out = _run(cell)
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("fault", [_stale_documents, _half_documents, _lost_write])
def test_index_build_faults_are_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = _run("qwen3-0.6b.index-embed")
    assert not out["correct"], out["check"]
