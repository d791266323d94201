"""The system under test, built from the benchmark's inputs, and the
benchmark's wrappers around the calls into each of its layers.

The wrappers time each engine batch (``Service.search_batch`` with the
engine's ``StageTimings``), mark the layers for the profiler
(``bench.<layer>`` ranges), and keep references to what each layer
produced (query vectors, dense candidates, the reranker's inputs and
scores, the answers, the index build's vectors) for the comparison after
the window. They add no copy and no synchronisation to the timed path.
"""

import json
import multiprocessing
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from harness.weights import make_params, model_seed


@dataclass
class Batch:
    start: float
    queries: list[str]
    end: float = 0.0
    stages: dict = field(default_factory=dict)
    query_vecs: torch.Tensor | None = None
    dense_ids: np.ndarray | None = None
    dense_scores: np.ndarray | None = None
    rerank_outer: tuple | None = None  # (docs_grouped, final scores)
    rerank_calls: list = field(default_factory=list)  # (queries, docs_grouped, suffix_cap, scores)
    returned: list[list[int]] | None = None
    traced: bool = False


class Recorder:
    """What the wrappers saw, batch by batch, and an optional profiler hook
    called before and after each batch (``on_batch``)."""

    def __init__(self):
        self.batches: list[Batch] = []
        self.current: Batch | None = None
        self.on_batch = None  # callable(stage: "start" | "end", batch)


def corpus_rows(seed: int, n: int, dim: int, device) -> torch.Tensor:
    """The dense index's rows: unit vectors in bf16, drawn on the device."""
    gen = torch.Generator(device=device).manual_seed(model_seed(seed, "corpus"))
    rows = torch.randn(n, dim, generator=gen, device=device)
    rows /= rows.norm(dim=1, keepdim=True)
    return rows.to(torch.bfloat16)


def qwen3_config(model_cfg: dict):
    from lean_explore_tpu_torch.models.qwen3 import Qwen3Config

    return Qwen3Config(**{k: model_cfg[k] for k in (
        "vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
        "num_key_value_heads", "head_dim", "intermediate_size", "rms_norm_eps",
        "rope_theta", "tie_word_embeddings")})


def write_tokenizer(vocab: dict, tokenizer_json: dict, directory: Path):
    from lean_explore_tpu_torch.models.tokenizer import load_tokenizer

    directory.mkdir(parents=True, exist_ok=True)
    (directory / "tokenizer.json").write_text(json.dumps(tokenizer_json))
    (directory / "tokenizer_config.json").write_text(json.dumps(
        {"pad_token": "<pad>", "eos_token": "<eos>", "unk_token": "<unk>"}))
    return load_tokenizer(directory)


def make_store(corpus, path: str):
    from lean_explore_tpu_torch.models.store import Declaration, DeclarationStore

    store = DeclarationStore(path, create=True)
    c = corpus
    step = 50_000
    for start in range(0, len(c), step):
        store.insert_many([
            Declaration(name=c.names[i], module=c.modules[i], source_text=c.source_texts[i],
                        source_link=c.source_links[i], id=i + 1, dependencies=c.dependencies[i],
                        informalization=c.informalizations[i])
            for i in range(start, min(start + step, len(c)))
        ])
    return store


def embedder(cfg, tokenizer, seed, device, batch_size):
    from lean_explore_tpu_torch.util.embedding_client import EmbeddingClient

    s = cfg["serving"]
    return EmbeddingClient.from_components(
        make_params(cfg["model"], model_seed(seed, "embedder"), device), qwen3_config(cfg["model"]),
        tokenizer, model_name=cfg["embedder"], max_length=s["embed_max_length"],
        batch_size=batch_size, query_prompt=s["query_prompt"],
    )


def build_search(cfg, corpus, tokenizer, seed, device, workdir: Path, rec: Recorder, timings: dict):
    """The serving stack of one card: store, BM25 name indices, the bf16
    dense index, both clients and the engine, wrapped for recording.
    Returns (service, batcher)."""
    from lean_explore_tpu_torch.api.server import SearchBatcher
    from lean_explore_tpu_torch.index.artifacts import IndexArtifacts
    from lean_explore_tpu_torch.index.dense import DenseIndex
    from lean_explore_tpu_torch.search.engine import SearchEngine
    from lean_explore_tpu_torch.search.service import Service
    from lean_explore_tpu_torch.util.profiling import StageTimings
    from lean_explore_tpu_torch.util.reranker_client import RerankerClient

    s = cfg["serving"]
    # The BM25 name indices build in a child process while this one fills
    # the store and the card. Spawned, not forked: torch has started threads
    # by now.
    pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        pending = pool.apply_async(_bm25_child, (corpus.names,))
        t = time.perf_counter()
        store = make_store(corpus, ":memory:")
        timings["store_s"] = time.perf_counter() - t
        t = time.perf_counter()
        ids = np.arange(1, len(corpus) + 1)
        dense = DenseIndex(corpus_rows(seed, len(corpus), cfg["model"]["hidden_size"], device), ids,
                           normalized=True)
        emb = embedder(cfg, tokenizer, seed, device, s["embed_batch"])
        rr = RerankerClient.from_components(
            make_params(cfg["model"], model_seed(seed, "reranker"), device), qwen3_config(cfg["model"]),
            tokenizer, model_name=cfg["reranker"], max_length=s["rerank_max_length"],
            instruction=s["instruction"], batch_size=s["rerank_batch"],
        )
        torch.cuda.synchronize(device) if device.type == "cuda" else None
        timings["weights_and_index_s"] = time.perf_counter() - t
        t = time.perf_counter()
        spaced, raw = pending.get()
        timings["bm25_wait_s"] = time.perf_counter() - t
    finally:
        pool.close()
        pool.join()
    t = time.perf_counter()
    engine = SearchEngine(workdir, store=store, artifacts=IndexArtifacts(
        dense=dense, bm25_spaced=spaced, bm25_raw=raw, bm25_ids=ids, manifest={}),
        embedding_client=emb, reranker_client=rr, preload_metadata=True, device=device)
    timings["preload_s"] = time.perf_counter() - t
    wrap_clients(emb, dense, rr, rec)
    service = TimedService(Service(engine), rec, StageTimings)
    batcher = SearchBatcher(service, coalesce_ms=s["coalesce_ms"], max_batch=s["serve_query_batch"])
    return service, batcher


def _bm25_child(names: list[str]):
    from lean_explore_tpu_torch.index.artifacts import build_bm25_name_indices

    return build_bm25_name_indices(names)


def _span(name):
    return torch.profiler.record_function(name)


def wrap_clients(emb, dense, rr, rec: Recorder) -> None:
    embed_device = emb.embed_device

    def embed_wrapped(texts, is_query=False):
        with _span("bench.encode"):
            out = embed_device(texts, is_query)
        if rec.current is not None and is_query:
            rec.current.query_vecs = out
        return out

    emb.embed_device = embed_wrapped
    search = dense.search

    def dense_wrapped(q, k, **kw):
        with _span("bench.dense"):
            scores, ids = search(q, k, **kw)
        if rec.current is not None:
            rec.current.dense_ids, rec.current.dense_scores = ids, scores
        return scores, ids

    dense.search = dense_wrapped
    grouped = rr.rerank_grouped
    grouped_sync = rr.rerank_grouped_sync

    async def rerank_wrapped(queries, docs_grouped):
        with _span("bench.rerank"):
            scores = await grouped(queries, docs_grouped)
        if rec.current is not None:
            rec.current.rerank_outer = (docs_grouped, scores)
        return scores

    def rerank_sync_wrapped(queries, docs_grouped, *, suffix_cap=None):
        scores = grouped_sync(queries, docs_grouped, suffix_cap=suffix_cap)
        if rec.current is not None:
            rec.current.rerank_calls.append((queries, docs_grouped, suffix_cap, scores))
        return scores

    rr.rerank_grouped = rerank_wrapped
    rr.rerank_grouped_sync = rerank_sync_wrapped


class TimedService:
    """``Service`` with each ``search_batch`` timed and recorded."""

    def __init__(self, service, rec: Recorder, stage_timings):
        self.service, self.rec, self._timings = service, rec, stage_timings

    def __getattr__(self, name):
        return getattr(self.service, name)

    async def search_batch(self, queries, **kw):
        batch = Batch(start=time.perf_counter(), queries=list(queries))
        if self.rec.on_batch:
            self.rec.on_batch("start", batch)
            batch.start = time.perf_counter()
        self.rec.current = batch
        timings = self._timings()
        try:
            with _span("bench.search_batch"):
                responses = await self.service.search_batch(queries, timings=timings, **kw)
        finally:
            self.rec.current = None
        batch.end = time.perf_counter()
        batch.stages = timings.as_dict()
        batch.returned = [[r.id for r in resp.results] for resp in responses]
        self.rec.batches.append(batch)
        if self.rec.on_batch:
            self.rec.on_batch("end", batch)
        return responses


def build_index_embed(cfg, corpus, tokenizer, seed, device, workdir: Path, timings: dict):
    """The index build's embedding stage: a store on disk holding the
    corpus without embeddings, its pending rows, and the corpus embedder at
    the stage's batch size. Returns (store, todo, client, db_path)."""
    from lean_explore_tpu_torch.extract.embeddings import DEFAULT_BATCH_SIZE

    t = time.perf_counter()
    db = workdir / "declarations.db"
    store = make_store(corpus, str(db))
    todo = list(store.iter_missing_embedding())
    timings["store_s"] = time.perf_counter() - t
    t = time.perf_counter()
    client = embedder(cfg, tokenizer, seed, device, DEFAULT_BATCH_SIZE)
    torch.cuda.synchronize(device) if device.type == "cuda" else None
    timings["weights_s"] = time.perf_counter() - t
    return store, todo, client, db
