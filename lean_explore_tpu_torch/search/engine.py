"""Hybrid search engine of the port: dense + BM25 retrieval, RRF fusion,
dependency boost, cross-encoder rerank (lean_explore_tpu/search/engine.py).

The same stages and the same fusion arithmetic as the JAX engine, host
fusion in float64 included. ``search_batch`` is the entry point: the whole
batch shares one embedding forward, one dense retrieval pass on the device
and one grouped reranker forward. ``search`` is the batch of one.
"""

import asyncio
import logging
import os
from pathlib import Path

import numpy as np
import torch

from lean_explore_tpu_torch.config import Config
from lean_explore_tpu_torch.index.artifacts import load_index_artifacts
from lean_explore_tpu_torch.index.bm25 import Bm25Params
from lean_explore_tpu_torch.models.search_types import SearchResult
from lean_explore_tpu_torch.models.store import Declaration, DeclarationStore
from lean_explore_tpu_torch.search.scoring import (
    normalize_dependency_counts,
    normalize_scores,
)
from lean_explore_tpu_torch.search.tokenization import (
    is_autogenerated,
    tokenize_raw,
    tokenize_spaced,
    tokenize_words,
)
from lean_explore_tpu_torch.util.profiling import StageTimings, count, span

logger = logging.getLogger(__name__)


class SearchEngine:
    """Hybrid two-stage retrieval + fusion + rerank over index artifacts."""

    def __init__(
        self,
        data_dir: str | Path | None = None,
        *,
        store: DeclarationStore | None = None,
        artifacts=None,
        embedding_client=None,
        embedding_model_name: str = Config.EMBEDDING_MODEL_NAME,
        reranker_client=None,
        reranker_model_name: str = Config.RERANKER_MODEL_NAME,
        use_local_data: bool = False,
        dense_dtype: str | None = None,
        preload_metadata: bool | None = None,
        device: str | torch.device | None = None,
    ):
        """Open index artifacts and prepare (lazily) the model clients.

        Args:
            data_dir: Artifact directory; defaults to the configured cache
                (Config.ACTIVE_CACHE_PATH), or to the extraction output
                (Config.ACTIVE_DATA_PATH) when use_local_data=True.
            store: Injected document store (tests); default opens
                declarations.db inside data_dir.
            artifacts: Injected IndexArtifacts (tests); default loads from
                data_dir and validates completeness at construction.
            embedding_client / reranker_client: Injected clients; default
                lazily constructs the port's clients on first use so
                importing the engine never loads model weights.
            dense_dtype: On-device corpus dtype (default Config.CORPUS_DTYPE).
            preload_metadata: Hold the whole metadata table in memory
                (default Config.PRELOAD_METADATA / env
                LEAN_EXPLORE_PRELOAD_METADATA). High-QPS serving mode: the
                fusion stage stops paying sqlite hydration + dependency-JSON
                parsing per batch.
            device: Device of the dense index and the default clients
                (default CUDA; pass "cpu" to run on the CPU). With
                LEAN_EXPLORE_MESH_SHAPE set, the index is sharded and the
                clients are data-parallel over that many devices of this
                kind.
        """
        if data_dir is None:
            data_dir = (
                Config.ACTIVE_DATA_PATH if use_local_data else Config.ACTIVE_CACHE_PATH
            )
        self.data_dir = Path(data_dir)
        self.device = device

        self._artifacts = artifacts or load_index_artifacts(
            self.data_dir,
            dense_dtype=dense_dtype or Config.CORPUS_DTYPE,
            device=device,
        )
        self.store = store or DeclarationStore(self.data_dir / "declarations.db")

        self._embedding_client = embedding_client
        self._embedding_model_name = embedding_model_name
        self._reranker_client = reranker_client
        self._reranker_model_name = reranker_model_name

        self._metadata: dict[int, Declaration] | None = None
        self._dep_names: dict[int, list[str]] | None = None
        self._dep_graph = None  # (indptr, targets) id-indexed CSR
        if (
            Config.PRELOAD_METADATA if preload_metadata is None else preload_metadata
        ):
            self._preload_metadata()

    def _preload_metadata(self) -> None:
        """Load every declaration row (minus embeddings) and pre-parse the
        dependency JSON. One table scan at startup buys hydration-free
        fusion for every subsequent batch, plus an id-indexed dependency
        CSR so the boost runs in the native lexcore (no string work)."""
        metadata: dict[int, Declaration] = {}
        dep_names: dict[int, list[str]] = {}
        for decl in self.store.iter_all(with_embeddings=False):
            metadata[decl.id] = decl
            dep_names[decl.id] = decl.dependency_names()
        self._metadata = metadata
        self._dep_names = dep_names

        self._dep_graph = None
        if metadata:
            max_id = max(metadata)
            if max_id <= 4 * len(metadata):  # dense id space only
                name_to_id = {d.name: i for i, d in metadata.items()}
                indptr = np.zeros(max_id + 2, dtype=np.int64)
                targets: list[int] = []
                # From 0: sqlite autoincrement starts at 1, but injected
                # stores may carry id 0 — skipping it would silently drop
                # its edges on the native path only (fallback divergence).
                for decl_id in range(0, max_id + 1):
                    resolved = [
                        name_to_id[name]
                        for name in dep_names.get(decl_id, ())
                        if name in name_to_id
                    ]
                    targets.extend(resolved)
                    indptr[decl_id + 1] = len(targets)
                self._dep_graph = (
                    indptr,
                    np.asarray(targets, dtype=np.int64),
                )
        logger.info("preloaded metadata for %d declarations", len(metadata))

    # ------------------------------------------------------------------
    # Lazy clients
    # ------------------------------------------------------------------

    @property
    def embedding_client(self):
        if self._embedding_client is None:
            from lean_explore_tpu_torch.util.embedding_client import EmbeddingClient

            self._embedding_client = EmbeddingClient(
                self._embedding_model_name,
                max_length=Config.EMBEDDING_MAX_LENGTH,
                device=self.device,
                mesh=self._client_data_mesh(),
            )
        return self._embedding_client

    def _client_data_mesh(self):
        """A flat ``data`` mesh over the serving mesh's devices when
        LEAN_EXPLORE_MESH_SHAPE is set (encode batches and rerank query
        groups are independent rows, so both clients split them over every
        device), else None."""
        from lean_explore_tpu_torch.parallel.mesh import serve_mesh_from_config
        from lean_explore_tpu_torch.parallel.rerank import rerank_data_mesh

        serve_mesh = serve_mesh_from_config(self.device)
        return None if serve_mesh is None else rerank_data_mesh(serve_mesh)

    @property
    def reranker_client(self):
        if self._reranker_client is None:
            from lean_explore_tpu_torch.util.reranker_client import RerankerClient

            self._reranker_client = RerankerClient(
                self._reranker_model_name,
                max_length=Config.RERANKER_MAX_LENGTH,
                device=self.device,
                mesh=self._client_data_mesh(),
            )
        return self._reranker_client

    # ------------------------------------------------------------------
    # Retrieval stages
    # ------------------------------------------------------------------

    @staticmethod
    def _max_merge_arrays(
        ids: np.ndarray, scores: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Dedup ids keeping the max score, preserving first-seen order.

        Vectorized replacement for the per-candidate dict loops — output
        order is exactly the old dict's insertion order, so downstream RRF
        tie-breaking is unchanged.
        """
        if len(ids) == 0:
            return ids.astype(np.int64), scores.astype(np.float64)
        uniq, first_pos, inverse = np.unique(
            ids, return_index=True, return_inverse=True
        )
        # Max score per unique id: sort (group, -score), take group heads.
        order = np.lexsort((-scores, inverse))
        grouped = inverse[order]
        head = np.empty(len(ids), dtype=bool)
        head[0] = True
        head[1:] = grouped[1:] != grouped[:-1]
        best = np.empty(len(uniq), dtype=np.float64)
        best[grouped[head]] = scores[order[head]]
        keep = np.argsort(first_pos, kind="stable")
        return uniq[keep].astype(np.int64), best[keep]

    def _retrieve_bm25_arrays(
        self, query: str, bm25_k: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Max-merged BM25 (ids, scores) from the spaced + raw name indices,
        first-seen order (spaced results, then new raw ids)."""
        arts = self._artifacts
        ids = np.asarray(arts.bm25_ids)
        all_ids: list[np.ndarray] = []
        all_scores: list[np.ndarray] = []
        for index, tokens in (
            (arts.bm25_spaced, tokenize_spaced(query)),
            (arts.bm25_raw, tokenize_raw(query)),
        ):
            rows, scores = index.retrieve(tokens, k=bm25_k)
            all_ids.append(ids[rows])
            all_scores.append(np.asarray(scores, dtype=np.float64))
        merged = self._max_merge_arrays(
            np.concatenate(all_ids), np.concatenate(all_scores)
        )
        logger.debug("BM25 name: %d candidates", len(merged[0]))
        return merged

    def _semantic_arrays(
        self, scores_row, ids_row
    ) -> tuple[np.ndarray, np.ndarray]:
        return self._max_merge_arrays(
            np.asarray(ids_row), np.asarray(scores_row, dtype=np.float64)
        )

    # ------------------------------------------------------------------
    # Fusion stages (host, float64)
    # ------------------------------------------------------------------

    @staticmethod
    def _rrf_fuse_arrays(
        bm25: tuple[np.ndarray, np.ndarray],
        semantic: tuple[np.ndarray, np.ndarray],
    ) -> tuple[np.ndarray, np.ndarray]:
        """Array-native RRF: feeds lexcore without dict or tuple-list churn.

        Input arrays are first-seen-ordered max-merges, i.e. exactly the
        iteration order the dict path would present, so ranks and tie order
        are identical across the three implementations. Returns fused
        (ids, scores) sorted descending.
        """
        bm25_ids, bm25_scores = bm25
        sem_ids, sem_scores = semantic
        if len(bm25_ids) == 0 and len(sem_ids) == 0:
            return (
                np.zeros(0, dtype=np.int64),
                np.zeros(0, dtype=np.float64),
            )
        from lean_explore_tpu_torch.native import rrf_fuse_native

        fused = rrf_fuse_native(bm25_ids, bm25_scores, sem_ids, sem_scores)
        if fused is not None:
            return fused
        pairs = SearchEngine._compute_rrf_scores(
            dict(zip(bm25_ids.tolist(), bm25_scores.tolist())),
            dict(zip(sem_ids.tolist(), sem_scores.tolist())),
        )
        return (
            np.asarray([cid for cid, _ in pairs], dtype=np.int64),
            np.asarray([s for _, s in pairs], dtype=np.float64),
        )

    @staticmethod
    def _compute_rrf_scores(
        bm25_map: dict[int, float], semantic_map: dict[int, float]
    ) -> list[tuple[int, float]]:
        """RRF over the two signals (reference engine.py:263-300)."""
        if not bm25_map and not semantic_map:
            return []
        bm25_rank = {
            cid: r
            for r, (cid, _) in enumerate(
                sorted(bm25_map.items(), key=lambda x: x[1], reverse=True), start=1
            )
        }
        sem_rank = {
            cid: r
            for r, (cid, _) in enumerate(
                sorted(semantic_map.items(), key=lambda x: x[1], reverse=True),
                start=1,
            )
        }
        default_bm25 = len(bm25_rank) + 1
        default_sem = len(sem_rank) + 1
        # Deterministic candidate order: bm25 insertion order, then semantic.
        candidates = dict.fromkeys(bm25_map)
        candidates.update(dict.fromkeys(semantic_map))
        fused = [
            (
                cid,
                1.0 / bm25_rank.get(cid, default_bm25)
                + 1.0 / sem_rank.get(cid, default_sem),
            )
            for cid in candidates
        ]
        fused.sort(key=lambda x: x[1], reverse=True)
        return fused

    @staticmethod
    def _dependency_boost(
        rrf_scores: list[tuple[int, float]],
        declarations: dict[int, Declaration],
        dep_names: dict[int, list[str]],
        top_n: int = 500,
    ) -> list[tuple[int, float]]:
        """Boost declarations that other top candidates depend on
        (reference engine.py:302-358). Pure: hydration is the caller's job
        so a batch of queries shares one store round-trip."""
        top_ids = [cid for cid, _ in rrf_scores[:top_n]]
        name_to_id = {
            declarations[cid].name: cid for cid in top_ids if cid in declarations
        }
        dep_counts: dict[int, int] = dict.fromkeys(top_ids, 0)
        for cid in top_ids:
            for dep_name in dep_names.get(cid, ()):
                target = name_to_id.get(dep_name)
                if target is not None:
                    dep_counts[target] += 1

        max_deps = max(dep_counts.values()) if dep_counts else 0
        boosted: list[tuple[int, float]] = []
        for rank, (cid, _) in enumerate(rrf_scores[:top_n], start=1):
            count = dep_counts.get(cid, 0)
            if max_deps > 0 and count > 0:
                dep_rank = (max_deps - count) + 1
            else:
                dep_rank = max_deps + 1 if max_deps > 0 else top_n + 1
            boosted.append((cid, 1.0 / rank + 1.0 / dep_rank))
        boosted.sort(key=lambda x: x[1], reverse=True)
        return boosted

    @staticmethod
    def _extract_package(module: str) -> str:
        return module.split(".")[0] if module else ""

    def _filter_by_packages(
        self, declarations_map: dict[int, Declaration], packages: list[str]
    ) -> dict[int, Declaration]:
        if not packages:
            return declarations_map
        wanted = set(packages)
        return {
            cid: decl
            for cid, decl in declarations_map.items()
            if self._extract_package(decl.module) in wanted
        }

    # ------------------------------------------------------------------
    # Rerank fusion
    # ------------------------------------------------------------------

    def _compute_bm25_on_informalizations(
        self, query: str, candidates: list[Declaration]
    ) -> list[float]:
        """Ad-hoc BM25+ over candidate informalizations
        (reference engine.py:418-448; word tokens, no dedup).

        Scores the query's tokens directly against the candidate docs —
        bit-identical to building a throwaway ``Bm25Index`` and scoring
        (a regression test pins this), but skipping the vocab/CSR
        construction for the ~49 tokens that never get queried. Was the
        single largest fuse-stage component at B=128.
        """
        from collections import Counter

        texts = [d.informalization if d.informalization else d.name for d in candidates]
        corpus = [tokenize_words(t) for t in texts]
        query_tokens = tokenize_words(query)
        n_docs = len(corpus)
        if n_docs == 0:
            return []
        p = Bm25Params(method="bm25+")
        doc_lengths = np.fromiter(
            (len(toks) for toks in corpus), np.float64, n_docs
        )
        avgdl = float(doc_lengths.mean())
        k1b = p.k1 * (1.0 - p.b)
        k1b_over_avgdl = p.k1 * p.b / avgdl if avgdl > 0 else 0.0
        counters = [Counter(toks) for toks in corpus]
        scores = np.zeros(n_docs, dtype=np.float64)
        constant = 0.0
        for tok in query_tokens:
            tf = np.fromiter(
                (float(c.get(tok, 0)) for c in counters), np.float64, n_docs
            )
            occupied = tf > 0
            df = int(occupied.sum())
            if df == 0:  # token absent from the ad-hoc vocab: skipped
                continue
            idf_t = float(np.log((n_docs + 1) / np.float64(df)))
            constant += idf_t * p.delta
            denom = k1b + k1b_over_avgdl * doc_lengths + tf
            scores += idf_t * ((p.k1 + 1.0) * tf / denom)
        if constant:
            scores += constant
        return scores.tolist()

    def _candidate_dependency_counts(
        self, candidates: list[Declaration]
    ) -> list[int]:
        """How many candidates depend on each candidate
        (reference engine.py:450-475). Preloaded metadata supplies
        pre-parsed dependency names (skipping a json.loads per candidate
        per batch on the serving path); cold mode parses per row."""
        dep_names_all = self._dep_names
        counts = {d.name: 0 for d in candidates}
        for d in candidates:
            names = (
                dep_names_all.get(d.id, ())
                if dep_names_all is not None
                else d.dependency_names()
            )
            for dep_name in names:
                if dep_name in counts:
                    counts[dep_name] += 1
        return [counts.get(d.name, 0) for d in candidates]

    def _precompute_fusion_signals(
        self, query: str, candidates: list[Declaration], fuzzy: list[float]
    ) -> tuple[list[float], list[float], list[float]]:
        """The rerank-independent final-fusion signals for one query.

        Separated from the combine step so search_batch can compute these
        on the host WHILE the cross-encoder runs on device — the signal
        work hides entirely under the rerank forward.
        """
        bm25_inf = self._compute_bm25_on_informalizations(query, candidates)
        dep_counts = self._candidate_dependency_counts(candidates)
        return fuzzy, bm25_inf, normalize_dependency_counts(dep_counts)

    @staticmethod
    def _combine_fusion_signals(
        signals: tuple[list[float], list[float], list[float]],
        reranker_scores: list[float],
    ) -> list[float]:
        """Weighted fusion given precomputed signals + rerank scores."""
        fuzzy, bm25_inf, norm_dep = signals
        norm_rerank = normalize_scores(reranker_scores)
        norm_fuzzy = normalize_scores(fuzzy)
        norm_bm25 = normalize_scores(bm25_inf)
        final = []
        for i in range(len(fuzzy)):
            score = 1.0 * norm_rerank[i] + 0.4 * norm_bm25[i] + 0.2 * norm_dep[i]
            if fuzzy[i] >= 0.7:
                score += 1.0 * norm_fuzzy[i]
            final.append(score)
        return final

    @staticmethod
    def _to_search_result(decl: Declaration) -> SearchResult:
        return SearchResult(
            id=decl.id,
            name=decl.name,
            module=decl.module,
            docstring=decl.docstring,
            source_text=decl.source_text,
            source_link=decl.source_link,
            dependencies=decl.dependencies,
            informalization=decl.informalization,
        )

    @staticmethod
    def _take_results(
        ordered: list[Declaration], limit: int
    ) -> list[SearchResult]:
        """Drop auto-generated declarations, convert, cap at limit."""
        results: list[SearchResult] = []
        for decl in ordered:
            if is_autogenerated(decl.name):
                continue
            results.append(SearchEngine._to_search_result(decl))
            if len(results) >= limit:
                break
        return results

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------

    async def search(
        self,
        query: str,
        limit: int = 50,
        faiss_k: int = 1000,
        bm25_k: int = 1000,
        rerank_top: int | None = 25,
        packages: list[str] | None = None,
    ) -> list[SearchResult]:
        """Single-query search (reference engine.py:534-606 surface)."""
        results = await self.search_batch(
            [query],
            limit=limit,
            dense_k=faiss_k,
            bm25_k=bm25_k,
            rerank_top=rerank_top,
            packages=packages,
        )
        return results[0]

    async def search_batch(
        self,
        queries: list[str],
        limit: int = 50,
        dense_k: int = 1000,
        bm25_k: int = 1000,
        rerank_top: int | None = 25,
        packages: list[str] | None = None,
        timings: StageTimings | None = None,
        dep_boost_top_n: int = 500,
    ) -> list[list[SearchResult]]:
        """Batched hybrid search: one device program per stage for the whole
        batch. This is the serving entry point, one ``search_batch`` span.

        dep_boost_top_n is the dependency-boost window (reference
        engine.py:576 boosts the RRF top 500); the hydration union below must
        cover the same window, so both read this one parameter.
        """
        timings = timings or StageTimings()
        with span("search_batch"):
            count("queries", len(queries))

            # Device-step cap (Config.SERVE_QUERY_BATCH / env
            # LEAN_EXPLORE_SERVE_QUERY_BATCH): oversized batches split into
            # serving-sized slices, the batch the device stages are sized for.
            step = max(Config.SERVE_QUERY_BATCH, 1)
            if len(queries) > step:
                out: list[list[SearchResult]] = []
                for start in range(0, len(queries), step):
                    out.extend(
                        await self.search_batch(
                            queries[start : start + step],
                            limit=limit,
                            dense_k=dense_k,
                            bm25_k=bm25_k,
                            rerank_top=rerank_top,
                            packages=packages,
                            timings=timings,
                            dep_boost_top_n=dep_boost_top_n,
                        )
                    )
                return out

            live = [i for i, q in enumerate(queries) if q.strip()]
            results: list[list[SearchResult]] = [[] for _ in queries]
            if not live:
                return results

            live_queries = [queries[i] for i in live]

            # Stages 1a + 1b run CONCURRENTLY: the lexical stage is host work
            # (CSR scoring releases the GIL in the native path) while encode +
            # dense retrieval are device programs — the BM25 scan hides entirely
            # under the embedding forward (SURVEY §7 "serving efficiency").
            _empty = (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.float64))

            async def _lexical() -> list[tuple[np.ndarray, np.ndarray]]:
                with timings.stage("lexical"):
                    if (os.cpu_count() or 1) > 1 and len(live_queries) > 1:
                        return list(
                            await asyncio.gather(
                                *(
                                    asyncio.to_thread(
                                        self._retrieve_bm25_arrays, q, bm25_k
                                    )
                                    for q in live_queries
                                )
                            )
                        )
                    return [
                        self._retrieve_bm25_arrays(q, bm25_k)
                        for q in live_queries
                    ]

            async def _semantic() -> list[tuple[np.ndarray, np.ndarray]]:
                dense = self._artifacts.dense
                if dense.n == 0 or dense_k <= 0:  # dense_k=0: lexical-only mode
                    return [_empty for _ in live_queries]
                with timings.stage("encode"):
                    client = self.embedding_client
                    if hasattr(client, "embed_device"):
                        # Device-native path: the query embeddings stay on
                        # device and feed the retrieval matmul directly — no
                        # wire format, no host round trip.
                        query_vecs = await asyncio.to_thread(
                            client.embed_device, live_queries, True
                        )
                    else:
                        response = await client.embed(live_queries, is_query=True)
                        query_vecs = response.embeddings
                with timings.stage("dense"):
                    k = min(dense_k, dense.n)
                    scores, ids = await asyncio.to_thread(
                        dense.search, query_vecs, k
                    )
                return [
                    self._semantic_arrays(scores[i], ids[i])
                    for i in range(len(live_queries))
                ]

            # _semantic first: it reaches its first await (the threaded embed
            # dispatch) immediately, so the device is busy before the lexical
            # stage's single-core synchronous branch occupies the event loop.
            semantic_maps, bm25_maps = await asyncio.gather(_semantic(), _lexical())

            # Stage 2: fuse + boost + filter per query (host float64). The
            # hydration for the dependency boost is batched: one store round-trip
            # covers the union of every query's top-500, and dependency JSON is
            # parsed once per declaration.
            with timings.stage("fuse"):
                rrf_lists = [
                    self._rrf_fuse_arrays(bm25_pair, semantic_pair)
                    for bm25_pair, semantic_pair in zip(bm25_maps, semantic_maps)
                ]
                if self._metadata is not None:
                    declarations_all = self._metadata
                    dep_names_all = self._dep_names
                else:
                    union_ids = {
                        cid
                        for rrf_ids, _ in rrf_lists
                        for cid in rrf_ids[:dep_boost_top_n].tolist()
                    }
                    declarations_all = await asyncio.to_thread(
                        self.store.get_by_ids, list(union_ids)
                    )
                    dep_names_all = {
                        cid: decl.dependency_names()
                        for cid, decl in declarations_all.items()
                    }

                per_query_candidates: list[list[Declaration]] = []
                for rrf_ids, rrf_scores in rrf_lists:
                    if len(rrf_ids) == 0:
                        per_query_candidates.append([])
                        continue
                    boosted_ids: list[int] | None = None
                    if self._dep_graph is not None:
                        from lean_explore_tpu_torch.native import dep_boost_native

                        native = dep_boost_native(
                            rrf_ids[:dep_boost_top_n],
                            *self._dep_graph,
                            top_n=dep_boost_top_n,
                        )
                        if native is not None:
                            boosted_ids = native[0].tolist()
                    if boosted_ids is None:
                        boosted = self._dependency_boost(
                            list(zip(rrf_ids.tolist(), rrf_scores.tolist())),
                            declarations_all,
                            dep_names_all,
                            dep_boost_top_n,
                        )
                        boosted_ids = [cid for cid, _ in boosted]
                    declarations_map = declarations_all
                    if packages:
                        # Filter only the boosted candidates (≤ top_n rows), not
                        # the whole hydrated/preloaded map.
                        candidates_map = {
                            cid: declarations_all[cid]
                            for cid in boosted_ids
                            if cid in declarations_all
                        }
                        declarations_map = self._filter_by_packages(
                            candidates_map, packages
                        )
                        boosted_ids = [
                            cid for cid in boosted_ids if cid in declarations_map
                        ]
                    top_n = rerank_top if rerank_top and rerank_top > 0 else limit
                    per_query_candidates.append(
                        [
                            declarations_map[cid]
                            for cid in boosted_ids[:top_n]
                            if cid in declarations_map
                        ]
                    )

            # Stage 3: rerank — one cross-encoder forward over every query's
            # pairs, then per-query fusion.
            if rerank_top and rerank_top > 0:
                flat_docs: list[str] = []
                flat_query: list[str] = []
                spans: list[tuple[int, int]] = []
                for q, candidates in zip(live_queries, per_query_candidates):
                    start = len(flat_docs)
                    for decl in candidates:
                        flat_docs.append(
                            f"{decl.name}: {decl.informalization}"
                            if decl.informalization
                            else decl.name
                        )
                        flat_query.append(q)
                    spans.append((start, len(flat_docs)))

                rerank_scores: list[float] = []
                per_query_signals: list[tuple | None] = [None] * len(live_queries)
                if flat_docs:

                    async def _rerank() -> list[float]:
                        client = self.reranker_client
                        if hasattr(client, "rerank_grouped"):
                            # Shared-prefix KV path: each query's pairs reuse
                            # one prefix forward (util/reranker_client.py).
                            # Grouped scores flatten back to the span layout.
                            grouped = await client.rerank_grouped(
                                live_queries,
                                [flat_docs[start:end] for start, end in spans],
                            )
                            return [s for group in grouped for s in group]
                        return await self._rerank_pairs(flat_query, flat_docs)

                    def _signals() -> list[tuple | None]:
                        # Rerank-independent fusion signals (fuzzy, ad-hoc
                        # BM25 over informalizations, dependency counts):
                        # computed WHILE the cross-encoder runs on device, so
                        # this host work hides under the rerank forward.
                        from lean_explore_tpu_torch.search.scoring import (
                            fuzzy_name_scores_pairs,
                        )

                        with span("fuse/signals"):
                            flat_names = [
                                decl.name
                                for candidates in per_query_candidates
                                for decl in candidates
                            ]
                            flat_fuzzy = fuzzy_name_scores_pairs(
                                flat_query, flat_names
                            )
                            out: list[tuple | None] = [None] * len(live_queries)
                            for qi, (q, candidates, (start, end)) in enumerate(
                                zip(live_queries, per_query_candidates, spans)
                            ):
                                if candidates:
                                    out[qi] = self._precompute_fusion_signals(
                                        q, candidates, flat_fuzzy[start:end]
                                    )
                            return out

                    if (os.cpu_count() or 1) > 1:
                        # Signals compute on another core while the
                        # cross-encoder runs on device.
                        with timings.stage("rerank"):
                            rerank_scores, per_query_signals = await asyncio.gather(
                                _rerank(), asyncio.to_thread(_signals)
                            )
                    else:
                        # Single-core host: the signal thread would steal CPU
                        # from rerank's own tokenization/dispatch path
                        # (measured: rerank 1202 -> 1548 ms at B=128 with the
                        # overlap forced on a 1-core bench host) — run them
                        # sequentially instead.
                        with timings.stage("rerank"):
                            rerank_scores = await _rerank()
                        with timings.stage("fuse"):
                            per_query_signals = _signals()

                with timings.stage("fuse"):
                    for out_idx, candidates, signals, (start, end) in zip(
                        live, per_query_candidates, per_query_signals, spans
                    ):
                        if not candidates:
                            continue
                        final = self._combine_fusion_signals(
                            signals, rerank_scores[start:end]
                        )
                        order = sorted(
                            range(len(candidates)), key=lambda i: final[i], reverse=True
                        )
                        results[out_idx] = self._take_results(
                            [candidates[i] for i in order], limit
                        )
            else:
                for out_idx, candidates in zip(live, per_query_candidates):
                    results[out_idx] = self._take_results(candidates, limit)

            return results

    async def _rerank_pairs(
        self, queries: list[str], documents: list[str]
    ) -> list[float]:
        """Score (query, document) pairs; queries may differ per pair.

        Uses the client's cross-query pair API when present (pairs from
        different queries share device batches); falls back to per-query
        grouping for duck-typed clients that only expose rerank().
        """
        client = self.reranker_client
        if hasattr(client, "rerank_pairs"):
            return await client.rerank_pairs(queries, documents)

        scores = [0.0] * len(documents)
        start = 0
        while start < len(documents):
            end = start
            while end < len(documents) and queries[end] == queries[start]:
                end += 1
            response = await client.rerank(queries[start], documents[start:end])
            scores[start:end] = response.scores
            start = end
        return scores

    async def get_by_id(self, declaration_id: int) -> SearchResult | None:
        if self._metadata is not None:
            decl = self._metadata.get(declaration_id)
        else:
            decl = await asyncio.to_thread(self.store.get_by_id, declaration_id)
        return self._to_search_result(decl) if decl else None

    async def get_by_name(self, name: str) -> SearchResult | None:
        decl = await asyncio.to_thread(self.store.get_by_name, name)
        return self._to_search_result(decl) if decl else None
