"""Service layer: timing + response envelopes over the engine
(lean_explore_tpu/search/service.py): the same defaults (limit=20,
rerank_top=50) and the batched entry point serving is built around.
"""

import logging
import time

from lean_explore_tpu_torch.models.search_types import SearchResponse, SearchResult
from lean_explore_tpu_torch.search.engine import SearchEngine
from lean_explore_tpu_torch.util.profiling import StageTimings

logger = logging.getLogger(__name__)


class Service:
    """Clean search/get interface used by MCP and library callers."""

    def __init__(self, engine: SearchEngine | None = None):
        self.engine = engine or SearchEngine()

    async def search(
        self,
        query: str,
        limit: int = 20,
        rerank_top: int | None = 50,
        packages: list[str] | None = None,
    ) -> SearchResponse:
        """Search and wrap results with timing metadata."""
        start = time.time()
        results = await self.engine.search(
            query=query, limit=limit, rerank_top=rerank_top, packages=packages
        )
        return SearchResponse(
            query=query,
            results=results,
            count=len(results),
            processing_time_ms=int((time.time() - start) * 1000),
        )

    async def search_batch(
        self,
        queries: list[str],
        limit: int = 20,
        rerank_top: int | None = 50,
        packages: list[str] | None = None,
        timings: StageTimings | None = None,
    ) -> list[SearchResponse]:
        """Batched search: one device pass per stage across all queries.
        ``timings`` collects the engine's per-stage milliseconds."""
        start = time.time()
        batches = await self.engine.search_batch(
            queries, limit=limit, rerank_top=rerank_top, packages=packages,
            timings=timings,
        )
        elapsed_ms = int((time.time() - start) * 1000)
        return [
            SearchResponse(
                query=q,
                results=results,
                count=len(results),
                processing_time_ms=elapsed_ms,
            )
            for q, results in zip(queries, batches)
        ]

    async def get_by_id(self, declaration_id: int) -> SearchResult | None:
        return await self.engine.get_by_id(declaration_id)

    async def warmup(
        self, *, rerank: bool = True, batch: int = 1, all_buckets: bool = False
    ) -> int:
        """Compile-and-execute the serving programs before real traffic.

        The first query otherwise pays model loading, the kernel build and
        the first CUDA launches of the encode / dense-retrieval / rerank
        stages. Best-effort: installations without local model
        checkpoints (BM25-only serving) warm what they can; returns elapsed
        ms.

        Args:
            rerank: Also warm the cross-encoder path.
            batch: Warm with this many queries (the serving batch).
            all_buckets: Also warm every standard batch bucket below
                ``batch`` (models.tokenizer.BATCH_BUCKETS).
        """
        start = time.time()
        if all_buckets:
            from lean_explore_tpu_torch.models.tokenizer import BATCH_BUCKETS

            sizes = [b for b in BATCH_BUCKETS if b < max(batch, 1)]
            sizes.append(max(batch, 1))
        else:
            sizes = [max(batch, 1)]
        for size in sizes:
            queries = [f"warmup query {i}" for i in range(size)]
            # Warm the SERVICE default rerank pool (50), not the engine
            # default (25): 25 vs 50 candidates pad to different
            # docs-per-group shapes in the grouped reranker.
            for rerank_top in ([50, 0] if rerank else [0]):
                try:
                    await self.engine.search_batch(
                        queries, limit=1, rerank_top=rerank_top
                    )
                    break
                except FileNotFoundError as exc:
                    logger.warning(
                        "warmup degraded (model checkpoint unavailable): %s", exc
                    )
        return int((time.time() - start) * 1000)
