"""lean_explore_tpu_torch: the PyTorch/CUDA port of lean_explore_tpu.

Hybrid search over Lean 4 declarations (BM25 + dense retrieval, RRF fusion,
dependency boost, Qwen3 cross-encoder rerank) on one NVIDIA GPU. Entry
points run on CUDA unless the caller passes ``device="cpu"``. Imports stay
lazy so that importing the package loads no model and builds no kernel.
"""

from importlib import import_module
from typing import TYPE_CHECKING

# The JAX package's version: MCP's serverInfo reports it from either package.
__version__ = "0.5.0"

# The JAX package's top-level names (its ``_LAZY_ATTRS``) and the port's
# own clients and index.
_LAZY = {
    "Config": "lean_explore_tpu_torch.config",
    "SearchResult": "lean_explore_tpu_torch.models.search_types",
    "SearchResponse": "lean_explore_tpu_torch.models.search_types",
    "SearchResultSummary": "lean_explore_tpu_torch.models.search_types",
    "SearchSummaryResponse": "lean_explore_tpu_torch.models.search_types",
    "Declaration": "lean_explore_tpu_torch.models.store",
    "SearchEngine": "lean_explore_tpu_torch.search.engine",
    "Service": "lean_explore_tpu_torch.search.service",
    "ApiClient": "lean_explore_tpu_torch.api.client",
    "EmbeddingClient": "lean_explore_tpu_torch.util.embedding_client",
    "RerankerClient": "lean_explore_tpu_torch.util.reranker_client",
    "DenseIndex": "lean_explore_tpu_torch.index.dense",
}

if TYPE_CHECKING:  # pragma: no cover
    from lean_explore_tpu_torch.api.client import ApiClient
    from lean_explore_tpu_torch.config import Config
    from lean_explore_tpu_torch.index.dense import DenseIndex
    from lean_explore_tpu_torch.models.search_types import (
        SearchResponse,
        SearchResult,
        SearchResultSummary,
        SearchSummaryResponse,
    )
    from lean_explore_tpu_torch.models.store import Declaration
    from lean_explore_tpu_torch.search.engine import SearchEngine
    from lean_explore_tpu_torch.search.service import Service
    from lean_explore_tpu_torch.util.embedding_client import EmbeddingClient
    from lean_explore_tpu_torch.util.reranker_client import RerankerClient


def __getattr__(name: str):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(import_module(module), name)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
