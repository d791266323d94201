"""lean_explore_tpu_torch: the PyTorch/CUDA port of lean_explore_tpu.

Hybrid search over Lean 4 declarations (BM25 + dense retrieval, RRF fusion,
dependency boost, Qwen3 cross-encoder rerank) on one NVIDIA GPU. Entry
points run on CUDA unless the caller passes ``device="cpu"``. Imports stay
lazy so that importing the package loads no model and builds no kernel.
"""

from importlib import import_module
from typing import TYPE_CHECKING

_LAZY = {
    "SearchEngine": "lean_explore_tpu_torch.search.engine",
    "Service": "lean_explore_tpu_torch.search.service",
    "EmbeddingClient": "lean_explore_tpu_torch.util.embedding_client",
    "RerankerClient": "lean_explore_tpu_torch.util.reranker_client",
    "DenseIndex": "lean_explore_tpu_torch.index.dense",
}

if TYPE_CHECKING:  # pragma: no cover
    from lean_explore_tpu_torch.index.dense import DenseIndex
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
