"""Model clients, device selection, stage timing and device traces.

The JAX package's lazy exports; nothing loads a model until it is used.
"""

from importlib import import_module
from typing import TYPE_CHECKING

_LAZY = {
    "EmbeddingClient": "lean_explore_tpu_torch.util.embedding_client",
    "EmbeddingResponse": "lean_explore_tpu_torch.util.embedding_client",
    "RerankerClient": "lean_explore_tpu_torch.util.reranker_client",
    "RerankerResponse": "lean_explore_tpu_torch.util.reranker_client",
    "RemoteEmbeddingClient": "lean_explore_tpu_torch.util.remote_embedding_client",
    "OpenRouterClient": "lean_explore_tpu_torch.util.openrouter_client",
    "setup_logging": "lean_explore_tpu_torch.util.logging",
    "StageTimings": "lean_explore_tpu_torch.util.profiling",
    "device_trace": "lean_explore_tpu_torch.util.profiling",
}

if TYPE_CHECKING:  # pragma: no cover
    from lean_explore_tpu_torch.util.embedding_client import (
        EmbeddingClient,
        EmbeddingResponse,
    )
    from lean_explore_tpu_torch.util.logging import setup_logging
    from lean_explore_tpu_torch.util.openrouter_client import OpenRouterClient
    from lean_explore_tpu_torch.util.profiling import StageTimings, device_trace
    from lean_explore_tpu_torch.util.remote_embedding_client import (
        RemoteEmbeddingClient,
    )
    from lean_explore_tpu_torch.util.reranker_client import (
        RerankerClient,
        RerankerResponse,
    )


def __getattr__(name: str):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(import_module(module), name)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
