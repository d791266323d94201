"""The settings the serving slice reads, with the JAX package's environment
variables and defaults (lean_explore_tpu/config.py), so a deployment
switches packages without changing its environment.
"""

import os
import pathlib

def _active_version() -> str:
    """Data version: env > active_version marker beside the cache > default."""
    env_version = os.getenv("LEAN_EXPLORE_VERSION")
    if env_version:
        return env_version
    marker = _cache_directory().parent / "active_version"
    if marker.exists():
        return marker.read_text().strip()
    return "v0.1.0"


def _cache_directory() -> pathlib.Path:
    return pathlib.Path(
        os.getenv(
            "LEAN_EXPLORE_CACHE_DIR",
            pathlib.Path.home() / ".lean_explore_tpu" / "cache",
        )
    )


class Config:
    """Settings resolved once at import from the environment."""

    CACHE_DIRECTORY: pathlib.Path = _cache_directory()
    ACTIVE_VERSION: str = _active_version()
    ACTIVE_CACHE_PATH: pathlib.Path = CACHE_DIRECTORY / ACTIVE_VERSION
    """Default artifact directory of SearchEngine."""

    EMBEDDING_MODEL_NAME: str = os.getenv(
        "LEAN_EXPLORE_EMBEDDING_MODEL", "Qwen/Qwen3-Embedding-0.6B"
    )
    RERANKER_MODEL_NAME: str = os.getenv(
        "LEAN_EXPLORE_RERANKER_MODEL", "Qwen/Qwen3-Reranker-0.6B"
    )
    EMBEDDING_MAX_LENGTH: int = int(
        os.getenv("LEAN_EXPLORE_EMBEDDING_MAX_LENGTH", "512")
    )
    RERANKER_MAX_LENGTH: int = int(
        os.getenv("LEAN_EXPLORE_RERANKER_MAX_LENGTH", "256")
    )

    CORPUS_DTYPE: str = os.getenv("LEAN_EXPLORE_CORPUS_DTYPE", "bfloat16")
    """On-device corpus dtype: bfloat16 halves the bytes of the retrieval
    pass; float32 gives exact scores; int8 (per-row quantized codes and
    scales) halves bfloat16's bytes again at a small recall cost."""

    SERVE_QUERY_BATCH: int = int(os.getenv("LEAN_EXPLORE_SERVE_QUERY_BATCH", "128"))
    """Most queries one engine step takes; larger batches are split."""

    PRELOAD_METADATA: bool = os.getenv("LEAN_EXPLORE_PRELOAD_METADATA", "") not in (
        "", "0", "false",
    )
    """Hold every declaration's metadata in memory (high-QPS serving)."""
