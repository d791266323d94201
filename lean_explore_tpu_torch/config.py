"""The settings the serving and index-build paths read, with the JAX
package's environment variables and defaults (lean_explore_tpu/config.py),
so a deployment switches packages without changing its environment.
"""

import os
import pathlib
import re
from datetime import datetime

_TIMESTAMP_RE = re.compile(r"^\d{8}_\d{6}$")

REQUIRED_INDEX_FILES = [
    "declarations.db",
    "dense_embeddings.npy",
    "dense_ids.npy",
    "bm25_name_spaced.npz",
    "bm25_name_raw.npz",
    "bm25_ids.npy",
    "manifest.json",
]


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


def _data_directory() -> pathlib.Path:
    return pathlib.Path(
        os.getenv(
            "LEAN_EXPLORE_DATA_DIR",
            pathlib.Path(__file__).resolve().parent.parent / "data",
        )
    )


def timestamped_directories(data_directory: pathlib.Path) -> list[pathlib.Path]:
    """All YYYYMMDD_HHMMSS extraction dirs under data_directory, newest first."""
    if not data_directory.exists():
        return []
    dirs = [
        d
        for d in data_directory.iterdir()
        if d.is_dir() and _TIMESTAMP_RE.match(d.name)
    ]
    return sorted(dirs, key=lambda d: d.name, reverse=True)


def is_complete_index(directory: pathlib.Path) -> bool:
    """True when a directory holds every required index artifact."""
    return all((directory / name).exists() for name in REQUIRED_INDEX_FILES)


def _resolve_active_data_path(
    data_directory: pathlib.Path, version: str
) -> pathlib.Path:
    """The locally extracted serving data: ``data_directory`` itself when it
    holds a declarations.db, else its newest complete extraction (crashed
    runs skipped), else ``data_directory / version``."""
    if (data_directory / "declarations.db").exists():
        return data_directory
    for d in timestamped_directories(data_directory):
        if is_complete_index(d):
            return d
    return data_directory / version


class Config:
    """Settings resolved once at import from the environment."""

    CACHE_DIRECTORY: pathlib.Path = _cache_directory()
    DATA_DIRECTORY: pathlib.Path = _data_directory()
    """Extraction pipeline output root. Env: LEAN_EXPLORE_DATA_DIR."""
    ACTIVE_VERSION: str = _active_version()
    ACTIVE_CACHE_PATH: pathlib.Path = CACHE_DIRECTORY / ACTIVE_VERSION
    """Default artifact directory of SearchEngine (downloaded data)."""
    ACTIVE_DATA_PATH: pathlib.Path = _resolve_active_data_path(
        DATA_DIRECTORY, ACTIVE_VERSION
    )
    """Artifact directory of locally extracted data
    (``SearchEngine(use_local_data=True)``)."""
    EXTRACTION_DATABASE_PATH: pathlib.Path = ACTIVE_DATA_PATH / "declarations.db"

    PACKAGES_ROOT: pathlib.Path = pathlib.Path(
        os.getenv(
            "LEAN_EXPLORE_PACKAGES_ROOT",
            pathlib.Path(__file__).resolve().parent.parent / "lean",
        )
    )
    """Per-package Lean workspaces root. Env: LEAN_EXPLORE_PACKAGES_ROOT."""

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

    MESH_SHAPE: str = os.getenv("LEAN_EXPLORE_MESH_SHAPE", "")
    """Optional 'data,corpus' mesh shape. This package runs on one device
    and raises where more than one is configured (ROADMAP A7)."""

    R2_ASSETS_BASE_URL: str = os.getenv(
        "LEAN_EXPLORE_R2_BASE_URL",
        "https://pub-48b75babc4664808b15520033423c765.r2.dev",
    )
    """Artifact download base URL (``data fetch``)."""
    API_BASE_URL: str = os.getenv(
        "LEAN_EXPLORE_API_BASE_URL", "https://www.leanexplore.com/api/v2"
    )
    """Search API base URL of ``ApiClient``."""

    @staticmethod
    def get_latest_extraction_path() -> pathlib.Path | None:
        """Newest timestamped extraction dir, or None."""
        dirs = timestamped_directories(Config.DATA_DIRECTORY)
        return dirs[0] if dirs else None

    @staticmethod
    def get_latest_database_path() -> pathlib.Path | None:
        """declarations.db inside the newest extraction dir, if present."""
        latest = Config.get_latest_extraction_path()
        if latest and (latest / "declarations.db").exists():
            return latest / "declarations.db"
        return None

    @staticmethod
    def create_timestamped_extraction_path() -> pathlib.Path:
        """Create and return a new YYYYMMDD_HHMMSS extraction directory."""
        path = Config.DATA_DIRECTORY / datetime.now().strftime("%Y%m%d_%H%M%S")
        path.mkdir(parents=True, exist_ok=True)
        return path

    @staticmethod
    def mesh_shape() -> tuple[int, int] | None:
        """Parse MESH_SHAPE into (data, corpus) axis sizes, or None."""
        if not Config.MESH_SHAPE:
            return None
        parts = [int(p) for p in Config.MESH_SHAPE.split(",")]
        if len(parts) == 1:
            return (1, parts[0])
        return (parts[0], parts[1])
