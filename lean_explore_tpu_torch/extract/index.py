"""Index-building stage: pack the store into serving artifacts
(lean_explore_tpu/extract/index.py)."""

import logging
import shutil
from pathlib import Path

from lean_explore_tpu_torch.index.artifacts import build_index_artifacts
from lean_explore_tpu_torch.models.store import DeclarationStore

logger = logging.getLogger(__name__)


def build_indices(
    store: DeclarationStore,
    output_directory: str | Path,
    *,
    copy_database: bool = True,
) -> dict:
    """Build dense + BM25 artifacts and colocate the database.

    Args:
        store: Populated declaration store.
        output_directory: Artifact directory (the serving data dir).
        copy_database: Copy the store's db file into the artifact dir when it
            lives elsewhere (serving expects declarations.db alongside).

    Returns:
        The manifest dict.
    """
    output_directory = Path(output_directory)
    output_directory.mkdir(parents=True, exist_ok=True)
    manifest = build_index_artifacts(store, output_directory)

    target_db = output_directory / "declarations.db"
    if copy_database and store.path != ":memory:":
        source_db = Path(store.path).resolve()
        if source_db != target_db.resolve():
            shutil.copy2(source_db, target_db)
            logger.info("copied database to %s", target_db)
    elif store.path == ":memory:" and not target_db.exists():
        logger.warning(
            "store is in-memory; declarations.db must be written separately"
        )
    return manifest
