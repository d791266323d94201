"""The database discovery the embedding cache needs
(lean_explore_tpu/extract/informalize.py ``discover_database_files``).

Informalization itself calls an LLM over the network and is not ported
(ROADMAP A10).
"""

import logging
from pathlib import Path

from lean_explore_tpu_torch.config import Config

logger = logging.getLogger(__name__)


def discover_database_files() -> list[Path]:
    """Every declarations.db under the data and cache roots."""
    found: list[Path] = []
    for root in (Config.DATA_DIRECTORY, Config.CACHE_DIRECTORY):
        if root.exists():
            found.extend(root.rglob("declarations.db"))
    logger.info("discovered %d databases for cache scan", len(found))
    return found
