"""Corpus embedding stage, with the byte-level cache
(lean_explore_tpu/extract/embeddings.py):

- a cross-database cache keyed by exact informalization text, so unchanged
  declarations reuse prior embeddings byte for byte;
- incremental: only rows with an informalization and no embedding;
- batched store commits, so a crash resumes where it left off.

When LEAN_EXPLORE_MESH_SHAPE is set the default client splits each batch
over that many devices (``_embed_mesh``), as the JAX stage does.
"""

import logging
import sqlite3
import time
from pathlib import Path

import numpy as np
import torch

from lean_explore_tpu_torch.config import Config
from lean_explore_tpu_torch.models.store import DeclarationStore, unpack_embedding

logger = logging.getLogger(__name__)

DEFAULT_BATCH_SIZE = 250


def _embed_mesh(device: str | torch.device | None = None):
    """The corpus embedder's all-device data mesh when multi-device serving
    is configured (LEAN_EXPLORE_MESH_SHAPE), else None: every device of
    ``device``'s kind that the shape names goes on the ``data`` axis (the
    trunk is replicated; splitting the batches is the gain). A shape that
    names more devices than there are raises."""
    shape = Config.mesh_shape()
    if shape is None:
        return None
    from lean_explore_tpu_torch.parallel.mesh import SERVE_AXES, make_mesh
    from lean_explore_tpu_torch.util.platform import mesh_devices

    return make_mesh(
        (shape[0] * shape[1], 1), axis_names=SERVE_AXES, devices=mesh_devices(device)
    )


def load_embedding_cache(
    database_files: list[Path], wanted: set[str] | None = None
) -> dict[str, list[float]]:
    """informalization text -> embedding, scanned across prior databases.

    ``wanted`` restricts the cache to the texts actually pending, so blobs
    of rows nobody needs are never decoded.
    """
    cache: dict[str, list[float]] = {}
    for db_path in database_files:
        try:
            conn = sqlite3.connect(str(db_path))
            try:
                cursor = conn.execute(
                    "SELECT informalization, informalization_embedding "
                    "FROM declarations WHERE informalization IS NOT NULL "
                    "AND informalization_embedding IS NOT NULL"
                )
                for text, blob in cursor:
                    if text in cache:
                        continue
                    if wanted is not None and text not in wanted:
                        continue
                    vector = unpack_embedding(blob)
                    if vector:
                        cache[text] = vector
            finally:
                conn.close()
        except sqlite3.DatabaseError as error:
            logger.warning("skipping cache db %s: %s", db_path, error)
            continue
    logger.info("embedding cache: %d entries", len(cache))
    return cache


def generate_embeddings(
    store: DeclarationStore,
    *,
    client=None,
    model_name: str | None = None,
    batch_size: int = DEFAULT_BATCH_SIZE,
    use_cache: bool = True,
    limit: int | None = None,
    device: str | torch.device | None = None,
) -> int:
    """Embed every informalization that lacks an embedding.

    Args:
        store: Target declaration store.
        client: Object with ``embed_sync(texts) -> np.ndarray``; the port's
            EmbeddingClient is constructed from config when None.
        model_name: Model id for the default client.
        batch_size: Declarations per device batch + commit.
        use_cache: Reuse embeddings from prior databases by text equality.
        limit: Optional cap (smoke tests).
        device: Device of the default client (default CUDA; "cpu" asks for
            the CPU); with LEAN_EXPLORE_MESH_SHAPE set, its batches split
            over that many devices of this kind (``_embed_mesh``).

    Returns:
        Number of embeddings written.
    """
    todo = list(store.iter_missing_embedding())
    if limit:
        todo = todo[:limit]
    if not todo:
        logger.info("nothing to embed")
        return 0

    cache: dict[str, list[float]] = {}
    if use_cache:
        from lean_explore_tpu_torch.extract.informalize import discover_database_files

        cache = load_embedding_cache(
            discover_database_files(),
            wanted={d.informalization for d in todo if d.informalization},
        )

    cached_rows = [
        (d.id, cache[d.informalization]) for d in todo if d.informalization in cache
    ]
    if cached_rows:
        for start in range(0, len(cached_rows), 1000):
            store.set_embeddings(cached_rows[start : start + 1000])
        logger.info("reused %d cached embeddings", len(cached_rows))
    remaining = [d for d in todo if d.informalization not in cache]
    if not remaining:
        return len(cached_rows)

    if client is None:
        from lean_explore_tpu_torch.util.embedding_client import EmbeddingClient

        client = EmbeddingClient(
            model_name or Config.EMBEDDING_MODEL_NAME,
            max_length=Config.EMBEDDING_MAX_LENGTH,
            batch_size=batch_size,
            device=device,
            mesh=_embed_mesh(device),
        )

    written = len(cached_rows)
    start_time = time.perf_counter()
    for start in range(0, len(remaining), batch_size):
        batch = remaining[start : start + batch_size]
        vectors = client.embed_sync([d.informalization for d in batch])
        store.set_embeddings((d.id, np.asarray(v)) for d, v in zip(batch, vectors))
        written += len(batch)
        rate = (written - len(cached_rows)) / max(
            time.perf_counter() - start_time, 1e-9
        )
        logger.info("embedded %d/%d (%.1f emb/s)", written, len(todo), rate)
    return written
