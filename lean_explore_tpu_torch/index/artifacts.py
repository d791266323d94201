"""Index artifact set: build, load and the in-memory handle
(lean_explore_tpu/index/artifacts.py).

The files are the JAX package's, unchanged (MANIFEST_SCHEMA 1):

    declarations.db          sqlite3 document store
    dense_embeddings.npy     normalized f32 [N_emb, D]
    dense_ids.npy            dense row -> declaration id
    bm25_name_spaced.npz     CSR BM25+ index over spaced name tokens
    bm25_name_raw.npz        CSR BM25+ index over whole-name tokens
    bm25_ids.npy             shared BM25 row -> declaration id
    manifest.json            schema/version/counts/dims

The BM25 indices cover every declaration; the dense index only the rows
with embeddings. Either package loads what the other builds.
"""

import json
import logging
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from lean_explore_tpu_torch.config import REQUIRED_INDEX_FILES
from lean_explore_tpu_torch.index import dense as dense_mod
from lean_explore_tpu_torch.index.bm25 import Bm25Index, Bm25Params
from lean_explore_tpu_torch.index.dense import DenseIndex
from lean_explore_tpu_torch.models.store import DeclarationStore
from lean_explore_tpu_torch.search.tokenization import tokenize_raw, tokenize_spaced

logger = logging.getLogger(__name__)

MANIFEST_SCHEMA = 1

BM25_SPACED_FILE = "bm25_name_spaced.npz"
BM25_RAW_FILE = "bm25_name_raw.npz"
BM25_IDS_FILE = "bm25_ids.npy"
MANIFEST_FILE = "manifest.json"


@dataclass
class IndexArtifacts:
    """In-memory handle to a loaded artifact set."""

    dense: DenseIndex
    bm25_spaced: Bm25Index
    bm25_raw: Bm25Index
    bm25_ids: np.ndarray
    manifest: dict


def build_bm25_name_indices(
    names: list[str], params: Bm25Params | None = None
) -> tuple[Bm25Index, Bm25Index]:
    """Two BM25+ name indices with per-doc token dedup."""
    params = params or Bm25Params()
    corpus_spaced = [sorted(set(tokenize_spaced(n))) for n in names]
    corpus_raw = [sorted(set(tokenize_raw(n))) for n in names]
    return Bm25Index.build(corpus_spaced, params), Bm25Index.build(corpus_raw, params)


def build_index_artifacts(
    store: DeclarationStore,
    output_directory: str | Path,
    *,
    embedding_dim: int | None = None,
) -> dict:
    """Build every index artifact from a populated declaration store.

    The store's own db file must already live at (or be copied to)
    output_directory/declarations.db by the caller (extract.index does).

    Returns:
        The manifest dict.
    """
    output_directory = Path(output_directory)
    output_directory.mkdir(parents=True, exist_ok=True)

    all_ids: list[int] = []
    all_names: list[str] = []
    emb_ids: list[int] = []
    emb_rows: list[np.ndarray] = []
    for decl in store.iter_all():
        all_ids.append(decl.id)
        all_names.append(decl.name or "")
        if decl.informalization_embedding is not None:
            emb_ids.append(decl.id)
            emb_rows.append(
                np.asarray(decl.informalization_embedding, dtype=np.float32)
            )
    logger.info(
        "Building index artifacts: %d declarations, %d embedded",
        len(all_ids),
        len(emb_ids),
    )

    bm25_spaced, bm25_raw = build_bm25_name_indices(all_names)
    bm25_spaced.save(output_directory / BM25_SPACED_FILE)
    bm25_raw.save(output_directory / BM25_RAW_FILE)
    np.save(output_directory / BM25_IDS_FILE, np.asarray(all_ids, dtype=np.int64))

    if emb_rows:
        matrix = np.stack(emb_rows)
        dim = matrix.shape[1]
    else:
        dim = embedding_dim or 0
        matrix = np.zeros((0, dim), dtype=np.float32)
    # Normalized on the host: an offline build needs no device round trip
    # (the serving dtype and padding are load-time choices).
    norms = np.linalg.norm(matrix, axis=1, keepdims=True)
    normalized = (matrix / np.maximum(norms, 1e-12)).astype(np.float32)
    np.save(output_directory / dense_mod.EMBEDDINGS_FILE, normalized)
    np.save(
        output_directory / dense_mod.IDS_FILE, np.asarray(emb_ids, dtype=np.int64)
    )

    manifest = {
        "schema": MANIFEST_SCHEMA,
        "created_unix": int(time.time()),
        "n_declarations": len(all_ids),
        "n_embedded": len(emb_ids),
        "embedding_dim": dim,
        "bm25_method": bm25_spaced.params.method,
        "files": REQUIRED_INDEX_FILES,
    }
    (output_directory / MANIFEST_FILE).write_text(json.dumps(manifest, indent=2))
    logger.info("Index artifacts written to %s", output_directory)
    return manifest


def load_index_artifacts(
    directory: str | Path,
    *,
    dense_dtype: str = "float32",
    device: str | torch.device | None = None,
) -> IndexArtifacts:
    """Load an artifact set, the dense matrix onto ``device`` (default
    CUDA); raises FileNotFoundError on incomplete dirs."""
    directory = Path(directory)
    manifest_path = directory / MANIFEST_FILE
    if not manifest_path.exists():
        raise FileNotFoundError(
            f"Index manifest not found at {manifest_path}. "
            "Run 'lean-explore data fetch' or the extraction pipeline first."
        )
    manifest = json.loads(manifest_path.read_text())
    schema = manifest.get("schema")
    if schema != MANIFEST_SCHEMA:
        raise ValueError(
            f"Index artifact schema {schema!r} at {directory} does not match "
            f"this build's schema {MANIFEST_SCHEMA}."
        )
    index_files = (
        dense_mod.EMBEDDINGS_FILE,
        dense_mod.IDS_FILE,
        BM25_SPACED_FILE,
        BM25_RAW_FILE,
        BM25_IDS_FILE,
    )
    missing = [f for f in index_files if not (directory / f).exists()]
    if missing:
        raise FileNotFoundError(
            f"Index artifact set at {directory} is incomplete (missing "
            f"{', '.join(missing)})."
        )
    return IndexArtifacts(
        dense=DenseIndex.load(directory, dtype=dense_dtype, device=device),
        bm25_spaced=Bm25Index.load(directory / BM25_SPACED_FILE),
        bm25_raw=Bm25Index.load(directory / BM25_RAW_FILE),
        bm25_ids=np.load(directory / BM25_IDS_FILE),
        manifest=manifest,
    )
