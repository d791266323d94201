"""Index artifact set: the in-memory handle, the BM25 name-index build and
the loader the serving path needs (lean_explore_tpu/index/artifacts.py).

The files are the JAX package's, unchanged (MANIFEST_SCHEMA 1):

    declarations.db          sqlite3 document store
    dense_embeddings.npy     normalized f32 [N_emb, D]
    dense_ids.npy            dense row -> declaration id
    bm25_name_spaced.npz     CSR BM25+ index over spaced name tokens
    bm25_name_raw.npz        CSR BM25+ index over whole-name tokens
    bm25_ids.npy             shared BM25 row -> declaration id
    manifest.json            schema/version/counts/dims

Building the artifacts from a store is a later slice.
"""

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from lean_explore_tpu_torch.index import dense as dense_mod
from lean_explore_tpu_torch.index.bm25 import Bm25Index, Bm25Params
from lean_explore_tpu_torch.index.dense import DenseIndex
from lean_explore_tpu_torch.search.tokenization import tokenize_raw, tokenize_spaced

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
