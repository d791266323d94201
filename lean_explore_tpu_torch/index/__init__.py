"""Index layer: dense (device matmul) + BM25 (CSR) indices and artifact I/O.

The names of the JAX package's ``index.__all__``, loaded on first use so
that importing the package loads no index.
"""

from importlib import import_module
from typing import TYPE_CHECKING

_LAZY = {
    "Bm25Index": "lean_explore_tpu_torch.index.bm25",
    "Bm25Params": "lean_explore_tpu_torch.index.bm25",
    "DenseIndex": "lean_explore_tpu_torch.index.dense",
    "IndexArtifacts": "lean_explore_tpu_torch.index.artifacts",
    "build_bm25_name_indices": "lean_explore_tpu_torch.index.artifacts",
    "build_index_artifacts": "lean_explore_tpu_torch.index.artifacts",
    "load_index_artifacts": "lean_explore_tpu_torch.index.artifacts",
}

if TYPE_CHECKING:  # pragma: no cover
    from lean_explore_tpu_torch.index.artifacts import (
        IndexArtifacts,
        build_bm25_name_indices,
        build_index_artifacts,
        load_index_artifacts,
    )
    from lean_explore_tpu_torch.index.bm25 import Bm25Index, Bm25Params
    from lean_explore_tpu_torch.index.dense import DenseIndex


def __getattr__(name: str):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(import_module(module), name)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
