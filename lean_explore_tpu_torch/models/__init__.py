"""Data models: wire types, the sqlite3 store, the tokenizer, the Qwen3 trunk.

The names of the JAX package's ``models.__all__``, loaded on first use.
"""

from importlib import import_module
from typing import TYPE_CHECKING

_LAZY = {
    "Declaration": "lean_explore_tpu_torch.models.store",
    "DeclarationStore": "lean_explore_tpu_torch.models.store",
    "SearchResponse": "lean_explore_tpu_torch.models.search_types",
    "SearchResult": "lean_explore_tpu_torch.models.search_types",
    "SearchResultSummary": "lean_explore_tpu_torch.models.search_types",
    "SearchSummaryResponse": "lean_explore_tpu_torch.models.search_types",
    "extract_bold_description": "lean_explore_tpu_torch.models.search_types",
    "pack_embedding": "lean_explore_tpu_torch.models.store",
    "unpack_embedding": "lean_explore_tpu_torch.models.store",
}

if TYPE_CHECKING:  # pragma: no cover
    from lean_explore_tpu_torch.models.search_types import (
        SearchResponse,
        SearchResult,
        SearchResultSummary,
        SearchSummaryResponse,
        extract_bold_description,
    )
    from lean_explore_tpu_torch.models.store import (
        Declaration,
        DeclarationStore,
        pack_embedding,
        unpack_embedding,
    )


def __getattr__(name: str):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(import_module(module), name)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
