"""Search layer: engine, service, scoring, tokenization.

``SearchEngine`` and ``Service`` load on first use, as the JAX package's
lazy exports do.
"""

from importlib import import_module
from typing import TYPE_CHECKING

_LAZY = {
    "SearchEngine": "lean_explore_tpu_torch.search.engine",
    "Service": "lean_explore_tpu_torch.search.service",
}

if TYPE_CHECKING:  # pragma: no cover
    from lean_explore_tpu_torch.search.engine import SearchEngine
    from lean_explore_tpu_torch.search.service import Service


def __getattr__(name: str):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(import_module(module), name)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
