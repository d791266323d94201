"""Wire types for search responses, as plain dataclasses.

Same field names as the JAX package's pydantic models
(lean_explore_tpu/models/search_types.py); ``model_dump`` and
``model_copy`` take the pydantic arguments the serving surfaces use and
return the same values, so consumers see one schema from either package.
"""

import dataclasses
import re

_BOLD_HEADER_RE = re.compile(r"\*\*(.+?)\*\*")


def extract_bold_description(informalization: str | None) -> str | None:
    """The leading ``**Bold Title.**`` header of an informalization (the
    text between its first pair of ``**`` at the start), or None: the JAX
    package's function of the same name."""
    if not informalization:
        return None
    match = _BOLD_HEADER_RE.match(informalization)
    return match.group(1) if match else None


def _dump(value, exclude_none: bool):
    if dataclasses.is_dataclass(value):
        out = {}
        for f in dataclasses.fields(value):
            item = getattr(value, f.name)
            if item is None and exclude_none:
                continue
            out[f.name] = _dump(item, exclude_none)
        return out
    if isinstance(value, list):
        return [_dump(item, exclude_none) for item in value]
    return value


class _Dumpable:
    def model_dump(self, *, mode: str = "python", exclude_none: bool = False) -> dict:
        """The fields as a dict, nested results included. ``exclude_none``
        drops None fields at every depth, as pydantic does; every field is
        an int, a str, None or a list of results, so ``mode="json"`` gives
        the same dict as ``"python"``."""
        if mode not in ("python", "json"):
            raise ValueError(f"mode must be 'python' or 'json', got {mode!r}")
        return _dump(self, exclude_none)

    def model_copy(self, *, update: dict | None = None):
        """A shallow copy with the fields of ``update`` replaced."""
        return dataclasses.replace(self, **(update or {}))


@dataclasses.dataclass(slots=True)
class SearchResultSummary(_Dumpable):
    """Slim result (id, name, short description) for token-frugal MCP output."""

    id: int
    name: str
    description: str | None


@dataclasses.dataclass(slots=True)
class SearchSummaryResponse(_Dumpable):
    """Envelope for slim search results."""

    query: str
    results: list[SearchResultSummary]
    count: int
    processing_time_ms: int | None = None


@dataclasses.dataclass(slots=True)
class SearchResult(_Dumpable):
    """One Lean declaration returned from search (full fields)."""

    id: int
    name: str
    module: str
    docstring: str | None
    source_text: str
    source_link: str
    dependencies: str | None
    informalization: str | None

    @classmethod
    def from_dict(cls, data: dict) -> "SearchResult":
        """A result from its wire dict; keys that are not fields are
        ignored, as pydantic ignores them by default."""
        names = [f.name for f in dataclasses.fields(cls)]
        return cls(**{name: data[name] for name in names if name in data})


@dataclasses.dataclass(slots=True)
class SearchResponse(_Dumpable):
    """Envelope for full search results."""

    query: str
    results: list[SearchResult]
    count: int
    processing_time_ms: int | None = None
