"""Wire types for search responses, as plain dataclasses.

Same field names as the JAX package's pydantic models
(lean_explore_tpu/models/search_types.py); ``model_dump()`` returns the
same dict, so consumers see one schema from either package.
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


class _Dumpable:
    def model_dump(self) -> dict:
        return dataclasses.asdict(self)


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


@dataclasses.dataclass(slots=True)
class SearchResponse(_Dumpable):
    """Envelope for full search results."""

    query: str
    results: list[SearchResult]
    count: int
    processing_time_ms: int | None = None
