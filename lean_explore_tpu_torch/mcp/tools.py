"""The eight MCP tools (lean_explore_tpu/mcp/tools.py).

The same names, descriptions, argument schemas and response shapes:
``search`` (full results), ``search_summary`` (id, name and short
description) and six per-field getters keyed by declaration id.
"""

import asyncio
import logging

from lean_explore_tpu_torch.mcp.app import get_backend_service, mcp_app
from lean_explore_tpu_torch.models.search_types import (
    SearchResult,
    SearchResultSummary,
    SearchSummaryResponse,
    extract_bold_description,
)

logger = logging.getLogger(__name__)

_SEARCH_SCHEMA = {
    "type": "object",
    "properties": {
        "query": {
            "type": "string",
            "description": (
                "A Lean declaration name (e.g., 'List.filter') or an informal "
                "natural language description (e.g., 'prime number "
                "divisibility')."
            ),
        },
        "limit": {
            "type": "integer",
            "description": "Maximum number of results.",
            "default": 10,
        },
        "rerank_top": {
            "type": ["integer", "null"],
            "description": (
                "Number of candidates to rerank with the cross-encoder; 0 or "
                "null skips reranking. Local backend only."
            ),
            "default": 50,
        },
        "packages": {
            "type": ["array", "null"],
            "items": {"type": "string"},
            "description": "Restrict results to these packages.",
            "default": None,
        },
    },
    "required": ["query"],
}

_ID_SCHEMA = {
    "type": "object",
    "properties": {
        "declaration_id": {
            "type": "integer",
            "description": "Numeric id from a search or search_summary result.",
        }
    },
    "required": ["declaration_id"],
}


async def _backend_search(query, limit, rerank_top, packages):
    backend = get_backend_service()
    if not hasattr(backend, "search"):
        raise RuntimeError("Search functionality not available on backend.")
    call = backend.search(
        query=query, limit=limit, rerank_top=rerank_top, packages=packages
    )
    return await call if asyncio.iscoroutine(call) else call


async def _backend_get_by_id(declaration_id: int) -> SearchResult | None:
    backend = get_backend_service()
    if not hasattr(backend, "get_by_id"):
        raise RuntimeError("Get-by-id functionality not available on backend.")
    call = backend.get_by_id(declaration_id=declaration_id)
    return await call if asyncio.iscoroutine(call) else call


@mcp_app.tool(
    name="search",
    description=(
        "Search Lean 4 declarations and return full results including source "
        "code, module, dependencies, and informalization. Accepts declaration "
        "names ('List.map') or natural-language descriptions ('continuous "
        "function on a compact set'); hybrid retrieval handles both. Prefer "
        "search_summary + per-field tools to save tokens."
    ),
    input_schema=_SEARCH_SCHEMA,
)
async def search(query, limit=10, rerank_top=50, packages=None):
    response = await _backend_search(query, limit, rerank_top, packages)
    return response.model_dump(exclude_none=True)


@mcp_app.tool(
    name="search_summary",
    description=(
        "Search Lean 4 declarations and return concise results (id, name, "
        "short description) — the recommended first step; follow up with the "
        "per-field tools for details. Accepts declaration names or natural-"
        "language descriptions."
    ),
    input_schema=_SEARCH_SCHEMA,
)
async def search_summary(query, limit=10, rerank_top=50, packages=None):
    response = await _backend_search(query, limit, rerank_top, packages)
    summary = SearchSummaryResponse(
        query=response.query,
        results=[
            SearchResultSummary(
                id=r.id,
                name=r.name,
                description=extract_bold_description(r.informalization),
            )
            for r in response.results
        ],
        count=response.count,
        processing_time_ms=response.processing_time_ms,
    )
    # Only the envelope drops its None fields: a result without a
    # description keeps "description": null, as the JAX tool's dict does.
    return {k: v for k, v in summary.model_dump().items() if v is not None}


def _field_tool(tool_name: str, field: str, description: str):
    @mcp_app.tool(name=tool_name, description=description, input_schema=_ID_SCHEMA)
    async def getter(declaration_id):
        result = await _backend_get_by_id(int(declaration_id))
        if result is None:
            return None
        return {"id": result.id, "name": result.name, field: getattr(result, field)}

    getter.__name__ = tool_name
    return getter


get_source_code = _field_tool(
    "get_source_code",
    "source_text",
    "Retrieve the Lean 4 source code for a declaration by id.",
)
get_source_link = _field_tool(
    "get_source_link",
    "source_link",
    "Retrieve the GitHub source link for a declaration by id.",
)
get_docstring = _field_tool(
    "get_docstring",
    "docstring",
    "Retrieve the docstring for a declaration by id.",
)
get_description = _field_tool(
    "get_description",
    "informalization",
    "Retrieve the natural language description (informalization) for a "
    "declaration by id.",
)
get_module = _field_tool(
    "get_module",
    "module",
    "Retrieve the module path for a declaration by id (e.g., "
    "'Mathlib.Data.List.Basic').",
)
get_dependencies = _field_tool(
    "get_dependencies",
    "dependencies",
    "Retrieve the JSON array of declaration names this declaration depends on.",
)
