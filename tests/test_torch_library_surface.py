"""The port's library surface against the JAX package's, on the CPU.

Every name that ``lean_explore_tpu`` exports lazily at the top level
(``_LAZY_ATTRS``) and every name that its ``index``, ``models``, ``ops``,
``search`` and ``util`` export (``__all__`` or ``_LAZY``) resolves from the
port's counterpart, to an object of the port; the summary types dump as
JAX's pydantic models do, and the MCP ``search_summary`` tool answers with
JAX's JSON, byte for byte; ``util.profiling.device_trace`` writes a
``torch.profiler`` trace on the CPU and does nothing without a directory.
"""

import asyncio
import importlib
import json

import pytest
import torch

import lean_explore_tpu
import lean_explore_tpu_torch
from lean_explore_tpu.mcp import app as jax_app
from lean_explore_tpu.mcp import tools as jax_tools
from lean_explore_tpu.models import search_types as jax_types
from lean_explore_tpu_torch.mcp import app as port_app
from lean_explore_tpu_torch.mcp import tools as port_tools
from lean_explore_tpu_torch.models import search_types as port_types
from lean_explore_tpu_torch.util.profiling import device_trace

SUBPACKAGES = ("index", "models", "ops", "search", "util")


def _exports(module) -> list[str]:
    return list(getattr(module, "__all__", None) or module._LAZY)


def test_top_level_names_resolve_in_the_port():
    names = sorted(lean_explore_tpu._LAZY_ATTRS)
    assert {"Config", "SearchResultSummary", "SearchSummaryResponse", "ApiClient"} <= set(names)
    for name in names:
        value = getattr(lean_explore_tpu_torch, name)
        assert value.__module__.startswith("lean_explore_tpu_torch."), name
        assert name in dir(lean_explore_tpu_torch)
    with pytest.raises(AttributeError):
        lean_explore_tpu_torch.NoSuchName  # noqa: B018


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_names_resolve_in_the_port(sub):
    jax_module = importlib.import_module(f"lean_explore_tpu.{sub}")
    port_module = importlib.import_module(f"lean_explore_tpu_torch.{sub}")
    names = _exports(jax_module)
    assert names
    for name in names:
        value = getattr(port_module, name)
        assert value.__module__.startswith(f"lean_explore_tpu_torch.{sub}."), (sub, name)
        assert name in dir(port_module)
    with pytest.raises(AttributeError):
        getattr(port_module, "NoSuchName")


def test_summary_types_dump_as_jax_s():
    args = dict(query="q", results=[dict(id=3, name="A.b", description=None)], count=1)
    want = jax_types.SearchSummaryResponse(**args)
    got = port_types.SearchSummaryResponse(
        query="q", results=[port_types.SearchResultSummary(id=3, name="A.b", description=None)],
        count=1,
    )
    for kw in ({}, {"exclude_none": True}, {"mode": "json"}):
        assert got.model_dump(**kw) == want.model_dump(**kw)


class _Backend:
    """Answers every search with one fixed response of the given package."""

    def __init__(self, types):
        self.response = types.SearchResponse(
            query="nat add",
            results=[
                types.SearchResult(
                    id=i, name=f"Nat.add_{i}", module="M", docstring=None, source_text="s",
                    source_link="l", dependencies=None, informalization=text,
                )
                for i, text in enumerate(["**Addition.** of naturals", None, "no header"])
            ],
            count=3,
            processing_time_ms=7,
        )

    async def search(self, query, limit, rerank_top, packages):
        return self.response


@pytest.mark.parametrize("processing_time_ms", [7, None])
def test_search_summary_json_is_jax_s(monkeypatch, processing_time_ms):
    """A result without an informalization keeps ``"description": null``
    and the envelope drops a missing processing time, in both."""
    answers = []
    for app, tools, types in ((jax_app, jax_tools, jax_types), (port_app, port_tools, port_types)):
        backend = _Backend(types)
        backend.response.processing_time_ms = processing_time_ms
        monkeypatch.setattr(app, "_backend_service", backend)
        answers.append(json.dumps(asyncio.run(tools.search_summary("nat add", limit=3))))
    assert answers[1] == answers[0]
    assert '"description": null' in answers[1]
    assert ("processing_time_ms" in answers[1]) == (processing_time_ms is not None)


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    with device_trace(tmp_path / "trace"):
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("matmul" in str(e.get("name", "")) for e in events)


@pytest.mark.parametrize("log_dir", [None, ""])
def test_device_trace_without_a_directory_does_nothing(tmp_path, monkeypatch, log_dir):
    monkeypatch.chdir(tmp_path)
    with device_trace(log_dir):
        torch.ones(3).sum()
    assert list(tmp_path.iterdir()) == []
