"""The port's rerank cascade, single-query API and chained scoring against
the JAX client, on the CPU.

Both clients load the same float32 checkpoints (a tiny random one from
``tests.helpers.make_tiny_model_dir`` and the committed
``runs/reranker/checkpoint``) and score the same documents, drawn with a
numpy seed from each tokenizer's vocabulary. Scores agree within 1e-5, the
reranker tolerance of tests/test_torch_qwen3.py, and the order they give
is the same; a cascade's composition (keep set, ordinal band) is checked
exactly. ``_truncate_docs`` gives JAX's strings, on the committed
tokenizers that the cascade serves.
"""

import asyncio
import json
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from lean_explore_tpu.models.tokenizer import load_tokenizer as jax_load_tokenizer
from lean_explore_tpu.util.reranker_client import RerankerClient as JaxReranker
from lean_explore_tpu_torch.models import qwen3
from lean_explore_tpu_torch.models.tokenizer import encode_batch, load_tokenizer
from lean_explore_tpu_torch.search.engine import SearchEngine
from lean_explore_tpu_torch.util.reranker_client import RerankerClient, RerankerResponse
from tests.helpers import make_tiny_model_dir

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-5
CASCADE = "LEAN_EXPLORE_RERANK_CASCADE"


@pytest.fixture(scope="module", params=["tiny", "committed"])
def clients(request, tmp_path_factory):
    if request.param == "tiny":
        path = make_tiny_model_dir(tmp_path_factory.mktemp("tiny_cascade"), seed=5)
    else:
        path = REPO / "runs" / "reranker" / "checkpoint"
    port = RerankerClient(
        str(path), model_dir=path, dtype=torch.float32, max_length=64, device="cpu"
    )
    jax_client = JaxReranker(str(path), model_dir=path, dtype="float32", max_length=64)
    return port, jax_client


def _words(tokenizer) -> list[str]:
    return sorted(w for w in tokenizer.vocab if w.isalpha() and w not in ("true", "false"))


def _groups(port, sizes=(6, 2, 5, 0, 3), seed=0):
    """Queries and document groups of the given sizes, 4-11 words a
    document, from the tokenizer's own words."""
    words = _words(port.tokenizer)
    rng = np.random.default_rng(seed)

    def text(lo, hi):
        return " ".join(rng.choice(words, size=int(rng.integers(lo, hi))))

    queries = [text(2, 4) for _ in sizes]
    docs = [[text(4, 12) for _ in range(n)] for n in sizes]
    return queries, docs


def _expect_same(got, want):
    assert [len(g) for g in got] == [len(w) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=TOL)
        assert np.argsort(-np.asarray(g), kind="stable").tolist() == np.argsort(
            -np.asarray(w), kind="stable"
        ).tolist()


@pytest.mark.parametrize("cap,keep", [(3, 2), (5, 4)])
def test_cascade_matches_jax(clients, cap, keep):
    port, jax_client = clients
    queries, docs = _groups(port)
    kw = dict(stage1_doc_tokens=cap, keep=keep)
    _expect_same(
        port.rerank_grouped_cascade_sync(queries, docs, **kw),
        jax_client.rerank_grouped_cascade_sync(queries, docs, **kw),
    )


def test_keep_at_least_every_group_equals_the_full_rerank(clients):
    port, _ = clients
    queries, docs = _groups(port)
    full = port.rerank_grouped_sync(queries, docs)
    assert port.rerank_grouped_cascade_sync(
        queries, docs, stage1_doc_tokens=3, keep=max(map(len, docs))
    ) == full


def _spy_grouped(monkeypatch, port) -> list[dict]:
    calls = []
    real = port.rerank_grouped_sync

    def spy(queries, docs_grouped, **kw):
        calls.append(dict(queries=list(queries), docs=[list(d) for d in docs_grouped], **kw))
        return real(queries, docs_grouped, **kw)

    monkeypatch.setattr(port, "rerank_grouped_sync", spy)
    return calls


def test_only_groups_over_keep_get_stage_one(clients, monkeypatch):
    port, _ = clients
    queries, docs = _groups(port)
    calls = _spy_grouped(monkeypatch, port)
    port.rerank_grouped_cascade_sync(queries, docs, stage1_doc_tokens=3, keep=3)
    stage1, stage2 = calls
    assert stage1["suffix_cap"] == 3
    assert stage1["queries"] == [q for q, d in zip(queries, docs) if len(d) > 3]
    assert "suffix_cap" not in stage2 and stage2["queries"] == queries
    assert [len(d) for d in stage2["docs"]] == [min(len(d), 3) for d in docs]


def test_pruned_candidates_keep_stage_one_order_below_the_rescored(clients):
    port, _ = clients
    queries, docs = _groups(port)
    keep, cap = 2, 3
    out = port.rerank_grouped_cascade_sync(queries, docs, stage1_doc_tokens=cap, keep=keep)
    need = [gi for gi, group in enumerate(docs) if len(group) > keep]
    assert need and len(need) < len(docs)
    stage1 = dict(zip(need, port.rerank_grouped_sync(
        [queries[gi] for gi in need], [docs[gi] for gi in need], suffix_cap=cap
    )))
    tops = [
        sorted(range(len(group)), key=lambda i: stage1[gi][i], reverse=True)
        if gi in stage1 else list(range(len(group)))
        for gi, group in enumerate(docs)
    ]
    stage2 = port.rerank_grouped_sync(
        queries, [[group[i] for i in top[:keep]] for group, top in zip(docs, tops)]
    )
    for group, scores, top, rescored in zip(docs, out, tops, stage2):
        kept, pruned = top[:keep], top[keep:]
        assert [scores[i] for i in kept] == rescored
        floor = min(rescored, default=0.0)
        assert [scores[i] for i in pruned] == [floor - 1e-4 * (j + 1) for j in range(len(pruned))]


def test_flat_path_honours_the_cap(clients, monkeypatch):
    port, jax_client = clients
    queries, docs = _groups(port)
    monkeypatch.setenv("LEAN_EXPLORE_RERANK_PREFIX", "0")
    got = port.rerank_grouped_sync(queries, docs, suffix_cap=3)
    _expect_same(got, jax_client.rerank_grouped_sync(queries, docs, suffix_cap=3))
    flat_q = [q for q, d in zip(queries, docs) for _ in d]
    truncated = port._truncate_docs([x for d in docs for x in d], 3)
    assert [s for row in got for s in row] == port.rerank_pairs_sync(flat_q, truncated)
    assert got != port.rerank_grouped_sync(queries, docs)


def test_tiny_prefix_fallback_honours_the_cap(clients, monkeypatch):
    """At max_length 4 no pair keeps MIN_SHARED_PREFIX shared tokens, so
    every group takes the flat fallback, which must score the truncated
    documents."""
    port, jax_client = clients
    queries, docs = _groups(port)
    monkeypatch.setattr(port, "max_length", 4)
    monkeypatch.setattr(jax_client, "max_length", 4)
    seen = []
    real = port.rerank_pairs_sync
    monkeypatch.setattr(
        port, "rerank_pairs_sync", lambda q, d: seen.append(list(d)) or real(q, d)
    )
    got = port.rerank_grouped_sync(queries, docs, suffix_cap=3)
    assert seen == [port._truncate_docs([x for d in docs for x in d], 3)]
    _expect_same(got, jax_client.rerank_grouped_sync(queries, docs, suffix_cap=3))


@pytest.mark.parametrize("value", ["4,2", "4", "a,b", "4,2,1", " , "])
def test_cascade_variable(clients, monkeypatch, value):
    port, jax_client = clients
    queries, docs = _groups(port, sizes=(5, 1))
    monkeypatch.setenv(CASCADE, value)
    try:
        want = asyncio.run(jax_client.rerank_grouped(queries, docs))
    except ValueError as err:
        with pytest.raises(ValueError) as raised:
            asyncio.run(port.rerank_grouped(queries, docs))
        assert str(raised.value) == str(err)
        return
    assert value == "4,2"
    got = asyncio.run(port.rerank_grouped(queries, docs))
    _expect_same(got, want)
    assert got == port.rerank_grouped_cascade_sync(queries, docs, stage1_doc_tokens=4, keep=2)


def test_cascade_rejects_what_jax_rejects(clients):
    port, _ = clients
    with pytest.raises(ValueError, match="must be positive"):
        port.rerank_grouped_cascade_sync(["q"], [["d"]], stage1_doc_tokens=0, keep=2)


def _bare(cls, tokenizer):
    client = object.__new__(cls)
    client.tokenizer = tokenizer
    client._tokenizer_lock = threading.Lock()
    return client


@pytest.mark.parametrize("checkpoint", ["reranker", "scale200k/reranker"])
def test_truncate_docs_gives_jax_s_strings(checkpoint):
    path = REPO / "runs" / checkpoint / "checkpoint"
    port = _bare(RerankerClient, load_tokenizer(path))
    jax_client = _bare(JaxReranker, jax_load_tokenizer(path))
    words = _words(port.tokenizer)
    rng = np.random.default_rng(1)
    docs = [" ".join(rng.choice(words, size=int(rng.integers(1, 30)))) for _ in range(20)]
    docs += [
        "Nat.add_comm: the sum , of two ; natural numbers .",
        "zzqx unknownword the (a + b) = c",
        "",
    ]
    for cap in (1, 3, 48):
        got = port._truncate_docs(docs, cap)
        assert got == jax_client._truncate_docs(docs, cap)
    assert got[0] == docs[0] or len(docs[0].split()) > 48


def test_rerank_sync_and_rerank_match_jax(clients):
    port, jax_client = clients
    queries, docs = _groups(port, sizes=(11,), seed=3)
    for batch_size in (None, 1, 4):
        got = port.rerank_sync(queries[0], docs[0], batch_size=batch_size)
        want = jax_client.rerank_sync(queries[0], docs[0], batch_size=batch_size)
        assert isinstance(got, RerankerResponse)
        assert (got.query, got.model) == (want.query, want.model)
        np.testing.assert_allclose(got.scores, want.scores, atol=TOL)
    assert asyncio.run(port.rerank(queries[0], docs[0], 1)) == port.rerank_sync(
        queries[0], docs[0], 1
    )
    assert port.rerank_sync("q", []).scores == []
    for bad in (0, -1):
        with pytest.raises(ValueError, match="batch_size must be positive"):
            port.rerank_sync("q", ["d"], batch_size=bad)


def test_rerank_pairs_sync_equals_the_per_bucket_loop(clients, monkeypatch):
    """Rebuilt on ``_score_encoded`` (chains of 8 same-shape buckets), the
    pair scores equal the earlier loop's, one ``rerank_scores`` call a
    bucket, bit for bit; and JAX's within TOL."""
    port, jax_client = clients
    queries, docs = _groups(port, sizes=(20, 20), seed=4)
    flat_q = [q for q, d in zip(queries, docs) for _ in d]
    flat_d = [x for d in docs for x in d]
    monkeypatch.setattr(port, "batch_size", 2)
    monkeypatch.setattr(jax_client, "batch_size", 2)
    chained = []
    real = qwen3.rerank_scores_chained
    monkeypatch.setattr(
        qwen3, "rerank_scores_chained", lambda *a, **k: chained.append(1) or real(*a, **k)
    )
    got = port.rerank_pairs_sync(flat_q, flat_d)
    assert chained, "no bucket shape filled a chain"

    pairs = [port._format_pair(q, d) for q, d in zip(flat_q, flat_d)]
    order = sorted(range(len(pairs)), key=lambda i: len(pairs[i]))
    want = [0.0] * len(pairs)
    for start in range(0, len(order), 2):
        chunk = order[start : start + 2]
        batch = encode_batch(port.tokenizer, [pairs[i] for i in chunk], max_length=64)
        with torch.no_grad():
            scores = qwen3.rerank_scores(
                port.params, port.config, torch.from_numpy(batch.input_ids),
                torch.from_numpy(batch.attention_mask),
                token_true=port.token_true_id, token_false=port.token_false_id,
            )
        for i, s in zip(chunk, scores.numpy()):
            want[i] = float(s)
    assert got == want
    np.testing.assert_allclose(got, jax_client.rerank_pairs_sync(flat_q, flat_d), atol=TOL)


def test_engine_fallback_reaches_rerank(clients):
    """A client with only ``rerank`` serves the engine's pair scoring
    (search/engine.py ``_rerank_pairs``) with the pair API's scores."""
    port, _ = clients
    queries, docs = _groups(port, sizes=(3, 4), seed=6)
    flat_q = [q for q, d in zip(queries, docs) for _ in d]
    flat_d = [x for d in docs for x in d]
    engine = types.SimpleNamespace(reranker_client=types.SimpleNamespace(rerank=port.rerank))
    got = asyncio.run(SearchEngine._rerank_pairs(engine, flat_q, flat_d))
    np.testing.assert_allclose(got, port.rerank_pairs_sync(flat_q, flat_d), atol=TOL)


def test_stage_one_keep_sets_at_the_chain_s_cliff_equal_jax_s():
    """ROADMAP C6. The 200k chain's 24,8 cascade on the card is 5 queries
    of recall@1 under the committed TPU row. Its keep sets turn on P(true)
    gaps as small as 7e-6 between the target and the keep boundary; on the
    queries of the committed dump closest to that boundary (all 114 whose
    top-1 the cascade changes were checked when it was taken) the port's
    stage 1 keeps what the JAX client's keeps in f32 on the CPU, and what
    the card kept (scripts/dump_cascade_divergence.py)."""
    record = json.loads((REPO / "runs" / "scale200k" / "cascade_24_8_divergence.json").read_text())
    path = REPO / "runs" / "scale200k" / "reranker" / "checkpoint"
    port = RerankerClient(
        str(path), max_length=record["rr_max_length"], dtype=torch.float32, device="cpu"
    )
    jax_client = JaxReranker(
        str(path), model_dir=path, max_length=record["rr_max_length"], dtype="float32"
    )
    rows = record["queries"]
    args = ([r["query"] for r in rows], [r["documents"] for r in rows])
    got = port.rerank_grouped_sync(*args, suffix_cap=record["cap"])
    want = jax_client.rerank_grouped_sync(*args, suffix_cap=record["cap"])

    def keep(scores):
        return sorted(range(len(scores)), key=lambda j: scores[j], reverse=True)[: record["keep"]]

    assert record["point"] == "24,8" and len(rows) == 8
    for row, g, w in zip(rows, got, want):
        np.testing.assert_allclose(g, w, atol=TOL)
        assert keep(g) == keep(w) == row["keep"]


def test_calibration_cap_24_rankings_equal_jax_s():
    """ROADMAP C11. At cap 24 the 200k chain's calibration on the card
    keeps the full-length top-3 in 36 of 192 groups where the committed TPU
    row has 39 (containment_top3 0.1875 against 0.2031). The card's, the
    port's and the JAX client's float32 rankings agreed on every group
    (scripts/compare_torch_cap_rankings.py); on the committed record's
    groups closest to turning, the port's and JAX's full-length top-3 and
    cap-24 keep sets are the record's."""
    record = json.loads(
        (REPO / "runs" / "scale200k" / "cascade_calibration_cap24_divergence.json").read_text()
    )
    cap = record["caps"]["24"]
    assert cap["groups_differing_from_jax"] == {"card": [], "port": []}
    assert cap["card_row"] == cap["jax_f32_cpu_row"] == cap["port_cpu_row"]
    path = REPO / record["reranker"]
    port = RerankerClient(str(path), max_length=record["rr_max_length"], dtype=torch.float32,
                          device="cpu")
    jax_client = JaxReranker(str(path), model_dir=path, max_length=record["rr_max_length"],
                             dtype="float32")
    rows = cap["closest"]
    args = ([r["query"] for r in rows], [r["documents"] for r in rows])
    keep = record["keep"]

    def decisions(full, truncated):
        order = sorted(range(len(full)), key=lambda j: full[j], reverse=True)
        kept = sorted(range(len(truncated)), key=lambda j: truncated[j], reverse=True)[:keep]
        return {"full_top3": order[:3], "keep_set": sorted(kept)}

    got = zip(port.rerank_grouped_sync(*args), port.rerank_grouped_sync(*args, suffix_cap=24))
    want = zip(jax_client.rerank_grouped_sync(*args),
               jax_client.rerank_grouped_sync(*args, suffix_cap=24))
    for row, g, w in zip(rows, got, want):
        np.testing.assert_allclose(g[0], w[0], atol=TOL)
        np.testing.assert_allclose(g[1], w[1], atol=TOL)
        assert decisions(*g) == decisions(*w) == cap["jax_rankings"][row["index"]]
