"""The readers of the program's own spans (``harness/spans.py`` and the
metrics built on it), on the tiny CPU cells: each gives a number, or
nothing where it needs the card, and the rerank's token fill read from
the spans equals the one worked out from what the reranker was handed."""

from types import SimpleNamespace

import pytest

import tiny
from harness import spans as spans_mod
from harness import system
from harness.spec import Spec
from harness.trace import Trace

CARD_ONLY = {"rerank_device_ms", "rerank_idle_ms"}


def _recording(monkeypatch) -> list:
    """Every ``Recorder`` a run makes."""
    made = []

    class Keeping(system.Recorder):
        def __init__(self):
            super().__init__()
            made.append(self)

    monkeypatch.setattr(system, "Recorder", Keeping)
    return made


def _fill_from_calls(batches, cfg) -> float:
    """Real over padded tokens of the grouped reranker's buckets, from the
    pairs each call was handed, on the program's bucket rules."""
    from lean_explore_tpu_torch.models.tokenizer import bucket_batch, bucket_length
    from lean_explore_tpu_torch.util.reranker_client import GROUP_CHUNK, SUFFIX_BUCKETS
    from reference import text

    s = cfg["serving"]
    tok = text.Tokenizer(cfg["vocab"])
    max_len = s["rerank_max_length"]
    real = padded = 0
    for b in batches:
        for queries, groups, cap, _ in b.rerank_calls:
            buckets: dict[int, list] = {}
            for q, docs in zip(queries, groups):
                if not docs:
                    continue
                rows, shared = text.pair_rows(tok, s["instruction"], q, docs, max_len, cap)
                suffixes = [len(r) - shared for r in rows]
                real += shared + sum(suffixes)
                buckets.setdefault(bucket_length(max(suffixes), max_len, buckets=SUFFIX_BUCKETS),
                                   []).append((shared, len(docs)))
            for s_bucket, recs in buckets.items():
                chunk = min(GROUP_CHUNK, bucket_batch(len(recs)))
                g_pad = -(-len(recs) // chunk) * chunk
                p_pad = bucket_length(max(p for p, _ in recs), max_len)
                padded += g_pad * (p_pad + max(d for _, d in recs) * s_bucket)
    return 100.0 * real / padded


@pytest.mark.parametrize("cell", ["qwen3-0.6b.closed", "qwen3-0.6b-cascade.closed"])
def test_search_cells_read_the_program_s_spans(cell, monkeypatch):
    recorders = _recording(monkeypatch)
    # the first batch outside the profiled stretch, whose spans the timing
    # readers read
    out = tiny.run_tiny(cell, trace=True, seconds=6.0,
                        traffic=tiny.tiny_traffic("closed", trace_after_s=1.0))
    names = {m["name"] for m in Spec(tiny.ROOT).metrics("per_layer", cell)}
    assert {"encode_wait_ms", "rerank_host_ms", "rerank_token_fill"} | CARD_ONLY <= names
    got = out["metrics"]
    assert out["correct"]
    assert got["encode_wait_ms"]["value"] >= 0 and got["encode_wait_ms"]["unit"] == "ms"
    assert got["rerank_host_ms"]["value"] > 0
    assert 0 < got["rerank_token_fill"]["value"] <= 100
    assert not CARD_ONLY & set(got)  # no card: no events, no device trace

    (rec,) = recorders
    cfg = tiny.tiny_config(Spec(tiny.ROOT).cell(cell)["config"])
    from generators import corpus as C

    reader = Spec(tiny.ROOT).reader("rerank_token_fill")
    batches = [b for b in rec.batches if b.rerank_calls]
    assert batches
    from_spans = reader(SimpleNamespace(batches=batches))
    traffic = tiny.tiny_traffic("closed")
    corpus = C.make_corpus(n_decls=cfg["deployment"]["declarations"], n_concepts=traffic["corpus"]["concepts"],
                           body_sentences=traffic["corpus"]["body_sentences"],
                           max_deps=traffic["corpus"]["max_dependencies"], seed=7)
    cfg["vocab"] = C.vocabulary(corpus, tuple(cfg["vocabulary_texts"]))
    assert from_spans == pytest.approx(_fill_from_calls(batches, cfg), rel=1e-12)


def test_index_build_reads_its_host_spans():
    out = tiny.run_tiny("qwen3-0.6b.index-embed", trace=True)
    assert out["correct"]
    assert out["metrics"]["index_host_ms"]["value"] > 0


def test_readers_give_nothing_without_the_program_s_spans():
    spec = Spec(tiny.ROOT)
    ctx = SimpleNamespace(program_spans=None, batches=[], all_batches=[], calls=[(0.0, 1.0, 3)],
                          traced_calls=[], trace=None)
    for name in ("encode_wait_ms", "rerank_host_ms", "rerank_device_ms", "rerank_token_fill",
                 "rerank_idle_ms", "index_host_ms"):
        assert spec.reader(name)(ctx) is None, name


def test_idle_under_a_host_range_by_hand():
    # device busy 0-10 and 20-30 of a 0-40 stretch; the host in rerank
    # ranges 5-25 and 28-40 (two overlapping): idle 10-20 and 30-40
    # overlap them for 10 + 10
    t = Trace(window_us=40.0, begin_us=0.0, end_us=40.0,
              device=[("k", 0, 10), ("k", 20, 30)],
              host=[("lx.rerank/pack", 5, 25), ("lx.rerank/stage2", 28, 40),
                    ("lx.rerank/tokenize", 32, 36), ("lx.fuse/signals", 10, 20)])
    assert spans_mod.idle_under_us(t, "lx.rerank/") == pytest.approx(20.0)
    assert spans_mod.idle_under_us(t, "lx.encode/") is None
    assert spans_mod.idle_under_us(Trace(40.0, 0.0, 40.0, [], t.host), "lx.rerank/") is None
