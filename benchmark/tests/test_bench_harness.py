"""The harness's own arithmetic, generators, discovery and guard, on the CPU."""

import json
import shutil

import numpy as np
import pytest
import torch

import tiny  # noqa: F401 - puts the benchmark and the repository on sys.path
from generators import corpus as C
from harness import counts, stats, trace, weights
from harness.guard import forbidden_modules
from harness.spec import Spec


def test_corpus_and_queries_are_deterministic_by_seed():
    a = C.make_corpus(n_decls=500, n_concepts=60, body_sentences=5, max_deps=3, seed=2**40 + 1)
    b = C.make_corpus(n_decls=500, n_concepts=60, body_sentences=5, max_deps=3, seed=2**40 + 1)
    c = C.make_corpus(n_decls=500, n_concepts=60, body_sentences=5, max_deps=3, seed=2**40 + 2)
    assert a.names == b.names and a.informalizations == b.informalizations
    assert a.dependencies == b.dependencies and (a.triples == b.triples).all()
    assert a.names != c.names
    mix = {"semantic": 3, "name_exact": 1, "name_fragment": 1, "name_typo": 1}
    qa, qb = C.make_queries(a, mix, 600, 5), C.make_queries(a, mix, 600, 5)
    assert qa == qb and qa != C.make_queries(a, mix, 600, 6)
    # every seed sends the same amount of each class
    classes = [cls for _, cls, _ in qa]
    assert classes.count("semantic") == 300 and classes.count("name_typo") == 100
    words = [len(t.split()) for t in a.informalizations]
    assert 100 <= np.median(words) <= 120


def test_vocabulary_covers_every_document_and_prompt():
    corpus = C.make_corpus(n_decls=300, n_concepts=40, body_sentences=5, max_deps=3, seed=3)
    cfg = tiny.tiny_config("qwen3-0.6b")
    vocab = C.vocabulary(corpus, tuple(cfg["vocabulary_texts"]))
    texts = [corpus.document(i) for i in range(len(corpus))] + [cfg["serving"]["query_prompt"]]
    assert all(t in vocab for text in texts for t in C.pre_tokenize(text))
    assert "true" in vocab and "false" in vocab


def test_weights_are_deterministic_by_seed():
    m = tiny.TINY_MODEL | {"vocab_size": 64}
    a = weights.make_params(m, 11, torch.device("cpu"))
    b = weights.make_params(m, 11, torch.device("cpu"))
    c = weights.make_params(m, 12, torch.device("cpu"))
    assert torch.equal(a["layers"]["q_proj"], b["layers"]["q_proj"])
    assert not torch.equal(a["layers"]["q_proj"], c["layers"]["q_proj"])
    assert a["embed"].dtype == torch.bfloat16 and a["layers"]["down_proj"].shape == (2, 128, 64)


class _B:
    def __init__(self, start, end, n):
        self.start, self.end, self.queries = start, end, ["q"] * n


def test_whole_batch_rate_counts_batches_begun_in_the_window():
    batches = [_B(0.0, 2.0, 128), _B(2.0, 4.0, 128), _B(9.5, 12.0, 100), _B(10.0, 11.0, 50)]
    rate, end, n = stats.whole_batch_rate(batches, 0.0, 10.0)
    assert n == 356 and end == 12.0 and rate == pytest.approx(356 / 12.0)


def test_busy_union_and_idle_gaps():
    assert trace.union_us([(0, 10), (5, 15), (20, 30), (21, 22)]) == 25
    t = trace.Trace(window_us=40.0, begin_us=0.0, end_us=40.0,
                    device=[("k1", 0, 10), ("k2", 5, 15), ("k1", 20, 30)],
                    host=[("bench.rerank", 0, 40), ("aten::copy_", 16, 19)])
    assert t.busy_us() == 25 and t.kernel_us("k1") == 20
    assert t.top_ops()[0] == ["k1", 20 / 1e6]
    gaps = dict(t.idle_gaps())
    assert gaps["bench.rerank / aten::copy_"] == pytest.approx(5 / 1e6)
    assert gaps["bench.rerank / python"] == pytest.approx(10 / 1e6)


def test_flop_count_by_hand():
    m = {"hidden_size": 8, "head_dim": 2, "intermediate_size": 16, "num_attention_heads": 4,
         "num_key_value_heads": 2, "num_hidden_layers": 3}
    # q 8x8, k and v 8x4, o 8x8, MLP three 8x16: 2 x (64+32+32+64+384) a token and layer
    assert counts.linear_flops_per_token(m) == 3 * 2 * (64 + 32 + 32 + 64 + 384)
    # 3 tokens from scratch see 1 + 2 + 3 keys: 4 x heads x width x layers each
    assert counts.attention_flops(m, 3, 0) == 4 * 8 * 3 * 6
    # 2 tokens after 5 cached see 6 and 7 keys
    assert counts.attention_flops(m, 2, 5) == 4 * 8 * 3 * 13
    assert counts.suffix_flops(m, 5, 2) == counts.linear_flops_per_token(m) * 2 + 4 * 8 * 3 * 13 + 2 * 2 * 8


def test_k1_bytes_by_hand():
    # 300,000 x 1024 bf16 corpus, 128 bf16 queries, a 4096 x 128 f32 carry
    assert counts.k1_bytes(300_000, 1024, 128, 4096) == 614_400_000 + 262_144 + 2_097_152
    assert counts.k1_bound_s(300_000, 1024, 128, 4096) == pytest.approx(616_759_296 / 3.35e12)


def test_jax_guard_compares_whole_top_level_names():
    names = ["lean_explore_tpu_torch", "lean_explore_tpu_torch.search", "jaxtyping", "numpy"]
    assert forbidden_modules(names) == []
    assert forbidden_modules(names + ["lean_explore_tpu.search", "jax._src", "flax"]) == [
        "flax", "jax._src", "lean_explore_tpu.search"]


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path):
    """Files and entries alone: a configuration, a traffic mix (one
    closed-loop client) and a per-layer metric added in a copy of the
    benchmark are found by name and run, with no code edited."""
    bench = tmp_path / "benchmark"
    shutil.copytree(tiny.BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    data = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    cfg = tiny.tiny_config("qwen3-0.6b")
    cfg["name"] = "tiny-new"
    (bench / "configs" / "tiny-new.json").write_text(json.dumps(cfg))
    mix = tiny.tiny_traffic("closed", clients=1, warmup_batches=[1], check_requests=2)
    (bench / "traffic" / "single.json").write_text(json.dumps(mix))
    (bench / "metrics" / "batches_traced.py").write_text(
        "def read(ctx):\n    return float(sum(1 for b in ctx.all_batches if b.traced))\n")
    data["configs"].append({"name": "tiny-new", "source": "https://example.org", "file": "benchmark/configs/tiny-new.json",
                            "reduced": [], "why": "test"})
    data["workloads"].append({"name": "tiny-new.single", "config": "tiny-new", "traffic": "single", "chips": 1,
                              "why": "test"})
    data["per_layer"].append({"name": "batches_traced", "unit": "batches", "better": "higher",
                              "source": "program_span", "layer": "Whole step", "moves": "search_qps",
                              "workloads": ["tiny-new.single"]})
    data["end_to_end"][0]["workloads"].append("tiny-new.single")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    spec = Spec(tmp_path, bench)
    cell = spec.cell("tiny-new.single")
    assert spec.config(cell["config"])["name"] == "tiny-new"
    assert spec.traffic(cell["traffic"])["clients"] == 1
    assert [m["name"] for m in spec.metrics("per_layer", cell["name"])] == ["batches_traced"]

    import run

    out = run.run_cell(spec, cell, 3, 3.0, True, torch.device("cpu"), tmp_path)
    assert out["correct"] and out["metrics"]["batches_traced"]["value"] >= 1
    plain = run.run_cell(spec, cell, 3, 1.5, False, torch.device("cpu"), tmp_path)
    assert set(plain["metrics"]) == {"search_qps", "setup_s"}


def test_main_refuses_without_enough_devices(capsys):
    import run

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    assert run.main(["--workload", "qwen3-0.6b.closed", "--seed", "1", "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "needs 1 CUDA device" in out.err


def test_pool_reference_by_hand():
    """BM25+ over names, fused with the dense list by reciprocal rank, then
    the dependency boost, worked out by hand on four declarations."""
    import math

    from reference import pool

    names = ["Nat.add_comm", "Nat.add_zero", "Int.mul_comm", "List.map"]
    deps = {0: [], 1: [], 2: [], 3: []}
    ref = pool.PoolReference(names, deps.__getitem__, ["add comm"])
    rows, scores = ref.spaced.top(["add", "comm"], 3)
    # "add" and "comm" each in two of four names of 3, 3, 3 and 2 tokens
    idf, norm = math.log(5 / 2), 1.5 * 0.25 + 1.5 * 0.75 / 2.75 * 3 + 1
    assert rows.tolist() == [0, 1, 2]  # rows 1 and 2 tie: by row
    assert scores[0] == pytest.approx(2 * idf * 2.5 / norm + 2 * idf * 0.5)
    assert scores[1] == pytest.approx(scores[2])
    # BM25 ranks ids 1, 2; dense ranks ids 4, 3: ids 1 and 4 tie at 1 + 1/3
    # and keep first-seen order, no dependencies leave the order as it is
    assert ref.pool("add comm", [4, 3], [0.9, 0.8], bm25_k=2, rerank_top=3) == [1, 4, 2]
    # Nat.add_comm depends on Int.mul_comm: id 3 gets 1/4 + 1/1, the others
    # 1/rank + 1/2
    deps[0] = ["Int.mul_comm"]
    assert ref.pool("add comm", [4, 3], [0.9, 0.8], bm25_k=2, rerank_top=3) == [1, 3, 4]
