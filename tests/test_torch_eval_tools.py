"""The port's quality and cascade-calibration tools against the JAX
scripts, on the CPU.

The JAX scripts (scripts/calibrate_cascade.py, measure_prescreen_coverage.py,
eval_rerank_top.py, eval_query_classes.py, measure_int8_effects.py,
eval_retrieval.py, probe_reranker_doclen.py) are loaded by path and run
in-process with ``--platform cpu`` where they take it; the port's scripts
run with ``--device cpu``. Both read the committed 20k chain's float32
checkpoints (runs/embedder, runs/reranker) at the records' lengths, on a
small corpus of that chain's regime (``make_corpus`` with its 1,200
concepts and seed). The tools that take --data-dir share one artifact
directory that the port's index build writes; the others build their
own. Each report must equal the JAX script's, the seconds aside, but for
the int8 reranker's P(true) drift against float32. Both int8 clients load
the checkpoint in bf16 and quantize it, and the two packages round bf16
differently on the CPU (XLA keeps f32 inside its fusions), so an
activation at a rounding tie takes the next int8 code in one of them: on
these 400 pairs 6 scores of the two int8 clients differ by more than
2^-8, at most by 0.043, where their float32 clients agree within 2e-6.
The drift's mean is held within 2^-8, and its max within 0.1, the int8
trunk's own drift bound against the dense trunk
(tests/models_nn/test_qwen3_int8.py).
``containment_metrics`` is held to the JAX script's own function on random
score vectors with ties.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from lean_explore_tpu_torch import evaluation
from lean_explore_tpu_torch.train.synthetic import make_corpus

REPO = Path(__file__).resolve().parent.parent
EMBEDDER = REPO / "runs" / "embedder" / "checkpoint"
RERANKER = REPO / "runs" / "reranker" / "checkpoint"
CORPUS = dict(n_decls=150, n_concepts=1200, seed=0)
N_QUERIES = 12
DRIFT_MEAN_TOL, DRIFT_MAX_TOL = 2.0**-8, 0.1


def load(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_jax(name: str, argv: list[str], monkeypatch, capsys) -> dict:
    """The JAX script's main() with ``argv``; returns its last stdout line
    as JSON."""
    monkeypatch.setattr(sys, "argv", [name, *map(str, argv)])
    capsys.readouterr()
    load(name).main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def without_seconds(value):
    if isinstance(value, dict):
        return {k: without_seconds(v) for k, v in value.items() if k != "seconds"}
    return value


JAX_CALIBRATE = load("calibrate_cascade")


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory) -> Path:
    """The shared artifact directory: the small corpus embedded and indexed
    through the port at the scripts' embedder length."""
    root = tmp_path_factory.mktemp("eval_tools")
    corpus = make_corpus(**CORPUS, n_eval=N_QUERIES)
    embedder, _ = evaluation.float32_clients(EMBEDDER, RERANKER, 64, 128, "cpu")
    store, _ = evaluation.build_index(corpus, embedder, root)
    store.close()
    return root


def common(n_eval_flag: str) -> list[str]:
    return [
        "--embedder", EMBEDDER, "--reranker", RERANKER, "--n-decls", CORPUS["n_decls"],
        "--n-concepts", CORPUS["n_concepts"], n_eval_flag, N_QUERIES,
    ]


@settings(max_examples=60, deadline=None)
@given(
    st.integers(1, 30).flatmap(
        lambda n: st.tuples(
            st.lists(st.integers(0, 6), min_size=n, max_size=n),
            st.lists(st.integers(0, 6), min_size=n, max_size=n),
        )
    ),
    st.integers(1, 12),
)
def test_containment_metrics_is_the_jax_script_s(scores, keep):
    """Integer-valued scores make ties common: the full ranking's top-1 and
    top-3 and both top-``keep`` sets break them by position in both."""
    full, cap = ([float(x) for x in s] for s in scores)
    assert evaluation.containment_metrics(full, cap, keep) == JAX_CALIBRATE.containment_metrics(
        full, cap, keep
    )


@pytest.mark.parametrize("jax_name,port_name,n_eval_flag,extra", [
    ("calibrate_cascade", "calibrate_torch_cascade", "--n-queries",
     ["--rerank-top", 10, "--keep", 4, "--caps", 8, 16, 24, "--top1-floor", 0.8]),
    ("measure_prescreen_coverage", "measure_torch_prescreen_coverage", "--n-eval",
     ["--rerank-top", 10, "--caps", 8, 12, 32]),
    ("eval_rerank_top", "eval_torch_rerank_top", "--n-eval",
     ["--rerank-tops", 10, 4, "--cascade", "8,3"]),
])
def test_data_dir_tools_give_the_jax_scripts_reports(
    artifacts, tmp_path, monkeypatch, capsys, jax_name, port_name, n_eval_flag, extra
):
    """Each tool over the shared artifact directory, which it leaves in
    place: the same report as the JAX script's."""
    argv = [*common(n_eval_flag), "--data-dir", artifacts, *extra]
    want = run_jax(jax_name, [*argv, "--out", tmp_path / "jax.json", "--platform", "cpu"],
                   monkeypatch, capsys)
    report = load(port_name).main(
        [*map(str, argv), "--out", str(tmp_path / "port.json"), "--device", "cpu"]
    )
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert without_seconds(got) == without_seconds(want)
    if jax_name == "calibrate_cascade":
        assert got["recommended_cap"] == report["recommended_cap"]
        jax_file = json.loads((tmp_path / "jax.json").read_text())
        port_file = json.loads((tmp_path / "port.json").read_text())
        assert without_seconds(port_file) == without_seconds(jax_file)
    assert (artifacts / "manifest.json").is_file()  # never deletes a caller's index


def test_query_classes_give_the_jax_script_s_report(tmp_path, monkeypatch, capsys):
    argv = [
        "--embedder", EMBEDDER, "--reranker", RERANKER, "--n-decls", CORPUS["n_decls"],
        "--n-concepts", CORPUS["n_concepts"], "--n-eval", N_QUERIES, "--n-per-class", 6,
        "--rerank-top", 10,
    ]
    want = run_jax("eval_query_classes",
                   [*argv, "--out", tmp_path / "jax", "--platform", "cpu"], monkeypatch, capsys)
    report = load("eval_torch_query_classes").main(
        [*map(str, argv), "--out", str(tmp_path / "port"), "--device", "cpu"]
    )
    assert without_seconds(report["results"]) == without_seconds(want)
    assert set(want) == {"semantic", "name_exact", "name_fragment", "name_typo"}
    assert want["name_exact"]["bm25_only"]["recall_at_1"] == 1.0


def test_int8_effects_give_the_jax_script_s_report(tmp_path, monkeypatch, capsys):
    argv = [
        "--embedder", EMBEDDER, "--reranker", RERANKER, "--n-decls", CORPUS["n_decls"],
        "--n-concepts", CORPUS["n_concepts"], "--n-eval", N_QUERIES, "--n-queries", 8,
    ]
    want = run_jax("measure_int8_effects",
                   [*argv, "--out", tmp_path / "jax.json", "--platform", "cpu"],
                   monkeypatch, capsys)
    got = load("measure_torch_int8_effects").main(
        [*map(str, argv), "--out", str(tmp_path / "port.json"), "--device", "cpu"]
    )
    assert got["dense_trained_geometry"] == want["dense_trained_geometry"]
    drift, want_drift = got["reranker_int8_drift"], want["reranker_int8_drift"]
    for key, tol in (("p_true_drift_mean", DRIFT_MEAN_TOL), ("p_true_drift_max", DRIFT_MAX_TOL)):
        assert abs(drift.pop(key) - want_drift.pop(key)) <= tol, key
    assert drift == want_drift


def test_retrieval_harness_gives_the_jax_script_s_report(
    artifacts, tmp_path, monkeypatch, capsys
):
    """The synthetic mode, then --data-dir with a queries file over the
    shared artifacts and each package's default engine on the committed
    checkpoints: hybrid equal to the JAX script's, and the port's
    ablations equal to the JAX engine's with the same overrides."""
    from lean_explore_tpu import config as jax_config
    from lean_explore_tpu.evaluation import evaluate_engine as jax_evaluate
    from lean_explore_tpu.search.engine import SearchEngine as JaxEngine
    from lean_explore_tpu.util.embedding_client import EmbeddingClient as JaxEmbedder
    from lean_explore_tpu.util.reranker_client import RerankerClient as JaxReranker
    from lean_explore_tpu_torch import config as port_config
    from lean_explore_tpu_torch.search.engine import SearchEngine
    from lean_explore_tpu_torch.util.embedding_client import EmbeddingClient
    from lean_explore_tpu_torch.util.reranker_client import RerankerClient

    synthetic = ["--n", 600, "--dim", 32, "--queries", 24]
    want = run_jax("eval_retrieval", synthetic, monkeypatch, capsys)
    got = load("eval_torch_retrieval").main([*map(str, synthetic), "--device", "cpu"])
    assert got == want and set(got) == {"hybrid", "dense_only", "bm25_only"}

    corpus = make_corpus(**CORPUS, n_eval=N_QUERIES)
    queries = tmp_path / "queries.jsonl"
    queries.write_text("".join(
        json.dumps({"query": q, "target": t}) + "\n" for q, t in corpus.eval_queries
    ))
    for engine in (JaxEngine, SearchEngine):
        defaults = engine.__init__.__kwdefaults__
        monkeypatch.setitem(defaults, "embedding_model_name", str(EMBEDDER))
        monkeypatch.setitem(defaults, "reranker_model_name", str(RERANKER))
    for client, dtype in (
        (JaxEmbedder, "float32"), (JaxReranker, "float32"),
        (EmbeddingClient, torch.float32), (RerankerClient, torch.float32),
    ):
        monkeypatch.setitem(client.__init__.__kwdefaults__, "dtype", dtype)
    for config in (jax_config.Config, port_config.Config):
        monkeypatch.setattr(config, "CORPUS_DTYPE", "float32")
        monkeypatch.setattr(config, "EMBEDDING_MAX_LENGTH", 64)
        monkeypatch.setattr(config, "RERANKER_MAX_LENGTH", 128)
    real = ["--data-dir", artifacts, "--queries-file", queries]
    want = run_jax("eval_retrieval", real, monkeypatch, capsys)
    got = load("eval_torch_retrieval").main([*map(str, real), "--device", "cpu"])
    assert got["hybrid"] == want["hybrid"]
    jax_engine = JaxEngine(artifacts)
    for label, overrides in load("eval_torch_retrieval").ABLATIONS.items():
        assert got[label] == jax_evaluate(jax_engine, corpus.eval_queries, **overrides), label


def test_doclen_probe_gives_the_jax_script_s_report(tmp_path, monkeypatch, capsys):
    argv = [
        "--checkpoints", RERANKER, "--n-decls", CORPUS["n_decls"],
        "--n-concepts", CORPUS["n_concepts"], "--n-eval", N_QUERIES, "--body-sentences", 1,
        "--queries", 8, "--caps", 16, 8, "--max-length", 128,
    ]
    monkeypatch.setattr(sys, "argv", ["probe", *map(str, argv), "--report", str(tmp_path / "j")])
    load("probe_reranker_doclen").main()
    want = json.loads((tmp_path / "j").read_text())
    got = load("probe_torch_reranker_doclen").main(
        [*map(str, argv), "--report", str(tmp_path / "p"), "--device", "cpu"]
    )
    want["task"]["report"] = got["task"]["report"] = None
    assert got == want
    assert list(got["results"][str(RERANKER)]) == ["full", "cap16", "cap8", "distractor_full"]


def test_capture_hooks_the_method_the_engine_calls(artifacts, monkeypatch):
    """The capture wraps the client's async ``rerank_grouped`` for its pass
    only, records every query in order with the full rerank (the cascade
    variable unset for it and restored after), and raises when the engine
    never reached the reranker."""
    corpus = make_corpus(**CORPUS, n_eval=N_QUERIES)
    embedder, reranker = evaluation.float32_clients(EMBEDDER, RERANKER, 64, 128, "cpu")
    engine, store = evaluation.prepare_engine(corpus, embedder, reranker, artifacts, None, "cpu")
    queries = [q for q, _ in corpus.eval_queries]
    monkeypatch.setenv(evaluation.CASCADE_ENV, "8,2")
    groups = evaluation.capture_rerank_groups(engine, queries, 10, batch=5)
    assert [g.query for g in groups] == queries
    assert all(len(g.documents) == len(g.scores) == 10 for g in groups)
    want = reranker.rerank_grouped_sync(queries[:3], [g.documents for g in groups[:3]])
    np.testing.assert_allclose([g.scores for g in groups[:3]], want, atol=1e-6)
    assert "rerank_grouped" not in vars(reranker)
    assert evaluation.os.environ[evaluation.CASCADE_ENV] == "8,2"
    with pytest.raises(RuntimeError, match="captured 0 rerank groups"):
        evaluation.capture_rerank_groups(engine, queries, 0)
    store.close()


def test_recommended_cap_is_the_smallest_over_the_floor():
    rows = {48: {"containment_top1": 0.97}, 8: {"containment_top1": 0.34},
            96: {"containment_top1": 0.99}, 24: {"containment_top1": 0.95}}
    assert evaluation.recommended_cap(rows, 0.95) == 24
    assert evaluation.recommended_cap(rows, 0.96) == 48
    assert evaluation.recommended_cap(rows, 0.995) is None


def test_chip_smoke_holds_the_tools_to_their_records():
    """chip_smoke.py phase 10's references: the 200k chain's records at
    their own task (192 queries, keep 16, floor 0.95, cap 48 recommended),
    and ROADMAP C11's rows. Those are exactly the rows whose TPU record
    JAX's own float32 run on the CPU (the JAX scripts at their defaults
    with --platform cpu, runs/jax_f32_cpu) misses by more than the phase's
    slack, which the phase holds to that run instead; and calibration cap
    24, whose JAX float32 row (the card's rankings, equal to JAX's on every
    group) misses its TPU row."""
    import chip_smoke as cs

    runs = REPO / "runs"
    calibration = json.loads((REPO / cs.TOOLS_CALIBRATION).read_text())
    coverage = json.loads((REPO / cs.TOOLS_COVERAGE).read_text())
    assert calibration["task"]["n_queries"] == coverage["task"]["n_eval"] == cs.TOOLS_N_QUERIES
    assert (calibration["task"]["keep"], calibration["task"]["top1_floor"]) == (16, 0.95)
    assert calibration["recommended_cap"] == cs.TOOLS_RECOMMENDED_CAP
    assert {int(c) for c in [*calibration["caps"], *coverage["caps"]]} == set(cs.TOOLS_CAPS)

    def beyond(got: dict, want: dict, n: int) -> bool:
        return any(
            abs(got[k] - want[k]) > cs.CHAIN_MRR_SLACK + 1e-9 if k.startswith("mrr")
            else abs(round(got[k] * n) - round(want[k] * n)) > cs.CHAIN_QUERY_SLACK
            for k in want if k.startswith(("recall", "mrr", "top1", "containment"))
        )

    tpu = json.loads((REPO / cs.TOOLS_QUERY_CLASSES).read_text())["results"]
    f32 = json.loads((REPO / cs.TOOLS_F32_QUERY_CLASSES).read_text())["results"]
    missed = {
        (qclass, config) for qclass, rows in tpu.items() for config, row in rows.items()
        if beyond(f32[qclass][config], row, row["n_queries"])
    }
    tpu_int8 = json.loads((REPO / cs.TOOLS_INT8_EFFECTS).read_text())
    f32_int8 = json.loads((REPO / cs.TOOLS_F32_INT8_EFFECTS).read_text())
    recall = tpu_int8["dense_trained_geometry"]["recall_at_10"]
    missed |= {
        ("dense", key) for key, value in recall.items()
        if abs(f32_int8["dense_trained_geometry"]["recall_at_10"][key] - value)
        > cs.TOOLS_DENSE_RECALL_TOL
    }
    assert not beyond(f32_int8["reranker_int8_drift"], tpu_int8["reranker_int8_drift"], 128)
    assert missed == cs.TOOLS_F32_ROWS

    divergence = json.loads((REPO / cs.TOOLS_CAP_DIVERGENCE).read_text())
    assert list(divergence["caps"]) == ["24"] and divergence["keep"] == 16
    cap = divergence["caps"]["24"]
    assert cap["tpu_row"] == calibration["caps"]["24"]
    assert beyond(cap["jax_f32_cpu_row"], cap["tpu_row"], 192)
    assert (runs / "scale200k" / "reranker" / "checkpoint") == REPO / divergence["reranker"]
