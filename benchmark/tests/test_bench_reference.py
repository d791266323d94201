"""The plain reference against the port's CPU path, the control, and the
faults the check has to catch, at the tiny CPU size."""

import numpy as np
import pytest
import torch

import tiny
from generators import corpus as C
from harness import weights
from reference import model, text


def _tiny_params(seed=5):
    m = tiny.tiny_config("qwen3-0.6b")["model"]
    params = weights.make_params(m, seed, torch.device("cpu"))
    as_f32 = {"embed": params["embed"].float(), "final_norm": params["final_norm"].float(),
              "lm_head": None, "layers": {k: v.float() for k, v in params["layers"].items()}}
    return m, as_f32


def test_reference_trunk_agrees_with_the_port_in_float32():
    from lean_explore_tpu_torch.models import qwen3

    from harness.system import qwen3_config

    m, params = _tiny_params()
    rows = [[5, 9, 11, 3, 2], [7, 7, 2], [1, 2, 3, 4, 5, 6, 7, 8, 2]]
    ref = model.embed(params, m, rows, torch.device("cpu"))
    t = max(len(r) for r in rows)
    ids = torch.tensor([r + [0] * (t - len(r)) for r in rows])
    mask = torch.tensor([[1] * len(r) + [0] * (t - len(r)) for r in rows])
    port = qwen3.embed_pool(params, qwen3_config(m), ids, mask)
    assert torch.allclose(ref, port, atol=2e-6)
    logit = model.yes_no_logit(params, m, rows, 3, 4, torch.device("cpu"))
    p = qwen3.rerank_scores(params, qwen3_config(m), ids, mask, token_true=3, token_false=4)
    assert torch.allclose(torch.sigmoid(logit), p, atol=2e-6)


def test_reference_tokenizer_agrees_with_the_ports_reader(tmp_path):
    from harness.system import write_tokenizer

    corpus = C.make_corpus(n_decls=200, n_concepts=40, body_sentences=5, max_deps=3, seed=4)
    cfg = tiny.tiny_config("qwen3-0.6b")
    vocab = C.vocabulary(corpus, tuple(cfg["vocabulary_texts"]))
    port = write_tokenizer(vocab, C.tokenizer_json(vocab), tmp_path)
    ref = text.Tokenizer(vocab)
    texts = [corpus.document(i) for i in range(50)] + [C.typo(corpus.names[0], np.random.default_rng(1))]
    texts.append(text.pair_text(cfg["serving"]["instruction"], "which x of some y keeps z", corpus.document(3)))
    for t in texts:
        assert ref.encode(t) == port.encode(t)


def test_fusion_agrees_with_the_ports_signals():
    from lean_explore_tpu_torch.search import scoring
    from lean_explore_tpu_torch.search.engine import SearchEngine

    corpus = C.make_corpus(n_decls=300, n_concepts=30, body_sentences=5, max_deps=3, seed=6)
    rows = list(range(40))
    names = [corpus.names[r] for r in rows]
    informal = [corpus.informalizations[r] for r in rows]
    query = " ".join(C.pre_tokenize(corpus.names[3])[4:7])
    rng = np.random.default_rng(0)
    rerank = rng.uniform(0.3, 0.7, len(rows))
    deps = [[n for n in (corpus.dependencies[r] or "[]").strip("[]").replace('"', "").split(", ") if n]
            for r in rows]
    ours = text.fused_scores(query, names, informal, deps, rerank)

    class Decl:
        def __init__(self, r):
            self.name, self.informalization, self.id = corpus.names[r], corpus.informalizations[r], r

        def dependency_names(self):
            return deps[rows.index(self.id)]

    engine = object.__new__(SearchEngine)
    engine._dep_names = None
    cands = [Decl(r) for r in rows]
    signals = engine._precompute_fusion_signals(query, cands, scoring.fuzzy_name_scores(query, names))
    theirs = SearchEngine._combine_fusion_signals(signals, list(rerank))
    assert np.allclose(ours, theirs, atol=1e-12)


@pytest.mark.parametrize("cell", ["qwen3-0.6b.closed", "qwen3-0.6b-cascade.closed", "qwen3-0.6b.index-embed"])
def test_a_tiny_run_of_each_cell_is_correct_and_the_control_is_not(cell):
    """The port's CPU path passes the check; the fp8 reference in its place,
    judged by the same numbers and limits, fails it. Six layers: fp8's
    error grows with depth, and two layers stay under the full size's."""
    import tempfile
    from pathlib import Path

    import run
    from harness.spec import Spec

    spec = Spec(tiny.ROOT)
    c = spec.cell(cell)
    cfg = tiny.tiny_config(c["config"], layers=6)
    run.configure_environment(Path(tempfile.gettempdir()) / "bench_tiny", cfg)
    with tempfile.TemporaryDirectory() as work:
        out = run.run_cell(spec, c, 21, 3.0, False, torch.device("cpu"), Path(work), cfg=cfg,
                           traffic=tiny.tiny_traffic(c["traffic"]), with_control=True)
    assert out["correct"], out["check"]
    limits = cfg["check_limits"]
    assert any(v > limits[k] for k, v in out["control"].items()), out["control"]


def test_reference_pool_agrees_with_the_ports_engine():
    """Every request of a tiny run's window, of every query class, gets the
    pool that the plain reference of the lexical stage, the fusion and the
    dependency boost picks."""
    out = tiny.run_tiny("qwen3-0.6b.closed", seconds=4.0,
                        traffic=tiny.tiny_traffic("closed", check_requests=64))
    assert out["check"]["pool_miss"]["value"] == 0 and out["correct"], out["check"]
