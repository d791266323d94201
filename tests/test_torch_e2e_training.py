"""The port's end-to-end training scripts (scripts/train_torch_embedder_e2e.py,
scripts/train_torch_reranker_e2e.py) and their learning-rate schedule
against the JAX package's (scripts/train_*_e2e.py, optax) on the CPU, at the
JAX tests' miniature (tests/train/test_train_serve_eval.py,
tests/train/test_reranker_serve_eval.py: 200 declarations, 48 concepts, 32
held-out queries, batch 32, hidden 64).

- The schedule equals optax's ``warmup_cosine_decay_schedule`` at every
  count within 1e-6 relative (both round to float32; their cosines may
  differ in the last bit).
- The task data (corpus, tokenizer vocabularies, training pairs, reranker
  examples, the direct metric's distractor groups) equal what the JAX
  script's steps give, value for value.
- The scripts' draw (``init_train_state(draw="threefry")``,
  ``qwen3.init_params_threefry``) is the JAX package's init at the same
  seed: its keys and random bits exactly, its normals within 4 units in
  the last place (XLA's ``log1p`` inside ``erf_inv`` rounds its own way;
  3 at most, in under 1% of values, at the seeds tested).
- From that init the embedder miniature follows JAX's run for 30 steps:
  the logged loss at step 30 within the tolerance of
  tests/test_torch_train.py's step test scaled to 29 steps (params within
  2 sum_t lr_t U_t of JAX's, plus the init's 4 units in the last place, so
  the loss within twice the first-order change sum |g| |dp| plus 1e-5
  relative, plus 1e-4 for both logs' rounding to 4 decimals), and every
  eval metric within one query of 32 (1/32 for MRR).
- Both miniatures clear the JAX tests' thresholds, which hold for JAX's
  seed-0 init, not for every init: from torch's draw at seed 0 the
  reranker's 400 steps reach direct 0.1562 and a full-pipeline MRR@10 of
  0.6433, 0.037 under the JAX test's margin over hybrid, and JAX's own
  runs at seeds 1-3 reach direct 0.0312-0.125, under that test's 0.15. On
  the card, chip_smoke.py phase 7 trains both at the committed task and
  widths.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chip_smoke import load_script
from lean_explore_tpu.models import DeclarationStore as JaxStore
from lean_explore_tpu.models import qwen3 as jq
from lean_explore_tpu.models.tokenizer import load_tokenizer as jax_load_tokenizer
from lean_explore_tpu.train import pairs_from_store as jax_pairs_from_store
from lean_explore_tpu.train import synthetic as JS
from lean_explore_tpu.train.cross_encoder import format_pair as jax_format_pair
from lean_explore_tpu_torch.models import hf_loader, threefry
from lean_explore_tpu_torch.train import contrastive as TC
from lean_explore_tpu_torch.train import e2e
from lean_explore_tpu_torch.util.embedding_client import EmbeddingClient
from lean_explore_tpu_torch.util.reranker_client import RerankerClient
from tests.test_torch_train import LOSS_RTOL, _scheduled_update_bound

REPO = Path(__file__).resolve().parent.parent
SEED = 0
MINI = ["--n-decls", "200", "--n-concepts", "48", "--n-eval", "32", "--batch-size", "32",
        "--hidden-size", "64"]
MINI_CORPUS = dict(n_decls=200, n_concepts=48, n_eval=32, seed=SEED, body_sentences=1)
RERANKER_MINI = MINI + ["--embedder", str(REPO / "runs" / "embedder" / "checkpoint"),
                        "--steps", "400", "--num-layers", "2", "--rerank-top", "20",
                        "--no-name-variants"]
TRAJECTORY_STEPS = 30
N_EVAL = 32
# Torch's threads in this module: JAX's subprocess runs beside the port's
# miniatures, and the suite's other workers beside both.
TORCH_THREADS = 4


@pytest.fixture(scope="module")
def embedder_script():
    return load_script(REPO, "train_torch_embedder_e2e")


@pytest.fixture(scope="module")
def reranker_script():
    return load_script(REPO, "train_torch_reranker_e2e")


@pytest.fixture(scope="module")
def jax_trajectory(tmp_path_factory):
    """JAX's embedder miniature for TRAJECTORY_STEPS steps, started in a
    subprocess when first asked for and read when ``wait`` is called, so
    it runs while the port trains."""
    out = tmp_path_factory.mktemp("jax_embedder")
    log = out / "stderr.log"
    with open(log, "w") as stderr:
        proc = subprocess.Popen(
            [sys.executable, str(REPO / "scripts" / "train_embedder_e2e.py"), "--out", str(out),
             *MINI, "--steps", str(TRAJECTORY_STEPS), "--platform", "cpu"],
            cwd=REPO, stdout=subprocess.DEVNULL, stderr=stderr,
        )

    def wait() -> dict:
        proc.wait(timeout=600)
        assert proc.returncode == 0, log.read_text()[-2000:]
        return json.loads((out / "eval.json").read_text())

    yield out, wait
    if proc.poll() is None:
        proc.kill()
        proc.wait()


# The scripts' draw's normals against JAX's, in units in the last place
# (module docstring).
INIT_MAX_ULP = 4


def _jax_init(config, seed: int) -> dict:
    """The port's params from JAX's init at ``seed`` (the JAX scripts'
    ``init_train_state`` draws ``qwen3.init_params`` from PRNGKey(seed))."""
    jconfig = jq.Qwen3Config(**dataclasses.asdict(config))
    params = jax.tree.map(np.asarray, jq.init_params(jconfig, jax.random.PRNGKey(seed)))
    return hf_loader.params_from_jax(params, device="cpu")


def _holding_params(monkeypatch, script) -> dict:
    """Wraps ``script``'s ``init_train_state`` unchanged; returns a dict
    that holds the params it handed out."""
    held = {}
    init_train_state = script.init_train_state

    def holding(*args, **kw):
        held["params"], opt_state = init_train_state(*args, **kw)
        return held["params"], opt_state

    monkeypatch.setattr(script, "init_train_state", holding)
    return held


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(TORCH_THREADS, before))
    yield
    torch.set_num_threads(before)


def _keys(tree):
    """The nested key structure of a report (dicts only)."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


def _committed(name: str) -> dict:
    return json.loads((REPO / "runs" / name / "eval.json").read_text())


# ---------------------------------------------------------------- schedule


@pytest.mark.parametrize("steps,lr", [(3000, 3e-4), (40, 1e-3)])
def test_schedule_equals_optax_at_every_count(steps, lr):
    warmup = min(200, steps // 10 + 1)
    kw = dict(init_value=0.0, peak_value=lr, warmup_steps=warmup, decay_steps=steps,
              end_value=0.05 * lr)
    want = np.asarray(optax.warmup_cosine_decay_schedule(**kw)(np.arange(steps + 6)))
    port = TC.warmup_cosine_decay_schedule(**kw)
    got = np.array([port(c) for c in range(steps + 6)])
    assert got[0] == want[0] == 0.0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert warmup == {3000: 200, 40: 5}[steps]


def test_schedule_refuses_no_decay():
    with pytest.raises(ValueError):
        TC.warmup_cosine_decay_schedule(0.0, 1e-3, 10, 10)


# ---------------------------------------------------------------- task data


@pytest.fixture(scope="module")
def stores(embedder_script, tmp_path_factory):
    """(JAX corpus and store, port corpus and store) at the miniature, the
    port's built by the script's own calls."""
    tmp = tmp_path_factory.mktemp("stores")
    jcorpus = JS.make_corpus(**MINI_CORPUS)
    jstore = JaxStore(tmp / "jax.db", create=True)
    jstore.insert_many(jcorpus.declarations)
    tcorpus = embedder_script.make_corpus(**MINI_CORPUS)
    tstore = e2e.make_store(tcorpus, tmp / "port")
    yield jcorpus, jstore, tcorpus, tstore
    jstore.close()
    tstore.close()


def test_corpus_equals_jax(stores):
    jcorpus, _, tcorpus, _ = stores
    assert [dataclasses.asdict(d) for d in tcorpus.declarations] == [
        dataclasses.asdict(d) for d in jcorpus.declarations
    ]
    assert tcorpus.eval_queries == jcorpus.eval_queries
    assert tcorpus.n_train == jcorpus.n_train


@pytest.mark.parametrize("paraphrases", [False, True])
def test_embedder_vocabulary_and_pairs_equal_jax(stores, embedder_script, tmp_path, paraphrases):
    jcorpus, jstore, tcorpus, tstore = stores
    # The JAX script's steps (scripts/train_embedder_e2e.py).
    extra = ("query : ",)
    if paraphrases:
        extra += tuple(t.format(s0="", s1="", s2="") for t in JS._PARAPHRASE_TEMPLATES)
    jdir = JS.build_wordlevel_tokenizer(jcorpus.texts(), tmp_path / "jax", extra_texts=extra)
    jtok = jax_load_tokenizer(jdir)
    train_docs = {d.informalization for d in jcorpus.declarations[: jcorpus.n_train]}
    raw = [(q, d) for q, d in jax_pairs_from_store(jstore) if d in train_docs]
    if paraphrases:
        raw.extend(JS.make_paraphrase_pairs(jcorpus))
    want_pairs = [("query : " + q, d) for q, d in raw]

    tdir, ttok = embedder_script.build_tokenizer(tcorpus, tmp_path / "port", paraphrases)
    assert ttok.vocab == jtok.get_vocab()
    assert e2e.padded_vocab(ttok) == (jtok.vocab_size + 7) // 8 * 8
    assert embedder_script.training_pairs(tcorpus, tstore, paraphrases) == want_pairs


@pytest.mark.parametrize("name_variants", [False, True])
def test_reranker_vocabulary_examples_and_distractors_equal_jax(
    stores, reranker_script, tmp_path, name_variants
):
    jcorpus, _, tcorpus, _ = stores
    jdir = JS.build_wordlevel_tokenizer(
        jcorpus.texts(), tmp_path / "jax", extra_texts=(jax_format_pair("q", "d"), "true false")
    )
    jtok = jax_load_tokenizer(jdir)
    _, ttok, token_true, token_false = reranker_script.build_tokenizer(tcorpus, tmp_path / "port")
    assert ttok.vocab == jtok.get_vocab()
    assert (token_true, token_false) == (
        jtok.convert_tokens_to_ids("true"), jtok.convert_tokens_to_ids("false")
    )
    want = JS.make_reranker_examples(
        jcorpus, np.random.default_rng(SEED + 1), name_variants=name_variants
    )
    got = reranker_script.make_reranker_examples(
        tcorpus, np.random.default_rng(SEED + 1), name_variants=name_variants
    )
    assert [(q, d, int(y)) for q, d, y in got] == [(q, d, int(y)) for q, d, y in want]

    # The JAX script's direct-metric loop (scripts/train_reranker_e2e.py).
    name_to_idx = {d.name: i for i, d in enumerate(jcorpus.declarations)}
    holdout_range = (jcorpus.n_train, len(jcorpus.declarations))
    d_rng = np.random.default_rng(SEED + 2)
    want_queries, want_groups = [], []
    for q, target in jcorpus.eval_queries:
        ti = name_to_idx[target]
        distractors = []
        while len(distractors) < 49:
            j = int(d_rng.integers(*holdout_range))
            if j != ti:
                distractors.append(j)
        want_queries.append(q)
        want_groups.append([JS.reranker_document(jcorpus.declarations[ti])] + [
            JS.reranker_document(jcorpus.declarations[j]) for j in distractors
        ])
    queries, groups = reranker_script.distractor_groups(tcorpus, SEED)
    assert (queries, groups) == (want_queries, want_groups)


# ------------------------------------------------------------- miniatures


def _assert_servable(ckpt: Path, reranker: bool) -> None:
    for name in ("model.safetensors", "config.json", "tokenizer.json"):
        assert (ckpt / name).exists()
    if reranker:
        scores = RerankerClient(str(ckpt), model_dir=ckpt, dtype=torch.float32,
                                device="cpu").rerank_sync("a query", ["one doc", "two doc"])
        assert len(scores.scores) == 2 and all(0.0 <= s <= 1.0 for s in scores.scores)
    else:
        vecs = EmbeddingClient(str(ckpt), model_dir=ckpt, dtype=torch.float32,
                               device="cpu").embed_sync(["one doc", "two doc"])
        assert vecs.shape == (2, 64) and np.allclose(np.linalg.norm(vecs, axis=1), 1.0, atol=1e-5)


def test_embedder_miniature_from_its_own_init(embedder_script, jax_trajectory, tmp_path):
    """tests/train/test_train_serve_eval.py's run and thresholds on the
    port (its own init), the report's keys those of the committed JAX
    report, the checkpoint served by the port's client."""
    out = tmp_path / "run"
    results = embedder_script.main(
        ["--out", str(out), *MINI, "--steps", "300", "--device", "cpu"]
    )["results"]
    trained, random_init = results["trained"]["dense_only"], results["random_init"]["dense_only"]
    assert results["trained"]["bm25_only"]["recall_at_10"] <= 0.05
    assert trained["recall_at_10"] >= random_init["recall_at_10"] + 0.1
    assert trained["recall_at_10"] >= 0.5
    assert trained["mrr_at_10"] >= random_init["mrr_at_10"] + 0.05
    assert results["trained"]["hybrid"]["recall_at_10"] >= 0.2
    report = json.loads((out / "eval.json").read_text())
    assert report["train_history"][-1]["accuracy"] > 0.5
    assert _keys(report) == _keys(_committed("embedder"))
    _assert_servable(out / "checkpoint", reranker=False)
    _assert_servable(out / "random_checkpoint", reranker=False)


def test_embedder_follows_jax_from_the_same_init(embedder_script, jax_trajectory, monkeypatch, tmp_path):
    """Both packages' embedder miniature for 30 steps, each from its
    script's init at seed 0: the exported inits, the logged loss at
    step 30 and the eval metrics within the module docstring's
    tolerances."""
    jax_out, wait = jax_trajectory
    held = _holding_params(monkeypatch, embedder_script)
    out = tmp_path / "run"
    report = embedder_script.main(
        ["--out", str(out), *MINI, "--steps", str(TRAJECTORY_STEPS), "--device", "cpu"]
    )
    want = wait()

    got_init = hf_loader.read_safetensors(out / "random_checkpoint" / "model.safetensors")
    want_init = hf_loader.read_safetensors(jax_out / "random_checkpoint" / "model.safetensors")
    assert got_init.keys() == want_init.keys()
    for name in got_init:
        np.testing.assert_array_max_ulp(got_init[name], want_init[name], maxulp=INIT_MAX_ULP)
    init_dp = INIT_MAX_ULP * float(np.finfo(np.float32).eps) * max(
        float(np.abs(w).max()) for w in want_init.values()
    )

    (got_log,), (want_log,) = report["train_history"], want["train_history"]
    assert got_log["step"] == want_log["step"] == TRAJECTORY_STEPS
    schedule = e2e.lr_schedule(3e-4, TRAJECTORY_STEPS)
    dp = 2 * _scheduled_update_bound([schedule(t) for t in range(TRAJECTORY_STEPS - 1)]) + init_dp
    grad_l1 = sum(float(p.grad.abs().sum()) for p in TC.param_leaves(held["params"]))
    tol = 2 * grad_l1 * dp + LOSS_RTOL * abs(want_log["loss"]) + 1e-4
    assert abs(got_log["loss"] - want_log["loss"]) <= tol, (got_log, want_log, tol)

    for label, arms in want["results"].items():
        for arm, metrics in arms.items():
            got = report["results"][label][arm]
            for key in ("recall_at_1", "recall_at_10"):
                assert abs(round(got[key] * N_EVAL) - round(metrics[key] * N_EVAL)) <= 1, (
                    label, arm, key, got, metrics)
            assert abs(got["mrr_at_10"] - metrics["mrr_at_10"]) <= 1 / N_EVAL + 1e-4
    assert want["fused_selection_on_trained_geometry"]["n_rows"] == (
        report["fused_selection_on_trained_geometry"]["n_rows"]
    )


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_threefry_keys_and_bits_equal_jax(seed):
    """``threefry``'s key, split and bits: JAX's, bit for bit."""
    key = threefry.key(seed)
    np.testing.assert_array_equal(key, np.asarray(jax.random.key_data(jax.random.PRNGKey(seed))))
    keys = threefry.split(key, 16)
    np.testing.assert_array_equal(keys, np.asarray(jax.random.split(jax.random.PRNGKey(seed), 16)))
    for sub in keys[[0, 7, 15]]:
        np.testing.assert_array_equal(
            threefry.bits(sub, (37, 129)), np.asarray(jax.random.bits(jnp.asarray(sub), (37, 129)))
        )


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("tied", [True, False])
def test_threefry_init_equals_jax_init(seed, tied):
    """``init_train_state(draw="threefry")``, the scripts' draw: JAX's
    ``init_params(config, PRNGKey(seed))`` within INIT_MAX_ULP, every norm
    weight exactly, in the port's layout (an untied head drawn last, as in
    JAX)."""
    config = dataclasses.replace(e2e.model_config(264, 64, 2), tie_word_embeddings=tied)
    params, _ = TC.init_train_state(config, TC.make_optimizer(1e-3), seed=seed, device="cpu",
                                    draw="threefry")
    want = _jax_init(config, seed)
    got_leaves, want_leaves = TC.param_leaves(params), TC.param_leaves(TC.trainable(want))
    assert len(got_leaves) == len(want_leaves) == (13 if tied else 14)
    for got, expected in zip(got_leaves, want_leaves):
        assert got.shape == expected.shape and got.requires_grad
        np.testing.assert_array_max_ulp(got.detach().numpy(), expected.detach().numpy(),
                                        maxulp=INIT_MAX_ULP)
    differing = sum(int((g != w).sum()) for g, w in zip(got_leaves, want_leaves))
    assert differing < 0.01 * sum(g.numel() for g in got_leaves)


def test_reranker_miniature_from_jax_init(reranker_script, tmp_path):
    """tests/train/test_reranker_serve_eval.py's run and thresholds on the
    port, from JAX's seed-0 init (module docstring), the report's keys
    those of the committed JAX report, the checkpoint served by the port's
    client."""
    out = tmp_path / "run"
    report = reranker_script.main(["--out", str(out), *RERANKER_MINI, "--device", "cpu"])
    direct = report["reranker_direct"]
    assert direct["random_init"]["recall_at_1_of_50"] <= 0.12
    assert direct["trained"]["recall_at_1_of_50"] >= 0.15
    pipe = report["pipeline"]
    full, hybrid = pipe["full_pipeline_trained"], pipe["hybrid_no_rerank"]
    assert full["recall_at_1"] >= 0.45
    assert full["recall_at_1"] >= hybrid["recall_at_1"] + 0.2
    assert full["mrr_at_10"] >= hybrid["mrr_at_10"] + 0.1
    assert full["recall_at_10"] >= pipe["dense_only"]["recall_at_10"] - 0.05
    assert full["recall_at_10"] >= 0.95
    assert _keys(json.loads((out / "eval.json").read_text())) == _keys(_committed("reranker"))
    _assert_servable(out / "checkpoint", reranker=True)


def test_scripts_refuse_a_missing_card(embedder_script, reranker_script, tmp_path, monkeypatch):
    """CUDA by default: without a card, no --device cpu means an error."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for script in (embedder_script, reranker_script):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            script.main(["--out", str(tmp_path / "run")])
