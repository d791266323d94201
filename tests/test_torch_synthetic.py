"""The port's synthetic corpus (lean_explore_tpu_torch/train/synthetic.py)
against the JAX package's module at the same seeds: the same declarations,
concepts, eval queries and training examples, exactly, and a WordLevel
tokenizer file that HuggingFace ``tokenizers`` and the port read to the
same ids, byte-identical to the file the JAX module writes.
"""

import dataclasses
import json

import numpy as np
import pytest
from tokenizers import Tokenizer

from lean_explore_tpu.train import synthetic as jax_synthetic
from lean_explore_tpu_torch.models.tokenizer import load_tokenizer
from lean_explore_tpu_torch.train import synthetic

CORPORA = [
    dict(n_decls=60, n_concepts=30, n_eval=8, seed=0, body_sentences=1),
    dict(n_decls=300, n_concepts=80, n_eval=32, seed=3, body_sentences=5),
    dict(n_decls=200, n_concepts=40, n_eval=500, seed=7, body_sentences=7,
         holdout_fraction=0.3),
]


def _decls(corpus) -> list[dict]:
    return [dataclasses.asdict(d) for d in corpus.declarations]


def _as_ints(triples) -> list[tuple[int, ...]]:
    return [tuple(int(x) for x in t) for t in triples]


@pytest.fixture(scope="module", params=range(len(CORPORA)))
def pair(request):
    kwargs = CORPORA[request.param]
    return jax_synthetic.make_corpus(**kwargs), synthetic.make_corpus(**kwargs)


def test_make_corpus_equals_jax(pair):
    want, got = pair
    assert _decls(got) == _decls(want)
    assert [(c.base, c.synonym) for c in got.concepts] == [
        (c.base, c.synonym) for c in want.concepts
    ]
    assert got.eval_queries == want.eval_queries
    assert got.n_train == want.n_train
    assert _as_ints(got.triples) == _as_ints(want.triples)
    assert got.texts() == want.texts()
    assert [synthetic.reranker_document(d) for d in got.declarations] == [
        jax_synthetic.reranker_document(d) for d in want.declarations
    ]


@pytest.mark.parametrize("name_variants", [True, False])
def test_make_reranker_examples_equals_jax(pair, name_variants):
    want, got = pair
    kwargs = dict(name_variants=name_variants, variant_fraction=0.5)
    assert synthetic.make_reranker_examples(
        got, np.random.default_rng(5), **kwargs
    ) == jax_synthetic.make_reranker_examples(want, np.random.default_rng(5), **kwargs)


def test_paraphrase_pairs_and_name_queries_equal_jax(pair):
    want, got = pair
    assert synthetic.make_paraphrase_pairs(got) == jax_synthetic.make_paraphrase_pairs(want)
    assert synthetic.make_name_queries(
        got, np.random.default_rng(9), n_per_class=10
    ) == jax_synthetic.make_name_queries(want, np.random.default_rng(9), n_per_class=10)


def test_same_errors_as_jax():
    for module in (jax_synthetic, synthetic):
        with pytest.raises(ValueError, match="template pool"):
            module.make_corpus(n_decls=10, n_concepts=10, body_sentences=8)
        corpus = module.make_corpus(n_decls=20, n_concepts=12)
        corpus.triples = None
        with pytest.raises(ValueError, match="without triples"):
            module.make_paraphrase_pairs(corpus)
        with pytest.raises(ValueError, match="without triples"):
            module.make_reranker_examples(corpus, np.random.default_rng(0))


def test_tokenizer_file_is_jax_s_byte_for_byte(pair, tmp_path):
    _, corpus = pair
    texts = corpus.texts()
    extra = ("the {s0} over any", "Ünïcode ∀ x_y , é.")
    jax_dir = jax_synthetic.build_wordlevel_tokenizer(
        texts, tmp_path / "jax", extra_texts=extra
    )
    port_dir = synthetic.build_wordlevel_tokenizer(
        texts, tmp_path / "port", extra_texts=extra
    )
    for name in ("tokenizer.json", "tokenizer_config.json"):
        assert (port_dir / name).read_bytes() == (jax_dir / name).read_bytes(), name

    hf = Tokenizer.from_file(str(port_dir / "tokenizer.json"))
    port = load_tokenizer(port_dir)
    assert hf.get_vocab() == port.vocab
    assert json.loads((port_dir / "tokenizer.json").read_text(encoding="utf-8"))["model"]["vocab"] == port.vocab
    sample = [*texts[:40], *extra, "an unseen_word zzz here"]
    want = [e.ids for e in hf.encode_batch(sample)]
    assert port(sample)["input_ids"] == want
    assert (port.pad_token_id, port.unk_token_id, port.eos_token_id) == (0, 1, 2)
