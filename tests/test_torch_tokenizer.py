"""The port's WordLevel tokenizer reader vs transformers.

Every committed tokenizer (runs/*/{checkpoint,tokenizer}/tokenizer.json)
must give the same ids as ``AutoTokenizer`` with truncation, and
``encode_batch`` the same padded arrays as the JAX package's. Exact
equality: both are integer maps.
"""

import functools
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from lean_explore_tpu.models.tokenizer import encode_batch as jax_encode_batch
from lean_explore_tpu_torch.models.tokenizer import (
    WordLevelTokenizer,
    bucket_batch,
    bucket_length,
    encode_batch,
    load_tokenizer,
)

REPO = Path(__file__).resolve().parent.parent
TOKENIZER_DIRS = sorted(
    str(p.parent.relative_to(REPO))
    for pattern in ("runs/*/*/tokenizer.json", "runs/*/*/*/tokenizer.json")
    for p in REPO.glob(pattern)
    if p.parent.name in ("checkpoint", "tokenizer")
)
TEXTS = [
    "Nat.add_comm: the sum of two natural numbers commutes",
    "<Instruct>: find relevant\n<Query>: x_y <eos> foo <pad>",
    "héllo wörld ∀ x, f(x) = 0 __init__",
    "a  b\t c",
    "**Thing 3.** does w1 w2 stuff 7 " * 40,
    "",
]


def test_every_committed_tokenizer_is_covered():
    assert len(TOKENIZER_DIRS) >= 8


@pytest.mark.parametrize("model_dir", TOKENIZER_DIRS)
def test_ids_match_transformers(model_dir):
    from transformers import AutoTokenizer

    hf = AutoTokenizer.from_pretrained(str(REPO / model_dir), local_files_only=True)
    ours = load_tokenizer(REPO / model_dir)
    assert ours(TEXTS)["input_ids"] == hf(TEXTS)["input_ids"]
    kw = dict(truncation=True, max_length=16)
    assert ours(TEXTS, **kw)["input_ids"] == hf(TEXTS, **kw)["input_ids"]
    for token in ("true", "false", "<eos>", "nat", "no-such-token"):
        assert ours.convert_tokens_to_ids(token) == hf.convert_tokens_to_ids(token)
    assert (ours.pad_token_id, ours.eos_token_id) == (hf.pad_token_id, hf.eos_token_id)

    for append_eos in (False, True):
        got = encode_batch(ours, TEXTS, max_length=64, append_eos=append_eos)
        want = jax_encode_batch(hf, TEXTS, max_length=64, append_eos=append_eos)
        np.testing.assert_array_equal(got.input_ids, want.input_ids)
        np.testing.assert_array_equal(got.attention_mask, want.attention_mask)
        assert got.n_valid == want.n_valid


def test_whitespace_only_tokenizer_with_named_specials(tmp_path):
    """The serving smoke run's tokenizer: Whitespace pre-tokenizer, special
    tokens named by the caller."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {"<pad>": 0, "<unk>": 1, "<eos>": 2, "true": 3, "false": 4, "a": 5, ":": 6}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(str(tmp_path / "tokenizer.json"))
    specials = dict(pad_token="<pad>", eos_token="<eos>", unk_token="<unk>")
    hf = PreTrainedTokenizerFast(tokenizer_file=str(tmp_path / "tokenizer.json"), **specials)
    ours = WordLevelTokenizer.from_file(tmp_path / "tokenizer.json", **specials)
    texts = ["a : true<eos>false", "b a:a", "<pad><unk>"]
    assert ours(texts)["input_ids"] == hf(texts)["input_ids"]


def test_other_models_raise():
    with pytest.raises(ValueError, match="WordLevel"):
        WordLevelTokenizer({"model": {"type": "BPE", "vocab": {}, "merges": []}})
    with pytest.raises(ValueError, match="pre-tokenizer"):
        WordLevelTokenizer(
            {"model": {"type": "WordLevel", "vocab": {"a": 0}},
             "pre_tokenizer": {"type": "ByteLevel"}}
        )


def test_buckets():
    assert [bucket_batch(n) for n in (1, 3, 100, 129)] == [1, 4, 128, 256]
    assert [bucket_length(n, 256) for n in (5, 33, 300)] == [32, 64, 256]


@pytest.mark.parametrize("model_dir", TOKENIZER_DIRS)
def test_decode_matches_transformers(model_dir):
    """The reranker cascade's ``_truncate_docs`` decodes capped documents:
    the port's strings must be HF's for every committed tokenizer."""
    from transformers import AutoTokenizer

    hf = AutoTokenizer.from_pretrained(str(REPO / model_dir), local_files_only=True)
    ours = load_tokenizer(REPO / model_dir)
    for row in ours(TEXTS, truncation=True, max_length=48)["input_ids"]:
        assert ours.decode(row) == hf.decode(row)


def test_a_post_processor_raises(tmp_path):
    """A post-processor adds tokens that the reader would not: it raises at
    load instead of encoding without them."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors
    from transformers import PreTrainedTokenizerFast

    vocab = {"<unk>": 0, "<eos>": 1, "a": 2}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = processors.TemplateProcessing(
        single="$A <eos>", special_tokens=[("<eos>", 1)]
    )
    tok.save(str(tmp_path / "tokenizer.json"))
    hf = PreTrainedTokenizerFast(tokenizer_file=str(tmp_path / "tokenizer.json"))
    assert hf("a a")["input_ids"] == [2, 2, 1]
    with pytest.raises(ValueError, match="post-processor 'TemplateProcessing'"):
        WordLevelTokenizer.from_file(tmp_path / "tokenizer.json")


# HuggingFace's Whitespace pre-tokenizer runs the Oniguruma engine, whose
# \w and \s are not Python's (ROADMAP C9). One string per category in which
# the two engines disagree, and the two that showed it on the 200k chain.
CHAIN_TOKENIZERS = ("runs/scale200k/embedder/tokenizer", "runs/scale200k/reranker/tokenizer")
CLASS_TEXTS = [
    "sum of f₁ and x² over the reals",  # No: subscripts, superscripts
    "the mean x̄ of a list",  # Mn: a combining macron
    "the sign ः here and ि there",  # Mc: spacing combining marks
    "ⓐ circled ⓑ letters",  # So
    "an enclosed a⃝ b",  # Me
    "x‿y and a⁀b",  # Pc
    "zero‍width‌joiners",  # Cf
    "file\x1cgroup\x1drecord\x1eunit\x1fsep",  # Python's \s, not HF's
    "astral 𝔸 𝟙 𐍈 😀 words",
]


@pytest.mark.parametrize("model_dir", CHAIN_TOKENIZERS)
def test_unicode_word_classes_are_hf_s(model_dir):
    from tokenizers import Tokenizer

    from lean_explore_tpu.models.tokenizer import load_tokenizer as jax_load

    hf = Tokenizer.from_file(str(REPO / model_dir / "tokenizer.json"))
    jax_tok = jax_load(REPO / model_dir)
    ours = load_tokenizer(REPO / model_dir)
    got = ours(CLASS_TEXTS)["input_ids"]
    assert got == [e.ids for e in hf.encode_batch(CLASS_TEXTS)]
    assert got == jax_tok(CLASS_TEXTS)["input_ids"]
    assert [len(row) for row in got[:2]] == [10, 6]


_CLASS_EDGE = st.sampled_from(
    list("\x1c\x1d\x1e\x1f₁²x̄ः⃝‿‍‌ⓐ∀ℝ⟨⟩ \t\n") + ["\U0001d538", "\U0001f600"]
)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.one_of(st.text(max_size=12), _CLASS_EDGE), max_size=8).map("".join))
def test_unicode_word_classes_property(text):
    for model_dir in CHAIN_TOKENIZERS:
        ours, hf = _chain_tokenizers(model_dir)
        assert ours(text)["input_ids"] == hf.encode(text).ids


@functools.cache
def _chain_tokenizers(model_dir):
    from tokenizers import Tokenizer

    hf = Tokenizer.from_file(str(REPO / model_dir / "tokenizer.json"))
    return load_tokenizer(REPO / model_dir), hf


def test_committed_classes_rederive_from_tokenizers():
    """``unicode_classes.py`` is what ``tokenizers`` gives now, over every
    code point (a few batched pre-tokenizer calls)."""
    import sys

    import tokenizers

    from lean_explore_tpu_torch.models import unicode_classes

    sys.path.insert(0, str(REPO / "scripts"))
    import make_torch_unicode_classes as make

    derived = make.derive()
    for name, ranges in derived.items():
        assert tuple(ranges) == getattr(unicode_classes, name), name
    assert unicode_classes.TOKENIZERS_VERSION == tokenizers.__version__
