"""The port's byte-level BPE reader (lean_explore_tpu_torch/models/bpe.py)
against HuggingFace ``tokenizers``, on tokenizers trained in the test with
``BpeTrainer`` (scripts/make_torch_bpe_fixture.py's ``build``, over
train/synthetic.py's corpus and Lean-style Unicode text) in both
pre-tokenizer variants: Qwen's (NFC, Split on its pattern, ByteLevel
without a regex) and GPT-2's (ByteLevel with its regex and a prefix space).

Ids, masks, truncation, special and added tokens and decode are integer or
string maps: held exactly. Embeddings through both packages'
EmbeddingClient are held to the existing embedding tolerance (atol and
rtol 2e-4, tests/test_torch_qwen3.py).
"""

import json
import sys
import time
import unicodedata
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from lean_explore_tpu.models.tokenizer import encode_batch as jax_encode_batch
from lean_explore_tpu.util.embedding_client import EmbeddingClient as JaxEmbeddingClient
from lean_explore_tpu_torch.models.bpe import ByteLevelBPETokenizer
from lean_explore_tpu_torch.models.tokenizer import encode_batch, load_tokenizer
from lean_explore_tpu_torch.util.embedding_client import EmbeddingClient
from tests.helpers import make_tiny_model_dir

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))
import make_torch_bpe_fixture as fixture  # noqa: E402

VARIANTS = ("qwen", "gpt2")
TEXTS = [
    "∀ x ∈ ℝ, f₁ x² ≤ ⟨a, b⟩ and the mean x̄ of a list",
    "theorem Nat.add_comm (a b : ℕ) : a + b = b + a := by\r\n  omega",
    "定理：自然数的加法满足交换律 😀 🚀 👨‍👩‍👧",
    "it's the lemma's proof; we'll see THEY'RE done, I've 12345678 and 3.14159",
    "  leading spaces\tand tabs\n\nnew paragraphs ⊢ ∃ y, y ≠ 0 → ¬ p   ",
    "<|im_start|>user\nfind a lemma<|im_end|><|endoftext|>",
    "a<think>b   </think>   c theorem theorems xtheorem ℝ≥0",
    "é decomposed and é composed, ﬁ ligature, \x1c\x1f controls",
    "",
    "   ",
]


@pytest.fixture(scope="module", params=VARIANTS)
def built(request, tmp_path_factory):
    """(variant, HF tokenizer, the port's reader of its saved file)."""
    tok = fixture.build(request.param, n_decls=2000)
    path = tmp_path_factory.mktemp(f"bpe_{request.param}") / "tokenizer.json"
    tok.save(str(path))
    return request.param, tok, ByteLevelBPETokenizer.from_file(path)


def _assert_like_hf(ours, hf, texts):
    got = ours(texts)
    want = hf.encode_batch(texts)
    assert got["input_ids"] == [e.ids for e in want]
    assert got["attention_mask"] == [e.attention_mask for e in want]
    for ids in got["input_ids"]:
        for skip in (False, True):
            assert ours.decode(ids, skip_special_tokens=skip) == hf.decode(
                ids, skip_special_tokens=skip
            )


def test_examples_match_hf(built):
    variant, hf, ours = built
    _assert_like_hf(ours, hf, TEXTS)
    hf.enable_truncation(7)
    try:
        got = ours(TEXTS, truncation=True, max_length=7)["input_ids"]
        assert got == [e.ids for e in hf.encode_batch(TEXTS)]
    finally:
        hf.no_truncation()
    # Special and added tokens are single ids; a single_word token inside a
    # word is not one.
    ids = ours("<|im_start|><think>theorem")["input_ids"]
    assert ids == [ours.convert_tokens_to_ids(t) for t in ("<|im_start|>", "<think>", "theorem")]
    assert len(ours("xtheorem")["input_ids"]) > 1
    prefix = " " if variant == "gpt2" else ""  # ByteLevel's add_prefix_space
    decoded = ours.decode(ours(TEXTS[5])["input_ids"], skip_special_tokens=True)
    assert decoded == prefix + "user\nfind a lemma"


_EDGES = st.sampled_from(
    ["<|endoftext|>", "<think>", " </think> ", "theorem", "ℝ≥0", "'s", "'LL", "\r\n", "  ",
     "é", "₁", "😀", "定理", "123456", "\x1c", "ſ", " ", "_", "ⓐ", "x̄"]
)


@settings(max_examples=150, deadline=None)
@given(text=st.lists(st.one_of(st.text(max_size=10), _EDGES), max_size=8).map("".join))
def test_property_matches_hf(built, text):
    _, hf, ours = built
    _assert_like_hf(ours, hf, [text])


def test_round_trip_is_the_normalized_text(built):
    variant, _, ours = built
    for text in TEXTS:
        want = unicodedata.normalize("NFC", text) if variant == "qwen" else text
        if variant == "gpt2" and not text.startswith(" "):
            want = " " + want  # the prefix space ByteLevel adds
        added = fixture.SPECIAL + [t["content"] for t in fixture.ADDED]
        if any(t in text for t in added) or not text.strip():
            continue  # added tokens split the prefix space and strip spaces
        assert ours.decode(ours(text)["input_ids"]) == want


def _spec(hf) -> dict:
    return json.loads(hf.to_str())


def test_merges_as_strings_and_ignore_merges(built):
    """The older file format ("a b" merges) gives the same ids; with
    ``ignore_merges`` a word in the vocabulary is one id, as in HF."""
    from tokenizers import Tokenizer

    _, hf, _ = built
    spec = _spec(hf)
    spec["model"]["merges"] = [" ".join(pair) for pair in spec["model"]["merges"]]
    _assert_like_hf(ByteLevelBPETokenizer(spec), Tokenizer.from_str(json.dumps(spec)), TEXTS)
    spec["model"]["ignore_merges"] = True
    # Words in the vocabulary that the merges do not reach: the last two
    # merges' tokens renamed (tokenizers numbers the added tokens after the
    # vocabulary, so its size stays).
    vocab, merges = spec["model"]["vocab"], spec["model"]["merges"]
    for new, (a, b) in zip(("Ġzzqx", "zzqx"), (m.split(" ") for m in merges[-2:])):
        vocab[new] = vocab.pop(a + b)
    del merges[-2:]
    hf_ignore = Tokenizer.from_str(json.dumps(spec))
    _assert_like_hf(ByteLevelBPETokenizer(spec), hf_ignore, TEXTS + ["zzqx", " zzqx"])


@pytest.mark.parametrize(
    "edit,name",
    [
        (lambda s: s.update(post_processor={"type": "TemplateProcessing", "single": [],
                                            "pair": [], "special_tokens": {}}),
         "TemplateProcessing"),
        (lambda s: s["model"].update(dropout=0.1), "dropout"),
        (lambda s: s["model"].update(byte_fallback=True), "byte_fallback"),
        (lambda s: s["model"].update(continuing_subword_prefix="##"), "continuing_subword_prefix"),
        (lambda s: s["model"].update(end_of_word_suffix="</w>"), "end_of_word_suffix"),
        (lambda s: s.update(normalizer={"type": "Lowercase"}), "Lowercase"),
        (lambda s: s.update(pre_tokenizer={"type": "Whitespace"}), "Whitespace"),
        (lambda s: s.update(decoder={"type": "WordPiece"}), "WordPiece"),
        (lambda s: s["pre_tokenizer"]["pretokenizers"][0].update(pattern={"Regex": "a*"}),
         "Split pattern 'a\\*'"),
    ],
    ids=["template", "dropout", "byte_fallback", "prefix", "suffix", "normalizer",
         "pre_tokenizer", "decoder", "empty_match"],
)
def test_what_is_not_read_raises_by_name(edit, name):
    spec = json.loads((REPO / "tests" / "fixtures" / "bpe_qwen_style" / "tokenizer.json")
                      .read_text())
    edit(spec)
    with pytest.raises(ValueError, match=name):
        ByteLevelBPETokenizer(spec)


def test_committed_fixture_matches_hf():
    """The file chip_smoke.py times on the card: HF's ids, and the reader
    load_tokenizer picks for it."""
    from tokenizers import Tokenizer

    path = REPO / "tests" / "fixtures" / "bpe_qwen_style"
    ours = load_tokenizer(path)
    assert isinstance(ours, ByteLevelBPETokenizer)
    assert ours.eos_token_id == ours.pad_token_id == ours.convert_tokens_to_ids("<|endoftext|>")
    _assert_like_hf(ours, Tokenizer.from_file(str(path / "tokenizer.json")), TEXTS)


@pytest.fixture(scope="module")
def bpe_model_dir(tmp_path_factory):
    """tests/helpers.make_tiny_model_dir's checkpoint, its embedding table
    grown to the BPE vocabulary, carrying the committed fixture."""
    import transformers

    path = make_tiny_model_dir(tmp_path_factory.mktemp("bpe_model") / "m", seed=3)
    fixture_dir = REPO / "tests" / "fixtures" / "bpe_qwen_style"
    spec = json.loads((fixture_dir / "tokenizer.json").read_text())
    n = max(t["id"] for t in spec["added_tokens"]) + 1
    torch.manual_seed(3)
    model = transformers.Qwen3ForCausalLM.from_pretrained(path)
    model.resize_token_embeddings((n + 7) // 8 * 8, mean_resizing=False)
    model.save_pretrained(path, safe_serialization=True)
    (path / "tokenizer.json").write_bytes((fixture_dir / "tokenizer.json").read_bytes())
    config = json.loads((fixture_dir / "tokenizer_config.json").read_text())
    config.update(tokenizer_class="PreTrainedTokenizerFast", model_max_length=512)
    (path / "tokenizer_config.json").write_text(json.dumps(config))
    return path


def test_encode_batch_and_embeddings_equal_jax(bpe_model_dir):
    texts = TEXTS[:8] + ["query about ∑ and ∫", "x" * 300]
    jax_client = JaxEmbeddingClient("tiny", model_dir=bpe_model_dir, max_length=64,
                                    dtype="float32")
    client = EmbeddingClient("tiny", model_dir=bpe_model_dir, max_length=64,
                             dtype=torch.float32, device="cpu")
    for append_eos in (False, True):
        got = encode_batch(client.tokenizer, texts, max_length=64, append_eos=append_eos)
        want = jax_encode_batch(jax_client.tokenizer, texts, max_length=64, append_eos=append_eos)
        np.testing.assert_array_equal(got.input_ids, want.input_ids)
        np.testing.assert_array_equal(got.attention_mask, want.attention_mask)
    for is_query in (False, True):
        np.testing.assert_allclose(client.embed_sync(texts, is_query=is_query),
                                   jax_client.embed_sync(texts, is_query=is_query),
                                   atol=2e-4, rtol=2e-4)


def test_docs_per_second_beside_hf():
    """The reader's rate on the synthetic informalizations against HF's
    (``encode_batch`` of tokenizers, threads and all), printed; no
    threshold."""
    from tokenizers import Tokenizer

    from lean_explore_tpu_torch.train.synthetic import make_corpus

    path = REPO / "tests" / "fixtures" / "bpe_qwen_style"
    docs = [d.informalization for d in make_corpus(n_decls=2000, n_concepts=120, n_eval=32,
                                                   seed=1, body_sentences=1).declarations]
    hf = Tokenizer.from_file(str(path / "tokenizer.json"))
    ours = load_tokenizer(path)
    start = time.perf_counter()
    got = ours(docs)["input_ids"]
    ours_rate = len(docs) / (time.perf_counter() - start)
    start = time.perf_counter()
    want = [e.ids for e in hf.encode_batch(docs)]
    hf_rate = len(docs) / (time.perf_counter() - start)
    assert got == want
    print(f"\nBPE reader {ours_rate:.0f} docs/s, HF tokenizers {hf_rate:.0f} docs/s "
          f"({len(docs)} docs, CPU)")
