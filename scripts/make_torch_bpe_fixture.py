"""Build a small byte-level BPE tokenizer of Qwen's pipeline with
HuggingFace ``tokenizers`` (BpeTrainer), and write it to
tests/fixtures/bpe_qwen_style/ (tokenizer.json, tokenizer_config.json).

The fixture is what the card's machine, which has no ``tokenizers``, reads
to time the port's BPE reader (chip_smoke.py phase 8); the CPU tests build
the same tokenizers in the test through ``build`` and hold the port's
reader (lean_explore_tpu_torch/models/bpe.py) to them.

    python scripts/make_torch_bpe_fixture.py [--check]

``--check`` exits 1 when the committed files differ from a fresh build.
"""

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
OUT = REPO / "tests" / "fixtures" / "bpe_qwen_style"

# Qwen2/Qwen3's split (their tokenizer.json's Split pre-tokenizer).
QWEN_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*"
    r"|\s*[\r\n]+|\s+(?!\S)|\s+"
)
VOCAB_SIZE = 4096
SPECIAL = ["<|endoftext|>", "<|im_start|>", "<|im_end|>"]
# Added tokens that are not special, one of each flag tokenizers reads.
ADDED = [
    dict(content="<think>", normalized=False),
    dict(content="</think>", normalized=False, lstrip=True, rstrip=True),
    dict(content="theorem", normalized=True, single_word=True),
    dict(content="ℝ≥0", normalized=True),
]
# Lean-style Unicode text beside the synthetic corpus: symbols, subscripts,
# combining marks, CJK, emoji, CRLF, digit runs and contractions.
EXTRA_TEXTS = [
    "∀ x ∈ ℝ, f₁ x² ≤ ⟨a, b⟩ and the mean x̄ of a list",
    "theorem Nat.add_comm (a b : ℕ) : a + b = b + a := by\r\n  omega",
    "定理：自然数的加法满足交换律 😀 🚀 ∑ i in range 10, i",
    "it's the lemma's proof; we'll see they're done, I've 12345678 and 3.14159",
    "  leading spaces\tand tabs\n\nnew paragraphs ⊢ ∃ y, y ≠ 0 → ¬ p",
]


def training_texts(n_decls: int) -> list[str]:
    from lean_explore_tpu_torch.train.synthetic import make_corpus

    corpus = make_corpus(n_decls=n_decls, n_concepts=max(n_decls // 16, 48), n_eval=32,
                         seed=0, body_sentences=1)
    return corpus.texts() + EXTRA_TEXTS * 20


def build(variant: str = "qwen", n_decls: int = 20_000):
    """The fixture's ``tokenizers.Tokenizer``: ``qwen`` (NFC, Split on
    Qwen's pattern then ByteLevel without its regex) or ``gpt2`` (ByteLevel
    with its regex and a prefix space, no normalizer), trained on
    ``n_decls`` synthetic declarations (the fixture's 20,000 fill the 4,096
    tokens; the tests take fewer)."""
    from tokenizers import AddedToken, Regex, Tokenizer, decoders, models, normalizers
    from tokenizers import pre_tokenizers, processors, trainers

    tok = Tokenizer(models.BPE())
    if variant == "qwen":
        tok.normalizer = normalizers.NFC()
        tok.pre_tokenizer = pre_tokenizers.Sequence([
            pre_tokenizers.Split(Regex(QWEN_PATTERN), behavior="isolated"),
            pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False),
        ])
    elif variant == "gpt2":
        tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=True, use_regex=True)
    else:
        raise ValueError(variant)
    tok.post_processor = processors.ByteLevel(trim_offsets=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=VOCAB_SIZE,
        special_tokens=[AddedToken(t, special=True, normalized=False) for t in SPECIAL],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        show_progress=False,
    )
    tok.train_from_iterator(training_texts(n_decls), trainer=trainer)
    tok.add_tokens([AddedToken(**spec) for spec in ADDED])
    return tok


def write(out: Path) -> None:
    out.mkdir(parents=True, exist_ok=True)
    build("qwen").save(str(out / "tokenizer.json"))
    config = {"eos_token": "<|endoftext|>", "pad_token": "<|endoftext|>", "unk_token": None}
    (out / "tokenizer_config.json").write_text(json.dumps(config, indent=1) + "\n")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", action="store_true")
    args = parser.parse_args(argv)
    if args.check:
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            write(Path(tmp))
            same = all(
                (Path(tmp) / name).read_bytes() == (OUT / name).read_bytes()
                for name in ("tokenizer.json", "tokenizer_config.json")
            )
        print("fixture is", "current" if same else "stale")
        return 0 if same else 1
    write(OUT)
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
