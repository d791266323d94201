"""Tokenizer loading and bucketed batch encoding.

``encode_batch`` and the buckets are those of the JAX package
(lean_explore_tpu/models/tokenizer.py): right padding to a few (batch,
length) buckets, pad rows keeping one valid token. The tokenizer itself is
a pure-Python reader of a HuggingFace ``tokenizer.json``: here one whose
model is ``WordLevel`` and whose pre-tokenizers are ``Whitespace`` and
``CharDelimiterSplit`` (alone or in a ``Sequence``), the kind every
committed checkpoint carries, and in ``bpe`` a byte-level BPE (Qwen's
kind). ``load_tokenizer`` picks the reader by the model's type; another
type, or a part a reader does not apply, raises.
"""

import functools
import json
import logging
import re
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from lean_explore_tpu_torch.models.unicode_classes import SPACE, WORD, char_class

logger = logging.getLogger(__name__)

LENGTH_BUCKETS = (32, 64, 128, 256, 512)
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


class UnicodePattern:
    """A regex over HuggingFace's character classes (``unicode_classes``),
    compiled twice from ``build(cc)``, where ``cc`` takes ``char_class``'s
    arguments: once over every code point, once over the BMP alone, which
    ``re`` matches about ten times faster. ``findall`` takes the BMP one
    unless the text holds an astral character."""

    def __init__(self, build):
        self._full = re.compile(build(char_class))
        self._bmp = re.compile(build(functools.partial(char_class, bmp=True)))

    def pattern(self, text: str) -> re.Pattern:
        return self._bmp if not text or max(text) <= "\uffff" else self._full

    def findall(self, text: str) -> list[str]:
        return self.pattern(text).findall(text)


# HuggingFace's Whitespace pre-tokenizer, ``\w+|[^\w\s]+``, with its own
# engine's ``\w`` and ``\s``: Python's count subscript digits as word
# characters, combining marks not, and \x1c-\x1f as space.
_WHITESPACE = UnicodePattern(
    lambda cc: f"{cc(WORD)}+|{cc(WORD, SPACE, negate=True)}+"
)


def _split_whitespace(pieces: list[str]) -> list[str]:
    return [m for piece in pieces for m in _WHITESPACE.findall(piece)]


def _split_char(delimiter: str):
    def split(pieces: list[str]) -> list[str]:
        return [part for piece in pieces for part in piece.split(delimiter) if part]

    return split


def pre_tokenizer(spec: dict | None):
    """The pre-tokenizer a ``tokenizer.json`` spec names, as a function
    from a list of text pieces to the list of words."""
    if spec is None:
        return lambda pieces: pieces
    kind = spec.get("type")
    if kind == "Whitespace":
        return _split_whitespace
    if kind == "CharDelimiterSplit":
        return _split_char(spec["delimiter"])
    if kind == "Sequence":
        steps = [pre_tokenizer(s) for s in spec["pretokenizers"]]

        def run(pieces: list[str]) -> list[str]:
            for step in steps:
                pieces = step(pieces)
            return pieces

        return run
    raise ValueError(f"unsupported pre-tokenizer {kind!r}")


class WordLevelTokenizer:
    """Encoder for a WordLevel ``tokenizer.json``, with the call surface
    the clients use: ``tokenizer(texts, truncation=..., max_length=...)``,
    ``convert_tokens_to_ids`` and the pad/eos/unk ids.

    Special tokens (pad, eos, unk and the file's added tokens) are matched
    in the raw text before pre-tokenization, as HuggingFace does.
    """

    def __init__(
        self,
        spec: dict,
        *,
        pad_token: str | None = None,
        eos_token: str | None = None,
        unk_token: str | None = None,
    ):
        model = spec.get("model", {})
        if model.get("type") != "WordLevel":
            raise ValueError(
                f"unsupported tokenizer model {model.get('type')!r}: this "
                "reader takes WordLevel (models.bpe takes BPE)"
            )
        if spec.get("normalizer") is not None:
            raise ValueError("tokenizer normalizers are not supported")
        if spec.get("post_processor") is not None:
            # Encodes, and _truncate_docs' add_special_tokens=False, are only
            # HF's when no post-processor adds tokens.
            raise ValueError(
                f"unsupported tokenizer post-processor "
                f"{spec['post_processor'].get('type')!r}: it is not applied"
            )
        self.vocab: dict[str, int] = dict(model["vocab"])
        self._decoder = spec.get("decoder")
        self._pre = pre_tokenizer(spec.get("pre_tokenizer"))
        unk_token = unk_token or model.get("unk_token")
        self.unk_token_id = self.vocab.get(unk_token) if unk_token else None
        self.pad_token_id = self.vocab.get(pad_token) if pad_token else None
        self.eos_token_id = self.vocab.get(eos_token) if eos_token else None
        specials = {t["content"]: t["id"] for t in spec.get("added_tokens", [])}
        for token in (pad_token, eos_token, unk_token):
            if token and token in self.vocab:
                specials.setdefault(token, self.vocab[token])
        self._specials = specials
        self._id_to_token = {i: t for t, i in {**self.vocab, **specials}.items()}
        self._special_re = (
            re.compile(
                "|".join(
                    re.escape(t) for t in sorted(specials, key=len, reverse=True)
                )
            )
            if specials
            else None
        )

    @classmethod
    def from_file(cls, path: str | Path, **special_tokens) -> "WordLevelTokenizer":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f), **special_tokens)

    def _word_id(self, word: str) -> int:
        tid = self.vocab.get(word)
        if tid is None:
            if self.unk_token_id is None:
                raise KeyError(f"token {word!r} not in vocabulary and no unk token")
            return self.unk_token_id
        return tid

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        pos = 0
        matches = self._special_re.finditer(text) if self._special_re else ()
        for m in matches:
            ids.extend(self._word_id(w) for w in self._pre([text[pos : m.start()]]))
            ids.append(self._specials[m.group(0)])
            pos = m.end()
        ids.extend(self._word_id(w) for w in self._pre([text[pos:]]))
        return ids

    def __call__(
        self,
        texts,
        *,
        truncation: bool = False,
        max_length: int | None = None,
        padding: bool = False,
        add_special_tokens: bool = True,
    ) -> dict:
        """HF's call surface. ``add_special_tokens`` changes nothing: only a
        post-processor adds special tokens, and one raises at load."""
        if padding:
            raise ValueError("padding is done by encode_batch")
        single = isinstance(texts, str)
        rows = [self.encode(t) for t in ([texts] if single else texts)]
        if truncation and max_length is not None:
            rows = [row[:max_length] for row in rows]
        masks = [[1] * len(row) for row in rows]
        if single:
            return {"input_ids": rows[0], "attention_mask": masks[0]}
        return {"input_ids": rows, "attention_mask": masks}

    def convert_tokens_to_ids(self, token: str) -> int | None:
        return self.vocab.get(token, self.unk_token_id)

    def decode(self, ids) -> str:
        """The tokens of ``ids`` joined by single spaces, special tokens
        kept: what HuggingFace's decode gives for a tokenizer.json without a
        decoder and without clean-up of tokenization spaces (the committed
        checkpoints' tokenizers). Another decoder raises."""
        if self._decoder is not None:
            raise NotImplementedError(
                f"decode of a tokenizer with a {self._decoder.get('type')!r} decoder"
            )
        return " ".join(self._id_to_token[int(i)] for i in ids)


def load_tokenizer(model_dir: str | Path):
    """Read ``tokenizer.json`` and the special tokens named in
    ``tokenizer_config.json`` from a local model directory: a
    ``WordLevelTokenizer``, or a ``bpe.ByteLevelBPETokenizer`` for a BPE
    model."""
    model_dir = Path(model_dir)
    path = model_dir / "tokenizer.json"
    if not path.exists():
        raise FileNotFoundError(f"No tokenizer.json under {model_dir}")
    special = {}
    config_path = model_dir / "tokenizer_config.json"
    if config_path.exists():
        config = json.loads(config_path.read_text())
        for key in ("pad_token", "eos_token", "unk_token"):
            value = config.get(key)
            if isinstance(value, dict):
                value = value.get("content")
            if isinstance(value, str):
                special[key] = value
    with open(path, encoding="utf-8") as f:
        spec = json.load(f)
    if spec.get("model", {}).get("type") == "BPE":
        from lean_explore_tpu_torch.models.bpe import ByteLevelBPETokenizer

        return ByteLevelBPETokenizer(spec, **special)
    return WordLevelTokenizer(spec, **special)


def unk_fraction(tokenizer, texts: list[str], max_texts: int = 64) -> float:
    """Fraction of <unk> tokens when ``tokenizer`` encodes a text sample
    (lean_explore_tpu/models/tokenizer.py ``unk_fraction``): the guard
    against evaluating a corpus whose words a WordLevel vocabulary has
    never seen. 0.0 when the tokenizer has no unk id."""
    unk_id = getattr(tokenizer, "unk_token_id", None)
    if unk_id is None or not texts:
        return 0.0
    rows = tokenizer(list(texts[:max_texts]))["input_ids"]
    total = sum(len(r) for r in rows)
    if not total:
        return 0.0
    return sum(1 for r in rows for t in r if t == unk_id) / total


def bucket_length(n: int, max_length: int, buckets=LENGTH_BUCKETS) -> int:
    """Smallest bucket >= n, capped at max_length."""
    for b in buckets:
        if b >= max_length:
            return max_length
        if n <= b:
            return b
    return max_length


def bucket_batch(n: int, buckets=BATCH_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    # Above the largest bucket: round up to a multiple of it.
    top = buckets[-1]
    return ((n + top - 1) // top) * top


@dataclass
class EncodedBatch:
    """Padded token batch; rows >= n_valid are padding-only."""

    input_ids: np.ndarray  # [B_pad, T_pad] int32
    attention_mask: np.ndarray  # [B_pad, T_pad] int32
    n_valid: int


def encode_batch(
    tokenizer,
    texts: list[str],
    *,
    max_length: int,
    pad_to_buckets: bool = True,
    append_eos: bool = False,
) -> EncodedBatch:
    """Tokenize, truncate, and pad to bucketed shapes.

    Args:
        tokenizer: A WordLevelTokenizer (or anything with its call surface).
        texts: Input strings (non-empty list).
        max_length: Hard truncation length.
        pad_to_buckets: Pad (batch, length) up to bucket sizes.
        append_eos: Append the EOS token inside the length budget (Qwen3
            embedding models pool the EOS position).
    """
    enc = tokenizer(
        list(texts),
        truncation=True,
        max_length=max_length - 1 if append_eos else max_length,
        padding=False,
    )
    ids_list = enc["input_ids"]
    if append_eos and tokenizer.eos_token_id is not None:
        ids_list = [row + [tokenizer.eos_token_id] for row in ids_list]

    longest = max(len(row) for row in ids_list)
    target_len = (
        bucket_length(longest, max_length) if pad_to_buckets else longest
    )
    target_len = max(target_len, 1)
    n = len(ids_list)
    target_batch = bucket_batch(n) if pad_to_buckets else n

    pad_id = tokenizer.pad_token_id
    if pad_id is None:
        pad_id = tokenizer.eos_token_id or 0
    input_ids = np.full((target_batch, target_len), pad_id, dtype=np.int32)
    mask = np.zeros((target_batch, target_len), dtype=np.int32)
    for i, row in enumerate(ids_list):
        row = row[:target_len]
        input_ids[i, : len(row)] = row
        mask[i, : len(row)] = 1
    # Pad rows carry a single valid token so masked softmax rows stay benign
    # and pooling indices are in range; their outputs are discarded.
    mask[n:, 0] = 1
    return EncodedBatch(input_ids=input_ids, attention_mask=mask, n_valid=n)
