"""A pure-Python reader of a byte-level BPE ``tokenizer.json``: the kind
Qwen2/Qwen3 (and GPT-2) publish, held to HuggingFace ``tokenizers``.

What it reads, as ``tokenizers`` applies it:

- added tokens (special or not), matched leftmost-longest in the raw text
  (``normalized: false``) or in each normalized piece (``normalized:
  true``), with their ``single_word``, ``lstrip`` and ``rstrip`` flags;
- an ``NFC`` normalizer, or none;
- the pre-tokenizer ``Sequence[Split(Regex, "Isolated"), ByteLevel(
  use_regex=false)]`` (Qwen) or ``ByteLevel(use_regex=true)`` (GPT-2), with
  ``add_prefix_space``; the Oniguruma patterns are rewritten for ``re`` with
  HuggingFace's own character classes (``unicode_classes``);
- a ``BPE`` model with ranked merges (``"a b"`` strings or ``["a", "b"]``
  pairs), ``ignore_merges`` and an optional unk token, with a per-word
  merge cache;
- a ``ByteLevel`` post-processor (adds nothing) and decoder.

Anything else raises by name: another normalizer or pre-tokenizer, a
``TemplateProcessing`` (or other) post-processor, BPE ``dropout``,
``byte_fallback``, ``continuing_subword_prefix`` or ``end_of_word_suffix``.
"""

import bisect
import json
import re
import unicodedata
from pathlib import Path

from lean_explore_tpu_torch.models.tokenizer import UnicodePattern
from lean_explore_tpu_torch.models.unicode_classes import LETTER, NUMBER, SPACE, WORD

# GPT-2's split, which tokenizers' ByteLevel(use_regex=true) runs.
GPT2_PATTERN = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
# tokenizers' word cache holds this many words and then stops adding.
CACHE_CAPACITY = 10_000


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's map of each byte to a printable character."""
    keep = [*range(ord("!"), ord("~") + 1), *range(ord("¡"), ord("¬") + 1),
            *range(ord("®"), ord("ÿ") + 1)]
    chars, extra = {}, 0
    for b in range(256):
        if b in keep:
            chars[b] = chr(b)
        else:
            chars[b] = chr(256 + extra)
            extra += 1
    return chars


BYTE_CHARS = bytes_to_unicode()
CHAR_BYTES = {c: b for b, c in BYTE_CHARS.items()}
# str.translate of a word's UTF-8 bytes read as Latin-1: the byte map in C.
_BYTE_TABLE = {b: c for b, c in BYTE_CHARS.items()}


def byte_level(word: str) -> str:
    """A word's UTF-8 bytes as GPT-2's printable characters."""
    return word.encode("utf-8").decode("latin-1").translate(_BYTE_TABLE)
_CLASSES = {"L": LETTER, "N": NUMBER}


def translate_pattern(pattern: str, cc) -> str:
    """An Oniguruma pattern as a ``re`` pattern: ``\\p{L}``, ``\\p{N}``,
    ``\\s`` and ``\\S`` become HuggingFace's classes (``cc`` is
    ``char_class`` or its BMP form), inside or outside a bracket. Other
    class escapes (``\\w``, ``\\d``, other properties) raise."""
    out, i, in_class = [], 0, False
    while i < len(pattern):
        c = pattern[i]
        if c == "\\":
            nxt = pattern[i + 1]
            if nxt == "p":
                end = pattern.index("}", i)
                name = pattern[i + 3 : end]
                if name not in _CLASSES:
                    raise ValueError(f"unsupported class \\p{{{name}}} in {pattern!r}")
                cls = cc(_CLASSES[name])
                out.append(cls[1:-1] if in_class else cls)
                i = end + 1
                continue
            if nxt in "sS":
                if in_class and nxt == "S":
                    raise ValueError(f"\\S inside a class in {pattern!r}")
                cls = cc(SPACE, negate=nxt == "S")
                out.append(cls[1:-1] if in_class else cls)
                i += 2
                continue
            if nxt in "wWdDbBhH":
                raise ValueError(f"unsupported escape \\{nxt} in {pattern!r}")
            out.append(pattern[i : i + 2])
            i += 2
            continue
        if c == "[" and not in_class:
            in_class = True
        elif c == "]" and in_class:
            in_class = False
        out.append(c)
        i += 1
    return "".join(out)


def _isolated(pattern: str, build):
    """tokenizers' Split(..., "Isolated") on ``pattern``, as ``re`` reads it
    (``build(cc)``): each match a piece, and each stretch between matches a
    piece, through ``re.split`` on the pattern as one group. A pattern that
    can match the empty string or has groups of its own raises."""
    grouped = UnicodePattern(lambda cc: f"({build(cc)})")
    probe = grouped.pattern("")
    if probe.groups != 1 or probe.match("") is not None:
        raise ValueError(f"unsupported Split pattern {pattern!r}: it matches the empty "
                         "string or has groups")
    return lambda piece: [part for part in grouped.pattern(piece).split(piece) if part]


def _split_step(spec: dict):
    if spec.get("invert"):
        raise ValueError("unsupported Split pre-tokenizer with invert")
    if spec.get("behavior") != "Isolated":
        raise ValueError(f"unsupported Split behavior {spec.get('behavior')!r}")
    pattern = spec["pattern"]
    if "Regex" in pattern:
        regex = pattern["Regex"]
        return _isolated(regex, lambda cc: translate_pattern(regex, cc))
    literal = re.escape(pattern["String"])
    return _isolated(pattern["String"], lambda cc: literal)


def _byte_level_step(spec: dict):
    """ByteLevel's split (its prefix space and GPT-2's regex, if used). The
    byte map itself is left to the reader's word cache (``byte_level``)."""
    regex = (
        _isolated(GPT2_PATTERN, lambda cc: translate_pattern(GPT2_PATTERN, cc))
        if spec.get("use_regex", True)
        else None
    )
    prefix = spec.get("add_prefix_space", False)

    def split(piece: str) -> list[str]:
        if prefix and not piece.startswith(" "):
            piece = " " + piece
        return regex(piece) if regex else [piece]

    return split


def byte_level_pre_tokenizer(spec: dict | None):
    """The pre-tokenizer of a byte-level ``tokenizer.json``, as a function
    from one normalized piece to its words, before the byte map. Exactly
    one ByteLevel step, last, after any Split steps."""
    steps = spec.get("pretokenizers", []) if spec and spec.get("type") == "Sequence" else [spec]
    funcs, kinds = [], []
    for step in steps:
        kind = step.get("type") if step else None
        if kind == "Split":
            funcs.append(_split_step(step))
        elif kind == "ByteLevel":
            funcs.append(_byte_level_step(step))
        else:
            raise ValueError(f"unsupported pre-tokenizer {kind!r} for a byte-level BPE")
        kinds.append(kind)
    if kinds.count("ByteLevel") != 1 or kinds[-1] != "ByteLevel":
        raise ValueError(f"unsupported pre-tokenizer sequence {kinds}: ByteLevel must come last")

    def run(piece: str) -> list[str]:
        pieces = [piece]
        for func in funcs:
            pieces = [w for p in pieces for w in func(p)]
        return pieces

    return run


def _normalizer(spec: dict | None):
    if spec is None:
        return lambda text: text
    kind = spec.get("type")
    if kind == "NFC":
        return lambda text: unicodedata.normalize("NFC", text)
    if kind == "Sequence" and all(n.get("type") == "NFC" for n in spec["normalizers"]):
        return lambda text: unicodedata.normalize("NFC", text)
    raise ValueError(f"unsupported normalizer {kind!r} for a byte-level BPE")


def _member(ranges):
    """Membership of one character in sorted (start, end) ranges."""
    starts = [start for start, _ in ranges]

    def member(char: str) -> bool:
        i = bisect.bisect_right(starts, ord(char)) - 1
        return i >= 0 and ord(char) <= ranges[i][1]

    return member


# tokenizers' word boundary for single_word tokens (a word character next
# to the match) and the spaces lstrip/rstrip take.
_is_word, _is_space = _member(WORD), _member(SPACE)


class _AddedTokens:
    """tokenizers' AddedVocabulary split of one set of tokens (the raw
    ones or the normalized ones): leftmost-longest matches, each kept or
    skipped by ``single_word`` and widened by ``lstrip``/``rstrip``."""

    def __init__(self, tokens: list[dict]):
        self.by_content = {t["content"]: t for t in tokens}
        contents = sorted(self.by_content, key=len, reverse=True)
        self.regex = re.compile("|".join(map(re.escape, contents))) if contents else None

    def split(self, text: str) -> list[tuple[str, int | None]]:
        """(piece, token id or None) in order; an empty text is one piece."""
        if self.regex is None or not text:
            return [(text, None)]
        out, pos = [], 0
        for m in self.regex.finditer(text):
            token = self.by_content[m.group(0)]
            start, stop = m.start(), m.end()
            if token.get("single_word"):
                before = start == 0 or not _is_word(text[start - 1])
                after = stop == len(text) or not _is_word(text[stop])
                if not (before and after):
                    continue
            if token.get("lstrip"):
                while start > pos and _is_space(text[start - 1]):
                    start -= 1
            if token.get("rstrip"):
                while stop < len(text) and _is_space(text[stop]):
                    stop += 1
            if start > pos:
                out.append((text[pos:start], None))
            out.append((text[start:stop], token["id"]))
            pos = stop
        if pos < len(text):
            out.append((text[pos:], None))
        return out


class ByteLevelBPETokenizer:
    """Encoder and decoder for a byte-level BPE ``tokenizer.json``, with the
    call surface of ``WordLevelTokenizer``: ``tokenizer(texts,
    truncation=..., max_length=...)``, ``convert_tokens_to_ids``,
    ``decode`` and the pad/eos/unk ids."""

    def __init__(
        self,
        spec: dict,
        *,
        pad_token: str | None = None,
        eos_token: str | None = None,
        unk_token: str | None = None,
    ):
        model = spec.get("model", {})
        if model.get("type") != "BPE":
            raise ValueError(f"not a BPE model: {model.get('type')!r}")
        if model.get("dropout") not in (None, 0.0):
            raise ValueError("unsupported BPE dropout")
        if model.get("byte_fallback"):
            raise ValueError("unsupported BPE byte_fallback")
        for key in ("continuing_subword_prefix", "end_of_word_suffix"):
            if model.get(key):
                raise ValueError(f"unsupported BPE {key} {model[key]!r}")
        post = spec.get("post_processor")
        if post is not None and post.get("type") != "ByteLevel":
            raise ValueError(
                f"unsupported tokenizer post-processor {post.get('type')!r}: it is not applied"
            )
        decoder = spec.get("decoder")
        if decoder is not None and decoder.get("type") != "ByteLevel":
            raise ValueError(f"unsupported decoder {decoder.get('type')!r} for a byte-level BPE")

        self.vocab: dict[str, int] = dict(model["vocab"])
        merges = [m.split(" ", 1) if isinstance(m, str) else m for m in model.get("merges", [])]
        self._ranks = {(a, b): (rank, self.vocab[a + b]) for rank, (a, b) in enumerate(merges)}
        self._ignore_merges = bool(model.get("ignore_merges"))
        model_unk = model.get("unk_token")
        self._model_unk = self.vocab.get(model_unk) if model_unk else None
        self._fuse_unk = bool(model.get("fuse_unk"))
        self._normalize = _normalizer(spec.get("normalizer"))
        self._pre = byte_level_pre_tokenizer(spec.get("pre_tokenizer"))
        self._byte_decode = decoder is not None
        self._cache: dict[str, list[int]] = {}
        self._bytes_cache: dict[str, bytes] = {}

        added = spec.get("added_tokens", [])
        self._raw_added = _AddedTokens([t for t in added if not t.get("normalized")])
        self._norm_added = _AddedTokens([t for t in added if t.get("normalized")])
        self._added = {t["content"]: t["id"] for t in added}
        self._special_ids = {t["id"] for t in added if t.get("special")}
        self._id_to_token = {i: t for t, i in self.vocab.items()}
        self._id_to_token.update({i: t for t, i in self._added.items()})

        unk_token = unk_token or model_unk
        self.unk_token_id = self.convert_tokens_to_ids(unk_token) if unk_token else None
        self.pad_token_id = self._lookup(pad_token)
        self.eos_token_id = self._lookup(eos_token)

    @classmethod
    def from_file(cls, path: str | Path, **special_tokens) -> "ByteLevelBPETokenizer":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f), **special_tokens)

    def _lookup(self, token: str | None) -> int | None:
        if not token:
            return None
        return self._added.get(token, self.vocab.get(token))

    def _word(self, raw: str) -> list[int]:
        """A pre-tokenized word's ids: its bytes mapped, then the
        lowest-ranked adjacent pair merged first (leftmost among equals),
        until no pair has a merge. Cached by the word before the map."""
        cached = self._cache.get(raw)
        if cached is not None:
            return cached
        word = byte_level(raw)
        if self._ignore_merges and word in self.vocab:
            ids = [self.vocab[word]]
        else:
            symbols: list[str] = []
            unk_run = False
            for c in word:
                if c in self.vocab:
                    symbols.append(c)
                    unk_run = False
                elif self._model_unk is not None:
                    if not (self._fuse_unk and unk_run):
                        symbols.append(None)
                    unk_run = True
            while len(symbols) > 1:
                best, at = None, -1
                for i in range(len(symbols) - 1):
                    a, b = symbols[i], symbols[i + 1]
                    if a is None or b is None:
                        continue
                    rank = self._ranks.get((a, b))
                    if rank is not None and (best is None or rank[0] < best[0]):
                        best, at = rank, i
                if best is None:
                    break
                symbols[at : at + 2] = [symbols[at] + symbols[at + 1]]
            ids = [self._model_unk if s is None else self.vocab[s] for s in symbols]
        if len(self._cache) < CACHE_CAPACITY:
            self._cache[raw] = ids
        return ids

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for raw, raw_id in self._raw_added.split(text):
            if raw_id is not None:
                ids.append(raw_id)
                continue
            for piece, piece_id in self._norm_added.split(self._normalize(raw)):
                if piece_id is not None:
                    ids.append(piece_id)
                elif piece:
                    for word in self._pre(piece):
                        ids.extend(self._word(word))
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
        """HF's call surface. ``add_special_tokens`` changes nothing: no
        post-processor this reader takes adds tokens."""
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
        tid = self._lookup(token)
        return self.unk_token_id if tid is None else tid

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        """tokenizers' decode: each token's bytes through the ByteLevel
        map (a token with a character outside it, such as an added token,
        by its own UTF-8 bytes), joined and read as UTF-8 with
        replacement characters. Without a decoder the tokens are joined by
        spaces."""
        tokens = [
            self._id_to_token[int(i)]
            for i in ids
            if not (skip_special_tokens and int(i) in self._special_ids)
        ]
        if not self._byte_decode:
            return " ".join(tokens)
        return b"".join(map(self._token_bytes, tokens)).decode("utf-8", errors="replace")

    def _token_bytes(self, token: str) -> bytes:
        data = self._bytes_cache.get(token)
        if data is None:
            if all(c in CHAR_BYTES for c in token):
                data = bytes(CHAR_BYTES[c] for c in token)
            else:
                data = token.encode("utf-8")
            self._bytes_cache[token] = data
        return data
