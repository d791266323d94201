"""Tokenizers for declaration names and natural-language text.

Behavior-compatible with the reference tokenizers
(upstream lean-explore src/lean_explore/search/tokenization.py:11-71); these run
host-side at query time (a handful of strings) and at index-build time.
The Python regex path is the production path everywhere: the C++ lexcore
tokenizer (native.tokenize_spaced_native, parity-tested) is per-call and
measured 1.7x SLOWER on typical short declaration names — ctypes call
overhead dominates — so it stays a tested fallback-capable twin, not a
fast path.

A copy of lean_explore_tpu/search/tokenization.py: the port imports nothing of the
JAX package.
"""

import re

_CAMEL_BOUNDARY = re.compile(r"([a-z])([A-Z])")
_WORD = re.compile(r"\w+")
_DOT_UNDERSCORE = str.maketrans({".": " ", "_": " "})


def tokenize_spaced(text: str) -> list[str]:
    """Split a declaration name on dots, underscores and camelCase boundaries.

    ``"Nat.add_comm"`` -> ``["nat", "add", "comm"]``;
    ``"fooBar"`` -> ``["foo", "bar"]``.
    """
    if not text:
        return []
    spaced = _CAMEL_BOUNDARY.sub(r"\1 \2", text.translate(_DOT_UNDERSCORE))
    return _WORD.findall(spaced.lower())


def tokenize_raw(text: str) -> list[str]:
    """Keep the whole name as one lowercase token (exact-name index)."""
    return [text.lower()] if text else []


def tokenize_words(text: str) -> list[str]:
    """Whitespace/punctuation word split for natural-language text."""
    return [w.lower() for w in _WORD.findall(text)] if text else []


def is_autogenerated(name: str) -> bool:
    """True for Lean auto-generated declarations (``.mk`` constructors)."""
    return name.endswith(".mk")
