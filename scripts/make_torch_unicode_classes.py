"""Write lean_explore_tpu_torch/models/unicode_classes.py from HuggingFace
``tokenizers``.

The port's tokenizers match text with Python's ``re``, whose ``\\w``,
``\\s`` and Unicode categories are not those of the Oniguruma engine that
``tokenizers`` runs: subscript digits are word characters for Python and
not for Oniguruma, combining marks the other way round. So the classes
the port's patterns use are taken from ``tokenizers`` itself, over every
code point 0-0x10FFFF but the surrogates, and committed as (start, end)
ranges:

- ``\\w`` and ``\\s`` through the ``Whitespace`` pre-tokenizer
  (``\\w+|[^\\w\\s]+``);
- ``\\p{L}`` and ``\\p{N}`` through ``Split(Regex(...), "removed")``.

    python scripts/make_torch_unicode_classes.py [--check]

``--check`` exits 1 when the committed module differs from a fresh
derivation instead of writing it.
"""

import argparse
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "lean_explore_tpu_torch" / "models" / "unicode_classes.py"
SURROGATES = range(0xD800, 0xE000)
# Code points per pre-tokenizer call: a few calls, each on a string of a
# few million characters.
CHUNK = 1 << 17


def code_points() -> np.ndarray:
    cps = np.arange(0x110000, dtype=np.int64)
    return cps[(cps < SURROGATES.start) | (cps >= SURROGATES.stop)]


def whitespace_classes(cps: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(is_word, is_space) of each code point, read from ``Whitespace``.

    Each code point c stands in a group "a" c " " at offset 3i: a word
    character joins "a" in one piece (0, 2); a character that is neither
    word nor space starts a piece of its own at 1; a space leaves "a"
    alone.
    """
    from tokenizers.pre_tokenizers import Whitespace

    pre = Whitespace()
    word = np.zeros(len(cps), bool)
    other = np.zeros(len(cps), bool)
    for lo in range(0, len(cps), CHUNK):
        chunk = cps[lo : lo + CHUNK]
        text = "".join(f"a{chr(c)} " for c in chunk)
        for _, (start, end) in pre.pre_tokenize_str(text):
            group, at = divmod(start, 3)
            if at == 0 and end - start == 2:
                word[lo + group] = True
            elif at == 1:
                other[lo + group] = True
    return word, ~(word | other)


def regex_class(cps: np.ndarray, pattern: str) -> np.ndarray:
    """Whether each code point matches ``pattern`` (one character), read
    from ``Split(Regex(pattern), "removed")``: the pieces left are exactly
    the characters it does not match."""
    from tokenizers import Regex
    from tokenizers.pre_tokenizers import Split

    pre = Split(Regex(pattern), "removed")
    kept = np.zeros(len(cps), bool)
    for lo in range(0, len(cps), CHUNK):
        chunk = cps[lo : lo + CHUNK]
        text = "".join(chr(c) for c in chunk)
        for _, (start, end) in pre.pre_tokenize_str(text):
            kept[lo + start : lo + end] = True
    return ~kept


def to_ranges(cps: np.ndarray, member: np.ndarray) -> list[tuple[int, int]]:
    """Inclusive (start, end) runs of the member code points."""
    ranges: list[tuple[int, int]] = []
    for c in cps[member].tolist():
        if ranges and ranges[-1][1] == c - 1:
            ranges[-1] = (ranges[-1][0], c)
        else:
            ranges.append((c, c))
    return ranges


def derive() -> dict[str, list[tuple[int, int]]]:
    cps = code_points()
    word, space = whitespace_classes(cps)
    return {
        "WORD": to_ranges(cps, word),
        "SPACE": to_ranges(cps, space),
        "LETTER": to_ranges(cps, regex_class(cps, r"\p{L}")),
        "NUMBER": to_ranges(cps, regex_class(cps, r"\p{N}")),
    }


def render(classes: dict[str, list[tuple[int, int]]], version: str) -> str:
    lines = [
        '"""Character classes of HuggingFace tokenizers\' Oniguruma regexes,',
        "as (start, end) code point ranges, both ends included.",
        "",
        "Generated by scripts/make_torch_unicode_classes.py from tokenizers",
        f"{version}; do not edit. ``WORD`` is ``\\\\w``, ``SPACE`` ``\\\\s``,",
        "``LETTER`` ``\\\\p{L}`` and ``NUMBER`` ``\\\\p{N}``. Python's ``re``",
        "and ``unicodedata`` disagree with these on about 1,700 code points",
        "(subscripts and superscripts, combining marks, ``\\\\x1c``-``\\\\x1f``),",
        "so ``char_class`` builds the port's patterns from them.",
        '"""',
        "",
        f'TOKENIZERS_VERSION = "{version}"',
        "",
    ]
    for name, ranges in classes.items():
        lines.append(f"{name} = (")
        row = "   "
        for start, end in ranges:
            item = f" (0x{start:X}, 0x{end:X}),"
            if len(row) + len(item) > 79:
                lines.append(row)
                row = "   "
            row += item
        if row.strip():
            lines.append(row)
        lines.append(")")
        lines.append("")
    lines += [
        "",
        "def char_class(*classes, negate: bool = False, bmp: bool = False) -> str:",
        '    """A ``re`` character class, ``[...]`` or ``[^...]``, over the union',
        "    of the given range tuples. With ``bmp`` only the ranges below",
        "    0x10000 are written: ``re`` tests such a class against a bitmap,",
        "    and one with astral ranges range by range, about ten times slower;",
        '    the class is then right only on text without astral characters."""',
        "    parts = []",
        "    for ranges in classes:",
        "        for start, end in ranges:",
        "            if bmp and start > 0xFFFF:",
        "                continue",
        "            if bmp:",
        "                end = min(end, 0xFFFF)",
        "            part = f\"\\\\U{start:08x}\"",
        "            if end != start:",
        "                part += f\"-\\\\U{end:08x}\"",
        "            parts.append(part)",
        "    return (\"[^\" if negate else \"[\") + \"\".join(parts) + \"]\"",
        "",
    ]
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", action="store_true")
    args = parser.parse_args(argv)
    import tokenizers

    text = render(derive(), tokenizers.__version__)
    if args.check:
        same = OUT.read_text() == text
        print("unicode_classes.py is", "current" if same else "stale")
        return 0 if same else 1
    OUT.write_text(text)
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
