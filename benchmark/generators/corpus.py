"""Synthetic Lean-shaped corpus, its WordLevel vocabulary and the query mix.

A frozen copy, vectorised with NumPy where it can be, of
``lean_explore_tpu_torch/train/synthetic.py`` at commit 4369825
(``make_concepts``, ``make_corpus``, ``make_name_queries``, ``_typo`` and
``build_wordlevel_tokenizer``): the same templates, the same name and
informalization shapes, ``body_sentences`` extra body prose per declaration
(5 gives the production-length documents, about 110 words). It differs
from the source in three ways, none of which changes a document's shape:

- concept words, triples and query targets are drawn in whole arrays, so a
  seed gives another corpus than the source's at that seed;
- every declaration gets a few dependencies from the seed, on declarations
  that share its first concept, so the dependency boost has work to do;
- the vocabulary is built from the templates and the concept words rather
  than by scanning every text (the same tokens, in a fraction of the time).

Nothing here imports the program: the benchmark hands what this module
makes to the program and to the plain reference alike.
"""

import json
import re
from dataclasses import dataclass

import numpy as np

ROOTS = (
    "Mathlib.Algebra", "Mathlib.Topology", "Mathlib.Order",
    "Mathlib.Analysis", "Mathlib.CategoryTheory", "Mathlib.NumberTheory",
)
CONSONANTS = "bcdfgklmnprstvz"
VOWELS = "aeiou"

BODY_TEMPLATE = (
    "A lemma stating that the {b0} of every {b1} preserves {b2} under "
    "composition ."
)
TITLE_TEMPLATE = "**The {s0} of a {s1} with {s2}.**"
QUERY_TEMPLATE = "which {s0} of some {s1} keeps {s2}"
EXTRA_BODY_TEMPLATES = (
    "Moreover the hypothesis requires that each {b1} admits a canonical "
    "{b0} whose image factors through the {b2} in the evident way .",
    "The proof proceeds by induction over the structure of the {b2} , "
    "reducing the general case to the {b0} of a single {b1} .",
    "As a consequence every morphism compatible with the {b0} descends "
    "to the quotient and the {b1} inherits the {b2} canonically .",
    "This generalizes the classical statement in which the {b2} is "
    "trivial and the {b0} agrees with the identity on each {b1} .",
    "Under the additional assumption that the {b1} is finite , the "
    "{b2} commutes with arbitrary limits taken along the {b0} .",
    "See also the dual statement , obtained by replacing the {b0} with "
    "its opposite and the {b2} with the corresponding {b1} structure .",
)

QUERY_CLASSES = ("semantic", "name_exact", "name_fragment", "name_typo")

# HuggingFace's Whitespace pre-tokenizer on ASCII text, then the split on
# "_" of the source's tokenizer (CharDelimiterSplit).
_WHITESPACE = re.compile(r"\w+|[^\w\s]+")


def pre_tokenize(text: str) -> list[str]:
    return [p for m in _WHITESPACE.findall(text) for p in m.split("_") if p]


def _words(rng: np.random.Generator, n: int, syllables: int) -> list[str]:
    c = rng.integers(len(CONSONANTS), size=(n, syllables))
    v = rng.integers(len(VOWELS), size=(n, syllables))
    return [
        "".join(CONSONANTS[a] + VOWELS[b] for a, b in zip(cr, vr))
        for cr, vr in zip(c.tolist(), v.tolist())
    ]


def make_concepts(n: int, rng: np.random.Generator) -> tuple[list[str], list[str]]:
    """n base words (3 syllables) and n synonyms (4 syllables), all distinct."""
    bases: list[str] = []
    synonyms: list[str] = []
    seen: set[str] = set()
    while len(bases) < n:
        for base, syn in zip(_words(rng, 2 * n, 3), _words(rng, 2 * n, 4)):
            if base in seen or syn in seen:
                continue
            seen.update((base, syn))
            bases.append(base)
            synonyms.append(syn)
            if len(bases) == n:
                break
    return bases, synonyms


@dataclass
class Corpus:
    names: list[str]
    modules: list[str]
    informalizations: list[str]
    source_texts: list[str]
    source_links: list[str]
    dependencies: list[str | None]  # JSON list of names, or None
    triples: np.ndarray  # [N, 3] concept indices
    bases: list[str]
    synonyms: list[str]

    def __len__(self) -> int:
        return len(self.names)

    def document(self, i: int) -> str:
        """The text the engine hands the cross-encoder for row i."""
        return f"{self.names[i]}: {self.informalizations[i]}"


def make_corpus(
    *, n_decls: int, n_concepts: int, body_sentences: int, max_deps: int, seed: int
) -> Corpus:
    if body_sentences > len(EXTRA_BODY_TEMPLATES) + 1:
        raise ValueError(f"body_sentences={body_sentences} repeats a sentence")
    rng = np.random.default_rng(seed)
    bases, synonyms = make_concepts(n_concepts, rng)

    # Unique concept triples as sorted sets, in the order first drawn.
    triples = np.zeros((0, 3), dtype=np.int64)
    while len(triples) < n_decls:
        draw = np.sort(rng.integers(n_concepts, size=(n_decls + n_decls // 8 + 64, 3)), axis=1)
        draw = draw[(draw[:, 0] < draw[:, 1]) & (draw[:, 1] < draw[:, 2])]
        both = np.concatenate([triples, draw])
        keys = (both[:, 0] * n_concepts + both[:, 1]) * n_concepts + both[:, 2]
        _, first = np.unique(keys, return_index=True)
        triples = both[np.sort(first)]
    triples = triples[:n_decls]

    names, modules, informal, sources, links = [], [], [], [], []
    n_extra = len(EXTRA_BODY_TEMPLATES)
    for i, (a, b, c) in enumerate(triples.tolist()):
        root = ROOTS[i % len(ROOTS)]
        ba, bb, bc = bases[a], bases[b], bases[c]
        name = f"{root}.{ba}_{bb}.of_{bc}"
        title = TITLE_TEMPLATE.format(s0=synonyms[a], s1=synonyms[b], s2=synonyms[c])
        parts = [title, BODY_TEMPLATE.format(b0=ba, b1=bb, b2=bc)]
        three = (ba, bb, bc)
        for s in range(body_sentences - 1):
            r = (i + s) % 3
            parts.append(EXTRA_BODY_TEMPLATES[(i + s) % n_extra].format(
                b0=three[r], b1=three[(r + 1) % 3], b2=three[(r + 2) % 3]
            ))
        names.append(name)
        modules.append(f"{root}.Basic")
        informal.append(" ".join(parts))
        sources.append(f"theorem {name} : ∀ x, {ba} x = {bb} x")
        links.append(f"https://github.com/example/mathlib/{i}")

    # Dependencies: each declaration on the next 0..max_deps declarations
    # that share its first concept (in the order of that concept).
    order = np.argsort(triples[:, 0], kind="stable")
    counts = rng.integers(0, max_deps + 1, size=n_decls)
    position = np.empty(n_decls, dtype=np.int64)
    position[order] = np.arange(n_decls)
    first = triples[:, 0]
    deps: list[str | None] = []
    for i in range(n_decls):
        p = int(position[i])
        picked = []
        for q in range(p + 1, min(p + 1 + int(counts[i]), n_decls)):
            j = int(order[q])
            if first[j] != first[i]:
                break
            picked.append(names[j])
        deps.append(json.dumps(picked) if picked else None)
    return Corpus(names, modules, informal, sources, links, deps, triples, bases, synonyms)


def typo(name: str, rng: np.random.Generator) -> str:
    """One in-word character substituted, never a dot or an underscore."""
    alphabet = CONSONANTS + VOWELS
    positions = [j for j, ch in enumerate(name) if ch in alphabet]
    j = positions[int(rng.integers(len(positions)))]
    repl = alphabet[int(rng.integers(len(alphabet)))]
    while repl == name[j]:
        repl = alphabet[int(rng.integers(len(alphabet)))]
    return name[:j] + repl + name[j + 1:]


def make_queries(
    corpus: Corpus, mix: dict[str, int], n: int, seed: int
) -> list[tuple[str, str, int]]:
    """n (query, class, target row) triples. The classes come in the exact
    proportions of ``mix`` (class -> weight) and are shuffled from the
    seed, so every seed sends the same amount of each class."""
    rng = np.random.default_rng([seed, 1])
    total = sum(mix.values())
    classes: list[str] = []
    for cls in QUERY_CLASSES:
        classes += [cls] * (n * mix.get(cls, 0) // total)
    classes += [QUERY_CLASSES[0]] * (n - len(classes))
    order = rng.permutation(n)
    targets = rng.integers(len(corpus), size=n)
    out = []
    for slot in order.tolist():
        cls, i = classes[slot], int(targets[slot])
        a, b, c = corpus.triples[i].tolist()
        if cls == "semantic":
            text = QUERY_TEMPLATE.format(
                s0=corpus.synonyms[a], s1=corpus.synonyms[b], s2=corpus.synonyms[c]
            )
        elif cls == "name_exact":
            text = corpus.names[i]
        elif cls == "name_fragment":
            text = " ".join((corpus.bases[a], corpus.bases[b], corpus.bases[c]))
        else:
            text = typo(corpus.names[i], rng)
        out.append((text, cls, i))
    return out


def vocabulary(corpus: Corpus, extra_texts: tuple[str, ...]) -> dict[str, int]:
    """The WordLevel vocabulary: every token of the templates, the names'
    roots, the concept words and ``extra_texts`` (prompts, the reranker's
    pair template, "true"/"false"), sorted, after <pad>, <unk>, <eos>."""
    texts = [BODY_TEMPLATE, TITLE_TEMPLATE, QUERY_TEMPLATE, *EXTRA_BODY_TEMPLATES,
             *ROOTS, "Basic of", *extra_texts]
    tokens: set[str] = set()
    for text in texts:
        tokens.update(pre_tokenize(re.sub(r"\{\w+\}", " ", text)))
    tokens.update(corpus.bases)
    tokens.update(corpus.synonyms)
    vocab = {"<pad>": 0, "<unk>": 1, "<eos>": 2}
    for tok in sorted(tokens):
        vocab.setdefault(tok, len(vocab))
    return vocab


def tokenizer_json(vocab: dict[str, int]) -> dict:
    """The ``tokenizer.json`` of the source's ``build_wordlevel_tokenizer``."""
    return {
        "version": "1.0",
        "truncation": None,
        "padding": None,
        "added_tokens": [],
        "normalizer": None,
        "pre_tokenizer": {
            "type": "Sequence",
            "pretokenizers": [
                {"type": "Whitespace"},
                {"type": "CharDelimiterSplit", "delimiter": "_"},
            ],
        },
        "post_processor": None,
        "decoder": None,
        "model": {"type": "WordLevel", "vocab": vocab, "unk_token": "<unk>"},
    }
