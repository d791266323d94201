"""Synthetic Lean-shaped corpus for end-to-end training and quality eval,
the port's copy of lean_explore_tpu/train/synthetic.py: the same concepts,
declarations, eval queries and training examples at the same seeds.

Every concept has a **base word** (declaration names and informalization
bodies) and a disjoint **synonym** (informal titles and eval queries), so
name-BM25 cannot match a synonym query and the synonym -> base alignment is
learned only through training. Eval queries use their own phrasing and
target declarations held out of training.

``build_wordlevel_tokenizer`` writes the ``tokenizer.json`` the JAX module
writes through HuggingFace ``tokenizers``, here without that package: the
same pre-tokenizers (Whitespace, then CharDelimiterSplit on "_"), the same
sorted vocabulary and ids, the same JSON layout.
"""

import itertools
import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from lean_explore_tpu_torch.models.store import Declaration
from lean_explore_tpu_torch.models.search_types import extract_bold_description
from lean_explore_tpu_torch.models.tokenizer import pre_tokenizer

_ROOTS = (
    "Mathlib.Algebra", "Mathlib.Topology", "Mathlib.Order",
    "Mathlib.Analysis", "Mathlib.CategoryTheory", "Mathlib.NumberTheory",
)
_CONSONANTS = "bcdfgklmnprstvz"
_VOWELS = "aeiou"

# Distinct filler templates: bodies (base words), titles and eval queries
# (synonym words). Titles and queries share the synonym vocabulary but not
# their phrasing, so eval is not a memorized-string lookup.
_BODY_TEMPLATE = (
    "A lemma stating that the {b0} of every {b1} preserves {b2} under "
    "composition ."
)
_TITLE_TEMPLATE = "**The {s0} of a {s1} with {s2}.**"
_QUERY_TEMPLATE = "which {s0} of some {s1} keeps {s2}"

# Extra body sentences for ``body_sentences > 1`` (production-length
# documents). Real Mathlib informalizations are ~80-120 words with the
# discriminative bold title leading and the concept words recurring
# through generic mathematical prose; these templates mirror that —
# each repeats the declaration's base words (rotated positions) amid
# filler vocabulary shared by EVERY declaration, so later sentences
# carry some signal but are mostly non-discriminative, like real proofs
# restating their subject amid standard language.
_EXTRA_BODY_TEMPLATES = (
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

# Additional synonym phrasings for TRAINING only (make_paraphrase_pairs).
# Deliberately disjoint from _QUERY_TEMPLATE's function words
# (which/some/keeps) so evaluation still probes unseen phrasing.
_PARAPHRASE_TEMPLATES = (
    "the {s0} over any {s1} having {s2}",
    "a {s0} for every {s1} respecting {s2}",
)


@dataclass(frozen=True)
class Concept:
    base: str
    synonym: str


@dataclass
class SyntheticCorpus:
    declarations: list[Declaration]
    concepts: list[Concept]
    # (query text, target declaration name); targets are all in the
    # held-out tail [n_train, n) of `declarations`.
    eval_queries: list[tuple[str, str]]
    n_train: int
    # Concept-index triple per declaration (aligned with `declarations`);
    # the overlap structure drives hard-negative mining for the reranker.
    triples: list[tuple[int, int, int]] | None = None

    def texts(self) -> list[str]:
        """Every text the tokenizer must cover (docs, names, queries)."""
        out = []
        for d in self.declarations:
            out.append(d.informalization)
            out.append(d.name)
        out.extend(q for q, _ in self.eval_queries)
        return out


def _word(rng: np.random.Generator, syllables: int) -> str:
    return "".join(
        _CONSONANTS[rng.integers(len(_CONSONANTS))]
        + _VOWELS[rng.integers(len(_VOWELS))]
        for _ in range(syllables)
    )


def make_concepts(n: int, rng: np.random.Generator) -> list[Concept]:
    """n concepts with globally unique, non-overlapping base/synonym words."""
    seen: set[str] = set()
    concepts: list[Concept] = []
    while len(concepts) < n:
        base = _word(rng, 3)
        syn = _word(rng, 4)
        if base in seen or syn in seen or base == syn:
            continue
        seen.add(base)
        seen.add(syn)
        concepts.append(Concept(base, syn))
    return concepts


def make_corpus(
    *,
    n_decls: int = 2000,
    n_concepts: int = 240,
    n_eval: int = 256,
    holdout_fraction: float = 0.2,
    seed: int = 0,
    body_sentences: int = 1,
) -> SyntheticCorpus:
    """Build the corpus, its concept vocabulary, and held-out eval queries.

    ``body_sentences`` > 1 appends extra body prose per declaration
    (_EXTRA_BODY_TEMPLATES, cycled with base-word positions rotated by
    the template index), producing production-length documents (~110
    words median at 5 sentences — the committed runs/longdoc regime — vs
    the default ~22) with the discriminative title still leading: the
    regime the rerank-cascade prescreen and production throughput rows
    are measured in (docs/performance.md). Because the rotation is tied
    to the template index modulo the 6-template pool, each template
    always carries one fixed word arrangement; values above 7 would
    repeat a sentence verbatim within a document and are rejected.
    """
    if body_sentences > len(_EXTRA_BODY_TEMPLATES) + 1:
        raise ValueError(
            f"body_sentences={body_sentences} exceeds the "
            f"{len(_EXTRA_BODY_TEMPLATES)}-template pool + title sentence "
            "(larger values would repeat sentences verbatim)"
        )
    rng = np.random.default_rng(seed)
    concepts = make_concepts(n_concepts, rng)

    triples: list[tuple[int, int, int]] = []
    used: set[frozenset] = set()
    while len(triples) < n_decls:
        pick = tuple(sorted(rng.choice(n_concepts, size=3, replace=False)))
        key = frozenset(pick)
        if key in used:
            continue
        used.add(key)
        triples.append(pick)

    declarations: list[Declaration] = []
    for i, (a, b, c) in enumerate(triples):
        ca, cb, cc = concepts[a], concepts[b], concepts[c]
        root = _ROOTS[i % len(_ROOTS)]
        # Concept triples are unique as sorted sets, so this name is unique
        # without a numeric suffix (which would bloat the tokenizer with one
        # token per declaration).
        name = f"{root}.{ca.base}_{cb.base}.of_{cc.base}"
        title = _TITLE_TEMPLATE.format(s0=ca.synonym, s1=cb.synonym, s2=cc.synonym)
        body = _BODY_TEMPLATE.format(b0=ca.base, b1=cb.base, b2=cc.base)
        if body_sentences > 1:
            bases = (ca.base, cb.base, cc.base)
            extra = []
            for s in range(body_sentences - 1):
                tpl = _EXTRA_BODY_TEMPLATES[(i + s) % len(_EXTRA_BODY_TEMPLATES)]
                r = (i + s) % 3  # rotate which base word sits where
                extra.append(
                    tpl.format(
                        b0=bases[r], b1=bases[(r + 1) % 3], b2=bases[(r + 2) % 3]
                    )
                )
            body = " ".join([body, *extra])
        declarations.append(
            Declaration(
                name=name,
                module=f"{root}.Basic",
                source_text=f"theorem {name} : ∀ x, {ca.base} x = {cb.base} x",
                source_link=f"https://github.com/example/mathlib/{i}",
                dependencies=None,
                informalization=f"{title} {body}",
                informalization_embedding=None,
            )
        )

    n_train = int(n_decls * (1.0 - holdout_fraction))
    holdout = list(range(n_train, n_decls))
    picks = rng.choice(len(holdout), size=min(n_eval, len(holdout)), replace=False)
    eval_queries = []
    for p in picks:
        i = holdout[int(p)]
        a, b, c = triples[i]
        query = _QUERY_TEMPLATE.format(
            s0=concepts[a].synonym, s1=concepts[b].synonym, s2=concepts[c].synonym
        )
        eval_queries.append((query, declarations[i].name))

    return SyntheticCorpus(
        declarations=declarations,
        concepts=concepts,
        eval_queries=eval_queries,
        n_train=n_train,
        triples=triples,
    )


def reranker_document(decl: Declaration) -> str:
    """The document string the engine feeds the cross-encoder
    (search/engine.py search_batch: ``"{name}: {informalization}"``)."""
    return (
        f"{decl.name}: {decl.informalization}"
        if decl.informalization
        else decl.name
    )


def _typo(name: str, rng: np.random.Generator) -> str:
    """Substitute one in-word character, never the dots/underscores."""
    alphabet = _CONSONANTS + _VOWELS
    positions = [j for j, ch in enumerate(name) if ch in alphabet]
    j = positions[int(rng.integers(len(positions)))]
    repl = alphabet[int(rng.integers(len(alphabet)))]
    while repl == name[j]:
        repl = alphabet[int(rng.integers(len(alphabet)))]
    return name[:j] + repl + name[j + 1 :]


def make_reranker_examples(
    corpus: SyntheticCorpus,
    rng: np.random.Generator,
    *,
    name_variants: bool = True,
    variant_fraction: float = 0.25,
) -> list[tuple[str, str, int]]:
    """Labeled (query, document, match?) triples for cross-encoder training.

    Per train-split declaration, for each of its query forms — spaced
    name + informal title (the forms train/data.pairs_from_store uses for
    the embedder), plus, with ``name_variants``, a spaced word fragment
    and a single-char-typo name for ``variant_fraction`` of the
    declarations (the round-4 query-class eval measured the
    fragment/typo rank-1 cost of training without them; making the
    variants UNIVERSAL measurably starved the hard semantic form —
    direct recall collapsed 0.98 -> 0.51 at fixed steps — so they are
    diluted, not everywhere) — the loader gets:

    - the matching document (label 1),
    - a HARD negative sharing 2 of its 3 concepts (label 0) — at serving
      time the reranker discriminates among the dense top-50, which are
      precisely the near-misses sharing most concepts; easy negatives
      alone would teach only "any synonym overlap",
    - a random negative (label 0).
    """
    if corpus.triples is None:
        raise ValueError("corpus built without triples")
    n_train = corpus.n_train
    # concept-pair -> train declaration indices containing that pair
    pair_to_decls: dict[frozenset, list[int]] = {}
    for i in range(n_train):
        a, b, c = corpus.triples[i]
        for pair in (frozenset((a, b)), frozenset((a, c)), frozenset((b, c))):
            pair_to_decls.setdefault(pair, []).append(i)

    examples: list[tuple[str, str, int]] = []
    for i in range(n_train):
        decl = corpus.declarations[i]
        a, b, c = corpus.triples[i]
        queries = [decl.name]
        title = extract_bold_description(decl.informalization or "")
        if title:
            queries.append(title)
        if name_variants and rng.random() < variant_fraction:
            queries.append(
                " ".join(
                    (
                        corpus.concepts[a].base,
                        corpus.concepts[b].base,
                        corpus.concepts[c].base,
                    )
                )
            )
            queries.append(_typo(decl.name, rng))

        hard_candidates = [
            j
            for pair in (
                frozenset((a, b)), frozenset((a, c)), frozenset((b, c))
            )
            for j in pair_to_decls.get(pair, ())
            if j != i
        ]
        positive_doc = reranker_document(decl)
        for q in queries:
            examples.append((q, positive_doc, 1))
            if hard_candidates:
                j = hard_candidates[rng.integers(len(hard_candidates))]
            else:
                j = int(rng.integers(n_train))
                if j == i:  # fallback must not mislabel the positive
                    j = (j + 1) % n_train
            examples.append((q, reranker_document(corpus.declarations[j]), 0))
            k = int(rng.integers(n_train))
            if k == i:
                k = (k + 1) % n_train
            examples.append((q, reranker_document(corpus.declarations[k]), 0))
    return examples


def make_paraphrase_pairs(
    corpus: SyntheticCorpus,
) -> list[tuple[str, str]]:
    """(paraphrased query, document) training pairs over the train split.

    The informal titles expose each synonym in exactly ONE phrasing, so a
    model trained on (title, doc) pairs alone cannot learn phrasing
    invariance — measured round 4: held-out template queries capped dense
    recall@10 at ~0.6 while train accuracy saturated. These pairs restate
    each train declaration's synonyms in _PARAPHRASE_TEMPLATES (function
    words disjoint from the eval template), teaching that the phrasing
    varies and the synonyms carry the meaning.
    """
    if corpus.triples is None:
        raise ValueError("corpus built without triples")
    pairs: list[tuple[str, str]] = []
    for i in range(corpus.n_train):
        decl = corpus.declarations[i]
        a, b, c = corpus.triples[i]
        syn = (
            corpus.concepts[a].synonym,
            corpus.concepts[b].synonym,
            corpus.concepts[c].synonym,
        )
        for tpl in _PARAPHRASE_TEMPLATES:
            pairs.append(
                (tpl.format(s0=syn[0], s1=syn[1], s2=syn[2]),
                 decl.informalization)
            )
    return pairs


def make_name_queries(
    corpus: SyntheticCorpus,
    rng: np.random.Generator,
    *,
    n_per_class: int = 128,
) -> dict[str, list[tuple[str, str]]]:
    """Name-style labeled queries — the reference's headline use case.

    The reference's primary documented query class is declaration-name
    search ('List.map', reference README.md:24), served by the two name
    BM25 indices (engine.py:192-223) plus the fuzzy-name boost
    (scoring.py:141-156). The synonym-phrased eval_queries by design carry
    ZERO name-token signal, so they cannot exercise that path; these three
    classes do:

    - ``name_exact``: the full dotted name verbatim (raw-index regime).
    - ``name_fragment``: the base words spaced out, like a user typing
      "List map" (spaced-index regime).
    - ``name_typo``: the full name with one character substituted — the
      raw index misses, the spaced index keeps 2 of 3 base words, and the
      fuzzy boost (difflib ratio >= 0.7 adds +1.0 in the final fusion)
      should recover rank 1.

    Targets are drawn from the held-out tail, mirroring eval_queries.
    """
    if corpus.triples is None:
        raise ValueError("corpus built without triples")
    n = len(corpus.declarations)
    holdout = list(range(corpus.n_train, n))
    picks = rng.choice(
        len(holdout), size=min(3 * n_per_class, len(holdout)), replace=False
    )
    classes: dict[str, list[tuple[str, str]]] = {
        "name_exact": [], "name_fragment": [], "name_typo": [],
    }
    for slot, p in enumerate(picks):
        i = holdout[int(p)]
        decl = corpus.declarations[i]
        a, b, c = corpus.triples[i]
        if slot % 3 == 0:
            classes["name_exact"].append((decl.name, decl.name))
        elif slot % 3 == 1:
            frag = " ".join(
                (corpus.concepts[a].base, corpus.concepts[b].base,
                 corpus.concepts[c].base)
            )
            classes["name_fragment"].append((frag, decl.name))
        else:
            # Substitute one character inside a base word (never the dots
            # or underscores, so tokenization still splits identically).
            classes["name_typo"].append((_typo(decl.name, rng), decl.name))
    return classes


def build_wordlevel_tokenizer(
    texts: list[str], out_dir: str | Path, *, extra_texts: tuple[str, ...] = ()
) -> Path:
    """Write a WordLevel HF tokenizer covering every token in `texts`.

    The checkpoint layout load_tokenizer expects (tokenizer.json +
    tokenizer_config.json), byte for byte what HuggingFace ``tokenizers``
    saves for the same model. Vocabulary order is deterministic (sorted).
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    # Whitespace keeps snake_case compounds whole; splitting on "_" too
    # gives subword-style sharing between declaration names and prose (and
    # keeps the vocabulary at O(concepts), not O(declarations)).
    pre_spec = {
        "type": "Sequence",
        "pretokenizers": [
            {"type": "Whitespace"},
            {"type": "CharDelimiterSplit", "delimiter": "_"},
        ],
    }
    pre = pre_tokenizer(pre_spec)
    tokens: set[str] = set()
    for text in itertools.chain(texts, extra_texts):
        tokens.update(pre([text]))

    vocab = {"<pad>": 0, "<unk>": 1, "<eos>": 2}
    for tok in sorted(tokens):
        vocab.setdefault(tok, len(vocab))

    spec = {
        "version": "1.0",
        "truncation": None,
        "padding": None,
        "added_tokens": [],
        "normalizer": None,
        "pre_tokenizer": pre_spec,
        "post_processor": None,
        "decoder": None,
        "model": {"type": "WordLevel", "vocab": vocab, "unk_token": "<unk>"},
    }
    (out_dir / "tokenizer.json").write_text(
        json.dumps(spec, indent=2, ensure_ascii=False), encoding="utf-8"
    )
    (out_dir / "tokenizer_config.json").write_text(
        json.dumps(
            {
                "tokenizer_class": "PreTrainedTokenizerFast",
                "pad_token": "<pad>",
                "eos_token": "<eos>",
                "unk_token": "<unk>",
                "model_max_length": 512,
            }
        )
    )
    return out_dir
