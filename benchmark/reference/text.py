"""Plain text side of the reference: the WordLevel tokenizer, the two
models' input formats, and the final fusion of the hybrid search.

Written from the semantics the configuration states, not from the
program: a WordLevel vocabulary over the Whitespace pre-tokenizer and a
split on "_"; the embedder's query prompt, truncation to max_length - 1
tokens and an appended end-of-sequence token, pooled at that token; the
reranker's ``<Instruct>: ...\\n<Query>: ...\\n<Document>: ...`` pair,
truncated to max_length tokens; the reference lean-explore final fusion
(min-max normalised rerank score, BM25+ over the candidates'
informalizations at k1 1.5, b 0.75, delta 0.5, log-compressed dependency
counts among the candidates, and difflib's ratio on names when it is at
least 0.7, weighted 1.0, 0.4, 0.2 and 1.0). Imports nothing of the program.
"""

import difflib
import math
import re
from collections import Counter

import numpy as np

_WHITESPACE = re.compile(r"\w+|[^\w\s]+")
_WORD = re.compile(r"\w+")
_FUZZY = str.maketrans({".": " ", "_": " "})
EPSILON = 1e-9


class Tokenizer:
    def __init__(self, vocab: dict[str, int]):
        self.vocab = vocab
        self.unk = vocab["<unk>"]
        self.eos = vocab["<eos>"]

    def encode(self, text: str) -> list[int]:
        return [
            self.vocab.get(p, self.unk)
            for m in _WHITESPACE.findall(text)
            for p in m.split("_")
            if p
        ]


def query_rows(tok: Tokenizer, prompt: str, queries: list[str], max_length: int) -> list[list[int]]:
    return [tok.encode(prompt + q)[: max_length - 1] + [tok.eos] for q in queries]


def document_rows(tok: Tokenizer, docs: list[str], max_length: int) -> list[list[int]]:
    return [tok.encode(d)[: max_length - 1] + [tok.eos] for d in docs]


def pair_text(instruction: str, query: str, document: str) -> str:
    return f"<Instruct>: {instruction}\n<Query>: {query}\n<Document>: {document}"


def pair_rows(tok: Tokenizer, instruction: str, query: str, docs: list[str],
              max_length: int, suffix_cap: int | None = None) -> tuple[list[list[int]], int]:
    """The token rows of one query's pairs and the length of the prefix
    they share. ``suffix_cap`` is the cascade's first stage: each row keeps
    the shared prefix and at most that many tokens after it."""
    rows = [tok.encode(pair_text(instruction, query, d))[:max_length] for d in docs]
    shared = min(len(r) for r in rows) - 1
    first = rows[0]
    for r in rows[1:]:
        n = 0
        while n < shared and r[n] == first[n]:
            n += 1
        shared = n
    if suffix_cap is not None:
        rows = [r[: shared + suffix_cap] for r in rows]
    return rows, shared


def normalize(values) -> np.ndarray:
    arr = np.asarray(values, dtype=np.float64)
    if arr.size == 0:
        return arr
    lo, hi = float(arr.min()), float(arr.max())
    if hi - lo < EPSILON:
        return np.full(arr.size, 1.0 if hi > EPSILON else 0.0)
    return (arr - lo) / (hi - lo)


def bm25_plus(query: str, texts: list[str], k1=1.5, b=0.75, delta=0.5) -> np.ndarray:
    docs = [[w.lower() for w in _WORD.findall(t)] for t in texts]
    n = len(docs)
    lengths = np.array([len(d) for d in docs], dtype=np.float64)
    avgdl = lengths.mean()
    counts = [Counter(d) for d in docs]
    scores = np.zeros(n)
    for term in (w.lower() for w in _WORD.findall(query)):
        tf = np.array([c.get(term, 0) for c in counts], dtype=np.float64)
        df = int((tf > 0).sum())
        if df == 0:
            continue
        idf = math.log((n + 1) / df)
        scores += idf * ((k1 + 1) * tf / (k1 * (1 - b + b * lengths / avgdl) + tf) + delta)
    return scores


def fuzzy(query: str, name: str) -> float:
    return difflib.SequenceMatcher(
        None, query.lower().translate(_FUZZY), name.lower().translate(_FUZZY)
    ).ratio()


def fused_scores(query: str, names: list[str], informal: list[str],
                 dep_names: list[list[str]], rerank: np.ndarray) -> np.ndarray:
    """Final score of each candidate of one query (rerank = P("true"))."""
    fz = np.array([fuzzy(query, n) for n in names])
    bm = bm25_plus(query, [t or n for t, n in zip(informal, names)])
    wanted = {n: 0 for n in names}
    for deps in dep_names:
        for d in deps:
            if d in wanted:
                wanted[d] += 1
    dep = np.array([wanted[n] for n in names], dtype=np.float64)
    dep = np.log1p(dep) / np.log1p(dep.max()) if dep.max() > 0 else np.zeros(len(names))
    score = normalize(rerank) + 0.4 * normalize(bm) + 0.2 * dep
    return score + np.where(fz >= 0.7, normalize(fz), 0.0)
