"""Plain reference of the candidate pool that goes to the reranker.

Written from the reference lean-explore engine's semantics, not from the
program: two BM25+ indices over the declaration names (k1 1.5, b 0.75,
delta 0.5, idf ln((N + 1) / df), each name's tokens counted once; one
index of the name split on dots, underscores and camelCase, one of the
whole lowercased name), each queried for its top ``bm25_k`` (ties by
ascending row) and merged by the larger score in first-seen order;
reciprocal-rank fusion of that list with the dense candidates (1/rank in
each list, a missing document ranked one past the list's end; ranks by
score, ties in first-seen order); the dependency boost over the fused top
``top_n`` (1/rank plus 1/dependency-rank, a document's count being how
many of the top ``top_n`` name it as a dependency); and the boosted top
``rerank_top``. Imports nothing of the program.
"""

import math
import re

import numpy as np

_CAMEL = re.compile(r"([a-z])([A-Z])")
_WORD = re.compile(r"\w+")
K1, B, DELTA = 1.5, 0.75, 0.5


def spaced_tokens(name: str) -> list[str]:
    if not name:
        return []
    text = _CAMEL.sub(r"\1 \2", name.replace(".", " ").replace("_", " "))
    return _WORD.findall(text.lower())


def raw_tokens(name: str) -> list[str]:
    return [name.lower()] if name else []


class NameIndex:
    """BM25+ over one tokenisation of every name; postings kept only for
    the tokens the judged queries use."""

    def __init__(self, names: list[str], tokenize, wanted: set[str]):
        self.n = len(names)
        lengths = np.empty(self.n, dtype=np.float64)
        postings: dict[str, list[int]] = {t: [] for t in wanted}
        for row, name in enumerate(names):
            tokens = set(tokenize(name))
            lengths[row] = len(tokens)
            for t in tokens & wanted:
                postings[t].append(row)
        self.lengths = lengths
        self.avgdl = float(lengths.mean())
        self.postings = {t: np.asarray(rows, dtype=np.int64) for t, rows in postings.items() if rows}

    def top(self, tokens: list[str], k: int) -> tuple[np.ndarray, np.ndarray]:
        scores = np.zeros(self.n)
        constant = 0.0
        for t in tokens:
            rows = self.postings.get(t)
            if rows is None:
                continue
            idf = math.log((self.n + 1) / len(rows))
            constant += idf * DELTA
            # tf is 1: a name's tokens count once.
            norm = K1 * (1.0 - B) + K1 * B / self.avgdl * self.lengths[rows] + 1.0
            scores[rows] += idf * ((K1 + 1.0) * 1.0 / norm)
        scores += constant
        order = np.lexsort((np.arange(self.n), -scores))[: min(k, self.n)]
        return order, scores[order]


def _first_seen_max(ids, scores) -> dict[int, float]:
    out: dict[int, float] = {}
    for i, s in zip(ids, scores):
        i, s = int(i), float(s)
        out[i] = max(out[i], s) if i in out else s
    return out


def _ranks(scored: dict[int, float]) -> dict[int, int]:
    ordered = sorted(scored.items(), key=lambda kv: kv[1], reverse=True)
    return {cid: r for r, (cid, _) in enumerate(ordered, start=1)}


class PoolReference:
    """The pool of each judged query over one corpus (ids are row + 1)."""

    def __init__(self, names: list[str], dependencies, queries: list[str]):
        """``dependencies(row)`` is the list of names row depends on."""
        self.names = names
        self.deps = dependencies
        self.spaced = NameIndex(names, spaced_tokens, {t for q in queries for t in spaced_tokens(q)})
        self.raw = NameIndex(names, raw_tokens, {t for q in queries for t in raw_tokens(q)})

    def lexical(self, query: str, k: int) -> dict[int, float]:
        a_rows, a_scores = self.spaced.top(spaced_tokens(query), k)
        b_rows, b_scores = self.raw.top(raw_tokens(query), k)
        return _first_seen_max(np.concatenate([a_rows, b_rows]) + 1, np.concatenate([a_scores, b_scores]))

    def pool(self, query: str, dense_ids, dense_scores, bm25_k: int, rerank_top: int,
             top_n: int = 500) -> list[int]:
        bm25 = self.lexical(query, bm25_k)
        dense = _first_seen_max(dense_ids, dense_scores)
        if not bm25 and not dense:
            return []
        rb, rs = _ranks(bm25), _ranks(dense)
        missing_b, missing_s = len(rb) + 1, len(rs) + 1
        candidates = list(dict.fromkeys(list(bm25) + list(dense)))
        fused = [(c, 1.0 / rb.get(c, missing_b) + 1.0 / rs.get(c, missing_s)) for c in candidates]
        fused.sort(key=lambda kv: kv[1], reverse=True)
        top = [c for c, _ in fused[:top_n]]
        in_top = {self.names[c - 1]: c for c in top}
        counts = dict.fromkeys(top, 0)
        for c in top:
            for name in self.deps(c - 1):
                if name in in_top:
                    counts[in_top[name]] += 1
        most = max(counts.values(), default=0)
        boosted = []
        for rank, c in enumerate(top, start=1):
            n = counts[c]
            dep_rank = (most - n + 1) if most > 0 and n > 0 else (most + 1 if most > 0 else top_n + 1)
            boosted.append((c, 1.0 / rank + 1.0 / dep_rank))
        boosted.sort(key=lambda kv: kv[1], reverse=True)
        return [c for c, _ in boosted[:rerank_top]]
