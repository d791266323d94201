"""BM25 lexical index with bm25s-compatible "bm25+" scoring.

Replaces the reference's vendored bm25s/SciPy CSC scorer
(upstream lean-explore src/lean_explore/search/engine.py:192-223 and
extract/index.py:238-266). The scoring math reproduces bm25s
``method="bm25+"`` exactly so the reference's cross-index max-merge and
rank fusion see identical numbers:

    score(q, d) = sum over query-token occurrences t (t in vocab) of
        idf(t) * ( (k1+1)*tf(t,d) / (k1*(1 - b + b*dl_d/avgdl) + tf(t,d))
                   + delta )

    idf(t) = ln((N + 1) / df(t))          [BM25+ of Lv & Zhai 2011]

Note the ``+ delta`` applies to *every* document, including those without
the token (tf=0 -> contribution idf*delta). That per-query-token constant is
rank-neutral within one index but matters for the engine's max-merge across
the spaced/raw name indices, so it is kept, mirroring bm25s's
nonoccurrence-array mechanism.

Postings are token-major CSR over numpy arrays: scoring a query is a few
vectorized gathers + adds on host (the corpus-sized dense accumulation is
~1MB), which is faster end-to-end than shipping sparse postings to the GPU
for the handful of tokens a query carries. The dense retrieval matmul is
where the GPU earns its keep; see ops/dense.py.

A copy of lean_explore_tpu/index/bm25.py: the port imports nothing of the
JAX package.
"""

import json
from dataclasses import asdict, dataclass
from pathlib import Path

import numpy as np

_METHODS = ("bm25+", "lucene", "robertson")


@dataclass(frozen=True)
class Bm25Params:
    """Scoring parameters (bm25s defaults)."""

    k1: float = 1.5
    b: float = 0.75
    delta: float = 0.5
    method: str = "bm25+"


def _idf(method: str, df: np.ndarray, n_docs: int) -> np.ndarray:
    df = df.astype(np.float64)
    if method == "bm25+":
        return np.log((n_docs + 1) / df)
    if method == "lucene":
        return np.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
    if method == "robertson":
        return np.log((n_docs - df + 0.5) / (df + 0.5))
    raise ValueError(f"unsupported method {method!r}; choose from {_METHODS}")


class Bm25Index:
    """Token-major CSR BM25 index over a tokenized corpus."""

    def __init__(
        self,
        vocab: dict[str, int],
        indptr: np.ndarray,
        doc_indices: np.ndarray,
        tf_values: np.ndarray,
        doc_lengths: np.ndarray,
        params: Bm25Params,
    ):
        self.vocab = vocab
        self.indptr = indptr
        self.doc_indices = doc_indices
        self.tf_values = tf_values
        self.doc_lengths = doc_lengths
        self.params = params
        self.n_docs = int(doc_lengths.shape[0])
        self.avgdl = float(doc_lengths.mean()) if self.n_docs else 0.0
        df = np.diff(indptr)
        # Tokens always have df >= 1 by construction (they came from a doc).
        self.idf = _idf(params.method, np.maximum(df, 1), self.n_docs)

    # ------------------------------------------------------------------
    # Build / persist
    # ------------------------------------------------------------------

    @classmethod
    def build(
        cls, corpus_tokens: list[list[str]], params: Bm25Params | None = None
    ) -> "Bm25Index":
        """Index a tokenized corpus.

        Token frequency within each doc is honored; callers wanting the
        reference's per-doc dedup for name indices (extract/index.py:255-256)
        dedup before calling.
        """
        params = params or Bm25Params()
        if params.method not in _METHODS:
            raise ValueError(f"unsupported method {params.method!r}")
        vocab: dict[str, int] = {}
        # Accumulate (token_id, doc_id) -> tf
        token_doc_tf: dict[tuple[int, int], int] = {}
        doc_lengths = np.zeros(len(corpus_tokens), dtype=np.float64)
        for doc_id, tokens in enumerate(corpus_tokens):
            doc_lengths[doc_id] = len(tokens)
            for tok in tokens:
                tid = vocab.setdefault(tok, len(vocab))
                key = (tid, doc_id)
                token_doc_tf[key] = token_doc_tf.get(key, 0) + 1

        n_vocab = len(vocab)
        counts = np.zeros(n_vocab, dtype=np.int64)
        for tid, _ in token_doc_tf:
            counts[tid] += 1
        indptr = np.zeros(n_vocab + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        doc_indices = np.zeros(len(token_doc_tf), dtype=np.int32)
        tf_values = np.zeros(len(token_doc_tf), dtype=np.float32)
        cursor = indptr[:-1].copy()
        # No sort needed: dict insertion order already yields ascending
        # doc_id per token (docs are scanned in order), and the cursor
        # places each posting independently — a global O(nnz log nnz)
        # Python tuple sort here was pure wasted build time.
        for (tid, doc_id), tf in token_doc_tf.items():
            pos = cursor[tid]
            doc_indices[pos] = doc_id
            tf_values[pos] = tf
            cursor[tid] += 1
        return cls(vocab, indptr, doc_indices, tf_values, doc_lengths, params)

    def save(self, path: str | Path) -> None:
        """Persist as one .npz (vocab and params ride as JSON strings)."""
        np.savez_compressed(
            path,
            indptr=self.indptr,
            doc_indices=self.doc_indices,
            tf_values=self.tf_values,
            doc_lengths=self.doc_lengths,
            vocab_json=np.array(json.dumps(self.vocab)),
            params_json=np.array(json.dumps(asdict(self.params))),
        )

    @classmethod
    def load(cls, path: str | Path) -> "Bm25Index":
        path = Path(path)
        if not path.exists():
            raise FileNotFoundError(
                f"BM25 index not found at {path}. Run 'lean-explore data fetch' "
                "or the extraction pipeline first."
            )
        with np.load(path, allow_pickle=False) as data:
            return cls(
                vocab=json.loads(str(data["vocab_json"])),
                indptr=data["indptr"],
                doc_indices=data["doc_indices"],
                tf_values=data["tf_values"],
                doc_lengths=data["doc_lengths"],
                params=Bm25Params(**json.loads(str(data["params_json"]))),
            )

    # ------------------------------------------------------------------
    # Scoring
    # ------------------------------------------------------------------

    def score(self, query_tokens: list[str]) -> np.ndarray:
        """Dense score vector [n_docs] float64 for one tokenized query.

        Duplicate query tokens contribute once per occurrence (bm25s sums
        per token-id occurrence); out-of-vocabulary tokens contribute 0.

        Uses the lexcore native scorer when built (make -C native); the
        numpy path below is the always-available reference implementation.
        """
        p = self.params
        if self.n_docs:
            from lean_explore_tpu_torch.native import bm25_score_native

            token_ids = np.fromiter(
                (self.vocab.get(t, -1) for t in query_tokens),
                dtype=np.int64,
                count=len(query_tokens),
            )
            native = bm25_score_native(
                self.indptr,
                self.doc_indices,
                self.tf_values,
                self.doc_lengths,
                self.avgdl,
                self.idf,
                token_ids,
                p.k1,
                p.b,
                p.delta,
                p.method,
            )
            if native is not None:
                return native
        scores = np.zeros(self.n_docs, dtype=np.float64)
        constant = 0.0
        for tok in query_tokens:
            tid = self.vocab.get(tok)
            if tid is None:
                continue
            idf_t = self.idf[tid]
            if p.method == "bm25+":
                constant += idf_t * p.delta
            lo, hi = self.indptr[tid], self.indptr[tid + 1]
            docs = self.doc_indices[lo:hi]
            tf = self.tf_values[lo:hi].astype(np.float64)
            # Same association as the native scorer (k1(1-b) and k1*b/avgdl
            # precomputed) so both paths are bit-identical.
            k1b_over_avgdl = p.k1 * p.b / self.avgdl if self.avgdl > 0 else 0.0
            denom = p.k1 * (1.0 - p.b) + k1b_over_avgdl * self.doc_lengths[docs] + tf
            if p.method == "robertson":
                tfc = tf / denom
            else:
                tfc = (p.k1 + 1.0) * tf / denom
            scores[docs] += idf_t * tfc
        if constant:
            scores += constant
        return scores

    def score_batch(self, queries_tokens: list[list[str]]) -> np.ndarray:
        """[Q, n_docs] score matrix."""
        if not queries_tokens:
            return np.zeros((0, self.n_docs), dtype=np.float64)
        return np.stack([self.score(q) for q in queries_tokens])

    def retrieve(
        self, query_tokens: list[str], k: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Top-k (indices, scores), descending, ties broken by doc index.

        k is clamped to the corpus size (bm25s raises instead; clamping keeps
        small-corpus serving functional with the engine's k=1000 defaults).
        """
        scores = self.score(query_tokens)
        k = min(k, self.n_docs)
        if k == 0:
            return np.array([], dtype=np.int64), np.array([], dtype=np.float64)
        from lean_explore_tpu_torch.native import topk_native

        native = topk_native(scores, k)
        if native is not None:
            return native
        # Deterministic selection (ties by ascending doc index), matching the
        # native comparator so both paths return identical candidate sets.
        idx = np.lexsort((np.arange(self.n_docs), -scores))[:k]
        return idx, scores[idx]
