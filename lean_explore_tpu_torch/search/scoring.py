"""Signal normalization and fusion math for ranking.

Numerically bit-compatible with the reference's fusion layer
(upstream lean-explore src/lean_explore/search/scoring.py:14-156): ranking math is
tiny (25-1000 candidates) and order-sensitive on ties, so it is pinned to
host float64 — exactly what the reference's pure-Python arithmetic does
implicitly — rather than run on-device where f32 drift could reorder ties.

Implementations are numpy-vectorized; every function also accepts plain
Python lists and returns Python floats/ints so the engine and tests can use
them interchangeably with the reference semantics.

A copy of lean_explore_tpu/search/scoring.py: the port imports nothing of the
JAX package.
"""

import difflib

import numpy as np

EPSILON = 1e-9

_FUZZY_NORM = str.maketrans({".": " ", "_": " "})


def normalize_scores(scores: list[float] | np.ndarray) -> list[float]:
    """Min-max scale to [0, 1].

    Degenerate ranges follow the reference (scoring.py:30-33): if
    max - min < EPSILON, return all-ones when max > EPSILON else all-zeros.
    """
    arr = np.asarray(scores, dtype=np.float64)
    if arr.size == 0:
        return []
    lo = float(arr.min())
    hi = float(arr.max())
    span = hi - lo
    if span < EPSILON:
        fill = 1.0 if hi > EPSILON else 0.0
        return [fill] * arr.size
    return ((arr - lo) / span).tolist()


def normalize_dependency_counts(counts: list[int] | np.ndarray) -> list[float]:
    """Log-compress dependency counts to [0, 1]: log1p(c) / log1p(max)."""
    arr = np.asarray(counts, dtype=np.float64)
    if arr.size == 0:
        return []
    max_count = float(arr.max())
    if max_count == 0:
        return [0.0] * arr.size
    return (np.log1p(arr) / np.log1p(max_count)).tolist()


def compute_ranks(scores: list[float] | np.ndarray) -> list[int]:
    """1-indexed descending-score ranks; zero/negative scores get rank n+1.

    Ties resolve by original position (stable sort), matching the reference's
    ``list.sort`` behavior (scoring.py:74-76).
    """
    arr = np.asarray(scores, dtype=np.float64)
    n = arr.size
    order = np.argsort(-arr, kind="stable")
    ranks = np.empty(n, dtype=np.int64)
    ranks[order] = np.arange(1, n + 1)
    ranks[arr <= 0] = n + 1
    return ranks.tolist()


def reciprocal_rank_fusion(
    rank_lists: list[list[int]] | list[np.ndarray], k: int = 0
) -> list[float]:
    """RRF(d) = sum_i 1 / (k + rank_i(d)); k=0 reproduces the reference's
    plain 1/rank fusion (engine.py:296)."""
    if not rank_lists:
        # np path would collapse shape (0,) to a 0-d array whose .tolist()
        # is the scalar 0.0 — honor the declared list[float] contract.
        return []
    mat = np.asarray(rank_lists, dtype=np.float64)
    return (1.0 / (k + mat)).sum(axis=0).tolist()


def weighted_score_fusion(
    score_lists: list[list[float]], weights: list[float]
) -> list[float]:
    """Min-max normalize each signal, then take the weighted sum."""
    if not score_lists:
        return []
    n = len(score_lists[0])
    if n == 0:
        return []
    normalized = np.asarray(
        [normalize_scores(s) for s in score_lists], dtype=np.float64
    )
    w = np.asarray(weights, dtype=np.float64)
    return (w @ normalized).tolist()


def fuzzy_name_score(query: str, name: str) -> float:
    """Character-level similarity between query and declaration name.

    Both sides are lowercased with dots/underscores treated as spaces, then
    compared with difflib's Ratcliff-Obershelp ratio — the exact metric the
    reference uses (scoring.py:153-156), kept on host: it only ever runs on
    the 25-50 rerank candidates.
    """
    q = query.lower().translate(_FUZZY_NORM)
    n = name.lower().translate(_FUZZY_NORM)
    return difflib.SequenceMatcher(None, q, n).ratio()


def fuzzy_name_scores(query: str, names: list[str]) -> list[float]:
    """Batch fuzzy scores for one query against many names.

    Uses the native lexcore batch scorer when present (exact difflib-ratio
    semantics, incl. autojunk on the second sequence, verified by parity
    tests); falls back to per-pair SequenceMatcher calls. Per-pair because
    ratio() is order-sensitive — autojunk applies to the second sequence,
    so reusing a matcher with the query pinned as seq2 would change results
    vs the reference.
    """
    return fuzzy_name_scores_pairs([query] * len(names), names)


def fuzzy_name_scores_pairs(
    queries: list[str], names: list[str]
) -> list[float]:
    """Fuzzy scores for aligned (query, name) pairs — queries may differ.

    The engine batches every query's rerank candidates of a serving step
    into ONE native call here (thousands of pairs), instead of a Python
    SequenceMatcher per pair.
    """
    if len(queries) != len(names):
        # zip would silently truncate and every later pair's score would
        # shift onto the wrong candidate in the engine's flat slicing.
        raise ValueError(
            f"queries ({len(queries)}) and names ({len(names)}) must align"
        )
    if not names:
        return []
    from lean_explore_tpu_torch.native import fuzzy_batch_native

    norm_q = [q.lower().translate(_FUZZY_NORM) for q in queries]
    norm_n = [name.lower().translate(_FUZZY_NORM) for name in names]
    native = fuzzy_batch_native(norm_q, norm_n)
    if native is not None:
        return native.tolist()
    return [
        difflib.SequenceMatcher(None, q, n).ratio()
        for q, n in zip(norm_q, norm_n)
    ]
