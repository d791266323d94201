"""ctypes bindings for the lexcore native library (native/lexcore.cpp).

The library accelerates the host-side lexical path (BM25 CSR scoring, top-k
selection). Loading is best-effort: when the .so is absent or broken every
caller transparently uses the numpy implementations, so the native layer is
an optimization, never a requirement.

Build with ``make -C native`` (g++ only; no Python build deps).

A copy of lean_explore_tpu/native.py: the port imports nothing of the
JAX package.
"""

import ctypes
import logging
import os
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_IN_TREE_SO = _NATIVE_DIR / "liblexcore.so"
# The documented override comes FIRST so it actually overrides the in-tree
# build (it previously sat after it and could never win in a checkout).
_LIB_CANDIDATES = [
    *(
        [Path(os.environ["LEAN_EXPLORE_LEXCORE"])]
        if os.environ.get("LEAN_EXPLORE_LEXCORE")
        else []
    ),
    _IN_TREE_SO,
]

_lib = None
_load_attempted = False


def _try_build() -> None:
    """Best-effort in-tree build: the .so is a build artifact (gitignored),
    so a fresh checkout needs one ``make -C native``. Doing it here keeps
    the native fast path on for every entry point (serving, bench, MCP)
    without a separate install step; any failure falls back to numpy.

    The Makefile compiles to a temp file and renames atomically, so
    concurrent first-calls from several processes can race this build
    safely — no process can dlopen a half-written library. Set
    LEAN_EXPLORE_NATIVE_AUTOBUILD=0 to keep first-request latency free of
    the one-time compile (build at install time with ``make -C native``).
    """
    import subprocess

    if os.environ.get("LEAN_EXPLORE_NATIVE_AUTOBUILD", "1") == "0":
        return
    if not (_NATIVE_DIR / "Makefile").exists():
        return
    try:
        subprocess.run(
            ["make", "-C", str(_NATIVE_DIR), "liblexcore.so"],
            capture_output=True,
            timeout=120,
            check=False,
        )
    except (OSError, subprocess.TimeoutExpired) as error:
        logger.info("lexcore build attempt failed: %s", error)


def load_lexcore() -> ctypes.CDLL | None:
    """Load and memoize the library; None when unavailable/disabled."""
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    if os.environ.get("LEAN_EXPLORE_NO_NATIVE"):
        return None
    source = _NATIVE_DIR / "lexcore.cpp"
    stale = (
        _IN_TREE_SO.exists()
        and source.exists()
        and _IN_TREE_SO.stat().st_mtime < source.stat().st_mtime
    )
    if not _IN_TREE_SO.exists() or stale:
        # Rebuild on missing OR stale: a .so older than lexcore.cpp would
        # silently keep serving pre-fix native behavior (e.g. the round-3
        # fuzzy autojunk-parity fix) while the tests exercise the source.
        _try_build()
    for candidate in _LIB_CANDIDATES:
        if not candidate.exists():
            continue
        try:
            lib = ctypes.CDLL(str(candidate))
            _configure(lib)
        except (OSError, AttributeError) as error:
            # AttributeError: the library dlopens but lacks a required
            # symbol (stale/foreign build) — fall through to the next
            # candidate / numpy instead of crashing the first search.
            logger.warning("failed to load lexcore at %s: %s", candidate, error)
            continue
        _lib = lib
        logger.info("lexcore loaded from %s", candidate)
        break
    return _lib


def _configure(lib: ctypes.CDLL) -> None:
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.le_bm25_score.argtypes = [
        i64p, i32p, f32p, f64p,
        ctypes.c_int64, ctypes.c_double, f64p,
        i64p, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int32, f64p,
    ]
    lib.le_bm25_score.restype = None
    lib.le_topk.argtypes = [f64p, ctypes.c_int64, ctypes.c_int64, i64p, f64p]
    lib.le_topk.restype = None
    lib.le_tokenize_spaced.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64,
        i64p, ctypes.c_int64,
    ]
    lib.le_tokenize_spaced.restype = ctypes.c_int64
    if hasattr(lib, "le_rrf_fuse"):  # lexcore >= 0.2
        lib.le_rrf_fuse.argtypes = [
            i64p, f64p, ctypes.c_int64,
            i64p, f64p, ctypes.c_int64,
            i64p, f64p,
        ]
        lib.le_rrf_fuse.restype = ctypes.c_int64
        lib.le_dep_boost.argtypes = [
            i64p, ctypes.c_int64, ctypes.c_int64,
            i64p, i64p, ctypes.c_int64,
            i64p, f64p,
        ]
        lib.le_dep_boost.restype = None
    if hasattr(lib, "le_fuzzy_batch"):  # lexcore >= 0.3
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.le_fuzzy_batch.argtypes = [
            u32p, i64p, u32p, i64p, ctypes.c_int64, f64p,
        ]
        lib.le_fuzzy_batch.restype = None
    lib.le_version.restype = ctypes.c_char_p


def _ptr(array: np.ndarray, ctype):
    return array.ctypes.data_as(ctypes.POINTER(ctype))


_METHOD_CODES = {"bm25+": 0, "lucene": 1, "robertson": 2}


def bm25_score_native(
    indptr: np.ndarray,
    doc_indices: np.ndarray,
    tf_values: np.ndarray,
    doc_lengths: np.ndarray,
    avgdl: float,
    idf: np.ndarray,
    query_token_ids: np.ndarray,
    k1: float,
    b: float,
    delta: float,
    method: str,
) -> np.ndarray | None:
    """Native BM25 scoring; None when the library is unavailable."""
    lib = load_lexcore()
    if lib is None:
        return None
    n_docs = doc_lengths.shape[0]
    scores = np.zeros(n_docs, dtype=np.float64)
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    doc_indices = np.ascontiguousarray(doc_indices, dtype=np.int32)
    tf_values = np.ascontiguousarray(tf_values, dtype=np.float32)
    doc_lengths = np.ascontiguousarray(doc_lengths, dtype=np.float64)
    idf = np.ascontiguousarray(idf, dtype=np.float64)
    query_token_ids = np.ascontiguousarray(query_token_ids, dtype=np.int64)
    lib.le_bm25_score(
        _ptr(indptr, ctypes.c_int64),
        _ptr(doc_indices, ctypes.c_int32),
        _ptr(tf_values, ctypes.c_float),
        _ptr(doc_lengths, ctypes.c_double),
        ctypes.c_int64(n_docs),
        ctypes.c_double(avgdl),
        _ptr(idf, ctypes.c_double),
        _ptr(query_token_ids, ctypes.c_int64),
        ctypes.c_int64(len(query_token_ids)),
        ctypes.c_double(k1),
        ctypes.c_double(b),
        ctypes.c_double(delta),
        ctypes.c_int32(_METHOD_CODES[method]),
        _ptr(scores, ctypes.c_double),
    )
    return scores


def tokenize_spaced_native(text: str) -> list[str] | None:
    """Native spaced tokenizer; None when unavailable or the text is
    non-ASCII (the Python regex path handles unicode).

    NOT wired into production: measured 1.7x slower than the Python regex
    on typical short declaration names (ctypes per-call overhead dominates
    at these string lengths — 1.54s vs 0.92s over 100k names). Kept as a
    parity-tested twin of the C tokenizer the CSR scorer shares string
    handling with; a batched variant would be the way in if name
    tokenization ever becomes a measured bottleneck."""
    lib = load_lexcore()
    if lib is None or not text.isascii():
        return None
    raw = text.encode("ascii")
    out = ctypes.create_string_buffer(2 * len(raw) + 2)
    starts = np.zeros(len(raw) + 1, dtype=np.int64)
    n = lib.le_tokenize_spaced(
        raw,
        ctypes.c_int64(len(raw)),
        out,
        ctypes.c_int64(len(out)),
        _ptr(starts, ctypes.c_int64),
        ctypes.c_int64(len(starts)),
    )
    if n < 0:
        return None
    buf = out.raw
    tokens = []
    for i in range(n):
        start = int(starts[i])
        end = buf.index(b"\0", start)
        tokens.append(buf[start:end].decode("ascii"))
    return tokens


def rrf_fuse_native(
    bm25_ids: np.ndarray,
    bm25_scores: np.ndarray,
    sem_ids: np.ndarray,
    sem_scores: np.ndarray,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Native RRF fusion (engine arithmetic); None when unavailable."""
    lib = load_lexcore()
    if lib is None or not hasattr(lib, "le_rrf_fuse"):
        return None
    bm25_ids = np.ascontiguousarray(bm25_ids, dtype=np.int64)
    bm25_scores = np.ascontiguousarray(bm25_scores, dtype=np.float64)
    sem_ids = np.ascontiguousarray(sem_ids, dtype=np.int64)
    sem_scores = np.ascontiguousarray(sem_scores, dtype=np.float64)
    capacity = len(bm25_ids) + len(sem_ids)
    out_ids = np.zeros(capacity, dtype=np.int64)
    out_scores = np.zeros(capacity, dtype=np.float64)
    total = lib.le_rrf_fuse(
        _ptr(bm25_ids, ctypes.c_int64),
        _ptr(bm25_scores, ctypes.c_double),
        ctypes.c_int64(len(bm25_ids)),
        _ptr(sem_ids, ctypes.c_int64),
        _ptr(sem_scores, ctypes.c_double),
        ctypes.c_int64(len(sem_ids)),
        _ptr(out_ids, ctypes.c_int64),
        _ptr(out_scores, ctypes.c_double),
    )
    return out_ids[:total], out_scores[:total]


def dep_boost_native(
    top_ids: np.ndarray,
    dep_indptr: np.ndarray,
    dep_targets: np.ndarray,
    top_n: int = 500,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Native dependency boost over a global id-indexed dependency CSR;
    None when unavailable.

    Mirrors SearchEngine._dependency_boost's contract exactly: only the
    first ``top_n`` candidates participate (votes counted among them,
    results returned for them) — the slice happens HERE so a caller
    passing the full RRF list cannot silently diverge from the Python
    fallback, which slices to top_n itself.
    """
    lib = load_lexcore()
    if lib is None or not hasattr(lib, "le_dep_boost"):
        return None
    top_ids = np.ascontiguousarray(top_ids, dtype=np.int64)[:top_n]
    dep_indptr = np.ascontiguousarray(dep_indptr, dtype=np.int64)
    dep_targets = np.ascontiguousarray(dep_targets, dtype=np.int64)
    n = len(top_ids)
    out_ids = np.zeros(n, dtype=np.int64)
    out_scores = np.zeros(n, dtype=np.float64)
    lib.le_dep_boost(
        _ptr(top_ids, ctypes.c_int64),
        ctypes.c_int64(n),
        ctypes.c_int64(top_n),
        _ptr(dep_indptr, ctypes.c_int64),
        _ptr(dep_targets, ctypes.c_int64),
        ctypes.c_int64(len(dep_indptr) - 2),
        _ptr(out_ids, ctypes.c_int64),
        _ptr(out_scores, ctypes.c_double),
    )
    return out_ids, out_scores


def _pack_utf32(texts: list[str]) -> tuple[np.ndarray, np.ndarray]:
    """Concatenate strings as a UTF-32 code-point buffer + offsets.

    Repeated strings (e.g. one query against 50 candidate names) are
    encoded once.
    """
    offsets = np.zeros(len(texts) + 1, dtype=np.int64)
    chunks = []
    encoded: dict[str, np.ndarray] = {}
    total = 0
    for i, text in enumerate(texts):
        raw = encoded.get(text)
        if raw is None:
            raw = np.frombuffer(text.encode("utf-32-le"), dtype=np.uint32)
            encoded[text] = raw
        chunks.append(raw)
        total += len(raw)
        offsets[i + 1] = total
    data = (
        np.concatenate(chunks)
        if chunks
        else np.zeros(0, dtype=np.uint32)
    )
    return np.ascontiguousarray(data, dtype=np.uint32), offsets


def fuzzy_batch_native(
    a_texts: list[str], b_texts: list[str]
) -> np.ndarray | None:
    """Batch difflib-ratio parity scores for aligned (a, b) string pairs;
    None when the library is unavailable. Inputs must already be normalized
    (the scoring layer lowercases and maps ./_ to spaces)."""
    lib = load_lexcore()
    if lib is None or not hasattr(lib, "le_fuzzy_batch"):
        return None
    if len(a_texts) != len(b_texts):
        raise ValueError("a_texts and b_texts must align")
    n = len(a_texts)
    out = np.zeros(n, dtype=np.float64)
    if n == 0:
        return out
    a_data, a_off = _pack_utf32(a_texts)
    b_data, b_off = _pack_utf32(b_texts)
    lib.le_fuzzy_batch(
        _ptr(a_data, ctypes.c_uint32),
        _ptr(a_off, ctypes.c_int64),
        _ptr(b_data, ctypes.c_uint32),
        _ptr(b_off, ctypes.c_int64),
        ctypes.c_int64(n),
        _ptr(out, ctypes.c_double),
    )
    return out


def topk_native(
    scores: np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray] | None:
    """Native top-k (descending, ties by index); None when unavailable."""
    lib = load_lexcore()
    if lib is None:
        return None
    scores = np.ascontiguousarray(scores, dtype=np.float64)
    k = min(k, scores.shape[0])
    out_idx = np.zeros(k, dtype=np.int64)
    out_scores = np.zeros(k, dtype=np.float64)
    lib.le_topk(
        _ptr(scores, ctypes.c_double),
        ctypes.c_int64(scores.shape[0]),
        ctypes.c_int64(k),
        _ptr(out_idx, ctypes.c_int64),
        _ptr(out_scores, ctypes.c_double),
    )
    return out_idx, out_scores
