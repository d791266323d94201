"""Retrieval-quality metrics over labeled (query -> declaration) pairs
(lean_explore_tpu/evaluation.py): the same metrics and rounding, so a
quality number from either package means the same thing.

Beside them, the measurements of the JAX package's quality and
cascade-calibration scripts, so that the port's scripts and chip_smoke.py
call the same functions:

- ``build_index`` / ``open_engine``: a synthetic corpus embedded and
  indexed through the port, and a float32 engine over it;
- ``capture_rerank_groups``: one serving pass recording every query's
  rerank candidates and their full-length scores
  (scripts/calibrate_cascade.py, scripts/measure_prescreen_coverage.py);
- ``score_caps``: each prescreen cap's truncated scores of those groups,
  scored once, from which ``calibration_row`` (label-free containment,
  ``recommended_cap``) and ``coverage_row`` (gold's stage-1 rank) both
  come;
- ``evaluate_query_classes`` (scripts/eval_query_classes.py),
  ``evaluate_rerank_tops`` (scripts/eval_rerank_top.py),
  ``dense_int8_recall`` and ``reranker_int8_drift``
  (scripts/measure_int8_effects.py).

One kept divergence (ROADMAP C): ``guard_store_vocab`` skips declarations
without an informalization, where the JAX guard hands ``None`` to the
tokenizer and fails with a TypeError.
"""

import asyncio
import os
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

from lean_explore_tpu_torch.models.tokenizer import unk_fraction


def guard_store_vocab(store, tokenizer, *, sample: int = 64) -> None:
    """Refuse to evaluate a store whose text the tokenizer cannot read.

    Samples ``sample`` informalizations and raises ``SystemExit`` when
    more than 20% of their tokens are <unk>: the signature of checkpoints
    trained on another corpus regime (short-doc checkpoints against a
    --body-sentences 5 index, say), whose numbers would describe uniform
    <unk> filler.
    """
    texts: list[str] = []
    for decl in store.iter_all(with_embeddings=False):
        if decl.informalization is None:
            continue
        texts.append(decl.informalization)
        if len(texts) >= sample:
            break
    unk = unk_fraction(tokenizer, texts)
    if unk > 0.2:
        raise SystemExit(
            f"vocabulary mismatch: {unk:.0%} of corpus tokens are <unk> "
            "under the model's tokenizer — these checkpoints were trained "
            "on a different corpus regime (e.g. short-doc checkpoints vs "
            "--body-sentences > 1); the measurement would describe uniform "
            "<unk> filler, not the intended text. Train matching "
            "checkpoints first (scripts/train_*_e2e.py with the same "
            "--body-sentences)."
        )


def evaluate_engine(
    engine,
    labeled: list[tuple[str, str]],
    *,
    k: int = 10,
    batch: int = 64,
    dense_k: int = 1000,
    bm25_k: int = 1000,
    rerank_top: int = 50,
) -> dict:
    """recall@1/@k and MRR@k of engine.search_batch on (query, target) pairs.

    ``rerank_top`` defaults to the serving default (Service.search's 50),
    so the full pipeline is measured, rerank included; ``rerank_top=0``
    ablates the rerank stage.
    """
    if not labeled:
        raise ValueError(
            "evaluate_engine needs at least one (query, target) pair — "
            "the eval split is empty"
        )
    hits1 = hitsk = 0
    reciprocal_ranks = []

    async def _run() -> None:
        nonlocal hits1, hitsk
        for start in range(0, len(labeled), batch):
            chunk = labeled[start : start + batch]
            results = await engine.search_batch(
                [q for q, _ in chunk], limit=k, rerank_top=rerank_top,
                dense_k=dense_k, bm25_k=bm25_k,
            )
            for (_, target), ranked in zip(chunk, results):
                names = [r.name for r in ranked]
                if names and names[0] == target:
                    hits1 += 1
                if target in names:
                    hitsk += 1
                    reciprocal_ranks.append(1.0 / (names.index(target) + 1))
                else:
                    reciprocal_ranks.append(0.0)

    asyncio.run(_run())
    n = len(labeled)
    return {
        "recall_at_1": round(hits1 / n, 4),
        f"recall_at_{k}": round(hitsk / n, 4),
        f"mrr_at_{k}": round(float(np.mean(reciprocal_ranks)), 4),
        "n_queries": n,
    }


CASCADE_ENV = "LEAN_EXPLORE_RERANK_CASCADE"
# Batch of the stage's documents when the scripts embed a corpus, and of
# the groups each cap is scored in (the JAX scripts' 256 and 64).
EMBED_BATCH = 256
CAP_BATCH = 64


def build_index(corpus, embedder, work: Path) -> tuple:
    """Store, embeddings and artifacts of ``corpus`` in ``work``
    (``extract.embeddings.generate_embeddings``, ``extract.index.build_indices``);
    returns the open store and the seconds (and docs/s) of each stage."""
    import torch

    from lean_explore_tpu_torch.extract.embeddings import generate_embeddings
    from lean_explore_tpu_torch.extract.index import build_indices
    from lean_explore_tpu_torch.models.store import DeclarationStore

    seconds = {}
    t = time.perf_counter()
    (work / "store").mkdir(parents=True, exist_ok=True)
    store = DeclarationStore(work / "store" / "declarations.db", create=True)
    store.insert_many(corpus.declarations)
    seconds["store"] = time.perf_counter() - t
    guard_store_vocab(store, embedder.tokenizer)

    t = time.perf_counter()
    n = generate_embeddings(store, client=embedder, batch_size=EMBED_BATCH, use_cache=False)
    if embedder.device.type == "cuda":
        torch.cuda.synchronize(embedder.device)
    seconds["embed"] = time.perf_counter() - t
    seconds["embed_docs_per_s"] = n / seconds["embed"]

    t = time.perf_counter()
    build_indices(store, work)
    seconds["build"] = time.perf_counter() - t
    return store, seconds


def open_engine(work: Path, store, embedder, reranker, device) -> tuple:
    """A SearchEngine over the artifacts in ``work`` with a float32 corpus
    on ``device``, and the seconds the load took."""
    from lean_explore_tpu_torch.index.artifacts import load_index_artifacts
    from lean_explore_tpu_torch.search.engine import SearchEngine

    t = time.perf_counter()
    artifacts = load_index_artifacts(work, dense_dtype="float32", device=device)
    engine = SearchEngine(
        work, store=store, artifacts=artifacts, embedding_client=embedder,
        reranker_client=reranker, device=device,
    )
    return engine, time.perf_counter() - t


def float32_clients(embedder_dir, reranker_dir, emb_max_length, rr_max_length, device):
    """The float32 embedder and reranker the JAX scripts evaluate with,
    on ``device``."""
    import torch

    from lean_explore_tpu_torch.util.embedding_client import EmbeddingClient
    from lean_explore_tpu_torch.util.reranker_client import RerankerClient

    embedder = EmbeddingClient(
        str(embedder_dir), model_dir=Path(embedder_dir), max_length=emb_max_length,
        batch_size=EMBED_BATCH, dtype=torch.float32, device=device,
    )
    reranker = RerankerClient(
        str(reranker_dir), model_dir=Path(reranker_dir), max_length=rr_max_length,
        dtype=torch.float32, device=device,
    )
    return embedder, reranker


def prepare_engine(corpus, embedder, reranker, data_dir, tmp: Path, device):
    """The JAX scripts' two ways to an engine: over an existing artifact
    directory (``data_dir``; its store guarded against the embedder's
    vocabulary, nothing of it written or deleted), or over ``corpus``
    embedded and indexed in ``tmp``. Returns the engine and its store."""
    from lean_explore_tpu_torch.models.store import DeclarationStore

    if data_dir is not None:
        work = Path(data_dir)
        store = DeclarationStore(work / "declarations.db")
        guard_store_vocab(store, embedder.tokenizer)
    else:
        work = Path(tmp)
        store, _ = build_index(corpus, embedder, work)
    engine, _ = open_engine(work, store, embedder, reranker, device)
    return engine, store


class RerankGroup(NamedTuple):
    """One query's rerank candidates as the engine sent them to the
    cross-encoder, with their full-length scores."""

    query: str
    documents: list[str]
    scores: list[float]


def capture_rerank_groups(
    engine, queries: list[str], rerank_top: int, *, batch: int | None = None
) -> list[RerankGroup]:
    """One serving pass of ``engine.search_batch`` over ``queries`` (in
    batches of ``batch``, all in one call when None) at ``rerank_top``,
    recording each query's candidate documents and full-length scores.

    The engine reaches the reranker through the client's async
    ``rerank_grouped`` (which runs ``rerank_grouped_sync`` in a thread), so
    that is the method wrapped here, on the instance, for the pass only;
    LEAN_EXPLORE_RERANK_CASCADE is unset for it, so the scores are the full
    rerank's. Raises when a non-blank query was not captured, in order.
    """
    client = engine.reranker_client
    real = client.rerank_grouped
    groups: list[RerankGroup] = []

    async def recording(qs, docs_grouped):
        scores = await real(qs, docs_grouped)
        groups.extend(
            RerankGroup(q, list(docs), [float(x) for x in s])
            for q, docs, s in zip(qs, docs_grouped, scores)
        )
        return scores

    async def run():
        step = batch or max(len(queries), 1)
        for start in range(0, len(queries), step):
            await engine.search_batch(
                queries[start : start + step], limit=10, rerank_top=rerank_top
            )

    saved = os.environ.pop(CASCADE_ENV, None)
    own = vars(client).get("rerank_grouped")  # an instance's own method stays its own
    client.rerank_grouped = recording
    try:
        asyncio.run(run())
    finally:
        if own is None:
            del client.rerank_grouped
        else:
            client.rerank_grouped = own
        if saved is not None:
            os.environ[CASCADE_ENV] = saved
    want = [q for q in queries if q.strip()]
    if [g.query for g in groups] != want:
        raise RuntimeError(
            f"captured {len(groups)} rerank groups for {len(want)} queries "
            "(or out of order): the capture missed the engine's rerank call"
        )
    return groups


def score_caps(
    client, groups: list[RerankGroup], caps, *, batch: int = CAP_BATCH
) -> dict[int, tuple[list[list[float]], float]]:
    """Each cap's scores of every group with the documents cut to ``cap``
    suffix tokens (``rerank_grouped_sync(suffix_cap=cap)``, the cascade's
    stage 1), in batches of ``batch`` groups: {cap: (scores, seconds)}.
    Both tools' rows come from this one scoring."""
    out = {}
    for cap in caps:
        t = time.perf_counter()
        scores: list[list[float]] = []
        for start in range(0, len(groups), batch):
            chunk = groups[start : start + batch]
            scores.extend(
                list(map(float, s))
                for s in client.rerank_grouped_sync(
                    [g.query for g in chunk], [g.documents for g in chunk],
                    suffix_cap=cap,
                )
            )
        out[cap] = (scores, time.perf_counter() - t)
    return out


def ranking(scores) -> list[int]:
    """Candidate positions by descending score, ties in position order
    (Python's stable sort, as the cascade's keep set)."""
    return sorted(range(len(scores)), key=lambda i: scores[i], reverse=True)


def containment_metrics(
    full_scores: list[float], cap_scores: list[float], keep: int
) -> tuple[bool, bool, float]:
    """Agreement of a truncated prescreen with the full-length ranking
    (scripts/calibrate_cascade.py): (full top-1 in the prescreen's
    top-``keep``, the full top-3 all in it, |top-keep ∩ top-keep| / keep).
    Label-free: the full-length top-1 stands in for gold."""
    full_order = ranking(full_scores)
    cap_top = set(ranking(cap_scores)[:keep])
    top3 = full_order[: min(3, len(full_scores))]
    return (
        full_order[0] in cap_top,
        len(set(top3) & cap_top) == len(top3),
        len(set(full_order[:keep]) & cap_top) / keep,
    )


def calibration_row(groups: list[RerankGroup], cap_scores, keep: int, seconds: float) -> dict:
    """calibrate_cascade.py's row of one cap: the containment means over
    the groups, rounded as there."""
    top1 = top3 = 0
    overlaps = 0.0
    for group, scores in zip(groups, cap_scores):
        hit1, hit3, overlap = containment_metrics(group.scores, scores, keep)
        top1 += hit1
        top3 += hit3
        overlaps += overlap
    n = len(groups)
    return {
        "containment_top1": round(top1 / n, 4),
        "containment_top3": round(top3 / n, 4),
        "overlap_at_keep": round(overlaps / n, 4),
        "n": n,
        "seconds": round(seconds, 1),
    }


def recommended_cap(rows: dict, floor: float):
    """The smallest cap whose containment_top1 clears ``floor``, or None."""
    return next(
        (cap for cap in sorted(rows) if rows[cap]["containment_top1"] >= floor), None
    )


def gold_stage1_ranks(
    groups: list[RerankGroup], cap_scores, target_by_query: dict[str, str]
) -> list[int]:
    """measure_prescreen_coverage.py's gold ranks (1-based) under one cap's
    scores, for each group whose query is labeled and whose candidates hold
    its target (a document starting with ``"<target>:"``)."""
    ranks = []
    for group, scores in zip(groups, cap_scores):
        target = target_by_query.get(group.query)
        if target is None:
            continue
        gold = next(
            (i for i, d in enumerate(group.documents) if d.startswith(target + ":")), None
        )
        if gold is None:
            continue  # gold not retrieved: the cascade cannot affect it
        ranks.append(ranking(scores).index(gold) + 1)
    return ranks


def coverage_row(ranks: list[int], seconds: float) -> dict:
    """measure_prescreen_coverage.py's row of one cap."""
    r = np.array(ranks)
    return {
        "top8": round(float((r <= 8).mean()), 4),
        "top12": round(float((r <= 12).mean()), 4),
        "top16": round(float((r <= 16).mean()), 4),
        "top25": round(float((r <= 25).mean()), 4),
        "median_rank": float(np.median(r)),
        "n": int(r.size),
        "seconds": round(seconds, 1),
    }


def doc_words(groups: list[RerankGroup]) -> dict:
    """Median and 90th percentile of the candidates' word counts."""
    words = [len(d.split()) for g in groups for d in g.documents]
    return {"median": float(np.median(words)), "p90": float(np.percentile(words, 90))}


# scripts/eval_query_classes.py's engine configurations.
QUERY_CLASS_CONFIGS = {
    "bm25_only": dict(dense_k=0, rerank_top=0),
    "dense_only": dict(bm25_k=0, rerank_top=0),
    "hybrid_no_rerank": dict(rerank_top=0),
    "full_pipeline": None,  # the full pipeline at the caller's rerank_top
}


def evaluate_query_classes(
    engine, query_sets: dict, rerank_top: int, *, configs=None, log=None
) -> dict:
    """``evaluate_engine`` of each query class in each configuration of
    ``configs`` (a subset of QUERY_CLASS_CONFIGS' labels, all when None;
    the full pipeline at ``rerank_top``), each row with its seconds."""
    results: dict = {}
    for qclass, labeled in query_sets.items():
        results[qclass] = {}
        for label, overrides in QUERY_CLASS_CONFIGS.items():
            if configs is not None and label not in configs:
                continue
            kw = dict(rerank_top=rerank_top) if overrides is None else overrides
            t = time.perf_counter()
            row = evaluate_engine(engine, labeled, **kw)
            row["seconds"] = round(time.perf_counter() - t, 1)
            results[qclass][label] = row
            if log is not None:
                log(f"{qclass}/{label}: {row}")
    return results


def evaluate_rerank_tops(
    engine, labeled, rerank_tops, cascade: str, *, log=None
) -> dict:
    """eval_rerank_top.py's sweep: each ``rerank_top`` without and then
    with LEAN_EXPLORE_RERANK_CASCADE set to ``cascade`` (unset after each
    arm and before the first), under its labels."""
    results = {}
    try:
        for top in rerank_tops:
            for point in (None, cascade):
                if point is None:
                    os.environ.pop(CASCADE_ENV, None)
                    label = f"top{top}"
                else:
                    os.environ[CASCADE_ENV] = point
                    label = f"top{top}_cascade_{point.replace(',', '_')}"
                t = time.perf_counter()
                row = evaluate_engine(engine, labeled, rerank_top=top)
                row["seconds"] = round(time.perf_counter() - t, 1)
                results[label] = row
                if log is not None:
                    log(f"{label}: {row}")
    finally:
        os.environ.pop(CASCADE_ENV, None)
    return results


def topk_overlap(got: np.ndarray, exact: np.ndarray, k: int = 10) -> float:
    """Mean |top-k ∩ exact top-k| / k over the rows, rounded to 4 places."""
    return round(
        float(np.mean([len(set(exact[i]) & set(got[i, :k])) / k for i in range(exact.shape[0])])),
        4,
    )


def dense_int8_recall(corpus_mat, queries, *, k: int = 10) -> dict:
    """measure_int8_effects.py's dense half on the tensors' device: recall
    @``k`` against the exact scan of the plain bin-max scan
    (``dense_topk(method="fused")``) and of the corpus quantized per row
    after padding to 512 rows (``quantize_rows_device``), searched as an
    int8 ``DenseIndex`` searches it: the int8 kernel on the card above
    16,384 padded rows, the exact quantized scan otherwise."""
    import torch

    from lean_explore_tpu_torch.index.dense import INT8_KERNEL_MIN_ROWS, ROW_ALIGN
    from lean_explore_tpu_torch.ops.bin_topk_int8 import bin_topk_int8
    from lean_explore_tpu_torch.ops.dense import dense_topk, serving_bins
    from lean_explore_tpu_torch.ops.quant import quantize_rows_device, quantized_topk

    n = int(corpus_mat.shape[0])
    _, exact = dense_topk(queries, corpus_mat, k, method="chunked")
    _, fused = dense_topk(queries, corpus_mat, k, method="fused")
    padded = torch.nn.functional.pad(corpus_mat, (0, 0, 0, (-n) % ROW_ALIGN))
    codes, scales = quantize_rows_device(padded)
    rows = codes.shape[0]
    if codes.device.type == "cuda" and rows > INT8_KERNEL_MIN_ROWS:
        bins = serving_bins(queries.shape[0], rows)
        _, int8_rows = bin_topk_int8(queries, codes, scales, n, k=k, bins=bins)
    else:
        _, int8_rows = quantized_topk(queries, codes, scales, n, k=k)
    exact = exact.cpu().numpy()
    return {
        "n_rows": n,
        "n_queries": int(exact.shape[0]),
        "recall_at_10": {
            "fused_f32_vs_exact": topk_overlap(fused.cpu().numpy(), exact, k),
            "int8_vs_exact": topk_overlap(int8_rows.cpu().numpy(), exact, k),
        },
    }


def direct_eval_groups(corpus, n_queries: int, seed: int) -> tuple[list[str], list[list[str]]]:
    """measure_int8_effects.py's direct-eval groups: each of the first
    ``n_queries`` eval queries with its target's document first and 49
    held-out distractors drawn with ``default_rng(seed + 2)``."""
    from lean_explore_tpu_torch.train.synthetic import reranker_document

    name_to_idx = {d.name: i for i, d in enumerate(corpus.declarations)}
    holdout = (corpus.n_train, len(corpus.declarations))
    rng = np.random.default_rng(seed + 2)
    queries, docs_grouped = [], []
    for q, target in corpus.eval_queries[:n_queries]:
        ti = name_to_idx[target]
        distractors = []
        while len(distractors) < 49:
            j = int(rng.integers(*holdout))
            if j != ti:
                distractors.append(j)
        docs_grouped.append(
            [reranker_document(corpus.declarations[ti])]
            + [reranker_document(corpus.declarations[j]) for j in distractors]
        )
        queries.append(q)
    return queries, docs_grouped


def reranker_int8_drift(f32, q8, queries, docs_grouped) -> dict:
    """measure_int8_effects.py's reranker half: P(true) drift of the int8
    client against the float32 one on the same groups, recall@1-of-50 of
    each (gold first in every group) and their top-1 agreement."""
    a = np.asarray(f32.rerank_grouped_sync(queries, docs_grouped))
    b = np.asarray(q8.rerank_grouped_sync(queries, docs_grouped))
    drift = np.abs(a - b)
    return {
        "n_queries": len(queries),
        "pairs_per_query": 50,
        "p_true_drift_mean": round(float(drift.mean()), 5),
        "p_true_drift_max": round(float(drift.max()), 5),
        "recall_at_1_of_50_f32": round(float((np.argmax(a, axis=1) == 0).mean()), 4),
        "recall_at_1_of_50_int8": round(float((np.argmax(b, axis=1) == 0).mean()), 4),
        "top1_agreement": round(float((np.argmax(a, axis=1) == np.argmax(b, axis=1)).mean()), 4),
    }
