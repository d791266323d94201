"""Retrieval-quality metrics over labeled (query -> declaration) pairs
(lean_explore_tpu/evaluation.py): the same metrics and rounding, so a
quality number from either package means the same thing.

One kept divergence (ROADMAP C): ``guard_store_vocab`` skips declarations
without an informalization, where the JAX guard hands ``None`` to the
tokenizer and fails with a TypeError.
"""

import asyncio

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
