"""Shared arithmetic of the per-layer metrics' readers (``metrics/``)."""

from harness import counts
from reference import text


def stage_mean_ms(ctx, stage: str):
    """Mean milliseconds a batch of one engine stage (``StageTimings``), over
    the window's batches outside the profiled stretch."""
    batches = [b for b in ctx.batches if not b.traced]
    if not batches:
        return None
    return sum(b.stages.get(stage, 0.0) for b in batches) / len(batches)


def idle_percent(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us() / ctx.trace.window_us)


def batch_flops(batch, cfg: dict, traffic: dict, tok: text.Tokenizer) -> float:
    """Model FLOPs one engine batch needs: the queries' encode, the dense
    scan, and each query's rerank group: its prefix once, and in each stage
    as many suffixes as the traffic and the configuration ask for
    (``rerank_top``; the cascade's second stage its ``keep``), capped as
    the stage caps them. The suffixes' lengths are those of the documents
    the program handed the stage, so a pool cut short is still counted at
    its full size."""
    m, s = cfg["model"], cfg["serving"]
    total = sum(counts.sequence_flops(m, len(r)) for r in
                text.query_rows(tok, s["query_prompt"], batch.queries, s["embed_max_length"]))
    total += 2.0 * len(batch.queries) * cfg["deployment"]["declarations"] * m["hidden_size"]
    if batch.rerank_outer is None:
        return total
    pool = traffic["rerank_top"]
    cascade = s.get("rerank_cascade")
    for q, docs in zip(batch.queries, batch.rerank_outer[0]):
        if docs:
            _, shared = text.pair_rows(tok, s["instruction"], q, docs, s["rerank_max_length"])
            total += counts.sequence_flops(m, shared)
    for queries, groups, cap, _ in batch.rerank_calls:
        wanted = min(cascade[1], pool) if cascade and cap is None else pool
        for q, docs in zip(queries, groups):
            if not docs:
                continue
            rows, shared = text.pair_rows(tok, s["instruction"], q, docs, s["rerank_max_length"], cap)
            served = sum(counts.suffix_flops(m, shared, len(r) - shared) for r in rows)
            total += served * wanted / len(rows)
    return total
