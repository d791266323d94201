"""Where a rerank cascade point changes the 200k chain's top-1, on the card.

Builds the 200k chain's index through the port as chip_smoke.py phase 6
does (the committed runs/scale200k checkpoints in float32, the chain's
corpus and lengths), then runs ``SearchEngine.search_batch`` over the 512
eval queries in evaluate_engine's batches of 64, first with the full rerank
and then with LEAN_EXPLORE_RERANK_CASCADE set to --point. For every query
whose top-1 is the target in one arm and not in the other, it writes the
query, its target, its candidate documents as the cascade's stage 1 got
them, the stage-1 scores on the card, the keep set they give (Python's
stable sort, as the client), the target's stage-1 rank and its P(true) gap
to the keep boundary, plus the per-arm counts, as one JSON file; with
--closest N only the N queries of smallest gap.

    python3 scripts/dump_cascade_divergence.py --point 24,8 \\
        --out cascade_24_8_divergence.json

runs/scale200k/cascade_24_8_divergence.json is ``closest(report, 8)`` of
such a run; tests/test_torch_rerank_cascade.py holds the port's and the
JAX client's stage-1 keep sets on it to each other and to the card's on the
CPU, and chip_smoke.py phase 6 holds the card's to it.
"""

import argparse
import asyncio
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from lean_explore_tpu_torch.train.synthetic import make_corpus  # noqa: E402
from lean_explore_tpu_torch.util.embedding_client import EmbeddingClient  # noqa: E402
from lean_explore_tpu_torch.util.reranker_client import RerankerClient  # noqa: E402

CASCADE_ENV = "LEAN_EXPLORE_RERANK_CASCADE"


def top1(engine, labeled, rerank_top: int) -> list[str]:
    """Top-1 name of each query, in evaluate_engine's batches of 64."""

    async def run():
        out = []
        for start in range(0, len(labeled), 64):
            chunk = [q for q, _ in labeled[start : start + 64]]
            for ranked in await engine.search_batch(chunk, limit=10, rerank_top=rerank_top):
                out.append(ranked[0].name if ranked else "")
        return out

    return asyncio.run(run())


def closest(report: dict, n: int) -> dict:
    """``report`` with only its ``n`` queries of smallest gap between the
    target's stage-1 score and the keep boundary."""
    rows = sorted(
        report["queries"], key=lambda r: float("inf") if r["gap"] is None else r["gap"]
    )[:n]
    return {**report, "queries": sorted(rows, key=lambda r: r["index"])}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--point", default="24,8")
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--closest", type=int, default=None)
    args = parser.parse_args(argv)
    cap, keep = (int(x) for x in args.point.split(","))
    device = torch.device(args.device)
    embedder_dir, reranker_dir = chip_smoke.chain_checkpoints(REPO)
    script = chip_smoke.load_script(REPO, "eval_torch_quality")
    corpus = make_corpus(**chip_smoke.CHAIN_CORPUS)
    labeled = corpus.eval_queries
    embedder = EmbeddingClient(
        str(embedder_dir), max_length=chip_smoke.CHAIN_EMB_MAX_LENGTH,
        batch_size=script.EMBED_BATCH, dtype=torch.float32, device=device,
    )
    reranker = RerankerClient(
        str(reranker_dir), max_length=chip_smoke.CHAIN_RR_MAX_LENGTH,
        dtype=torch.float32, device=device,
    )
    stage1 = []
    real = reranker.rerank_grouped_sync

    def spy(queries, docs_grouped, **kw):
        scores = real(queries, docs_grouped, **kw)
        if kw.get("suffix_cap") is not None:
            stage1.extend(zip(queries, docs_grouped, scores))
        return scores

    reranker.rerank_grouped_sync = spy
    with tempfile.TemporaryDirectory(prefix="cascade_divergence_") as tmp:
        t = time.perf_counter()
        store, _ = script.build_index(corpus, embedder, Path(tmp))
        engine, _ = script.open_engine(Path(tmp), store, embedder, reranker, device)
        print(f"index built in {time.perf_counter() - t:.1f} s", file=sys.stderr)
        os.environ.pop(CASCADE_ENV, None)
        full = top1(engine, labeled, chip_smoke.CHAIN_RERANK_TOP)
        os.environ[CASCADE_ENV] = args.point
        try:
            cascade = top1(engine, labeled, chip_smoke.CHAIN_RERANK_TOP)
        finally:
            os.environ.pop(CASCADE_ENV, None)
        store.close()
    if len(stage1) != len(labeled):
        raise SystemExit(f"stage 1 saw {len(stage1)} groups for {len(labeled)} queries")
    rows = []
    for i, ((query, target), f, c) in enumerate(zip(labeled, full, cascade)):
        if (f == target) == (c == target):
            continue
        q, docs, scores = stage1[i]
        if q != query:
            raise SystemExit(f"stage 1's group {i} is {q!r}, not {query!r}")
        order = sorted(range(len(docs)), key=lambda j: scores[j], reverse=True)
        gold = [j for j, doc in enumerate(docs) if doc.startswith(f"{target}:")]
        rank = order.index(gold[0]) if gold else None
        if rank is None:
            gap = None
        elif rank < keep:
            gap = scores[gold[0]] - scores[order[keep]]
        else:
            gap = scores[order[keep - 1]] - scores[gold[0]]
        rows.append({
            "index": i, "query": query, "target": target, "full_top1": f,
            "cascade_top1": c, "documents": docs, "stage1_scores": scores,
            "keep": order[:keep], "target_rank": rank, "gap": gap,
        })
    report = {
        "point": args.point, "cap": cap, "keep": keep,
        "rr_max_length": chip_smoke.CHAIN_RR_MAX_LENGTH,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "n_queries": len(labeled),
        "full_hits_at_1": sum(f == t for (_, t), f in zip(labeled, full)),
        "cascade_hits_at_1": sum(c == t for (_, t), c in zip(labeled, cascade)),
        "lost": sum(r["full_top1"] == r["target"] for r in rows),
        "gained": sum(r["cascade_top1"] == r["target"] for r in rows),
        "queries": rows,
    }
    if args.closest is not None:
        report = closest(report, args.closest)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report))
    print(json.dumps({k: v for k, v in report.items() if k != "queries"}))


if __name__ == "__main__":
    main()
