"""Rerank-cascade prescreen coverage through the PyTorch port: gold's
stage-1 rank against the token budget.

The port's counterpart of scripts/measure_prescreen_coverage.py, with its
flags and defaults (``--device`` for ``--platform``): ``evaluate_engine``'s
pass of the port's ``SearchEngine.search_batch`` over the labeled eval
queries (batches of 64) records each query's rerank candidates; each cap
of --caps then scores the same groups with the documents cut to that many
suffix tokens, and its row is the share of queries whose gold document
ranks within the top 8, 12, 16 and 25 of that prescreen, and gold's median
rank, over the queries whose candidates hold gold. Writes the report to
--out and prints it as one JSON line.

With --data-dir the measurement runs against an existing artifact
directory, which it never writes or deletes; the corpus flags still make
the labeled queries and must match it. Otherwise the corpus is embedded
and indexed in a temporary directory.

The 200k chain's record (runs/scale200k/prescreen_coverage.json):

    python scripts/measure_torch_prescreen_coverage.py \\
        --embedder runs/scale200k/embedder/checkpoint \\
        --reranker runs/scale200k/reranker/checkpoint \\
        --n-decls 200000 --n-concepts 6000 --body-sentences 5 \\
        --emb-max-length 128 --rr-max-length 192

Runs on CUDA unless ``--device cpu``.
"""

import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from lean_explore_tpu_torch import evaluation  # noqa: E402
from lean_explore_tpu_torch.train.synthetic import make_corpus  # noqa: E402


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=Path("runs/torch_tools/prescreen_coverage.json"))
    parser.add_argument("--embedder", type=Path, default=Path("runs/embedder/checkpoint"))
    parser.add_argument("--reranker", type=Path, default=Path("runs/reranker/checkpoint"))
    parser.add_argument("--n-decls", type=int, default=5000)
    parser.add_argument("--n-concepts", type=int, default=600)
    parser.add_argument("--n-eval", type=int, default=192)
    parser.add_argument("--rerank-top", type=int, default=50)
    parser.add_argument(
        "--body-sentences", type=int, default=1,
        help="body sentences per doc (5 ~= production length, ~110-word docs)",
    )
    parser.add_argument("--emb-max-length", "--serve-max-length", type=int, default=64)
    parser.add_argument("--rr-max-length", "--client-max-length", type=int, default=128)
    parser.add_argument("--caps", type=int, nargs="+", default=[8, 12, 16, 24, 32, 48, 64])
    parser.add_argument(
        "--data-dir", type=Path, default=None,
        help="measure against an existing artifact directory instead of "
        "rebuilding the index; the corpus flags still make the labeled "
        "queries and must match it",
    )
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def coverage_report(args, groups, scored, target_by_query: dict) -> dict:
    """measure_prescreen_coverage.py's report from the captured groups and
    each cap's scores (``evaluation.score_caps``)."""
    return {
        "task": {
            "n_decls": args.n_decls,
            "n_eval": args.n_eval,
            "rerank_top": args.rerank_top,
            "body_sentences": args.body_sentences,
        },
        "doc_words": evaluation.doc_words(groups),
        "caps": {
            cap: evaluation.coverage_row(
                evaluation.gold_stage1_ranks(groups, scored[cap][0], target_by_query),
                scored[cap][1],
            )
            for cap in args.caps
        },
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = torch.device(args.device)
    corpus = make_corpus(
        n_decls=args.n_decls, n_concepts=args.n_concepts, n_eval=args.n_eval,
        seed=args.seed, body_sentences=args.body_sentences,
    )
    embedder, reranker = evaluation.float32_clients(
        args.embedder, args.reranker, args.emb_max_length, args.rr_max_length, device
    )
    with tempfile.TemporaryDirectory(prefix="prescreen_torch_") as tmp:
        engine, store = evaluation.prepare_engine(
            corpus, embedder, reranker, args.data_dir, Path(tmp), device
        )
        groups = evaluation.capture_rerank_groups(
            engine, [q for q, _ in corpus.eval_queries], args.rerank_top, batch=64
        )
        log(f"captured {len(groups)} candidate groups")
        scored = evaluation.score_caps(reranker, groups, args.caps)
        store.close()
    report = coverage_report(args, groups, scored, dict(corpus.eval_queries))
    for cap, row in report["caps"].items():
        log(f"cap={cap}: {json.dumps(row)}")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=2))
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
