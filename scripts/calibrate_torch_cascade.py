"""Label-free rerank-cascade calibration through the PyTorch port: pick the
prescreen cap from query strings alone.

The port's counterpart of scripts/calibrate_cascade.py, with its flags and
defaults (``--device`` for ``--platform``): for the eval queries of the
synthetic corpus (their labels unused), one serving pass of the port's
``SearchEngine.search_batch`` records each query's rerank candidates and
their full-length scores; each cap of --caps then scores the same groups
with the documents cut to that many suffix tokens, and its row is the
share of groups whose full-length top-1 (``containment_top1``) and top-3
(``containment_top3``) survive the prescreen's top-``keep``, and the
overlap of the two top-``keep`` sets. The recommended cap is the smallest
whose containment_top1 clears --top1-floor. Writes the report to --out and
prints the JSON line calibrate_cascade.py prints.

With --data-dir the calibration runs against an existing artifact
directory (declarations.db and the index), which it never writes or
deletes; the corpus flags still make the probe queries and must match it.
Otherwise the corpus is embedded and indexed in a temporary directory.

The 200k chain's record (runs/scale200k/cascade_calibration.json):

    python scripts/calibrate_torch_cascade.py \\
        --embedder runs/scale200k/embedder/checkpoint \\
        --reranker runs/scale200k/reranker/checkpoint \\
        --n-decls 200000 --n-concepts 6000 --body-sentences 5 --keep 16 \\
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
    parser.add_argument("--out", type=Path, default=Path("runs/torch_tools/cascade_calibration.json"))
    parser.add_argument("--embedder", type=Path, default=Path("runs/embedder/checkpoint"))
    parser.add_argument("--reranker", type=Path, default=Path("runs/reranker/checkpoint"))
    parser.add_argument("--n-decls", type=int, default=5000)
    parser.add_argument("--n-concepts", type=int, default=600)
    parser.add_argument("--n-queries", type=int, default=192)
    parser.add_argument("--rerank-top", type=int, default=50)
    parser.add_argument("--keep", type=int, default=8)
    parser.add_argument("--body-sentences", type=int, default=1)
    parser.add_argument("--emb-max-length", "--serve-max-length", type=int, default=64)
    parser.add_argument("--rr-max-length", "--client-max-length", type=int, default=128)
    parser.add_argument("--caps", type=int, nargs="+", default=[8, 16, 24, 32, 48, 64, 96])
    parser.add_argument("--top1-floor", type=float, default=0.95)
    parser.add_argument(
        "--data-dir", type=Path, default=None,
        help="calibrate against an existing artifact directory instead of "
        "rebuilding the index; the corpus flags still make the probe queries "
        "and must match it",
    )
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def calibration_report(args, groups, scored) -> dict:
    """calibrate_cascade.py's report from the captured groups and each
    cap's scores (``evaluation.score_caps``)."""
    caps = {
        cap: evaluation.calibration_row(groups, scored[cap][0], args.keep, scored[cap][1])
        for cap in args.caps
    }
    return {
        "task": {
            "n_decls": args.n_decls,
            "n_queries": len(groups),
            "rerank_top": args.rerank_top,
            "keep": args.keep,
            "body_sentences": args.body_sentences,
            "top1_floor": args.top1_floor,
            "labels_used": False,
        },
        "doc_words": evaluation.doc_words(groups),
        "caps": caps,
        "recommended_cap": evaluation.recommended_cap(caps, args.top1_floor),
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = torch.device(args.device)
    corpus = make_corpus(
        n_decls=args.n_decls, n_concepts=args.n_concepts, n_eval=args.n_queries,
        seed=args.seed, body_sentences=args.body_sentences,
    )
    # Labels are not used: only the query strings. A deployment puts a
    # sample of its own users' queries here.
    queries = [q for q, _ in corpus.eval_queries]
    embedder, reranker = evaluation.float32_clients(
        args.embedder, args.reranker, args.emb_max_length, args.rr_max_length, device
    )
    with tempfile.TemporaryDirectory(prefix="calibrate_torch_") as tmp:
        engine, store = evaluation.prepare_engine(
            corpus, embedder, reranker, args.data_dir, Path(tmp), device
        )
        groups = evaluation.capture_rerank_groups(engine, queries, args.rerank_top)
        log(f"captured {len(groups)} candidate groups")
        scored = evaluation.score_caps(reranker, groups, args.caps)
        store.close()
    report = calibration_report(args, groups, scored)
    for cap, row in report["caps"].items():
        log(f"cap={cap}: {json.dumps(row)}")
    log(f"recommended cap: {report['recommended_cap']}")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=2))
    print(json.dumps({"recommended_cap": report["recommended_cap"], "caps": report["caps"]}))
    return report


if __name__ == "__main__":
    main()
