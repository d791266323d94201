"""Retrieval quality against rerank_top through the PyTorch port: how many
candidates the cross-encoder must rescore.

The port's counterpart of scripts/eval_rerank_top.py, with its flags and
defaults (``--device`` for ``--platform``): recall@1, recall@10 and MRR@10
of ``evaluate_engine`` on the port's engine with float32 clients for each
rerank_top of --rerank-tops, each without and then with the rerank cascade
(LEAN_EXPLORE_RERANK_CASCADE set to --cascade, unset after each arm), under
eval_rerank_top.py's labels (``top50``, ``top50_cascade_32_8``, ...).
Writes the report to --out and prints the results as one JSON line.

With --data-dir the sweep runs against an existing artifact directory,
which it never writes or deletes; the corpus flags still make the labeled
queries and must match it. Otherwise the corpus is embedded and indexed in
a temporary directory.

The 200k chain's record (runs/scale200k/rerank_top_eval.json, the
chain's calibrated point 48,25):

    python scripts/eval_torch_rerank_top.py \\
        --embedder runs/scale200k/embedder/checkpoint \\
        --reranker runs/scale200k/reranker/checkpoint \\
        --n-decls 200000 --n-concepts 6000 --body-sentences 5 \\
        --emb-max-length 128 --rr-max-length 192 --cascade 48,25

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
    parser.add_argument("--out", type=Path, default=Path("runs/torch_tools/rerank_top_eval.json"))
    parser.add_argument("--embedder", type=Path, default=Path("runs/embedder/checkpoint"))
    parser.add_argument("--reranker", type=Path, default=Path("runs/reranker/checkpoint"))
    parser.add_argument("--n-decls", type=int, default=20_000)
    parser.add_argument("--n-concepts", type=int, default=1200)
    parser.add_argument("--n-eval", type=int, default=512)
    parser.add_argument("--rerank-tops", type=int, nargs="+", default=[50, 25, 16, 8])
    parser.add_argument(
        "--cascade", type=str, default="32,8",
        help="cascade point '<cap>,<keep>' of the second arm at each rerank_top "
        "(the chain's calibrated point: scripts/calibrate_torch_cascade.py)",
    )
    parser.add_argument(
        "--data-dir", type=Path, default=None,
        help="evaluate an existing artifact directory instead of rebuilding the "
        "index; the corpus flags still make the labeled queries and must match it",
    )
    parser.add_argument("--body-sentences", type=int, default=1)
    parser.add_argument("--emb-max-length", type=int, default=64)
    parser.add_argument("--rr-max-length", type=int, default=128)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


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
    with tempfile.TemporaryDirectory(prefix="rerank_top_torch_") as tmp:
        engine, store = evaluation.prepare_engine(
            corpus, embedder, reranker, args.data_dir, Path(tmp), device
        )
        results = evaluation.evaluate_rerank_tops(
            engine, corpus.eval_queries, args.rerank_tops, args.cascade, log=log
        )
        store.close()
    report = {
        "task": {
            "n_decls": args.n_decls, "n_eval": args.n_eval,
            "body_sentences": args.body_sentences, "cascade": args.cascade,
            "data_dir": None if args.data_dir is None else str(args.data_dir),
        },
        "results": results,
    }
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=2))
    print(json.dumps(results))
    return report


if __name__ == "__main__":
    main()
