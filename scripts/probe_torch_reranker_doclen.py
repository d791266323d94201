"""Probe a trained reranker's gold-pair scores across document caps through
the PyTorch port.

The port's counterpart of scripts/probe_reranker_doclen.py, with its flags
and defaults (and ``--device``): the first --queries held-out eval queries
of the synthetic corpus, each scored against its gold document at full
length, at each doc-token cap of --caps (``RerankerClient._truncate_docs``,
the serving truncation) and against a full-length held-out distractor
drawn with ``default_rng(seed + 2)``, for each float32 checkpoint of
--checkpoints at --max-length; each arm's mean and median P(true) and the
share above 0.5. Prints each arm's line and, with --report, writes the
report.

    python scripts/probe_torch_reranker_doclen.py \\
        --checkpoints runs/scale200k/reranker/checkpoint \\
        --report probe.json  # runs/scale200k/trunc_probe.json's arguments

Runs on CUDA unless ``--device cpu``.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from lean_explore_tpu_torch.train.synthetic import make_corpus, reranker_document  # noqa: E402
from lean_explore_tpu_torch.util.reranker_client import RerankerClient  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checkpoints", type=Path, nargs="+", required=True)
    # The corpus flags must match the training run, so that the held-out
    # queries are the run's.
    parser.add_argument("--n-decls", type=int, default=200_000)
    parser.add_argument("--n-concepts", type=int, default=6000)
    parser.add_argument("--n-eval", type=int, default=512)
    parser.add_argument("--body-sentences", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--queries", type=int, default=64)
    parser.add_argument("--caps", type=int, nargs="+", default=(96, 64, 48, 24))
    parser.add_argument("--max-length", type=int, default=192)
    parser.add_argument("--report", type=Path, default=None)
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def probe_pairs(corpus, n_queries: int, seed: int):
    """The held-out queries, their gold documents and one full-length
    distractor each."""
    name_to_idx = {d.name: i for i, d in enumerate(corpus.declarations)}
    rng = np.random.default_rng(seed + 2)
    queries, golds = [], []
    for q, target in corpus.eval_queries[:n_queries]:
        queries.append(q)
        golds.append(reranker_document(corpus.declarations[name_to_idx[target]]))
    hold = (corpus.n_train, len(corpus.declarations))
    distractors = [
        reranker_document(corpus.declarations[int(rng.integers(*hold))]) for _ in queries
    ]
    return queries, golds, distractors


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = torch.device(args.device)
    corpus = make_corpus(
        n_decls=args.n_decls, n_concepts=args.n_concepts, n_eval=args.n_eval,
        seed=args.seed, body_sentences=args.body_sentences,
    )
    queries, golds, distractors = probe_pairs(corpus, args.queries, args.seed)
    task = {k: v for k, v in vars(args).items() if k != "device"}
    report: dict = {
        "task": task | {"checkpoints": [str(c) for c in args.checkpoints], "report": None,
                        "caps": list(args.caps)},
        "results": {},
    }
    for ckpt in args.checkpoints:
        client = RerankerClient(
            str(ckpt), model_dir=ckpt, max_length=args.max_length, dtype=torch.float32,
            device=device,
        )
        arms = [("full", golds)]
        arms += [(f"cap{c}", client._truncate_docs(golds, c)) for c in args.caps]
        arms.append(("distractor_full", distractors))
        rows = {}
        for label, docs in arms:
            scores = np.concatenate(client.rerank_grouped_sync(queries, [[d] for d in docs]))
            rows[label] = {
                "mean": round(float(scores.mean()), 4),
                "median": round(float(np.median(scores)), 4),
                "frac_true": round(float((scores > 0.5).mean()), 4),
            }
            print(f"{ckpt} {label:16s} {rows[label]}")
        report["results"][str(ckpt)] = rows
    if args.report:
        args.report.write_text(json.dumps(report, indent=1))
        print(f"wrote {args.report}")
    return report


if __name__ == "__main__":
    main()
