"""Retrieval quality by query class through the PyTorch port: which signal
wins which kind of query.

The port's counterpart of scripts/eval_query_classes.py, with its flags
and defaults (``--device`` for ``--platform``): the synthetic corpus at the
committed 20k runs' arguments, embedded at length 64 with the float32
embedder and indexed in a temporary directory, then ``evaluate_engine`` of
four engine configurations (BM25 alone, dense alone, both without the
rerank, and the full pipeline at --rerank-top with the float32 reranker at
length 128) on four query classes: the semantic eval queries and the three
name classes of ``train.synthetic.make_name_queries`` (exact names, spaced
name fragments, names with one typo), drawn with ``default_rng(seed + 3)``.

- name_exact / name_fragment: BM25 over the raw / spaced name index;
- name_typo: the fuzzy-name boost;
- semantic: the trained embedder and reranker.

Writes the report to ``<out>/eval.json`` (and --report) and prints the
results as one JSON line. Runs on CUDA unless ``--device cpu``.

    python scripts/eval_torch_query_classes.py  # runs/query_classes/eval.json's arguments
"""

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from lean_explore_tpu_torch import evaluation  # noqa: E402
from lean_explore_tpu_torch.train.synthetic import make_corpus, make_name_queries  # noqa: E402

# eval_query_classes.py's serving lengths.
EMB_MAX_LENGTH, RR_MAX_LENGTH = 64, 128


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=Path("runs/torch_tools/query_classes"))
    parser.add_argument("--report", type=Path, default=None)
    parser.add_argument("--embedder", type=Path, default=Path("runs/embedder/checkpoint"))
    parser.add_argument("--reranker", type=Path, default=Path("runs/reranker/checkpoint"))
    # The corpus flags must match the checkpoints' training runs.
    parser.add_argument("--n-decls", type=int, default=20_000)
    parser.add_argument("--n-concepts", type=int, default=1200)
    parser.add_argument("--n-eval", type=int, default=512)
    parser.add_argument("--n-per-class", type=int, default=128)
    parser.add_argument("--rerank-top", type=int, default=50)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def query_sets(corpus, seed: int, n_per_class: int) -> dict:
    """The semantic eval queries and the three name classes."""
    return {
        "semantic": corpus.eval_queries,
        **make_name_queries(corpus, np.random.default_rng(seed + 3), n_per_class=n_per_class),
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    for ckpt in (args.embedder, args.reranker):
        if not (ckpt / "model.safetensors").exists():
            sys.exit(f"missing checkpoint: {ckpt}")
    device = torch.device(args.device)
    log(f"building corpus (n={args.n_decls}) ...")
    corpus = make_corpus(
        n_decls=args.n_decls, n_concepts=args.n_concepts, n_eval=args.n_eval, seed=args.seed,
    )
    sets = query_sets(corpus, args.seed, args.n_per_class)
    embedder, reranker = evaluation.float32_clients(
        args.embedder, args.reranker, EMB_MAX_LENGTH, RR_MAX_LENGTH, device
    )
    with tempfile.TemporaryDirectory(prefix="query_classes_torch_") as tmp:
        engine, store = evaluation.prepare_engine(
            corpus, embedder, reranker, None, Path(tmp), device
        )
        results = evaluation.evaluate_query_classes(engine, sets, args.rerank_top, log=log)
        store.close()
    report = {
        "task": {
            "n_decls": args.n_decls,
            "query_sets": {k: len(v) for k, v in sets.items()},
            "embedder": str(args.embedder),
            "reranker": str(args.reranker),
        },
        "results": results,
    }
    payload = json.dumps(report, indent=2)
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "eval.json").write_text(payload)
    if args.report:
        args.report.write_text(payload)
    print(json.dumps(results))
    return report


if __name__ == "__main__":
    main()
