"""Int8 effects on trained geometry through the PyTorch port: dense recall
and reranker drift.

The port's counterpart of scripts/measure_int8_effects.py, with its flags
and defaults (``--device`` for ``--platform``):

1. dense: the synthetic corpus embedded with the float32 embedder (length
   64) and the first --n-queries eval queries; recall@10 against the exact
   scan of the plain bin-max scan (``fused_f32_vs_exact``) and of the corpus
   quantized per row (``int8_vs_exact``: the int8 kernel on the card, the
   exact quantized scan on the CPU);
2. reranker: each of those queries with its target's document and 49
   held-out distractors, scored by the float32 and the W8A8 int8 reranker
   (length 128): P(true) drift, recall@1-of-50 of each and their top-1
   agreement.

Writes the report to --out and prints it as one JSON line. Runs on CUDA
unless ``--device cpu``.

    python scripts/measure_torch_int8_effects.py  # runs/int8_effects.json's arguments
"""

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from lean_explore_tpu_torch import evaluation  # noqa: E402
from lean_explore_tpu_torch.train.synthetic import make_corpus  # noqa: E402
from lean_explore_tpu_torch.util.reranker_client import RerankerClient  # noqa: E402

# measure_int8_effects.py's serving lengths.
EMB_MAX_LENGTH, RR_MAX_LENGTH = 64, 128


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=Path("runs/torch_tools/int8_effects.json"))
    parser.add_argument("--embedder", type=Path, default=Path("runs/embedder/checkpoint"))
    parser.add_argument("--reranker", type=Path, default=Path("runs/reranker/checkpoint"))
    parser.add_argument("--n-decls", type=int, default=20_000)
    parser.add_argument("--n-concepts", type=int, default=1200)
    parser.add_argument("--n-eval", type=int, default=512)
    parser.add_argument("--n-queries", type=int, default=128)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def measure(embedder, f32, q8, corpus, n_queries: int, seed: int, corpus_mat=None) -> dict:
    """Both halves of the report. ``corpus_mat`` is the corpus's embedding
    matrix on the embedder's device when the caller has it."""
    if corpus_mat is None:
        corpus_mat = embedder.embed_device(
            [d.informalization for d in corpus.declarations], is_query=False
        )
    q_vecs = embedder.embed_device([q for q, _ in corpus.eval_queries[:n_queries]], is_query=True)
    dense = evaluation.dense_int8_recall(corpus_mat, q_vecs)
    log(f"dense recall@10: {json.dumps(dense['recall_at_10'])}")
    queries, docs_grouped = evaluation.direct_eval_groups(corpus, n_queries, seed)
    drift = evaluation.reranker_int8_drift(f32, q8, queries, docs_grouped)
    log(json.dumps(drift))
    return {"dense_trained_geometry": dense, "reranker_int8_drift": drift}


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = torch.device(args.device)
    corpus = make_corpus(
        n_decls=args.n_decls, n_concepts=args.n_concepts, n_eval=args.n_eval, seed=args.seed,
    )
    log("embedding the corpus with the trained embedder ...")
    embedder, f32 = evaluation.float32_clients(
        args.embedder, args.reranker, EMB_MAX_LENGTH, RR_MAX_LENGTH, device
    )
    q8 = RerankerClient(
        str(args.reranker), model_dir=args.reranker, max_length=RR_MAX_LENGTH,
        dtype="int8", device=device,
    )
    report = measure(embedder, f32, q8, corpus, args.n_queries, args.seed)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=2))
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
