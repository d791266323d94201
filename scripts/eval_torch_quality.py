"""Retrieval quality of the full pipeline and the rerank cascade through the
PyTorch port.

The port's counterpart of scripts/eval_cascade.py, with its flags: build
the synthetic corpus, embed every informalization with a float32 embedder,
build the index artifacts through the port (or take an existing artifact
directory with --data-dir), load them with a float32 corpus, and measure
recall@1, recall@10 and MRR@10 of ``SearchEngine.search_batch`` over the
held-out eval queries with a float32 reranker: first the full pipeline,
then each cascade point of --points on the same engine
(LEAN_EXPLORE_RERANK_CASCADE set to the point, and popped after), each arm
under eval_cascade.py's label (``cascade_48_25``, ...). Prints one JSON
line: the task, the metrics and the seconds of each stage and arm.

The 200k chain (runs/scale200k; embedder serving length 128 and reranker
rescore length 192, docs/training.md "Config-5 scale" and
runs/scale200k/trunc_probe.json):

    python scripts/eval_torch_quality.py \\
        --embedder runs/scale200k/embedder/checkpoint \\
        --reranker runs/scale200k/reranker/checkpoint \\
        --n-decls 200000 --n-concepts 6000 --body-sentences 5 \\
        --emb-max-length 128 --rr-max-length 192

The chain's committed cascade record (runs/scale200k/cascade_eval.json)
adds ``--points 48,16 48,25 24,8``. Runs on CUDA unless ``--device cpu``.
"""

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from lean_explore_tpu_torch.evaluation import evaluate_engine, guard_store_vocab  # noqa: E402
from lean_explore_tpu_torch.extract.embeddings import generate_embeddings  # noqa: E402
from lean_explore_tpu_torch.extract.index import build_indices  # noqa: E402
from lean_explore_tpu_torch.index.artifacts import load_index_artifacts  # noqa: E402
from lean_explore_tpu_torch.models.store import DeclarationStore  # noqa: E402
from lean_explore_tpu_torch.search.engine import SearchEngine  # noqa: E402
from lean_explore_tpu_torch.train.synthetic import make_corpus  # noqa: E402
from lean_explore_tpu_torch.util.embedding_client import EmbeddingClient  # noqa: E402
from lean_explore_tpu_torch.util.reranker_client import RerankerClient  # noqa: E402

EMBED_BATCH = 256
CASCADE_ENV = "LEAN_EXPLORE_RERANK_CASCADE"
# eval_cascade.py's default sweep, spanning the coverage cliff measured on
# the 22-word corpus.
DEFAULT_POINTS = ("32,16", "32,8", "24,12", "16,12", "12,8", "12,25")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=None,
                        help="also write the report here")
    parser.add_argument("--embedder", type=Path, default=Path("runs/embedder/checkpoint"))
    parser.add_argument("--reranker", type=Path, default=Path("runs/reranker/checkpoint"))
    parser.add_argument("--n-decls", type=int, default=20_000)
    parser.add_argument("--n-concepts", type=int, default=1200)
    parser.add_argument("--n-eval", type=int, default=512)
    parser.add_argument("--rerank-top", type=int, default=50)
    parser.add_argument("--body-sentences", type=int, default=1)
    parser.add_argument("--emb-max-length", "--serve-max-length", type=int, default=64)
    parser.add_argument("--rr-max-length", "--client-max-length", type=int, default=128)
    parser.add_argument(
        "--data-dir", type=Path, default=None,
        help="evaluate an existing artifact directory instead of rebuilding "
        "the index; the corpus flags still make the eval queries and must "
        "match it",
    )
    parser.add_argument(
        "--points", type=str, nargs="+", default=list(DEFAULT_POINTS),
        help="cascade operating points as '<cap>,<keep>'",
    )
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    for p in args.points:  # fail in milliseconds, not after the embed pass
        try:
            cap, keep = (int(x) for x in p.split(","))
            if cap <= 0 or keep <= 0:
                raise ValueError
        except ValueError:
            raise SystemExit(
                f"--points entry {p!r} must be '<cap>,<keep>' positive ints"
            ) from None
    return args


def evaluate_arms(engine, labeled, rerank_top: int, points) -> tuple[dict, dict]:
    """``evaluate_engine`` of the full pipeline, then of each cascade point
    with LEAN_EXPLORE_RERANK_CASCADE set to it; the variable is popped after
    each arm and before the first. Returns the metrics and the seconds of
    each arm, under eval_cascade.py's labels."""
    results, seconds = {}, {}
    arms = [("full_pipeline", None)] + [(f"cascade_{p.replace(',', '_')}", p) for p in points]
    try:
        for label, point in arms:
            if point is None:
                os.environ.pop(CASCADE_ENV, None)
            else:
                os.environ[CASCADE_ENV] = point
            t = time.perf_counter()
            results[label] = evaluate_engine(engine, labeled, rerank_top=rerank_top)
            seconds[label] = time.perf_counter() - t
            log(f"{label}: {json.dumps(results[label])}")
    finally:
        os.environ.pop(CASCADE_ENV, None)
    return results, seconds


def build_index(corpus, embedder, work: Path) -> tuple[DeclarationStore, dict]:
    """Store, embeddings and artifacts of ``corpus`` in ``work``; returns
    the open store and the seconds (and docs/s) of each stage."""
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


def open_engine(work: Path, store, embedder, reranker, device) -> tuple[SearchEngine, float]:
    """A SearchEngine over the artifacts in ``work`` with a float32 corpus
    on ``device``, and the seconds the load took."""
    t = time.perf_counter()
    artifacts = load_index_artifacts(work, dense_dtype="float32", device=device)
    engine = SearchEngine(
        work, store=store, artifacts=artifacts, embedding_client=embedder,
        reranker_client=reranker, device=device,
    )
    return engine, time.perf_counter() - t


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)
    device = torch.device(args.device)
    seconds = {}
    t = time.perf_counter()
    corpus = make_corpus(
        n_decls=args.n_decls, n_concepts=args.n_concepts, n_eval=args.n_eval,
        seed=args.seed, body_sentences=args.body_sentences,
    )
    seconds["corpus"] = time.perf_counter() - t
    t = time.perf_counter()
    embedder = EmbeddingClient(
        str(args.embedder), model_dir=args.embedder, max_length=args.emb_max_length,
        batch_size=EMBED_BATCH, dtype=torch.float32, device=device,
    )
    reranker = RerankerClient(
        str(args.reranker), model_dir=args.reranker, max_length=args.rr_max_length,
        dtype=torch.float32, device=device,
    )
    seconds["clients"] = time.perf_counter() - t

    with tempfile.TemporaryDirectory(prefix="eval_torch_quality_") as tmp:
        if args.data_dir is not None:
            work = args.data_dir
            store = DeclarationStore(work / "declarations.db")
            guard_store_vocab(store, embedder.tokenizer)
        else:
            work = Path(tmp)
            log(f"embedding {args.n_decls} declarations on {device} ...")
            store, built = build_index(corpus, embedder, work)
            seconds.update(built)
        engine, seconds["load"] = open_engine(work, store, embedder, reranker, device)
        results, arm_seconds = evaluate_arms(
            engine, corpus.eval_queries, args.rerank_top, args.points
        )
        seconds["eval"] = arm_seconds.pop("full_pipeline")
        seconds.update({f"eval_{label}": s for label, s in arm_seconds.items()})
        store.close()

    report = {
        "task": {
            "n_decls": args.n_decls, "n_concepts": args.n_concepts,
            "n_eval": args.n_eval, "body_sentences": args.body_sentences,
            "seed": args.seed, "rerank_top": args.rerank_top,
            "points": args.points,
            "emb_max_length": args.emb_max_length,
            "rr_max_length": args.rr_max_length,
            "embedder": str(args.embedder), "reranker": str(args.reranker),
            "data_dir": None if args.data_dir is None else str(args.data_dir),
            "dtype": "float32",
            "device": torch.cuda.get_device_name(device)
            if device.type == "cuda" else "cpu",
        },
        "results": results,
        "seconds": {k: round(v, 3) for k, v in seconds.items()},
    }
    if args.out is not None:
        args.out.write_text(json.dumps(report, indent=2))
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
