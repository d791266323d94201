"""Retrieval-quality harness of the PyTorch port: recall@k and MRR of the
hybrid engine on labeled (query -> declaration) pairs, with the dense-only
and BM25-only ablations.

The port's counterpart of scripts/eval_retrieval.py, with its flags and
defaults (and ``--device``). Two modes:

    python scripts/eval_torch_retrieval.py                 # synthetic corpus
    python scripts/eval_torch_retrieval.py --data-dir DIR \\
        --queries-file queries.jsonl                       # real artifacts

queries.jsonl lines: {"query": "...", "target": "Decl.name"}.

- Synthetic mode builds an N-declaration corpus whose embeddings are noisy
  copies of their queries' (query i's target is declaration i), served
  with a vector embedder and no reranker: ``hybrid``, ``dense_only`` and
  ``bm25_only``, each at rerank_top 0, as eval_retrieval.py measures them.
- With --data-dir, ``SearchEngine(DIR)`` with the clients the environment
  configures (LEAN_EXPLORE_EMBEDDING_MODEL, LEAN_EXPLORE_RERANKER_MODEL,
  their max lengths, LEAN_EXPLORE_CORPUS_DTYPE): ``hybrid`` is the full
  serving path, rerank included, as in eval_retrieval.py; ``dense_only``
  and ``bm25_only`` are its ablations at rerank_top 0, which the JAX
  script does not run in this mode.

Prints one JSON line with recall@1, recall@10 and MRR@10 per
configuration; --min-recall10 exits 1 when hybrid recall@10 falls below
it. Runs on CUDA unless ``--device cpu``.
"""

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from lean_explore_tpu_torch.evaluation import evaluate_engine  # noqa: E402
from lean_explore_tpu_torch.index.artifacts import (  # noqa: E402
    build_index_artifacts,
    load_index_artifacts,
)
from lean_explore_tpu_torch.models.store import Declaration, DeclarationStore  # noqa: E402
from lean_explore_tpu_torch.search.engine import SearchEngine  # noqa: E402
from lean_explore_tpu_torch.util.embedding_client import EmbeddingResponse  # noqa: E402

ABLATIONS = {
    "dense_only": dict(bm25_k=0, rerank_top=0),
    "bm25_only": dict(dense_k=0, rerank_top=0),
}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def build_synthetic(n: int, dim: int, noise: float, tmp: str, seed: int = 0):
    """eval_retrieval.py's corpus and queries in ``tmp``: query i's target
    is declaration i, its vector the declaration's plus ``noise``."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, dim)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    words = [f"w{i}" for i in range(2000)]

    store = DeclarationStore(f"{tmp}/declarations.db", create=True)
    rows = []
    for i in range(n):
        # The word is a name component of its own, so the lexical signal is
        # informative as with real Lean names; about n/2000 share it.
        name = f"Pkg{i % 5}.ns{i % 31}.{words[i % 2000]}_{i}"
        rows.append(
            Declaration(
                name=name,
                module=f"Pkg{i % 5}.Mod{i % 17}",
                source_text=f"def {name} := x{i}",
                source_link=f"https://example/{i}",
                dependencies=None,
                informalization=f"**Thing {i}.** about {words[i % 2000]} "
                f"and {words[(i * 3) % 2000]}",
                informalization_embedding=base[i].tolist(),
            )
        )
        if len(rows) == 5000:
            store.insert_many(rows)
            rows = []
    if rows:
        store.insert_many(rows)
    build_index_artifacts(store, tmp)

    query_vecs = base + noise * rng.standard_normal((n, dim)).astype(np.float32)
    query_vecs /= np.linalg.norm(query_vecs, axis=1, keepdims=True)
    labeled = [
        # The query shares tokens with its target's informalization, so the
        # lexical signal is informative too.
        (f"{words[i % 2000]} thing number {(i * 7) % 50}",
         f"Pkg{i % 5}.ns{i % 31}.{words[i % 2000]}_{i}")
        for i in range(n)
    ]
    return store, query_vecs, labeled


class VectorEmbedder:
    """Maps each query string to its precomputed evaluation vector."""

    def __init__(self, mapping: dict[str, np.ndarray], dim: int, device):
        self.mapping = mapping
        self.dim = dim
        self.device = torch.device(device)

    def embed_device(self, texts, is_query=False) -> torch.Tensor:
        out = np.stack([self.mapping.get(t, np.zeros(self.dim, np.float32)) for t in texts])
        return torch.from_numpy(out).to(self.device)

    async def embed(self, texts, is_query=False) -> EmbeddingResponse:
        vecs = self.embed_device(texts, is_query).cpu().numpy()
        return EmbeddingResponse(texts=list(texts), embeddings=vecs.tolist(), model="eval")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=20_000, help="synthetic corpus size")
    parser.add_argument("--dim", type=int, default=256)
    parser.add_argument("--noise", type=float, default=0.35,
                        help="query-vs-target embedding noise")
    parser.add_argument("--queries", type=int, default=512,
                        help="labeled queries to evaluate")
    parser.add_argument("--data-dir", type=str, default=None,
                        help="evaluate real artifacts instead of synthetic")
    parser.add_argument("--queries-file", type=str, default=None,
                        help="jsonl of {query, target} for --data-dir mode")
    parser.add_argument("--min-recall10", type=float, default=None,
                        help="quality gate: exit 1 if hybrid recall@10 "
                             "falls below this floor")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.data_dir and not args.queries_file:
        parser.error("--queries-file is required with --data-dir")
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = torch.device(args.device)
    with tempfile.TemporaryDirectory(prefix="eval_torch_retrieval_") as tmp:
        if args.data_dir:
            labeled = [
                (row["query"], row["target"])
                for row in map(json.loads, Path(args.queries_file).read_text().splitlines())
            ]
            engine = SearchEngine(args.data_dir, device=device)
            configs = {"hybrid": dict(), **ABLATIONS}
        else:
            log(f"building synthetic corpus (n={args.n}, dim={args.dim}) ...")
            store, query_vecs, labeled_all = build_synthetic(args.n, args.dim, args.noise, tmp)
            picks = np.random.default_rng(1).choice(len(labeled_all), size=args.queries,
                                                    replace=False)
            labeled = [labeled_all[i] for i in picks]
            embedder = VectorEmbedder(
                {labeled_all[i][0]: query_vecs[i] for i in picks}, args.dim, device
            )
            engine = SearchEngine(
                tmp, store=store, artifacts=load_index_artifacts(tmp, device=device),
                embedding_client=embedder, device=device,
            )
            # rerank_top 0: synthetic vectors and no reranker measure the
            # retrieval geometry (dense, BM25, fusion) only.
            configs = {"hybrid": dict(rerank_top=0), **ABLATIONS}
        report = {}
        for label, overrides in configs.items():
            log(f"evaluating {label} ...")
            report[label] = evaluate_engine(engine, labeled, **overrides)
        engine.store.close()
    print(json.dumps(report))
    if args.min_recall10 is not None:
        got = report["hybrid"]["recall_at_10"]
        if got < args.min_recall10:
            log(f"QUALITY GATE FAILED: hybrid recall@10 {got:.4f} < floor {args.min_recall10:.4f}")
            sys.exit(1)
        log(f"quality gate ok: hybrid recall@10 {got:.4f} >= {args.min_recall10:.4f}")
    return report


if __name__ == "__main__":
    main()
