"""Train the cross-encoder reranker with the PyTorch port, then serve and
evaluate the full pipeline.

The port's counterpart of scripts/train_reranker_e2e.py, with its flags
(``--device`` in place of ``--platform``: CUDA unless ``--device cpu``):
rebuild the synthetic corpus the embedder was trained on (deterministic
from the seed), train a Qwen3-architecture cross-encoder on labeled
(query, document, match?) triples with concept-overlap hard negatives and
AdamW on a warmup-cosine schedule, export the random init and the trained
weights as HF checkpoints, measure the reranker alone (each held-out
query's target against 49 held-out distractors), then embed the corpus
with --embedder and evaluate the hybrid pipeline (dense + BM25 + RRF +
dependency boost + rerank fusion) against its ablations.

The run starts from the JAX script's own init at the same --seed
(``init_train_state``'s "threefry" draw). The committed quality target
is the JAX package's run (runs/reranker/eval.json: 20,000 declarations,
1,200 concepts, 512 held-out queries, hidden 256 x 4 layers, 4000 steps,
the embedder of runs/embedder): direct recall@1 of 50 0.832 trained
against 0.0312 random; full_pipeline_trained recall@1 0.8105, recall@10
0.9902, MRR@10 0.8944; full_pipeline_random_rerank recall@1 0.3164.
Those arguments, on an embedder trained by
scripts/train_torch_embedder_e2e.py:

    python scripts/train_torch_reranker_e2e.py --out runs/torch_reranker \\
        --embedder runs/torch_embedder/checkpoint --steps 4000

(chip_smoke.py's phase 7 runs them on the card). A CPU miniature:

    python scripts/train_torch_reranker_e2e.py --out /tmp/run \\
        --embedder runs/embedder/checkpoint --n-decls 200 --n-concepts 48 \\
        --n-eval 32 --steps 400 --batch-size 32 --hidden-size 64 \\
        --num-layers 2 --rerank-top 20 --no-name-variants --device cpu

Under ``torchrun --nproc-per-node N`` the N ranks train data-parallel on
the JAX script's (N, 1) mesh (``train.e2e.train_mesh``) on the same global
batches; rank 0 evaluates and writes, the others write under
``<out>/rank<r>`` and stop after training. One rank runs as above.

Writes eval.json (the JAX script's keys) and timing.json (pairs/s, the
loader's share of a step, peak memory, embedding docs/s, seconds a stage)
under --out, and prints the direct and pipeline results as one JSON line.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from lean_explore_tpu_torch.evaluation import evaluate_engine  # noqa: E402
from lean_explore_tpu_torch.models.tokenizer import load_tokenizer  # noqa: E402
from lean_explore_tpu_torch.train import (  # noqa: E402
    CrossEncoderDataLoader,
    init_train_state,
    make_ce_train_step,
    make_optimizer,
)
from lean_explore_tpu_torch.train import e2e  # noqa: E402
from lean_explore_tpu_torch.train.cross_encoder import format_pair  # noqa: E402
from lean_explore_tpu_torch.train.e2e import log  # noqa: E402
from lean_explore_tpu_torch.train.export import export_hf_checkpoint  # noqa: E402
from lean_explore_tpu_torch.train.synthetic import (  # noqa: E402
    build_wordlevel_tokenizer,
    make_corpus,
    make_reranker_examples,
    reranker_document,
)
from lean_explore_tpu_torch.util.embedding_client import EmbeddingClient  # noqa: E402
from lean_explore_tpu_torch.util.platform import resolve_device  # noqa: E402
from lean_explore_tpu_torch.util.reranker_client import RerankerClient  # noqa: E402

EMBED_BATCH = 256
DISTRACTORS = 49


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=Path("runs/torch_reranker"))
    parser.add_argument("--report", type=Path, default=None)
    parser.add_argument("--embedder", type=Path, default=Path("runs/embedder/checkpoint"),
                        help="trained embedder checkpoint "
                        "(scripts/train_torch_embedder_e2e.py)")
    # Corpus args must match the embedder run so the task is identical.
    parser.add_argument("--n-decls", type=int, default=20_000)
    parser.add_argument("--n-concepts", type=int, default=1200)
    parser.add_argument("--n-eval", type=int, default=512)
    parser.add_argument("--steps", type=int, default=3000)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--learning-rate", type=float, default=3e-4)
    parser.add_argument("--hidden-size", type=int, default=256)
    parser.add_argument("--num-layers", type=int, default=4)
    parser.add_argument("--max-length", type=int, default=96)
    parser.add_argument("--body-sentences", type=int, default=1,
                        help="body sentences per document (5 ~= production-length "
                        "~110-word docs; raise --max-length, --client-max-length "
                        "and --serve-max-length too)")
    parser.add_argument("--client-max-length", "--rr-max-length", type=int, default=128,
                        help="RerankerClient pair max_length at the direct and "
                        "pipeline evals")
    parser.add_argument("--serve-max-length", "--emb-max-length", type=int, default=64,
                        help="EmbeddingClient max_length for corpus embedding")
    parser.add_argument("--rerank-top", type=int, default=50)
    parser.add_argument("--truncation-augment", type=float, default=0.0,
                        help="probability of truncating an example's document to a "
                        "random token cap (measured negative; off by default)")
    parser.add_argument("--truncation-caps", type=int, nargs=2, default=(24, 96),
                        metavar=("LO", "HI"),
                        help="random cap range for --truncation-augment")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no-name-variants", action="store_true",
                        help="train on name+title query forms only")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a GPU) or cpu")
    return parser.parse_args(argv)


def build_tokenizer(corpus, out: Path):
    """The reranker's WordLevel tokenizer: corpus texts, the pair template
    and the scored true/false tokens (neither may be <unk>). Returns (its
    directory, the tokenizer, the true and false ids)."""
    tok_dir = build_wordlevel_tokenizer(
        corpus.texts(), out / "tokenizer", extra_texts=(format_pair("q", "d"), "true false"),
    )
    tokenizer = load_tokenizer(tok_dir)
    ids = []
    for tok in ("true", "false"):
        tid = tokenizer.convert_tokens_to_ids(tok)
        if tid is None or tid == tokenizer.unk_token_id:
            raise ValueError(f"the reranker tokenizer has no {tok!r} token")
        ids.append(int(tid))
    return tok_dir, tokenizer, ids[0], ids[1]


def distractor_groups(corpus, seed: int) -> tuple[list[str], list[list[str]]]:
    """The direct metric's groups: each eval query with its target's
    document first, then DISTRACTORS held-out documents drawn (never the
    target) by ``default_rng(seed + 2)``."""
    name_to_idx = {d.name: i for i, d in enumerate(corpus.declarations)}
    holdout = (corpus.n_train, len(corpus.declarations))
    rng = np.random.default_rng(seed + 2)
    queries, groups = [], []
    for q, target in corpus.eval_queries:
        ti = name_to_idx[target]
        distractors = []
        while len(distractors) < DISTRACTORS:
            j = int(rng.integers(*holdout))
            if j != ti:
                distractors.append(j)
        queries.append(q)
        groups.append([reranker_document(corpus.declarations[i]) for i in [ti, *distractors]])
    return queries, groups


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    mesh = e2e.train_mesh(device)  # torchrun's ranks, as the JAX script's (n, 1) mesh
    if mesh is not None:
        device = mesh.device
    if not (args.embedder / "model.safetensors").exists():
        sys.exit(
            f"no embedder checkpoint at {args.embedder}: run "
            "scripts/train_torch_embedder_e2e.py first (or pass --embedder)"
        )
    started = time.perf_counter()
    out = e2e.rank_out(args.out, mesh)
    out.mkdir(parents=True, exist_ok=True)
    timing: dict = {"device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}

    # ------------------------------------------------------------------ data
    log(f"building Lean-shaped corpus (n={args.n_decls}) ...")
    corpus = make_corpus(
        n_decls=args.n_decls, n_concepts=args.n_concepts, n_eval=args.n_eval,
        seed=args.seed, body_sentences=args.body_sentences,
    )
    data_dir = out / "data"
    store = e2e.make_store(corpus, data_dir)
    tok_dir, tokenizer, token_true, token_false = build_tokenizer(corpus, out)
    vocab_size = e2e.padded_vocab(tokenizer)
    log(f"tokenizer: {len(tokenizer.vocab)} tokens (vocab padded {vocab_size})")
    examples = make_reranker_examples(
        corpus, np.random.default_rng(args.seed + 1), name_variants=not args.no_name_variants
    )
    n_pos = sum(1 for _, _, y in examples if y)
    log(f"{len(examples)} labeled examples ({n_pos} positive)")

    # ----------------------------------------------------------------- train
    config = e2e.model_config(vocab_size, args.hidden_size, args.num_layers)
    optimizer = make_optimizer(learning_rate=e2e.lr_schedule(args.learning_rate, args.steps))
    params, opt_state = init_train_state(
        config, optimizer, seed=args.seed, device=device, draw="threefry", mesh=mesh
    )
    # The step updates params in place: the random init is exported first.
    random_ckpt = export_hf_checkpoint(params, config, out / "random_checkpoint", tokenizer_dir=tok_dir)

    def loader():
        return CrossEncoderDataLoader(
            tokenizer, examples, batch_size=args.batch_size, max_length=args.max_length,
            seed=args.seed, truncation_augment=args.truncation_augment,
            truncation_caps=tuple(args.truncation_caps),
        )

    step_fn = make_ce_train_step(
        config, token_true=token_true, token_false=token_false, mesh=mesh
    )
    history, timing["train"] = e2e.train_steps(
        step_fn, params, opt_state, iter(loader()), steps=args.steps,
        batch_size=args.batch_size, device=device, log_every=200,
    )
    if out != args.out:  # a rank other than 0 trains beside it and stops
        return {"train_history": history}
    e2e.loader_share(timing["train"], loader())
    trained_ckpt = export_hf_checkpoint(params, config, out / "checkpoint", tokenizer_dir=tok_dir)
    log(f"exported trained reranker checkpoint: {trained_ckpt}")

    report = {
        "task": {
            "n_decls": args.n_decls,
            "n_concepts": args.n_concepts,
            "body_sentences": args.body_sentences,
            "n_train_decls": corpus.n_train,
            "n_eval_queries": len(corpus.eval_queries),
            "n_examples": len(examples),
            "n_positive": n_pos,
            "negatives": "1 concept-overlap hard + 1 random per positive",
            "steps": args.steps,
            "batch_size": args.batch_size,
            "model": {
                "hidden_size": config.hidden_size,
                "num_hidden_layers": config.num_hidden_layers,
                "vocab_size": config.vocab_size,
            },
        },
        "train_history": history,
        "reranker_direct": {},
        "pipeline": {},
    }

    # ------------------------------------------------- direct reranker metric
    # The cross-encoder alone: recall@1 is "does P(true) rank the target's
    # pair first among 50". Random init ~= 1/50.
    queries, groups = distractor_groups(corpus, args.seed)
    rerankers = {}
    for label, ckpt in (("random_init", random_ckpt), ("trained", trained_ckpt)):
        rerankers[label] = RerankerClient(
            str(ckpt), model_dir=ckpt, max_length=args.client_max_length,
            dtype=torch.float32, device=device,
        )
        start = time.perf_counter()
        grouped = rerankers[label].rerank_grouped_sync(queries, groups)
        hits = sum(int(np.argmax(scores)) == 0 for scores in grouped)
        recall1 = hits / len(queries)
        report["reranker_direct"][label] = {
            "recall_at_1_of_50": round(recall1, 4),
            "n_queries": len(queries),
            "seconds": round(time.perf_counter() - start, 1),
        }
        log(f"direct rerank {label}: recall@1/50 = {recall1:.4f}")

    # ------------------------------------------------------- pipeline eval
    log("embedding corpus with the trained embedder ...")
    embedder = EmbeddingClient(
        str(args.embedder), model_dir=args.embedder, max_length=args.serve_max_length,
        batch_size=EMBED_BATCH, dtype=torch.float32, device=device,
    )
    timing["embed_docs_per_s"] = e2e.embed_store(store, embedder)
    art_dir = e2e.build_artifacts(store, data_dir, out / "artifacts")
    engine_t = e2e.open_engine(art_dir, store, embedder, rerankers["trained"], device)
    engine_r = e2e.open_engine(art_dir, store, embedder, rerankers["random_init"], device)
    grid = {
        "dense_only": (engine_t, dict(bm25_k=0, rerank_top=0)),
        "hybrid_no_rerank": (engine_t, dict(rerank_top=0)),
        "full_pipeline_trained": (engine_t, dict(rerank_top=args.rerank_top)),
        "dense_rerank_trained": (engine_t, dict(bm25_k=0, rerank_top=args.rerank_top)),
        "full_pipeline_random_rerank": (engine_r, dict(rerank_top=args.rerank_top)),
    }
    for label, (engine, kw) in grid.items():
        start = time.perf_counter()
        report["pipeline"][label] = evaluate_engine(engine, corpus.eval_queries, **kw)
        e2e.synchronize(device)
        report["pipeline"][label]["seconds"] = round(time.perf_counter() - start, 1)
        log(f"{label}: {json.dumps(report['pipeline'][label])}")
    store.close()

    payload = json.dumps(report, indent=2)
    (out / "eval.json").write_text(payload)
    if args.report:
        args.report.write_text(payload)
    timing["total_seconds"] = time.perf_counter() - started
    (out / "timing.json").write_text(json.dumps(timing, indent=2))
    print(json.dumps({k: report[k] for k in ("reranker_direct", "pipeline")}))
    return report


if __name__ == "__main__":
    main()
