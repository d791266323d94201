"""Train the embedder with the PyTorch port, then serve and evaluate with it.

The port's counterpart of scripts/train_embedder_e2e.py, with its flags
(``--device`` in place of ``--platform``: CUDA unless ``--device cpu``):
build the Lean-shaped synthetic corpus (targets of the eval queries held
out of training), train a small Qwen3-architecture embedder on contrastive
pairs from ``train.pairs_from_store`` (plus paraphrased-synonym pairs under
--paraphrases) with AdamW on a warmup-cosine schedule, export the random
init and the trained weights as HF checkpoints, embed the corpus with each,
build the serving artifacts and evaluate the hybrid, dense-only and
BM25-only engine, then hold the trained geometry's fused bin-max selection
(and on CUDA the bin_topk kernel) against the exact scan.

The run starts from the JAX script's own init at the same --seed
(``init_train_state``'s "threefry" draw). The committed quality target
is the JAX package's run (runs/embedder/eval.json: 20,000 declarations,
1,200 concepts, 512 held-out queries, hidden 384 x 6 layers, 3000 steps,
--paraphrases): trained dense_only recall@10 0.9785, recall@1 0.8984,
MRR@10 0.9289; hybrid recall@10 0.9688; random init dense_only recall@10
0.0059; fused selection recall@10 against the exact scan 0.9812. The JAX
script's own float32 run on a CPU from that init gives dense_only
0.9609, 0.8574, 0.8971 and hybrid 0.9551
(runs/jax_f32_cpu/embedder_eval.json). Those
arguments:

    python scripts/train_torch_embedder_e2e.py --out runs/torch_embedder \\
        --hidden-size 384 --num-layers 6 --steps 3000 --paraphrases

(chip_smoke.py's phase 7 runs them on the card). A CPU miniature:

    python scripts/train_torch_embedder_e2e.py --out /tmp/run --n-decls 200 \\
        --n-concepts 48 --n-eval 32 --steps 300 --batch-size 32 \\
        --hidden-size 64 --device cpu

Under ``torchrun --nproc-per-node N`` the N ranks train data-parallel on
the JAX script's (N, 1) mesh (``train.e2e.train_mesh``) on the same global
batches; rank 0 evaluates and writes, the others write under
``<out>/rank<r>`` and stop after training. One rank runs as above.

Writes eval.json (the JAX script's keys, plus on CUDA
``bin_topk_selection_on_trained_geometry``) and timing.json (pairs/s, the
loader's share of a step, peak memory, embedding docs/s, seconds a stage)
under --out, and prints the results as one JSON line.
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
from lean_explore_tpu_torch.ops.dense import dense_topk  # noqa: E402
from lean_explore_tpu_torch.train import (  # noqa: E402
    ContrastiveDataLoader,
    init_train_state,
    make_optimizer,
    make_train_step,
    pairs_from_store,
)
from lean_explore_tpu_torch.train import e2e  # noqa: E402
from lean_explore_tpu_torch.train.e2e import QUERY_PROMPT, log  # noqa: E402
from lean_explore_tpu_torch.train.export import export_hf_checkpoint  # noqa: E402
from lean_explore_tpu_torch.train.synthetic import (  # noqa: E402
    _PARAPHRASE_TEMPLATES,
    build_wordlevel_tokenizer,
    make_corpus,
    make_paraphrase_pairs,
)
from lean_explore_tpu_torch.util.embedding_client import EmbeddingClient  # noqa: E402
from lean_explore_tpu_torch.util.platform import resolve_device  # noqa: E402

EMBED_BATCH = 256
SELECTION_QUERIES = 128


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=Path("runs/torch_embedder"))
    parser.add_argument("--report", type=Path, default=None,
                        help="write the eval JSON here as well")
    parser.add_argument("--n-decls", type=int, default=20_000)
    parser.add_argument("--n-concepts", type=int, default=1200)
    parser.add_argument("--n-eval", type=int, default=512)
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--learning-rate", type=float, default=3e-4)
    parser.add_argument("--hidden-size", type=int, default=256)
    parser.add_argument("--num-layers", type=int, default=4)
    parser.add_argument("--query-max-length", type=int, default=12)
    parser.add_argument("--doc-max-length", type=int, default=28)
    parser.add_argument("--body-sentences", type=int, default=1,
                        help="body sentences per document (5 ~= production-length "
                        "~110-word docs; raise --doc-max-length and "
                        "--serve-max-length to match)")
    parser.add_argument("--serve-max-length", "--emb-max-length", type=int, default=64,
                        help="EmbeddingClient max_length for corpus embedding + eval")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--paraphrases", action="store_true",
                        help="add paraphrased-synonym training pairs "
                        "(train/synthetic.make_paraphrase_pairs)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a GPU) or cpu")
    return parser.parse_args(argv)


def build_tokenizer(corpus, out: Path, paraphrases: bool):
    """The WordLevel tokenizer over the corpus, the query prompt and, with
    ``paraphrases``, the paraphrase templates' words: (its directory, the
    tokenizer)."""
    extra_texts = (QUERY_PROMPT,)
    if paraphrases:
        extra_texts += tuple(tpl.format(s0="", s1="", s2="") for tpl in _PARAPHRASE_TEMPLATES)
    tok_dir = build_wordlevel_tokenizer(corpus.texts(), out / "tokenizer", extra_texts=extra_texts)
    return tok_dir, load_tokenizer(tok_dir)


def training_pairs(corpus, store, paraphrases: bool) -> list[tuple[str, str]]:
    """(prompted query, document) pairs of the train split: the store's
    name and title pairs whose document is a train declaration's (eval
    targets live in the held-out tail), then the paraphrase pairs."""
    train_docs = {d.informalization for d in corpus.declarations[: corpus.n_train]}
    raw_pairs = [(q, d) for q, d in pairs_from_store(store) if d in train_docs]
    if paraphrases:
        raw_pairs.extend(make_paraphrase_pairs(corpus))
    return [(QUERY_PROMPT + q, d) for q, d in raw_pairs]


def recall_vs_exact(idx: np.ndarray, idx_exact: np.ndarray) -> float:
    k = idx_exact.shape[1]
    return float(np.mean([len(set(a) & set(b)) / k for a, b in zip(idx, idx_exact)]))


def selection_check(q_vecs: torch.Tensor, corpus_mat: torch.Tensor) -> dict:
    """Top-10 overlap with the exact scan (``chunked``) of the plain
    bin-max scan (``fused``) and, on CUDA, of the bin_topk kernel, over the
    trained geometry: {method: recall@10 vs exact}."""
    _, idx_exact = dense_topk(q_vecs, corpus_mat, 10, method="chunked")
    methods = ["fused"] + (["bin_topk"] if corpus_mat.device.type == "cuda" else [])
    out = {}
    for method in methods:
        _, idx = dense_topk(q_vecs, corpus_mat, 10, method=method)
        out[method] = recall_vs_exact(idx.cpu().numpy(), idx_exact.cpu().numpy())
    return out


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    mesh = e2e.train_mesh(device)  # torchrun's ranks, as the JAX script's (n, 1) mesh
    if mesh is not None:
        device = mesh.device
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
    tok_dir, tokenizer = build_tokenizer(corpus, out, args.paraphrases)
    vocab_size = e2e.padded_vocab(tokenizer)
    log(f"tokenizer: {len(tokenizer.vocab)} tokens (vocab padded {vocab_size})")
    pairs = training_pairs(corpus, store, args.paraphrases)
    log(f"{len(pairs)} training pairs over {corpus.n_train} declarations")

    # ----------------------------------------------------------------- train
    config = e2e.model_config(vocab_size, args.hidden_size, args.num_layers)
    optimizer = make_optimizer(learning_rate=e2e.lr_schedule(args.learning_rate, args.steps))
    params, opt_state = init_train_state(
        config, optimizer, seed=args.seed, device=device, draw="threefry", mesh=mesh
    )
    # The step updates params in place: the random init is exported first.
    random_ckpt = export_hf_checkpoint(
        params, config, out / "random_checkpoint", tokenizer_dir=tok_dir, query_prompt=QUERY_PROMPT,
    )

    def loader():
        return ContrastiveDataLoader(
            tokenizer, pairs, batch_size=args.batch_size,
            query_max_length=args.query_max_length, doc_max_length=args.doc_max_length,
            seed=args.seed,
        )

    history, timing["train"] = e2e.train_steps(
        make_train_step(config, mesh=mesh), params, opt_state, iter(loader()),
        steps=args.steps, batch_size=args.batch_size, device=device, log_every=100,
    )
    if out != args.out:  # a rank other than 0 trains beside it and stops
        return {"train_history": history}
    e2e.loader_share(timing["train"], loader())
    trained_ckpt = export_hf_checkpoint(
        params, config, out / "checkpoint", tokenizer_dir=tok_dir, query_prompt=QUERY_PROMPT,
    )
    log(f"exported trained checkpoint: {trained_ckpt}")

    # ---------------------------------------------------------- serve + eval
    report = {
        "task": {
            "n_decls": args.n_decls,
            "n_concepts": args.n_concepts,
            "body_sentences": args.body_sentences,
            "n_train_decls": corpus.n_train,
            "n_eval_queries": len(corpus.eval_queries),
            "holdout": "eval targets excluded from training pairs",
            "steps": args.steps,
            "batch_size": args.batch_size,
            "model": {
                "hidden_size": config.hidden_size,
                "num_hidden_layers": config.num_hidden_layers,
                "vocab_size": config.vocab_size,
            },
        },
        "train_history": history,
        "results": {},
    }
    arms = {"hybrid": {}, "dense_only": {"bm25_k": 0}, "bm25_only": {"dense_k": 0}}
    timing["embed_docs_per_s"], timing["eval_seconds"] = {}, {}
    for label, ckpt in (("random_init", random_ckpt), ("trained", trained_ckpt)):
        log(f"embedding corpus + serving eval with {label} weights ...")
        client = EmbeddingClient(
            str(ckpt), model_dir=ckpt, max_length=args.serve_max_length,
            batch_size=EMBED_BATCH, dtype=torch.float32, device=device,
        )
        timing["embed_docs_per_s"][label] = e2e.embed_store(store, client)
        art_dir = e2e.build_artifacts(store, data_dir, out / f"artifacts_{label}")
        engine = e2e.open_engine(art_dir, store, client, None, device)
        # rerank_top=0: this script trains and evaluates the embedder's
        # stages only (the reranker script evaluates the full pipeline).
        report["results"][label] = {}
        for arm, kw in arms.items():
            start = time.perf_counter()
            report["results"][label][arm] = evaluate_engine(
                engine, corpus.eval_queries, rerank_top=0, **kw
            )
            e2e.synchronize(device)
            timing["eval_seconds"][f"{label}/{arm}"] = time.perf_counter() - start
        log(f"{label}: {json.dumps(report['results'][label])}")

    # Selection fidelity on the trained (anisotropic) geometry: the fused
    # bin-max scan, and on CUDA the bin_topk kernel, against the exact scan
    # over the same corpus matrix.
    q_vecs = client.embed_device(
        [q for q, _ in corpus.eval_queries[:SELECTION_QUERIES]], is_query=True
    )
    corpus_mat = torch.from_numpy(
        np.stack([
            np.asarray(d.informalization_embedding, dtype=np.float32)
            for d in store.iter_all()
        ])
    ).to(device)
    store.close()
    recall = selection_check(q_vecs, corpus_mat)
    shape = {"n_rows": int(corpus_mat.shape[0]), "n_queries": int(q_vecs.shape[0])}
    report["fused_selection_on_trained_geometry"] = {
        "recall_at_10_vs_exact": round(recall["fused"], 4), **shape,
    }
    if "bin_topk" in recall:
        report["bin_topk_selection_on_trained_geometry"] = {
            "recall_at_10_vs_exact": round(recall["bin_topk"], 4), **shape,
        }
    log(f"selection recall@10 against the exact scan on the trained geometry: {recall}")

    payload = json.dumps(report, indent=2)
    (out / "eval.json").write_text(payload)
    if args.report:
        args.report.write_text(payload)
    timing["total_seconds"] = time.perf_counter() - started
    (out / "timing.json").write_text(json.dumps(timing, indent=2))
    print(json.dumps(report["results"]))
    return report


if __name__ == "__main__":
    main()
