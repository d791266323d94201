"""The quality tools' full-size runs through the PyTorch port, each beside
its committed record, on one card.

What chip_smoke.py phase 10 leaves out for time, at the records' own
arguments:

1. the 200k chain's index (runs/scale200k checkpoints in float32, lengths
   128 and 192) embedded and built once in --work;
2. scripts/eval_torch_rerank_top.py over it: rerank_top 50, 25, 16 and 8,
   each without and with the chain's cascade point 48,25, on the 512 eval
   queries (runs/scale200k/rerank_top_eval.json);
3. scripts/eval_torch_query_classes.py at its defaults, the committed 20k
   chain: every query class in every configuration
   (runs/query_classes/eval.json);
4. scripts/eval_torch_retrieval.py --data-dir on the 200k index with a
   queries file of its 512 eval pairs, in a child process whose
   environment serves the chain's checkpoints, lengths and a float32
   corpus: hybrid (the full pipeline) against
   runs/scale200k/reranker_eval.json's full_pipeline_trained and its
   dense_only, BM25 alone against runs/scale200k/embedder_eval.json;
5. scripts/probe_torch_reranker_doclen.py on runs/scale200k/reranker at
   its defaults (runs/scale200k/trunc_probe.json, that checkpoint's rows).

Each report is written under --out; each recall is logged as queries
against its record, MRR as a difference, and summary.json holds them all.

    python3 scripts/run_torch_tools_full.py --out tools_full
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from chip_smoke import (  # noqa: E402
    CHAIN_CORPUS,
    CHAIN_EMB_MAX_LENGTH,
    CHAIN_RR_MAX_LENGTH,
    _child_env,
    chain_checkpoints,
    load_script,
)
from lean_explore_tpu_torch import evaluation  # noqa: E402
from lean_explore_tpu_torch.train.synthetic import make_corpus  # noqa: E402

CHAIN = REPO / "runs" / "scale200k"
CHAIN_FLAGS = [
    "--n-decls", str(CHAIN_CORPUS["n_decls"]), "--n-concepts", str(CHAIN_CORPUS["n_concepts"]),
    "--body-sentences", str(CHAIN_CORPUS["body_sentences"]),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def against(label: str, got: dict, want: dict) -> dict:
    """Queries (MRR: difference) between a metrics row and its record."""
    n = got["n_queries"]
    diff = {
        key: round(got[key] * n) - round(want[key] * n) if key.startswith("recall")
        else round(got[key] - want[key], 4)
        for key in ("recall_at_1", "recall_at_10", "mrr_at_10")
    }
    log(f"  {label}: " + "; ".join(
        f"{k} {got[k]:.4f} ({want[k]:.4f}, {diff[k]:+})" for k in diff))
    return diff


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    args.out.mkdir(parents=True, exist_ok=True)
    card = (
        subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True).stdout.strip()
        if device.type == "cuda" else "cpu"
    )
    log(card)
    summary: dict = {"card": card, "seconds": {}, "diff": {}}
    embedder_dir, reranker_dir = chain_checkpoints(REPO)
    with tempfile.TemporaryDirectory(prefix="tools_full_") as tmp:
        work = Path(tmp) / "chain"
        t = time.perf_counter()
        corpus = make_corpus(**CHAIN_CORPUS)
        embedder, _ = evaluation.float32_clients(
            embedder_dir, reranker_dir, CHAIN_EMB_MAX_LENGTH, CHAIN_RR_MAX_LENGTH, device
        )
        store, _ = evaluation.build_index(corpus, embedder, work)
        store.close()
        del embedder
        summary["seconds"]["index"] = time.perf_counter() - t
        log(f"200k index {summary['seconds']['index']:.1f} s")

        t = time.perf_counter()
        report = load_script(REPO, "eval_torch_rerank_top").main([
            "--embedder", str(embedder_dir), "--reranker", str(reranker_dir), *CHAIN_FLAGS,
            "--emb-max-length", str(CHAIN_EMB_MAX_LENGTH),
            "--rr-max-length", str(CHAIN_RR_MAX_LENGTH), "--cascade", "48,25",
            "--data-dir", str(work), "--out", str(args.out / "rerank_top_eval.json"),
            "--device", args.device,
        ])
        summary["seconds"]["rerank_top"] = time.perf_counter() - t
        record = json.loads((CHAIN / "rerank_top_eval.json").read_text())["results"]
        summary["diff"]["rerank_top"] = {
            label: against(f"rerank_top {label}", row, record[label])
            for label, row in report["results"].items() if label in record
        }

        t = time.perf_counter()
        report = load_script(REPO, "eval_torch_query_classes").main([
            "--embedder", str(REPO / "runs" / "embedder" / "checkpoint"),
            "--reranker", str(REPO / "runs" / "reranker" / "checkpoint"),
            "--out", str(args.out / "query_classes"), "--device", args.device,
        ])
        summary["seconds"]["query_classes"] = time.perf_counter() - t
        record = json.loads((REPO / "runs" / "query_classes" / "eval.json").read_text())["results"]
        summary["diff"]["query_classes"] = {
            f"{qclass}/{config}": against(f"{qclass}/{config}", row, record[qclass][config])
            for qclass, rows in report["results"].items() for config, row in rows.items()
        }

        queries = Path(tmp) / "queries.jsonl"
        queries.write_text("".join(
            json.dumps({"query": q, "target": t}) + "\n" for q, t in corpus.eval_queries
        ))
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(REPO / "scripts" / "eval_torch_retrieval.py"), "--data-dir",
             str(work), "--queries-file", str(queries), "--device", args.device],
            env=_child_env(embedder_dir, reranker_dir), capture_output=True, text=True,
            timeout=900,
        )
        summary["seconds"]["retrieval"] = time.perf_counter() - t
        if proc.returncode != 0:
            raise SystemExit(f"eval_torch_retrieval.py failed:\n{proc.stderr[-3000:]}")
        report = json.loads(proc.stdout.strip().splitlines()[-1])
        (args.out / "retrieval.json").write_text(json.dumps(report, indent=2))
        pipeline = json.loads((CHAIN / "reranker_eval.json").read_text())["pipeline"]
        trained = json.loads((CHAIN / "embedder_eval.json").read_text())["results"]["trained"]
        summary["diff"]["retrieval"] = {
            "hybrid": against("retrieval hybrid", report["hybrid"], pipeline["full_pipeline_trained"]),
            "dense_only": against("retrieval dense_only", report["dense_only"], pipeline["dense_only"]),
            "bm25_only": against("retrieval bm25_only", report["bm25_only"], trained["bm25_only"]),
        }

    t = time.perf_counter()
    report = load_script(REPO, "probe_torch_reranker_doclen").main([
        "--checkpoints", str(reranker_dir), "--report", str(args.out / "trunc_probe.json"),
        "--device", args.device,
    ])
    summary["seconds"]["probe"] = time.perf_counter() - t
    record = json.loads((CHAIN / "trunc_probe.json").read_text())["results"]
    want = record["runs/scale200k/reranker/checkpoint"]
    got = report["results"][str(reranker_dir)]
    n = report["task"]["queries"]
    summary["diff"]["probe"] = {
        arm: {"frac_true_queries": round(row["frac_true"] * n) - round(want[arm]["frac_true"] * n),
              "mean": round(row["mean"] - want[arm]["mean"], 4),
              "median": round(row["median"] - want[arm]["median"], 4)}
        for arm, row in got.items()
    }
    log("  probe against trunc_probe.json: " + json.dumps(summary["diff"]["probe"]))
    (args.out / "summary.json").write_text(json.dumps(summary, indent=2))
    log(json.dumps({"seconds": {k: round(v, 1) for k, v in summary["seconds"].items()}}))
    return summary


if __name__ == "__main__":
    os.environ.pop("LEAN_EXPLORE_RERANK_CASCADE", None)
    main()
