"""Rankings of the rerank cascade's prescreen caps on captured candidate
groups: the card's, the port's on the CPU and the JAX client's in float32
on the CPU, side by side.

Reads the groups that ``chip_smoke.py --tools --tools-dump DIR`` captured on
the card (DIR/tools_groups.json: each of phase 10a's 192 queries with its
50 candidate documents and their full-length scores, and every cap's
truncated scores), scores them again on the CPU with the port's and the
JAX package's float32 reranker at the dump's length, at full length and at
each cap of --caps, and compares what calibrate_cascade.py reads from
them: each group's full-length top-1 and top-3 and its prescreen keep set
(the cap's top ``keep``). Writes --out: the counts of groups whose
top-3 or keep set differ between the card and JAX and between the port and
JAX, each cap's calibration row from the card's, the port's and JAX's
scores beside the committed TPU row, every group's JAX rankings, and the
--closest groups whose containment turns on the smallest score gaps, with
their documents and JAX's scores, for tests/test_torch_eval_tools.py.

    python3 scripts/compare_torch_cap_rankings.py \\
        --groups DIR/tools_groups.json --caps 24 \\
        --out runs/scale200k/cascade_calibration_cap24_divergence.json

Takes a few minutes on the CPU for one cap.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from lean_explore_tpu_torch import evaluation  # noqa: E402
from lean_explore_tpu_torch.util.reranker_client import RerankerClient  # noqa: E402


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def score(client, groups, suffix_cap=None, batch=evaluation.CAP_BATCH) -> list[list[float]]:
    out = []
    for start in range(0, len(groups), batch):
        chunk = groups[start : start + batch]
        out.extend(
            list(map(float, s))
            for s in client.rerank_grouped_sync(
                [g.query for g in chunk], [g.documents for g in chunk], suffix_cap=suffix_cap
            )
        )
    return out


def decisions(full, cap, keep: int) -> tuple[list[int], list[int]]:
    """A group's full-length top-3 (in order) and its keep set (sorted)."""
    return evaluation.ranking(full)[:3], sorted(evaluation.ranking(cap)[:keep])


def margin(full, cap, keep: int) -> float:
    """How close a group's containment is to turning: the smaller of the
    full-length gap between ranks 3 and 4 and the prescreen gap between
    the worst full top-3 document and the keep boundary."""
    order_full, order_cap = evaluation.ranking(full), evaluation.ranking(cap)
    gap_full = full[order_full[2]] - full[order_full[3]] if len(full) > 3 else float("inf")
    pos = [order_cap.index(i) for i in order_full[:3]]
    worst = order_cap[max(pos)]
    edge = order_cap[keep] if max(pos) < keep else order_cap[keep - 1]
    return min(abs(gap_full), abs(cap[worst] - cap[edge]))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--groups", type=Path, required=True)
    parser.add_argument("--reranker", type=Path,
                        default=REPO / "runs" / "scale200k" / "reranker" / "checkpoint")
    parser.add_argument("--record", type=Path,
                        default=REPO / "runs" / "scale200k" / "cascade_calibration.json")
    parser.add_argument("--caps", type=int, nargs="+", required=True)
    parser.add_argument("--closest", type=int, default=8)
    parser.add_argument("--out", type=Path, required=True)
    args = parser.parse_args(argv)

    from lean_explore_tpu.util.reranker_client import RerankerClient as JaxReranker

    dump = json.loads(args.groups.read_text())
    keep, length = dump["keep"], dump["rr_max_length"]
    groups = [evaluation.RerankGroup(g["query"], g["documents"], g["scores"]) for g in dump["groups"]]
    tpu = json.loads(args.record.read_text())["caps"]
    port = RerankerClient(str(args.reranker), max_length=length, dtype=torch.float32, device="cpu")
    jax_client = JaxReranker(str(args.reranker), model_dir=args.reranker, max_length=length,
                             dtype="float32")
    t = time.perf_counter()
    full = {"port": score(port, groups), "jax": score(jax_client, groups),
            "card": [g.scores for g in groups]}
    log(f"full-length scores {time.perf_counter() - t:.1f} s")
    report = {
        "keep": keep, "rr_max_length": length, "reranker": str(args.reranker.relative_to(REPO)),
        "card": dump["device"], "n_groups": len(groups),
        "full_max_abs_diff": {
            who: max(abs(a - b) for x, y in zip(full[who], full["jax"]) for a, b in zip(x, y))
            for who in ("card", "port")
        },
        "caps": {},
    }
    for cap in args.caps:
        t = time.perf_counter()
        scores = {"port": score(port, groups, cap), "jax": score(jax_client, groups, cap),
                  "card": dump["cap_scores"][str(cap)]}
        log(f"cap {cap} scores {time.perf_counter() - t:.1f} s")
        made = {who: [decisions(f, c, keep) for f, c in zip(full[who], scores[who])]
                for who in scores}
        rows = {
            who: evaluation.calibration_row(
                [g._replace(scores=f) for g, f in zip(groups, full[who])], scores[who], keep, 0.0
            )
            for who in scores
        }
        margins = [margin(f, c, keep) for f, c in zip(full["jax"], scores["jax"])]
        closest = sorted(range(len(groups)), key=lambda i: margins[i])[: args.closest]
        report["caps"][str(cap)] = {
            "tpu_row": tpu.get(str(cap)),
            "jax_f32_cpu_row": rows["jax"], "port_cpu_row": rows["port"], "card_row": rows["card"],
            "groups_differing_from_jax": {
                who: [i for i, (a, b) in enumerate(zip(made[who], made["jax"])) if a != b]
                for who in ("card", "port")
            },
            "cap_max_abs_diff": {
                who: max(abs(a - b) for x, y in zip(scores[who], scores["jax"]) for a, b in zip(x, y))
                for who in ("card", "port")
            },
            "jax_rankings": [{"full_top3": a, "keep_set": b} for a, b in made["jax"]],
            "closest": [
                {"index": i, "margin": margins[i], "query": groups[i].query,
                 "documents": groups[i].documents, "jax_full_scores": full["jax"][i],
                 "jax_cap_scores": scores["jax"][i]}
                for i in sorted(closest)
            ],
        }
        summary = {k: v for k, v in report["caps"][str(cap)].items()
                   if k not in ("jax_rankings", "closest")}
        log(f"cap {cap}: {json.dumps(summary)}")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
