"""The benchmark of the PyTorch and CUDA port, one cell a run:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's configuration and data from the seed on the card (see
``BENCHMARK.json``, ``configs/``, ``traffic/``), warms the shapes its
traffic uses, drives the port for ``--seconds`` with the traffic mix's
generator, then holds a sample of what the timed path produced to the
plain reference (``reference/``) and prints one JSON line: the cell's
end-to-end metrics (``--trace 0``) or its per-layer metrics from a
profiled stretch (``--trace 1``), ``correct``, and the numbers compared
beside their limits. Exits 2 without enough CUDA devices, and 3 if JAX or
the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))


def log(msg: str) -> None:
    print(f"[bench {time.perf_counter() - T_START:7.1f}s] {msg}", file=sys.stderr, flush=True)


def configure_environment(root: Path, cfg: dict) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths; the
    program's settings from the configuration and nothing else."""
    cache = root / "build" / "bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for var in [v for v in os.environ if v.startswith("LEAN_EXPLORE_")]:
        del os.environ[var]
    for var, value in cfg.get("environment", {}).items():
        os.environ[var] = value


def run_cell(spec, cell: dict, seed: int, seconds: float, trace: bool, device,
             workdir: Path, cfg: dict | None = None, traffic: dict | None = None,
             with_control: bool = False) -> dict:
    """One run of ``cell``; returns the result dict (printed by ``main``).
    ``with_control`` also judges the fp8 reference in the program's place
    on the same sample (``calibrate.py``; the benchmark's runs do not)."""
    import torch

    from generators import corpus as corpus_mod
    from harness import loadgen, stats, system
    from harness.mainthread import MainThread
    from harness.trace import Profiler

    cfg = cfg or spec.config(cell["config"])
    traffic = traffic or spec.traffic(cell["traffic"])
    setup = {}

    t = time.perf_counter()
    shape = traffic["corpus"]
    corpus = corpus_mod.make_corpus(n_decls=cfg["deployment"]["declarations"],
                                    n_concepts=shape["concepts"], body_sentences=shape["body_sentences"],
                                    max_deps=shape["max_dependencies"], seed=seed)
    vocab = corpus_mod.vocabulary(corpus, tuple(cfg["vocabulary_texts"]))
    setup["corpus_s"] = time.perf_counter() - t
    tokenizer = system.write_tokenizer(vocab, corpus_mod.tokenizer_json(vocab), workdir / "tokenizer")

    rec = system.Recorder()
    profiler = Profiler() if trace else None
    kind = traffic["kind"]
    result_extra = {}
    captured_calls: dict[int, tuple] = {}

    if kind == "closed":
        queries = [q for q, _, _ in corpus_mod.make_queries(
            corpus, traffic["query_mix"], traffic["queries"], seed)]
        service, batcher = system.build_search(cfg, corpus, tokenizer, seed, device, workdir, rec, setup)
        t = time.perf_counter()
        warm = corpus_mod.make_queries(corpus, traffic["query_mix"], sum(traffic["warmup_batches"]), seed + 1)
        start = 0
        for size in traffic["warmup_batches"]:
            asyncio.run(service.search_batch([q for q, _, _ in warm[start:start + size]],
                                             limit=traffic["limit"], rerank_top=traffic["rerank_top"]))
            start += size
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup["warmup_s"] = time.perf_counter() - t
        rec.batches.clear()
        if profiler:
            profiler.prime()
        batcher.start()
        main = MainThread()
        if trace:
            rec.on_batch = stretch_hook(profiler, traffic, main)
        setup_s = time.perf_counter() - T_START
        log(f"set-up {setup_s:.1f} s: " + ", ".join(f"{k} {v:.2f}" for k, v in setup.items()))
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        win = loadgen.run_closed(batcher, queries, traffic, seconds, main,
                                 lambda: sum(len(b.queries) for b in rec.batches))
        batcher.stop()
        if profiler and profiler.prof is not None:
            profiler.stop()
        window = [b for b in rec.batches if win.start <= b.start < win.close]
        rate, win.end, n_window = stats.whole_batch_rate(rec.batches, win.start, win.close)
        # Closed loop: the requests still queued when the window closed were
        # dropped unsent, and are neither attempted nor failed.
        attempted = [r for r in win.requests if not (r.future is not None and r.future.cancelled())]
        failed = sum(1 for r in attempted if not r.ok)
        log(f"window {win.end - win.start:.2f} s: {len(window)} batches, {n_window} queries in them, "
            f"{len(attempted)} requests, {failed} failed")
        log("batches (start s, seconds, size): " + " ".join(
            f"({b.start - win.start:.2f},{b.end - b.start:.2f},{len(b.queries)})" for b in rec.batches))
        e2e = {"search_qps": rate}
        ctx_extra = dict(batches=window, all_batches=list(rec.batches), window=win)
    elif kind == "index_embed":
        store, todo, client, db = system.build_index_embed(cfg, corpus, tokenizer, seed, device, workdir, setup)
        t = time.perf_counter()
        warm_docs = [d.informalization for d in todo[-traffic["batch_size"]:]]
        for _ in range(traffic["warmup_calls"]):
            client.embed_sync(warm_docs)
        setup["warmup_s"] = time.perf_counter() - t
        if profiler:
            profiler.prime()
        setup_s = time.perf_counter() - T_START
        log(f"set-up {setup_s:.1f} s: " + ", ".join(f"{k} {v:.2f}" for k, v in setup.items()))
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        traced_calls = set(range(traffic["trace_from"], traffic["trace_from"] + traffic["trace_calls"]))

        def on_call(stage, index, vectors=None, batch=None):
            if profiler and index in traced_calls:
                if stage == "start" and profiler.prof is None and profiler.trace is None:
                    profiler.start()
                elif stage == "end" and index == max(traced_calls):
                    profiler.stop()
            if stage == "end":
                captured_calls[index] = (batch, vectors)

        win = loadgen.run_index_embed(store, todo, client, traffic, seconds, on_call)
        if profiler and profiler.prof is not None:
            profiler.stop()
        n_docs = sum(n for _, _, n in win.calls)
        rate = n_docs / (win.end - win.start)
        log(f"window {win.end - win.start:.2f} s: {len(win.calls)} calls, {n_docs} documents embedded and written")
        attempted, failed = len(win.calls), 0
        e2e = {"embed_docs_per_s": rate}
        ctx_extra = dict(calls=win.calls, window=win, traced_calls=sorted(traced_calls),
                         captured=captured_calls)
    else:
        raise ValueError(f"unknown traffic kind {kind!r}")

    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    e2e["setup_s"] = setup_s

    # The program's state goes before the reference runs on the card.
    if kind == "closed":
        judged = {"samples": search_samples(rec, win, traffic, seed)}
        del service, batcher
    else:
        calls = sample_calls(captured_calls, traffic, seed)
        store.close()
        del store, client, todo
        judged = {"calls": calls, "written": read_back(db, calls)}
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    numbers = judge(cfg, traffic, corpus, vocab, seed, device, **judged)
    log(f"check {time.perf_counter() - t:.1f} s")
    if with_control:
        result_extra["control"] = judge(cfg, traffic, corpus, vocab, seed, device, control=True, **judged)
    limits = cfg["check_limits"]
    compared = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(v["value"] <= v["limit"] for v in compared.values())

    result = {"correct": correct, "attempted": attempted if isinstance(attempted, int) else len(attempted),
              "failed": failed}
    names = [m["name"] for m in spec.metrics("per_layer" if trace else "end_to_end", cell["name"])]
    metric_units = {m["name"]: m["unit"] for m in spec.data["end_to_end"] + spec.data["per_layer"]}
    metrics = {}
    device_rec = {"platform": "gpu" if device.type == "cuda" else device.type,
                  "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                  "count": cell["chips"], "memory_peak_bytes": int(memory_peak)}
    if trace:
        tr = profiler.trace
        # What a per-layer metric's reader (``metrics/<name>.py``) reads.
        ctx = SimpleNamespace(cfg=cfg, traffic=traffic, trace=tr, vocab=vocab, seconds=seconds, **ctx_extra)
        for name in names:
            value = spec.reader(name)(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": metric_units[name]}
        if tr is not None:
            device_rec["busy_s"] = tr.busy_us() / 1e6
            device_rec["window_s"] = tr.window_us / 1e6
            result_extra["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    else:
        for name in names:
            if name in e2e:
                metrics[name] = {"value": e2e[name], "unit": metric_units[name]}
    result.update(metrics=metrics, device=device_rec, **result_extra)
    result["check"] = compared
    return result


def stretch_hook(profiler, traffic: dict, main):
    """Profile whole engine batches: from the first that starts after
    ``trace_after_s`` of the window, for ``trace_batches`` batches. The
    profiler starts and stops on the main thread, between two batches."""
    state = {"count": 0, "t0": None}

    def hook(stage, batch):
        if state["t0"] is None:
            state["t0"] = batch.start
        if profiler.trace is not None:
            return
        if stage == "start" and profiler.prof is None:
            if batch.start - state["t0"] >= traffic["trace_after_s"]:
                main.call(profiler.start)
        elif stage == "end" and profiler.prof is not None:
            batch.traced = True
            state["count"] += 1
            if state["count"] >= traffic["trace_batches"]:
                main.call(profiler.stop)

    return hook


def search_samples(rec, win, traffic: dict, seed: int):
    """The requests the check reads, drawn from the seed among every
    request answered by a batch that began in the window."""
    import numpy as np

    from reference.check import SearchSample

    slots = [(b, p) for b in rec.batches if win.start <= b.start < win.close and b.returned
             for p in range(len(b.queries))]
    rng = np.random.default_rng([seed, 3])
    pick = rng.choice(len(slots), size=min(traffic["check_requests"], len(slots)), replace=False)
    out = []
    for i in sorted(pick.tolist()):
        b, p = slots[i]
        try:
            out.append(_sample(b, p))
        except (IndexError, TypeError, KeyError) as error:
            # A layer gave fewer outputs than the batch had queries.
            out.append(SearchSample(query=b.queries[p], query_vec=None, dense_ids=None, dense_scores=None,
                                    pool=[], scores=[], returned=[], broken=repr(error)))
    return out


def _sample(b, p):
    import numpy as np

    from reference.check import SearchSample

    docs, scores = b.rerank_outer
    pool = docs[p]
    stage1 = kept = stage2 = None
    if len(b.rerank_calls) == 2:  # the cascade: a truncated stage, then the rescore
        (_, d1, _, s1), (_, d2, _, s2) = b.rerank_calls
        for group, sc in zip(d1, s1):
            if group is pool:
                stage1 = list(sc)
        kept, stage2 = list(d2[p]), list(s2[p])
    return SearchSample(
        query=b.queries[p], query_vec=b.query_vecs[p].float().cpu().numpy(),
        dense_ids=np.asarray(b.dense_ids[p]), dense_scores=np.asarray(b.dense_scores[p]),
        pool=list(pool), scores=list(scores[p]),
        returned=list(b.returned[p]), stage1=stage1, kept=kept, stage2=stage2,
    )


def sample_calls(captured: dict, traffic: dict, seed: int):
    import numpy as np

    rng = np.random.default_rng([seed, 3])
    keys = sorted(captured)
    pick = rng.choice(len(keys), size=min(traffic["check_calls"], len(keys)), replace=False)
    return [captured[keys[i]] for i in sorted(pick.tolist())]


def read_back(db: Path, sampled) -> int:
    """Stored embeddings of the sampled documents that differ from the ones
    served, read from the database file."""
    import sqlite3

    import numpy as np

    conn = sqlite3.connect(str(db))
    bad = 0
    try:
        for batch, vectors in sampled:
            for d, v in zip(batch, vectors):
                row = conn.execute("SELECT informalization_embedding FROM declarations WHERE id = ?",
                                   (int(d.id),)).fetchone()
                if row is None or row[0] is None or not np.array_equal(
                        np.frombuffer(row[0], dtype="<f4"), np.asarray(v, dtype=np.float32)):
                    bad += 1
    finally:
        conn.close()
    return bad


def judge(cfg, traffic, corpus, vocab, seed, device, samples=None, calls=None, written=0, control=False):
    """The numbers compared (``reference.check``); with ``control`` those
    of the fp8 reference in the program's place."""
    import numpy as np
    import torch

    from harness import system
    from harness.weights import make_params, model_seed
    from reference import check

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = cfg["model"]
    pe = make_params(m, model_seed(seed, "embedder"), device)
    if calls is not None:
        j = check.Judge(cfg, corpus, vocab, pe, None, None, device)
        docs = [d.informalization for batch, _ in calls for d in batch]
        served = np.concatenate([np.asarray(v) for _, v in calls])
        with torch.no_grad():
            return check.judge_documents(j, docs, served, written, "fp8" if control else None)
    pr = make_params(m, model_seed(seed, "reranker"), device)
    rows = system.corpus_rows(seed, len(corpus), m["hidden_size"], device)
    j = check.Judge(cfg, corpus, vocab, pe, pr, rows, device)
    cascade = cfg["serving"].get("rerank_cascade")
    with torch.no_grad():
        if control:
            samples = check.control_samples(j, samples, traffic["limit"], cascade)
        return check.judge_search(j, samples, traffic["limit"], traffic["rerank_top"], cascade)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from harness.guard import forbidden_modules
    from harness.spec import Spec

    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    cfg = spec.config(cell["config"])
    configure_environment(ROOT, cfg)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {cell['name']} needs {cell['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    sys.path.insert(1, str(ROOT))
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    log(f"{cell['name']} seed {args.seed} seconds {args.seconds} trace {args.trace}")
    seed = args.seed % (1 << 62)
    device = torch.device("cuda:0")
    with tempfile.TemporaryDirectory(prefix="bench_") as tmp:
        result = run_cell(spec, cell, seed, args.seconds, bool(args.trace), device, Path(tmp))
    log(f"card {smi.communicate(timeout=60)[0].strip()}")
    loaded = forbidden_modules(sys.modules)
    if loaded:
        print(f"benchmark: forbidden modules loaded: {loaded}", file=sys.stderr)
        return 3
    for name, entry in result["check"].items():
        print(f"check {name} {entry['value']!r} limit {entry['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
