"""Tiny CPU versions of the benchmark's configurations and mixes, for the
tests: two layers of width 64 over 2,000 declarations, the same code."""

import copy
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_MODEL = {"vocab_size": 1024, "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
              "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 128}


def tiny_config(name: str, layers: int = 2) -> dict:
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg["model"].update(TINY_MODEL, num_hidden_layers=layers)
    cfg["deployment"]["declarations"] = 2000
    cfg["serving"].update(dense_bins=1024, serve_query_batch=16, embed_batch=16)
    return cfg


def tiny_traffic(name: str, **over) -> dict:
    traffic = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    traffic["corpus"] = dict(traffic["corpus"], concepts=120)
    traffic["queries"] = 512
    if traffic["kind"] == "closed":
        traffic.update(clients=32, warmup_batches=[16], trace_after_s=0.0, check_requests=6)
    else:
        traffic.update(batch_size=25, warmup_calls=1, trace_from=1, trace_calls=2, check_calls=2)
    traffic.update(over)
    return traffic


def run_tiny(cell_name: str, *, seed=7, seconds=2.0, trace=False, cfg=None, traffic=None, tmp=None):
    import tempfile

    import torch

    import run
    from harness.spec import Spec

    spec = Spec(ROOT)
    cell = spec.cell(cell_name)
    cfg = cfg or tiny_config(cell["config"])
    traffic = traffic or tiny_traffic(cell["traffic"])
    run.configure_environment(Path(tempfile.gettempdir()) / "bench_tiny", cfg)
    with tempfile.TemporaryDirectory(dir=tmp) as work:
        return run.run_cell(spec, cell, seed, seconds, trace, torch.device("cpu"), Path(work),
                            cfg=copy.deepcopy(cfg), traffic=traffic)
