"""Readings the benchmark's limits are set from; not part of a benchmark
run.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13 --seconds 12

Runs the cell once a seed (a short window at the cell's own load and
sizes) and prints, per seed, the numbers the check compares for the
program and for the control: the fp8 reference in the program's place on
the same requests.
"""

import argparse
import copy
import json
import sys
import tempfile
from pathlib import Path

import run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="1")
    parser.add_argument("--seconds", type=float, default=12.0)
    args = parser.parse_args(argv)

    from harness.spec import Spec

    spec = Spec(run.ROOT)
    cell = spec.cell(args.workload)
    cfg = spec.config(cell["config"])
    run.configure_environment(run.ROOT, cfg)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(1, str(run.ROOT))
    device = torch.device("cuda:0")
    for seed in (int(s) for s in args.seeds.split(",")):
        with tempfile.TemporaryDirectory(prefix="bench_") as tmp:
            r = run.run_cell(spec, cell, seed, args.seconds, False, device, Path(tmp),
                             cfg=copy.deepcopy(cfg), with_control=True)
        print(json.dumps({"workload": cell["name"], "seed": seed, "correct": r["correct"],
                          "program": {k: v["value"] for k, v in r["check"].items()},
                          "control": r["control"], "metrics": r["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
