"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix; the configuration's entry
names its file, the mix is ``traffic/<name>.json``, and each per-layer
metric is read by ``metrics/<name>.py``'s ``read(ctx)``. Adding a cell,
a configuration, a mix or a metric adds files and entries; no code here
changes.
"""

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent


class Spec:
    def __init__(self, root: Path, bench_dir: Path = BENCH_DIR):
        self.root = root
        self.bench_dir = bench_dir
        self.data = json.loads((root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for cell in self.data["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for entry in self.data["configs"]:
            if entry["name"] == name:
                return json.loads((self.root / entry["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench_dir / "traffic" / f"{name}.json").read_text())

    def metrics(self, kind: str, cell: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` entries reported in ``cell``."""
        return [m for m in self.data[kind] if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric: str):
        path = self.bench_dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"bench_metric_{metric.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
