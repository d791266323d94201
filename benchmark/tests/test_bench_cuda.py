"""Runs of ``benchmark/run.py`` as the benchmark is run: in a process of
its own, with nothing but the port loaded. The card-only case has the
``cuda`` marker and skips, with its reason, where there is no card."""

import json
import subprocess
import sys

import pytest

import tiny


def test_a_tiny_run_loads_no_jax_and_no_jax_package():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import tiny\n"
        "out = tiny.run_tiny('qwen3-0.6b.closed', seconds=1.5)\n"
        "from harness.guard import forbidden_modules\n"
        "print(out['correct'], forbidden_modules(sys.modules), 'lean_explore_tpu_torch' in sys.modules)\n"
    ) % (str(tiny.BENCH / "tests"), str(tiny.BENCH))
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                          cwd=tiny.ROOT)
    assert done.returncode == 0, done.stderr[-3000:]
    assert done.stdout.strip().splitlines()[-1] == "True [] True"


@pytest.mark.cuda
def test_each_cell_runs_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run the port on the card")
    for cell in ("qwen3-0.6b.closed", "qwen3-0.6b.index-embed"):
        done = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", cell, "--seed", "4242424242",
             "--seconds", "5", "--trace", "0"],
            capture_output=True, text=True, timeout=900, cwd=tiny.ROOT)
        assert done.returncode == 0, done.stderr[-3000:]
        result = json.loads(done.stdout.strip().splitlines()[-1])
        assert result["correct"] and result["device"]["platform"] == "gpu"
        assert "setup_s" in result["metrics"]
