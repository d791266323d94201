"""What the port's spans (``lean_explore_tpu_torch.util.profiling``) cost
on this host, and where their ``lx.*`` ranges land in a profiler's trace:

    python3 scripts/measure_torch_span_cost.py [--n 200000]

Prints one JSON line: microseconds per span opened and closed on its own
(as the serving path opens them, recorded in the ring), with a counter,
with CUDA events (``device=``, on a card), and while a ``torch.profiler``
records (the ``lx.*`` mirror on); and, on a card, whether an ``lx.*``
range or a ``record_function`` range gets a copy on the device's timeline
(a copy there would count as device work in a trace's busy time).
"""

import argparse
import json
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from lean_explore_tpu_torch.util.profiling import count, span  # noqa: E402


def per_span_us(n: int, body) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        body()
    return (time.perf_counter() - t0) / n * 1e6


def plain():
    with span("cost"):
        pass


def counted():
    with span("cost"):
        count("tokens", 3)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=200_000)
    args = parser.parse_args(argv)
    cuda = torch.cuda.is_available()
    out = {"device": torch.cuda.get_device_name(0) if cuda else "cpu", "torch": torch.__version__}
    per_span_us(1000, plain)
    out["span_us"] = per_span_us(args.n, plain)
    out["span_count_us"] = per_span_us(args.n, counted)
    acts = [ProfilerActivity.CPU]
    if cuda:
        dev = torch.device("cuda:0")
        torch.ones(1, device=dev).add_(1)

        def events():
            with span("cost", device=dev):
                pass

        out["span_device_us"] = per_span_us(args.n // 10, events)
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        out["span_profiled_us"] = per_span_us(args.n // 10, plain)
    if cuda:
        a = torch.randn(512, 512, device=dev)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            with span("mirrored"):
                a @ a
            with torch.profiler.record_function("user.range"):
                a @ a
            torch.cuda.synchronize()
        on_device = sorted({e.name() for e in prof.profiler.kineto_results.events()
                            if e.device_type() == torch.autograd.DeviceType.CUDA})
        out["device_events"] = on_device
        out["lx_on_device"] = any(n.startswith("lx.") for n in on_device)
        out["record_function_on_device"] = "user.range" in on_device
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
