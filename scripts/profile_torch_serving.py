"""Where one serving batch of the PyTorch port spends its time, on one GPU.

    python3 scripts/profile_torch_serving.py [--rows 300000]

Builds the serving set-up of chip_smoke.py phase 4 through its
``build_service`` (synthetic store, BM25 name indices, a bf16 dense index
on the card, two Qwen3-0.6B-geometry clients with random weights), warms
once, then runs one batch of 128 queries through ``Service.search_batch``
under ``torch.profiler`` and prints:

- the batch's wall time and the engine's stage split (host clock);
- the device busy share: the union of CUDA kernel intervals over the
  batch's wall time (so 1 - busy is the device's idle share);
- the ten CUDA kernels with the most device time.

Needs a CUDA device; exits 2 without one.
"""

import argparse
import asyncio
import sys
import tempfile
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent


def _union_us(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if start > end:
            total += stop - start
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", type=int, default=300_000)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serving: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from lean_explore_tpu_torch.util.profiling import StageTimings

    device = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="profile_serving_") as tmp:
        service = cs.build_service(device, tmp, args.rows).service()
        asyncio.run(service.search_batch(cs.queries_for(999)))
        torch.cuda.synchronize()

        timings = StageTimings()
        activities = [
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA,
        ]
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            asyncio.run(service.search_batch(cs.queries_for(0), timings=timings))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1000.0

    kernels = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    busy_ms = _union_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1000
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        entry = by_name.setdefault(e.name, [0.0, 0])
        entry[0] += (e.time_range.end - e.time_range.start) / 1000
        entry[1] += 1
    card = torch.cuda.get_device_name(0)
    print(f"card: {card}, {torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    print(f"batch of {cs.BATCH}: {wall_ms:.1f} ms wall; stages (ms) "
          f"{ {k: round(v, 2) for k, v in timings.as_dict().items()} }")
    print(f"device busy {busy_ms:.1f} ms = {busy_ms / wall_ms:.4f} of the batch "
          f"({len(kernels)} kernel launches)")
    print("top CUDA kernels by device time (ms, launches):")
    for name, (ms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  {ms:9.3f} {count:6d}  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
