"""Which torch.distributed collectives two ranks on one CUDA card can run.

    python3 scripts/probe_torch_collectives.py [--timeout S]

Starts two pairs of ranks on ``cuda:0``, rendezvous through a ``file://``
in a temporary directory:

- gloo: each collective of ``COLLECTIVES`` on CUDA tensors, in turn, its
  result checked; what it raised where it did not run;
- NCCL: one ``all_reduce``, which NCCL is expected to refuse with two
  ranks on one GPU.

Prints one JSON object: {"gloo": {name: "ok" | error}, "nccl": "ok" |
error, "card": torch.cuda.get_device_name(0)}. A rank that does not end
within the timeout is killed and reported as such. This is the record
behind ``parallel.mesh.init_distributed``'s choice of backend and of the
collectives (all_reduce and all_gather_into_tensor, with barrier) that
the port's mesh uses.
Needs a CUDA card; exits 2 without one.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

WORLD = 2
COLLECTIVES = (
    "all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
    "reduce_scatter_tensor", "reduce", "barrier",
)


def _error(exc: BaseException) -> str:
    return f"{type(exc).__name__}: {' '.join(str(exc).split())}"[:600]


def _run_collective(name: str, rank: int):
    """Run one collective on CUDA tensors and check its result."""
    import torch
    import torch.distributed as dist

    x = torch.full((4,), float(rank + 1), device="cuda:0")
    total = float(sum(range(1, WORLD + 1)))
    if name == "all_reduce":
        dist.all_reduce(x)
        ok = bool((x == total).all())
    elif name == "broadcast":
        dist.broadcast(x, src=0)
        ok = bool((x == 1.0).all())
    elif name == "all_gather":
        parts = [torch.empty_like(x) for _ in range(WORLD)]
        dist.all_gather(parts, x)
        ok = all(bool((p == r + 1).all()) for r, p in enumerate(parts))
    elif name == "all_gather_into_tensor":
        out = torch.empty(WORLD * 4, device="cuda:0")
        dist.all_gather_into_tensor(out, x)
        ok = bool((out.view(WORLD, 4)[:, 0] == torch.arange(1, WORLD + 1, device="cuda:0")).all())
    elif name == "reduce_scatter_tensor":
        out = torch.empty(2, device="cuda:0")
        dist.reduce_scatter_tensor(out, torch.full((WORLD * 2,), float(rank + 1), device="cuda:0"))
        ok = bool((out == total).all())
    elif name == "reduce":
        dist.reduce(x, dst=0)
        ok = rank != 0 or bool((x == total).all())
    else:
        dist.barrier()
        ok = True
    torch.cuda.synchronize()
    return "ok" if ok else "wrong result"


def rank_main(backend: str, rank: int, init: str, out: Path) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    result: dict = {}
    try:
        dist.init_process_group(
            backend, init_method=init, world_size=WORLD, rank=rank,
            timeout=timedelta(seconds=60),
        )
        if backend == "nccl":
            x = torch.ones(4, device="cuda:0")
            dist.all_reduce(x)
            torch.cuda.synchronize()
            result["nccl"] = "ok" if bool((x == WORLD).all()) else "wrong result"
        else:
            result["gloo"] = {}
            for name in COLLECTIVES:
                try:
                    result["gloo"][name] = _run_collective(name, rank)
                except Exception as exc:  # noqa: BLE001 - the probe records each refusal
                    result["gloo"][name] = _error(exc)
    except Exception as exc:  # noqa: BLE001 - NCCL's refusal is the finding
        result[backend] = _error(exc)
    out.write_text(json.dumps(result))
    os._exit(0)  # a refused NCCL communicator may not tear down cleanly


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--timeout", type=float, default=120.0)
    parser.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--backend", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--init", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--out", type=Path, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.rank is not None:
        rank_main(args.backend, args.rank, args.init, args.out)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("probe_torch_collectives: no CUDA device", file=sys.stderr)
        return 2
    report = {"card": torch.cuda.get_device_name(0)}
    with tempfile.TemporaryDirectory(prefix="probe_collectives_") as tmp:
        procs = []
        for backend in ("gloo", "nccl"):
            init = f"file://{tmp}/{backend}_rendezvous"
            for rank in range(WORLD):
                out = Path(tmp) / f"{backend}{rank}.json"
                procs.append((backend, rank, out, subprocess.Popen(
                    [sys.executable, __file__, "--rank", str(rank), "--backend", backend,
                     "--init", init, "--out", str(out)],
                    stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                )))
        deadline = time.monotonic() + args.timeout
        for backend, rank, out, proc in procs:
            try:
                proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            if rank == 0 and backend not in report:
                report[backend] = (
                    json.loads(out.read_text())[backend] if out.exists()
                    else f"rank 0 did not finish within {args.timeout} s"
                )
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
