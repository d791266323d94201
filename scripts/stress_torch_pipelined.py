"""Launch K4 (the ring-fed bin-max carry) many times and count the launches
whose carry differs from K1's kernel carry, with and without the proxy fence
that orders the float32 stage's ldmatrix reads before the slot's TMA
refill. On one GPU.

    python3 scripts/stress_torch_pipelined.py [--reps 1000]

Builds ``csrc/bin_topk_pipelined.cu`` as it is (``fenced``) and from a copy
of ``csrc/`` whose ``ring_tiles.cuh`` has the float32 consumers'
``fence_proxy_async_shared()`` call removed (``unfenced``; the bf16 stage is
read by wgmma descriptors, through the async proxy, and has no such fence),
with the port's nvcc flags, each into its own directory under
``build/stress_pipelined/``, and loads both with ctypes. For bf16 and f32
unit-row inputs (seeded) at two shapes, the serving shape (300,000 valid
rows of 300,032 x 1024, B = 128, bins = 4096) and one super-tile (its first
65,536 rows, bins = 65,536, so that every product reaches the carry), and
for every ring depth the dtype takes (``STAGES``: 2-5 bf16, 2-3 float32),
it launches each build ``--reps`` times and compares every carry with K1's
kernel carry (``ops.bin_topk.bin_topk_carry``) bit for bit. It also times
each build at the serving shape (CUDA-event mean of 20 launches, 3 stages)
beside K1, in turns. Prints one line per count and a JSON summary last;
exits 1 if a launch of the fenced build differed, 2 without a device.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
FENCE_FILE = "ring_tiles.cuh"
FENCE_CALL = "  fence_proxy_async_shared();\n"
BUILDS = ("fenced", "unfenced")
ENTRIES = {
    torch.bfloat16: "bin_topk_pipelined_carry",
    torch.float32: "bin_topk_pipelined_carry_f32",
}
# Every ring depth of each dtype (ops.bin_topk_pipelined.MAX_BUFFERS).
STAGES = {torch.bfloat16: (2, 3, 4, 5), torch.float32: (2, 3)}


def build_all(out_dir: Path) -> dict[str, ctypes.CDLL]:
    """{build: library}: the sources as they are, and without the fence call."""
    from lean_explore_tpu_torch.ops.cuda_build import CSRC_DIR, NVCC_FLAGS, nvcc_path

    fenced = (CSRC_DIR / FENCE_FILE).read_text()
    if fenced.count(FENCE_CALL) != 1:
        raise SystemExit(f"expected one fence_proxy_async_shared() call in {FENCE_FILE}")
    procs = {}
    for name in BUILDS:
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        for header in CSRC_DIR.glob("*.cuh"):
            (d / header.name).write_text(header.read_text())
        if name == "unfenced":
            (d / FENCE_FILE).write_text(fenced.replace(FENCE_CALL, ""))
        (d / "kernel.cu").write_text((CSRC_DIR / "bin_topk_pipelined.cu").read_text())
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "kernel.cu")]
        procs[name] = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
    libs = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for the {name} build:\n{out}")
        lib = ctypes.CDLL(str(out_dir / name / "lib.so"))
        for dtype, entry in ENTRIES.items():
            fn = getattr(lib, entry)
            pointers = 5 if dtype == torch.float32 else 4  # the f32 entry takes q_split
            fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 8 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launch(lib, q, corpus, n_valid, bins, n_buffers) -> torch.Tensor:
    """The build's carry [bins, B], launched as the port's wrapper launches it."""
    from lean_explore_tpu_torch.ops import bin_topk as K

    n, dim = corpus.shape
    groups = K.ring_supertile_groups(corpus.device, n, q.shape[0], bins)
    out, partial, groups = K.carry_buffers(corpus, q.shape[0], bins, groups)
    scratch = K.split_scratch(q) if corpus.dtype == torch.float32 else None
    split = [] if scratch is None else [scratch.data_ptr()]
    status = getattr(lib, ENTRIES[corpus.dtype])(
        q.data_ptr(), *split, corpus.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        q.shape[0], n, dim, int(n_valid), bins, K.steal_bits_for(n, bins), groups,
        n_buffers, torch.cuda.current_stream().cuda_stream,
    )
    if status != 0:
        raise RuntimeError(f"launch failed: cudaError {status}")
    return out


def unit_rows(n, d, gen, dtype) -> torch.Tensor:
    x = torch.randn(n, d, generator=gen, device="cuda", dtype=torch.float32)
    return (x / x.norm(dim=1, keepdim=True)).to(dtype)


def cuda_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=1000, help="launches per count")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from lean_explore_tpu_torch.ops import bin_topk as K

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(card, flush=True)
    libs = build_all(REPO / "build" / "stress_pipelined")
    counts, times = [], {}
    for dtype in ENTRIES:
        gen = torch.Generator(device="cuda").manual_seed(0)
        corpus = torch.zeros(300_032, 1024, dtype=dtype, device="cuda")
        corpus[:300_000] = unit_rows(300_000, 1024, gen, dtype)
        q = unit_rows(128, 1024, gen, dtype)
        shapes = (("serving", corpus, 300_000, 4096),
                  ("one super-tile", corpus[:65_536], 65_536, 65_536))
        for shape, c, n_valid, bins in shapes:
            want = K.bin_topk_carry(q, c, n_valid, bins).view(torch.int32)
            for name, lib in libs.items():
                for n_buffers in STAGES[dtype]:
                    bad = words = 0
                    for _ in range(args.reps):
                        got = launch(lib, q, c, n_valid, bins, n_buffers).view(torch.int32)
                        if not torch.equal(got, want):
                            bad += 1
                            words += int((got != want).sum())
                    row = {"build": name, "dtype": str(dtype).split(".")[-1], "shape": shape,
                           "n_buffers": n_buffers, "launches": args.reps,
                           "differing_launches": bad, "differing_words": words}
                    counts.append(row)
                    print(json.dumps(row), flush=True)
        k1 = lambda: K.bin_topk_carry(q, corpus, 300_000, 4096)  # noqa: E731
        key = str(dtype).split(".")[-1]
        times[key] = {"k1_ms": [cuda_ms(k1)]}
        for name, lib in libs.items():
            times[key][f"{name}_ms"] = cuda_ms(
                lambda lib=lib: launch(lib, q, corpus, 300_000, 4096, 3)
            )
        times[key]["k1_ms"].append(cuda_ms(k1))
        print(json.dumps({key: times[key]}), flush=True)
    fenced_bad = sum(r["differing_launches"] for r in counts if r["build"] == "fenced")
    print(json.dumps({"card": card, "fenced_differing_launches": fenced_bad,
                      "counts": counts, "serving_ms_at_3_stages": times}))
    return 1 if fenced_bad else 0


if __name__ == "__main__":
    sys.exit(main())
