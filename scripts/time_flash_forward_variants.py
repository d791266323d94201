"""Where does the bf16 flash-attention forward's time go, and would a block
of two q heads pay for itself? On one GPU.

    python3 scripts/time_flash_forward_variants.py

Builds ``csrc/flash_attention.cu`` as it is ("base") and in variants, each
made by replacing exact strings in a copy of the source (every string must
occur as often as the variant says, or the script stops: a variant that no
longer matches the kernel is rebuilt, not skipped). ``two_heads`` (bf16)
computes the same function by another design and is held against the
plain twin ``attention_flash_plain`` within ``kernel_tolerance`` on valid
rows: a block of 8 warps holds 128 queries of each of the two q heads of a
GQA group (even and odd), so each K/V tile read from L2 serves both, one
block an SM, against one head's 4 warps, two blocks an SM.

Four are ablations of the bf16 kernel, whose output is wrong by design:
``no_kv_copies`` (K and V never copied in; the segment ids still are, so
the same tiles are skipped), ``no_softmax``, ``no_qk`` and ``no_pv`` (that
step of each tile left out). Then the CUDA-event mean of 20 launches of
each build, in turns (base, the variants, the variants again in reverse,
base), on the masks of the paths the forward serves (chip_smoke.py's
``workload_flash_masks``: 4d's embed batch at B 64 x T 512, 5b's documents
and full rows at B 32 x T 256; 16/8 heads, DH 128). Prints the card's name
and power limit, one JSON line per mask, the registers and spill
bytes ``ptxas -v`` reports per variant and kernel function, and a last
JSON line. Exits 1 if base or ``two_heads`` leaves its tolerance, 2
without a device.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "lean_explore_tpu_torch" / "csrc"
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

# variant: (whether it computes the same function, [(string, replacement,
# occurrences)])
TWO_HEADS = [
    ("constexpr int BF16_THREADS = 32 * BF16_WARPS;",
     "constexpr int BF16_THREADS = 64 * BF16_WARPS;", 1),
    ("static constexpr int RING = F32_ROWS * ROW;",
     "static constexpr int RING = 2 * F32_ROWS * ROW;", 1),
    ('static_assert(2 * (BYTES + 1024) <= 233472, "two bf16 forward blocks exceed an SM");',
     'static_assert(BYTES + 1024 <= 233472, "a bf16 forward block exceeds an SM");', 1),
    ("__launch_bounds__(BF16_THREADS, 2)", "__launch_bounds__(BF16_THREADS, 1)", 1),
    ("  block_place(qb, h, b);\n  const int hk = h / (NQ / NKV);\n"
     "  const int q0 = qb * F32_ROWS;\n  const int qw = q0 + warp * BF16_WARP_ROWS;",
     "  block_place(qb, h, b);\n  h = 2 * h + warp / BF16_WARPS;\n"
     "  const int hk = h / (NQ / NKV);\n  const int q0 = qb * F32_ROWS;\n"
     "  const int qw = q0 + warp % BF16_WARPS * BF16_WARP_ROWS;", 1),
    ("  load_tile<DH, 2, S::ROW, F32_ROWS, BF16_THREADS>(\n"
     "      smem, q + ((long long)b * T + q0) * q_stride + (long long)h * DH * 2, q_stride, tid,\n"
     "      n_queries);",
     "  for (int j = 0; j < 2; ++j)\n"
     "    load_tile<DH, 2, S::ROW, F32_ROWS, BF16_THREADS>(\n"
     "        smem + j * F32_ROWS * S::ROW,\n"
     "        q + ((long long)b * T + q0) * q_stride + (long long)(2 * blockIdx.x + j) * DH * 2,\n"
     "        q_stride, tid, n_queries);", 1),
    ("const dim3 grid(NQ, B,", "const dim3 grid(sizeof(Out) == 1 ? NQ / 2 : NQ, B,", 1),
]
VARIANTS = {
    "two_heads": (True, TWO_HEADS),
    "no_kv_copies": (False, [
        ("    load_tile<DH, 2, S::ROW, BF16_KEYS, BF16_THREADS>(stage, k + off, kv_stride, tid);\n"
         "    load_tile<DH, 2, S::ROW, BF16_KEYS, BF16_THREADS>(stage + S::TILE, v + off, "
         "kv_stride, tid);\n", "    (void)off;\n", 1),
    ]),
    "no_softmax": (False, [
        ("      online_softmax(s[m], o[m], m_run[m], l_run[m], kseg, qseg[m], k0, "
         "row_lo + 16 * m, lane,\n                     scale_log2);\n", "", 1),
    ]),
    "no_qk": (False, [
        ("    rows_x_rows_m<DH, S::ROW>(s, smem, warp * BF16_WARP_ROWS, stage, lane);", "", 1),
    ]),
    "no_pv": (False, [
        ("    acc_x_tile_m<DH, S::ROW, MT, BF16_KEYS>(o, s, stage + S::TILE, lane);", "", 1),
    ]),
}
REPS = 20


def variant_source(edits) -> str:
    """The kernel's source with each (string, replacement, occurrences) of
    ``edits`` applied; raises when a string occurs another number of times."""
    source = (CSRC / "flash_attention.cu").read_text()
    for old, new, count in edits:
        if source.count(old) != count:
            raise ValueError(f"variant no longer matches the kernel: {old[:60]!r} occurs "
                             f"{source.count(old)} times, not {count}")
        source = source.replace(old, new)
    return source


def build_all(out_root: Path) -> dict[str, tuple[ctypes.CDLL, list[str]]]:
    """{variant: (library, ptxas lines)}, base included, one nvcc each, all
    started together."""
    from compare_torch_kernel_builds import _configure, ptxas_functions
    from lean_explore_tpu_torch.ops.cuda_build import NVCC_FLAGS, nvcc_path

    procs = {}
    for name, edits in [("base", [])] + [(n, e) for n, (_, e) in VARIANTS.items()]:
        out_dir = out_root / name
        out_dir.mkdir(parents=True, exist_ok=True)
        src = out_dir / "flash_attention.cu"
        src.write_text(variant_source(edits))
        lib = out_dir / "libflash_attention.so"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        built[name] = (ctypes.CDLL(str(lib)), ptxas_functions(log))
        _configure("flash_attention", built[name][0])
    return built


def in_turns(libs: dict, names: list[str], run) -> dict[str, list[float]]:
    """CUDA-event ms a launch of ``run(lib)`` per build: base, the others,
    the others in reverse, base."""
    order = names + names[::-1]
    times = {name: [] for name in names}
    for name in order:
        lib = libs[name][0]
        run(lib)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            run(lib)
        end.record()
        torch.cuda.synchronize()
        times[name].append(round(start.elapsed_time(end) / REPS, 4))
    return times


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.parse_args()
    if not torch.cuda.is_available():
        print("time_flash_forward_variants: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from compare_torch_kernel_builds import run_flash
    from lean_explore_tpu_torch.ops import flash_attention as FA

    libs = build_all(REPO / "build" / "flash_variants")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    ok = True
    names = ["base", *VARIANTS]
    for label, mask in smoke.workload_flash_masks("cuda").items():
        b, t = mask.shape
        seed = 51 if t == smoke.FLASH_T else 70
        valid = mask.bool()
        q, k, v, _ = smoke.flash_inputs(b, t, [t] * b, seed, "cuda", torch.bfloat16)
        want = FA.attention_flash_plain(q, k, v, mask, smoke.FLASH_DH**-0.5)[valid].float()
        tol = FA.kernel_tolerance(q, k, v, want)
        errs = {}
        for name in names:
            if name == "base" or VARIANTS[name][0]:
                got = run_flash(libs[name][0], q, k, v, mask)
                torch.cuda.synchronize()
                finite = bool(torch.isfinite(got).all())
                errs[name] = float((got[valid].float() - want).abs().max()) if finite else None
        right = all(err is not None and err <= tol for err in errs.values())
        ok &= right
        times = in_turns(libs, names, lambda lib: run_flash(lib, q, k, v, mask))
        print(json.dumps({
            "mask": label, "batch": b, "seq": t, "tol": tol, "max_abs_err": errs,
            "within_tolerance": right, "ms_in_turns": times,
        }), flush=True)
        del q, k, v
    for name, (_, functions) in libs.items():
        for line in functions:
            print(f"{name}: {line}", flush=True)
    print(json.dumps({"within_tolerance": ok, "card": card}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
