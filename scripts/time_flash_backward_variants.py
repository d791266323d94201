"""Where does the bf16 flash-attention backward's time go, and which block
shape serves it best? On one GPU.

    python3 scripts/time_flash_backward_variants.py

Builds ``csrc/flash_attention_bwd.cu`` as it is ("base") and in variants,
each made by replacing exact strings in a copy of the source (every string
must occur as often as the variant says, or the script stops: a variant
that no longer matches the kernel is rebuilt, not skipped). The variants
that compute the same function write the gradients straight from the
accumulators as bf16 pairs (``unstaged_store``, where the kernels stage
them in shared memory and store whole rows) or change a block's shape: its
warpgroups of 64 fixed rows and blocks an SM (``dkv_two_groups``: two
warpgroups, one block an SM; ``dq_one_group``: one, over a three-stage
ring, two blocks an SM); each is held against the plain twin
``attention_flash_bwd_plain`` within ``bwd_kernel_tolerance``. Four are
ablations, whose output is wrong by design: ``no_products`` (no wgmma is
issued), ``no_stream_copies`` (the streamed tiles are never copied; their
lse, di and segment ids still are, so the same tiles are skipped),
``no_fixed_copies`` (the fixed tiles are never copied) and ``no_softmax``
(p and ds are not formed). Then the CUDA-event mean of 20 launches of the
dq and dk/dv entries of each build, in turns (base, the
variants, the variants again in reverse, base), at the training shape
(B 32 x T 256, 16/8 heads, DH 128) on chip_smoke.py's check mask, 5b's
documents and full rows. Prints the card's name and power limit, one JSON
line per mask and entry, the registers and spill bytes ``ptxas -v``
reports per variant and kernel function, and a last JSON line. Exits 1 if
base or a same-function variant leaves its tolerance, 2 without a device.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "lean_explore_tpu_torch" / "csrc"
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

DKV = "constexpr int DKV_GROUPS = 1, DKV_STAGES = 3, DKV_BLOCKS = 2;"
DQ = "constexpr int DQ_GROUPS = 2, DQ_STAGES = 2, DQ_BLOCKS = 2;"
# variant: (whether it computes the same function, [(string, replacement,
# occurrences)])
VARIANTS = {
    "unstaged_store": (True, [
        ("    store_group<DH, S::FIXED_ROWS>(dk, smem, wg, a.dk + base, stride, tid);\n"
         "    store_group<DH, S::FIXED_ROWS>(dv, smem + S::FIXED, wg, a.dv + base, stride, tid);",
         "    const long long rows0 = base - (long long)kg * stride * 2;\n"
         "    store_rows<DH>(a.dk + rows0, stride, kw + (lane >> 2),\n"
         "                   *reinterpret_cast<const float(*)[DH / 8][4]>(&dk), lane);\n"
         "    store_rows<DH>(a.dv + rows0, stride, kw + (lane >> 2),\n"
         "                   *reinterpret_cast<const float(*)[DH / 8][4]>(&dv), lane);", 1),
        ("    store_group<DH, S::FIXED_ROWS>(dq, smem, wg,\n"
         "                                   a.dq + (((long long)b * T + qg) * a.NQ + h) * DH * 2, "
         "stride,\n                                   tid);",
         "    store_rows<DH>(a.dq + (((long long)b * T) * a.NQ + h) * DH * 2, stride, row_lo,\n"
         "                   *reinterpret_cast<const float(*)[DH / 8][4]>(&dq), lane);", 1),
    ]),
    "dkv_two_groups": (True, [
        (DKV, "constexpr int DKV_GROUPS = 2, DKV_STAGES = 3, DKV_BLOCKS = 1;", 1)]),
    "dq_one_group": (True, [
        (DQ, "constexpr int DQ_GROUPS = 1, DQ_STAGES = 3, DQ_BLOCKS = 2;", 1)]),
    "no_products": (False, [
        ("    rows_x_stream<DH, S::FIXED_ROWS>(", "    if (false) rows_x_stream<DH, S::FIXED_ROWS>(", 4),
        ("    acc_x_stream<DH>(", "    if (false) acc_x_stream<DH>(", 3),
    ]),
    "no_stream_copies": (False, [
        ("  load_swizzled<DH, STREAM_ROWS, S::THREADS>(tiles, first, stride, tid);\n"
         "  load_swizzled<DH, STREAM_ROWS, S::THREADS>(tiles + S::STREAM, second, stride, tid);\n",
         "  (void)tiles;\n", 1),
    ]),
    "no_fixed_copies": (False, [
        ("  load_swizzled<DH, S::FIXED_ROWS, S::THREADS>(",
         "  if (false) load_swizzled<DH, S::FIXED_ROWS, S::THREADS>(", 4),
    ]),
    "no_softmax": (False, [
        ("\n    probabilities<true>(p, key_seg, q_seg, kw, q0, no_rows, rows, lane, scale_log2);",
         "", 1),
        ("\n    score_grads<true>(ds, p, no_rows, rows + STREAM_ROWS, lane, a.sm_scale);", "", 1),
        ("\n    probabilities<false>(p, q_seg, k_seg, qw, k0, lse2, nullptr, lane, scale_log2);",
         "", 1),
        ("\n    score_grads<false>(ds, p, dis, nullptr, lane, a.sm_scale);", "", 1),
    ]),
}
REPS = 20


def variant_source(edits) -> str:
    """The kernel's source with each (string, replacement, occurrences) of
    ``edits`` applied; raises when a string occurs another number of times."""
    source = (CSRC / "flash_attention_bwd.cu").read_text()
    for old, new, count in edits:
        if source.count(old) != count:
            raise ValueError(f"variant no longer matches the kernel: {old[:60]!r} occurs "
                             f"{source.count(old)} times, not {count}")
        source = source.replace(old, new)
    return source


def build_all(out_root: Path) -> dict:
    """{variant: (library, ptxas lines)}, base included, one nvcc each, all
    started together."""
    import ctypes

    from compare_torch_kernel_builds import _configure, ptxas_functions
    from lean_explore_tpu_torch.ops.cuda_build import NVCC_FLAGS, nvcc_path

    procs = {}
    for name, edits in [("base", [])] + [(n, e) for n, (_, e) in VARIANTS.items()]:
        out_dir = out_root / name
        out_dir.mkdir(parents=True, exist_ok=True)
        src = out_dir / "flash_attention_bwd.cu"
        src.write_text(variant_source(edits))
        lib = out_dir / "libflash_attention_bwd.so"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        built[name] = (ctypes.CDLL(str(lib)), ptxas_functions(log))
        _configure("flash_attention_bwd", built[name][0])
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
        print("time_flash_backward_variants: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from compare_torch_kernel_builds import run_bwd
    from lean_explore_tpu_torch.ops import flash_attention as FA

    libs = build_all(REPO / "build" / "flash_bwd_variants")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    ok = True
    names = ["base", *VARIANTS]
    b, t, scale = smoke.TRAIN_B, smoke.TRAIN_T, smoke.FLASH_DH**-0.5
    workloads = smoke.workload_flash_masks("cuda")
    masks = {
        "check": smoke.training_flash_mask(b, t, 70, "cuda"),
        "train_5b": workloads["train_5b"],
        "train_full": workloads["train_full"],
    }
    for label, mask in masks.items():
        q, k, v, _ = smoke.flash_inputs(b, t, [t] * b, 70, "cuda", torch.bfloat16)
        out, lse = FA.attention_flash_plain(q, k, v, mask, scale, with_lse=True)
        gen = torch.Generator(device="cuda").manual_seed(71)
        dout = (torch.randn(out.shape, generator=gen, device="cuda") * mask[..., None])
        dout = dout.to(torch.bfloat16)
        inputs = (q, k, v, mask, dout, lse, FA.row_dot(out, dout, smoke.FLASH_NQ))
        want = FA.attention_flash_bwd_plain(q, k, v, mask, out, lse, dout, scale)
        tols = FA.bwd_kernel_tolerance(q, k, v, mask, lse, dout, inputs[-1], scale)
        for dq_entry in (True, False):
            pick = slice(0, 1) if dq_entry else slice(1, 3)
            errs = {}
            for name in names:
                if name == "base" or VARIANTS[name][0]:
                    got = run_bwd(libs[name][0], inputs, dq_entry)
                    torch.cuda.synchronize()
                    finite = all(bool(torch.isfinite(x).all()) for x in got)
                    errs[name] = [float((x.float() - ref.float()).abs().max()) if finite
                                  else None for x, ref in zip(got, want[pick])]
            right = all(e is not None and e <= tol for errors in errs.values()
                        for e, tol in zip(errors, tols[pick]))
            ok &= right
            times = in_turns(libs, names, lambda lib: run_bwd(lib, inputs, dq_entry))
            print(json.dumps({
                "mask": label, "entry": "dq" if dq_entry else "dkv", "batch": b, "seq": t,
                "tol": tols[pick], "max_abs_err": errs, "within_tolerance": right,
                "ms_in_turns": times,
            }), flush=True)
        del q, k, v, out, lse, dout, inputs, want
    for name, (_, functions) in libs.items():
        for line in functions:
            if "f32" in line or "max_over_groups" in line:
                continue
            print(f"{name}: {line}", flush=True)
    print(json.dumps({"within_tolerance": ok, "card": card}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
