"""Where does the time of the float32 retrieval kernels (K1-f32, K3-f32: 3xTF32
on wgmma, fed by a TMA ring) go, and which block shape serves them best? On
one GPU.

    python3 scripts/time_tf32_variants.py

Builds ``csrc/bin_topk.cu`` and ``csrc/windowed_scores.cu`` as they are
("base") and in variants, each from a copy of ``csrc/`` in which exact
strings of one or more files are replaced (every string must occur as often
as the variant says, or the script stops: a variant that no longer matches
the kernels is rebuilt, not skipped). Four are ablations, whose output is
wrong by design: ``no_query_copies`` (the producer copies only the corpus
tile of a stage, not the query halves), ``no_split`` (the corpus fragments
go to the products unsplit), ``no_products`` (no wgmma is issued) and, for
K1, ``no_fold`` (a super-tile's scores are added into the carry, not
packed and folded) or, for K3, ``no_store`` (no score, window maximum or
staged tile is written; the scores' sum decides one store that never
happens, so that the products stay live). The others compute the same
function in the same order and must give base's bits: ``carry_2_stages``
(K1's ring of 3 stages cut to 2), ``carry_in_registers`` (K1's carry in
registers over a 4-stage ring, where shared memory holds it: the kernel
then spills),
``carry_split_each_step`` (K1 splits each k8 slice of a stage just before
its three products, as K3 does), ``window_2_stages`` (K3's 3 stages cut
to 2), ``window_split_first`` (K3 splits the whole stage first, as K1
does) and ``window_thread_store`` (K3's warpgroups write their staged
scores 4 bytes a store, where they write 16). Base
is held against the plain twins (``bin_topk_carry_plain`` within two
packing quanta plus ``score_tolerance``, ``fused_scores_wmax_plain`` within
``score_tolerance``). Then the CUDA-event mean of 20 launches of
each build's entry, in turns (base, the variants, the variants again in
reverse, base), at the serving shape: 300,000 valid unit rows of a
300,032 x 1024 float32 corpus, B = 128, bins = 4096, window 8. Prints the
card's name and power limit, one JSON line per kernel, the registers and
spill bytes ``ptxas -v`` reports per variant and f32 kernel function, and a
last JSON line. Exits 1 if base leaves its tolerance or a same-function
variant differs from base, 2 without a device.
"""

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "lean_explore_tpu_torch" / "csrc"
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

N_ROWS, N_VALID, DIM, BATCH, BINS, WINDOW = 300_032, 300_000, 1024, 128, 4096, 8
K1, K3 = "bin_topk_f32", "windowed_scores_f32"
# The ring's fill (ring_tiles.cuh), shared by the bf16 and the f32 kernels.
FILL = (
    "  mbar_arrive_expect_tx(full, RowRing<QUERY_BOXES>::STAGE);\n"
    "  tma_load(stage, corpus, k0, row0, full);\n"
    "  tma_load(stage + CORPUS_BOX, queries, k0, q0, full);\n"
    "  if constexpr (QUERY_BOXES == 2) tma_load(stage + CORPUS_BOX + QUERY_BOX, q_lo, k0, q0, full);\n"
)
NO_QUERY_COPIES = (
    "  mbar_arrive_expect_tx(full, CORPUS_BOX);\n"
    "  tma_load(stage, corpus, k0, row0, full);\n"
)
# The carry kernel's carry in registers where shared memory holds it (every
# element type: ring_carry.cuh).
CARRY_IN_REGISTERS = [
    ("ring_carry.cuh", "constexpr int GROUP_THREADS = 128;", "constexpr int GROUP_THREADS = 1;",
     1),
    ("ring_carry.cuh",
     "  float* carry = reinterpret_cast<float*>(ring.after()) +\n"
     "                 (warp >> 2) * RING_ACC * GROUP_THREADS + (warp & 3) * 32 + lane;\n",
     "  float carry_registers[RING_ACC];\n"
     "  float* carry = carry_registers;\n", 1)]
# The windowed kernel's rows written 4 bytes a store where B % 4 == 0 allows
# 16 (both element types).
THREAD_STORE = [("windowed_scores.cu", "  if ((B & 3) == 0) {", "  if (false) {", 1)]
# variant: (whether it computes base's function, the kernels it is timed on,
# [(file, string, replacement, occurrences)])
VARIANTS = {
    "no_query_copies": (False, (K1, K3), [
        ("ring_tiles.cuh", FILL, NO_QUERY_COPIES, 1)]),
    "no_split": (False, (K1, K3), [
        ("ring_tiles.cuh", "F32Product::split(raw[kk], hi[kk], lo[kk]);",
         "for (int i = 0; i < 4; ++i) hi[kk][i] = lo[kk][i] = raw[kk][i];", 2)]),
    "no_products": (False, (K1, K3), [
        ("ring_tiles.cuh", "    wgmma_tf32_rs(acc, ", "    if (false) wgmma_tf32_rs(acc, ", 3)]),
    "no_fold": (False, (K1,), [
        ("ring_carry.cuh",
         "        fold_acc<Stage>(carry, acc, (uint32_t)p, bins, s, n_valid, low_mask, rs, "
         "query_scales,\n                        warp, lane);",
         "        for (int i = 0; i < RING_ACC; ++i) {\n"
         "          carry[i * GROUP_THREADS] += acc[i];\n"
         "          acc[i] = 0.0f;\n"
         "        }", 1)]),
    "no_store": (False, (K3,), [
        ("windowed_scores.cu", "      store_scores(acc, ",
         "      float sum = 0.0f;\n"
         "      for (int i = 0; i < RING_ACC; ++i) sum += acc[i];\n"
         "      if (sum == 1234.5f) scores_t[0] = sum;\n"
         "      if (false) store_scores(acc, ", 1)]),
    "carry_2_stages": (True, (K1,), [
        ("bin_topk.cu", "constexpr int CARRY_STAGES = 3;", "constexpr int CARRY_STAGES = 2;",
         1)]),
    "carry_in_registers": (True, (K1,), [
        ("bin_topk.cu", "constexpr int CARRY_STAGES = 3;", "constexpr int CARRY_STAGES = 4;", 1),
        *CARRY_IN_REGISTERS]),
    "carry_split_each_step": (True, (K1,), [
        ("bin_topk.cu", "Tf32Stage<false>", "Tf32Stage<true>", 1)]),
    "window_2_stages": (True, (K3,), [
        ("windowed_scores.cu", "constexpr int WINDOW_STAGES = 3;",
         "constexpr int WINDOW_STAGES = 2;", 1)]),
    "window_split_first": (True, (K3,), [
        ("windowed_scores.cu", "Tf32Stage<true>", "Tf32Stage<false>", 1)]),
    "window_thread_store": (True, (K3,), THREAD_STORE),
}
REPS = 20


def variant_tree(out_dir: Path, edits) -> Path:
    """A copy of csrc/ under out_dir with each (file, string, replacement,
    occurrences) of ``edits`` applied; raises when a string occurs another
    number of times."""
    tree = out_dir / "csrc"
    if tree.exists():
        shutil.rmtree(tree)
    shutil.copytree(CSRC, tree)
    for name, old, new, count in edits:
        path = tree / name
        source = path.read_text()
        if source.count(old) != count:
            raise ValueError(f"variant no longer matches {name}: {old[:60]!r} occurs "
                             f"{source.count(old)} times, not {count}")
        path.write_text(source.replace(old, new))
    return tree


def build_all(out_root: Path, variants: dict | None = None,
              sources: tuple = ("bin_topk", "windowed_scores")) -> dict:
    """{variant: {source: (library, ptxas lines)}}, base included, one nvcc
    per source of ``sources`` and variant of ``variants`` (default
    VARIANTS), all started together; each library's entries configured
    (K1's and K3's bf16 and f32 ones, K2's int8 one)."""
    from compare_torch_kernel_builds import _configure, ptxas_functions
    from lean_explore_tpu_torch.ops.cuda_build import NVCC_FLAGS, nvcc_path

    variants = VARIANTS if variants is None else variants
    procs = {}
    for name, edits in [("base", [])] + [(n, v[2]) for n, v in variants.items()]:
        tree = variant_tree(out_root / name, edits)
        for source in sources:
            lib = out_root / name / f"lib{source}.so"
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(lib), str(tree / f"{source}.cu")]
            procs[name, source] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for (name, source), (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name} ({source}):\n{log}")
        built.setdefault(name, {})[source] = (ctypes.CDLL(str(lib)), ptxas_functions(log))
    for libs in built.values():
        for source, (lib, _) in libs.items():
            _configure(source, lib)
    return built


def runners(q, corpus) -> dict:
    """{kernel: (run(libs), output())} at the serving shape: ``run``
    launches a build's entry with the wrappers' grid, ``output`` gives the
    last launch's output as one tensor."""
    from lean_explore_tpu_torch.ops import bin_topk as K

    steal = K.steal_bits_for(N_ROWS, BINS)
    groups = K.ring_supertile_groups(corpus.device, N_ROWS, BATCH, BINS)
    split = K.split_scratch(q)
    scores = torch.empty(N_ROWS, BATCH, device="cuda")
    wmax = torch.empty(N_ROWS // WINDOW, BATCH, device="cuda")
    last = {}

    def carry(libs):
        out, partial, _ = K.carry_buffers(corpus, BATCH, BINS, groups)
        status = libs["bin_topk"][0].bin_topk_carry_f32(
            q.data_ptr(), split.data_ptr(), corpus.data_ptr(), out.data_ptr(),
            partial.data_ptr() if partial is not None else None, BATCH, N_ROWS, DIM, N_VALID,
            BINS, steal, groups, torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise RuntimeError(f"bin_topk_carry_f32: cudaError {status}")
        last[K1] = out

    def windowed(libs):
        status = libs["windowed_scores"][0].windowed_scores_f32(
            q.data_ptr(), split.data_ptr(), corpus.data_ptr(), scores.data_ptr(),
            wmax.data_ptr(), BATCH, N_ROWS, DIM, N_VALID, WINDOW,
            torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise RuntimeError(f"windowed_scores_f32: cudaError {status}")

    return {
        K1: (carry, lambda: last[K1].clone()),
        K3: (windowed, lambda: torch.cat([scores.flatten(), wmax.flatten()])),
    }


def in_turns(run, built: dict, names: list[str]) -> dict[str, list[float]]:
    """CUDA-event ms a launch of ``run(libs)`` per build: base, the others,
    the others in reverse, base."""
    times = {name: [] for name in names}
    for name in names + names[::-1]:
        call = lambda: run(built[name])  # noqa: E731
        call()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            call()
        end.record()
        torch.cuda.synchronize()
        times[name].append(round(start.elapsed_time(end) / REPS, 4))
    return times


def base_error(kernel: str, got: torch.Tensor, q, corpus) -> tuple[float, float]:
    """(error, tolerance) of base's output against the plain twin."""
    from lean_explore_tpu_torch.ops import bin_topk as K
    from lean_explore_tpu_torch.ops import windowed as W

    tol = K.score_tolerance(torch.float32, DIM)
    if kernel == K1:
        steal = K.steal_bits_for(N_ROWS, BINS)
        want = K.bin_topk_carry_plain(q, corpus, N_VALID, BINS, steal)
        return float((got - want).abs().max()), 2.0 * 2.0 ** (steal - 22) + tol
    want = torch.cat([x.flatten() for x in W.fused_scores_wmax_plain(q, corpus, N_VALID, WINDOW)])
    finite = torch.isfinite(want)
    if not torch.equal(finite, torch.isfinite(got)):
        return float("inf"), tol
    return float((got[finite] - want[finite]).abs().max()), tol


def serving_inputs(dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """(queries, corpus) of the serving shape in ``dtype``: seeded unit rows,
    the corpus's pad rows zero."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    corpus = torch.zeros(N_ROWS, DIM, device="cuda", dtype=dtype)
    rows = torch.randn(N_VALID, DIM, generator=gen, device="cuda")
    corpus[:N_VALID] = (rows / rows.norm(dim=1, keepdim=True)).to(dtype)
    del rows
    q = torch.randn(BATCH, DIM, generator=gen, device="cuda")
    return (q / q.norm(dim=1, keepdim=True)).to(dtype), corpus


def measure(variants: dict, runners, base_error, dtype: torch.dtype, build_dir: str,
            function_tag: str, sources: tuple = ("bin_topk", "windowed_scores")) -> int:
    """Builds ``sources`` as base and in ``variants``, holds base to its
    plain twins and the same-function variants to base's bits, times every
    build in turns at the serving shape in ``dtype``, prints the ptxas
    lines of the kernel functions whose name holds ``function_tag``;
    returns the exit code."""
    if not torch.cuda.is_available():
        print(f"{Path(sys.argv[0]).name}: needs a CUDA device", file=sys.stderr)
        return 2
    built = build_all(REPO / "build" / build_dir, variants, sources)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    q, corpus = serving_inputs(dtype)
    ok = True
    for kernel, (run, output) in runners(q, corpus).items():
        names = ["base"] + [n for n, v in variants.items() if kernel in v[1]]
        run(built["base"])
        base = output()
        torch.cuda.synchronize()
        err, tol = base_error(kernel, base, q, corpus)
        same = {}
        for name in names[1:]:
            if variants[name][0]:
                run(built[name])
                got = output()
                torch.cuda.synchronize()
                same[name] = torch.equal(got.view(torch.int32), base.view(torch.int32))
        right = err <= tol and all(same.values())
        ok &= right
        print(json.dumps({
            "kernel": kernel, "rows": N_ROWS, "n_valid": N_VALID, "dim": DIM, "batch": BATCH,
            "bins": BINS, "window": WINDOW, "base_max_abs_err": err, "tol": tol,
            "same_bits_as_base": same, "right": right,
            "ms_in_turns": in_turns(run, built, names),
        }), flush=True)
    for name, libs in built.items():
        for source, (_, functions) in libs.items():
            for line in functions:
                if function_tag in line:
                    print(f"{name} {source}: {line}", flush=True)
    print(json.dumps({"right": ok, "card": card}))
    return 0 if ok else 1


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.parse_args()
    return measure(VARIANTS, runners, base_error, torch.float32, "tf32_variants", "tf32")


if __name__ == "__main__":
    sys.exit(main())
