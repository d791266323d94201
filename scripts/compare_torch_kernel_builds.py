"""Do the port's retrieval kernels and its flash-attention float32 backward
give the same bits as another tree's build of them, and are both builds'
float32 retrieval kernels, flash-attention forwards and bf16 backward right
and how fast? On one GPU.

    python3 scripts/compare_torch_kernel_builds.py --other unpacked/parent

Builds ``csrc/bin_topk.cu``, ``csrc/bin_topk_int8.cu``,
``csrc/bin_topk_pipelined.cu``, ``csrc/windowed_scores.cu``,
``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu`` of this
tree and of the tree at ``--other`` (for example the parent commit,
unpacked with ``git archive`` into a directory that .gitignore lists) with
the port's nvcc flags, each into its own directory under
``build/compare_builds/``, loads both with ctypes and calls their entry
points on the same inputs: ``bin_topk_carry`` (bf16),
``bin_topk_int8_carry`` (the same corpus and queries quantized per row),
``bin_topk_pipelined_carry`` and ``bin_topk_pipelined_carry_f32`` (K4 at 3
ring stages, bf16 and the same corpus in float32; on mma.sync with 64 x 64
blocks in older trees, K1's wgmma kernel with a ``q_split`` scratch for
float32 in newer ones, each tree's interface and groups read from its
source) and ``windowed_scores``
(bf16) at the serving shape (300,000 valid rows of a 300,032 x 1024
unit-row corpus, B = 128, bins = 4096, window 8) and two small shapes,
compared bit for bit (K1 and K3 in bf16 and K2 on wgmma in newer trees,
on mma.sync in older ones, each build's bf16 and int8 carries launched
with their own wrappers' super-tile groups, read from its source);
``bin_topk_carry_f32``
and ``windowed_scores_f32``
(float32: 3xTF32 on mma.sync in older trees, on wgmma with a ``q_split``
scratch argument in newer ones, each tree's C interface read from its
source),
held in each build against their plain twins (``bin_topk_carry_plain``
within two packing quanta plus ``score_tolerance``,
``fused_scores_wmax_plain`` within ``score_tolerance``), their bit
identity printed beside; and the backward's float32
entries ``flash_attention_bwd_dq_f32`` and ``flash_attention_bwd_dkv_f32``
at the training shape (B = 32, T = 256, 16/8 heads, DH 128, ragged and
left-padded rows, dO zero on pad rows) and a small DH 64 shape; it prints,
per kernel and shape, whether the outputs are equal bit for bit. The
forwards (``flash_attention_fwd``, bf16, and ``flash_attention_fwd_f32``,
without lse) and the bf16 backward (``flash_attention_bwd_dq``,
``flash_attention_bwd_dkv``) sum in another order in each build by design,
so each build's output is held instead against its plain twin on valid
rows, finite everywhere: the forwards against ``attention_flash_plain``
within ``ops.flash_attention.kernel_tolerance`` at the serving shape (B =
64, T = 512, 16/8 heads, DH 128, ragged lengths) and a small DH 64 shape,
the backward's dq, dk and dv against ``attention_flash_bwd_plain`` within
``bwd_kernel_tolerance`` at the backward's two shapes. Then the CUDA-event
mean of 20 launches of each build's retrieval entries, bf16 and float32,
of its K4 at every ring depth this tree's wrapper takes (2 to
``MAX_BUFFERS``: 2-5 bf16, 2-3 float32), and of its int8 carry, at the
serving shape (six rounds of turns: a few percent of drift hides a 1%
difference in fewer), and of its forwards at chip_smoke.py's serving
shape (B 64 x T 512, its ragged and left-padded mask, then phase 4d's
embed batch's mask) and training shape (B 32 x T 256, the backward check's
mask, then 5b's documents' mask and full rows), and of the backward
entries, bf16 and float32, at the training shape on its check mask, 5b's
documents and full rows, each in turns (other, this, this, other); then,
per kernel function of each build, the registers and spill bytes
``ptxas -v`` reports. Exits 1 if any output differs or leaves its
tolerance. Needs a CUDA device and nvcc; exits 2 without a device.
"""

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
KERNELS = (
    "bin_topk", "bin_topk_int8", "bin_topk_pipelined", "windowed_scores", "flash_attention",
    "flash_attention_bwd",
)
# Entries whose output is held against the plain twin in each build, not
# compared bit for bit between builds.
TWIN_HELD = ("bin_topk_f32", "windowed_scores_f32")
K4_BUFFERS = 3
# (batch, seq, nq, nkv, dh) of the flash-attention forward
FLASH_SHAPES = ((64, 512, 16, 8, 128), (3, 256, 4, 2, 64))
# (batch, seq, nq, nkv, dh) of the flash backward: the training shape first
BWD_SHAPES = ((32, 256, 16, 8, 128), (3, 256, 4, 2, 64))
BWD_ENTRIES = {
    torch.bfloat16: ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"),
    torch.float32: ("flash_attention_bwd_dq_f32", "flash_attention_bwd_dkv_f32"),
}
# Rounds of turns (other, this, this, other) of the retrieval timing.
RETRIEVAL_ROUNDS = 6
# (n_rows, n_valid, dim, batch, bins, window)
SHAPES = (
    (300_032, 300_000, 1024, 128, 4096, 8),
    (8192 + 4096, 8192 + 4000, 256, 37, 4096, 8),
    (64 * 9, 64 * 9, 128, 200, 64, 16),
)


def ptxas_functions(log: str) -> list[str]:
    """One line per kernel function of a ``ptxas -v`` log: its name
    (demangled where c++filt exists), registers and spill bytes."""
    rows, name, spills = [], None, ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name, spills = entry.group(1), ""
        elif "spill" in line:
            spills = line.strip()
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            rows.append((name, f"{regs} registers; {spills}"))
            name = None
    if rows and shutil.which("c++filt"):
        names = subprocess.run(
            ["c++filt"], input="\n".join(n for n, _ in rows), capture_output=True, text=True
        ).stdout.splitlines()
        if len(names) == len(rows):
            rows = [(demangled, info) for demangled, (_, info) in zip(names, rows)]
    return [f"{name}: {info}" for name, info in rows]


def build(csrc: Path, out_dir: Path) -> dict[str, tuple[ctypes.CDLL, list[str]]]:
    """{kernel: (library, ptxas lines per kernel function)} built from ``csrc``."""
    sys.path.insert(0, str(REPO))
    from lean_explore_tpu_torch.ops.cuda_build import NVCC_FLAGS, nvcc_path

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in KERNELS:
        lib = out_dir / f"lib{name}.so"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(lib), str(csrc / f"{name}.cu")]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    built = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {csrc / name}.cu:\n{log}")
        built[name] = (ctypes.CDLL(str(lib)), ptxas_functions(log))
    return built


def takes_split(csrc: Path) -> bool:
    """Whether a tree's float32 retrieval entries take the ``q_split``
    scratch (the wgmma kernels), read from its source."""
    return "void* q_split" in (csrc / "bin_topk.cu").read_text()


def bf16_carry_on_ring(csrc: Path) -> bool:
    """Whether a tree's bf16 carry runs the wgmma kernel, whose wrapper
    takes ``ring_supertile_groups`` (else ``mma_sync_supertile_groups``)."""
    return "Bf16Stage" in (csrc / "bin_topk.cu").read_text()


def pipelined_on_ring(csrc: Path) -> bool:
    """Whether a tree's K4 runs K1's wgmma carry kernel (its float32 entry
    then takes the ``q_split`` scratch and its wrapper
    ``ring_supertile_groups``)."""
    return "launch_ring_carry" in (csrc / "bin_topk_pipelined.cu").read_text()


def mma_sync_supertile_groups(device, n: int, batch: int, bins: int) -> int:
    """The groups older trees' mma.sync carry wrappers split the super-tiles
    over: about four blocks of (64 bins x 64 queries) an SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = (bins // 64) * -(-batch // 64)
    return max(1, min(-(-n // bins), -(-4 * sms // blocks)))


def int8_carry_on_ring(csrc: Path) -> bool:
    """Whether a tree's int8 carry runs the wgmma kernel, whose wrapper
    takes ``ring_supertile_groups`` (else ``mma_sync_supertile_groups``)."""
    return "Int8Stage" in (csrc / "bin_topk_int8.cu").read_text()


def _configure(kernel: str, lib: ctypes.CDLL, split: bool = True, ring: bool = True,
               int8_ring: bool = True, k4_ring: bool = True) -> None:
    """Sets the argument types of a library's entries; ``split`` says
    whether its float32 retrieval entries take the ``q_split`` scratch,
    ``ring`` whether its bf16 carry is the wgmma kernel, ``int8_ring``
    whether its int8 carry is and ``k4_ring`` whether its K4 is; all are
    kept on the library (``f32_takes_split``, ``bf16_on_ring``,
    ``int8_on_ring``, ``k4_on_ring``)."""
    lib.f32_takes_split = split
    lib.bf16_on_ring = ring
    lib.int8_on_ring = int8_ring
    lib.k4_on_ring = k4_ring
    extra = [ctypes.c_void_p] if split else []
    if kernel == "bin_topk":
        fns = [lib.bin_topk_carry, lib.bin_topk_carry_f32]
        lib.bin_topk_carry.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.bin_topk_carry_f32.argtypes = (
            [ctypes.c_void_p] * 4 + extra + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    elif kernel == "bin_topk_pipelined":
        fns = [lib.bin_topk_pipelined_carry, lib.bin_topk_pipelined_carry_f32]
        k4_split = [ctypes.c_void_p] if k4_ring else []
        lib.bin_topk_pipelined_carry.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.bin_topk_pipelined_carry_f32.argtypes = (
            [ctypes.c_void_p] + k4_split + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
            + [ctypes.c_void_p])
    elif kernel == "bin_topk_int8":
        fns = [lib.bin_topk_int8_carry]
        fns[0].argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    elif kernel == "flash_attention_bwd":
        tail = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
        fns = []
        for dq, dkv in BWD_ENTRIES.values():
            getattr(lib, dq).argtypes = [ctypes.c_void_p] * 8 + tail
            getattr(lib, dkv).argtypes = [ctypes.c_void_p] * 9 + tail
            fns += [getattr(lib, dq), getattr(lib, dkv)]
    elif kernel == "windowed_scores":
        fns = [lib.windowed_scores, lib.windowed_scores_f32]
        lib.windowed_scores.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.windowed_scores_f32.argtypes = (
            [ctypes.c_void_p] * 4 + extra + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    else:
        fns = [lib.flash_attention_fwd, lib.flash_attention_fwd_f32]
        for fn in fns:
            fn.argtypes = (
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
            )
    for fn in fns:
        fn.restype = ctypes.c_int


def split_args(lib, q, takes: bool | None = None) -> list:
    """[q_split pointer] for a library whose float32 entries take the
    scratch (``takes``, else ``lib.f32_takes_split``; kept alive on the
    library until its next call), else []."""
    from lean_explore_tpu_torch.ops.bin_topk import split_scratch

    if not (lib.f32_takes_split if takes is None else takes):
        return []
    lib.last_split = split_scratch(q)
    return [lib.last_split.data_ptr()]


def run_bin_topk(lib, q, corpus, n_valid, bins) -> torch.Tensor:
    from lean_explore_tpu_torch.ops.bin_topk import (
        carry_buffers,
        ring_supertile_groups,
        steal_bits_for,
    )

    n, dim = corpus.shape
    f32 = corpus.dtype == torch.float32
    groups_of = (ring_supertile_groups if (lib.f32_takes_split if f32 else lib.bf16_on_ring)
                 else mma_sync_supertile_groups)
    groups = groups_of(corpus.device, n, q.shape[0], bins)
    out, partial, groups = carry_buffers(corpus, q.shape[0], bins, groups)
    stream = torch.cuda.current_stream().cuda_stream
    fn = lib.bin_topk_carry_f32 if f32 else lib.bin_topk_carry
    status = fn(
        q.data_ptr(), *(split_args(lib, q) if f32 else []), corpus.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None, q.shape[0], n, dim,
        n_valid, bins, steal_bits_for(n, bins), groups, stream,
    )
    if status != 0:
        raise RuntimeError(f"bin_topk_carry: cudaError {status}")
    return out


def run_pipelined(lib, q, corpus, n_valid, bins, n_buffers: int = K4_BUFFERS) -> torch.Tensor:
    """K4's carry at ``n_buffers`` ring stages, with the groups and the C
    interface of the library's own tree."""
    from lean_explore_tpu_torch.ops.bin_topk import (
        carry_buffers,
        ring_supertile_groups,
        steal_bits_for,
    )

    n, dim = corpus.shape
    f32 = corpus.dtype == torch.float32
    groups_of = ring_supertile_groups if lib.k4_on_ring else mma_sync_supertile_groups
    groups = groups_of(corpus.device, n, q.shape[0], bins)
    out, partial, groups = carry_buffers(corpus, q.shape[0], bins, groups)
    fn = lib.bin_topk_pipelined_carry_f32 if f32 else lib.bin_topk_pipelined_carry
    split = split_args(lib, q, lib.k4_on_ring) if f32 else []
    status = fn(
        q.data_ptr(), *split, corpus.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None, q.shape[0], n, dim,
        n_valid, bins, steal_bits_for(n, bins), groups, n_buffers,
        torch.cuda.current_stream().cuda_stream,
    )
    if status != 0:
        raise RuntimeError(f"bin_topk_pipelined_carry: cudaError {status}")
    return out


def run_bin_topk_int8(lib, q_codes, q_scales, codes, scales, n_valid, bins) -> torch.Tensor:
    """K2's carry with the groups of the library's own wrapper."""
    from lean_explore_tpu_torch.ops.bin_topk import (
        carry_buffers,
        ring_supertile_groups,
        steal_bits_for,
    )

    n, dim = codes.shape
    groups_of = ring_supertile_groups if lib.int8_on_ring else mma_sync_supertile_groups
    groups = groups_of(codes.device, n, q_codes.shape[0], bins)
    out, partial, groups = carry_buffers(codes, q_codes.shape[0], bins, groups)
    status = lib.bin_topk_int8_carry(
        q_codes.data_ptr(), q_scales.data_ptr(), codes.data_ptr(), scales.data_ptr(),
        out.data_ptr(), partial.data_ptr() if partial is not None else None,
        q_codes.shape[0], n, dim, n_valid, bins, steal_bits_for(n, bins), groups,
        torch.cuda.current_stream().cuda_stream,
    )
    if status != 0:
        raise RuntimeError(f"bin_topk_int8_carry: cudaError {status}")
    return out


def run_windowed(lib, q, corpus, n_valid, window, joined: bool = True):
    """(scores_t, wmax_t) of one launch, joined into one flat tensor unless
    ``joined`` is False."""
    n, dim = corpus.shape
    batch = q.shape[0]
    scores = torch.empty(n, batch, device=corpus.device)
    wmax = torch.empty(n // window, batch, device=corpus.device)
    stream = torch.cuda.current_stream().cuda_stream
    f32 = corpus.dtype == torch.float32
    fn = lib.windowed_scores_f32 if f32 else lib.windowed_scores
    status = fn(
        q.data_ptr(), *(split_args(lib, q) if f32 else []), corpus.data_ptr(),
        scores.data_ptr(), wmax.data_ptr(), batch, n, dim, n_valid, window, stream,
    )
    if status != 0:
        raise RuntimeError(f"windowed_scores: cudaError {status}")
    return torch.cat([scores.flatten(), wmax.flatten()]) if joined else (scores, wmax)


def twin_error(kernel: str, got, q, corpus, n_valid, bins, window) -> tuple[float, float]:
    """(error, tolerance) of a float32 retrieval entry's output against its
    plain twin: the carry within two packing quanta plus score_tolerance,
    the scores and window maxima within score_tolerance (pad rows -inf in
    both)."""
    from lean_explore_tpu_torch.ops import bin_topk as K
    from lean_explore_tpu_torch.ops import windowed as W

    n, dim = corpus.shape
    tol = K.score_tolerance(torch.float32, dim)
    if kernel == "bin_topk_f32":
        steal = K.steal_bits_for(n, bins)
        want = K.bin_topk_carry_plain(q, corpus, n_valid, bins, steal)
        return float((got - want).abs().max()), 2.0 * 2.0 ** (steal - 22) + tol
    want = torch.cat([x.flatten() for x in W.fused_scores_wmax_plain(q, corpus, n_valid, window)])
    if not torch.equal(torch.isneginf(got), torch.isneginf(want)):
        return float("inf"), tol
    finite = torch.isfinite(want)
    return float((got[finite] - want[finite]).abs().max()), tol


def run_flash(lib, q, k, v, mask) -> torch.Tensor:
    b, t, nq, dh = q.shape
    out = torch.empty(b, t, nq * dh, dtype=q.dtype, device=q.device)
    fn = lib.flash_attention_fwd if q.dtype == torch.bfloat16 else lib.flash_attention_fwd_f32
    status = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(), b, t,
        nq, k.shape[2], dh, float(dh**-0.5), torch.cuda.current_stream().cuda_stream,
    )
    if status != 0:
        raise RuntimeError(f"flash_attention_fwd: cudaError {status}")
    return out


def compare_flash(builds) -> tuple[list[dict], bool]:
    """The flash forward of both builds, bf16 and f32, each held against the
    plain twin on the same inputs."""
    sys.path.insert(0, str(REPO))
    from lean_explore_tpu_torch.ops import flash_attention as FA

    results, ok = [], True
    for b, t, nq, nkv, dh in FLASH_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(b * t + dh)
        lens = torch.randint(1, t + 1, (b,), generator=gen, device="cuda")
        mask = (torch.arange(t, device="cuda")[None] < lens[:, None]).to(torch.int32)
        base = [torch.randn(b, t, h, dh, generator=gen, device="cuda") for h in (nq, nkv, nkv)]
        valid = mask.bool()
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (x.to(dtype) for x in base)
            want = FA.attention_flash_plain(q, k, v, mask, dh**-0.5)[valid].float()
            tol = FA.kernel_tolerance(q, k, v, want)
            errs = {}
            for tag, libs in builds.items():
                got = run_flash(libs["flash_attention"][0], q, k, v, mask)
                torch.cuda.synchronize()
                finite = bool(torch.isfinite(got).all())
                errs[tag] = float((got[valid].float() - want).abs().max()) if finite else None
            right = all(err is not None and err <= tol for err in errs.values())
            ok &= right
            results.append({
                "kernel": "flash_attention", "dtype": str(dtype), "batch": b, "seq": t,
                "nq": nq, "nkv": nkv, "dh": dh, "max_abs_err": errs, "tol": tol,
                "within_tolerance": right,
            })
            print(json.dumps(results[-1]), flush=True)
    return results, ok


def in_turns(builds, kernel: str, run, reps: int = 20, rounds: int = 1) -> list:
    """CUDA-event ms per launch of ``run(lib)`` with each build's library of
    ``kernel``, in turns: other, this, this, other, ``rounds`` times."""
    times = []
    for tag in ("other", "this", "this", "other") * rounds:
        lib = builds[tag][kernel][0]
        run(lib)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            run(lib)
        end.record()
        torch.cuda.synchronize()
        times.append((tag, start.elapsed_time(end) / reps))
    return times


def time_retrieval(builds) -> None:
    """Both builds' K1 and K3 entries, bf16 and float32, their K4 at every
    ring depth this tree's wrapper takes, and their K2 (the bf16 inputs
    quantized per row), at the serving shape (the first of SHAPES), in
    RETRIEVAL_ROUNDS rounds of turns."""
    from lean_explore_tpu_torch.ops.bin_topk_pipelined import MAX_BUFFERS, MIN_BUFFERS
    from lean_explore_tpu_torch.ops.quant import quantize_rows_device

    n, n_valid, dim, batch, bins, window = SHAPES[0]
    for dtype, suffix in ((torch.bfloat16, ""), (torch.float32, "_f32")):
        gen = torch.Generator(device="cuda").manual_seed(n + batch)
        corpus = torch.randn(n, dim, generator=gen, device="cuda")
        corpus = (corpus / corpus.norm(dim=1, keepdim=True)).to(dtype)
        corpus[n_valid:] = 0
        q = torch.randn(batch, dim, generator=gen, device="cuda")
        q = (q / q.norm(dim=1, keepdim=True)).to(dtype)
        for kernel, source, run in (
            ("bin_topk", "bin_topk", lambda lib: run_bin_topk(lib, q, corpus, n_valid, bins)),
            ("windowed_scores", "windowed_scores",
             lambda lib: run_windowed(lib, q, corpus, n_valid, window, joined=False)),
        ):
            print(json.dumps({
                "kernel": kernel + suffix, "shape": "serving", "rows": n, "n_valid": n_valid,
                "dim": dim, "batch": batch, "bins": bins, "window": window,
                "ms_in_turns": in_turns(builds, source, run, rounds=RETRIEVAL_ROUNDS),
            }), flush=True)
        for n_buffers in range(MIN_BUFFERS, MAX_BUFFERS[dtype] + 1):
            print(json.dumps({
                "kernel": "bin_topk_pipelined" + suffix, "shape": "serving", "rows": n,
                "n_valid": n_valid, "dim": dim, "batch": batch, "bins": bins,
                "n_buffers": n_buffers,
                "ms_in_turns": in_turns(
                    builds, "bin_topk_pipelined",
                    lambda lib: run_pipelined(lib, q, corpus, n_valid, bins, n_buffers),
                    rounds=RETRIEVAL_ROUNDS),
            }), flush=True)
        if dtype == torch.bfloat16:
            q8, q8_scales = quantize_rows_device(q.float())
            c8, c8_scales = quantize_rows_device(corpus.float())
            print(json.dumps({
                "kernel": "bin_topk_int8", "shape": "serving", "rows": n, "n_valid": n_valid,
                "dim": dim, "batch": batch, "bins": bins,
                "ms_in_turns": in_turns(
                    builds, "bin_topk_int8",
                    lambda lib: run_bin_topk_int8(lib, q8, q8_scales, c8, c8_scales, n_valid,
                                                  bins),
                    rounds=RETRIEVAL_ROUNDS),
            }), flush=True)
            del q8, c8
        del corpus, q


def time_forward(builds) -> None:
    """Both builds' forwards, bf16 and f32, at chip_smoke.py's serving and
    training shapes, on its ragged check masks and on the masks of the paths
    the forward serves (``workload_flash_masks``), in turns."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke

    workloads = smoke.workload_flash_masks("cuda")
    shapes = (
        ("serving", smoke.FLASH_B, smoke.FLASH_T, 51, smoke.serving_flash_mask("cuda")),
        ("serving, 4d's embed mask", smoke.FLASH_B, smoke.FLASH_T, 51, workloads["embed_4d"]),
        ("training", smoke.TRAIN_B, smoke.TRAIN_T, 70,
         smoke.training_flash_mask(smoke.TRAIN_B, smoke.TRAIN_T, 70, "cuda")),
        ("training, 5b's documents", smoke.TRAIN_B, smoke.TRAIN_T, 70, workloads["train_5b"]),
        ("training, full rows", smoke.TRAIN_B, smoke.TRAIN_T, 70, workloads["train_full"]),
    )
    for label, b, t, seed, mask in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, _ = smoke.flash_inputs(b, t, [t] * b, seed, "cuda", dtype)
            times = in_turns(builds, "flash_attention",
                             lambda lib: run_flash(lib, q, k, v, mask))
            print(json.dumps({
                "kernel": "flash_attention_fwd" + ("_f32" if dtype == torch.float32 else ""),
                "shape": label, "batch": b, "seq": t, "ms_in_turns": times,
            }), flush=True)
            del q, k, v


def bwd_inputs(b, t, nq, nkv, dh, dtype) -> tuple:
    """(q, k, v, seg, dout, lse, di) of the backward: seeded q, k, v, ragged
    lengths with the last row left-padded, the twin's lse, dO zero on pad
    rows and di = rowsum(dO * O)."""
    sys.path.insert(0, str(REPO))
    from lean_explore_tpu_torch.ops import flash_attention as FA

    gen = torch.Generator(device="cuda").manual_seed(b * t + dh + 1)
    q, k, v = (
        torch.randn(b, t, h, dh, generator=gen, device="cuda").to(dtype) for h in (nq, nkv, nkv)
    )
    lens = torch.randint(1, t + 1, (b,), generator=gen, device="cuda")
    seg = (torch.arange(t, device="cuda")[None] < lens[:, None]).to(torch.int32)
    seg[-1] = 0
    seg[-1, t // 2 + 2:] = 1
    out, lse = FA.attention_flash_plain(q, k, v, seg, dh**-0.5, with_lse=True)
    dout = (torch.randn(out.shape, generator=gen, device="cuda") * seg[..., None]).to(dtype)
    return q, k, v, seg, dout, lse, FA.row_dot(out, dout, nq)


def run_bwd(lib, inputs, dq_entry: bool) -> list[torch.Tensor]:
    """[dq] or [dk, dv] from one launch of the backward entry of q's dtype."""
    q, k, v, seg, dout, lse, di = inputs
    b, t, nq, dh = q.shape
    dq, dkv = BWD_ENTRIES[q.dtype]
    outputs = [torch.empty_like(q)] if dq_entry else [torch.empty_like(k), torch.empty_like(v)]
    status = getattr(lib, dq if dq_entry else dkv)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), di.data_ptr(), *(x.data_ptr() for x in outputs), b, t, nq,
        k.shape[2], dh, float(dh**-0.5), torch.cuda.current_stream().cuda_stream,
    )
    if status != 0:
        raise RuntimeError(f"flash backward ({q.dtype}): cudaError {status}")
    return outputs


def compare_bwd(builds) -> tuple[list[dict], bool]:
    """The backward entries of both builds on the same inputs: the bf16
    ones, whose sum order may differ by design between builds, each
    held against the plain twin ``attention_flash_bwd_plain`` within
    ``bwd_kernel_tolerance``, finite everywhere; the float32 ones bit for
    bit against the other build."""
    sys.path.insert(0, str(REPO))
    from lean_explore_tpu_torch.ops import flash_attention as FA

    results, ok = [], True
    for dtype in (torch.bfloat16, torch.float32):
        for b, t, nq, nkv, dh in BWD_SHAPES:
            inputs = bwd_inputs(b, t, nq, nkv, dh, dtype)
            q, k, v, seg, dout, lse, di = inputs
            if dtype == torch.bfloat16:
                out = FA.attention_flash_plain(q, k, v, seg, dh**-0.5)
                want = FA.attention_flash_bwd_plain(q, k, v, seg, out, lse, dout, dh**-0.5)
                tols = FA.bwd_kernel_tolerance(q, k, v, seg, lse, dout, di, dh**-0.5)
            for dq_entry in (True, False):
                outs = {tag: run_bwd(libs["flash_attention_bwd"][0], inputs, dq_entry)
                        for tag, libs in builds.items()}
                torch.cuda.synchronize()
                entry = "flash_attention_bwd_" + ("dq" if dq_entry else "dkv")
                row = {"kernel": entry, "dtype": str(dtype), "batch": b, "seq": t, "nq": nq,
                       "nkv": nkv, "dh": dh}
                if dtype == torch.bfloat16:
                    pick = slice(0, 1) if dq_entry else slice(1, 3)
                    errs = {}
                    for tag, got in outs.items():
                        finite = all(bool(torch.isfinite(x).all()) for x in got)
                        errs[tag] = [float((x.float() - ref.float()).abs().max()) if finite
                                     else None for x, ref in zip(got, want[pick])]
                    right = all(e is not None and e <= tol for errors in errs.values()
                                for e, tol in zip(errors, tols[pick]))
                    row.update({"max_abs_err": errs, "tol": tols[pick],
                                "within_tolerance": right})
                else:
                    right = all(torch.equal(x, y) for x, y in zip(outs["this"], outs["other"]))
                    row["bit_identical"] = right
                ok &= right
                results.append(row)
                print(json.dumps(results[-1]), flush=True)
            del inputs
    return results, ok


def time_bwd(builds) -> None:
    """Both builds' backward entries, bf16 and float32, at the training
    shape on chip_smoke.py's check mask, 5b's documents and full rows, in
    turns."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    from lean_explore_tpu_torch.ops import flash_attention as FA

    workloads = smoke.workload_flash_masks("cuda")
    b, t, nq, nkv, dh = BWD_SHAPES[0]
    masks = (
        ("training", smoke.training_flash_mask(b, t, 70, "cuda")),
        ("training, 5b's documents", workloads["train_5b"]),
        ("training, full rows", workloads["train_full"]),
    )
    for label, seg in masks:
        for dtype, (dq, dkv) in BWD_ENTRIES.items():
            q, k, v, _, _, _, _ = bwd_inputs(b, t, nq, nkv, dh, dtype)
            out, lse = FA.attention_flash_plain(q, k, v, seg, dh**-0.5, with_lse=True)
            gen = torch.Generator(device="cuda").manual_seed(5)
            dout = (torch.randn(out.shape, generator=gen, device="cuda") * seg[..., None]).to(dtype)
            inputs = (q, k, v, seg, dout, lse, FA.row_dot(out, dout, nq))
            for dq_entry in (True, False):
                times = in_turns(builds, "flash_attention_bwd",
                                 lambda lib: run_bwd(lib, inputs, dq_entry))
                print(json.dumps({
                    "kernel": dq if dq_entry else dkv, "shape": label, "batch": b, "seq": t,
                    "ms_in_turns": times,
                }), flush=True)
            del inputs, q, k, v, out, lse, dout


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", required=True, help="root of the other tree")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("compare_torch_kernel_builds: needs a CUDA device", file=sys.stderr)
        return 2
    trees = {"this": REPO / "lean_explore_tpu_torch" / "csrc",
             "other": Path(args.other).resolve() / "lean_explore_tpu_torch" / "csrc"}
    builds = {tag: build(csrc, REPO / "build" / "compare_builds" / tag)
              for tag, csrc in trees.items()}
    for tag, libs in builds.items():
        for kernel, (lib, _) in libs.items():
            _configure(kernel, lib, takes_split(trees[tag]), bf16_carry_on_ring(trees[tag]),
                       int8_carry_on_ring(trees[tag]), pipelined_on_ring(trees[tag]))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    from lean_explore_tpu_torch.ops.quant import quantize_rows_device

    results, ok = [], True
    for n, n_valid, dim, batch, bins, window in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(n + batch)
        corpus = torch.randn(n, dim, generator=gen, device="cuda")
        corpus = (corpus / corpus.norm(dim=1, keepdim=True)).to(torch.bfloat16)
        corpus[n_valid:] = 0
        q = torch.randn(batch, dim, generator=gen, device="cuda")
        q = (q / q.norm(dim=1, keepdim=True)).to(torch.bfloat16)
        qf, cf = q.float(), corpus.float()
        q8, q8_scales = quantize_rows_device(qf)
        c8, c8_scales = quantize_rows_device(cf)
        runs = {
            "bin_topk": lambda lib: run_bin_topk(lib, q, corpus, n_valid, bins),
            "bin_topk_f32": lambda lib: run_bin_topk(lib, qf, cf, n_valid, bins),
            "bin_topk_int8": lambda lib: run_bin_topk_int8(
                lib, q8, q8_scales, c8, c8_scales, n_valid, bins
            ),
            "bin_topk_pipelined": lambda lib: run_pipelined(lib, q, corpus, n_valid, bins),
            "bin_topk_pipelined_f32": lambda lib: run_pipelined(lib, qf, cf, n_valid, bins),
            "windowed_scores": lambda lib: run_windowed(lib, q, corpus, n_valid, window),
            "windowed_scores_f32": lambda lib: run_windowed(lib, qf, cf, n_valid, window),
        }
        for kernel, run in runs.items():
            source = kernel.removesuffix("_f32")
            outs = {tag: run(libs[source][0]) for tag, libs in builds.items()}
            torch.cuda.synchronize()
            same = torch.equal(
                outs["this"].view(torch.int32), outs["other"].view(torch.int32)
            )
            row = {
                "kernel": kernel, "rows": n, "n_valid": n_valid, "dim": dim,
                "batch": batch, "bins": bins, "window": window,
                "bit_identical": same,
            }
            if kernel in TWIN_HELD:
                errs = {tag: twin_error(kernel, out, qf, cf, n_valid, bins, window)
                        for tag, out in outs.items()}
                right = all(err <= tol for err, tol in errs.values())
                row.update({"max_abs_err": {tag: e for tag, (e, _) in errs.items()},
                            "tol": errs["this"][1], "within_tolerance": right})
            else:
                right = same
            ok &= right
            results.append(row)
            print(json.dumps(results[-1]), flush=True)
            del outs
        del qf, cf, q8, c8
    for compare in (compare_flash, compare_bwd):
        more, more_ok = compare(builds)
        results += more
        ok &= more_ok
    time_retrieval(builds)
    time_forward(builds)
    time_bwd(builds)
    for tag, libs in builds.items():
        for kernel, (_, functions) in libs.items():
            for line in functions:
                print(f"{tag} {kernel}: {line}", flush=True)
    print(json.dumps({"bit_identical_and_within_tolerance": ok, "card": card}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
