"""Where does the time of the bf16 retrieval kernels (K1 and K3 on bf16
wgmma m64n128k16, fed by a TMA ring) go, and which of their same-function
designs serves them best? On one GPU.

    python3 scripts/time_bf16_variants.py

Builds ``csrc/bin_topk.cu`` and ``csrc/windowed_scores.cu`` as they are
("base") and in variants, each from a copy of ``csrc/`` in which exact
strings of one or more files are replaced, as ``time_tf32_variants.py``
does (every string must occur as often as the variant says, or the script
stops). Four are ablations, whose output is wrong by design:
``no_query_copies`` (the producer copies only the corpus tile of a stage),
``no_products`` (no wgmma is issued) and, for K1, ``no_fold`` (a
super-tile's scores are added into the carry, not packed and folded) or,
for K3, ``no_store`` (no score, window maximum or staged tile is written;
the scores' sum decides one store that never happens, so that the
products stay live; the same edit as the f32 script's, which reaches
the windowed kernel). The others compute the same function in the same
order and must give base's bits: K1's ring of 4 stages cut to 3 or grown
to 5 (``carry_3_stages``, ``carry_5_stages``), its carry in registers
where shared memory holds it (``carry_in_registers``), the corpus operand
loaded into registers by ldmatrix where wgmma reads it by descriptor (the
RS form of the product, which the edit adds; the same edit timed on K1 as
``carry_a_in_registers`` and on K3 as ``window_a_in_registers``), K3's
ring of 4 stages cut to 3 or 2 (``window_3_stages``, ``window_2_stages``;
5 stages and the staged tiles exceed a block's shared memory), and its
scores written 4 bytes a store where the warpgroups write 16
(``window_thread_store``, the f32 script's edit). Two blocks an SM have
no variant: a block's ring of at least two 32 KB stages and its 64 KB of
carry or 68 KB of staged scores exceed half an SM's 227 KB of shared
memory, and K1's accumulators with its carry in registers (128
a thread) exceed the 102 registers that 18 warps leave a thread. Base is
held against the plain twins (``bin_topk_carry_plain`` within two packing
quanta plus ``score_tolerance``, ``fused_scores_wmax_plain`` within
``score_tolerance``). Then the CUDA-event mean of 20 launches of each
build's entry, in turns (base, the variants, the variants again in
reverse, base), at the serving shape: 300,000 valid unit rows of a
300,032 x 1024 bf16 corpus, B = 128, bins = 4096, window 8. Prints the
card's name and power limit, one JSON line per kernel, the registers and
spill bytes ``ptxas -v`` reports per variant and bf16 kernel function, and
a last JSON line. Exits 1 if base leaves its tolerance or a same-function
variant differs from base, 2 without a device.
"""

import argparse
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

import time_tf32_variants as common  # noqa: E402

K1, K3 = "bin_topk", "windowed_scores"
N_ROWS, N_VALID, DIM, BATCH, BINS, WINDOW = (
    common.N_ROWS, common.N_VALID, common.DIM, common.BATCH, common.BINS, common.WINDOW)
# The bf16 stage's corpus operand loaded into registers by ldmatrix (whose
# four 8 x 8 matrices of 16-byte rows are the m16n8k16 A fragment, wgmma's
# A register layout) where wgmma reads it by descriptor: the RS form of the
# k16 product, and the stage's fence of its ldmatrix reads before the
# slot's refill (an async-proxy write).
A_IN_REGISTERS = [
    ("ring_tiles.cuh", "#undef ACC128_REGS\n",
     "__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[64], const uint32_t (&a)[4], "
     "uint64_t b) {\n"
     "  asm volatile(\n"
     '      "{\\n.reg .pred p;\\nsetp.ne.b32 p, 1, 0;\\n"\n'
     '      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ACC128_REGS\n'
     '      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\\n}\\n"\n'
     "      : ACC128_OPERANDS(d)\n"
     '      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));\n'
     "}\n"
     "\n"
     "#undef ACC128_REGS\n", 1),
    ("ring_tiles.cuh",
     "  const uint64_t a = wgmma_desc(stage + (warp >> 2) * 64 * STAGE_BYTES, 16, 1024);\n"
     "  fence_operands(acc);\n"
     "  wgmma_fence();\n"
     "#pragma unroll\n"
     "  for (int kk = 0; kk < 4; ++kk) wgmma_ss<128>(acc, a + 2 * kk, q + 2 * kk);\n"
     "  wgmma_commit();\n"
     "  wgmma_wait<0>();\n"
     "  fence_operands(acc);\n",
     "  const int r = (warp >> 2) * 64 + (warp & 3) * 16 + (lane & 15);\n"
     "  uint32_t a[4][4];\n"
     "#pragma unroll\n"
     "  for (int kk = 0; kk < 4; ++kk) {\n"
     "    ldmatrix_x4(a[kk], stage + swizzled<RING_ROWS>(r, 2 * kk + (lane >> 4)));\n"
     "  }\n"
     "  fence_operands(acc);\n"
     "  wgmma_fence();\n"
     "#pragma unroll\n"
     "  for (int kk = 0; kk < 4; ++kk) wgmma_bf16_rs(acc, a[kk], q + 2 * kk);\n"
     "  wgmma_commit();\n"
     "  wgmma_wait<0>();\n"
     "  fence_operands(acc);\n"
     "#pragma unroll\n"
     "  for (int kk = 0; kk < 4; ++kk) fence_operands(a[kk]);\n"
     "  fence_proxy_async_shared();\n", 1)]
# variant: (whether it computes base's function, the kernels it is timed on,
# [(file, string, replacement, occurrences)])
VARIANTS = {
    "no_query_copies": (False, (K1, K3), [
        ("ring_tiles.cuh", common.FILL, common.NO_QUERY_COPIES, 1)]),
    "no_products": (False, (K1, K3), [
        ("ring_tiles.cuh", "for (int kk = 0; kk < 4; ++kk) wgmma_ss<128>(",
         "for (int kk = 0; kk < 4; ++kk) if (false) wgmma_ss<128>(", 1)]),
    "no_fold": (False, (K1,), common.VARIANTS["no_fold"][2]),
    "no_store": (False, (K3,), common.VARIANTS["no_store"][2]),
    "carry_3_stages": (True, (K1,), [
        ("bin_topk.cu", "constexpr int BF16_CARRY_STAGES = 4;",
         "constexpr int BF16_CARRY_STAGES = 3;", 1)]),
    "carry_5_stages": (True, (K1,), [
        ("bin_topk.cu", "constexpr int BF16_CARRY_STAGES = 4;",
         "constexpr int BF16_CARRY_STAGES = 5;", 1)]),
    "carry_in_registers": (True, (K1,), common.CARRY_IN_REGISTERS),
    "carry_a_in_registers": (True, (K1,), A_IN_REGISTERS),
    "window_3_stages": (True, (K3,), [
        ("windowed_scores.cu", "constexpr int BF16_WINDOW_STAGES = 4;",
         "constexpr int BF16_WINDOW_STAGES = 3;", 1)]),
    "window_2_stages": (True, (K3,), [
        ("windowed_scores.cu", "constexpr int BF16_WINDOW_STAGES = 4;",
         "constexpr int BF16_WINDOW_STAGES = 2;", 1)]),
    "window_a_in_registers": (True, (K3,), A_IN_REGISTERS),
    "window_thread_store": (True, (K3,), common.THREAD_STORE),
}


def runners(q, corpus) -> dict:
    """{kernel: (run(libs), output())} at the serving shape: ``run``
    launches a build's bf16 entry with the wrapper's grid, ``output`` gives
    the last launch's output as one tensor."""
    from lean_explore_tpu_torch.ops import bin_topk as K

    steal = K.steal_bits_for(N_ROWS, BINS)
    groups = K.ring_supertile_groups(corpus.device, N_ROWS, BATCH, BINS)
    scores = torch.empty(N_ROWS, BATCH, device="cuda")
    wmax = torch.empty(N_ROWS // WINDOW, BATCH, device="cuda")
    last = {}

    def carry(libs):
        out, partial, _ = K.carry_buffers(corpus, BATCH, BINS, groups)
        status = libs["bin_topk"][0].bin_topk_carry(
            q.data_ptr(), corpus.data_ptr(), out.data_ptr(),
            partial.data_ptr() if partial is not None else None, BATCH, N_ROWS, DIM, N_VALID,
            BINS, steal, groups, torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise RuntimeError(f"bin_topk_carry: cudaError {status}")
        last[K1] = out

    def windowed(libs):
        status = libs["windowed_scores"][0].windowed_scores(
            q.data_ptr(), corpus.data_ptr(), scores.data_ptr(), wmax.data_ptr(), BATCH, N_ROWS,
            DIM, N_VALID, WINDOW, torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise RuntimeError(f"windowed_scores: cudaError {status}")

    return {
        K1: (carry, lambda: last[K1].clone()),
        K3: (windowed, lambda: torch.cat([scores.flatten(), wmax.flatten()])),
    }


def base_error(kernel: str, got: torch.Tensor, q, corpus) -> tuple[float, float]:
    """(error, tolerance) of base's output against the plain twin."""
    from lean_explore_tpu_torch.ops import bin_topk as K
    from lean_explore_tpu_torch.ops import windowed as W

    tol = K.score_tolerance(torch.bfloat16, DIM)
    if kernel == K1:
        steal = K.steal_bits_for(N_ROWS, BINS)
        want = K.bin_topk_carry_plain(q, corpus, N_VALID, BINS, steal)
        return float((got - want).abs().max()), 2.0 * 2.0 ** (steal - 22) + tol
    want = torch.cat([x.flatten() for x in W.fused_scores_wmax_plain(q, corpus, N_VALID, WINDOW)])
    finite = torch.isfinite(want)
    if not torch.equal(finite, torch.isfinite(got)):
        return float("inf"), tol
    return float((got[finite] - want[finite]).abs().max()), tol


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.parse_args()
    return common.measure(VARIANTS, runners, base_error, torch.bfloat16, "bf16_variants", "bf16")


if __name__ == "__main__":
    sys.exit(main())
