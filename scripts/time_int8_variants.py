"""Where does the time of the int8 retrieval kernel (K2: s8 wgmma
m64n128k32, fed by a TMA ring) go, and does its ring depth matter? On one
GPU.

    python3 scripts/time_int8_variants.py

Builds ``csrc/bin_topk_int8.cu`` as it is ("base") and in variants, each
from a copy of ``csrc/`` in which exact strings of one or more files are
replaced, as ``time_tf32_variants.py`` does (every string must occur as
often as the variant says, or the script stops). Three are ablations,
whose output is wrong by design and which are the bf16 script's edits of
the shared block: ``no_query_copies`` (the producer copies only the corpus
tile of a stage), ``no_products`` (no wgmma is issued) and ``no_fold`` (a
super-tile's raw sums are added into the carry: no scaling, packing or
max, and no scale is read). The others compute the same function and must
give base's bits: the ring of 4 stages cut to 3 or grown to 5
(``carry_3_stages``, ``carry_5_stages``; 5 stages and the carry fill a
block's 227 KB), and ``deferred_wait`` (each warpgroup keeps a stage's
products in flight while it waits for the next stage and issues its
products, and releases a stage only then), also over 5 stages
(``deferred_wait_5_stages``: a warpgroup now holds two stages). Base is
held to the plain twin (``bin_topk_int8_carry_plain``) bit for bit. Then the CUDA-event mean of 20 launches of each build's entry,
in turns (base, the variants, the variants again in reverse, base), at the
serving shape: 300,000 valid unit rows of a 300,032 x 1024 corpus
quantized per row to int8, B = 128 queries quantized the same way, bins =
4096, launched with the wrapper's super-tile groups. Prints the card's name
and power limit, one JSON line, the registers and spill bytes ``ptxas -v``
reports per variant and int8 kernel function, and a last JSON line. Exits 1
if base differs from its twin or a same-function variant from base, 2
without a device.
"""

import argparse
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

import time_bf16_variants as bf16  # noqa: E402
import time_tf32_variants as common  # noqa: E402

K2 = "bin_topk_int8"
N_ROWS, N_VALID, DIM, BATCH, BINS = (
    common.N_ROWS, common.N_VALID, common.DIM, common.BATCH, common.BINS)
# Each warpgroup keeps one stage's wgmma group in flight while it waits for
# the next stage and issues its products (wait_group 1, then the previous
# stage's release), and waits for all before a fold: the same products in
# the same order on the same accumulators.
DEFERRED_WAIT = [
    ("ring_tiles.cuh",
     "  int slot = 0;\n  uint32_t phase = 0;\n",
     "  int slot = 0;\n  uint32_t phase = 0;\n  int held = 0;\n  bool pending = false;\n", 1),
    ("ring_tiles.cuh",
     "  for (int kk = 0; kk < 4; ++kk) wgmma_ss<128>(acc, a + 2 * kk, q + 2 * kk);\n"
     "  wgmma_commit();\n"
     "  wgmma_wait<0>();\n"
     "  fence_operands(acc);\n"
     "  ring_release(ring, at, lane);\n"
     "}\n",
     "  for (int kk = 0; kk < 4; ++kk) wgmma_ss<128>(acc, a + 2 * kk, q + 2 * kk);\n"
     "  wgmma_commit();\n"
     "  wgmma_wait<1>();\n"
     "  fence_operands(acc);\n"
     "  if (at.pending) {\n"
     "    __syncwarp();\n"
     "    if (lane == 0) mbar_arrive(&ring.empty[at.held]);\n"
     "  }\n"
     "  at.held = at.slot;\n"
     "  at.pending = true;\n"
     "  at.advance(ring.n);\n"
     "}\n"
     "\n"
     "template <class Acc>\n"
     "__device__ __forceinline__ void finish_stage(Acc (&acc)[RING_ACC], const OneBoxRing& ring,\n"
     "                                             RingSlot& at, int lane) {\n"
     "  wgmma_wait<0>();\n"
     "  fence_operands(acc);\n"
     "  __syncwarp();\n"
     "  if (lane == 0) mbar_arrive(&ring.empty[at.held]);\n"
     "  at.pending = false;\n"
     "}\n", 1),
    ("ring_carry.cuh",
     "    Stage::step(acc, ring, at, warp, lane);\n"
     "    if (t % k_steps == k_steps - 1) {\n",
     "    Stage::step(acc, ring, at, warp, lane);\n"
     "    if (t % k_steps == k_steps - 1) {\n"
     "      finish_stage(acc, ring, at, lane);\n", 1)]
# variant: (whether it computes base's function, the kernels it is timed on,
# [(file, string, replacement, occurrences)])
VARIANTS = {
    "no_query_copies": (False, (K2,), bf16.VARIANTS["no_query_copies"][2]),
    "no_products": (False, (K2,), bf16.VARIANTS["no_products"][2]),
    "no_fold": (False, (K2,), common.VARIANTS["no_fold"][2]),
    "carry_3_stages": (True, (K2,), [
        ("bin_topk_int8.cu", "constexpr int INT8_CARRY_STAGES = 4;",
         "constexpr int INT8_CARRY_STAGES = 3;", 1)]),
    "carry_5_stages": (True, (K2,), [
        ("bin_topk_int8.cu", "constexpr int INT8_CARRY_STAGES = 4;",
         "constexpr int INT8_CARRY_STAGES = 5;", 1)]),
    "deferred_wait": (True, (K2,), DEFERRED_WAIT),
    "deferred_wait_5_stages": (True, (K2,), DEFERRED_WAIT + [
        ("bin_topk_int8.cu", "constexpr int INT8_CARRY_STAGES = 4;",
         "constexpr int INT8_CARRY_STAGES = 5;", 1)]),
}


def quantized(q, corpus) -> tuple:
    """(q_codes, q_scales, codes, scales): the serving inputs quantized per
    row, as the wrapper and DenseIndex.build quantize them."""
    from lean_explore_tpu_torch.ops.quant import quantize_rows_device

    return (*quantize_rows_device(q), *quantize_rows_device(corpus))


def runners(q, corpus) -> dict:
    """{K2: (run(libs), output())} at the serving shape: ``run`` launches a
    build's int8 entry with the wrapper's groups, ``output`` gives the last
    launch's carry."""
    from compare_torch_kernel_builds import run_bin_topk_int8

    q_codes, q_scales, codes, scales = quantized(q, corpus)
    last = {}

    def carry(libs):
        last[K2] = run_bin_topk_int8(libs[K2][0], q_codes, q_scales, codes, scales, N_VALID,
                                     BINS)

    return {K2: (carry, lambda: last[K2].clone())}


def base_error(kernel: str, got: torch.Tensor, q, corpus) -> tuple[float, float]:
    """(error, tolerance) of base's carry against the plain twin: bit for
    bit, so a differing word is an infinite error."""
    from lean_explore_tpu_torch.ops import bin_topk_int8 as K8
    from lean_explore_tpu_torch.ops.bin_topk import steal_bits_for

    q_codes, q_scales, codes, scales = quantized(q, corpus)
    want = K8.bin_topk_int8_carry_plain(q_codes, q_scales, codes, scales, N_VALID, BINS,
                                        steal_bits_for(N_ROWS, BINS))
    same = torch.equal(got.view(torch.int32), want.view(torch.int32))
    return (0.0 if same else float("inf")), 0.0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.parse_args()
    return common.measure(VARIANTS, runners, base_error, torch.float32, "int8_variants",
                          "Int8", sources=(K2,))


if __name__ == "__main__":
    sys.exit(main())
