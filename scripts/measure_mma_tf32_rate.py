"""How many tf32 mma.sync m16n8k8 (SASS HMMA.1688.F32.TF32) and bf16
mma.sync m16n8k16 (HMMA.16816.F32.BF16) can one SM of this GPU issue a
second, how many bf16 wgmma of the two shapes the bf16 backward runs, and
how many tf32 wgmma m64n128k8 of the float32 retrieval kernels? The
ceilings of the port's flash-attention and float32 retrieval kernels,
which are built on those instructions. On one GPU.

    python3 scripts/measure_mma_tf32_rate.py [--count-only]

First prints how many of these instructions K5's kernels issue, counted
from their grids: the float32 backward (``csrc/flash_attention_bwd.cu``) at
the training shape (B 32 x T 256, 16/8 heads, DH 128), the 16 x 32 tile
pairs that each warp does not skip times its products (3 in dq, 4 in
dk/dv), each 3xTF32; the forwards (``csrc/flash_attention.cu``) at
chip_smoke.py's serving shape (B 64 x T 512, its ragged and left-padded
mask, then phase 4d's embed batch's mask) and training shape (B 32 x
T 256, the backward check's mask, then 5b's documents' mask and full
rows), the 32-key tiles that each warp (16 rows in f32, 32 in bf16) does
not skip under the kernels' causal and segment rule times their two
products, and the share of full rows' tiles that the segment rule skips;
and the bf16 backward at the training shape on its check mask, 5b's
documents and full rows (``bf16_backward_counts``: HMMA.16816 for warps of
16 rows on mma.sync, wgmma for warpgroups of 64); and the tf32 wgmma
m64n128k8 of K1-f32 and K3-f32 (``csrc/bin_topk.cu``,
``csrc/windowed_scores.cu``) at chip_smoke.py's serving shape
(``tf32_retrieval_counts``). With ``--count-only`` it stops there and needs
no GPU. Then it writes a small CUDA source into
``build/mma_tf32_rate/``, builds it with the port's nvcc flags against
``csrc/flash_tiles.cuh``, and launches 4 blocks an SM, each of 128, 256
or 512 threads, whose warps each run 2,000 rounds of 4, 8 or 16
independent accumulator chains of one mma.sync instruction (no loads, no
other work), tf32 and then bf16; then 1-2 blocks an SM of 1-3
warpgroups, each issuing 500 batches of 8 wgmma of one shape on zeroed
shared-memory operands in the backward's layout (m64n32k16 from shared
memory, m64n128k16 with A in registers), one batch in flight while the
next is issued, then the same for tf32 m64n128k8 with A in registers and
with A from shared memory. Prints the card's name and power limit, then per
instruction and configuration the CUDA-event time of 5 launches after a
warm one and the rate in instructions a second per SM, and last a JSON
line with each instruction's highest rate and the time the counted
instructions take at it (the bf16 backward's wgmma floor is the sum over
its two shapes; the float32 retrieval kernels' at the A-in-registers
rate). Exits 2 without a device.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

#include "ring_tiles.cuh"

constexpr int WGMMA_SMEM = 65536;

template <int CHAINS, bool BF16>
__global__ void mma_chains(float* out, int rounds) {
  const uint32_t a[4] = {threadIdx.x << 13, 0x3f800000u, 0x3f000000u, blockIdx.x << 13};
  const uint32_t b0 = 0x3f800000u, b1 = threadIdx.x << 14;
  float acc[CHAINS][4] = {};
  for (int i = 0; i < rounds; ++i) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) {
      if constexpr (BF16) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      } else {
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      }
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <bool BF16>
int launch(float* out, int chains, int blocks, int threads, int rounds, cudaStream_t s) {
  if (chains == 4) mma_chains<4, BF16><<<blocks, threads, 0, s>>>(out, rounds);
  else if (chains == 8) mma_chains<8, BF16><<<blocks, threads, 0, s>>>(out, rounds);
  else if (chains == 16) mma_chains<16, BF16><<<blocks, threads, 0, s>>>(out, rounds);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int mma_tf32_rate(float* out, int chains, int blocks, int threads, int rounds,
                             void* stream) {
  return launch<false>(out, chains, blocks, threads, rounds, static_cast<cudaStream_t>(stream));
}

extern "C" int mma_bf16_rate(float* out, int chains, int blocks, int threads, int rounds,
                             void* stream) {
  return launch<true>(out, chains, blocks, threads, rounds, static_cast<cudaStream_t>(stream));
}

// Each warpgroup issues `rounds` batches of 8 wgmma of one shape on one
// accumulator, one batch in flight while the next is issued, on zeroed
// shared-memory operands: in the bf16 backward's layout, m64n32k16 with A
// and B from shared memory (RS false) or m64n128k16 with A in registers
// and B read MN-major (RS true); with TF32, the float32 retrieval kernels'
// m64n128k8 with B a K-major 128-row tile and A from shared memory or from
// registers.
template <bool RS, bool TF32>
__global__ void wgmma_chains(float* out, int rounds) {
  extern __shared__ __align__(16) uint8_t raw[];
  uint8_t* smem = tiles::align_1024(raw);
  for (int i = threadIdx.x; i < WGMMA_SMEM / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  tiles::fence_proxy_async();
  __syncthreads();
  const int wg = threadIdx.x / 128;
  float d[64];
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;
  uint32_t af[4] = {0u, 0u, 0u, 0u};
  const uint64_t a = tiles::wgmma_desc(smem + wg * 8192, 16, 1024);
  const uint64_t b = tiles::wgmma_desc(smem + 32768, 16, 1024);
  const uint64_t b_mn = tiles::wgmma_desc(smem + 32768, 4096, 1024);
  for (int r = 0; r < rounds; ++r) {
    tiles::wgmma_fence();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if constexpr (TF32 && RS) {
        tiles::wgmma_tf32_rs(d, af, b + 2 * (i & 3));
      } else if constexpr (TF32) {
        tiles::wgmma_tf32_ss(d, a + 2 * (i & 3), b + 2 * (i & 3));
      } else if constexpr (RS) {
        tiles::wgmma_rs_t<128>(d, af, b_mn + 128 * (i & 1));
      } else {
        tiles::wgmma_ss<32>(*reinterpret_cast<float(*)[16]>(&d), a + 2 * (i & 3), b + 2 * (i & 3));
      }
    }
    tiles::wgmma_commit();
    tiles::wgmma_wait<1>();
  }
  tiles::wgmma_wait<0>();
  tiles::fence_operands(d);
  float s = 0.0f;
  for (int i = 0; i < 64; ++i) s += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int wgmma_rate(float* out, int rs, int groups, int blocks, int rounds, void* stream) {
  auto kernel = rs ? wgmma_chains<true, false> : wgmma_chains<false, false>;
  const int smem = WGMMA_SMEM + 1024;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, 128 * groups, smem, static_cast<cudaStream_t>(stream)>>>(out, rounds);
  return (int)cudaGetLastError();
}

extern "C" int wgmma_tf32_rate(float* out, int rs, int groups, int blocks, int rounds,
                               void* stream) {
  auto kernel = rs ? wgmma_chains<true, true> : wgmma_chains<false, true>;
  const int smem = WGMMA_SMEM + 1024;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, 128 * groups, smem, static_cast<cudaStream_t>(stream)>>>(out, rounds);
  return (int)cudaGetLastError();
}
"""
ROUNDS = 2000
BLOCKS_PER_SM = 4
TRAIN_SHAPE = (32, 256, 16, 8, 128)  # B, T, NQ, NKV, DH
BLOCK_ROWS, STREAM_ROWS, WARPS = 128, 32, 8  # the f32 kernels' tiling


def backward_mma_counts(b, t, nq, nkv, dh) -> dict[str, int]:
    """tf32 m16n8k8 instructions of the f32 dq and dk/dv kernels: per warp
    and 32-row streamed tile it does not skip, each product of a 16 x 32
    tile pair over DH (rows x rows) or of 16 x DH over 32 (X x tile) is
    16 * 32 * DH / (16 * 8 * 8) mma, three times over (3xTF32); dk/dv runs
    4 products, dq 3."""
    per_product = 3 * 16 * STREAM_ROWS * dh // (16 * 8 * 8)
    dkv = dq = 0
    for block in range((t + BLOCK_ROWS - 1) // BLOCK_ROWS):
        row0 = block * BLOCK_ROWS
        for warp in range(WARPS):
            w0 = row0 + 16 * warp  # the warp's first key (dk/dv) or query (dq)
            if w0 >= t:
                continue
            # dk/dv: query tiles from the block's first on that end at or after w0
            dkv += sum(1 for q0 in range(row0 // STREAM_ROWS * STREAM_ROWS, t, STREAM_ROWS)
                       if q0 + STREAM_ROWS - 1 >= w0)
            # dq: key tiles up to the block's last query that start at or before w0 + 15
            last = min(row0 + BLOCK_ROWS, t)
            dq += sum(1 for k0 in range(0, last, STREAM_ROWS) if k0 <= w0 + 15)
    group = nq // nkv
    return {"dq_f32": dq * 3 * per_product * b * nq,
            "dkv_f32": dkv * group * 4 * per_product * b * nkv}


def bf16_backward_counts(mask, nq: int, nkv: int, dh: int) -> dict[str, int]:
    """Tensor-core instructions of the bf16 dq and dk/dv kernels
    (csrc/flash_attention_bwd.cu) over a 0/1 mask [B, T]: per 128-row block
    and group of fixed rows (a warp of 16 rows on mma.sync, "_hmma", the
    design of its first step; a warpgroup of 64 on wgmma, "_wgmma"), the
    32-row streamed tiles that the group does not skip (takes_query_tile in
    dk/dv: a query tile wholly before its first key, or, when its keys share
    one segment, one with no query from that key on in it; takes_tile in
    dq), times the products of a tile. HMMA.16816: 4 products of 16 x 32
    over DH or of 16 x DH over 32 in dk/dv, 3 in dq, each (32 / 8) (DH / 16)
    instructions. wgmma: S^T and dP^T (S and dP) as DH / 16 m64n32k16 each
    from shared memory, dV and dK (dQ) as 2 m64n{DH}k16 each with A in
    registers ("_ss" and "_rs")."""
    mask = np.asarray(mask)
    t = mask.shape[1]
    keys = STREAM_ROWS
    group = nq // nkv
    counts = {}
    for name, rows in (("hmma", 16), ("wgmma", 64)):
        dkv = dq = 0
        for row in mask:
            for r0 in range(0, t, rows):
                own = row[r0:r0 + rows]
                uniform = bool((own == own[0]).all())
                for c0 in range(0, t, keys):
                    # dk/dv: keys r0.. against queries c0..; dq: queries r0.. against keys c0..
                    if c0 + keys - 1 >= r0 and not (
                        uniform and not (row[max(c0, r0):c0 + keys] == own[0]).any()
                    ):
                        dkv += 1
                    if c0 <= r0 + rows - 1 and not (
                        uniform and not (row[c0:min(c0 + keys, r0 + rows)] == own[0]).any()
                    ):
                        dq += 1
        dkv *= nkv * group
        dq *= nq
        if name == "hmma":
            per = (keys // 8) * (dh // 16)
            counts.update({"dkv_hmma": dkv * 4 * per, "dq_hmma": dq * 3 * per})
        else:
            counts.update({"dkv_wgmma_ss": dkv * 2 * (dh // 16), "dkv_wgmma_rs": dkv * 4,
                           "dq_wgmma_ss": dq * 2 * (dh // 16), "dq_wgmma_rs": dq * 2})
    return counts


def tf32_retrieval_counts(n: int, dim: int, batch: int, bins: int) -> dict[str, int]:
    """tf32 wgmma m64n128k8 of the float32 carry (K1-f32) and windowed
    scores (K3-f32) kernels over a corpus of n rows: each warpgroup's 64
    rows are multiplied by every block of 128 queries over the depth, three
    products (3xTF32) a k8 step. K1's warpgroups cover the 64-bin slices of
    each super-tile that lie inside the corpus, a block's second one past
    N or past `bins` included (it multiplies, and does not fold); K3's the
    128-row tiles, a half tile past N included."""
    q_blocks = -(-batch // 128)
    per_group = q_blocks * (dim // 8) * 3
    slices = -(-bins // 128)
    k1_groups = 0
    for p in range(-(-n // bins)):
        k1_groups += 2 * sum(1 for x in range(slices) if p * bins + 128 * x < n)
    return {"bin_topk_f32": k1_groups * per_group, "windowed_scores_f32": 2 * -(-n // 128) * per_group}


def forward_mma_counts(mask, nq: int, dh: int) -> dict[str, int]:
    """HMMA of the forward kernels over a 0/1 mask [B, T]: per 128-query
    block and warp, the 32-key tiles up to the block's last query that the
    warp does not skip (csrc/flash_attention.cu's takes_tile: a tile starting
    after its last query; when its rows share one segment, a tile none of
    whose keys up to its last query lies in it), times two products of the
    warp's rows by 32 keys over DH: f32 warps of 16 rows in 3xTF32 m16n8k8,
    bf16 warps of 32 rows in m16n8k16."""
    mask = np.asarray(mask)
    t = mask.shape[1]
    keys = STREAM_ROWS
    # (rows a warp, HMMA a warp tile): QK^T (keys / 8) x (DH / k) and
    # PV (DH / 8) x (keys / k) per 16 rows, k = 8 (tf32, x3) or 16 (bf16)
    per_tile = {"fwd_f32": (16, 3 * 2 * (keys // 8) * (dh // 8)),
                "fwd_bf16": (32, 2 * 2 * (keys // 8) * (dh // 16))}
    counts = {}
    for name, (rows, mma) in per_tile.items():
        tiles = 0
        for row in mask:
            for q0 in range(0, t, BLOCK_ROWS):
                last = min(q0 + BLOCK_ROWS, t)
                for qw in range(q0, last, rows):
                    own = row[qw:qw + rows]
                    uniform = bool((own == own[0]).all())
                    for k0 in range(0, min(last, qw + rows), keys):
                        if uniform and not (row[k0:min(k0 + keys, qw + rows)] == own[0]).any():
                            continue
                        tiles += 1
        counts[name] = tiles * mma * nq
    return counts


def forward_counts() -> dict[str, dict[str, int]]:
    """The forwards' HMMA at chip_smoke.py's serving and training masks and
    on the masks of the paths the forward serves (4d's embed batch, 5b's
    documents; full rows are the training shape's causal tiles, none
    skipped by segment), each with the share of the causal tiles (those of
    full rows at its shape) that the segment rule skips."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke

    nq, dh = smoke.FLASH_NQ, smoke.FLASH_DH
    workloads = smoke.workload_flash_masks("cpu")
    masks = {
        "serving": smoke.serving_flash_mask("cpu"),
        "serving, 4d's embed mask": workloads["embed_4d"],
        "training": smoke.training_flash_mask(smoke.TRAIN_B, smoke.TRAIN_T, 70, "cpu"),
        "training, 5b's documents": workloads["train_5b"],
        "training, full rows": workloads["train_full"],
    }
    counts = {label: forward_mma_counts(mask.numpy(), nq, dh) for label, mask in masks.items()}
    for label, mask in masks.items():
        full = forward_mma_counts(np.ones(tuple(mask.shape), dtype=np.int32), nq, dh)
        counts[label].update({f"{name}_skipped_share": 1 - counts[label][name] / n
                              for name, n in full.items()})
    return counts


def bf16_backward_counts_on_masks() -> dict[str, dict[str, int]]:
    """The bf16 backward's tensor-core instructions at the training shape
    on chip_smoke.py's check mask, 5b's documents and full rows."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke

    b, t = smoke.TRAIN_B, smoke.TRAIN_T
    workloads = smoke.workload_flash_masks("cpu")
    masks = {
        "training": smoke.training_flash_mask(b, t, 70, "cpu"),
        "training, 5b's documents": workloads["train_5b"],
        "training, full rows": workloads["train_full"],
    }
    return {label: bf16_backward_counts(mask.numpy(), smoke.FLASH_NQ, smoke.FLASH_NKV,
                                        smoke.FLASH_DH)
            for label, mask in masks.items()}


def best_rate(lib, entry: str, out, blocks: int, sms: int) -> float:
    """The highest rate per SM over the chain and thread configurations of
    one instruction, printing each."""
    best = 0.0
    fn = getattr(lib, entry)
    for chains in (4, 8, 16):
        for threads in (128, 256, 512):
            def launch():
                status = fn(out.data_ptr(), chains, blocks, threads, ROUNDS,
                            torch.cuda.current_stream().cuda_stream)
                if status != 0:
                    raise RuntimeError(f"{entry}: cudaError {status}")

            launch()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                launch()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 5
            count = blocks * threads // 32 * ROUNDS * chains
            rate = count / (ms * 1e-3) / sms
            best = max(best, rate)
            print(f"{entry}: chains {chains}, {threads} threads a block: {ms:.4f} ms, "
                  f"{rate / 1e9:.3f} G instructions a second per SM", flush=True)
    return best


def best_wgmma_rate(lib, rs: bool, sms: int, tf32: bool = False) -> float:
    """The highest rate per SM of one wgmma shape (bf16: m64n128k16 with A in
    registers when rs, else m64n32k16 from shared memory; tf32: m64n128k8,
    A in registers or shared memory) over 1-3 warpgroups a block and 1-2
    blocks an SM, printing each."""
    best = 0.0
    rounds = ROUNDS // 4
    entry = lib.wgmma_tf32_rate if tf32 else lib.wgmma_rate
    if tf32:
        name = f"wgmma tf32 m64n128k8 ({'A in registers' if rs else 'A, B in shared memory'})"
    else:
        name = ("wgmma m64n128k16 (A in registers)" if rs
                else "wgmma m64n32k16 (A, B in shared memory)")
    for groups in (1, 2, 3):
        for per_sm in (1, 2):
            blocks = per_sm * sms
            out = torch.empty(blocks * 128 * groups, device="cuda")

            def launch():
                status = entry(out.data_ptr(), int(rs), groups, blocks, rounds,
                               torch.cuda.current_stream().cuda_stream)
                if status != 0:
                    raise RuntimeError(f"{name}: cudaError {status}")

            launch()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                launch()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 5
            rate = blocks * groups * rounds * 8 / (ms * 1e-3) / sms
            best = max(best, rate)
            print(f"{name}: {groups} warpgroups a block, {per_sm} blocks an SM: {ms:.4f} ms, "
                  f"{rate / 1e9:.4f} G instructions a second per SM", flush=True)
    return best


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--count-only", action="store_true",
                        help="print the backward kernels' instruction counts and stop")
    args = parser.parse_args()
    counts = backward_mma_counts(*TRAIN_SHAPE)
    print(f"f32 backward at B, T, NQ, NKV, DH = {TRAIN_SHAPE}: {counts}", flush=True)
    fwd = forward_counts()
    for shape, shape_counts in fwd.items():
        print(f"forward, {shape}: {shape_counts}", flush=True)
    bwd16 = bf16_backward_counts_on_masks()
    for shape, shape_counts in bwd16.items():
        print(f"bf16 backward, {shape}: {shape_counts}", flush=True)
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke

    retrieval = tf32_retrieval_counts(
        -(-smoke.BIN_N_REAL // 512) * 512, smoke.BIN_DIM, smoke.BIN_BATCH, smoke.BIN_BINS)
    print(f"float32 retrieval at the serving shape: {retrieval}", flush=True)
    if args.count_only:
        return 0
    if not torch.cuda.is_available():
        print("measure_mma_tf32_rate: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from lean_explore_tpu_torch.ops.cuda_build import NVCC_FLAGS, nvcc_path

    out_dir = REPO / "build" / "mma_tf32_rate"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib_path = out_dir / "mma_tf32_rate.cu", out_dir / "libmma_tf32_rate.so"
    src.write_text(SOURCE)
    csrc = REPO / "lean_explore_tpu_torch" / "csrc"
    subprocess.run([nvcc_path(), *NVCC_FLAGS, "-I", str(csrc), "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    for entry in ("mma_tf32_rate", "mma_bf16_rate", "wgmma_rate", "wgmma_tf32_rate"):
        getattr(lib, entry).argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        getattr(lib, entry).restype = ctypes.c_int
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = BLOCKS_PER_SM * sms
    out = torch.empty(blocks * 512, device="cuda")
    best = best_rate(lib, "mma_tf32_rate", out, blocks, sms)
    best_bf16 = best_rate(lib, "mma_bf16_rate", out, blocks, sms)
    best_ss = best_wgmma_rate(lib, False, sms)
    best_rs = best_wgmma_rate(lib, True, sms)
    best_tf32_rs = best_wgmma_rate(lib, True, sms, tf32=True)
    best_tf32_ss = best_wgmma_rate(lib, False, sms, tf32=True)

    def bf16_bwd_floor(kernel: str, n: dict) -> float:
        if kernel.endswith("_hmma"):
            return n[kernel] / (best_bf16 * sms) * 1e3
        return (n[f"{kernel}_ss"] / best_ss + n[f"{kernel}_rs"] / best_rs) / sms * 1e3

    print(json.dumps({
        "card": card, "sms": sms, "best_per_sm_per_s": best,
        "tf32_flop_per_s": best * sms * 2 * 16 * 8 * 8,
        "best_bf16_per_sm_per_s": best_bf16,
        "bf16_flop_per_s": best_bf16 * sms * 2 * 16 * 8 * 16,
        "backward_ms_at_best": {k: n / (best * sms) * 1e3 for k, n in counts.items()},
        "forward_ms_at_best": {
            shape: {k: n / ((best if k == "fwd_f32" else best_bf16) * sms) * 1e3
                    for k, n in shape_counts.items() if not k.endswith("_share")}
            for shape, shape_counts in fwd.items()
        },
        "best_wgmma_m64n32k16_ss_per_sm_per_s": best_ss,
        "best_wgmma_m64n128k16_rs_per_sm_per_s": best_rs,
        "wgmma_ss_flop_per_s": best_ss * sms * 2 * 64 * 32 * 16,
        "wgmma_rs_flop_per_s": best_rs * sms * 2 * 64 * 128 * 16,
        "bf16_backward_ms_at_best": {
            shape: {kernel: bf16_bwd_floor(kernel, n)
                    for kernel in ("dkv_hmma", "dq_hmma", "dkv_wgmma", "dq_wgmma")}
            for shape, n in bwd16.items()
        },
        "best_wgmma_tf32_m64n128k8_rs_per_sm_per_s": best_tf32_rs,
        "best_wgmma_tf32_m64n128k8_ss_per_sm_per_s": best_tf32_ss,
        "wgmma_tf32_rs_flop_per_s": best_tf32_rs * sms * 2 * 64 * 128 * 8,
        "wgmma_tf32_ss_flop_per_s": best_tf32_ss * sms * 2 * 64 * 128 * 8,
        "tf32_retrieval_ms_at_best": {k: n / (best_tf32_rs * sms) * 1e3
                                      for k, n in retrieval.items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
