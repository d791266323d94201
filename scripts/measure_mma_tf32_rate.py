"""How many tf32 mma.sync m16n8k8 (SASS HMMA.1688.F32.TF32) can one SM of
this GPU issue a second? The ceiling of the port's 3xTF32 kernels, which
are built on that instruction. On one GPU.

    python3 scripts/measure_mma_tf32_rate.py [--count-only]

First prints how many of these instructions K5's float32 backward kernels
(``csrc/flash_attention_bwd.cu``) issue at the training shape (B 32 x
T 256, 16/8 heads, DH 128), counted from their grids: the 16 x 32 tile
pairs that each warp does not skip, times its products (3 in dq, 4 in
dk/dv), each 3xTF32. With ``--count-only`` it stops there and needs no
GPU. Then it writes a small
CUDA source into ``build/mma_tf32_rate/``, builds it with the
port's nvcc flags, and launches 4 blocks an SM, each of 128, 256 or 512
threads, whose warps each run 2,000 rounds of 4, 8 or 16 independent
accumulator chains of the instruction (no loads, no other work). Prints the
card's name and power limit, then per configuration the CUDA-event time of
5 launches after a warm one and the rate in instructions a second per SM,
and last a JSON line with the highest rate and the time the counted
instructions take at it. Exits 2 without a device.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <int CHAINS>
__global__ void mma_tf32_chains(float* out, int rounds) {
  const uint32_t a[4] = {threadIdx.x << 13, 0x3f800000u, 0x3f000000u, blockIdx.x << 13};
  const uint32_t b0 = 0x3f800000u, b1 = threadIdx.x << 14;
  float acc[CHAINS][4] = {};
  for (int i = 0; i < rounds; ++i) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) {
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int mma_tf32_rate(float* out, int chains, int blocks, int threads, int rounds,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chains == 4) mma_tf32_chains<4><<<blocks, threads, 0, s>>>(out, rounds);
  else if (chains == 8) mma_tf32_chains<8><<<blocks, threads, 0, s>>>(out, rounds);
  else if (chains == 16) mma_tf32_chains<16><<<blocks, threads, 0, s>>>(out, rounds);
  else return (int)cudaErrorInvalidValue;
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--count-only", action="store_true",
                        help="print the backward kernels' instruction counts and stop")
    args = parser.parse_args()
    counts = backward_mma_counts(*TRAIN_SHAPE)
    print(f"f32 backward at B, T, NQ, NKV, DH = {TRAIN_SHAPE}: {counts}", flush=True)
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
    subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.mma_tf32_rate.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.mma_tf32_rate.restype = ctypes.c_int
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = BLOCKS_PER_SM * sms
    out = torch.empty(blocks * 512, device="cuda")
    best = 0.0
    for chains in (4, 8, 16):
        for threads in (128, 256, 512):
            def launch():
                status = lib.mma_tf32_rate(out.data_ptr(), chains, blocks, threads, ROUNDS,
                                           torch.cuda.current_stream().cuda_stream)
                if status != 0:
                    raise RuntimeError(f"mma_tf32_rate: cudaError {status}")

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
            print(f"chains {chains}, {threads} threads a block: {ms:.4f} ms, "
                  f"{rate / 1e9:.3f} G mma.m16n8k8.tf32 a second per SM", flush=True)
    print(json.dumps({"card": card, "sms": sms, "best_per_sm_per_s": best,
                      "tf32_flop_per_s": best * sms * 2 * 16 * 8 * 8,
                      "backward_ms_at_best": {k: n / (best * sms) * 1e3
                                              for k, n in counts.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
