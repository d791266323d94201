// Fused corpus matmul + bin-max selection with packed provenance, for Hopper.
//
// Replaces the TPU kernel `_bin_topk_kernel` reached through
// `pallas_bin_topk` (lean_explore_tpu/ops/pallas_retrieval.py:214 and :402).
// It computes the same packed carry `[bins, B]` f32: for every query q and
// bin b, the max over the corpus rows r with r % bins == b of
//
//     packed(r, q) = bits(max(score(r, q) + 3, 1e-30)) with the low
//                    `steal_bits` mantissa bits replaced by r / bins,
//
// where score is the bf16 x bf16 inner product accumulated in f32 (or, for
// a float32 corpus, the f32 x f32 one as 3xTF32, see below), and pad
// rows (r >= n_valid) contribute bits(0) | (r / bins). All packed values are
// non-negative, so float order equals the order of their bit patterns and a
// plain max folds score and provenance together. The top-k epilogue over
// `[B, bins]` and the bit unpacking stay torch ops in the wrapper
// (lean_explore_tpu_torch/ops/bin_topk.py), as the TPU version runs them
// outside `pallas_call`. Two differences from the TPU: the epilogue is an
// exact `torch.topk` where the TPU used `lax.approx_max_k` (recall_target
// 0.99), and each result row comes from the unpacked provenance bits and
// the bin position, never from a gather.
//
// Design. The TPU walks corpus tiles in order on one core and keeps one
// carry in VMEM. Here bin slice [s0, s0+BM) only ever receives rows
// p*bins + s0 .. p*bins + s0 + BM - 1 of super-tile p, so a thread block
// owns one slice of bins for one block of BN queries and loops over the
// super-tiles, keeping its running max in registers: no atomics, and since
// max is order-free the carry does not depend on block order. To fill the
// card, the super-tiles are also split over `groups` blocks (grid z); each
// writes a partial carry and a second small kernel takes the max over them.
// The product is mma.sync m16n8k16 (bf16 in, f32 accumulate) from shared
// memory tiles filled by double-buffered cp.async; wgmma and TMA are later
// work. The kernel is `tiles::bin_carry_kernel<Bf16Product>` of
// mma_tiles.cuh, which it shares with the int8 version (bin_topk_int8.cu).
//
// A float32 corpus takes `tiles::bin_carry_kernel<F32Product>`: the same
// tiles, where a 128-byte stage holds 32 f32 values and each 32-byte slice
// is one mma.sync m16n8k8 tf32 step, taken three times as 3xTF32 (hi*hi +
// hi*lo + lo*hi), which keeps the products within about 3 * 2^-22 of f32.
// The TPU kernel runs f32 at HIGHEST precision (pallas_retrieval.py:156).
// The function's bound at the serving shape is by bytes: the corpus read
// is 1.229 GB, 0.37 ms at 3.35 TB/s, against 78.6 GFLOP, 0.16 ms at the
// 495 TFLOP/s TF32 rate. 3xTF32 runs three products, 0.48 ms of tensor
// time, so this kernel cannot reach that bound; it is the simple exact
// choice, and a faster f32 product is later work.
//
// Bound at the serving shape (N = 300,032 rows padded to 512, D = 1024,
// B = 128, bins = 4096): the corpus read is 300,032 * 1024 * 2 B = 614 MB,
// 0.18 ms at 3.35 TB/s; the arithmetic is 2 * 300,032 * 128 * 1024 =
// 78.6 GFLOP, 0.08 ms at 989 TFLOP/s bf16. The kernel is memory-bound, with
// a bound of about 0.18 ms.

#include "mma_tiles.cuh"

extern "C" {

// Writes the packed carry [bins, B] to `out`. With groups > 1 the super-tiles
// are split over that many blocks per bin slice, and `partial` must hold
// groups * bins * B floats. Returns cudaGetLastError() after the launches.
// Requires N % 64 == 0, bins % 64 == 0 and D % 64 == 0 (the wrapper checks).
int bin_topk_carry(const void* q, const void* corpus, void* out, void* partial, int B,
                   int N, int D, int n_valid, int bins, int steal_bits, int groups,
                   void* stream) {
  return tiles::launch_bin_carry<tiles::Bf16Product>(
      q, corpus, nullptr, nullptr, out, partial, B, N, D * 2, n_valid, bins, steal_bits,
      groups, stream);
}

// The same carry over a float32 corpus and float32 queries (3xTF32).
// Requires N % 64 == 0, bins % 64 == 0 and D % 32 == 0.
int bin_topk_carry_f32(const void* q, const void* corpus, void* out, void* partial, int B,
                       int N, int D, int n_valid, int bins, int steal_bits, int groups,
                       void* stream) {
  return tiles::launch_bin_carry<tiles::F32Product>(
      q, corpus, nullptr, nullptr, out, partial, B, N, D * 4, n_valid, bins, steal_bits,
      groups, stream);
}

}  // extern "C"
