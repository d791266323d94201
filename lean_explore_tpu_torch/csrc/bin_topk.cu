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
// a float32 corpus, the f32 x f32 one as 3xTF32; the TPU kernel runs f32 at
// HIGHEST precision, pallas_retrieval.py:156), and pad rows (r >= n_valid)
// contribute bits(0) | (r / bins). All packed values are non-negative, so
// float order equals the order of their bit patterns and a plain max folds
// score and provenance together. The top-k epilogue over `[B, bins]` and
// the bit unpacking stay torch ops in the wrapper
// (lean_explore_tpu_torch/ops/bin_topk.py), as the TPU version runs them
// outside `pallas_call`. Two differences from the TPU: the epilogue is an
// exact `torch.topk` where the TPU used `lax.approx_max_k` (recall_target
// 0.99), and each result row comes from the unpacked provenance bits and
// the bin position, never from a gather.
//
// Design. The TPU walks corpus tiles in order on one core and keeps one
// carry in VMEM. Here a block owns one slice of 128 bins for one block of
// 128 queries, loops over the super-tiles and keeps its running max on the
// SM, the super-tiles split over `groups` blocks and a max over the
// groups' partial carries after (ring_carry.cuh). Both element types run
// that file's kernel template, ring_carry_kernel (the int8 carry,
// bin_topk_int8.cu, too), over the ring-fed wgmma block of ring_tiles.cuh:
// two consumer warpgroups of 64 bins and a producer warp that keeps a TMA
// ring of stages (128 corpus rows and the block's 128 queries, 128 bytes
// deep) in flight. bf16: four m64n128k16 wgmma a stage and warpgroup, both
// operands by descriptor, a 4-stage ring of 32 KB stages; f32: 3xTF32
// m64n128k8, each corpus value split once in registers and the queries
// once a launch (split_tf32_kernel), a 3-stage ring of 48 KB stages.
//
// Bound at the serving shape (300,000 valid rows of 300,032 x 1024, B = 128,
// bins = 4096), by bytes for both types: bf16 reads 616.8 MB (the corpus
// once, the queries, the carry), 0.1841 ms at 3.35 TB/s, against 78.6
// GFLOP, 0.08 ms at 989 TFLOP/s; f32 reads 1,231.4 MB, 0.3676 ms, against
// 0.16 ms at the 495 TFLOP/s TF32 rate (its three products, 236 GFLOP,
// take 0.48 ms: the floor of a 3xTF32 design). Each block also reads its
// queries from L2 once per super-tile: 0.6 GB (bf16) or 2.4 GB (f32 halves)
// a launch beside the corpus. Measured on an NVIDIA H100 80GB HBM3 at
// 700 W (PERF.md): bf16 0.22 ms, 1.2x its bound, against 0.57 ms for the
// mma.sync kernel with cp.async that it replaced; it is held by the
// stream (without its products, its query copies or its fold it takes the
// same time: the corpus arrives at about 2.8 TB/s on 128 of the 132 SMs).
// Its carry in registers spills (168 registers) and runs 27% slower; A
// from registers, or 3 or 5 ring stages, change nothing. f32 0.68 ms,
// against 1.77-2.04 ms for the mma.sync kernel before it. Both give the
// bits of the mma.sync kernels before them.

#include "ring_carry.cuh"

namespace tiles {
namespace {  // the headers' internal namespace, reopened

constexpr int CARRY_STAGES = 3;       // ring stages of the f32 carry kernel (144 KB)
constexpr int BF16_CARRY_STAGES = 4;  // ring stages of the bf16 carry kernel (128 KB)

}  // namespace
}  // namespace tiles

extern "C" {

// Writes the packed carry [bins, B] of bf16 queries [B, D] and a bf16
// corpus [N, D] to `out`. `groups` splits the super-tiles of each 128-bin
// slice (the wrapper's ring_supertile_groups), and `partial` holds
// groups * bins * B floats when groups > 1. Requires N % 64 == 0,
// bins % 64 == 0, D % 64 == 0 and 16-byte aligned inputs (the wrapper
// checks). Returns the first CUDA error of the launches
// (cudaErrorInvalidValue for a tensor map that cannot be made).
int bin_topk_carry(const void* q, const void* corpus, void* out, void* partial, int B,
                   int N, int D, int n_valid, int bins, int steal_bits, int groups,
                   void* stream) {
  tiles::RingMaps maps = {};
  if (!tiles::one_box_maps(q, corpus, B, N, D * 2, maps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return tiles::launch_ring_carry<tiles::Bf16Stage>(
      maps, nullptr, nullptr, out, partial, B, N, D, n_valid, bins, steal_bits, groups,
      tiles::BF16_CARRY_STAGES, static_cast<cudaStream_t>(stream));
}

// The same carry over a float32 corpus and float32 queries (3xTF32 on
// wgmma), with `q_split` scratch of 2 * B * D floats for the queries' tf32
// halves, split first. Requires D % 32 == 0 and the rest as bin_topk_carry.
int bin_topk_carry_f32(const void* q, void* q_split, const void* corpus, void* out,
                       void* partial, int B, int N, int D, int n_valid, int bins,
                       int steal_bits, int groups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  tiles::RingMaps maps;
  const int split = tiles::tf32_prologue(q, q_split, corpus, B, N, D, maps, s);
  if (split != 0) return split;
  return tiles::launch_ring_carry<tiles::Tf32Stage<false>>(
      maps, nullptr, nullptr, out, partial, B, N, D, n_valid, bins, steal_bits, groups,
      tiles::CARRY_STAGES, s);
}

}  // extern "C"
