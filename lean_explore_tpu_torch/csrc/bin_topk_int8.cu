// Fused int8 corpus matmul + bin-max selection with packed provenance, for
// Hopper.
//
// Replaces the TPU kernel `_bin_topk_kernel_int8` reached through
// `pallas_bin_topk_int8` (lean_explore_tpu/ops/pallas_retrieval.py:260 and
// :308). It computes the same packed carry `[bins, B]` f32 as the bf16
// kernel (bin_topk.cu) over a corpus quantised per row (ops/quant.py):
// int8 codes [N, D] with f32 scales [N], against query codes [B, D] with
// f32 scales [B] that the wrapper quantises on the device. Each score is
//
//     score(r, q) = (float(raw(r, q)) * row_scale[r]) * query_scale[q],
//
// raw being the int8 x int8 inner product accumulated in int32 (exact:
// |raw| <= 127^2 * D, below 2^24 for D <= 1024, so the conversion to f32 is
// exact too). Each multiply and the +3 of the packing are rounded on their
// own with __fmul_rn / __fadd_rn: nvcc would otherwise contract
// (raw * rs) * qs + 3 into an FMA and round differently from the plain twin
// (ops/bin_topk_int8.py), which this kernel matches bit for bit. (XLA's CPU
// backend does contract the JAX kernel's steps in interpret mode; against
// that reference the port differs by at most one packing quantum, see
// tests/test_torch_bin_topk_int8.py.) Packing, pad rows and the stolen
// super-tile bits are those of the bf16 kernel. The epilogue (exact
// `torch.topk` over [B, bins], where the TPU used `lax.approx_max_k`, and
// the unpacking) is torch ops in the wrapper.
//
// Design: K1's block with one-byte elements, `ring_carry_kernel<Int8Stage>`
// (ring_carry.cuh over ring_tiles.cuh). Two consumer warpgroups of 64 bins
// and a producer warp a block of 128 bins x 128 queries, one block an SM,
// the super-tiles split over groups (ops.bin_topk.ring_supertile_groups: 32
// slices x 4 groups at the serving shape) and a max over the groups'
// partial carries. The producer keeps a 4-stage TMA ring of 32 KB stages
// (128 corpus rows and the block's 128 query rows, 128 bytes deep, in the
// 128-byte swizzle) in flight; each warpgroup adds a stage's four
// m64n128k32 s8 wgmma (both operands by descriptor, 32 bytes a step as in
// bf16) into 64 s32 registers a thread, and every 8 stages at D = 1024 folds
// them into its carry in shared memory: f32 of each sum, times its row's
// scale (two loads a thread and super-tile, issued at its first stage),
// times its query's scale (the block's 128 in shared memory). The sums are
// exact integers in any order, so the carry keeps the bits of the mma.sync
// kernel (m16n8k32 s8, cp.async) that this one replaced.
//
// Bound at the serving shape (300,000 valid rows of 300,032 x 1024, B = 128,
// bins = 4096): the codes are 300,032 * 1024 B = 307 MB, the row scales
// 1.2 MB, the carry 2.1 MB, so 310.7 MB or 0.0927 ms at 3.35 TB/s; the
// arithmetic is 2 * 300,032 * 128 * 1024 = 78.6 GOP, 0.040 ms at 1,979 TOP/s
// int8. The bound is by bytes.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md;
// scripts/compare_torch_kernel_builds.py, scripts/time_int8_variants.py):
// 0.143-0.151 ms, 1.6x its bound, against 0.361-0.374 ms in turns for the
// mma.sync kernel (64 x 64 blocks of four warps, a two-buffer cp.async
// loader) that it replaced. Unlike K1 bf16 it is not held by the stream
// alone: without its products it takes 0.121-0.125 ms, without its fold
// 0.120-0.126 (the corpus then arrives at about 2.5 TB/s), without its query
// copies the same as with them. Both warpgroups fold at the same stage,
// twice as often a byte as K1 bf16 does and with three more operations an
// element, and their products and folds together outlast the stream by
// about a sixth. 3 or 5 ring stages run 1-2% slower than 4; keeping one
// stage's products in flight while the next stage is waited for (wgmma
// wait_group 1) runs 10% slower.

#include "ring_carry.cuh"

namespace tiles {
namespace {  // the headers' internal namespace, reopened

constexpr int INT8_CARRY_STAGES = 4;  // ring stages of the int8 carry kernel (128 KB)

}  // namespace
}  // namespace tiles

extern "C" {

// Writes the packed carry [bins, B] to `out` (see bin_topk.cu's entry).
// `q` holds B rows of D int8 codes, `corpus` N rows, `q_scales` B floats and
// `row_scales` N floats. `groups` splits the super-tiles of each 128-bin
// slice (the wrapper's ring_supertile_groups), and `partial` holds
// groups * bins * B floats when groups > 1. Requires N % 64 == 0,
// bins % 64 == 0, D % 128 == 0 and 16-byte aligned inputs (the wrapper
// checks). Returns the first CUDA error of the launches
// (cudaErrorInvalidValue for a tensor map that cannot be made).
int bin_topk_int8_carry(const void* q, const void* q_scales, const void* corpus,
                        const void* row_scales, void* out, void* partial, int B, int N,
                        int D, int n_valid, int bins, int steal_bits, int groups,
                        void* stream) {
  tiles::RingMaps maps = {};
  if (!tiles::one_box_maps(q, corpus, B, N, D, maps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return tiles::launch_ring_carry<tiles::Int8Stage>(
      maps, q_scales, row_scales, out, partial, B, N, D, n_valid, bins, steal_bits, groups,
      tiles::INT8_CARRY_STAGES, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
