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
// Design: `tiles::bin_carry_kernel<Int8Product>` of mma_tiles.cuh, the bf16
// kernel's tiling with one-byte elements. A pipeline stage is 128 int8
// values deep; mma.sync m16n8k32 s8.s8.s32 takes the same ldmatrix
// fragments byte for byte as m16n8k16 bf16. Bin slices of 64 for 64
// queries per block, super-tiles split over grid z, then a max over the
// groups' partial carries. wgmma and TMA are later work.
//
// Bound at the serving shape (N = 300,032 rows, D = 1024, B = 128,
// bins = 4096): the codes are 300,032 * 1024 B = 307 MB, the row scales
// 1.2 MB, the carry 2.1 MB, so about 311 MB or 0.093 ms at 3.35 TB/s; the
// arithmetic is 2 * 300,032 * 128 * 1024 = 78.6 GOP, 0.040 ms at 1,979 TOP/s
// int8. The kernel is bound by bytes.

#include "mma_tiles.cuh"

extern "C" {

// Writes the packed carry [bins, B] to `out` (see bin_topk.cu's entry).
// `q` holds B rows of D int8 codes, `corpus` N rows, `q_scales` B floats and
// `row_scales` N floats. Requires N % 64 == 0, bins % 64 == 0 and
// D % 128 == 0 (the wrapper checks).
int bin_topk_int8_carry(const void* q, const void* q_scales, const void* corpus,
                        const void* row_scales, void* out, void* partial, int B, int N,
                        int D, int n_valid, int bins, int steal_bits, int groups,
                        void* stream) {
  return tiles::launch_bin_carry<tiles::Int8Product>(
      q, corpus, q_scales, row_scales, out, partial, B, N, D, n_valid, bins, steal_bits,
      groups, stream);
}

}  // extern "C"
