// Building blocks shared by the port's kernels. The flash-attention kernels
// (flash_tiles.cuh, flash_attention.cu, flash_attention_bwd.cu) take the
// cp.async copies, ldmatrix and the mma.sync products: Bf16Product, and
// F32Product's 3xTF32 split and products. The retrieval kernels K1-K4
// (bin_topk.cu, bin_topk_int8.cu, bin_topk_pipelined.cu,
// windowed_scores.cu) run on wgmma (ring_tiles.cuh, ring_carry.cuh) and
// take from here the stage depth, the packing constants, F32Product's
// split, ldmatrix, and the carry's super-tiles of a block
// (`group_supertiles`) and max over groups (`max_over_groups_kernel`).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tiles {
namespace {  // internal linkage: each kernel library has its own copy

constexpr int STAGE_BYTES = 128;  // depth bytes of one pipeline stage

constexpr float PACK_SHIFT = 3.0f;
constexpr float PACK_FLOOR = 1e-30f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes == 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// bf16 x bf16 products accumulated in f32; a score is the accumulator.
struct Bf16Product {
  __device__ static __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// f32 x f32 products as 3xTF32 (the TPU kernels take f32 at HIGHEST
// precision, pallas_retrieval.py:156): each operand x is split into
// hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest, and the
// product is accumulated in f32 as lo*hi + hi*lo + hi*hi, dropping lo*lo.
// x - hi - lo is at most 2^-22 |x|, so each product is within about
// 3 * 2^-22 |x y| of the exact one before the f32 sums (the tolerance is
// derived in ops/bin_topk.py, score_tolerance). `split` runs once per
// loaded fragment.
struct F32Product {
  __device__ static __forceinline__ uint32_t to_tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return r;
  }
  template <int R>
  __device__ static __forceinline__ void split(const uint32_t (&x)[R], uint32_t (&hi)[R],
                                               uint32_t (&lo)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float v = __uint_as_float(x[i]);
      hi[i] = to_tf32(v);
      lo[i] = to_tf32(v - __uint_as_float(hi[i]));
    }
  }
  __device__ static __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                                  uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ static __forceinline__ void mma3(float (&c)[4], const uint32_t (&a_hi)[4],
                                              const uint32_t (&a_lo)[4], uint32_t b0_hi,
                                              uint32_t b1_hi, uint32_t b0_lo, uint32_t b1_lo) {
    mma_tf32(c, a_lo, b0_hi, b1_hi);
    mma_tf32(c, a_hi, b0_lo, b1_lo);
    mma_tf32(c, a_hi, b0_hi, b1_hi);
  }
};

// Super-tiles [p_begin, p_end) of group `group` in which the slice of bins
// from s0 has rows inside the corpus of N rows (p * bins + s0 < N).
__device__ __forceinline__ void group_supertiles(int N, int bins, int s0, int group,
                                                 int tiles_per_group, int& p_begin,
                                                 int& p_end) {
  const int n_super = (N + bins - 1) / bins;
  p_begin = group * tiles_per_group;
  p_end = min(p_begin + tiles_per_group, n_super);
  while (p_end > p_begin && (long long)(p_end - 1) * bins + s0 >= N) --p_end;
}

// out[i] = max over g of partial[g][i]; every value is a non-negative packed float.
__global__ void max_over_groups_kernel(const float* __restrict__ partial,
                                       float* __restrict__ out, long long size,
                                       int groups) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < size;
       i += (long long)gridDim.x * blockDim.x) {
    float m = partial[i];
    for (int g = 1; g < groups; ++g) m = fmaxf(m, partial[(long long)g * size + i]);
    out[i] = m;
  }
}

// out [bins, B] = the max over the `groups` partial carries in `partial`.
inline void launch_max_over_groups(const void* partial, void* out, int bins, int B, int groups,
                                   cudaStream_t s) {
  const long long size = (long long)bins * B;
  const int blocks = (int)((size + 255) / 256);
  max_over_groups_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(partial),
                                                static_cast<float*>(out), size, groups);
}

}  // namespace
}  // namespace tiles
