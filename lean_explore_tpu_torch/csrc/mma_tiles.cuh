// Building blocks shared by the port's mma.sync kernels: K4's ring-fed
// carry (bin_topk_pipelined.cu) and, through flash_tiles.cuh, the
// flash-attention kernels. K1, K2 and K3 (bin_topk.cu, bin_topk_int8.cu,
// windowed_scores.cu) run on wgmma (ring_tiles.cuh, ring_carry.cuh) and take
// only F32Product's split, the packing constants and `group_supertiles` /
// `max_over_groups_kernel` from here.
//
// K4 computes 64 x 64 tiles of (corpus rows) x (queries) a block with four
// warps of 32 x 32. Both operands are row-major with the depth contiguous
// (corpus [N, D], queries [B, D]), so the depth is walked in stages of 128
// bytes: 64 bf16 or 32 f32 values. Its TMA ring fills each stage with two
// tile copies in the 128-byte swizzled layout, and ldmatrix feeds it to
// mma.sync. The fragment layouts of m16n8k16 bf16 and m16n8k8 tf32 are the
// same byte for byte (each 32-bit register holds 4 bytes of one row: two
// bf16 or one f32), so one ldmatrix walk serves both: each 32-byte slice of
// a stage is one mma k-step, and only the mma instruction differs.
//
// The carry's pieces (the super-tiles of a block, the fold of one
// super-tile, the store) are templates over the product type, with which
// K4 folds bf16 and 3xTF32 products. K1's and K2's wgmma kernels
// (ring_carry.cuh) fold with fold_supertile's arithmetic on wgmma's
// accumulator layout, so K4 equals K1 bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tiles {
namespace {  // internal linkage: each kernel library has its own copy

constexpr int BM = 64;              // corpus rows (bins) per block tile
constexpr int BN = 64;              // queries per block tile
constexpr int STAGE_BYTES = 128;    // depth bytes of one pipeline stage
constexpr int THREADS = 128;        // 4 warps as 2 (rows) x 2 (queries), 32 x 32 each

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
  static constexpr bool kSplit = false;
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
  static constexpr bool kSplit = true;
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

// Row (within the 64-row tile) and query column (within the 64-query tile)
// of accumulator element e of fragment (mi, ni) of this thread.
__device__ __forceinline__ int frag_row(int warp_m, int lane, int mi, int e) {
  return warp_m * 32 + mi * 16 + (lane >> 2) + (e >> 1) * 8;
}

__device__ __forceinline__ int frag_col(int warp_n, int lane, int ni, int e) {
  return warp_n * 32 + ni * 8 + (lane & 3) * 2 + (e & 1);
}

// Accumulates one stage's products into this warp's 32 x 32 fragment. L
// maps (row, 16-byte aligned byte column) of a stage tile to its byte offset.
template <class P, class L>
__device__ __forceinline__ void mma_stage(float (&acc)[2][4][4], const uint8_t* a_tile,
                                          const uint8_t* b_tile, int warp_m, int warp_n,
                                          int lane) {
#pragma unroll
  for (int kk = 0; kk < STAGE_BYTES; kk += 32) {
    uint32_t a_frag[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = warp_m * 32 + mi * 16 + (lane & 15);
      const int c = kk + (lane >> 4) * 16;
      ldmatrix_x4(a_frag[mi], a_tile + L::offset(r, c));
    }
    uint32_t b_frag[2][4];
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      const int r = warp_n * 32 + nj * 16 + (lane & 7) + (lane >> 4) * 8;
      const int c = kk + ((lane >> 3) & 1) * 16;
      ldmatrix_x4(b_frag[nj], b_tile + L::offset(r, c));
    }
    if constexpr (P::kSplit) {
      uint32_t a_hi[2][4], a_lo[2][4], b_hi[2][4], b_lo[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        P::split(a_frag[i], a_hi[i], a_lo[i]);
        P::split(b_frag[i], b_hi[i], b_lo[i]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int j = ni >> 1;
          const int h = (ni & 1) * 2;
          P::mma3(acc[mi][ni], a_hi[mi], a_lo[mi], b_hi[j][h], b_hi[j][h + 1], b_lo[j][h],
                  b_lo[j][h + 1]);
        }
    } else {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const uint32_t* bf = b_frag[ni >> 1];
          const int h = (ni & 1) * 2;
          P::mma(acc[mi][ni], a_frag[mi], bf[h], bf[h + 1]);
        }
    }
  }
}

// The carry's pieces of K4's mma.sync kernel (bin_carry_pipelined_kernel of
// bin_topk_pipelined.cu): the super-tiles of a block, the fold of one
// super-tile and the store.

// Super-tiles [p_begin, p_end) of group `group` whose slice of bins
// [s0, s0 + BM) lies inside the corpus of N rows.
__device__ __forceinline__ void group_supertiles(int N, int bins, int s0, int group,
                                                 int tiles_per_group, int& p_begin,
                                                 int& p_end) {
  const int n_super = (N + bins - 1) / bins;
  p_begin = group * tiles_per_group;
  p_end = min(p_begin + tiles_per_group, n_super);
  while (p_end > p_begin && (long long)(p_end - 1) * bins + s0 >= N) --p_end;
}

__device__ __forceinline__ void zero_fragments(float (&acc)[2][4][4], float (&carry)[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0.0f;
        carry[i][j][e] = 0.0f;
      }
}

// Folds super-tile p's scores (this warp's accumulators, rows
// p * bins + s0 + frag_row) into the packed running max, and zeroes the
// accumulators for the next super-tile.
__device__ __forceinline__ void fold_supertile(float (&carry)[2][4][4], float (&acc)[2][4][4],
                                               uint32_t p, int bins, int s0, int n_valid,
                                               uint32_t low_mask, int warp_m, int lane) {
  const long long row0 = (long long)p * bins + s0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int eh = 0; eh < 2; ++eh) {
      const bool valid = row0 + frag_row(warp_m, lane, mi, eh * 2) < n_valid;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int el = 0; el < 2; ++el) {
          const int e = eh * 2 + el;
          const float s = acc[mi][ni][e];
          const float shifted = valid ? fmaxf(__fadd_rn(s, PACK_SHIFT), PACK_FLOOR) : 0.0f;
          const uint32_t bits = (__float_as_uint(shifted) & ~low_mask) | p;
          carry[mi][ni][e] = fmaxf(carry[mi][ni][e], __uint_as_float(bits));
          acc[mi][ni][e] = 0.0f;
        }
    }
}

// Writes this thread's carry to dst[s0 .. s0 + BM)[q0 .. q0 + BN) of a
// [bins, B] carry, query columns < B only.
__device__ __forceinline__ void store_carry(float* __restrict__ dst,
                                            const float (&carry)[2][4][4], int s0, int q0,
                                            int B, int warp_m, int warp_n, int lane) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = frag_row(warp_m, lane, mi, e);
        const int n = q0 + frag_col(warp_n, lane, ni, e);
        if (n < B) dst[(long long)(s0 + m) * B + n] = carry[mi][ni][e];
      }
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
