// Building blocks shared by the port's mma.sync kernels: the int8 carry
// (bin_topk_int8.cu), K4's ring-fed carry (bin_topk_pipelined.cu) and,
// through flash_tiles.cuh, the flash-attention kernels. K1 and K3
// (bin_topk.cu, windowed_scores.cu) run on wgmma in both element types
// (ring_tiles.cuh) and take only F32Product's split, the packing constants
// and `group_supertiles` / `max_over_groups_kernel` from here.
//
// Each block computes 64 x 64 tiles of (corpus rows) x (queries) with four
// warps of 32 x 32. Both operands are row-major with the depth contiguous
// (corpus [N, D], queries [B, D]), so the depth is walked in stages of 128
// bytes: 64 bf16, 128 int8 or 32 f32 values. Double-buffered cp.async
// copies each stage into shared memory (bin_topk_pipelined.cu fills each
// stage with two TMA tile copies in the 128-byte swizzled layout) and
// ldmatrix feeds it to mma.sync.
// The fragment layouts of m16n8k16 bf16, m16n8k32 s8 and m16n8k8 tf32 are
// the same byte for byte (each 32-bit register holds 4 bytes of one row:
// two bf16, four int8 or one f32), so one loader and one ldmatrix walk
// serve all three: each 32-byte slice of a stage is one mma k-step, and
// only the mma instruction differs.
//
// The carry's pieces (the super-tiles of a block, the fold of one
// super-tile, the store) are templates over the product type: K4 folds
// bf16 and 3xTF32 products with them, and the int8 carry kernel (the port
// of the TPU's `_bin_topk_kernel_int8`,
// lean_explore_tpu/ops/pallas_retrieval.py:260) scaled int8 ones. K1's
// wgmma kernels (bin_topk.cu) fold with fold_supertile's arithmetic on
// wgmma's accumulator layout, so K4 equals K1 bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tiles {
namespace {  // internal linkage: each kernel library has its own copy

constexpr int BM = 64;              // corpus rows (bins) per block tile
constexpr int BN = 64;              // queries per block tile
constexpr int STAGE_BYTES = 128;    // depth bytes of one pipeline stage
constexpr int LDS = STAGE_BYTES + 16;  // smem row stride, 144 B: no ldmatrix bank conflicts
constexpr int THREADS = 128;        // 4 warps as 2 (rows) x 2 (queries), 32 x 32 each
constexpr int STAGE_SMEM = BM * LDS;   // bytes of one buffered tile (BM == BN)

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
  using Acc = float;
  static constexpr bool kScaled = false;
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
  using Acc = float;
  static constexpr bool kScaled = false;
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

// int8 x int8 products accumulated exactly in int32; a score is
// (raw * row_scale) * query_scale in f32, each step rounded on its own
// (never contracted into an FMA), the order of the TPU kernel (:286-288).
struct Int8Product {
  using Acc = int32_t;
  static constexpr bool kScaled = true;
  static constexpr bool kSplit = false;
  __device__ static __forceinline__ void mma(int32_t (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// Starts the cp.async copies of one stage: rows [0, BM) of `a_rows` (row
// stride a_stride bytes) and query rows [q0, q0 + BN) of `q` (stride
// q_stride bytes), bytes [k0, k0 + STAGE_BYTES) of each. Query rows >= B
// are filled with zeros. 512 chunks of 16 B per tile, 4 per thread.
__device__ __forceinline__ void load_stage(uint8_t* sa, uint8_t* sb, const uint8_t* a_rows,
                                           long long a_stride, const uint8_t* q,
                                           long long q_stride, int q0, int B, int k0,
                                           int tid) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = tid + i * THREADS;
    const int r = c >> 3;
    const int col = (c & 7) * 16;
    cp_async16(sa + r * LDS + col, a_rows + r * a_stride + k0 + col, 16);
    const int qr = q0 + r;
    const bool ok = qr < B;
    cp_async16(sb + r * LDS + col, q + (ok ? qr : 0) * q_stride + k0 + col, ok ? 16 : 0);
  }
}

// The cp.async stage tile's layout: byte offset of (row r, byte c) with
// rows padded to LDS bytes.
struct PaddedRows {
  __device__ static __forceinline__ int offset(int r, int c) { return r * LDS + c; }
};

// Accumulates one stage's products into this warp's 32 x 32 fragment. L
// maps (row, 16-byte aligned byte column) of a stage tile to its byte offset.
template <class P, class L = PaddedRows>
__device__ __forceinline__ void mma_stage(typename P::Acc (&acc)[2][4][4], const uint8_t* a_tile,
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

// The carry's pieces that the two mma.sync carry kernels share
// (bin_carry_kernel below, fed by cp.async, and bin_carry_pipelined_kernel
// of bin_topk_pipelined.cu, fed by a TMA ring): the super-tiles of a block,
// the fold of one super-tile and the store.

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

template <class P>
__device__ __forceinline__ void zero_fragments(typename P::Acc (&acc)[2][4][4],
                                               float (&carry)[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0;
        carry[i][j][e] = 0.0f;
      }
}

// Folds super-tile p's scores (this warp's accumulators, rows
// p * bins + s0 + frag_row) into the packed running max, and zeroes the
// accumulators for the next super-tile.
template <class P>
__device__ __forceinline__ void fold_supertile(float (&carry)[2][4][4],
                                               typename P::Acc (&acc)[2][4][4], uint32_t p,
                                               int bins, int s0, int n_valid,
                                               uint32_t low_mask,
                                               const float* __restrict__ row_scales,
                                               const float (&qs)[4][2], int warp_m, int lane) {
  const long long row0 = (long long)p * bins + s0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int eh = 0; eh < 2; ++eh) {
      const int m = frag_row(warp_m, lane, mi, eh * 2);
      float rs = 1.0f;
      if constexpr (P::kScaled) rs = row_scales[row0 + m];
      const bool valid = row0 + m < n_valid;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int el = 0; el < 2; ++el) {
          const int e = eh * 2 + el;
          float s;
          if constexpr (P::kScaled) {
            s = __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][e]), rs), qs[ni][el]);
          } else {
            s = acc[mi][ni][e];
          }
          const float shifted = valid ? fmaxf(__fadd_rn(s, PACK_SHIFT), PACK_FLOOR) : 0.0f;
          const uint32_t bits = (__float_as_uint(shifted) & ~low_mask) | p;
          carry[mi][ni][e] = fmaxf(carry[mi][ni][e], __uint_as_float(bits));
          acc[mi][ni][e] = 0;
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

// Packed bin-max carry of the int8 product. Grid: x = bin slice
// (bins / BM), y = query block (ceil(B / BN)), z = super-tile group. Block
// (x, y, z) owns bins [s0, s0 + BM) for queries [q0, q0 + BN), loops over
// the super-tiles of its group (rows p * bins + s0 .. + BM), and writes
// out[z][s0 .. s0 + BM)[q0 .. q0 + BN), scaling the products by the row
// scales [N] and the query scales [B].
template <class P>
__global__ void __launch_bounds__(THREADS)
bin_carry_kernel(const uint8_t* __restrict__ q,        // [B, row_bytes]
                 const uint8_t* __restrict__ corpus,   // [N, row_bytes]
                 const float* __restrict__ q_scales,   // [B] (int8 only)
                 const float* __restrict__ row_scales, // [N] (int8 only)
                 float* __restrict__ out,              // [groups, bins, B]
                 int B, int N, int row_bytes, int n_valid, int bins, int steal_bits,
                 int tiles_per_group) {
  static_assert(P::kScaled, "K1's unscaled products run on wgmma (bin_topk.cu)");
  __shared__ __align__(16) uint8_t smem_a[2][STAGE_SMEM];
  __shared__ __align__(16) uint8_t smem_b[2][STAGE_SMEM];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp & 1;
  const int warp_n = warp >> 1;
  const int s0 = blockIdx.x * BM;
  const int q0 = blockIdx.y * BN;

  int p_begin, p_end;
  group_supertiles(N, bins, s0, blockIdx.z, tiles_per_group, p_begin, p_end);
  const int k_steps = row_bytes / STAGE_BYTES;
  const int total = (p_end > p_begin) ? (p_end - p_begin) * k_steps : 0;
  const uint32_t low_mask = (1u << steal_bits) - 1u;

  float qs[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = q0 + frag_col(warp_n, lane, ni, h);
      qs[ni][h] = n < B ? q_scales[n] : 1.0f;
    }

  typename P::Acc acc[2][4][4];
  float carry[2][4][4];
  zero_fragments<P>(acc, carry);

  auto load = [&](int t, int buf) {
    const int p = p_begin + t / k_steps;
    const int k0 = (t % k_steps) * STAGE_BYTES;
    const long long row0 = (long long)p * bins + s0;
    load_stage(smem_a[buf], smem_b[buf], corpus + row0 * row_bytes, row_bytes, q, row_bytes,
               q0, B, k0, tid);
  };

  if (total > 0) load(0, 0);
  cp_async_commit();

  for (int t = 0; t < total; ++t) {
    const int buf = t & 1;
    if (t + 1 < total) load(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    mma_stage<P>(acc, smem_a[buf], smem_b[buf], warp_m, warp_n, lane);
    __syncthreads();

    if ((t % k_steps) == k_steps - 1) {
      fold_supertile<P>(carry, acc, (uint32_t)(p_begin + t / k_steps), bins, s0, n_valid,
                        low_mask, row_scales, qs, warp_m, lane);
    }
  }
  cp_async_wait_all();

  store_carry(out + (long long)blockIdx.z * bins * B, carry, s0, q0, B, warp_m, warp_n, lane);
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

// Launches the carry kernel over `groups` slices of the super-tiles and,
// when groups > 1, the max over the partial carries (`partial` holds
// groups * bins * B floats). Returns cudaGetLastError() after the launches.
template <class P>
int launch_bin_carry(const void* q, const void* corpus, const void* q_scales,
                     const void* row_scales, void* out, void* partial, int B, int N,
                     int row_bytes, int n_valid, int bins, int steal_bits, int groups,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_super = (N + bins - 1) / bins;
  const int tiles_per_group = (n_super + groups - 1) / groups;
  dim3 grid(bins / BM, (B + BN - 1) / BN, groups);
  float* carry_out = groups > 1 ? static_cast<float*>(partial) : static_cast<float*>(out);
  bin_carry_kernel<P><<<grid, THREADS, 0, s>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(corpus),
      static_cast<const float*>(q_scales), static_cast<const float*>(row_scales), carry_out,
      B, N, row_bytes, n_valid, bins, steal_bits, tiles_per_group);
  if (groups > 1) launch_max_over_groups(partial, out, bins, B, groups, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace tiles
