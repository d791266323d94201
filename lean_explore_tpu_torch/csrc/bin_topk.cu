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
// where score is the bf16 x bf16 inner product accumulated in f32, and pad
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
// work.
//
// Bound at the serving shape (N = 300,032 rows padded to 512, D = 1024,
// B = 128, bins = 4096): the corpus read is 300,032 * 1024 * 2 B = 614 MB,
// 0.18 ms at 3.35 TB/s; the arithmetic is 2 * 300,032 * 128 * 1024 =
// 78.6 GFLOP, 0.08 ms at 989 TFLOP/s bf16. The kernel is memory-bound, with
// a bound of about 0.18 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // bins (corpus rows of one super-tile) per block
constexpr int BN = 64;        // queries per block
constexpr int BK = 64;        // depth of one pipeline stage
constexpr int LDS = BK + 8;   // smem row stride in bf16 (144 B: no ldmatrix bank conflicts)
constexpr int THREADS = 128;  // 4 warps as 2 (rows) x 2 (queries), 32 x 32 each

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

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Grid: x = bin slice (bins / BM), y = query block (ceil(B / BN)),
// z = super-tile group. Block (x, y, z) writes out[z][s0 .. s0+BM)[q0 .. q0+BN).
__global__ void __launch_bounds__(THREADS)
bin_topk_carry_kernel(const __nv_bfloat16* __restrict__ q,       // [B, D]
                      const __nv_bfloat16* __restrict__ corpus,  // [N, D]
                      float* __restrict__ out,                    // [groups, bins, B]
                      int B, int N, int D, int n_valid, int bins,
                      int steal_bits, int tiles_per_group) {
  __shared__ __align__(16) __nv_bfloat16 smem_a[2][BM * LDS];
  __shared__ __align__(16) __nv_bfloat16 smem_b[2][BN * LDS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp & 1;
  const int warp_n = warp >> 1;
  const int s0 = blockIdx.x * BM;
  const int q0 = blockIdx.y * BN;

  // Super-tiles of this block: those whose slice lies inside the corpus.
  const int n_super = (N + bins - 1) / bins;
  const int p_begin = blockIdx.z * tiles_per_group;
  int p_end = min(p_begin + tiles_per_group, n_super);
  while (p_end > p_begin && (long long)(p_end - 1) * bins + s0 >= N) --p_end;
  const int k_steps = D / BK;
  const int total = (p_end > p_begin) ? (p_end - p_begin) * k_steps : 0;
  const uint32_t low_mask = (1u << steal_bits) - 1u;

  float acc[2][4][4];
  float carry[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0.0f;
        carry[i][j][e] = 0.0f;
      }

  // Each stage moves a BM x BK corpus tile and a BN x BK query tile:
  // 512 chunks of 16 B each, 4 per thread per tile.
  auto load_stage = [&](int t, int buf) {
    const int p = p_begin + t / k_steps;
    const int k0 = (t % k_steps) * BK;
    const long long row0 = (long long)p * bins + s0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + i * THREADS;
      const int r = c >> 3;
      const int col = (c & 7) * 8;
      cp_async16(&smem_a[buf][r * LDS + col], corpus + (row0 + r) * D + k0 + col, 16);
      const int qr = q0 + r;
      const bool ok = qr < B;
      cp_async16(&smem_b[buf][r * LDS + col], q + (long long)(ok ? qr : 0) * D + k0 + col,
                 ok ? 16 : 0);
    }
  };

  if (total > 0) load_stage(0, 0);
  cp_async_commit();

  for (int t = 0; t < total; ++t) {
    const int buf = t & 1;
    if (t + 1 < total) load_stage(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    const __nv_bfloat16* a_tile = smem_a[buf];
    const __nv_bfloat16* b_tile = smem_b[buf];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a_frag[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = warp_m * 32 + mi * 16 + (lane & 15);
        const int c = kk + (lane >> 4) * 8;
        ldmatrix_x4(a_frag[mi], a_tile + r * LDS + c);
      }
      uint32_t b_frag[2][4];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int r = warp_n * 32 + nj * 16 + (lane & 7) + (lane >> 4) * 8;
        const int c = kk + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(b_frag[nj], b_tile + r * LDS + c);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const uint32_t* bf = b_frag[ni >> 1];
          const int h = (ni & 1) * 2;
          mma_bf16_16816(acc[mi][ni], a_frag[mi], bf[h], bf[h + 1]);
        }
    }
    __syncthreads();

    if ((t % k_steps) == k_steps - 1) {
      // Fold this super-tile's scores into the packed running max.
      const uint32_t p = (uint32_t)(p_begin + t / k_steps);
      const long long row0 = (long long)p * bins + s0;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = warp_m * 32 + mi * 16 + (lane >> 2) + (e >> 1) * 8;
            const float s = acc[mi][ni][e];
            const float shifted =
                (row0 + m < n_valid) ? fmaxf(s + PACK_SHIFT, PACK_FLOOR) : 0.0f;
            const uint32_t bits = (__float_as_uint(shifted) & ~low_mask) | p;
            carry[mi][ni][e] = fmaxf(carry[mi][ni][e], __uint_as_float(bits));
            acc[mi][ni][e] = 0.0f;
          }
    }
  }
  cp_async_wait_all();

  float* dst = out + (long long)blockIdx.z * bins * B;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = warp_m * 32 + mi * 16 + (lane >> 2) + (e >> 1) * 8;
        const int n = q0 + warp_n * 32 + ni * 8 + (lane & 3) * 2 + (e & 1);
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

}  // namespace

extern "C" {

// Writes the packed carry [bins, B] to `out`. With groups > 1 the super-tiles
// are split over that many blocks per bin slice, and `partial` must hold
// groups * bins * B floats. Returns cudaGetLastError() after the launches.
// Requires N % BM == 0, bins % BM == 0 and D % BK == 0 (the wrapper checks).
int bin_topk_carry(const void* q, const void* corpus, void* out, void* partial, int B,
                   int N, int D, int n_valid, int bins, int steal_bits, int groups,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_super = (N + bins - 1) / bins;
  const int tiles_per_group = (n_super + groups - 1) / groups;
  dim3 grid(bins / BM, (B + BN - 1) / BN, groups);
  float* carry_out = groups > 1 ? static_cast<float*>(partial) : static_cast<float*>(out);
  bin_topk_carry_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(corpus),
      carry_out, B, N, D, n_valid, bins, steal_bits, tiles_per_group);
  if (groups > 1) {
    const long long size = (long long)bins * B;
    const int blocks = (int)((size + 255) / 256);
    max_over_groups_kernel<<<blocks, 256, 0, s>>>(
        static_cast<const float*>(partial), static_cast<float*>(out), size, groups);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
