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
// Bound at the serving shape (N = 300,032 rows padded to 512, D = 1024,
// B = 128, bins = 4096): the corpus read is 300,032 * 1024 * 2 B = 614 MB,
// 0.18 ms at 3.35 TB/s; the arithmetic is 2 * 300,032 * 128 * 1024 =
// 78.6 GFLOP, 0.08 ms at 989 TFLOP/s bf16. The kernel is memory-bound, with
// a bound of about 0.18 ms.
//
// A float32 corpus takes `bin_carry_tf32_kernel` below: the same carry and
// the same decomposition (a block owns a slice of bins for a block of
// queries and loops over the super-tiles of its group; max_over_groups_kernel
// when groups > 1), on the 3xTF32 wgmma mainloop of tf32_tiles.cuh (the TPU
// kernel runs f32 at HIGHEST precision, pallas_retrieval.py:156). A block is
// 128 bins (two warpgroups of 64) x 128 queries fed by a 3-stage TMA ring;
// each corpus value is split into tf32 hi and lo once, in registers, and the
// queries once a launch by split_tf32_kernel. Each warpgroup folds a
// super-tile into its packed carry with fold_supertile's arithmetic on
// wgmma's accumulator layout; the carry lives in shared memory, each
// thread's 64 words its own, so that the accumulators, the corpus
// fragments and their halves fit the registers that a block of nine warps
// leaves a thread (168) without spilling. The function's bound at the
// serving shape is by bytes: the corpus read is 1.229 GB, 0.37 ms at 3.35 TB/s, against 78.6
// GFLOP, 0.16 ms at the 495 TFLOP/s TF32 rate. The three products are 236
// GFLOP, 0.48 ms at that rate: the floor of a 3xTF32 design. L2 carries
// the corpus once and the query halves once per (128-bin slice,
// super-tile), 2.4 GB a launch. On an H100 SXM at 700 W it takes 0.68 ms
// at the serving shape, 1.4x that floor, against 1.77-2.04 ms for the
// mma.sync m16n8k8 kernel it replaced, with the same bits (PERF.md).

#include "tf32_tiles.cuh"

namespace tiles {
namespace {  // the headers' internal namespace, reopened

constexpr int CARRY_STAGES = 3;  // ring stages of the f32 carry kernel (144 KB)
constexpr int GROUP_THREADS = 128;
// The warpgroups' packed carries in shared memory (64 KB): accumulator i of
// thread t of a warpgroup at word i * GROUP_THREADS + t of the group's part.
constexpr int CARRY_SMEM = TF32_GROUPS * TF32_ACC * GROUP_THREADS * (int)sizeof(float);

// Folds super-tile p's scores of this warpgroup (rows p * bins + s ..) into
// its packed running max (this thread's words of `carry`, GROUP_THREADS
// apart) with fold_supertile's arithmetic, and zeroes acc.
__device__ __forceinline__ void fold_tf32(float* carry, float (&acc)[TF32_ACC], uint32_t p,
                                          int bins, int s, int n_valid, uint32_t low_mask,
                                          int warp, int lane) {
  const long long row0 = (long long)p * bins + s;
#pragma unroll
  for (int i = 0; i < TF32_ACC; ++i) {
    const bool valid = row0 + tf32_row(warp, lane, i) < n_valid;
    const float shifted = valid ? fmaxf(__fadd_rn(acc[i], PACK_SHIFT), PACK_FLOOR) : 0.0f;
    const uint32_t bits = (__float_as_uint(shifted) & ~low_mask) | p;
    float& word = carry[i * GROUP_THREADS];
    word = fmaxf(word, __uint_as_float(bits));
    acc[i] = 0.0f;
  }
}

// The packed carry of a float32 corpus. Grid: x = slice of TF32_ROWS bins,
// y = block of TF32_QUERIES queries, z = super-tile group. Warpgroup wg of
// block (x, y, z) owns bins [s, s + 64), s = x * TF32_ROWS + 64 wg, for
// queries [q0, q0 + TF32_QUERIES), folds the super-tiles of its group (rows
// p * bins + s ..) and writes out[z][s .. s + 64)[q0 ..], columns < B. A
// warpgroup whose slice lies past `bins` (bins % 128 == 64), or whose rows
// of its group's last super-tile lie past N, multiplies but does not fold.
__global__ void __launch_bounds__(TF32_THREADS, 1)
bin_carry_tf32_kernel(const __grid_constant__ CUtensorMap corpus_map,
                      const __grid_constant__ CUtensorMap q_hi_map,
                      const __grid_constant__ CUtensorMap q_lo_map,
                      float* __restrict__ out,  // [groups, bins, B]
                      int B, int N, int k_steps, int n_valid, int bins, int steal_bits,
                      int tiles_per_group, int n_stages) {
  extern __shared__ __align__(128) uint8_t smem[];
  const Tf32Ring ring(smem, n_stages);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int s0 = blockIdx.x * TF32_ROWS;
  const int q0 = blockIdx.y * TF32_QUERIES;
  int p_begin, p_end;
  group_supertiles(N, bins, s0, blockIdx.z, tiles_per_group, p_begin, p_end);
  const int total = p_end > p_begin ? (p_end - p_begin) * k_steps : 0;
  ring.init(tid);
  __syncthreads();

  RingSlot at;
  if (warp == TF32_CONSUMER_WARPS) {
    if (lane == 0) {
      for (int t = 0; t < total; ++t) {
        tf32_fill(ring, at, &corpus_map, &q_hi_map, &q_lo_map, (t % k_steps) * STAGE_BYTES,
                  (p_begin + t / k_steps) * bins + s0, q0);
      }
      tf32_drain(ring, at);
    }
    return;
  }

  const int s = s0 + (warp >> 2) * 64;
  const uint32_t low_mask = (1u << steal_bits) - 1u;
  float* carry = reinterpret_cast<float*>(ring.after()) +
                 (warp >> 2) * TF32_ACC * GROUP_THREADS + (warp & 3) * 32 + lane;
  float acc[TF32_ACC];
  zero_tf32(acc);
#pragma unroll
  for (int i = 0; i < TF32_ACC; ++i) carry[i * GROUP_THREADS] = 0.0f;
  for (int t = 0; t < total; ++t) {
    tf32_stage<false>(acc, ring, at, warp, lane);
    if (t % k_steps == k_steps - 1) {
      const int p = p_begin + t / k_steps;
      if ((long long)p * bins + s < N) {
        fold_tf32(carry, acc, (uint32_t)p, bins, s, n_valid, low_mask, warp, lane);
      } else {
        zero_tf32(acc);
      }
    }
  }
  if (s >= bins) return;
  float* dst = out + ((long long)blockIdx.z * bins + s) * B;
#pragma unroll
  for (int i = 0; i < TF32_ACC; ++i) {
    const int n = q0 + tf32_col(lane, i);
    if (n < B) dst[(long long)tf32_row(warp, lane, i) * B + n] = carry[i * GROUP_THREADS];
  }
}

// Splits the queries into `q_split` [2, B, D], then launches the f32 carry
// kernel over `groups` slices of the super-tiles and, when groups > 1, the
// max over the partial carries. Returns the first CUDA error.
int launch_bin_carry_tf32(const void* q, void* q_split, const void* corpus, void* out,
                          void* partial, int B, int N, int D, int n_valid, int bins,
                          int steal_bits, int groups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = tf32_smem_bytes(CARRY_STAGES, CARRY_SMEM);
  const cudaError_t attr =
      cudaFuncSetAttribute(bin_carry_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  Tf32Maps maps;
  const int split = tf32_prologue(q, q_split, corpus, B, N, D, maps, s);
  if (split != 0) return split;
  const int n_super = (N + bins - 1) / bins;
  const int tiles_per_group = (n_super + groups - 1) / groups;
  dim3 grid((bins + TF32_ROWS - 1) / TF32_ROWS, (B + TF32_QUERIES - 1) / TF32_QUERIES, groups);
  float* carry_out = groups > 1 ? static_cast<float*>(partial) : static_cast<float*>(out);
  bin_carry_tf32_kernel<<<grid, TF32_THREADS, smem, s>>>(
      maps.corpus, maps.q_hi, maps.q_lo, carry_out, B, N, D * 4 / STAGE_BYTES, n_valid, bins,
      steal_bits, tiles_per_group, CARRY_STAGES);
  if (groups > 1) launch_max_over_groups(partial, out, bins, B, groups, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace tiles

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

// The same carry over a float32 corpus and float32 queries (3xTF32 on
// wgmma), with `q_split` scratch of 2 * B * D floats for the queries' tf32
// halves. `groups` splits the super-tiles of each 128-bin slice (the
// wrapper's tf32_supertile_groups), and `partial` holds groups * bins * B
// floats when groups > 1. Requires N % 64 == 0, bins % 64 == 0, D % 32 == 0
// and 16-byte aligned inputs. Returns the first CUDA error of the launches.
int bin_topk_carry_f32(const void* q, void* q_split, const void* corpus, void* out,
                       void* partial, int B, int N, int D, int n_valid, int bins,
                       int steal_bits, int groups, void* stream) {
  return tiles::launch_bin_carry_tf32(q, q_split, corpus, out, partial, B, N, D, n_valid, bins,
                                      steal_bits, groups, stream);
}

}  // extern "C"
