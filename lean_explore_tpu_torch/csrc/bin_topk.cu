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
// carry in VMEM. Here bin slice [s0, s0 + 128) only ever receives rows
// p * bins + s0 .. of super-tile p, so a block owns one slice of 128 bins
// for one block of 128 queries and loops over the super-tiles, keeping its
// running max on the SM: no atomics, and since max is order-free the carry
// does not depend on block order. To fill the card the super-tiles are also
// split over `groups` blocks (grid z; the wrapper's ring_supertile_groups,
// at most one block an SM: 32 slices x 4 groups = 128 blocks at the serving
// shape); each writes a partial carry and `max_over_groups_kernel` takes the
// max over them. Both element types run one kernel template,
// ring_carry_kernel, over the ring-fed wgmma block of ring_tiles.cuh: two
// consumer warpgroups of 64 bins and a producer warp that keeps a TMA ring
// of stages (128 corpus rows and the block's 128 queries, 128 bytes deep)
// in flight. bf16: four m64n128k16 wgmma a stage
// and warpgroup, both operands by descriptor, a 4-stage ring of 32 KB
// stages; f32: 3xTF32 m64n128k8, each corpus value split once in
// registers and the queries once a launch (split_tf32_kernel), a 3-stage
// ring of 48 KB stages. Each warpgroup folds a super-tile into its packed
// carry with fold_supertile's arithmetic (mma_tiles.cuh) on wgmma's
// accumulator layout; the carry lives in shared memory, each thread's 64
// words its own, so that the accumulators and the operands fit the
// registers that a block of nine warps leaves a thread (168) without
// spilling. A warpgroup whose bins lie past `bins` (bins % 128 == 64), or
// whose rows of its group's last super-tile lie past N, multiplies but does
// not fold.
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

#include "ring_tiles.cuh"

namespace tiles {
namespace {  // the headers' internal namespace, reopened

constexpr int CARRY_STAGES = 3;       // ring stages of the f32 carry kernel (144 KB)
constexpr int BF16_CARRY_STAGES = 4;  // ring stages of the bf16 carry kernel (128 KB)
// The words between a thread's carry words: the warpgroups' packed carries
// lie in shared memory (64 KB), accumulator i of thread t of a warpgroup at
// word i * 128 + t of the group's part.
constexpr int GROUP_THREADS = 128;
constexpr int CARRY_SMEM = RING_GROUPS * RING_ACC * GROUP_THREADS * (int)sizeof(float);

// Folds super-tile p's scores of this warpgroup (rows p * bins + s ..) into
// its packed running max (this thread's words of `carry`, GROUP_THREADS
// apart) with fold_supertile's arithmetic, and zeroes acc.
__device__ __forceinline__ void fold_acc(float* carry, float (&acc)[RING_ACC], uint32_t p,
                                         int bins, int s, int n_valid, uint32_t low_mask,
                                         int warp, int lane) {
  const long long row0 = (long long)p * bins + s;
#pragma unroll
  for (int i = 0; i < RING_ACC; ++i) {
    const bool valid = row0 + acc_row(warp, lane, i) < n_valid;
    const float shifted = valid ? fmaxf(__fadd_rn(acc[i], PACK_SHIFT), PACK_FLOOR) : 0.0f;
    const uint32_t bits = (__float_as_uint(shifted) & ~low_mask) | p;
    float& word = carry[i * GROUP_THREADS];
    word = fmaxf(word, __uint_as_float(bits));
    acc[i] = 0.0f;
  }
}

// Writes this warpgroup's carry (words GROUP_THREADS apart) to
// out[s ..][q0 ..] of a [bins, B] carry, columns < B only.
__device__ __forceinline__ void store_acc_carry(float* __restrict__ dst, const float* carry,
                                                int q0, int B, int warp, int lane) {
#pragma unroll
  for (int i = 0; i < RING_ACC; ++i) {
    const int n = q0 + acc_col(lane, i);
    if (n < B) dst[(long long)acc_row(warp, lane, i) * B + n] = carry[i * GROUP_THREADS];
  }
}

// The packed carry over the ring of Stage (Bf16Stage, or Tf32Stage over
// the query halves of q_hi_map and q_lo_map; a bf16 launch's q_lo_map is
// unused). Grid: x = slice of RING_ROWS bins, y = block of RING_QUERIES
// queries, z = super-tile group. Warpgroup wg of block (x, y, z) owns bins
// [s, s + 64), s = x * RING_ROWS + 64 wg, for queries [q0, q0 +
// RING_QUERIES), folds the super-tiles of its group (rows p * bins + s ..)
// and writes out[z][s .. s + 64)[q0 ..], columns < B.
template <class Stage>
__global__ void __launch_bounds__(RING_THREADS, 1)
ring_carry_kernel(const __grid_constant__ CUtensorMap corpus_map,
                  const __grid_constant__ CUtensorMap query_map,
                  const __grid_constant__ CUtensorMap q_lo_map,
                  float* __restrict__ out,  // [groups, bins, B]
                  int B, int N, int k_steps, int n_valid, int bins, int steal_bits,
                  int tiles_per_group, int n_stages) {
  extern __shared__ __align__(128) uint8_t smem[];
  const typename Stage::Ring ring(smem, n_stages);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int s0 = blockIdx.x * RING_ROWS;
  const int q0 = blockIdx.y * RING_QUERIES;
  int p_begin, p_end;
  group_supertiles(N, bins, s0, blockIdx.z, tiles_per_group, p_begin, p_end);
  const int total = p_end > p_begin ? (p_end - p_begin) * k_steps : 0;
  ring.init(tid);
  __syncthreads();

  RingSlot at;
  if (warp == RING_CONSUMER_WARPS) {
    if (lane == 0) {
      for (int t = 0; t < total; ++t) {
        ring_fill(ring, at, &corpus_map, &query_map, &q_lo_map, (t % k_steps) * STAGE_BYTES,
                  (p_begin + t / k_steps) * bins + s0, q0);
      }
      ring_drain(ring, at);
    }
    return;
  }

  const int s = s0 + (warp >> 2) * 64;
  const uint32_t low_mask = (1u << steal_bits) - 1u;
  float* carry = reinterpret_cast<float*>(ring.after()) +
                 (warp >> 2) * RING_ACC * GROUP_THREADS + (warp & 3) * 32 + lane;
  float acc[RING_ACC];
  zero_acc(acc);
#pragma unroll
  for (int i = 0; i < RING_ACC; ++i) carry[i * GROUP_THREADS] = 0.0f;
  for (int t = 0; t < total; ++t) {
    Stage::step(acc, ring, at, warp, lane);
    if (t % k_steps == k_steps - 1) {
      const int p = p_begin + t / k_steps;
      if ((long long)p * bins + s < N) {
        fold_acc(carry, acc, (uint32_t)p, bins, s, n_valid, low_mask, warp, lane);
      } else {
        zero_acc(acc);
      }
    }
  }
  if (s >= bins) return;
  store_acc_carry(out + ((long long)blockIdx.z * bins + s) * B, carry, q0, B, warp, lane);
}

// Launches ring_carry_kernel<Stage> on an n-stage ring over `groups` slices
// of the super-tiles and, when groups > 1, the max over the partial carries.
// Returns the first CUDA error.
template <class Stage>
int launch_ring_carry(const RingMaps& maps, void* out, void* partial, int B, int N, int D,
                      int n_valid, int bins, int steal_bits, int groups, int n_stages,
                      cudaStream_t s) {
  const int smem = Stage::Ring::smem_bytes(n_stages, CARRY_SMEM);
  const cudaError_t attr = cudaFuncSetAttribute(
      ring_carry_kernel<Stage>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_super = (N + bins - 1) / bins;
  const int tiles_per_group = (n_super + groups - 1) / groups;
  float* carry_out = groups > 1 ? static_cast<float*>(partial) : static_cast<float*>(out);
  const dim3 grid((bins + RING_ROWS - 1) / RING_ROWS, (B + RING_QUERIES - 1) / RING_QUERIES,
                  groups);
  ring_carry_kernel<Stage><<<grid, RING_THREADS, smem, s>>>(
      maps.corpus, maps.queries, maps.q_lo, carry_out, B, N,
      D * Stage::ELEMENT_BYTES / STAGE_BYTES, n_valid, bins, steal_bits, tiles_per_group,
      n_stages);
  if (groups > 1) launch_max_over_groups(partial, out, bins, B, groups, s);
  return static_cast<int>(cudaGetLastError());
}

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
  if (!tiles::bf16_maps(q, corpus, B, N, D, maps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return tiles::launch_ring_carry<tiles::Bf16Stage>(
      maps, out, partial, B, N, D, n_valid, bins, steal_bits, groups, tiles::BF16_CARRY_STAGES,
      static_cast<cudaStream_t>(stream));
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
      maps, out, partial, B, N, D, n_valid, bins, steal_bits, groups, tiles::CARRY_STAGES, s);
}

}  // extern "C"
