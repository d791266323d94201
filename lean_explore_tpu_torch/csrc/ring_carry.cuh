// The packed bin-max carry on the ring-fed wgmma block (ring_tiles.cuh): one
// kernel template over the stage, shared by K1 (bin_topk.cu: Bf16Stage,
// Tf32Stage<false>), K2 (bin_topk_int8.cu: Int8Stage) and K4
// (bin_topk_pipelined.cu: K1's stages, the ring's depth from n_buffers).
//
// Bin slice [s0, s0 + 128) only ever receives rows p * bins + s0 .. of
// super-tile p, so a block owns one slice of 128 bins for one block of 128
// queries and loops over the super-tiles, keeping its running max on the
// SM: no atomics, and since max is order-free the carry does not depend on
// block order. To fill the card the super-tiles are also split over
// `groups` blocks (grid z; the wrappers' ring_supertile_groups, at most one
// block an SM: 32 slices x 4 groups = 128 blocks at the serving shape);
// each writes a partial carry and `max_over_groups_kernel` takes the max
// over them. Each warpgroup folds a super-tile into its packed carry
// (fold_acc, the arithmetic of the plain twin ops/bin_topk.fold_supertiles)
// on wgmma's accumulator layout; the carry lives in shared memory, each thread's 64 words its own,
// so that the accumulators and the operands fit the registers that a block
// of nine warps leaves a thread (168) without spilling. A warpgroup whose
// bins lie past `bins` (bins % 128 == 64), or whose rows of its group's last
// super-tile lie past N, multiplies but does not fold.
//
// A scaled stage (int8) folds Stage::score of each accumulator: the block's
// 128 query scales lie in shared memory after the carry, written once
// before the loop (the 32 columns of a thread would take 32 registers), and
// each thread loads the row scales of its two rows (acc_row: r and r + 8)
// of a super-tile from device memory at the super-tile's first stage, so
// that the loads complete under its products. A warpgroup that does not
// fold loads none: its rows may lie past N.

#pragma once

#include "ring_tiles.cuh"

namespace tiles {
namespace {  // the headers' internal namespace, reopened

// The words between a thread's carry words: the warpgroups' packed carries
// lie in shared memory (64 KB), accumulator i of thread t of a warpgroup at
// word i * 128 + t of the group's part.
constexpr int GROUP_THREADS = 128;
constexpr int CARRY_SMEM = RING_GROUPS * RING_ACC * GROUP_THREADS * (int)sizeof(float);

// Shared memory after a carry kernel's ring: the carry, then a scaled
// stage's query scales.
template <class Stage>
constexpr int carry_extra_smem() {
  return CARRY_SMEM + (Stage::SCALED ? RING_QUERIES * (int)sizeof(float) : 0);
}

// Folds super-tile p's scores of this warpgroup (rows p * bins + s ..) into
// its packed running max (this thread's words of `carry`, GROUP_THREADS
// apart) as ops/bin_topk.fold_supertiles does: max(score + 3, 1e-30), 0 on
// pad rows, the low steal bits replaced by p. Zeroes acc. A scaled stage's
// scores take the row scales rs of the thread's rows (r, r + 8) and the
// block's query scales qs.
template <class Stage>
__device__ __forceinline__ void fold_acc(float* carry, typename Stage::Acc (&acc)[RING_ACC],
                                         uint32_t p, int bins, int s, int n_valid,
                                         uint32_t low_mask, const float (&rs)[2],
                                         const float* qs, int warp, int lane) {
  const long long row0 = (long long)p * bins + s;
#pragma unroll
  for (int i = 0; i < RING_ACC; ++i) {
    const bool valid = row0 + acc_row(warp, lane, i) < n_valid;
    float score;
    if constexpr (Stage::SCALED) {
      score = Stage::score(acc[i], rs[(i >> 1) & 1], qs[acc_col(lane, i)]);
    } else {
      score = acc[i];
    }
    const float shifted = valid ? fmaxf(__fadd_rn(score, PACK_SHIFT), PACK_FLOOR) : 0.0f;
    const uint32_t bits = (__float_as_uint(shifted) & ~low_mask) | p;
    float& word = carry[i * GROUP_THREADS];
    word = fmaxf(word, __uint_as_float(bits));
    acc[i] = 0;
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

// The packed carry over the ring of Stage (Bf16Stage, Int8Stage, or
// Tf32Stage over the query halves of q_hi_map and q_lo_map; a one-box
// launch's q_lo_map is unused, and only a scaled stage reads q_scales [B]
// and row_scales [N]). Grid: x = slice of RING_ROWS bins, y = block of
// RING_QUERIES queries, z = super-tile group. Warpgroup wg of block (x, y,
// z) owns bins [s, s + 64), s = x * RING_ROWS + 64 wg, for queries [q0, q0 +
// RING_QUERIES), folds the super-tiles of its group (rows p * bins + s ..)
// and writes out[z][s .. s + 64)[q0 ..], columns < B.
template <class Stage>
__global__ void __launch_bounds__(RING_THREADS, 1)
ring_carry_kernel(const __grid_constant__ CUtensorMap corpus_map,
                  const __grid_constant__ CUtensorMap query_map,
                  const __grid_constant__ CUtensorMap q_lo_map,
                  const float* __restrict__ q_scales, const float* __restrict__ row_scales,
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
  float* query_scales = reinterpret_cast<float*>(ring.after()) + CARRY_SMEM / sizeof(float);
  if constexpr (Stage::SCALED) {
    if (tid < RING_QUERIES) query_scales[tid] = q0 + tid < B ? q_scales[q0 + tid] : 0.0f;
  }
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
  typename Stage::Acc acc[RING_ACC];
  zero_acc(acc);
#pragma unroll
  for (int i = 0; i < RING_ACC; ++i) carry[i * GROUP_THREADS] = 0.0f;
  float rs[2] = {0.0f, 0.0f};
  for (int t = 0; t < total; ++t) {
    if constexpr (Stage::SCALED) {
      const long long row0 = (long long)(p_begin + t / k_steps) * bins + s;
      if (t % k_steps == 0 && row0 < N) {
        const float* r = row_scales + row0 + acc_row(warp, lane, 0);
        rs[0] = r[0];
        rs[1] = r[8];
      }
    }
    Stage::step(acc, ring, at, warp, lane);
    if (t % k_steps == k_steps - 1) {
      const int p = p_begin + t / k_steps;
      if ((long long)p * bins + s < N) {
        fold_acc<Stage>(carry, acc, (uint32_t)p, bins, s, n_valid, low_mask, rs, query_scales,
                        warp, lane);
      } else {
        zero_acc(acc);
      }
    }
  }
  if (s >= bins) return;
  store_acc_carry(out + ((long long)blockIdx.z * bins + s) * B, carry, q0, B, warp, lane);
}

// Launches ring_carry_kernel<Stage> on an n-stage ring over `groups` slices
// of the super-tiles and, when groups > 1, the max over the partial carries
// into `out`. q_scales and row_scales are read by a scaled stage only.
// Returns the first CUDA error.
template <class Stage>
int launch_ring_carry(const RingMaps& maps, const void* q_scales, const void* row_scales,
                      void* out, void* partial, int B, int N, int D, int n_valid, int bins,
                      int steal_bits, int groups, int n_stages, cudaStream_t s) {
  const int smem = Stage::Ring::smem_bytes(n_stages, carry_extra_smem<Stage>());
  const cudaError_t attr = cudaFuncSetAttribute(
      ring_carry_kernel<Stage>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_super = (N + bins - 1) / bins;
  const int tiles_per_group = (n_super + groups - 1) / groups;
  float* carry_out = groups > 1 ? static_cast<float*>(partial) : static_cast<float*>(out);
  const dim3 grid((bins + RING_ROWS - 1) / RING_ROWS, (B + RING_QUERIES - 1) / RING_QUERIES,
                  groups);
  ring_carry_kernel<Stage><<<grid, RING_THREADS, smem, s>>>(
      maps.corpus, maps.queries, maps.q_lo, static_cast<const float*>(q_scales),
      static_cast<const float*>(row_scales), carry_out, B, N,
      D * Stage::ELEMENT_BYTES / STAGE_BYTES, n_valid, bins, steal_bits, tiles_per_group,
      n_stages);
  if (groups > 1) launch_max_over_groups(partial, out, bins, B, groups, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace tiles
