// K1's packed bin-max carry, fed by a ring of TMA tile copies, for Hopper.
//
// Replaces the TPU kernel `_bin_topk_pipelined_kernel` reached through
// `pallas_bin_topk_pipelined` (lean_explore_tpu/ops/pallas_retrieval.py:502
// and :571). On the TPU that kernel is `_bin_topk_kernel` (:214) with the
// grid's automatic pipeline replaced by a hand-driven one: the corpus stays
// in HBM and streams through `n_buffers` VMEM slots by explicit
// `make_async_copy`, each slot guarded by a DMA semaphore, and its carry is
// bit-identical to the grid kernel's. This kernel is the same on Hopper: it
// computes bin_topk.cu's packed carry [bins, B] f32, bit for bit, under
// the block decomposition of the mma.sync kernel that K1 ran before its
// wgmma one (grid x = bin slice of 64, y = query block of 64, z = super-tile group,
// then `max_over_groups_kernel` when groups > 1; each block loops over its
// super-tiles and keeps the running max in registers), with mma.sync
// products (bf16, or 3xTF32 for float32) whose k steps add as K1's wgmma
// steps do, and the same fold (`mma_stage`, `fold_supertile` and
// `store_carry` of mma_tiles.cuh). Where that kernel had all 128 threads
// start 16-byte cp.async into two buffers, with a __syncthreads() on
// either side of every stage's product, K4 is fed by a ring:
//
// - A block has 160 threads: consumer warps 0-3 (K1's 2 x 2 layout of
//   32 x 32 fragments) and producer warp 4, of which one lane starts the
//   copies. The producer fills a ring of `n_buffers` stages in dynamic
//   shared memory. A stage is K1's: 64 corpus rows and 64 query rows of 128
//   depth bytes, each tile one TMA copy (`cp.async.bulk.tensor.2d`) through
//   a tensor map built on the host (`cuTensorMapEncodeTiled`, looked up
//   through the CUDA runtime, so no -lcuda), in the 128-byte swizzle: the
//   16-byte chunk j of row r lands at chunk j ^ (r % 8), and the consumers'
//   ldmatrix addresses apply the same XOR (`Swizzle128Rows`), so the walk
//   stays conflict-free and the products keep K1's k order. Both copies
//   complete on the stage's full mbarrier, whose `arrive.expect_tx` carries
//   the stage's 16,384 bytes. Each consumer warp arrives on the stage's
//   empty mbarrier once its ldmatrix reads of the stage are done, and the
//   producer waits on that before it refills the slot. The reads are
//   generic-proxy accesses and the refill an async-proxy write, so each
//   consumer thread issues `fence.proxy.async.shared::cta` before the
//   arrive: the barrier's release alone does not order them. Without the
//   fence the refill overtook a warp's last reads of a stage, and a few
//   carry words differed from K1's in some bf16 launches
//   (scripts/stress_torch_pipelined.py shows it). Phase parity is tracked
//   per ring pass. There is no __syncthreads() inside the main loop: the
//   producer does not take part.
// - Query rows >= B lie outside the query tensor map: the TMA fills them
//   with zeros (and counts their bytes). Their accumulator columns are
//   never stored.
//
// A first version copied each 128-byte row with its own `cp.async.bulk`
// (128 copies a stage, into K1's padded 144-byte rows): right, but bound by
// the copy requests, at 2.03 ms (bf16) and 4.49 ms (f32) at the serving
// shape against K1's 0.55 and 1.75 on an H100 SXM at 700 W (PERF.md). Two
// tile copies a stage take that limit away: 0.31 and 1.67 ms there, K1's
// products and fold fed faster than K1 feeds them.
//
// Bound at the serving shape (300,000 valid rows of 300,032 x 1024, B = 128,
// bins = 4096), the same work as bin_topk.cu: 616.8 MB read (the corpus
// once, the queries and the carry), 0.1841 ms at 3.35 TB/s, against 78.6
// GFLOP, 0.08 ms at 989 TFLOP/s bf16; a float32 corpus reads 1,231.4 MB,
// 0.3676 ms, against 0.16 ms at the 495 TFLOP/s TF32 rate. Both are bound by
// bytes. The ring keeps up to `n_buffers - 1` stages of copies in flight
// while the consumers multiply, and takes the copies off the consumer warps;
// the product is still mma.sync, and `wgmma` (which reads these swizzled
// tiles from shared memory directly) is later work.

#include "mma_tiles.cuh"
#include "tma_ring.cuh"

namespace tiles {
namespace {

constexpr int CONSUMER_WARPS = THREADS / 32;    // 4, K1's 2 x 2 layout
constexpr int PIPE_THREADS = THREADS + 32;      // plus producer warp 4
constexpr int TILE_BYTES = BM * STAGE_BYTES;    // one swizzled 64 x 128-byte tile
constexpr int RING_STAGE = 2 * TILE_BYTES;      // corpus tile, then query tile
constexpr int STAGE_BARRIERS = 2 * sizeof(uint64_t);  // full and empty mbarrier
constexpr int RING_ALIGN = 1024;                // the 128-byte swizzle's period
constexpr int SMEM_LIMIT = 232448;              // dynamic shared memory of one block

// Dynamic shared memory of an n-stage ring: the stages, their barriers and
// the slack that lets the ring start on a 1024-byte boundary.
constexpr int ring_smem_bytes(int n_buffers) {
  return n_buffers * (RING_STAGE + STAGE_BARRIERS) + RING_ALIGN;
}

constexpr int MAX_BUFFERS = (SMEM_LIMIT - RING_ALIGN) / (RING_STAGE + STAGE_BARRIERS);

// The TMA's 128-byte swizzle of a tile of 128-byte rows starting on a
// 1024-byte boundary: byte c (16-byte aligned) of row r.
struct Swizzle128Rows {
  __device__ static __forceinline__ int offset(int r, int c) {
    return r * STAGE_BYTES + (c ^ ((r & 7) << 4));
  }
};

// K1's packed carry on mma.sync, fed by the TMA ring. `corpus_map` and `query_map` view the corpus
// [N, row_bytes] and the queries [B, row_bytes] as bytes, in boxes of 64 rows
// x 128 bytes with the 128-byte swizzle. Dynamic shared memory:
// ring_smem_bytes(n_buffers): the n_buffers stages from the first 1024-byte
// boundary, then n_buffers full and n_buffers empty mbarriers.
template <class P>
__global__ void __launch_bounds__(PIPE_THREADS)
bin_carry_pipelined_kernel(const __grid_constant__ CUtensorMap corpus_map,
                           const __grid_constant__ CUtensorMap query_map,
                           float* __restrict__ out,  // [groups, bins, B]
                           int B, int N, int row_bytes, int n_valid, int bins,
                           int steal_bits, int tiles_per_group, int n_buffers) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* ring = smem + ((RING_ALIGN - (smem_addr(smem) & (RING_ALIGN - 1))) & (RING_ALIGN - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + n_buffers * RING_STAGE);
  uint64_t* empty = full + n_buffers;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int s0 = blockIdx.x * BM;
  const int q0 = blockIdx.y * BN;

  int p_begin, p_end;
  group_supertiles(N, bins, s0, blockIdx.z, tiles_per_group, p_begin, p_end);
  const int k_steps = row_bytes / STAGE_BYTES;
  const int total = (p_end > p_begin) ? (p_end - p_begin) * k_steps : 0;

  if (tid == 0) {
    for (int s = 0; s < n_buffers; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    // Producer. Iteration t fills slot t % n_buffers once the consumers have
    // released its previous use (t - n_buffers); on the first pass the
    // parity of the phase before phase 0 passes at once. The last n_buffers
    // waits (t >= total) hold the lane until every stage has been read.
    if (lane == 0) {
      int slot = 0;
      uint32_t phase = 0;
      for (int t = 0; t < total + n_buffers; ++t) {
        mbar_wait(&empty[slot], phase ^ 1u);
        if (t < total) {
          const int p = p_begin + t / k_steps;
          const int k0 = (t % k_steps) * STAGE_BYTES;
          uint8_t* sa = ring + slot * RING_STAGE;
          mbar_arrive_expect_tx(&full[slot], RING_STAGE);
          tma_load(sa, &corpus_map, k0, p * bins + s0, &full[slot]);
          tma_load(sa + TILE_BYTES, &query_map, k0, q0, &full[slot]);
        }
        if (++slot == n_buffers) {
          slot = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }

  // Consumers: K1's products and fold, one stage at a time from the ring.
  const int warp_m = warp & 1;
  const int warp_n = warp >> 1;
  const uint32_t low_mask = (1u << steal_bits) - 1u;
  float acc[2][4][4];
  float carry[2][4][4];
  zero_fragments(acc, carry);

  int slot = 0;
  uint32_t phase = 0;
  for (int t = 0; t < total; ++t) {
    mbar_wait(&full[slot], phase);
    const uint8_t* sa = ring + slot * RING_STAGE;
    mma_stage<P, Swizzle128Rows>(acc, sa, sa + TILE_BYTES, warp_m, warp_n, lane);
    // The slot's refill is an async-proxy write: fence the ldmatrix reads.
    fence_proxy_async_shared();
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
    if (++slot == n_buffers) {
      slot = 0;
      phase ^= 1u;
    }
    if ((t % k_steps) == k_steps - 1) {
      fold_supertile(carry, acc, (uint32_t)(p_begin + t / k_steps), bins, s0, n_valid,
                     low_mask, warp_m, lane);
    }
  }

  store_carry(out + (long long)blockIdx.z * bins * B, carry, s0, q0, B, warp_m, warp_n, lane);
}

// Launches the pipelined carry kernel over `groups` slices of the
// super-tiles and, when groups > 1, the max over the partial carries. Returns the first error: cudaErrorInvalidValue for a
// ring size out of range or a tensor map that cannot be made, the
// shared-memory attribute's, or cudaGetLastError() after the launches.
template <class P>
int launch_bin_carry_pipelined(const void* q, const void* corpus, void* out, void* partial,
                               int B, int N, int row_bytes, int n_valid, int bins,
                               int steal_bits, int groups, int n_buffers, void* stream) {
  CUtensorMap corpus_map, query_map;
  if (n_buffers < 2 || n_buffers > MAX_BUFFERS || !encode_rows(&corpus_map, corpus, N, row_bytes) ||
      !encode_rows(&query_map, q, B, row_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = ring_smem_bytes(n_buffers);
  const cudaError_t attr = cudaFuncSetAttribute(
      bin_carry_pipelined_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_super = (N + bins - 1) / bins;
  const int tiles_per_group = (n_super + groups - 1) / groups;
  dim3 grid(bins / BM, (B + BN - 1) / BN, groups);
  float* carry_out = groups > 1 ? static_cast<float*>(partial) : static_cast<float*>(out);
  bin_carry_pipelined_kernel<P><<<grid, PIPE_THREADS, smem, s>>>(
      corpus_map, query_map, carry_out, B, N, row_bytes, n_valid, bins, steal_bits,
      tiles_per_group, n_buffers);
  if (groups > 1) launch_max_over_groups(partial, out, bins, B, groups, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace tiles

extern "C" {

// Writes the packed carry [bins, B] of bf16 queries [B, D] and a bf16 corpus
// [N, D] to `out`, through an `n_buffers`-stage ring (2 to 14, what a
// block's 227 KB of shared memory holds). With groups > 1, `partial` must
// hold groups * bins * B floats. Requires N % 64 == 0, bins % 64 == 0,
// D % 64 == 0 and 16-byte aligned inputs (the wrapper checks). Returns the
// first CUDA error of the launch, 0 when there is none.
int bin_topk_pipelined_carry(const void* q, const void* corpus, void* out, void* partial,
                             int B, int N, int D, int n_valid, int bins, int steal_bits,
                             int groups, int n_buffers, void* stream) {
  return tiles::launch_bin_carry_pipelined<tiles::Bf16Product>(
      q, corpus, out, partial, B, N, D * 2, n_valid, bins, steal_bits, groups, n_buffers,
      stream);
}

// The same carry over float32 queries and corpus (3xTF32, as
// bin_topk_carry_f32). Requires D % 32 == 0.
int bin_topk_pipelined_carry_f32(const void* q, const void* corpus, void* out, void* partial,
                                 int B, int N, int D, int n_valid, int bins, int steal_bits,
                                 int groups, int n_buffers, void* stream) {
  return tiles::launch_bin_carry_pipelined<tiles::F32Product>(
      q, corpus, out, partial, B, N, D * 4, n_valid, bins, steal_bits, groups, n_buffers,
      stream);
}

}  // extern "C"
