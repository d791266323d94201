// Masked transposed scores plus window maxima, for Hopper: the first pass of
// the exact windowed top-k.
//
// Replaces the TPU kernel `_fused_kernel` reached through `fused_scores_wmax`
// (lean_explore_tpu/ops/pallas_retrieval.py:30 and :60), which feeds
// `pallas_windowed_topk` (:653). For a bf16 corpus [N, D] and bf16 queries
// [B, D] (or both float32) it writes
//
//     scores_t[r, q] = <corpus[r], queries[q]> in f32 (-inf for r >= n_valid)
//     wmax_t[w, q]   = max over r in [w * W, (w + 1) * W) of scores_t[r, q]
//
// in the TPU's transposed layout: corpus rows lead. The selection that
// follows (top windows, gather of their members, top-k) is torch ops in the
// wrapper (lean_explore_tpu_torch/ops/windowed.py), as the TPU version runs
// it outside `pallas_call`. The query batch is not padded to a multiple of
// 8 as on the TPU: ragged query blocks are masked here.
//
// Design. Both element types run one kernel template, ring_windowed_kernel,
// over the ring-fed wgmma block of ring_tiles.cuh on a persistent grid (one
// block an SM) over 128-row corpus tiles x 128-query blocks, the query
// block fastest: two consumer warpgroups of 64 rows and a producer warp
// whose TMA ring runs on into the next tile while the warpgroups store the
// last. bf16: four m64n128k16 wgmma a stage, both operands by descriptor,
// a 4-stage ring of 32 KB stages; f32: 3xTF32 m64n128k8, each corpus value
// split once in registers (each k8 slice just before its products, which
// measured faster here than splitting the stage first) and the queries
// once a launch, a 3-stage ring of 48 KB stages. Each warpgroup stages its
// masked 64 x 128 tile in its own shared memory, row-major with padded
// rows, writes the rows to scores_t from there, 16 bytes a store where
// B % 4 == 0 (else 4), takes each window's max from it and writes wmax_t.
//
// Bound at the serving shape (N = 300,032, D = 1024, B = 128, W = 8), by
// bytes for both types: bf16 reads a 614 MB corpus and writes 153.6 MB of
// scores and 19.2 MB of window maxima, 787.5 MB or 0.2351 ms at 3.35 TB/s,
// against 78.6 GFLOP, 0.080 ms at 989 TFLOP/s; f32 reads a 1.229 GB corpus
// and writes the same 172.8 MB, 0.4186 ms, against 0.16 ms at the 495
// TFLOP/s TF32 rate (the three products, 236 GFLOP, 0.48 ms at that rate,
// are the floor of a 3xTF32 design). Measured on an NVIDIA H100 80GB HBM3
// at 700 W (PERF.md): bf16 0.268-0.271 ms, 1.14x its bound (2.9 TB/s),
// against 0.51 ms for the mma.sync kernel with cp.async that it replaced;
// without its stores it takes 0.20 ms (the corpus at 3.05 TB/s), with
// 4-byte stores 3% longer. A TMA tile store of the scores from swizzled
// panels ran 0.45% faster in bf16 and 2.4% slower in f32, and is not
// kept. f32 0.65-0.88 ms, against 1.65-1.90 ms for the mma.sync kernel
// before it. Both give the bits of the mma.sync kernels before them.

#include <math_constants.h>

#include "ring_tiles.cuh"

namespace tiles {
namespace {  // the header's internal namespace, reopened

constexpr int WINDOW_STAGES = 3;           // ring stages of the f32 kernel (144 KB)
constexpr int BF16_WINDOW_STAGES = 4;      // ring stages of the bf16 kernel (128 KB)
constexpr int SCORE_LD = RING_QUERIES + 8;  // f32 row stride of a staged score tile
constexpr int SCORE_TILES = RING_GROUPS * 64 * SCORE_LD * (int)sizeof(float);  // both groups'

// Writes a warpgroup's 64 x 128 scores (rows r0 .., queries q0 ..) to
// scores_t, -inf on pad rows, through its staged tile (row-major, rows
// SCORE_LD floats apart, in the shared memory after the ring), and their
// window maxima to wmax_t; columns < B only. The rows leave 16 bytes a
// store where B % 4 == 0, else 4. Named barrier 1 + wg syncs the group.
__device__ __forceinline__ void store_scores(const float (&acc)[RING_ACC], uint8_t* after,
                                             float* __restrict__ scores_t,
                                             float* __restrict__ wmax_t, long long r0, int q0,
                                             int B, int n_valid, int window, int warp, int lane) {
  float* tile = reinterpret_cast<float*>(after) + (warp >> 2) * 64 * SCORE_LD;
#pragma unroll
  for (int i = 0; i < RING_ACC; i += 2) {
    const int m = acc_row(warp, lane, i);
    const bool valid = r0 + m < n_valid;
    *reinterpret_cast<float2*>(tile + m * SCORE_LD + acc_col(lane, i)) =
        valid ? make_float2(acc[i], acc[i + 1]) : make_float2(-CUDART_INF_F, -CUDART_INF_F);
  }
  const int group_barrier = 1 + (warp >> 2);
  asm volatile("bar.sync %0, 128;\n" ::"r"(group_barrier) : "memory");
  const int tw = (warp & 3) * 32 + lane;
  const int n_cols = min(RING_QUERIES, B - q0);
  float* rows = scores_t + r0 * B + q0;
  if ((B & 3) == 0) {
    for (int i = tw; i < 64 * RING_QUERIES / 4; i += 128) {
      const int m = i / (RING_QUERIES / 4);
      const int n = (i % (RING_QUERIES / 4)) * 4;
      if (n < n_cols) {
        *reinterpret_cast<float4*>(rows + (long long)m * B + n) =
            *reinterpret_cast<const float4*>(tile + m * SCORE_LD + n);
      }
    }
  } else {
    for (int i = tw; i < 64 * RING_QUERIES; i += 128) {
      const int m = i / RING_QUERIES;
      const int n = i % RING_QUERIES;
      if (n < n_cols) rows[(long long)m * B + n] = tile[m * SCORE_LD + n];
    }
  }
  const long long w0 = r0 / window;
  for (int i = tw; i < (64 / window) * RING_QUERIES; i += 128) {
    const int w = i / RING_QUERIES;
    const int n = i % RING_QUERIES;
    if (n >= n_cols) continue;
    const float* col = tile + w * window * SCORE_LD + n;
    float m = col[0];
    for (int j = 1; j < window; ++j) m = fmaxf(m, col[j * SCORE_LD]);
    wmax_t[(w0 + w) * B + q0 + n] = m;
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(group_barrier) : "memory");
}

// scores_t and wmax_t over the ring of Stage (Bf16Stage, or Tf32Stage over
// the query halves of q_hi_map and q_lo_map; a bf16 launch's q_lo_map is
// unused). A persistent grid: block b takes tiles b, b + gridDim.x, ... of
// the (N / 128 rounded up) x q_blocks tiles, the query block fastest.
// Warpgroup wg of a tile owns its corpus rows r0 = row0 + 64 wg .. + 64 for
// queries q0 .. + 128; a warpgroup whose rows lie past N (the half tile
// when N / 64 is odd) multiplies zeros from the TMA and stores nothing.
template <class Stage>
__global__ void __launch_bounds__(RING_THREADS, 1)
ring_windowed_kernel(const __grid_constant__ CUtensorMap corpus_map,
                     const __grid_constant__ CUtensorMap query_map,
                     const __grid_constant__ CUtensorMap q_lo_map,
                     float* __restrict__ scores_t,  // [N, B]
                     float* __restrict__ wmax_t,    // [N / window, B]
                     int B, int N, int k_steps, int n_valid, int window, int q_blocks,
                     int n_tiles, int n_stages) {
  extern __shared__ __align__(128) uint8_t smem[];
  const typename Stage::Ring ring(smem, n_stages);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  ring.init(tid);
  __syncthreads();

  RingSlot at;
  if (warp == RING_CONSUMER_WARPS) {
    if (lane == 0) {
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int row0 = (tile / q_blocks) * RING_ROWS;
        const int q0 = (tile % q_blocks) * RING_QUERIES;
        for (int k = 0; k < k_steps; ++k) {
          ring_fill(ring, at, &corpus_map, &query_map, &q_lo_map, k * STAGE_BYTES, row0, q0);
        }
      }
      ring_drain(ring, at);
    }
    return;
  }

  float acc[RING_ACC];
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    zero_acc(acc);
    for (int k = 0; k < k_steps; ++k) Stage::step(acc, ring, at, warp, lane);
    const long long r0 = (long long)(tile / q_blocks) * RING_ROWS + (warp >> 2) * 64;
    if (r0 < N) {
      store_scores(acc, ring.after(), scores_t, wmax_t, r0, (tile % q_blocks) * RING_QUERIES, B,
                   n_valid, window, warp, lane);
    }
  }
}

// Launches ring_windowed_kernel<Stage> on an n-stage ring and a persistent
// grid of min(tiles, SMs) blocks; its dynamic shared memory is the ring,
// then the two warpgroups' staged tiles. Returns the first CUDA error.
template <class Stage>
int launch_ring_windowed(const RingMaps& maps, void* scores_t, void* wmax_t, int B, int N,
                         int D, int n_valid, int window, int n_stages, cudaStream_t s) {
  const int smem = Stage::Ring::smem_bytes(n_stages, SCORE_TILES);
  cudaError_t err = cudaFuncSetAttribute(ring_windowed_kernel<Stage>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_blocks = (B + RING_QUERIES - 1) / RING_QUERIES;
  const int n_tiles = (N + RING_ROWS - 1) / RING_ROWS * q_blocks;
  ring_windowed_kernel<Stage><<<n_tiles < sms ? n_tiles : sms, RING_THREADS, smem, s>>>(
      maps.corpus, maps.queries, maps.q_lo, static_cast<float*>(scores_t),
      static_cast<float*>(wmax_t), B, N, D * Stage::ELEMENT_BYTES / STAGE_BYTES, n_valid,
      window, q_blocks, n_tiles, n_stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace tiles

extern "C" {

// Writes scores_t [N, B] and wmax_t [N / window, B] (f32) for bf16 inputs.
// Requires N % 64 == 0, D % 64 == 0, 64 % window == 0 and 16-byte aligned
// inputs and outputs (the wrapper checks). Returns the first CUDA error of
// the launch (cudaErrorInvalidValue for a tensor map that cannot be made).
int windowed_scores(const void* q, const void* corpus, void* scores_t, void* wmax_t, int B,
                    int N, int D, int n_valid, int window, void* stream) {
  tiles::RingMaps maps = {};
  if (!tiles::one_box_maps(q, corpus, B, N, D * 2, maps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return tiles::launch_ring_windowed<tiles::Bf16Stage>(maps, scores_t, wmax_t, B, N, D, n_valid,
                                                       window, tiles::BF16_WINDOW_STAGES,
                                                       static_cast<cudaStream_t>(stream));
}

// The same for float32 inputs (3xTF32 on wgmma, each k8 slice of a stage
// split just before its products), with `q_split` scratch of 2 * B * D
// floats for the queries' tf32 halves, split first. Requires D % 32 == 0.
int windowed_scores_f32(const void* q, void* q_split, const void* corpus, void* scores_t,
                        void* wmax_t, int B, int N, int D, int n_valid, int window,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  tiles::RingMaps maps;
  const int split = tiles::tf32_prologue(q, q_split, corpus, B, N, D, maps, s);
  if (split != 0) return split;
  return tiles::launch_ring_windowed<tiles::Tf32Stage<true>>(
      maps, scores_t, wmax_t, B, N, D, n_valid, window, tiles::WINDOW_STAGES, s);
}

}  // extern "C"
