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
// Design (bf16): one block per 64-row corpus tile and 64-query block, the
// query block fastest in the grid so that neighbouring blocks read the same
// corpus tile and the second read hits L2. The product is the mma.sync
// tiling of mma_tiles.cuh over the whole depth. The 64 x 64 accumulator
// tile then goes through shared memory (reusing the stage buffers), where
// pad rows are masked, so that the score rows are written coalesced and
// each window's max is taken from shared memory before the one write of
// wmax_t.
//
// Bound at the serving shape (N = 300,032, D = 1024, B = 128, W = 8): the
// corpus read is 614 MB, the scores written 153.6 MB and the window maxima
// 19.2 MB, about 787 MB or 0.235 ms at 3.35 TB/s; the arithmetic is
// 78.6 GFLOP, 0.080 ms at 989 TFLOP/s bf16. The kernel is bound by bytes.
//
// A float32 corpus takes `windowed_scores_tf32_kernel` below, on the 3xTF32
// wgmma mainloop of tf32_tiles.cuh: a persistent grid (one block an SM) of
// two warpgroups over 128-row corpus tiles x 128-query blocks, the query
// block fastest, fed by a 3-stage TMA ring that runs on into the next tile
// while the warpgroups store the last; each corpus value is split once, in
// registers (each k8 slice just before its products, which measured faster
// here than splitting the stage first), and the queries once a launch.
// Each warpgroup stages its
// masked 64 x 128 tile in its own shared memory, writes the rows of scores_t
// from there as whole 16-byte pieces and takes each window's max from it.
// It reads a 1.229 GB corpus and writes the same 172.8 MB, about 0.42 ms at
// 3.35 TB/s, bound by bytes (78.6 GFLOP is 0.16 ms at the 495 TFLOP/s TF32
// rate); the three products are 236 GFLOP, 0.48 ms at that rate, the floor
// of a 3xTF32 design. On an H100 SXM at 700 W it takes 0.66-0.68 ms at the
// serving shape, against 1.65-1.80 ms for the mma.sync kernel it replaced,
// with the same bits (PERF.md).

#include <math_constants.h>

#include "tf32_tiles.cuh"

namespace tiles {
namespace {  // the header's internal namespace, reopened

constexpr int TILE_LD = BN + 4;  // f32 row stride of the staged score tile

__global__ void __launch_bounds__(THREADS)
windowed_scores_kernel(const uint8_t* __restrict__ q,       // [B, D] bf16
                       const uint8_t* __restrict__ corpus,  // [N, D] bf16
                       float* __restrict__ scores_t,        // [N, B]
                       float* __restrict__ wmax_t,          // [N / window, B]
                       int B, int row_bytes, int n_valid, int window, int q_blocks) {
  __shared__ __align__(16) uint8_t smem_a[2][STAGE_SMEM];
  __shared__ __align__(16) uint8_t smem_b[2][STAGE_SMEM];
  static_assert(sizeof(float) * BM * TILE_LD <= sizeof(smem_a), "score tile fits");

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp & 1;
  const int warp_n = warp >> 1;
  const long long s0 = (long long)(blockIdx.x / q_blocks) * BM;
  const int q0 = (blockIdx.x % q_blocks) * BN;
  const int k_steps = row_bytes / STAGE_BYTES;
  const uint8_t* rows = corpus + s0 * row_bytes;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  load_stage(smem_a[0], smem_b[0], rows, row_bytes, q, row_bytes, q0, B, 0, tid);
  cp_async_commit();
  for (int t = 0; t < k_steps; ++t) {
    const int buf = t & 1;
    if (t + 1 < k_steps)
      load_stage(smem_a[buf ^ 1], smem_b[buf ^ 1], rows, row_bytes, q, row_bytes, q0, B,
                 (t + 1) * STAGE_BYTES, tid);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    mma_stage<Bf16Product>(acc, smem_a[buf], smem_b[buf], warp_m, warp_n, lane);
    __syncthreads();
  }
  cp_async_wait_all();
  __syncthreads();

  // Stage the masked tile in shared memory.
  float(*tile)[TILE_LD] = reinterpret_cast<float(*)[TILE_LD]>(&smem_a[0][0]);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = frag_row(warp_m, lane, mi, e);
        tile[m][frag_col(warp_n, lane, ni, e)] =
            s0 + m < n_valid ? acc[mi][ni][e] : -CUDART_INF_F;
      }
  __syncthreads();

  const int n_cols = min(BN, B - q0);
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int m = i / BN;
    const int n = i % BN;
    if (n < n_cols) scores_t[(s0 + m) * B + q0 + n] = tile[m][n];
  }
  const int windows = BM / window;
  const long long w0 = s0 / window;
  for (int i = tid; i < windows * BN; i += THREADS) {
    const int w = i / BN;
    const int n = i % BN;
    if (n >= n_cols) continue;
    float m = tile[w * window][n];
    for (int j = 1; j < window; ++j) m = fmaxf(m, tile[w * window + j][n]);
    wmax_t[(w0 + w) * B + q0 + n] = m;
  }
}

int launch_windowed_scores(const void* q, const void* corpus, void* scores_t, void* wmax_t,
                           int B, int N, int row_bytes, int n_valid, int window,
                           void* stream) {
  const int q_blocks = (B + BN - 1) / BN;
  const long long blocks = (long long)(N / BM) * q_blocks;
  windowed_scores_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(corpus),
      static_cast<float*>(scores_t), static_cast<float*>(wmax_t), B, row_bytes, n_valid,
      window, q_blocks);
  return static_cast<int>(cudaGetLastError());
}

constexpr int WINDOW_STAGES = 3;           // ring stages of the f32 kernel (144 KB)
constexpr int SCORE_LD = TF32_QUERIES + 8;  // f32 row stride of a staged score tile
constexpr int SCORE_TILE = 64 * SCORE_LD * (int)sizeof(float);  // one warpgroup's

// Writes a warpgroup's 64 x 128 scores (rows r0 .., queries q0 ..) to
// scores_t, -inf on pad rows, through its staged tile, and their window
// maxima to wmax_t; columns < B only. Named barrier 1 + wg syncs the group.
__device__ __forceinline__ void store_scores_tf32(const float (&acc)[TF32_ACC], float* tile,
                                                  float* __restrict__ scores_t,
                                                  float* __restrict__ wmax_t, long long r0,
                                                  int q0, int B, int n_valid, int window,
                                                  int warp, int lane) {
#pragma unroll
  for (int i = 0; i < TF32_ACC; i += 2) {
    const int m = tf32_row(warp, lane, i);
    const bool valid = r0 + m < n_valid;
    *reinterpret_cast<float2*>(tile + m * SCORE_LD + tf32_col(lane, i)) =
        valid ? make_float2(acc[i], acc[i + 1]) : make_float2(-CUDART_INF_F, -CUDART_INF_F);
  }
  const int group_barrier = 1 + (warp >> 2);
  asm volatile("bar.sync %0, 128;\n" ::"r"(group_barrier) : "memory");
  const int tw = (warp & 3) * 32 + lane;
  const int n_cols = min(TF32_QUERIES, B - q0);
  float* rows = scores_t + r0 * B + q0;
  if ((B & 3) == 0) {
    for (int i = tw; i < 64 * TF32_QUERIES / 4; i += 128) {
      const int m = i / (TF32_QUERIES / 4);
      const int n = (i % (TF32_QUERIES / 4)) * 4;
      if (n < n_cols) {
        *reinterpret_cast<float4*>(rows + (long long)m * B + n) =
            *reinterpret_cast<const float4*>(tile + m * SCORE_LD + n);
      }
    }
  } else {
    for (int i = tw; i < 64 * TF32_QUERIES; i += 128) {
      const int m = i / TF32_QUERIES;
      const int n = i % TF32_QUERIES;
      if (n < n_cols) rows[(long long)m * B + n] = tile[m * SCORE_LD + n];
    }
  }
  const long long w0 = r0 / window;
  for (int i = tw; i < (64 / window) * TF32_QUERIES; i += 128) {
    const int w = i / TF32_QUERIES;
    const int n = i % TF32_QUERIES;
    if (n >= n_cols) continue;
    const float* col = tile + w * window * SCORE_LD + n;
    float m = col[0];
    for (int j = 1; j < window; ++j) m = fmaxf(m, col[j * SCORE_LD]);
    wmax_t[(w0 + w) * B + q0 + n] = m;
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(group_barrier) : "memory");
}

// scores_t and wmax_t of a float32 corpus. A persistent grid: block b takes
// tiles b, b + gridDim.x, ... of the (N / 128 rounded up) x q_blocks tiles,
// the query block fastest. Warpgroup wg of a tile owns its corpus rows
// r0 = row0 + 64 wg .. + 64 for queries q0 .. + 128; a warpgroup whose rows
// lie past N (the half tile when N / 64 is odd) multiplies zeros from the
// TMA and stores nothing.
__global__ void __launch_bounds__(TF32_THREADS, 1)
windowed_scores_tf32_kernel(const __grid_constant__ CUtensorMap corpus_map,
                            const __grid_constant__ CUtensorMap q_hi_map,
                            const __grid_constant__ CUtensorMap q_lo_map,
                            float* __restrict__ scores_t,  // [N, B]
                            float* __restrict__ wmax_t,    // [N / window, B]
                            int B, int N, int k_steps, int n_valid, int window, int q_blocks,
                            int n_tiles, int n_stages) {
  extern __shared__ __align__(128) uint8_t smem[];
  const Tf32Ring ring(smem, n_stages);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  ring.init(tid);
  __syncthreads();

  RingSlot at;
  if (warp == TF32_CONSUMER_WARPS) {
    if (lane == 0) {
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int row0 = (tile / q_blocks) * TF32_ROWS;
        const int q0 = (tile % q_blocks) * TF32_QUERIES;
        for (int k = 0; k < k_steps; ++k) {
          tf32_fill(ring, at, &corpus_map, &q_hi_map, &q_lo_map, k * STAGE_BYTES, row0, q0);
        }
      }
      tf32_drain(ring, at);
    }
    return;
  }

  float* staged = reinterpret_cast<float*>(ring.after()) + (warp >> 2) * (SCORE_TILE / 4);
  float acc[TF32_ACC];
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    zero_tf32(acc);
    for (int k = 0; k < k_steps; ++k) tf32_stage<true>(acc, ring, at, warp, lane);
    const long long r0 = (long long)(tile / q_blocks) * TF32_ROWS + (warp >> 2) * 64;
    if (r0 < N) {
      store_scores_tf32(acc, staged, scores_t, wmax_t, r0, (tile % q_blocks) * TF32_QUERIES, B,
                        n_valid, window, warp, lane);
    }
  }
}

// Splits the queries into `q_split` [2, B, D], then launches the f32
// kernel on min(tiles, SMs) blocks. Returns the first CUDA error.
int launch_windowed_scores_tf32(const void* q, void* q_split, const void* corpus,
                                void* scores_t, void* wmax_t, int B, int N, int D,
                                int n_valid, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = tf32_smem_bytes(WINDOW_STAGES, 2 * SCORE_TILE);
  const cudaError_t attr =
      cudaFuncSetAttribute(windowed_scores_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Tf32Maps maps;
  const int split = tf32_prologue(q, q_split, corpus, B, N, D, maps, s);
  if (split != 0) return split;
  const int q_blocks = (B + TF32_QUERIES - 1) / TF32_QUERIES;
  const int n_tiles = (N + TF32_ROWS - 1) / TF32_ROWS * q_blocks;
  windowed_scores_tf32_kernel<<<n_tiles < sms ? n_tiles : sms, TF32_THREADS, smem, s>>>(
      maps.corpus, maps.q_hi, maps.q_lo, static_cast<float*>(scores_t),
      static_cast<float*>(wmax_t), B, N, D * 4 / STAGE_BYTES, n_valid, window, q_blocks,
      n_tiles, WINDOW_STAGES);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace tiles

extern "C" {

// Writes scores_t [N, B] and wmax_t [N / window, B] (f32) for bf16 inputs.
// Requires N % 64 == 0, D % 64 == 0 and 64 % window == 0 (the wrapper
// checks). Returns cudaGetLastError() after the launch.
int windowed_scores(const void* q, const void* corpus, void* scores_t, void* wmax_t, int B,
                    int N, int D, int n_valid, int window, void* stream) {
  return tiles::launch_windowed_scores(
      q, corpus, scores_t, wmax_t, B, N, D * 2, n_valid, window, stream);
}

// The same for float32 inputs (3xTF32 on wgmma), with `q_split` scratch of
// 2 * B * D floats for the queries' tf32 halves. Requires D % 32 == 0 and
// a 16-byte aligned corpus.
int windowed_scores_f32(const void* q, void* q_split, const void* corpus, void* scores_t,
                        void* wmax_t, int B, int N, int D, int n_valid, int window,
                        void* stream) {
  return tiles::launch_windowed_scores_tf32(q, q_split, corpus, scores_t, wmax_t, B, N, D,
                                            n_valid, window, stream);
}

}  // extern "C"
