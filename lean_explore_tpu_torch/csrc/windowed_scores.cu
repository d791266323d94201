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
// Design: one block per 64-row corpus tile and 64-query block, the query
// block fastest in the grid so that neighbouring blocks read the same
// corpus tile and the second read hits L2. The product is the mma.sync
// tiling of mma_tiles.cuh over the whole depth: bf16, or for a float32
// corpus the 3xTF32 product (F32Product, the TPU's f32 at HIGHEST
// precision), whose 128-byte stages hold 32 f32 values. The 64 x 64
// accumulator tile then goes through shared memory (reusing the stage
// buffers), where pad rows are masked, so that the score rows are written
// coalesced and each window's max is taken from shared memory before the
// one write of wmax_t.
//
// Bound at the serving shape (N = 300,032, D = 1024, B = 128, W = 8): the
// corpus read is 614 MB, the scores written 153.6 MB and the window maxima
// 19.2 MB, about 787 MB or 0.235 ms at 3.35 TB/s; the arithmetic is
// 78.6 GFLOP, 0.080 ms at 989 TFLOP/s bf16. The kernel is bound by bytes.
// The f32 version reads a 1.229 GB corpus and writes the same 172.8 MB,
// about 0.42 ms, bound by bytes (78.6 GFLOP is 0.16 ms at the 495 TFLOP/s
// TF32 rate); its three tf32 products take 0.48 ms of tensor time.

#include <math_constants.h>

#include "mma_tiles.cuh"

namespace tiles {
namespace {  // the header's internal namespace, reopened

constexpr int TILE_LD = BN + 4;  // f32 row stride of the staged score tile

template <class P>
__global__ void __launch_bounds__(THREADS)
windowed_scores_kernel(const uint8_t* __restrict__ q,       // [B, D] bf16 or f32
                       const uint8_t* __restrict__ corpus,  // [N, D], q's dtype
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
    mma_stage<P>(acc, smem_a[buf], smem_b[buf], warp_m, warp_n, lane);
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

template <class P>
int launch_windowed_scores(const void* q, const void* corpus, void* scores_t, void* wmax_t,
                           int B, int N, int row_bytes, int n_valid, int window,
                           void* stream) {
  const int q_blocks = (B + BN - 1) / BN;
  const long long blocks = (long long)(N / BM) * q_blocks;
  windowed_scores_kernel<P><<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(corpus),
      static_cast<float*>(scores_t), static_cast<float*>(wmax_t), B, row_bytes, n_valid,
      window, q_blocks);
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
  return tiles::launch_windowed_scores<tiles::Bf16Product>(
      q, corpus, scores_t, wmax_t, B, N, D * 2, n_valid, window, stream);
}

// The same for float32 inputs (3xTF32). Requires D % 32 == 0.
int windowed_scores_f32(const void* q, const void* corpus, void* scores_t, void* wmax_t,
                        int B, int N, int D, int n_valid, int window, void* stream) {
  return tiles::launch_windowed_scores<tiles::F32Product>(
      q, corpus, scores_t, wmax_t, B, N, D * 4, n_valid, window, stream);
}

}  // extern "C"
