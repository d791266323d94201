// Causal GQA flash attention with segment ids (forward), for Hopper.
//
// Replaces the TPU kernel that `_attention_flash`
// (lean_explore_tpu/models/qwen3.py:201) reaches: JAX's Pallas TPU
// `flash_attention` (forward `pl.pallas_call` at :758 of
// jax/experimental/pallas/ops/tpu/flash_attention.py in JAX 0.9.0, body
// `_flash_attention_kernel_single_batch` :342). On the port's layout,
// q [B, T, NQ, DH], k and v [B, T, NKV, DH], all bf16 and contiguous, and
// segment ids seg [B, T] int32 (the 0/1 attention mask: pad 0, valid 1), it
// writes out [B, T, NQ * DH] bf16 (or all float32, below) with
//
//     out[b, i, h] = sum_j p_ij v[b, j, h / (NQ / NKV)] / sum_j p_ij,
//     p_ij = exp(s_ij - max_j s_ij) over the keys j <= i with
//            seg[b, j] == seg[b, i], s_ij = sm_scale * <q[b, i, h], k[b, j, h']>
//
// as the TPU kernel computes it: QK^T from bf16 values accumulated in f32,
// the online softmax in f32, each p rounded to bf16 before the PV product
// (f32 accumulation), the output rounded to bf16. Masked scores take the
// finite value -0.7 * FLT_MAX, the TPU kernel's mask value, so no -inf
// arithmetic can make a NaN. The diagonal j = i always lies in the query's
// own segment, so every row, pad rows included, has a key and a finite,
// deterministic output; only valid rows are compared with JAX, whose pad
// rows are unspecified. GQA indexes kv head h / (NQ / NKV), the same
// function as the TPU path's `jnp.repeat` of k and v, without the copy.
//
// Design. Both kernels run one block per (128-query block, q head, batch
// row), the latest query blocks (the most keys) first over the whole grid,
// so that the last blocks to run are the shortest. The block's queries stay
// in shared memory while the key tiles up to its last query stream past,
// so each K/V tile read from L2 serves 128 queries; a warp's scores go
// through an online softmax in f32 registers (running max and per-thread
// running sum, log2(e) folded into the scale, exp2 by ex2.approx.ftz, one
// division by the row sum at the end) and P feeds O += P V straight from
// the score accumulators. T % 128 == 64 leaves the last block's upper
// warps without rows (they only copy).
//
// - bf16 (`flash_attention_kernel`): 4 warps of 32 queries (two m16 tiles
//   that share every K and V fragment, which halves the ldmatrix reads per
//   product against 16-row warps), two blocks an SM. 32-key tiles of K, V
//   and their segment ids stream through a ring of three stages by
//   cp.async, two tiles in flight while one is computed, one barrier a
//   tile. Products on mma.sync m16n8k16 bf16 -> f32 with flash_tiles.cuh's
//   rows_x_rows_m (S = Q K^T, 32 x 32 a warp) and acc_x_tile_m (P rounded
//   to bf16 as the A operand, V^T by ldmatrix.trans), the backward's
//   rows_x_rows and acc_x_tile being their one-tile cases; rows padded by
//   16 bytes, so ldmatrix is free of bank conflicts. Shared memory 85 KB at
//   DH 128 (45 KB at DH 64); 255 registers at DH 128, no spill.
// - float32 (`flash_attention_f32_kernel`, the trunk's f32 parity setting;
//   the TPU kernel runs f32 too): 8 warps of 16 queries, one block an SM.
//   3xTF32 products on mma.sync m16n8k8 (F32Product of mma_tiles.cuh,
//   within about 3 * 2^-22 of f32 per product), p kept in f32 as the TPU
//   kernel keeps it (`p.astype(v.dtype)`). The f32 backward's dq staging
//   (flash_tiles.cuh): Q raw in an unpadded XOR-swizzled tile, K and V as
//   32-row tiles copied into raw buffers and split once into tf32 hi and lo
//   tiles by the thread that copied each chunk; S = Q K^T by
//   rows_x_rows_f32 (16 x 32 a warp), O += P V by acc_x_tile_f32, whose
//   permuted k index takes P from the accumulators with no shuffle and
//   whose B values are 16-byte loads, and store_rows_f32 undoes its
//   permuted columns. Shared memory 161 KB at DH 128 (81 KB at DH 64).
//
// Segment ids are staged per key tile beside K and V, so shared memory does
// not grow with T. A warp skips a key tile in which the mask allows no
// (query, key) pair of its rows: one that starts after its last query
// (causal), or, when its rows share one segment, one whose keys up to its
// last query all lie in other segments (a ballot over the tile's staged
// ids). The skip is exact: a wholly masked tile adds, to a row that has
// not met an allowed key yet, terms that the rescale at that row's first
// allowed key multiplies by exactly 0 (exp2 of the mask value minus a real
// score), and to a row that has, exp2(mask - m) = 0 with its max and sum
// unchanged; every row has its diagonal key, so the first allowed key
// always comes. A padded row is a segment of its own, so the warps of a
// row's padding skip every key tile of its valid part: on the trunk's
// right-padded batches the rule removes 23-25% of the causal tiles at
// 64 x 512 with 301-511 valid tokens a row, and 9-14% at 32 x 256 with
// 201-250 (scripts/measure_mma_tf32_rate.py --count-only).
//
// With an lse pointer (the `_lse` entries, for the backward), each kernel
// also writes the row log-sum-exp of the scaled, masked scores in natural
// log, lse = (m + log2 l) ln 2 from its log2-domain running max and sum,
// to lse [B, NQ, T] f32: JAX's saved residuals l and m (`save_residuals`,
// flash_attention.py:234-251) folded into one. It is a template flag, so
// the output with lse is the output without it, bit for bit.
//
// Bound at the serving shape (B = 64, T = 512, NQ 16, NKV 8, DH 128): q, k,
// v and out are 134.2 + 67.1 + 67.1 + 134.2 MB in bf16, 0.120 ms at
// 3.35 TB/s (0.240 ms in f32); the causal products are about 68.7 GFLOP,
// 0.069 ms at 989 TFLOP/s bf16 (0.139 ms at 495 TF32, counted once). Both
// are bound by bytes. mma.sync is the floor that binds first: with every
// row full the f32 kernel issues about 107 M HMMA.1688 over whole 16 x 32
// warp tiles at this shape, the bf16 kernel about 18 M HMMA.16816 over
// 32 x 32 ones, and the card issues about 1.19 G of either a second an SM
// (scripts/measure_mma_tf32_rate.py counts them for the chip check's and
// the trunk's masks and measures the rates). No one part holds the bf16
// kernel: leaving out its K/V copies, its softmax, its PV or its QK saves
// 3%, 6%, 13% or 17% of its time (scripts/time_flash_forward_variants.py),
// 39% together; the rest is what every tile keeps (the ring's wait and
// barrier, the skip ballot, the chain from ldmatrix through both products)
// with 2 warps a scheduler, at the register cap, to hide its latency.
// wgmma, whose products run asynchronously beside the softmax (its TF32
// form wants V K-major in shared memory), is the route past both kernels'
// mma.sync.

#include "flash_tiles.cuh"

namespace tiles {
namespace {  // the header's internal namespace, reopened

constexpr int BF16_MT = 2;                     // 16-row tiles of a bf16 warp's queries
constexpr int BF16_WARP_ROWS = 16 * BF16_MT;
constexpr int BF16_WARPS = F32_ROWS / BF16_WARP_ROWS;  // 4 warps hold a block's 128 queries
constexpr int BF16_THREADS = 32 * BF16_WARPS;
constexpr int BF16_KEYS = 32;                  // keys of a streamed tile
constexpr int BF16_STAGES = 3;                 // key tiles in the ring

// 2^x by the SFU alone (ex2.approx.ftz): subnormal results flush to 0,
// which exp2f's extra instructions would keep.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory of a bf16 forward block: the Q tile of F32_ROWS padded
// rows, then BF16_STAGES stages of a K tile, a V tile (BF16_KEYS padded
// rows each) and the keys' segment ids: 85 KB at DH 128, so two blocks
// share an SM.
template <int DH>
struct Bf16FwdShape {
  static constexpr int ROW = FlashShape<DH, 2>::ROW;
  static constexpr int TILE = BF16_KEYS * ROW;
  static constexpr int RING = F32_ROWS * ROW;  // the Q tile; the ring starts after it
  static constexpr int STAGE = 2 * TILE + BF16_KEYS * 4;
  static constexpr int BYTES = RING + BF16_STAGES * STAGE;
  // An SM has 228 KB of shared memory, less 1 KB reserved for each block.
  static_assert(2 * (BYTES + 1024) <= 233472, "two bf16 forward blocks exceed an SM");
};

// The block's place in launch_kernel's grid: its 128-query block qb, the
// latest (with the most keys) first over the whole grid, so that the last
// blocks to run are the shortest; its q head h and its batch row b.
__device__ __forceinline__ void block_place(int& qb, int& h, int& b) {
  qb = gridDim.z - 1 - blockIdx.z;
  h = blockIdx.x;
  b = blockIdx.y;
}

// One key tile of the online softmax for this thread's two rows (row_lo,
// row_lo + 8) of a warp's 16 x 8NT score fragment (s[j][e]: column
// k0 + 8j + 2t + (e & 1)): scale s into the log2 domain and mask it (key <=
// query and the same segment; kseg holds the tile's segment ids), update
// the running max (quad-reduced) and rescale the running sums and the
// output accumulators, then leave p = exp2(s - m) in f32 in s and add it to
// the running sums (per thread; quad-reduced once at the end).
template <int NT, int OTILES>
__device__ __forceinline__ void online_softmax(float (&s)[NT][4], float (&o)[OTILES][4],
                                               float (&m_run)[2], float (&l_run)[2],
                                               const int* kseg, const int (&qseg)[2], int k0,
                                               int row_lo, int lane, float scale_log2) {
  const int t = lane & 3;
  float mx[2] = {FA_MASK, FA_MASK};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int2 ks = *reinterpret_cast<const int2*>(kseg + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const int key = k0 + 8 * j + 2 * t + (e & 1);
      const bool ok = key <= row_lo + r * 8 && ((e & 1) ? ks.y : ks.x) == qseg[r];
      s[j][e] = ok ? s[j][e] * scale_log2 : FA_MASK;
      mx[r] = fmaxf(mx[r], s[j][e]);
    }
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r]);
    alpha[r] = exp2_ftz(m_run[r] - m_new);
    m_run[r] = m_new;
    l_run[r] *= alpha[r];
  }
#pragma unroll
  for (int n = 0; n < OTILES; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = exp2_ftz(s[j][e] - m_run[e >> 1]);
    }
    l_run[0] += s[j][0] + s[j][1];
    l_run[1] += s[j][2] + s[j][3];
  }
}

// The row sums of a row are spread over its quad; the full sums, then the
// row log-sum-exp (when lse is not null) and the rows scaled by 1 / sum.
template <int OTILES>
__device__ __forceinline__ void finish_rows(float (&o)[OTILES][4], const float (&m_run)[2],
                                            float (&l_run)[2], float* lse, long long bh,
                                            int T, int row_lo, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  // lse = (m + log2 l) ln 2 in natural-log units, lse[b, h, row], by one
  // lane of each quad.
  if (lse != nullptr && (lane & 3) == 0) {
    lse[bh * T + row_lo] = (m_run[0] + log2f(l_run[0])) * LN2;
    lse[bh * T + row_lo + 8] = (m_run[1] + log2f(l_run[1])) * LN2;
  }
  const float inv[2] = {1.0f / l_run[0], 1.0f / l_run[1]};
#pragma unroll
  for (int n = 0; n < OTILES; ++n) {
    o[n][0] *= inv[0];
    o[n][1] *= inv[0];
    o[n][2] *= inv[1];
    o[n][3] *= inv[1];
  }
}

template <int DH, bool LSE>
__global__ void __launch_bounds__(BF16_THREADS, 2)
flash_attention_kernel(const uint8_t* __restrict__ q,    // [B, T, NQ, DH] bf16
                       const uint8_t* __restrict__ k,    // [B, T, NKV, DH] bf16
                       const uint8_t* __restrict__ v,    // [B, T, NKV, DH] bf16
                       const int* __restrict__ seg,      // [B, T]
                       uint8_t* __restrict__ out,        // [B, T, NQ, DH] bf16
                       float* __restrict__ lse,          // [B, NQ, T] f32 when LSE
                       int T, int NQ, int NKV, float scale_log2) {
  using S = Bf16FwdShape<DH>;
  constexpr int MT = BF16_MT;
  extern __shared__ __align__(16) uint8_t smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int qb, h, b;
  block_place(qb, h, b);
  const int hk = h / (NQ / NKV);
  const int q0 = qb * F32_ROWS;
  const int qw = q0 + warp * BF16_WARP_ROWS;  // this warp's first query; none when qw >= T
  const int n_queries = min(F32_ROWS, T - q0);
  const long long q_stride = (long long)NQ * DH * 2;
  const long long kv_stride = (long long)NKV * DH * 2;
  const long long kv_base = (long long)b * T * kv_stride + (long long)hk * DH * 2;
  const int* sg = seg + (long long)b * T;

  load_tile<DH, 2, S::ROW, F32_ROWS, BF16_THREADS>(
      smem, q + ((long long)b * T + q0) * q_stride + (long long)h * DH * 2, q_stride, tid,
      n_queries);
  // Key tile kt into stage kt % BF16_STAGES: K, V and the keys' segment ids.
  auto load = [&](int kt) {
    uint8_t* stage = smem + S::RING + (kt % BF16_STAGES) * S::STAGE;
    const long long off = kv_base + (long long)kt * BF16_KEYS * kv_stride;
    load_tile<DH, 2, S::ROW, BF16_KEYS, BF16_THREADS>(stage, k + off, kv_stride, tid);
    load_tile<DH, 2, S::ROW, BF16_KEYS, BF16_THREADS>(stage + S::TILE, v + off, kv_stride, tid);
    if (tid < BF16_KEYS) cp_async4(stage + 2 * S::TILE + tid * 4, sg + kt * BF16_KEYS + tid);
  };
  const int n_tiles = (q0 + n_queries) / BF16_KEYS;  // key tiles up to the last query
#pragma unroll
  for (int i = 0; i < BF16_STAGES - 1; ++i) {
    if (i < n_tiles) load(i);
    cp_async_commit();  // Q joins the first group
  }

  // This thread's query rows: row_lo + 16m and row_lo + 16m + 8.
  const int row_lo = qw + (lane >> 2);
  int qseg[MT][2] = {}, s0 = 0;
  bool uniform = false;
  if (qw < T) row_segments(sg, row_lo, qseg, uniform, s0);
  float o[MT][DH / 8][4];
  float m_run[MT][2], l_run[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[m][n][e] = 0.0f;
    m_run[m][0] = m_run[m][1] = FA_MASK;
    l_run[m][0] = l_run[m][1] = 0.0f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    // Tile kt has landed (only the newer of the two groups in flight may
    // pend), and after the barrier no warp reads the stage that the next
    // load refills.
    static_assert(BF16_STAGES == 3, "the wait below keeps BF16_STAGES - 2 groups pending");
    cp_async_wait_one();
    __syncthreads();
    if (kt + BF16_STAGES - 1 < n_tiles) load(kt + BF16_STAGES - 1);
    cp_async_commit();

    const uint8_t* stage = smem + S::RING + (kt % BF16_STAGES) * S::STAGE;
    const int* kseg = reinterpret_cast<const int*>(stage + 2 * S::TILE);
    const int k0 = kt * BF16_KEYS;
    if (qw >= T || !takes_tile<BF16_KEYS, BF16_WARP_ROWS>(kseg, k0, qw, uniform, s0, lane))
      continue;
    float s[MT][BF16_KEYS / 8][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < BF16_KEYS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[m][j][e] = 0.0f;
    rows_x_rows_m<DH, S::ROW>(s, smem, warp * BF16_WARP_ROWS, stage, lane);  // S = Q K^T
#pragma unroll
    for (int m = 0; m < MT; ++m)
      online_softmax(s[m], o[m], m_run[m], l_run[m], kseg, qseg[m], k0, row_lo + 16 * m, lane,
                     scale_log2);
    // O += P V, p rounded to bf16.
    acc_x_tile_m<DH, S::ROW, MT, BF16_KEYS>(o, s, stage + S::TILE, lane);
  }
  cp_async_wait_all();

  if (qw < T) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      finish_rows(o[m], m_run[m], l_run[m], LSE ? lse : nullptr, (long long)b * NQ + h, T,
                  row_lo + 16 * m, lane);
      store_rows<DH>(out + ((long long)b * T * NQ + h) * DH * 2, (long long)NQ * DH,
                     row_lo + 16 * m, o[m], lane);
    }
  }
}

template <int DH, bool LSE>
__global__ void __launch_bounds__(F32_THREADS, 1)
flash_attention_f32_kernel(const uint8_t* __restrict__ q,  // [B, T, NQ, DH] f32
                           const uint8_t* __restrict__ k,  // [B, T, NKV, DH] f32
                           const uint8_t* __restrict__ v,  // [B, T, NKV, DH] f32
                           const int* __restrict__ seg,    // [B, T]
                           float* __restrict__ out,        // [B, T, NQ, DH] f32
                           float* __restrict__ lse,        // [B, NQ, T] f32 when LSE
                           int T, int NQ, int NKV, float scale_log2) {
  using S = F32Shape<DH, 1>;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint8_t* k_hi = smem + S::SPLIT;
  const uint8_t* k_lo = k_hi + S::STREAM;
  const uint8_t* v_hi = k_lo + S::STREAM;
  const uint8_t* v_lo = v_hi + S::STREAM;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int qb, h, b;
  block_place(qb, h, b);
  const int hk = h / (NQ / NKV);
  const int q0 = qb * F32_ROWS;
  const int qw = q0 + warp * 16;  // this warp's first query; none when qw >= T
  const int n_queries = min(F32_ROWS, T - q0);
  const long long q_stride = (long long)NQ * DH * 4;
  const long long kv_stride = (long long)NKV * DH * 4;
  const long long kv_base = (long long)b * T * kv_stride + (long long)hk * DH * 4;
  const int* sg = seg + (long long)b * T;

  load_rows_f32<DH, F32_ROWS, F32_THREADS>(
      smem, q + ((long long)b * T + q0) * q_stride + (long long)h * DH * 4, q_stride,
      n_queries, tid);
  auto load = [&](int kt) {
    const long long off = kv_base + (long long)kt * STREAM_ROWS * kv_stride;
    load_stream<DH, 1>(smem, k + off, v + off, kv_stride, nullptr, nullptr, 0,
                       sg + kt * STREAM_ROWS, kt & 1, tid);
  };
  load(0);
  cp_async_commit();

  const int row_lo = qw + (lane >> 2);
  int qseg[1][2] = {}, s0 = 0;
  bool uniform = false;
  if (qw < T) row_segments(sg, row_lo, qseg, uniform, s0);
  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m_run[2] = {FA_MASK, FA_MASK};
  float l_run[2] = {0.0f, 0.0f};

  const int n_tiles = (q0 + n_queries) / STREAM_ROWS;  // key tiles up to the last query
  for (int kt = 0; kt < n_tiles; ++kt) {
    split_stream<DH, 1>(smem, tid);
    if (kt + 1 < n_tiles) load(kt + 1);
    cp_async_commit();
    __syncthreads();

    const int* kseg =
        reinterpret_cast<const int*>(smem + S::ROWS) + ((kt & 1) * 3 + 2) * STREAM_ROWS;
    const int k0 = kt * STREAM_ROWS;
    if (qw >= T || !takes_tile<STREAM_ROWS, 16>(kseg, k0, qw, uniform, s0, lane)) continue;
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    rows_x_rows_f32<DH, 4>(s, smem, warp * 16, k_hi, k_lo, lane);  // S = Q K^T
    online_softmax(s, o, m_run, l_run, kseg, qseg[0], k0, row_lo, lane, scale_log2);
    acc_x_tile_f32<DH, STREAM_ROWS>(o, s, v_hi, v_lo, lane);  // O += P V, p in f32
  }
  cp_async_wait_all();

  if (qw < T) {
    finish_rows(o, m_run, l_run, LSE ? lse : nullptr, (long long)b * NQ + h, T, row_lo, lane);
    store_rows_f32<DH>(out + ((long long)b * T * NQ + h) * DH, (long long)NQ * DH, row_lo, o,
                       lane);
  }
}

template <typename Out>
using FlashKernel = void (*)(const uint8_t*, const uint8_t*, const uint8_t*, const int*, Out*,
                             float*, int, int, int, float);

// One launch of a forward kernel over the grid that block_place reads:
// (q head, batch row, 128-query block).
template <typename Out>
int launch_kernel(FlashKernel<Out> kernel, int threads, int smem, const void* q, const void* k,
                  const void* v, const void* seg, void* out, void* lse, int B, int T, int NQ,
                  int NKV, float sm_scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(NQ, B, (T + F32_ROWS - 1) / F32_ROWS);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(k),
      static_cast<const uint8_t*>(v), static_cast<const int*>(seg), static_cast<Out*>(out),
      static_cast<float*>(lse), T, NQ, NKV, sm_scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, int ELEM, bool LSE>
int launch_flash(const void* q, const void* k, const void* v, const void* seg, void* out,
                 void* lse, int B, int T, int NQ, int NKV, float sm_scale, void* stream) {
  if constexpr (ELEM == 2) {
    return launch_kernel<uint8_t>(flash_attention_kernel<DH, LSE>, BF16_THREADS,
                                  Bf16FwdShape<DH>::BYTES, q, k, v, seg, out, lse, B, T, NQ, NKV,
                                  sm_scale, stream);
  } else {
    return launch_kernel<float>(flash_attention_f32_kernel<DH, LSE>, F32_THREADS,
                                F32Shape<DH, 1>::BYTES, q, k, v, seg, out, lse, B, T, NQ, NKV,
                                sm_scale, stream);
  }
}

// Launches the instantiation for DH (64 or 128) and for lse given or null.
template <int ELEM>
int dispatch_flash(const void* q, const void* k, const void* v, const void* seg, void* out,
                   void* lse, int B, int T, int NQ, int NKV, int DH, float sm_scale,
                   void* stream) {
  if (DH != 64 && DH != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (DH == 128)
    return lse ? launch_flash<128, ELEM, true>(q, k, v, seg, out, lse, B, T, NQ, NKV, sm_scale,
                                               stream)
               : launch_flash<128, ELEM, false>(q, k, v, seg, out, lse, B, T, NQ, NKV,
                                                sm_scale, stream);
  return lse ? launch_flash<64, ELEM, true>(q, k, v, seg, out, lse, B, T, NQ, NKV, sm_scale,
                                            stream)
             : launch_flash<64, ELEM, false>(q, k, v, seg, out, lse, B, T, NQ, NKV, sm_scale,
                                             stream);
}

}  // namespace
}  // namespace tiles

extern "C" {

// Writes out [B, T, NQ * DH] bf16 (see the note above). Requires bf16
// contiguous inputs, T % 64 == 0, NQ % NKV == 0 and DH of 64 or 128 (the
// wrapper checks; another DH returns cudaErrorInvalidValue). Returns
// cudaGetLastError() after the launch.
int flash_attention_fwd(const void* q, const void* k, const void* v, const void* seg,
                        void* out, int B, int T, int NQ, int NKV, int DH, float sm_scale,
                        void* stream) {
  return tiles::dispatch_flash<2>(q, k, v, seg, out, nullptr, B, T, NQ, NKV, DH, sm_scale,
                                  stream);
}

// The same over float32 q, k, v, writing float32 out (3xTF32 products).
int flash_attention_fwd_f32(const void* q, const void* k, const void* v, const void* seg,
                            void* out, int B, int T, int NQ, int NKV, int DH, float sm_scale,
                            void* stream) {
  return tiles::dispatch_flash<4>(q, k, v, seg, out, nullptr, B, T, NQ, NKV, DH, sm_scale,
                                  stream);
}

// Both, also writing the row log-sum-exp lse [B, NQ, T] f32 (natural log,
// of the scaled masked scores), the backward's residual. The output and
// its arithmetic are those of the entries above.
int flash_attention_fwd_lse(const void* q, const void* k, const void* v, const void* seg,
                            void* out, void* lse, int B, int T, int NQ, int NKV, int DH,
                            float sm_scale, void* stream) {
  return tiles::dispatch_flash<2>(q, k, v, seg, out, lse, B, T, NQ, NKV, DH, sm_scale, stream);
}

int flash_attention_fwd_f32_lse(const void* q, const void* k, const void* v, const void* seg,
                                void* out, void* lse, int B, int T, int NQ, int NKV, int DH,
                                float sm_scale, void* stream) {
  return tiles::dispatch_flash<4>(q, k, v, seg, out, lse, B, T, NQ, NKV, DH, sm_scale, stream);
}

}  // extern "C"
