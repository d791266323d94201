// Causal GQA flash attention with segment ids (backward: dq and dk/dv), for
// Hopper.
//
// Replaces the two backward TPU kernels of JAX's Pallas TPU
// `flash_attention` (jax/experimental/pallas/ops/tpu/flash_attention.py in
// JAX 0.9.0), which `jax.grad` reaches through `_attention_flash`
// (lean_explore_tpu/models/qwen3.py:201) when a training objective takes
// flash: `_flash_attention_bwd_dkv` (`pl.pallas_call` :1121, body
// `_flash_attention_dkv_kernel` :796) and `_flash_attention_bwd_dq` (:1456,
// body `_flash_attention_dq_kernel` :1146). On the port's layout, q and
// dO [B, T, NQ, DH], k and v [B, T, NKV, DH], segment ids seg [B, T] int32,
// the forward's row log-sum-exp lse [B, NQ, T] f32 (natural log) and
// di = rowsum(dO * O) [B, NQ, T] f32 (computed outside, as JAX does), with
//
//     p_ij  = exp(s_ij - lse_i), s_ij = sm_scale <q_i, k_j> over the keys
//             j <= i of i's segment (0 elsewhere: the mask value -0.7 FLT_MAX
//             takes s_ij, and exp of it is exactly 0),
//     dp_ij = <dO_i, v_j>,  ds_ij = sm_scale p_ij (dp_ij - di_i),
//
// they write dq_i = sum_j ds_ij k_j ([B, T, NQ, DH]) and, per kv head,
// dk_j = sum_{h in group} sum_i ds_ij q_i and dv_j = sum_h sum_i p_ij dO_i
// ([B, T, NKV, DH]): the GQA sum over each group of NQ / NKV q heads, which
// JAX takes as the transpose of `jnp.repeat`, is taken in the kernel's
// registers, so nothing is repeated or reduced afterwards. As in the TPU
// kernels, p and ds are rounded to the input type (bf16) before their
// products and every product accumulates in f32. Pad rows carry their own
// segment and the diagonal, so lse is finite on every row and no NaN can
// arise; where dO is 0 (pad rows of a pooled loss) they add nothing.
//
// bf16 design. Four warps of 16 rows over 64-row tiles padded by 16 bytes,
// every product on mma.sync m16n8k16 bf16 -> f32 (rows_x_rows and
// acc_x_tile of flash_tiles.cuh).
//
// - dk/dv: one block per (64-key block, kv head, batch row), the earliest
//   key blocks (the most queries) first. K and V stay in shared memory;
//   the (q head, query block) pairs of its group from the diagonal on
//   stream Q and dO through two buffers by cp.async. Each warp owns 16 keys
//   and computes S^T = K Q^T and P^T from lse (keys as rows, so P^T and
//   dS^T are A operands straight from the accumulators). Two passes keep
//   64 accumulators a thread in flight, not 128: the first accumulates
//   dV += P^T dO and writes dV; the second recomputes S^T, forms
//   dP^T = V dO^T and dS^T, accumulates dK += dS^T Q and writes dK.
// - dq: one block per (64-query block, q head, batch row), the latest
//   query blocks (the most keys) first. Q and dO stay in shared memory; the
//   key blocks up to the diagonal stream K and V through two buffers. Each
//   warp owns 16 queries: S = Q K^T, P, dP = dO V^T, dS, dQ += dS K.
//
// Shared memory: two fixed tiles and two double-buffered ones of
// 64 x (DH * 2 + 16) bytes, 102 KB at DH = 128 (two blocks an SM), plus
// the segment ids. Registers (ptxas, DH = 128): dq 238, dk/dv 250, no spill.
//
// float32 design (3xTF32: each operand split into tf32 hi and lo, every
// product lo*hi + hi*lo + hi*hi on mma.sync m16n8k8, within about 3 * 2^-22
// of f32 per product, as in the forward). The products and their
// operands are the bf16 kernels'; the blocks differ, because four warps
// over 64-row f32 tiles ran one block of 4 warps an SM (198 KB of padded
// tiles), computed S^T twice in dk/dv (5 products a tile pair, where 4 do)
// for want of registers, split every streamed value again in each warp and
// read acc_x_tile's B with 2-way bank conflicts (its pad served ldmatrix
// only).
//
// - Eight warps of 16 rows, one block of 128 keys (dk/dv) or queries (dq)
//   and 8 warps an SM. Q and dO (dk/dv), or K and V (dq), stream as
//   32-row tiles, so a warp's S and dP fragments are 16 registers each and
//   dK and dV fit together: dk/dv runs one pass, S^T once, 4 products a
//   tile pair (dq 3). A warp skips a streamed tile that lies wholly before
//   its first key (dk/dv) or after its last query (dq); T % 128 == 64
//   leaves the last block's warps 4-7 without rows, and they only copy.
// - Tiles are unpadded, with each row's 16-byte chunks XOR-swizzled by the
//   row's place in its 8-row group (flash_tiles.cuh), so that ldmatrix and
//   acc_x_tile_f32's 16-byte B loads are both free of bank conflicts.
// - Each streamed tile is split into tf32 hi and lo tiles once, in shared
//   memory, by the thread that copied each chunk; the products load both
//   halves and split only the fixed rows of the warp (A) and X in
//   registers, hi by an integer add and mask (cvt's result for every
//   finite value, in 2 instructions where cvt takes 4).
// - acc_x_tile_f32 permutes the k index of each 8-deep chunk (X's
//   accumulator registers are then the tf32 A fragment: no shuffles) and
//   the output columns (a lane's B values of 4 n-tiles are one 16-byte
//   load); store_rows_f32 writes the columns back in order.
// - The loop: wait for this thread's copies of the streamed pair, a
//   barrier (no warp still reads the last pair's hi and lo), split them,
//   start the next pair's copy, a barrier, compute. The next copy so
//   overlaps this pair's products; its lse, di and segment ids are staged
//   beside it by 4-byte cp.async.
// - No atomics: every dq, dk and dv element is summed by one thread in a
//   fixed order, so repeated launches give the same bits.
//
// Shared memory (DH = 128): K and V (or Q and dO) 128 KB, the streamed
// pair 32 KB, its hi and lo 64 KB, the staged rows 768 bytes: 225 KB
// whatever T is. Registers (ptxas, DH = 128 / 64): dk/dv 255 / 182, dq
// 187 / 140, no spill; `rows_x_rows_f32` unrolls by 4, since full
// unrolling spilled 80 (dk/dv) and 108 (dq) bytes.
//
// Bound at the training shape (B = 32, T = 256, NQ 16, NKV 8, DH 128, f32):
// each kernel reads q, k, v, dO, lse and di and writes its gradients once,
// about 270 MB, 0.080 ms at 3.35 TB/s; its 3 (dq) or 4 (dk/dv) products
// over the causal pairs are 0.026 and 0.035 ms at 495 TFLOP/s TF32. Both
// are bound by bytes. The f32 kernels are held instead by mma.sync: they
// run 28.3 M (dk/dv) and 21.2 M (dq) HMMA.1688 over whole 16 x 32 warp
// tiles, and scripts/measure_mma_tf32_rate.py, which counts them, measures
// at most about 1.19 G of them a second an SM on an H100 (0.18 and 0.13 ms
// for these counts), where these kernels, 8 warps of 255 (dk/dv) and 187
// (dq) registers, take about 2.9 times that; wgmma is the route past it.
// They reread K/V (dq) and Q/dO (dk/dv) from L2 for every block.

#include "flash_tiles.cuh"

namespace tiles {
namespace {  // the header's internal namespace, reopened

// Scales and masks a warp's 16 x 64 score fragment and turns it into
// probabilities: s[j][e] (row row0 + g + (e >> 1) * 8, column col0 + j * 8
// + 2t + (e & 1)) becomes exp2(s * scale_log2 - lse2) where the key is not
// later than the query and both share a segment, and exactly 0 elsewhere
// (through the mask value). KEY_ROWS says whether the rows are keys (dk/dv)
// or queries (dq); lse2 of the query is lse * log2(e).
template <bool KEY_ROWS>
__device__ __forceinline__ void probabilities(float (&s)[8][4], const int* sseg, int row0,
                                              int col0, const float* lse2_row,
                                              const float* lse2_col, int lane,
                                              float scale_log2) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + (e >> 1) * 8;
      const int col = col0 + j * 8 + 2 * t + (e & 1);
      float lse2;
      bool ok;
      if constexpr (KEY_ROWS) {
        lse2 = lse2_col[j * 2 + (e & 1)];
        ok = row <= col;
      } else {
        lse2 = lse2_row[e >> 1];
        ok = col <= row;
      }
      ok = ok && sseg[row] == sseg[col];
      s[j][e] = exp2f((ok ? s[j][e] * scale_log2 : FA_MASK) - lse2);
    }
}

// ds = sm_scale * p * (dp - di), in place in dp; di of the query (the
// row in dq, the column in dk/dv).
template <bool KEY_ROWS>
__device__ __forceinline__ void score_grads(float (&dp)[8][4], const float (&p)[8][4],
                                            const float* di_row, const float* di_col,
                                            float sm_scale) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float di;
      if constexpr (KEY_ROWS) {
        di = di_col[j * 2 + (e & 1)];
      } else {
        di = di_row[e >> 1];
      }
      dp[j][e] = sm_scale * p[j][e] * (dp[j][e] - di);
    }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.0f;
}

struct BwdArgs {
  const uint8_t* q;     // [B, T, NQ, DH]
  const uint8_t* k;     // [B, T, NKV, DH]
  const uint8_t* v;     // [B, T, NKV, DH]
  const int* seg;       // [B, T]
  const uint8_t* dout;  // [B, T, NQ, DH]
  const float* lse;     // [B, NQ, T]
  const float* di;      // [B, NQ, T]
  uint8_t* dq;          // [B, T, NQ, DH]
  uint8_t* dk;          // [B, T, NKV, DH]
  uint8_t* dv;          // [B, T, NKV, DH]
  int T, NQ, NKV;
  float sm_scale;
};

// One pass of the dk/dv block over its (q head, query block) pairs: DK
// false accumulates dV = sum P^T dO, DK true dK = sum dS^T Q; the result
// is written to rows k0 + warp * 16 .. of dv or dk.
template <int DH, bool DK>
__device__ __forceinline__ void dkv_pass(const BwdArgs& a, uint8_t* smem, int kb, int hk,
                                         int b, bool load_kv) {
  using S = FlashShape<DH, 2>;
  constexpr int ROW = S::ROW;
  uint8_t* sk = smem;
  uint8_t* sv = smem + S::TILE;
  uint8_t* sq = smem + 2 * S::TILE;   // two buffers
  uint8_t* sdo = smem + 4 * S::TILE;  // two buffers
  const int* sseg = reinterpret_cast<const int*>(smem + 6 * S::TILE);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t = lane & 3;
  const int T = a.T;
  const int group = a.NQ / a.NKV;
  const int nqb = T / FA_BLOCK;
  const int k0 = kb * FA_BLOCK;
  const long long q_stride = (long long)a.NQ * DH * 2;
  const long long kv_stride = (long long)a.NKV * DH * 2;
  const float scale_log2 = a.sm_scale * LOG2E;

  // Pairs (h, qb): the group's heads, each over the query blocks kb..nqb-1.
  const int span = nqb - kb;
  const int n_iter = group * span;
  auto load = [&](int it, int buf) {
    const int h = hk * group + it / span;
    const int q0 = (kb + it % span) * FA_BLOCK;
    const long long off = ((long long)b * T + q0) * q_stride + (long long)h * DH * 2;
    load_tile<DH, 2, ROW>(sq + buf * S::TILE, a.q + off, q_stride, tid);
    load_tile<DH, 2, ROW>(sdo + buf * S::TILE, a.dout + off, q_stride, tid);
  };
  if (load_kv) {
    const long long off = ((long long)b * T + k0) * kv_stride + (long long)hk * DH * 2;
    load_tile<DH, 2, ROW>(sk, a.k + off, kv_stride, tid);
    load_tile<DH, 2, ROW>(sv, a.v + off, kv_stride, tid);
  }
  load(0, 0);
  cp_async_commit();

  float acc[DH / 8][4];
  zero(acc);
  for (int it = 0; it < n_iter; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_iter) load(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    const int h = hk * group + it / span;
    const int q0 = (kb + it % span) * FA_BLOCK;
    // lse * log2(e) and di of this thread's 16 query columns.
    const long long row_base = ((long long)b * a.NQ + h) * T + q0 + 2 * t;
    float lse2[16], dis[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        lse2[j * 2 + c] = a.lse[row_base + j * 8 + c] * LOG2E;
        if constexpr (DK) dis[j * 2 + c] = a.di[row_base + j * 8 + c];
      }

    const uint8_t* qt = sq + buf * S::TILE;
    const uint8_t* dot = sdo + buf * S::TILE;
    float p[8][4];
    zero(p);
    rows_x_rows<DH, ROW>(p, sk, warp * 16, qt, lane);  // S^T = K Q^T
    probabilities<true>(p, sseg, k0 + warp * 16, q0, nullptr, lse2, lane, scale_log2);
    if constexpr (DK) {
      float ds[8][4];
      zero(ds);
      rows_x_rows<DH, ROW>(ds, sv, warp * 16, dot, lane);  // dP^T = V dO^T
      score_grads<true>(ds, p, nullptr, dis, a.sm_scale);
      acc_x_tile<DH, ROW>(acc, ds, qt, lane);  // dK += dS^T Q
    } else {
      acc_x_tile<DH, ROW>(acc, p, dot, lane);  // dV += P^T dO
    }
    __syncthreads();
  }
  cp_async_wait_all();

  uint8_t* dst = (DK ? a.dk : a.dv) +
                 (((long long)b * T) * a.NKV + hk) * DH * 2;
  store_rows<DH>(dst, (long long)a.NKV * DH, k0 + warp * 16 + (lane >> 2), acc, lane);
}

template <int DH>
__global__ void __launch_bounds__(FA_THREADS) flash_attention_dkv_kernel(BwdArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  using S = FlashShape<DH, 2>;
  int* sseg = reinterpret_cast<int*>(smem + 6 * S::TILE);
  const int kb = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  for (int i = threadIdx.x; i < a.T; i += FA_THREADS) sseg[i] = a.seg[(long long)b * a.T + i];
  dkv_pass<DH, false>(a, smem, kb, hk, b, true);
  dkv_pass<DH, true>(a, smem, kb, hk, b, false);
}

template <int DH>
__global__ void __launch_bounds__(FA_THREADS) flash_attention_dq_kernel(BwdArgs a) {
  using S = FlashShape<DH, 2>;
  constexpr int ROW = S::ROW;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sq = smem;
  uint8_t* sdo = smem + S::TILE;
  uint8_t* sk = smem + 2 * S::TILE;  // two buffers
  uint8_t* sv = smem + 4 * S::TILE;  // two buffers
  int* sseg = reinterpret_cast<int*>(smem + 6 * S::TILE);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int T = a.T;
  const int hk = h / (a.NQ / a.NKV);
  const int q0 = qb * FA_BLOCK;
  const long long q_stride = (long long)a.NQ * DH * 2;
  const long long kv_stride = (long long)a.NKV * DH * 2;
  const long long q_off = ((long long)b * T + q0) * q_stride + (long long)h * DH * 2;
  const long long kv_base = (long long)b * T * kv_stride + (long long)hk * DH * 2;
  const float scale_log2 = a.sm_scale * LOG2E;

  for (int i = tid; i < T; i += FA_THREADS) sseg[i] = a.seg[(long long)b * T + i];
  load_tile<DH, 2, ROW>(sq, a.q + q_off, q_stride, tid);
  load_tile<DH, 2, ROW>(sdo, a.dout + q_off, q_stride, tid);
  load_tile<DH, 2, ROW>(sk, a.k + kv_base, kv_stride, tid);
  load_tile<DH, 2, ROW>(sv, a.v + kv_base, kv_stride, tid);
  cp_async_commit();

  // This thread's two query rows, row_lo and row_lo + 8.
  const int row_lo = q0 + warp * 16 + (lane >> 2);
  const long long bh = ((long long)b * a.NQ + h) * T;
  const float lse2[2] = {a.lse[bh + row_lo] * LOG2E, a.lse[bh + row_lo + 8] * LOG2E};
  const float dis[2] = {a.di[bh + row_lo], a.di[bh + row_lo + 8]};

  float acc[DH / 8][4];
  zero(acc);
  const int n_kblocks = qb + 1;  // key blocks up to the causal diagonal
  for (int kb = 0; kb < n_kblocks; ++kb) {
    const int buf = kb & 1;
    if (kb + 1 < n_kblocks) {
      const long long next = kv_base + (long long)(kb + 1) * FA_BLOCK * kv_stride;
      load_tile<DH, 2, ROW>(sk + (buf ^ 1) * S::TILE, a.k + next, kv_stride, tid);
      load_tile<DH, 2, ROW>(sv + (buf ^ 1) * S::TILE, a.v + next, kv_stride, tid);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    const uint8_t* kt = sk + buf * S::TILE;
    float p[8][4], ds[8][4];
    zero(p);
    zero(ds);
    rows_x_rows<DH, ROW>(p, sq, warp * 16, kt, lane);  // S = Q K^T
    probabilities<false>(p, sseg, q0 + warp * 16, kb * FA_BLOCK, lse2, nullptr, lane,
                         scale_log2);
    rows_x_rows<DH, ROW>(ds, sdo, warp * 16, sv + buf * S::TILE, lane);  // dP = dO V^T
    score_grads<false>(ds, p, dis, nullptr, a.sm_scale);
    acc_x_tile<DH, ROW>(acc, ds, kt, lane);  // dQ += dS K
    __syncthreads();
  }
  cp_async_wait_all();

  store_rows<DH>(a.dq + (((long long)b * T) * a.NQ + h) * DH * 2, (long long)a.NQ * DH, row_lo,
                 acc, lane);
}

template <int DH, bool DQ>
int launch_bwd(const BwdArgs& a, int B, void* stream) {
  auto kernel = DQ ? flash_attention_dq_kernel<DH> : flash_attention_dkv_kernel<DH>;
  const size_t smem = FlashShape<DH, 2>::bwd_smem_bytes(a.T);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(a.T / FA_BLOCK, DQ ? a.NQ : a.NKV, B);
  kernel<<<grid, FA_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// float32: 3xTF32 kernels of eight warps on swizzled tiles (the note above).

// probabilities over a warp's 16 x 32 score fragment: s[j][e] (row
// row0 + g + (e >> 1) * 8, column col0 + 8j + 2t + (e & 1)), with the rows'
// segment ids row_seg and the 32 columns' col_seg. KEY_ROWS (dk/dv): the
// rows are keys, and the columns' lse comes from lse_cols; else the rows
// are queries with lse2_rows = lse * log2(e) of rows g and g + 8.
template <bool KEY_ROWS>
__device__ __forceinline__ void probabilities_f32(float (&s)[4][4], const int (&row_seg)[2],
                                                  const int* col_seg, int row0, int col0,
                                                  const float (&lse2_rows)[2],
                                                  const float* lse_cols, int lane,
                                                  float scale_log2) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int2 seg2 = *reinterpret_cast<const int2*>(col_seg + 8 * j + 2 * t);
    float2 lse2 = make_float2(0.0f, 0.0f);
    if constexpr (KEY_ROWS) lse2 = *reinterpret_cast<const float2*>(lse_cols + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + (e >> 1) * 8;
      const int col = col0 + 8 * j + 2 * t + (e & 1);
      float lse;
      bool ok;
      if constexpr (KEY_ROWS) {
        lse = ((e & 1) ? lse2.y : lse2.x) * LOG2E;
        ok = row <= col;
      } else {
        lse = lse2_rows[e >> 1];
        ok = col <= row;
      }
      ok = ok && row_seg[e >> 1] == ((e & 1) ? seg2.y : seg2.x);
      s[j][e] = exp2f((ok ? s[j][e] * scale_log2 : FA_MASK) - lse);
    }
  }
}

// ds = sm_scale * p * (dp - di), in place in dp; di of the query (the
// columns' staged values in dk/dv, the rows' in dq).
template <bool KEY_ROWS>
__device__ __forceinline__ void score_grads_f32(float (&dp)[4][4], const float (&p)[4][4],
                                                const float (&di_rows)[2],
                                                const float* di_cols, int lane,
                                                float sm_scale) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float di = KEY_ROWS ? di_cols[8 * j + 2 * t + (e & 1)] : di_rows[e >> 1];
      dp[j][e] = sm_scale * p[j][e] * (dp[j][e] - di);
    }
}

template <int DH>
__global__ void __launch_bounds__(F32_THREADS, 1) flash_attention_dkv_f32_kernel(BwdArgs a) {
  using S = F32Shape<DH>;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint8_t* sk = smem;
  const uint8_t* sv = smem + S::FIXED;
  const uint8_t* q_hi = smem + S::SPLIT;
  const uint8_t* q_lo = q_hi + S::STREAM;
  const uint8_t* do_hi = q_lo + S::STREAM;
  const uint8_t* do_lo = do_hi + S::STREAM;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kb = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int T = a.T;
  const int group = a.NQ / a.NKV;
  const int k0 = kb * F32_ROWS;
  const int kw = k0 + warp * 16;  // this warp's first key; none when kw >= T
  const long long q_stride = (long long)a.NQ * DH * 4;
  const long long kv_stride = (long long)a.NKV * DH * 4;
  const float scale_log2 = a.sm_scale * LOG2E;
  const float no_rows[2] = {0.0f, 0.0f};
  const int* seg = a.seg + (long long)b * T;

  const long long kv_off = ((long long)b * T + k0) * kv_stride + (long long)hk * DH * 4;
  const int n_keys = min(F32_ROWS, T - k0);
  load_rows_f32<DH, F32_ROWS, F32_THREADS>(smem, a.k + kv_off, kv_stride, n_keys, tid);
  load_rows_f32<DH, F32_ROWS, F32_THREADS>(smem + S::FIXED, a.v + kv_off, kv_stride, n_keys,
                                          tid);
  // This thread's two keys, kw + g and kw + g + 8.
  const int key_seg[2] = {kw < T ? seg[kw + (lane >> 2)] : 0,
                          kw < T ? seg[kw + (lane >> 2) + 8] : 0};

  // Pairs (h, query tile): the group's heads, each over the 32-row tiles
  // from the one holding key k0 on.
  const int first = k0 / STREAM_ROWS;
  const int span = T / STREAM_ROWS - first;
  const int n_iter = group * span;
  auto load = [&](int it) {
    const int h = hk * group + it / span;
    const int q0 = (first + it % span) * STREAM_ROWS;
    const long long off = ((long long)b * T + q0) * q_stride + (long long)h * DH * 4;
    load_stream<DH>(smem, a.q + off, a.dout + off, q_stride, a.lse, a.di,
                    ((long long)b * a.NQ + h) * T + q0, seg + q0, it & 1, tid);
  };
  load(0);
  cp_async_commit();

  float dk[DH / 8][4], dv[DH / 8][4];
  zero(dk);
  zero(dv);
  for (int it = 0; it < n_iter; ++it) {
    split_stream<DH>(smem, tid);
    if (it + 1 < n_iter) load(it + 1);
    cp_async_commit();
    __syncthreads();

    const int q0 = (first + it % span) * STREAM_ROWS;
    // Causal: a tile that ends before this warp's first key adds nothing.
    if (kw < T && kw <= q0 + STREAM_ROWS - 1) {
      const float* rows = reinterpret_cast<const float*>(smem + S::ROWS) +
                          (it & 1) * 3 * STREAM_ROWS;
      const int* q_seg = reinterpret_cast<const int*>(rows + 2 * STREAM_ROWS);
      float p[4][4], ds[4][4];
      zero(p);
      rows_x_rows_f32<DH, 4>(p, sk, warp * 16, q_hi, q_lo, lane);  // S^T = K Q^T
      probabilities_f32<true>(p, key_seg, q_seg, kw, q0, no_rows, rows, lane, scale_log2);
      acc_x_tile_f32<DH, STREAM_ROWS>(dv, p, do_hi, do_lo, lane);  // dV += P^T dO
      zero(ds);
      rows_x_rows_f32<DH, 4>(ds, sv, warp * 16, do_hi, do_lo, lane);  // dP^T = V dO^T
      score_grads_f32<true>(ds, p, no_rows, rows + STREAM_ROWS, lane, a.sm_scale);
      acc_x_tile_f32<DH, STREAM_ROWS>(dk, ds, q_hi, q_lo, lane);  // dK += dS^T Q
    }
  }
  cp_async_wait_all();

  if (kw < T) {
    const long long base = ((long long)b * T * a.NKV + hk) * DH;
    const long long stride = (long long)a.NKV * DH;
    store_rows_f32<DH>(reinterpret_cast<float*>(a.dk) + base, stride, kw + (lane >> 2), dk, lane);
    store_rows_f32<DH>(reinterpret_cast<float*>(a.dv) + base, stride, kw + (lane >> 2), dv, lane);
  }
}

template <int DH>
__global__ void __launch_bounds__(F32_THREADS, 1) flash_attention_dq_f32_kernel(BwdArgs a) {
  using S = F32Shape<DH>;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint8_t* sq = smem;
  const uint8_t* sdo = smem + S::FIXED;
  const uint8_t* k_hi = smem + S::SPLIT;
  const uint8_t* k_lo = k_hi + S::STREAM;
  const uint8_t* v_hi = k_lo + S::STREAM;
  const uint8_t* v_lo = v_hi + S::STREAM;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int qb = gridDim.x - 1 - blockIdx.x;  // the latest queries (the most keys) first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int T = a.T;
  const int hk = h / (a.NQ / a.NKV);
  const int q0 = qb * F32_ROWS;
  const int qw = q0 + warp * 16;  // this warp's first query; none when qw >= T
  const int n_queries = min(F32_ROWS, T - q0);
  const long long q_stride = (long long)a.NQ * DH * 4;
  const long long kv_stride = (long long)a.NKV * DH * 4;
  const long long q_off = ((long long)b * T + q0) * q_stride + (long long)h * DH * 4;
  const long long kv_base = (long long)b * T * kv_stride + (long long)hk * DH * 4;
  const float scale_log2 = a.sm_scale * LOG2E;
  const int* seg = a.seg + (long long)b * T;

  load_rows_f32<DH, F32_ROWS, F32_THREADS>(smem, a.q + q_off, q_stride, n_queries, tid);
  load_rows_f32<DH, F32_ROWS, F32_THREADS>(smem + S::FIXED, a.dout + q_off, q_stride,
                                          n_queries, tid);
  auto load = [&](int kt) {
    const long long off = kv_base + (long long)kt * STREAM_ROWS * kv_stride;
    load_stream<DH>(smem, a.k + off, a.v + off, kv_stride, nullptr, nullptr, 0,
                    seg + kt * STREAM_ROWS, kt & 1, tid);
  };
  load(0);
  cp_async_commit();

  // This thread's two query rows, row_lo and row_lo + 8.
  const int row_lo = qw + (lane >> 2);
  float lse2[2] = {0.0f, 0.0f}, dis[2] = {0.0f, 0.0f};
  int q_seg[2] = {0, 0};
  if (qw < T) {
    const long long bh = ((long long)b * a.NQ + h) * T;
    for (int r = 0; r < 2; ++r) {
      lse2[r] = a.lse[bh + row_lo + 8 * r] * LOG2E;
      dis[r] = a.di[bh + row_lo + 8 * r];
      q_seg[r] = seg[row_lo + 8 * r];
    }
  }

  float dq[DH / 8][4];
  zero(dq);
  const int n_tiles = (q0 + n_queries) / STREAM_ROWS;  // key tiles up to the last query
  for (int kt = 0; kt < n_tiles; ++kt) {
    split_stream<DH>(smem, tid);
    if (kt + 1 < n_tiles) load(kt + 1);
    cp_async_commit();
    __syncthreads();

    const int k0 = kt * STREAM_ROWS;
    // Causal: a tile that starts after this warp's last query adds nothing.
    if (qw < T && k0 <= qw + 15) {
      const int* k_seg =
          reinterpret_cast<const int*>(smem + S::ROWS) + ((kt & 1) * 3 + 2) * STREAM_ROWS;
      float p[4][4], ds[4][4];
      zero(p);
      rows_x_rows_f32<DH, 4>(p, sq, warp * 16, k_hi, k_lo, lane);  // S = Q K^T
      probabilities_f32<false>(p, q_seg, k_seg, qw, k0, lse2, nullptr, lane, scale_log2);
      zero(ds);
      rows_x_rows_f32<DH, 4>(ds, sdo, warp * 16, v_hi, v_lo, lane);  // dP = dO V^T
      score_grads_f32<false>(ds, p, dis, nullptr, lane, a.sm_scale);
      acc_x_tile_f32<DH, STREAM_ROWS>(dq, ds, k_hi, k_lo, lane);  // dQ += dS K
    }
  }
  cp_async_wait_all();

  if (qw < T) {
    store_rows_f32<DH>(reinterpret_cast<float*>(a.dq) + ((long long)b * T * a.NQ + h) * DH,
                       (long long)a.NQ * DH, row_lo, dq, lane);
  }
}

template <int DH, bool DQ>
int launch_bwd_f32(const BwdArgs& a, int B, void* stream) {
  auto kernel = DQ ? flash_attention_dq_f32_kernel<DH> : flash_attention_dkv_f32_kernel<DH>;
  constexpr int smem = F32Shape<DH>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.T + F32_ROWS - 1) / F32_ROWS, DQ ? a.NQ : a.NKV, B);
  kernel<<<grid, F32_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int ELEM, bool DQ>
int dispatch_bwd(const void* q, const void* k, const void* v, const void* seg, const void* dout,
                 const void* lse, const void* di, void* dq, void* dk, void* dv, int B, int T,
                 int NQ, int NKV, int DH, float sm_scale, void* stream) {
  const BwdArgs a{static_cast<const uint8_t*>(q),    static_cast<const uint8_t*>(k),
                  static_cast<const uint8_t*>(v),    static_cast<const int*>(seg),
                  static_cast<const uint8_t*>(dout), static_cast<const float*>(lse),
                  static_cast<const float*>(di),     static_cast<uint8_t*>(dq),
                  static_cast<uint8_t*>(dk),         static_cast<uint8_t*>(dv),
                  T,                                 NQ,
                  NKV,                               sm_scale};
  if constexpr (ELEM == 2) {
    if (DH == 128) return launch_bwd<128, DQ>(a, B, stream);
    if (DH == 64) return launch_bwd<64, DQ>(a, B, stream);
  } else {
    if (DH == 128) return launch_bwd_f32<128, DQ>(a, B, stream);
    if (DH == 64) return launch_bwd_f32<64, DQ>(a, B, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace tiles

extern "C" {

// dq [B, T, NQ, DH] bf16 from bf16 q, k, v, dout and f32 lse, di (see the
// note above). Requires contiguous inputs, T % 64 == 0, NQ % NKV == 0 and
// DH of 64 or 128 (the wrapper checks; another DH returns
// cudaErrorInvalidValue). Returns cudaGetLastError() after the launch.
int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* seg,
                           const void* dout, const void* lse, const void* di, void* dq, int B,
                           int T, int NQ, int NKV, int DH, float sm_scale, void* stream) {
  return tiles::dispatch_bwd<2, true>(q, k, v, seg, dout, lse, di, dq, nullptr, nullptr, B, T,
                                      NQ, NKV, DH, sm_scale, stream);
}

// dk and dv [B, T, NKV, DH] bf16, each summed over its group's q heads.
int flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* seg,
                            const void* dout, const void* lse, const void* di, void* dk,
                            void* dv, int B, int T, int NQ, int NKV, int DH, float sm_scale,
                            void* stream) {
  return tiles::dispatch_bwd<2, false>(q, k, v, seg, dout, lse, di, nullptr, dk, dv, B, T, NQ,
                                       NKV, DH, sm_scale, stream);
}

// The same two over float32 inputs and outputs (3xTF32 products).
int flash_attention_bwd_dq_f32(const void* q, const void* k, const void* v, const void* seg,
                               const void* dout, const void* lse, const void* di, void* dq,
                               int B, int T, int NQ, int NKV, int DH, float sm_scale,
                               void* stream) {
  return tiles::dispatch_bwd<4, true>(q, k, v, seg, dout, lse, di, dq, nullptr, nullptr, B, T,
                                      NQ, NKV, DH, sm_scale, stream);
}

int flash_attention_bwd_dkv_f32(const void* q, const void* k, const void* v, const void* seg,
                                const void* dout, const void* lse, const void* di, void* dk,
                                void* dv, int B, int T, int NQ, int NKV, int DH,
                                float sm_scale, void* stream) {
  return tiles::dispatch_bwd<4, false>(q, k, v, seg, dout, lse, di, nullptr, dk, dv, B, T, NQ,
                                       NKV, DH, sm_scale, stream);
}

}  // extern "C"
