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
// bf16 design: every product on wgmma (sm_90a), warpgroups of 4 warps
// over 64 fixed rows, Q and dO (dk/dv) or K and V (dq) streamed past as
// 32-row tiles; flash_tiles.cuh has the swizzled tiles and wgmma helpers.
//
// - dk/dv: one block of one warpgroup per (64-key block, kv head, batch
//   row), the earliest key blocks (the most queries) first, two blocks an
//   SM. K and V stay in shared memory; the pairs (q head of the group,
//   32-row query tile) from the block's first key on stream through a
//   3-stage cp.async ring, their lse, di and segment ids staged beside
//   them. One pass, 4 products a tile pair: S^T = K Q^T and dP^T = V dO^T
//   as m64n32k16 with both operands in shared memory (K-major), P^T from
//   lse, then dV += P^T dO and dK += dS^T Q as m64n{DH}k16 whose A is the
//   f32 accumulator rounded to bf16 in registers (its layout is the A
//   fragment's) and whose B is the streamed tile read MN-major (the
//   descriptor's transpose bit). dP^T runs under P^T's softmax, dV under
//   dS^T's.
// - dq: one block of two warpgroups per (128-query block, q head, batch
//   row), the latest query blocks (the most keys) first, two blocks an SM
//   (at most 128 registers a thread, a 2-stage ring). S = Q K^T and
//   dP = dO V^T from shared memory, dQ += dS K with dS in registers and K
//   read MN-major.
// - A warpgroup skips a streamed tile in which the mask allows no pair of
//   its 64 rows: causal, or, when its rows share one segment, a tile with
//   no row of that segment in its causal range (the forward's rule, a
//   ballot over the staged ids, the same in its four warps, which issue
//   each wgmma together). The skip is exact: such a tile adds p = 0 and
//   ds = 0 to every sum. T % 128 == 64 leaves dq's last block an upper
//   warpgroup without rows; it only copies.
// - Tiles are unpadded, in wgmma's 128-byte swizzle (panels of 64 columns,
//   each row's 16-byte chunks XOR-ed by its place in its 8-row group),
//   written so by cp.async, and 1024-byte aligned; a proxy fence after each
//   ring wait makes the copies visible to wgmma. The gradients leave
//   through the warpgroup's own rows of the fixed tiles as 16-byte stores
//   of whole rows (7-23% faster than bf16 pairs straight from the
//   accumulators, scripts/time_flash_backward_variants.py).
// - Shared memory (DH = 128): dk/dv K and V 32 KB, the ring 48 KB, 82 KB a
//   block; dq Q and dO 64 KB, the ring 32 KB, 98 KB. Registers (ptxas):
//   dk/dv 245, dq 128 with 8 bytes spilled.
//
// What holds them (the variants script's ablations, NVIDIA H100 80GB
// HBM3): no one part; leaving out the products, the softmax, the streamed
// or the fixed copies saves 5-22% each. Their wgmma take about 0.02 ms at
// the rates scripts/measure_mma_tf32_rate.py measures (m64n32k16 from
// shared memory at 65% of the tensor cores' peak, m64n128k16 with A in
// registers at 98%), the bytes 0.040 ms at 3.35 TB/s; the rest is each
// warpgroup's chain of ring wait, barrier, ballot, products and softmax,
// and each block's first copies, with 2 warpgroups an SM.
//
// float32 design (3xTF32: each operand split into tf32 hi and lo, every
// product lo*hi + hi*lo + hi*hi on mma.sync m16n8k8, within about 3 * 2^-22
// of f32 per product, as in the forward). The products and their operands
// are the bf16 kernels'. Four warps over 64-row f32 tiles (the first
// design) ran one block of 4 warps an SM (198 KB of padded tiles),
// computed S^T twice in dk/dv (5 products a tile pair, where 4 do) for
// want of registers, split every streamed value again in each warp and
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

// probabilities over a warp's 16 x 32 score fragment: s[j][e] (row
// row0 + g + (e >> 1) * 8, column col0 + 8j + 2t + (e & 1)), with the rows'
// segment ids row_seg and the 32 columns' col_seg. KEY_ROWS (dk/dv): the
// rows are keys, and the columns' lse comes from lse_cols; else the rows
// are queries with lse2_rows = lse * log2(e) of rows g and g + 8.
template <bool KEY_ROWS>
__device__ __forceinline__ void probabilities(float (&s)[4][4], const int (&row_seg)[2],
                                              const int* col_seg, int row0, int col0,
                                              const float (&lse2_rows)[2], const float* lse_cols,
                                              int lane, float scale_log2) {
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
__device__ __forceinline__ void score_grads(float (&dp)[4][4], const float (&p)[4][4],
                                            const float (&di_rows)[2], const float* di_cols,
                                            int lane, float sm_scale) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float di = KEY_ROWS ? di_cols[8 * j + 2 * t + (e & 1)] : di_rows[e >> 1];
      dp[j][e] = sm_scale * p[j][e] * (dp[j][e] - di);
    }
}

// ---------------------------------------------------------------------
// bf16: wgmma kernels of warpgroups on swizzled tiles (the note above).

// Each block: GROUPS warpgroups of 64 fixed rows (keys in dk/dv, queries
// in dq), a ring of STAGES streamed pairs, BLOCKS blocks an SM.
constexpr int DKV_GROUPS = 1, DKV_STAGES = 3, DKV_BLOCKS = 2;
constexpr int DQ_GROUPS = 2, DQ_STAGES = 2, DQ_BLOCKS = 2;

// A bf16 backward block of GROUPS warpgroups and its shared memory, from
// its first 1024-byte boundary: two fixed swizzled tiles of FIXED_ROWS rows
// (K and V, or Q and dO), STAGES stages of a streamed pair of
// STREAM_ROWS-row tiles (Q and dO, or K and V), then per stage its rows'
// lse, di and segment ids.
template <int DH, int GROUPS, int STAGES>
struct Bf16BwdShape {
  static constexpr int FIXED_ROWS = 64 * GROUPS;
  static constexpr int THREADS = 128 * GROUPS;
  static constexpr int FIXED = FIXED_ROWS * DH * 2;
  static constexpr int STREAM = STREAM_ROWS * DH * 2;
  static constexpr int RING = 2 * FIXED;
  static constexpr int STAGED = RING + STAGES * 2 * STREAM;
  static constexpr int BYTES = STAGED + STAGES * 3 * STREAM_ROWS * 4 + 1024;  // + alignment
  static_assert(BYTES <= 232448, "a bf16 backward block exceeds shared memory");
};

// Starts the copies of one streamed pair into ring stage `stage`: both
// 32-row tiles (rows of `first` and `second`, row stride `stride` bytes)
// and the staged values of its rows: lse and di (when lse is not null;
// rows [lse_row, +32) of [B, NQ, T]) and the segment ids from seg.
template <class S, int DH>
__device__ __forceinline__ void load_pair(uint8_t* smem, int stage, const uint8_t* first,
                                          const uint8_t* second, long long stride,
                                          const float* lse, const float* di, long long lse_row,
                                          const int* seg, int tid) {
  uint8_t* tiles = smem + S::RING + stage * 2 * S::STREAM;
  load_swizzled<DH, STREAM_ROWS, S::THREADS>(tiles, first, stride, tid);
  load_swizzled<DH, STREAM_ROWS, S::THREADS>(tiles + S::STREAM, second, stride, tid);
  // 16-byte copies: each row of 32 values is 128-byte aligned (T % 64 == 0).
  float* rows = reinterpret_cast<float*>(smem + S::STAGED) + stage * 3 * STREAM_ROWS;
  const int c = 4 * (tid % 8);
  if (tid < 8) {
    cp_async16(rows + 2 * STREAM_ROWS + c, seg + c, 16);
  } else if (lse != nullptr && tid < 24) {
    const bool is_lse = tid < 16;
    cp_async16(rows + (is_lse ? 0 : STREAM_ROWS) + c, (is_lse ? lse : di) + lse_row + c, 16);
  }
}

// The descriptor of k16 step kk of a K-major swizzled tile of ROWS rows,
// from that of its first step: panel kk / 4, bytes 32 (kk % 4) into it.
template <int ROWS>
__device__ __forceinline__ uint64_t k_step(uint64_t desc, int kk) {
  return desc + (uint64_t)(((kk >> 2) * ROWS * 128 + (kk & 3) * 32) >> 4);
}

// D[64 x 32] = A[64 x DH] . B[32 x DH]^T for warpgroup wg: A rows 64 wg ..
// of a fixed tile, B a streamed tile, both K-major; issued, not waited for.
template <int DH, int FIXED_ROWS>
__device__ __forceinline__ void rows_x_stream(float (&d)[4][4], const uint8_t* fixed,
                                              const uint8_t* stream, int wg) {
  const uint64_t a = wgmma_desc(fixed + wg * 64 * 128, 16, 1024);
  const uint64_t b = wgmma_desc(stream, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    wgmma_ss<STREAM_ROWS>(*reinterpret_cast<float(*)[16]>(&d), k_step<FIXED_ROWS>(a, kk),
                          k_step<STREAM_ROWS>(b, kk));
  }
}

// Rounds a warpgroup's 64 x 32 accumulator to bf16 A fragments: n-tiles
// 2c and 2c + 1 are k16 chunk c.
__device__ __forceinline__ void to_a_fragments(const float (&x)[4][4], uint32_t (&xf)[2][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    xf[j >> 1][(j & 1) * 2] = pack_bf16(x[j][0], x[j][1]);
    xf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(x[j][2], x[j][3]);
  }
}

// out[64 x DH] += X[64 x 32] . B[32 x DH]: X as A fragments in registers,
// B a streamed tile read MN-major (k16 step c is its rows 16c .., its
// 64-column panels STREAM_ROWS * 128 bytes apart); issued, not waited for.
template <int DH>
__device__ __forceinline__ void acc_x_stream(float (&out)[DH / 2], const uint32_t (&xf)[2][4],
                                             const uint8_t* stream) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    wgmma_rs_t<DH>(out, xf[c], wgmma_desc(stream + c * 16 * 128, STREAM_ROWS * 128, 1024));
  }
}

// Writes a warpgroup's 64 x DH accumulator (warp w's rows 16w + g and
// 16w + g + 8 in the accumulator layout) as bf16 into its own rows
// 64 wg .. of a swizzled tile of FR rows, which no product reads any more,
// and, after the group's barrier, copies those rows to dst (row r at
// dst + r * stride elements) by 16-byte stores of whole rows.
template <int DH, int FR>
__device__ __forceinline__ void store_group(const float (&acc)[DH / 2], uint8_t* tile, int wg,
                                            uint8_t* dst, long long stride, int tid) {
  const int lane = tid & 31;
  const int row0 = 64 * wg + 16 * ((tid >> 5) & 3) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      *reinterpret_cast<uint32_t*>(tile + swizzled<FR>(row0 + 8 * r, j) + 4 * (lane & 3)) =
          pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  constexpr int CHUNKS = DH / 8;
#pragma unroll
  for (int i = 0; i < 64 * CHUNKS / 128; ++i) {
    const int c = (tid & 127) + 128 * i;
    const int r = c / CHUNKS;
    *reinterpret_cast<uint4*>(dst + (long long)r * stride * 2 + (c % CHUNKS) * 16) =
        *reinterpret_cast<const uint4*>(tile + swizzled<FR>(64 * wg + r, c % CHUNKS));
  }
}

// The top of every iteration of a bf16 backward block: this thread's
// copies of pair it have landed (only the newer of the two groups in
// flight may pend) and are made visible to wgmma, and after the barrier no
// warpgroup reads the stage that the next load refills (each waited for
// its products of the last pair).
template <int STAGES>
__device__ __forceinline__ void ring_wait() {
  cp_async_wait<STAGES - 2>();
  fence_proxy_async();
  __syncthreads();
}

template <int DH>
__global__ void __launch_bounds__(128 * DKV_GROUPS, DKV_BLOCKS)
    flash_attention_dkv_kernel(BwdArgs a) {
  using S = Bf16BwdShape<DH, DKV_GROUPS, DKV_STAGES>;
  constexpr int STAGES = DKV_STAGES;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint8_t* sk = smem;
  const uint8_t* sv = smem + S::FIXED;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;  // warpgroup: keys k0 + 64 wg ..
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int kb = blockIdx.z;  // the earliest keys (the most queries) first
  const int T = a.T;
  const int group = a.NQ / a.NKV;
  const int k0 = kb * S::FIXED_ROWS;
  const int kg = k0 + 64 * wg;             // the warpgroup's first key; none when kg >= T
  const int kw = kg + 16 * (warp & 3);     // this warp's first key
  const long long q_stride = (long long)a.NQ * DH * 2;
  const long long kv_stride = (long long)a.NKV * DH * 2;
  const float scale_log2 = a.sm_scale * LOG2E;
  const float no_rows[2] = {0.0f, 0.0f};
  const int* seg = a.seg + (long long)b * T;

  const long long kv_off = ((long long)b * T + k0) * kv_stride + (long long)hk * DH * 2;
  const int n_keys = min(S::FIXED_ROWS, T - k0);
  load_swizzled<DH, S::FIXED_ROWS, S::THREADS>(smem, a.k + kv_off, kv_stride, tid, n_keys);
  load_swizzled<DH, S::FIXED_ROWS, S::THREADS>(smem + S::FIXED, a.v + kv_off, kv_stride, tid,
                                               n_keys);

  // Pairs (h, query tile): the group's heads, each over the 32-row tiles
  // from the one holding key k0 on, through a ring of STAGES stages.
  const int first = k0 / STREAM_ROWS;
  const int span = T / STREAM_ROWS - first;
  const int n_iter = group * span;
  auto load = [&](int it) {
    const int h = hk * group + it / span;
    const int q0 = (first + it % span) * STREAM_ROWS;
    const long long off = ((long long)b * T + q0) * q_stride + (long long)h * DH * 2;
    load_pair<S, DH>(smem, it % STAGES, a.q + off, a.dout + off, q_stride, a.lse, a.di,
                     ((long long)b * a.NQ + h) * T + q0, seg + q0, tid);
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_iter) load(i);
    cp_async_commit();  // K and V join the first group
  }

  // This thread's two keys, kw + g and kw + g + 8, and whether the
  // warpgroup's 64 keys share one segment, s0.
  int key_seg[2] = {0, 0}, s0 = 0;
  bool uniform = false;
  if (kg < T) {
    uniform = rows_share_segment<64>(seg, kg, lane, s0);
    key_seg[0] = seg[kw + (lane >> 2)];
    key_seg[1] = seg[kw + (lane >> 2) + 8];
  }

  float dk[DH / 2], dv[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dk[i] = dv[i] = 0.0f;
  for (int it = 0; it < n_iter; ++it) {
    ring_wait<STAGES>();
    if (it + STAGES - 1 < n_iter) load(it + STAGES - 1);
    cp_async_commit();

    const int stage = it % STAGES;
    const int q0 = (first + it % span) * STREAM_ROWS;
    const uint8_t* qt = smem + S::RING + stage * 2 * S::STREAM;
    const uint8_t* dot = qt + S::STREAM;
    const float* rows = reinterpret_cast<const float*>(smem + S::STAGED) + stage * 3 * STREAM_ROWS;
    const int* q_seg = reinterpret_cast<const int*>(rows + 2 * STREAM_ROWS);
    // The same for all four warps of the group, which issue each wgmma together.
    if (kg >= T || !takes_query_tile<64>(q_seg, q0, kg, uniform, s0, lane)) continue;
    float p[4][4], ds[4][4];
    zero(p);
    zero(ds);
    wgmma_fence();
    rows_x_stream<DH, S::FIXED_ROWS>(p, sk, qt, wg);  // S^T = K Q^T
    wgmma_commit();
    rows_x_stream<DH, S::FIXED_ROWS>(ds, sv, dot, wg);  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(*reinterpret_cast<float(*)[16]>(&p));
    probabilities<true>(p, key_seg, q_seg, kw, q0, no_rows, rows, lane, scale_log2);
    uint32_t pf[2][4], sf[2][4];
    to_a_fragments(p, pf);
    wgmma_fence();
    acc_x_stream<DH>(dv, pf, dot);  // dV += P^T dO, under dS below
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(*reinterpret_cast<float(*)[16]>(&ds));
    score_grads<true>(ds, p, no_rows, rows + STREAM_ROWS, lane, a.sm_scale);
    to_a_fragments(ds, sf);
    wgmma_fence();
    acc_x_stream<DH>(dk, sf, qt);  // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dk);
    fence_operands(dv);
    fence_operands(*reinterpret_cast<uint32_t(*)[8]>(&pf));
    fence_operands(*reinterpret_cast<uint32_t(*)[8]>(&sf));
  }
  cp_async_wait_all();

  if (kg < T) {
    // Through the group's own rows of K and V, which no product reads now.
    const long long stride = (long long)a.NKV * DH;
    const long long base = (((long long)b * T + kg) * a.NKV + hk) * DH * 2;
    store_group<DH, S::FIXED_ROWS>(dk, smem, wg, a.dk + base, stride, tid);
    store_group<DH, S::FIXED_ROWS>(dv, smem + S::FIXED, wg, a.dv + base, stride, tid);
  }
}

template <int DH>
__global__ void __launch_bounds__(128 * DQ_GROUPS, DQ_BLOCKS)
    flash_attention_dq_kernel(BwdArgs a) {
  using S = Bf16BwdShape<DH, DQ_GROUPS, DQ_STAGES>;
  constexpr int STAGES = DQ_STAGES;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint8_t* sq = smem;
  const uint8_t* sdo = smem + S::FIXED;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;  // warpgroup: queries q0 + 64 wg ..
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qb = gridDim.z - 1 - blockIdx.z;  // the latest queries (the most keys) first
  const int T = a.T;
  const int hk = h / (a.NQ / a.NKV);
  const int q0 = qb * S::FIXED_ROWS;
  const int qg = q0 + 64 * wg;          // the warpgroup's first query; none when qg >= T
  const int qw = qg + 16 * (warp & 3);  // this warp's first query
  const int n_queries = min(S::FIXED_ROWS, T - q0);
  const long long q_stride = (long long)a.NQ * DH * 2;
  const long long kv_stride = (long long)a.NKV * DH * 2;
  const long long q_off = ((long long)b * T + q0) * q_stride + (long long)h * DH * 2;
  const long long kv_base = (long long)b * T * kv_stride + (long long)hk * DH * 2;
  const float scale_log2 = a.sm_scale * LOG2E;
  const int* seg = a.seg + (long long)b * T;

  load_swizzled<DH, S::FIXED_ROWS, S::THREADS>(smem, a.q + q_off, q_stride, tid, n_queries);
  load_swizzled<DH, S::FIXED_ROWS, S::THREADS>(smem + S::FIXED, a.dout + q_off, q_stride, tid,
                                               n_queries);
  auto load = [&](int kt) {
    const long long off = kv_base + (long long)kt * STREAM_ROWS * kv_stride;
    load_pair<S, DH>(smem, kt % STAGES, a.k + off, a.v + off, kv_stride, nullptr, nullptr, 0,
                     seg + kt * STREAM_ROWS, tid);
  };
  const int n_tiles = (q0 + n_queries) / STREAM_ROWS;  // key tiles up to the last query
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_tiles) load(i);
    cp_async_commit();  // Q and dO join the first group
  }

  // This thread's two query rows, row_lo and row_lo + 8, and whether the
  // warpgroup's 64 queries share one segment, s0.
  const int row_lo = qw + (lane >> 2);
  float lse2[2] = {0.0f, 0.0f}, dis[2] = {0.0f, 0.0f};
  int q_seg[2] = {0, 0}, s0 = 0;
  bool uniform = false;
  if (qg < T) {
    const long long bh = ((long long)b * a.NQ + h) * T;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse2[r] = a.lse[bh + row_lo + 8 * r] * LOG2E;
      dis[r] = a.di[bh + row_lo + 8 * r];
      q_seg[r] = seg[row_lo + 8 * r];
    }
    uniform = rows_share_segment<64>(seg, qg, lane, s0);
  }

  float dq[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dq[i] = 0.0f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    ring_wait<STAGES>();
    if (kt + STAGES - 1 < n_tiles) load(kt + STAGES - 1);
    cp_async_commit();

    const int stage = kt % STAGES;
    const int k0 = kt * STREAM_ROWS;
    const uint8_t* k_tile = smem + S::RING + stage * 2 * S::STREAM;
    const uint8_t* v_tile = k_tile + S::STREAM;
    const int* k_seg =
        reinterpret_cast<const int*>(smem + S::STAGED) + (stage * 3 + 2) * STREAM_ROWS;
    // The same for all four warps of the group, which issue each wgmma together.
    if (qg >= T || !takes_tile<STREAM_ROWS, 64>(k_seg, k0, qg, uniform, s0, lane)) continue;
    float p[4][4], ds[4][4];
    zero(p);
    zero(ds);
    wgmma_fence();
    rows_x_stream<DH, S::FIXED_ROWS>(p, sq, k_tile, wg);  // S = Q K^T
    wgmma_commit();
    rows_x_stream<DH, S::FIXED_ROWS>(ds, sdo, v_tile, wg);  // dP = dO V^T
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(*reinterpret_cast<float(*)[16]>(&p));
    probabilities<false>(p, q_seg, k_seg, qw, k0, lse2, nullptr, lane, scale_log2);
    wgmma_wait<0>();
    fence_operands(*reinterpret_cast<float(*)[16]>(&ds));
    score_grads<false>(ds, p, dis, nullptr, lane, a.sm_scale);
    uint32_t sf[2][4];
    to_a_fragments(ds, sf);
    wgmma_fence();
    acc_x_stream<DH>(dq, sf, k_tile);  // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dq);
    fence_operands(*reinterpret_cast<uint32_t(*)[8]>(&sf));
  }
  cp_async_wait_all();

  if (qg < T) {
    // Through the group's own rows of Q, which no product reads now.
    const long long stride = (long long)a.NQ * DH;
    store_group<DH, S::FIXED_ROWS>(dq, smem, wg,
                                   a.dq + (((long long)b * T + qg) * a.NQ + h) * DH * 2, stride,
                                   tid);
  }
}

template <int DH, bool DQ>
int launch_bwd(const BwdArgs& a, int B, void* stream) {
  auto kernel = DQ ? flash_attention_dq_kernel<DH> : flash_attention_dkv_kernel<DH>;
  using Dkv = Bf16BwdShape<DH, DKV_GROUPS, DKV_STAGES>;
  using Dq = Bf16BwdShape<DH, DQ_GROUPS, DQ_STAGES>;
  const int smem = DQ ? Dq::BYTES : Dkv::BYTES;
  const int rows = DQ ? Dq::FIXED_ROWS : Dkv::FIXED_ROWS;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(DQ ? a.NQ : a.NKV, B, (a.T + rows - 1) / rows);
  kernel<<<grid, DQ ? Dq::THREADS : Dkv::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// float32: 3xTF32 kernels of eight warps on swizzled tiles (the note above).

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
      probabilities<true>(p, key_seg, q_seg, kw, q0, no_rows, rows, lane, scale_log2);
      acc_x_tile_f32<DH, STREAM_ROWS>(dv, p, do_hi, do_lo, lane);  // dV += P^T dO
      zero(ds);
      rows_x_rows_f32<DH, 4>(ds, sv, warp * 16, do_hi, do_lo, lane);  // dP^T = V dO^T
      score_grads<true>(ds, p, no_rows, rows + STREAM_ROWS, lane, a.sm_scale);
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
      probabilities<false>(p, q_seg, k_seg, qw, k0, lse2, nullptr, lane, scale_log2);
      zero(ds);
      rows_x_rows_f32<DH, 4>(ds, sdo, warp * 16, v_hi, v_lo, lane);  // dP = dO V^T
      score_grads<false>(ds, p, dis, nullptr, lane, a.sm_scale);
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
