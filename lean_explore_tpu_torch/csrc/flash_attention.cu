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
// Design. One block of four warps per (64-query block, q head, batch row),
// the latest query blocks (the most keys) first. The Q tile goes through
// shared memory into registers once (ldmatrix); the key blocks of 64 up to
// the causal diagonal stream through two shared-memory buffers of K and V
// by cp.async, the next block's copy in flight while this one is computed.
// Each warp owns 16 query rows: S = Q K^T on mma.sync m16n8k16 bf16 -> f32
// (16 x 64 per warp), the scale and mask, a running max and a per-thread
// running sum in f32 registers with exp2f and log2(e) folded into the scale,
// P rounded to bf16 and fed straight from the S accumulators as the A
// operand of O += P V (m16n8k16, V^T by ldmatrix.trans), and one division by
// the row sum at the end. Rows in shared memory are padded by 16 bytes, so
// ldmatrix of K, V^T and Q is free of bank conflicts. Shared memory: Q, two
// K and two V tiles of 64 x (DH * 2 + 16) bytes plus the row's segment ids:
// 89 KB at DH = 128, T = 512, set as dynamic shared memory; two blocks fit
// on an SM. wgmma, TMA and warp specialisation are later work.
//
// Float32 inputs (the trunk's f32 parity setting; the TPU kernel runs f32
// too) take `flash_attention_f32_kernel`: the same blocks and online
// softmax, both products as 3xTF32 (F32Product of mma_tiles.cuh, m16n8k8,
// within about 3 * 2^-22 of f32 per product), and p kept in f32 as the TPU
// kernel keeps it (`p.astype(v.dtype)`). Q stays in shared memory and is
// reloaded per key block (its split fragments would not fit in registers);
// P moves from the S accumulator layout to the tf32 A layout by quad
// shuffles; V's B fragments are scalar shared loads (ldmatrix.trans is
// 16-bit only), its rows padded by 32 bytes to keep them conflict-free.
// Shared memory: 173 KB at DH = 128, T = 512, one block per SM. The f32
// output is written as f32.
//
// With an lse pointer (the `_lse` entries, for the backward), each kernel
// also writes the row log-sum-exp of the scaled, masked scores in natural
// log, lse = (m + log2 l) ln 2 from its log2-domain running max and sum,
// to lse [B, NQ, T] f32: JAX's saved residuals l and m (`save_residuals`,
// flash_attention.py:234-251) folded into one. It is a template flag, so
// the entries without lse compile to the same code as before it existed.
// The tiles and loaders are flash_tiles.cuh's, shared with the backward.
//
// Bound at the serving shape (B = 64, T = 512, NQ 16, NKV 8, DH 128): q, k,
// v and out are 134.2 + 67.1 + 67.1 + 134.2 MB, 0.120 ms at 3.35 TB/s; the
// causal products are about 68.7 GFLOP, 0.069 ms at 989 TFLOP/s bf16. The
// kernel is bound by bytes (it rereads k and v from L2 for every q head and
// query block).

#include <type_traits>

#include "flash_tiles.cuh"

namespace tiles {
namespace {  // the header's internal namespace, reopened

// One key block of the online softmax for this thread's two rows (row_lo,
// row_lo + 8) of a warp's 16 x 64 score fragment: scale s into the log2
// domain, mask it (key <= query, same segment), update the running max
// (quad-reduced) and rescale the running sums and the output accumulators,
// then leave p = exp2(s - m) in f32 in s and add it to the running sums
// (per thread; quad-reduced once at the end).
template <int OTILES>
__device__ __forceinline__ void online_softmax(float (&s)[8][4], float (&o)[OTILES][4],
                                               float (&m_run)[2], float (&l_run)[2],
                                               const int* sseg, const int (&qseg)[2], int k0,
                                               int row_lo, int lane, float scale_log2) {
  float mx[2] = {FA_MASK, FA_MASK};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const int key = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
      const bool ok = key <= row_lo + r * 8 && sseg[key] == qseg[r];
      s[j][e] = ok ? s[j][e] * scale_log2 : FA_MASK;
      mx[r] = fmaxf(mx[r], s[j][e]);
    }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r]);
    alpha[r] = exp2f(m_run[r] - m_new);
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
  for (int j = 0; j < 8; ++j) {
    s[j][0] = exp2f(s[j][0] - m_run[0]);
    s[j][1] = exp2f(s[j][1] - m_run[0]);
    s[j][2] = exp2f(s[j][2] - m_run[1]);
    s[j][3] = exp2f(s[j][3] - m_run[1]);
    l_run[0] += s[j][0] + s[j][1];
    l_run[1] += s[j][2] + s[j][3];
  }
}

// The running sums of a row are spread over its quad; the full sums.
__device__ __forceinline__ void reduce_row_sums(float (&l_run)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
}

// The row log-sum-exp of the scaled, masked scores in natural-log units,
// lse = (m + log2 l) ln 2 from the log2-domain running max m and sum l, to
// lse[b, h, row] ([B, NQ, T] f32), written by one lane of each quad.
__device__ __forceinline__ void store_lse(float* lse, const float (&m_run)[2],
                                          const float (&l_run)[2], long long bh, int T,
                                          int row_lo, int lane) {
  if ((lane & 3) == 0) {
    lse[bh * T + row_lo] = (m_run[0] + log2f(l_run[0])) * LN2;
    lse[bh * T + row_lo + 8] = (m_run[1] + log2f(l_run[1])) * LN2;
  }
}

template <int DH, bool LSE>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const uint8_t* __restrict__ q,    // [B, T, NQ, DH] bf16
                       const uint8_t* __restrict__ k,    // [B, T, NKV, DH] bf16
                       const uint8_t* __restrict__ v,    // [B, T, NKV, DH] bf16
                       const int* __restrict__ seg,      // [B, T]
                       uint8_t* __restrict__ out,        // [B, T, NQ, DH] bf16
                       float* __restrict__ lse,          // [B, NQ, T] f32 when LSE
                       int T, int NQ, int NKV, float scale_log2) {
  using S = FlashShape<DH, 2>;
  constexpr int KSTEPS = DH / 16;  // k16 steps of QK^T
  constexpr int OTILES = DH / 8;   // n8 tiles of the output row
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sq = smem;
  uint8_t* sk = smem + S::TILE;       // two buffers
  uint8_t* sv = smem + 3 * S::TILE;   // two buffers
  int* sseg = reinterpret_cast<int*>(smem + 3 * S::TILE + 2 * S::TILE_V);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (NQ / NKV);
  const int q0 = qb * FA_BLOCK;
  const long long q_stride = (long long)NQ * DH * 2;
  const long long kv_stride = (long long)NKV * DH * 2;
  const long long kv_base = (long long)b * T * kv_stride + (long long)hk * DH * 2;
  const uint8_t* kg = k + kv_base;
  const uint8_t* vg = v + kv_base;

  for (int i = tid; i < T; i += FA_THREADS) sseg[i] = seg[(long long)b * T + i];
  load_tile<DH, 2, S::ROW>(
      sq, q + ((long long)b * T + q0) * q_stride + (long long)h * DH * 2, q_stride, tid);
  load_tile<DH, 2, S::ROW>(sk, kg, kv_stride, tid);
  load_tile<DH, 2, S::ROW>(sv, vg, kv_stride, tid);
  cp_async_commit();

  // This thread's two query rows: row_lo and row_lo + 8.
  const int row_lo = q0 + warp * 16 + (lane >> 2);
  uint32_t qf[KSTEPS][4];
  float o[OTILES][4];
#pragma unroll
  for (int n = 0; n < OTILES; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m_run[2] = {FA_MASK, FA_MASK};
  float l_run[2] = {0.0f, 0.0f};
  int qseg[2] = {0, 0};

  const int n_kblocks = qb + 1;  // key blocks up to the causal diagonal
  for (int kb = 0; kb < n_kblocks; ++kb) {
    const int buf = kb & 1;
    if (kb + 1 < n_kblocks) {
      const long long next = (long long)(kb + 1) * FA_BLOCK * kv_stride;
      load_tile<DH, 2, S::ROW>(sk + (buf ^ 1) * S::TILE, kg + next, kv_stride, tid);
      load_tile<DH, 2, S::ROW>(sv + (buf ^ 1) * S::TILE, vg + next, kv_stride, tid);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    if (kb == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        ldmatrix_x4(qf[kk], sq + (warp * 16 + (lane & 15)) * S::ROW + kk * 32 + (lane >> 4) * 16);
      qseg[0] = sseg[row_lo];
      qseg[1] = sseg[row_lo + 8];
    }

    // S = Q K^T for this warp's 16 rows and the block's 64 keys.
    const uint8_t* kt = sk + buf * S::TILE;
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t bf[4];
        ldmatrix_x4(bf, kt + (nj * 16 + (lane & 7) + (lane >> 4) * 8) * S::ROW + kk * 32 +
                            ((lane >> 3) & 1) * 16);
        Bf16Product::mma(s[2 * nj], qf[kk], bf[0], bf[1]);
        Bf16Product::mma(s[2 * nj + 1], qf[kk], bf[2], bf[3]);
      }

    online_softmax(s, o, m_run, l_run, sseg, qseg, kb * FA_BLOCK, row_lo, lane, scale_log2);

    // P rounded to bf16 as the A operand of P V: n8 tiles 2c and 2c + 1 of
    // S are k16 chunk c of P.
    uint32_t pf[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      pf[j >> 1][(j & 1) * 2] = pack_bf16(s[j][0], s[j][1]);
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(s[j][2], s[j][3]);
    }

    // O += P V.
    const uint8_t* vt = sv + buf * S::TILE;
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int np = 0; np < OTILES / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vt + (c * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * S::ROW +
                                  (np * 16 + (lane >> 4) * 8) * 2);
        Bf16Product::mma(o[2 * np], pf[c], bf[0], bf[1]);
        Bf16Product::mma(o[2 * np + 1], pf[c], bf[2], bf[3]);
      }
    __syncthreads();
  }
  cp_async_wait_all();

  // One normalisation by the full row sums, then bf16 out.
  reduce_row_sums(l_run);
  if constexpr (LSE) store_lse(lse, m_run, l_run, (long long)b * NQ + h, T, row_lo, lane);
  const float inv[2] = {1.0f / l_run[0], 1.0f / l_run[1]};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    uint8_t* dst = out + (((long long)b * T + row_lo + r * 8) * NQ + h) * DH * 2;
#pragma unroll
    for (int n = 0; n < OTILES; ++n) {
      const int col = n * 8 + (lane & 3) * 2;
      *reinterpret_cast<uint32_t*>(dst + col * 2) =
          pack_bf16(o[n][2 * r] * inv[r], o[n][2 * r + 1] * inv[r]);
    }
  }
}

template <int DH, bool LSE>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_f32_kernel(const uint8_t* __restrict__ q,  // [B, T, NQ, DH] f32
                           const uint8_t* __restrict__ k,  // [B, T, NKV, DH] f32
                           const uint8_t* __restrict__ v,  // [B, T, NKV, DH] f32
                           const int* __restrict__ seg,    // [B, T]
                           float* __restrict__ out,        // [B, T, NQ, DH] f32
                           float* __restrict__ lse,        // [B, NQ, T] f32 when LSE
                           int T, int NQ, int NKV, float scale_log2) {
  using S = FlashShape<DH, 4>;
  constexpr int KSTEPS = DH / 8;  // k8 steps (32 bytes) of QK^T
  constexpr int OTILES = DH / 8;  // n8 tiles of the output row
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sq = smem;
  uint8_t* sk = smem + S::TILE;      // two buffers
  uint8_t* sv = smem + 3 * S::TILE;  // two buffers of TILE_V
  int* sseg = reinterpret_cast<int*>(smem + 3 * S::TILE + 2 * S::TILE_V);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (NQ / NKV);
  const int q0 = qb * FA_BLOCK;
  const long long q_stride = (long long)NQ * DH * 4;
  const long long kv_stride = (long long)NKV * DH * 4;
  const long long kv_base = (long long)b * T * kv_stride + (long long)hk * DH * 4;
  const uint8_t* kg = k + kv_base;
  const uint8_t* vg = v + kv_base;

  for (int i = tid; i < T; i += FA_THREADS) sseg[i] = seg[(long long)b * T + i];
  load_tile<DH, 4, S::ROW>(
      sq, q + ((long long)b * T + q0) * q_stride + (long long)h * DH * 4, q_stride, tid);
  load_tile<DH, 4, S::ROW>(sk, kg, kv_stride, tid);
  load_tile<DH, 4, S::ROW_V>(sv, vg, kv_stride, tid);
  cp_async_commit();

  const int row_lo = q0 + warp * 16 + g;
  float o[OTILES][4];
#pragma unroll
  for (int n = 0; n < OTILES; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m_run[2] = {FA_MASK, FA_MASK};
  float l_run[2] = {0.0f, 0.0f};
  int qseg[2] = {0, 0};
  // Quad lanes holding the S columns 2(t/2), 2(t/2)+1 and 4 further on.
  const int src_lo = (lane & ~3) | (t >> 1);
  const int src_hi = src_lo + 2;

  const int n_kblocks = qb + 1;
  for (int kb = 0; kb < n_kblocks; ++kb) {
    const int buf = kb & 1;
    if (kb + 1 < n_kblocks) {
      const long long next = (long long)(kb + 1) * FA_BLOCK * kv_stride;
      load_tile<DH, 4, S::ROW>(sk + (buf ^ 1) * S::TILE, kg + next, kv_stride, tid);
      load_tile<DH, 4, S::ROW_V>(sv + (buf ^ 1) * S::TILE_V, vg + next, kv_stride, tid);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    if (kb == 0) {
      qseg[0] = sseg[row_lo];
      qseg[1] = sseg[row_lo + 8];
    }

    // S = Q K^T, 3xTF32; each 32-byte slice of a row is one k8 step, read
    // by the same ldmatrix walk as the bf16 tiles.
    const uint8_t* kt = sk + buf * S::TILE;
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll 2
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t a[4], a_hi[4], a_lo[4];
      ldmatrix_x4(a, sq + (warp * 16 + (lane & 15)) * S::ROW + kk * 32 + (lane >> 4) * 16);
      F32Product::split(a, a_hi, a_lo);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t bf[4], b_hi[4], b_lo[4];
        ldmatrix_x4(bf, kt + (nj * 16 + (lane & 7) + (lane >> 4) * 8) * S::ROW + kk * 32 +
                            ((lane >> 3) & 1) * 16);
        F32Product::split(bf, b_hi, b_lo);
        F32Product::mma3(s[2 * nj], a_hi, a_lo, b_hi[0], b_hi[1], b_lo[0], b_lo[1]);
        F32Product::mma3(s[2 * nj + 1], a_hi, a_lo, b_hi[2], b_hi[3], b_lo[2], b_lo[3]);
      }
    }

    online_softmax(s, o, m_run, l_run, sseg, qseg, kb * FA_BLOCK, row_lo, lane, scale_log2);

    // O += P V, 3xTF32. S n8 tile c is P's k8 chunk c; the tf32 A fragment
    // wants columns t and t + 4 of rows g and g + 8.
    const float* vt = reinterpret_cast<const float*>(sv + buf * S::TILE_V);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int src = e < 2 ? src_lo : src_hi;
        const int row = (e & 1) * 2;  // s[c][0..1]: row g, s[c][2..3]: row g + 8
        const float even = __shfl_sync(0xffffffffu, s[c][row], src);
        const float odd = __shfl_sync(0xffffffffu, s[c][row + 1], src);
        x[e] = (t & 1) ? odd : even;
      }
      // A order: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4).
      const uint32_t pa[4] = {__float_as_uint(x[0]), __float_as_uint(x[1]),
                              __float_as_uint(x[2]), __float_as_uint(x[3])};
      uint32_t p_hi[4], p_lo[4];
      F32Product::split(pa, p_hi, p_lo);
      const float* v0 = vt + (c * 8 + t) * (S::ROW_V / 4) + g;
      const float* v1 = v0 + 4 * (S::ROW_V / 4);
#pragma unroll
      for (int n = 0; n < OTILES; ++n) {
        const uint32_t vb[2] = {__float_as_uint(v0[n * 8]), __float_as_uint(v1[n * 8])};
        uint32_t v_hi[2], v_lo[2];
        F32Product::split(vb, v_hi, v_lo);
        F32Product::mma3(o[n], p_hi, p_lo, v_hi[0], v_hi[1], v_lo[0], v_lo[1]);
      }
    }
    __syncthreads();
  }
  cp_async_wait_all();

  reduce_row_sums(l_run);
  if constexpr (LSE) store_lse(lse, m_run, l_run, (long long)b * NQ + h, T, row_lo, lane);
  const float inv[2] = {1.0f / l_run[0], 1.0f / l_run[1]};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* dst = out + (((long long)b * T + row_lo + r * 8) * NQ + h) * DH;
#pragma unroll
    for (int n = 0; n < OTILES; ++n)
      *reinterpret_cast<float2*>(dst + n * 8 + t * 2) =
          make_float2(o[n][2 * r] * inv[r], o[n][2 * r + 1] * inv[r]);
  }
}

template <int DH, int ELEM, bool LSE>
int launch_flash(const void* q, const void* k, const void* v, const void* seg, void* out,
                 void* lse, int B, int T, int NQ, int NKV, float sm_scale, void* stream) {
  using Out = typename std::conditional<ELEM == 2, uint8_t, float>::type;
  void (*kernel)(const uint8_t*, const uint8_t*, const uint8_t*, const int*, Out*, float*, int,
                 int, int, float);
  if constexpr (ELEM == 2) {
    kernel = flash_attention_kernel<DH, LSE>;
  } else {
    kernel = flash_attention_f32_kernel<DH, LSE>;
  }
  const size_t smem = FlashShape<DH, ELEM>::smem_bytes(T);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(T / FA_BLOCK, NQ, B);
  kernel<<<grid, FA_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(k),
      static_cast<const uint8_t*>(v), static_cast<const int*>(seg), static_cast<Out*>(out),
      static_cast<float*>(lse), T, NQ, NKV, sm_scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
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
