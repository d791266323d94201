// Tiles and fragment moves shared by the flash-attention kernels: the
// forward (flash_attention.cu) and the backward's dq and dk/dv kernels
// (flash_attention_bwd.cu).
//
// A forward tile, and a bf16 backward tile, is 64 rows of DH values of
// ELEM bytes (bf16: 2, f32: 4), copied from device memory by cp.async into
// shared memory whose rows are padded by 16 bytes, so that ldmatrix (8 rows
// of 16 bytes at a stride of 4 banks mod 32) is free of bank conflicts.
// The bf16 backward's products are of two shapes over a warp's 16 rows:
//
//   rows_x_rows: acc[16 x 64] += A[16 x DH] . B[64 x DH]^T, both tiles with
//     the depth contiguous (S = Q K^T, dP = dO V^T and their transposes);
//   acc_x_tile:  out[16 x DH] += X[16 x 64] . B[64 x DH], X an accumulator
//     left in registers and B row-major over its 64 rows (dV += P^T dO,
//     dK += dS^T Q, dQ += dS K);
//
// on mma.sync m16n8k16 with f32 accumulation. The f32 backward runs the
// same two shapes as 3xTF32 (m16n8k8) on unpadded, swizzled tiles
// (rows_x_rows_f32, acc_x_tile_f32, below), whose layout serves ldmatrix
// and the 16-byte loads of acc_x_tile_f32 alike.

#pragma once

#include <cuda_bf16.h>
#include <float.h>

#include "mma_tiles.cuh"

namespace tiles {
namespace {  // the header's internal namespace, reopened

constexpr int FA_BLOCK = 64;     // rows per tile: queries or keys
constexpr int FA_THREADS = 128;  // four warps of 16 rows
constexpr float FA_MASK = -0.7f * FLT_MAX;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Shared memory of a forward block: a Q tile, two K and two V tiles of 64
// rows of DH values of ELEM bytes, then the batch row's segment ids. Q and
// K rows are padded by 16 bytes; f32 V rows by 32 bytes (the scalar loads
// of a B fragment read rows t and columns g: 8t + g covers the 32 banks).
template <int DH, int ELEM>
struct FlashShape {
  static constexpr int ROW = DH * ELEM + 16;
  static constexpr int ROW_V = ELEM == 2 ? ROW : DH * ELEM + 32;
  static constexpr int TILE = FA_BLOCK * ROW;
  static constexpr int TILE_V = FA_BLOCK * ROW_V;
  static constexpr int CHUNKS = DH * ELEM / 16;  // 16-byte chunks per row
  static size_t smem_bytes(int T) {
    return 3 * TILE + 2 * TILE_V + sizeof(int) * (size_t)T;
  }
  // A bf16 backward block: two fixed tiles and two double-buffered
  // streams, all of row stride ROW, then the segment ids.
  static size_t bwd_smem_bytes(int T) { return 6 * TILE + sizeof(int) * (size_t)T; }
};

// cp.async of 64 rows of DH * ELEM bytes (row stride `stride` bytes) into a
// tile of row stride ROW.
template <int DH, int ELEM, int ROW>
__device__ __forceinline__ void load_tile(uint8_t* tile, const uint8_t* rows,
                                          long long stride, int tid) {
  constexpr int CHUNKS = FlashShape<DH, ELEM>::CHUNKS;
#pragma unroll
  for (int i = 0; i < FA_BLOCK * CHUNKS / FA_THREADS; ++i) {
    const int c = tid + i * FA_THREADS;
    const int r = c / CHUNKS;
    const int col = (c % CHUNKS) * 16;
    cp_async16(tile + r * ROW + col, rows + r * stride + col, 16);
  }
}

// acc[16 x 64] += A[row0 .. row0 + 16) . B[0 .. 64)^T over DH, bf16: A and
// B are tiles of row stride ROW with the depth contiguous. The A fragment
// of a k-step is rows row0 + (lane & 15), bytes (lane >> 4) * 16 of the
// slice; the B fragments of n-tiles 2nj, 2nj + 1 are rows nj * 16 +
// (lane & 7) + (lane >> 4) * 8, bytes ((lane >> 3) & 1) * 16.
template <int DH, int ROW>
__device__ __forceinline__ void rows_x_rows(float (&acc)[8][4], const uint8_t* a_tile, int row0,
                                            const uint8_t* b_tile, int lane) {
  constexpr int KSTEPS = DH * 2 / 32;
  const uint8_t* a_rows = a_tile + (row0 + (lane & 15)) * ROW + (lane >> 4) * 16;
  const uint8_t* b_rows = b_tile + ((lane & 7) + (lane >> 4) * 8) * ROW + ((lane >> 3) & 1) * 16;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, a_rows + kk * 32);
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      uint32_t b[4];
      ldmatrix_x4(b, b_rows + nj * 16 * ROW + kk * 32);
      Bf16Product::mma(acc[2 * nj], a, b[0], b[1]);
      Bf16Product::mma(acc[2 * nj + 1], a, b[2], b[3]);
    }
  }
}

// out[16 x DH] += X[16 x 64] . B[64 x DH], bf16: X in the m16n8 accumulator
// layout (x[j][e]: row g + (e >> 1) * 8, column j * 8 + 2t + (e & 1)), B a
// tile of row stride ROW whose 64 rows are the depth. n-tiles 2c and 2c + 1
// of X, rounded to bf16, are exactly the A fragment of k16 chunk c, and B^T
// comes by ldmatrix.trans.
template <int DH, int ROW>
__device__ __forceinline__ void acc_x_tile(float (&out)[DH / 8][4], const float (&x)[8][4],
                                           const uint8_t* b_tile, int lane) {
  uint32_t xf[4][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    xf[j >> 1][(j & 1) * 2] = pack_bf16(x[j][0], x[j][1]);
    xf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(x[j][2], x[j][3]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int np = 0; np < DH / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, b_tile + (c * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ROW +
                               (np * 16 + (lane >> 4) * 8) * 2);
      Bf16Product::mma(out[2 * np], xf[c], b[0], b[1]);
      Bf16Product::mma(out[2 * np + 1], xf[c], b[2], b[3]);
    }
}

// Writes this thread's part of a warp's 16 x DH accumulator to rows row_lo
// and row_lo + 8 of a [.., DH] bf16 output (row r at dst + r * stride
// elements), as bf16 pairs.
template <int DH>
__device__ __forceinline__ void store_rows(uint8_t* dst, long long stride, int row_lo,
                                           const float (&acc)[DH / 8][4], int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    uint8_t* row = dst + (long long)(row_lo + r * 8) * stride * 2;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const int col = n * 8 + t * 2;
      *reinterpret_cast<uint32_t*>(row + col * 2) = pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------
// f32 tiles of the backward: unpadded rows of DH floats, each row's 16-byte
// chunk c stored at chunk c ^ swizzle(row). The swizzle permutes the low
// three bits of the chunk index by the row's place in its 8-row group:
//
// - ldmatrix reads 8 consecutive rows at one chunk, and the 8 swizzle
//   values of a group differ, so the 8 reads take 8 different 4-bank
//   groups (a row of 256 or 512 bytes is 0 banks mod 32);
// - acc_x_tile_f32 reads, in each quarter warp (lanes g = 2m, 2m + 1 and
//   t = 0..3), rows 2t (or 2t + 1) at chunks (DH / 32) g + i: DH 128 needs
//   the swizzles of rows 0, 2, 4, 6 (and of 1, 3, 5, 7) to differ in their
//   low two bits, DH 64 in bits 0 and 2, and so each value below is built.
//
// So neither read has a bank conflict, where a pad serves one or the other
// (ldmatrix needs a row stride of 4 mod 8 words, scalar B reads at rows t
// and columns g one of 8 mod 16).
template <int DH>
__device__ __forceinline__ int swizzle(int row) {
  const int a = (row >> 1) & 3;
  const int odd = row & 1;
  if constexpr (DH == 128) {
    return a | (odd << 2);  // rows 0..7 -> 0 4 1 5 2 6 3 7
  } else {
    return (a & 1) | (odd << 1) | ((a & 2) << 1);  // -> 0 2 1 3 4 6 5 7
  }
}

// 3xTF32 split of f32 values, as F32Product::split gives it for every
// finite x: hi = tf32(x) rounded to nearest, ties away (cvt.rna's add of
// half a tf32 ulp and mask, here without cvt's test for NaN and inf), and
// lo = tf32(x - hi) by cvt.rna. A NaN or infinite x gives a NaN x - hi, so
// its products stay NaN as with two cvt.
template <int R>
__device__ __forceinline__ void split_f32(const uint32_t (&x)[R], uint32_t (&hi)[R],
                                          uint32_t (&lo)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    hi[i] = (x[i] + 0x1000u) & 0xffffe000u;
    lo[i] = F32Product::to_tf32(__uint_as_float(x[i]) - __uint_as_float(hi[i]));
  }
}

// cp.async of rows [0, n_rows) of ROWS rows of DH floats (row stride
// `stride` bytes) into a swizzled tile, by THREADS threads, thread tid
// taking chunks tid, tid + THREADS, ...; rows from n_rows on are left as
// they are.
template <int DH, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows_f32(uint8_t* tile, const uint8_t* rows,
                                              long long stride, int n_rows, int tid) {
  constexpr int CHUNKS = DH / 4;
#pragma unroll
  for (int i = 0; i < ROWS * CHUNKS / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / CHUNKS;
    const int ch = c % CHUNKS;
    if (r < n_rows) {
      cp_async16(tile + r * DH * 4 + ((ch ^ swizzle<DH>(r)) << 4), rows + r * stride + ch * 16,
                 16);
    }
  }
}

// Splits the chunks of a swizzled tile that thread tid copied with
// load_rows_f32 (so it needs only its own cp.async to have landed) into
// tiles of their tf32 hi and lo parts, in the same layout.
template <int DH, int ROWS, int THREADS>
__device__ __forceinline__ void split_rows_f32(const uint8_t* tile, uint8_t* hi_tile,
                                               uint8_t* lo_tile, int tid) {
  constexpr int CHUNKS = DH / 4;
#pragma unroll
  for (int i = 0; i < ROWS * CHUNKS / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / CHUNKS;
    const int off = r * DH * 4 + (((c % CHUNKS) ^ swizzle<DH>(r)) << 4);
    const uint4 v = *reinterpret_cast<const uint4*>(tile + off);
    const uint32_t x[4] = {v.x, v.y, v.z, v.w};
    uint32_t hi[4], lo[4];
    split_f32(x, hi, lo);
    *reinterpret_cast<uint4*>(hi_tile + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(lo_tile + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// acc[16 x 8 NT] += A[a_row0 .. a_row0 + 16) . B[0 .. 8 NT)^T over DH, 3xTF32:
// A a swizzled f32 tile, split here, and B given as the swizzled tiles of
// its tf32 hi and lo parts, all with the depth contiguous. Fragments as in
// rows_x_rows (a 32-bit word per ldmatrix cell is one f32); a_row0 is a
// multiple of 16, so every row a lane addresses has the swizzle of lane & 7.
template <int DH, int NT>
__device__ __forceinline__ void rows_x_rows_f32(float (&acc)[NT][4], const uint8_t* a_tile,
                                                int a_row0, const uint8_t* b_hi,
                                                const uint8_t* b_lo, int lane) {
  const int sw = swizzle<DH>(lane & 7);
  const uint8_t* a_rows = a_tile + (a_row0 + (lane & 15)) * DH * 4;
  const int b_row = ((lane & 7) + (lane >> 4) * 8) * DH * 4;
  const int a_chunk = (lane >> 4) ^ sw;
  const int b_chunk = ((lane >> 3) & 1) ^ sw;
#pragma unroll 4  // full unrolling spills the dq and dk/dv kernels
  for (int kk = 0; kk < DH / 8; ++kk) {
    uint32_t a[4], a_hi[4], a_lo[4];
    ldmatrix_x4(a, a_rows + (((2 * kk) ^ a_chunk) << 4));
    split_f32(a, a_hi, a_lo);
#pragma unroll
    for (int nj = 0; nj < NT / 2; ++nj) {
      const int off = b_row + nj * 16 * DH * 4 + (((2 * kk) ^ b_chunk) << 4);
      uint32_t bh[4], bl[4];
      ldmatrix_x4(bh, b_hi + off);
      ldmatrix_x4(bl, b_lo + off);
      F32Product::mma3(acc[2 * nj], a_hi, a_lo, bh[0], bh[1], bl[0], bl[1]);
      F32Product::mma3(acc[2 * nj + 1], a_hi, a_lo, bh[2], bh[3], bl[2], bl[3]);
    }
  }
}

// out[16 x DH] += X[16 x DEPTH] . B[DEPTH x DH], 3xTF32: X in the
// accumulator layout of rows_x_rows_f32 (x[c][e]: row g + (e >> 1) * 8,
// column 8c + 2t + (e & 1)), split here; B given as the swizzled tiles of
// its tf32 hi and lo parts, whose DEPTH rows are the depth. Two choices
// make it a product of loads and mma only:
//
// - the k index of k-chunk c is permuted, mma k = t taking depth 8c + 2t and
//   k = t + 4 depth 8c + 2t + 1, so X's registers are the tf32 A fragment
//   as they stand ({x0, x2, x1, x3}: no shuffles), and B's fragment is rows
//   8c + 2t and 8c + 2t + 1;
// - out's n-tile n, column m, is DH column m * (DH / 8) + n, so a lane's B
//   values of n-tiles 4i .. 4i + 3 are one 16-byte chunk of each row.
//   store_rows_f32 writes out back in DH order.
template <int DH, int DEPTH>
__device__ __forceinline__ void acc_x_tile_f32(float (&out)[DH / 8][4],
                                               const float (&x)[DEPTH / 8][4],
                                               const uint8_t* b_hi, const uint8_t* b_lo,
                                               int lane) {
  constexpr int PER_G = DH / 32;  // chunks of a lane's n-tile columns
  const int g = lane >> 2;
  const int t = lane & 3;
  const int sw0 = swizzle<DH>(2 * t);
  const int sw1 = swizzle<DH>(2 * t + 1);
#pragma unroll
  for (int c = 0; c < DEPTH / 8; ++c) {
    const uint32_t xa[4] = {__float_as_uint(x[c][0]), __float_as_uint(x[c][2]),
                            __float_as_uint(x[c][1]), __float_as_uint(x[c][3])};
    uint32_t x_hi[4], x_lo[4];
    split_f32(xa, x_hi, x_lo);
    const int row0 = (8 * c + 2 * t) * DH * 4;
    const int row1 = row0 + DH * 4;
#pragma unroll
    for (int i = 0; i < PER_G; ++i) {
      const int chunk = PER_G * g + i;
      const int off0 = row0 + ((chunk ^ sw0) << 4);
      const int off1 = row1 + ((chunk ^ sw1) << 4);
      const uint4 h0 = *reinterpret_cast<const uint4*>(b_hi + off0);
      const uint4 h1 = *reinterpret_cast<const uint4*>(b_hi + off1);
      const uint4 l0 = *reinterpret_cast<const uint4*>(b_lo + off0);
      const uint4 l1 = *reinterpret_cast<const uint4*>(b_lo + off1);
      F32Product::mma3(out[4 * i], x_hi, x_lo, h0.x, h1.x, l0.x, l1.x);
      F32Product::mma3(out[4 * i + 1], x_hi, x_lo, h0.y, h1.y, l0.y, l1.y);
      F32Product::mma3(out[4 * i + 2], x_hi, x_lo, h0.z, h1.z, l0.z, l1.z);
      F32Product::mma3(out[4 * i + 3], x_hi, x_lo, h0.w, h1.w, l0.w, l1.w);
    }
  }
}

// Writes this thread's part of a warp's 16 x DH acc_x_tile_f32 accumulator
// to rows row_lo and row_lo + 8 of a [.., DH] f32 output (row r at
// dst + r * stride floats): out[n][e] is row (e >> 1) * 8, column
// (2t + (e & 1)) * (DH / 8) + n, so a lane writes DH / 4 consecutive floats
// of each row, as 16-byte stores.
template <int DH>
__device__ __forceinline__ void store_rows_f32(float* dst, long long stride, int row_lo,
                                               const float (&acc)[DH / 8][4], int lane) {
  constexpr int NT = DH / 8;
  const int t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* row = dst + (long long)(row_lo + r * 8) * stride + 2 * t * NT;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int n = 0; n < NT; n += 4) {
        const int e = 2 * r + h;
        *reinterpret_cast<float4*>(row + h * NT + n) =
            make_float4(acc[n][e], acc[n + 1][e], acc[n + 2][e], acc[n + 3][e]);
      }
  }
}

}  // namespace
}  // namespace tiles
