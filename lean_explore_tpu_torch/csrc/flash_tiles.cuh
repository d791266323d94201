// Tiles and fragment moves shared by the flash-attention kernels: the
// forward (flash_attention.cu) and the backward's dq and dk/dv kernels
// (flash_attention_bwd.cu).
//
// A bf16 tile is rows of DH values copied from device memory by cp.async
// into shared memory whose rows are padded by 16 bytes, so that ldmatrix
// (8 rows of 16 bytes at a stride of 4 banks mod 32) is free of bank
// conflicts. The bf16 products are of two shapes over a warp's MT tiles of
// 16 rows, which share every B fragment (the forward takes MT = 2, the
// backward 1):
//
//   rows_x_rows_m: acc[16 x 8NT] += A[16 x DH] . B[8NT x DH]^T, both tiles
//     with the depth contiguous (S = Q K^T, dP = dO V^T and their
//     transposes);
//   acc_x_tile_m:  out[16 x DH] += X[16 x DEPTH] . B[DEPTH x DH], X an
//     accumulator left in registers and B row-major over its DEPTH rows
//     (O += P V, dV += P^T dO, dK += dS^T Q, dQ += dS K);
//
// on mma.sync m16n8k16 with f32 accumulation. The f32 kernels run the same
// two shapes as 3xTF32 (m16n8k8) on unpadded, swizzled tiles
// (rows_x_rows_f32, acc_x_tile_f32, below), whose layout serves ldmatrix
// and the 16-byte loads of acc_x_tile_f32 alike, with the streamed tiles
// split into tf32 hi and lo once (load_stream, split_stream).

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

// Padded tiles of 64 rows of DH values of ELEM bytes.
template <int DH, int ELEM>
struct FlashShape {
  static constexpr int ROW = DH * ELEM + 16;
  static constexpr int TILE = FA_BLOCK * ROW;
  static constexpr int CHUNKS = DH * ELEM / 16;  // 16-byte chunks per row
  // A bf16 backward block: two fixed tiles and two double-buffered
  // streams, all of row stride ROW, then the segment ids.
  static size_t bwd_smem_bytes(int T) { return 6 * TILE + sizeof(int) * (size_t)T; }
};

// cp.async of rows [0, n_rows) of ROWS rows of DH * ELEM bytes (row
// stride `stride` bytes) into a tile of row stride ROW, by THREADS threads;
// rows from n_rows on are left as they are. A caller that copies every row
// leaves n_rows at ROWS, and the row test folds away.
template <int DH, int ELEM, int ROW, int ROWS = FA_BLOCK, int THREADS = FA_THREADS>
__device__ __forceinline__ void load_tile(uint8_t* tile, const uint8_t* rows,
                                          long long stride, int tid, int n_rows = ROWS) {
  constexpr int CHUNKS = FlashShape<DH, ELEM>::CHUNKS;
#pragma unroll
  for (int i = 0; i < ROWS * CHUNKS / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / CHUNKS;
    const int col = (c % CHUNKS) * 16;
    if (n_rows == ROWS || r < n_rows) cp_async16(tile + r * ROW + col, rows + r * stride + col, 16);
  }
}

// acc[m][16 x 8NT] += A[row0 + 16m .. + 16) . B[0 .. 8NT)^T over DH, bf16,
// for MT tiles of 16 rows that share every B fragment: A and B are tiles of
// row stride ROW with the depth contiguous. The A fragment of a k-step is
// rows row0 + 16m + (lane & 15), bytes (lane >> 4) * 16 of the slice; the
// B fragments of n-tiles 2nj, 2nj + 1 are rows nj * 16 + (lane & 7) +
// (lane >> 4) * 8, bytes ((lane >> 3) & 1) * 16.
template <int DH, int ROW, int MT, int NT>
__device__ __forceinline__ void rows_x_rows_m(float (&acc)[MT][NT][4], const uint8_t* a_tile,
                                              int row0, const uint8_t* b_tile, int lane) {
  constexpr int KSTEPS = DH * 2 / 32;
  const uint8_t* a_rows = a_tile + (row0 + (lane & 15)) * ROW + (lane >> 4) * 16;
  const uint8_t* b_rows = b_tile + ((lane & 7) + (lane >> 4) * 8) * ROW + ((lane >> 3) & 1) * 16;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    uint32_t a[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) ldmatrix_x4(a[m], a_rows + m * 16 * ROW + kk * 32);
#pragma unroll
    for (int nj = 0; nj < NT / 2; ++nj) {
      uint32_t b[4];
      ldmatrix_x4(b, b_rows + nj * 16 * ROW + kk * 32);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        Bf16Product::mma(acc[m][2 * nj], a[m], b[0], b[1]);
        Bf16Product::mma(acc[m][2 * nj + 1], a[m], b[2], b[3]);
      }
    }
  }
}

// acc[16 x 64] += A[row0 .. row0 + 16) . B[0 .. 64)^T: the backward's one tile.
template <int DH, int ROW>
__device__ __forceinline__ void rows_x_rows(float (&acc)[8][4], const uint8_t* a_tile, int row0,
                                            const uint8_t* b_tile, int lane) {
  rows_x_rows_m<DH, ROW, 1, 8>(*reinterpret_cast<float(*)[1][8][4]>(&acc), a_tile, row0, b_tile,
                               lane);
}

// out[m][16 x DH] += X[m][16 x DEPTH] . B[DEPTH x DH], bf16, for MT tiles of
// 16 rows that share every B fragment: X in the m16n8 accumulator layout
// (x[m][j][e]: row g + (e >> 1) * 8, column j * 8 + 2t + (e & 1)), B a tile
// of row stride ROW whose DEPTH rows are the depth. n-tiles 2c and 2c + 1
// of X, rounded to bf16, are exactly the A fragment of k16 chunk c, and B^T
// comes by ldmatrix.trans.
template <int DH, int ROW, int MT, int DEPTH>
__device__ __forceinline__ void acc_x_tile_m(float (&out)[MT][DH / 8][4],
                                             const float (&x)[MT][DEPTH / 8][4],
                                             const uint8_t* b_tile, int lane) {
  uint32_t xf[MT][DEPTH / 16][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < DEPTH / 8; ++j) {
      xf[m][j >> 1][(j & 1) * 2] = pack_bf16(x[m][j][0], x[m][j][1]);
      xf[m][j >> 1][(j & 1) * 2 + 1] = pack_bf16(x[m][j][2], x[m][j][3]);
    }
#pragma unroll
  for (int c = 0; c < DEPTH / 16; ++c)
#pragma unroll
    for (int np = 0; np < DH / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, b_tile + (c * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ROW +
                               (np * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        Bf16Product::mma(out[m][2 * np], xf[m][c], b[0], b[1]);
        Bf16Product::mma(out[m][2 * np + 1], xf[m][c], b[2], b[3]);
      }
    }
}

// out[16 x DH] += X[16 x 64] . B[64 x DH]: the backward's one tile.
template <int DH, int ROW>
__device__ __forceinline__ void acc_x_tile(float (&out)[DH / 8][4], const float (&x)[8][4],
                                           const uint8_t* b_tile, int lane) {
  acc_x_tile_m<DH, ROW, 1, 64>(*reinterpret_cast<float(*)[1][DH / 8][4]>(&out),
                               *reinterpret_cast<const float(*)[1][8][4]>(&x), b_tile, lane);
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

// ---------------------------------------------------------------------
// The f32 kernels' blocks: eight warps over F32_ROWS fixed rows, the other
// operands streamed as 32-row tiles that are split once into tf32 hi and lo
// tiles in shared memory (flash_attention_bwd.cu's note; the forward takes
// the same staging).

constexpr int F32_ROWS = 128;     // fixed rows of a block: queries or keys
constexpr int F32_THREADS = 256;  // eight warps of 16 rows
constexpr int STREAM_ROWS = 32;   // rows of a streamed tile

// Shared memory of an f32 block: FIXED_TILES fixed tiles of F32_ROWS rows
// (the forward's Q; K and V in dk/dv, Q and dO in dq), the copies of a
// streamed pair of 32-row tiles (K and V, or Q and dO), their tf32 hi and
// lo tiles, and per streamed tile, in two buffers, its rows' lse, di and
// segment ids (the forward and dq read the ids only).
template <int DH, int FIXED_TILES = 2>
struct F32Shape {
  static constexpr int FIXED = F32_ROWS * DH * 4;
  static constexpr int STREAM = STREAM_ROWS * DH * 4;
  static constexpr int RAW = FIXED_TILES * FIXED;      // two streamed copies
  static constexpr int SPLIT = RAW + 2 * STREAM;       // hi, lo of each
  static constexpr int ROWS = SPLIT + 4 * STREAM;      // [2][lse, di, seg][32]
  static constexpr int BYTES = ROWS + 2 * 3 * STREAM_ROWS * 4;
  static_assert(BYTES <= 232448, "an f32 block exceeds shared memory");
};

// 4-byte async copy (lse, di and segment ids need no more than their own
// alignment).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// The streamed pair of one iteration: both 32-row tiles by cp.async (the
// rows of tile `first` and of `second`, row stride `stride` bytes) and the
// staged values of its rows into buffer buf: lse and di (when lse is not
// null; rows [lse_row, +32) of [B, NQ, T]) and the segment ids from seg.
template <int DH, int FIXED_TILES = 2>
__device__ __forceinline__ void load_stream(uint8_t* smem, const uint8_t* first,
                                            const uint8_t* second, long long stride,
                                            const float* lse, const float* di,
                                            long long lse_row, const int* seg, int buf,
                                            int tid) {
  using S = F32Shape<DH, FIXED_TILES>;
  load_rows_f32<DH, STREAM_ROWS, F32_THREADS>(smem + S::RAW, first, stride, STREAM_ROWS, tid);
  load_rows_f32<DH, STREAM_ROWS, F32_THREADS>(smem + S::RAW + S::STREAM, second, stride,
                                             STREAM_ROWS, tid);
  float* rows = reinterpret_cast<float*>(smem + S::ROWS) + buf * 3 * STREAM_ROWS;
  const int r = tid % STREAM_ROWS;
  if (tid < STREAM_ROWS) {
    cp_async4(rows + 2 * STREAM_ROWS + r, seg + r);
  } else if (lse != nullptr && tid < 3 * STREAM_ROWS) {
    const bool is_lse = tid < 2 * STREAM_ROWS;
    cp_async4(rows + (is_lse ? 0 : STREAM_ROWS) + r, (is_lse ? lse : di) + lse_row + r);
  }
}

// The top of every iteration: waits for this thread's copies of the
// streamed pair, and, once no warp reads the hi and lo tiles of the last
// pair any more, splits its own chunks of this pair into them.
template <int DH, int FIXED_TILES = 2>
__device__ __forceinline__ void split_stream(uint8_t* smem, int tid) {
  using S = F32Shape<DH, FIXED_TILES>;
  cp_async_wait_all();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    split_rows_f32<DH, STREAM_ROWS, F32_THREADS>(smem + S::RAW + i * S::STREAM,
                                                smem + S::SPLIT + 2 * i * S::STREAM,
                                                smem + S::SPLIT + (2 * i + 1) * S::STREAM, tid);
  }
  // The next pair's cp.async rewrites these chunks: keep the reads above it.
  asm volatile("" ::: "memory");
}

}  // namespace
}  // namespace tiles
