// Tiles and fragment moves shared by the flash-attention kernels: the
// forward (flash_attention.cu) and the backward's dq and dk/dv kernels
// (flash_attention_bwd.cu).
//
// A tile is 64 rows of DH values of ELEM bytes (bf16: 2, f32: 4), copied
// from device memory by cp.async into shared memory whose rows are padded
// by 16 bytes, so that ldmatrix (8 rows of 16 bytes at a stride of 4 banks
// mod 32) is free of bank conflicts. Every product of the three kernels is
// one of two shapes over a warp's 16 rows:
//
//   rows_x_rows: acc[16 x 64] += A[16 x DH] . B[64 x DH]^T, both tiles with
//     the depth contiguous (S = Q K^T, dP = dO V^T and their transposes);
//   acc_x_tile:  out[16 x DH] += X[16 x 64] . B[64 x DH], X an accumulator
//     left in registers and B row-major over its 64 rows (O += P V,
//     dV += P^T dO, dK += dS^T Q, dQ += dS K).
//
// bf16 runs mma.sync m16n8k16 with f32 accumulation; f32 runs 3xTF32
// (F32Product of mma_tiles.cuh, m16n8k8). Each 32-byte slice of a row is
// one k-step of either, read by the same ldmatrix walk.

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
  // A backward block: two fixed tiles and two double-buffered streams, all
  // of row stride ROW, then the segment ids.
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

// acc[16 x 64] += A[row0 .. row0 + 16) . B[0 .. 64)^T over DH: A and B are
// tiles of row stride ROW with the depth contiguous. The A fragment of a
// k-step is rows row0 + (lane & 15), bytes (lane >> 4) * 16 of the slice;
// the B fragments of n-tiles 2nj, 2nj + 1 are rows nj * 16 + (lane & 7) +
// (lane >> 4) * 8, bytes ((lane >> 3) & 1) * 16.
template <int DH, int ELEM, int ROW>
__device__ __forceinline__ void rows_x_rows(float (&acc)[8][4], const uint8_t* a_tile, int row0,
                                            const uint8_t* b_tile, int lane) {
  constexpr int KSTEPS = DH * ELEM / 32;
  const uint8_t* a_rows = a_tile + (row0 + (lane & 15)) * ROW + (lane >> 4) * 16;
  const uint8_t* b_rows = b_tile + ((lane & 7) + (lane >> 4) * 8) * ROW + ((lane >> 3) & 1) * 16;
  if constexpr (ELEM == 2) {
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
  } else {
#pragma unroll 2
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t a[4], a_hi[4], a_lo[4];
      ldmatrix_x4(a, a_rows + kk * 32);
      F32Product::split(a, a_hi, a_lo);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t b[4], b_hi[4], b_lo[4];
        ldmatrix_x4(b, b_rows + nj * 16 * ROW + kk * 32);
        F32Product::split(b, b_hi, b_lo);
        F32Product::mma3(acc[2 * nj], a_hi, a_lo, b_hi[0], b_hi[1], b_lo[0], b_lo[1]);
        F32Product::mma3(acc[2 * nj + 1], a_hi, a_lo, b_hi[2], b_hi[3], b_lo[2], b_lo[3]);
      }
    }
  }
}

// out[16 x DH] += X[16 x 64] . B[64 x DH]: X in the m16n8 accumulator
// layout (x[j][e]: row g + (e >> 1) * 8, column j * 8 + 2t + (e & 1)), B a
// tile of row stride ROW whose 64 rows are the depth. bf16: n-tiles 2c and
// 2c + 1 of X, rounded to bf16, are exactly the A fragment of k16 chunk c,
// and B^T comes by ldmatrix.trans. f32: X moves to the tf32 A layout
// ((g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)) by quad shuffles, and
// B's fragments are scalar shared loads (ldmatrix.trans is 16-bit only).
template <int DH, int ELEM, int ROW>
__device__ __forceinline__ void acc_x_tile(float (&out)[DH / 8][4], const float (&x)[8][4],
                                           const uint8_t* b_tile, int lane) {
  if constexpr (ELEM == 2) {
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
  } else {
    const int g = lane >> 2;
    const int t = lane & 3;
    // Quad lanes holding the X columns 2(t/2), 2(t/2)+1 and 4 further on.
    const int src_lo = (lane & ~3) | (t >> 1);
    const int src_hi = src_lo + 2;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int src = e < 2 ? src_lo : src_hi;
        const int row = (e & 1) * 2;  // x[c][0..1]: row g, x[c][2..3]: row g + 8
        const float even = __shfl_sync(0xffffffffu, x[c][row], src);
        const float odd = __shfl_sync(0xffffffffu, x[c][row + 1], src);
        y[e] = (t & 1) ? odd : even;
      }
      const uint32_t xa[4] = {__float_as_uint(y[0]), __float_as_uint(y[1]),
                              __float_as_uint(y[2]), __float_as_uint(y[3])};
      uint32_t x_hi[4], x_lo[4];
      F32Product::split(xa, x_hi, x_lo);
      const float* b0 = reinterpret_cast<const float*>(b_tile + (c * 8 + t) * ROW) + g;
      const float* b1 = reinterpret_cast<const float*>(b_tile + (c * 8 + t + 4) * ROW) + g;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        const uint32_t bb[2] = {__float_as_uint(b0[n * 8]), __float_as_uint(b1[n * 8])};
        uint32_t b_hi[2], b_lo[2];
        F32Product::split(bb, b_hi, b_lo);
        F32Product::mma3(out[n], x_hi, x_lo, b_hi[0], b_hi[1], b_lo[0], b_lo[1]);
      }
    }
  }
}

// Writes this thread's part of a warp's 16 x DH accumulator to rows row_lo
// and row_lo + 8 of a [.., DH] output (row r at dst + r * stride elements),
// as bf16 pairs (ELEM 2) or f32 pairs (ELEM 4).
template <int DH, int ELEM>
__device__ __forceinline__ void store_rows(uint8_t* dst, long long stride, int row_lo,
                                           const float (&acc)[DH / 8][4], int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    uint8_t* row = dst + (long long)(row_lo + r * 8) * stride * ELEM;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const int col = n * 8 + t * 2;
      if constexpr (ELEM == 2) {
        *reinterpret_cast<uint32_t*>(row + col * 2) = pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
      } else {
        *reinterpret_cast<float2*>(row + col * 4) = make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
      }
    }
  }
}

}  // namespace
}  // namespace tiles
