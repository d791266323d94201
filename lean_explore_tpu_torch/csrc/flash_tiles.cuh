// Tiles and fragment moves shared by the flash-attention kernels: the
// forward (flash_attention.cu) and the backward's dq and dk/dv kernels
// (flash_attention_bwd.cu).
//
// The bf16 forward's tile is rows of DH values copied from device memory
// by cp.async into shared memory whose rows are padded by 16 bytes, so
// that ldmatrix (8 rows of 16 bytes at a stride of 4 banks mod 32) is free
// of bank conflicts. Its products are of two shapes over a warp's MT tiles
// of 16 rows, which share every B fragment:
//
//   rows_x_rows_m: acc[16 x 8NT] += A[16 x DH] . B[8NT x DH]^T, both tiles
//     with the depth contiguous (S = Q K^T);
//   acc_x_tile_m:  out[16 x DH] += X[16 x DEPTH] . B[DEPTH x DH], X an
//     accumulator left in registers and B row-major over its DEPTH rows
//     (O += P V);
//
// on mma.sync m16n8k16 with f32 accumulation. The f32 kernels run the same
// two shapes as 3xTF32 (m16n8k8) on unpadded, swizzled tiles
// (rows_x_rows_f32, acc_x_tile_f32, below), whose layout serves ldmatrix
// and the 16-byte loads of acc_x_tile_f32 alike, with the streamed tiles
// split into tf32 hi and lo once (load_stream, split_stream). The bf16
// backward runs both shapes, and their transposes, on wgmma over tiles in
// its 128-byte swizzled layout (load_swizzled, wgmma_ss, wgmma_rs_t).

#pragma once

#include <cuda_bf16.h>
#include <float.h>

#include "mma_tiles.cuh"

namespace tiles {
namespace {  // the header's internal namespace, reopened

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

// Padded rows of DH values of ELEM bytes.
template <int DH, int ELEM>
struct FlashShape {
  static constexpr int ROW = DH * ELEM + 16;
  static constexpr int CHUNKS = DH * ELEM / 16;  // 16-byte chunks per row
};

// cp.async of rows [0, n_rows) of ROWS rows of DH * ELEM bytes (row
// stride `stride` bytes) into a tile of row stride ROW, by THREADS threads;
// rows from n_rows on are left as they are. A caller that copies every row
// leaves n_rows at ROWS, and the row test folds away.
template <int DH, int ELEM, int ROW, int ROWS, int THREADS>
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
// bf16 tiles of the backward, in the 128-byte swizzled layout that wgmma's
// shared-memory descriptors read: a tile of ROWS rows of DH values is
// DH / 64 panels of 64 columns, panel p at p * ROWS * 128 bytes, row r of a
// panel at r * 128 bytes and its 16-byte chunk c (columns 8c .. 8c + 7 of
// the panel) at chunk c ^ (r & 7). A tile starts on a 1024-byte boundary,
// so the XOR is the one the hardware takes from address bits 4-6 and 7-9.
// ldmatrix reads 8 consecutive rows at one logical chunk, whose physical
// chunks all differ: no bank conflicts, plain or transposed.

// Byte offset of 16-byte chunk `chunk` (columns 8 chunk ..) of row r.
template <int ROWS>
__device__ __forceinline__ int swizzled(int r, int chunk) {
  return (chunk >> 3) * (ROWS * 128) + r * 128 + (((chunk & 7) ^ (r & 7)) << 4);
}

// Waits until at most N of this thread's cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The first 1024-byte boundary at or after p in shared memory.
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t a = smem_addr(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// cp.async of rows [0, n_rows) of ROWS rows of DH bf16 values (row stride
// `stride` bytes) into a swizzled tile, by THREADS threads; rows from
// n_rows on are left as they are.
template <int DH, int ROWS, int THREADS>
__device__ __forceinline__ void load_swizzled(uint8_t* tile, const uint8_t* rows,
                                              long long stride, int tid, int n_rows = ROWS) {
  constexpr int CHUNKS = DH / 8;
  static_assert(ROWS * CHUNKS % THREADS == 0, "a tile's chunks do not split over the threads");
#pragma unroll
  for (int i = 0; i < ROWS * CHUNKS / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / CHUNKS;
    const int ch = c % CHUNKS;
    if (n_rows == ROWS || r < n_rows) {
      cp_async16(tile + swizzled<ROWS>(r, ch), rows + r * stride + ch * 16, 16);
    }
  }
}

// ---------------------------------------------------------------------
// wgmma (sm_90a): a warpgroup of 4 warps issues one asynchronous product of
// 64 rows, D[64 x N] += A[64 x 16] . B[16 x N], bf16 -> f32, B read from
// shared memory through a descriptor, A from shared memory (wgmma_ss) or
// from registers (wgmma_rs_t). Warp w of the group holds rows 16w .. 16w +
// 15 of D in the m16n8 accumulator layout, d[4j + e] = row g + 8 (e >> 1),
// column 8j + 2t + (e & 1) (g = lane / 4, t = lane % 4), and of A in the
// m16n8k16 A layout; so an accumulator's n-tiles 2c and 2c + 1, rounded to
// bf16, are the A fragment of k16 chunk c, as with mma.sync. The
// operands are swizzled tiles (above): K-major (B's depth contiguous: the
// rows of a tile are B's columns, as in S = Q K^T) or, in wgmma_rs_t, MN-major
// (B's depth is the tile's rows: dQ += dS K). Registers of D and A must
// keep their values until the group that reads them is waited for:
// wgmma_wait and fence_operands pin them.

// The 128-byte-swizzle descriptor of a shared-memory operand at p: lbo
// and sbo in bytes, the distance between 64-column panels of a MN-major
// operand and between 8-row groups.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Makes the compiler treat x as rewritten here, so that no read of it
// moves above a wgmma_wait and its register is not reused before one.
template <int N>
__device__ __forceinline__ void fence_operands(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(x[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_operands(int32_t (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(x[i])::"memory");
}

// Writes made by this thread's generic proxy (cp.async, st.shared) visible
// to the async proxy that wgmma reads shared memory through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D[64 x N] += A . B, both from swizzled K-major tiles.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b);

// D[64 x N] += A . B, A in registers, B from a MN-major swizzled tile.
template <int N>
__device__ __forceinline__ void wgmma_rs_t(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b));
}

template <>
__device__ __forceinline__ void wgmma_rs_t<64>(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

template <>
__device__ __forceinline__ void wgmma_rs_t<128>(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
      "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// ---------------------------------------------------------------------
// The skip rule of every flash kernel: a warp (or a warpgroup) skips a
// streamed tile of 32 rows in which the mask allows no (query, key) pair
// of its own rows. The skip is exact: such a tile adds p = 0 (and so
// ds = 0) to every sum.

// Whether a warp takes a key tile of KEYS keys from k0 (its ids in kseg)
// for its ROWS queries from qw (`uniform` when all are in segment s0): not
// when no (query, key) pair of the tile is allowed. Causal alone decides for
// rows of several segments. Lane l reads keys l, l + 32, ...
template <int KEYS, int ROWS>
__device__ __forceinline__ bool takes_tile(const int* kseg, int k0, int qw, bool uniform, int s0,
                                           int lane) {
  if (k0 > qw + ROWS - 1) return false;
  bool hit = !uniform;
#pragma unroll
  for (int i = 0; i < KEYS / 32; ++i)
    hit |= kseg[lane + 32 * i] == s0 && k0 + lane + 32 * i <= qw + ROWS - 1;
  return __any_sync(0xffffffffu, hit);
}

// The segment ids of this thread's rows (row_lo + 16m + 8r of MT 16-row
// tiles) and whether the warp's rows share one, s0.
template <int MT>
__device__ __forceinline__ void row_segments(const int* seg, int row_lo, int (&qseg)[MT][2],
                                             bool& uniform, int& s0) {
  bool same = true;
  s0 = __shfl_sync(0xffffffffu, seg[row_lo], 0);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      qseg[m][r] = seg[row_lo + 16 * m + 8 * r];
      same &= qseg[m][r] == s0;
    }
  uniform = __all_sync(0xffffffffu, same);
}

// Whether the ROWS rows from r0 (a multiple of 32 of them, all before T)
// share one segment, s0 (that of row r0). Lane l reads rows l, l + 32, ...
template <int ROWS>
__device__ __forceinline__ bool rows_share_segment(const int* seg, int r0, int lane, int& s0) {
  s0 = seg[r0];
  bool same = true;
#pragma unroll
  for (int i = 0; i < ROWS / 32; ++i) same &= seg[r0 + lane + 32 * i] == s0;
  return __all_sync(0xffffffffu, same);
}

// Whether a dk/dv warp or warpgroup (ROWS keys from kw, all in segment
// s0 when `uniform`) takes the query tile of 32 rows from q0 (their ids in
// qseg): not when every query lies before kw (causal), nor, when uniform,
// when no query from kw on lies in s0. Lane l reads query l.
template <int ROWS>
__device__ __forceinline__ bool takes_query_tile(const int* qseg, int q0, int kw, bool uniform,
                                                 int s0, int lane) {
  if (q0 + 31 < kw) return false;
  const bool hit = !uniform || (qseg[lane] == s0 && q0 + lane >= kw);
  return __any_sync(0xffffffffu, hit);
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
