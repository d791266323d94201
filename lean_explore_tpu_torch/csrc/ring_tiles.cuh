// The ring-fed wgmma block of the retrieval kernels K1, K2 and K3 on Hopper
// (bin_topk.cu, bin_topk_int8.cu and windowed_scores.cu), over a bf16
// corpus (wgmma m64n128k16), an int8 one (m64n128k32 s8, K2 only) and a
// float32 one (3xTF32 on wgmma m64n128k8).
//
// The kernels multiply a corpus [N, D] by queries [B, D], both with the
// depth contiguous (K-major, the layout wgmma takes from shared memory for
// every type, and the only one it takes for 8-bit types). A block is two
// consumer warpgroups and one producer warp. The producer's lane 0 fills a
// ring of stages in dynamic shared memory with TMA tile copies in the
// 128-byte swizzle (tma_ring.cuh); a stage is 128 bytes of depth (64 bf16,
// 128 int8 or 32 f32 values) of the block's 128 corpus rows and of its 128
// queries: one query box in bf16 and int8 (32 KB a stage), the hi and the
// lo halves of the queries in f32 (48 KB). Each warpgroup owns 64 of the
// corpus rows and holds their 64 x 128 accumulator (64 registers a thread:
// f32, or s32 for int8). The block, the ring, its fill and drain are one
// template over the number of query boxes; only the stage's products
// differ. In bf16 the corpus stream bounds both kernels (on an NVIDIA H100
// 80GB HBM3 at 700 W the carry reads it at 2.8 TB/s, the windowed kernel at
// 3.05 TB/s beside its stores); in int8 the products and the fold, which
// comes every 8 stages, outlast the stream of half the bytes by about a
// sixth; in f32 the three products and the stream together (bin_topk.cu,
// bin_topk_int8.cu, windowed_scores.cu, PERF.md).
//
// bf16 and int8. Four wgmma a stage, each 32 bytes deep (m64n128k16 bf16,
// m64n128k32 s8), the depth in ascending order, A (the group's 64 corpus
// rows) and B (the queries) both K-major by descriptor; the descriptors of
// the two types are the same, and so is their advance of 32 bytes a step
// (A loaded into registers by ldmatrix measured no different in bf16:
// scripts/time_bf16_variants.py). A wgmma bf16 k16 step adds as mma.sync
// m16n8k16 does (scripts/compare_torch_kernel_builds.py holds the kernels
// to the mma.sync kernels before them bit for bit), so the carry and the
// scores kept their bits when the kernels moved to wgmma. K4
// (bin_topk_pipelined.cu) runs K1's carry kernel at another ring depth,
// which changes no sum, so it equals K1.
// The int8 products are exact integers in s32, whatever the order of the
// sums, so K2's raw sums are those of any exact product.
//
// f32 (3xTF32). x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), both
// rounded to nearest (`cvt.rna`), and lo*hi + hi*lo + hi*hi summed
// (mma_tiles.cuh, F32Product; the bound in ops/bin_topk.py). A small
// prologue (`split_tf32_kernel`) splits the queries once a launch into f32
// bit patterns whose low 13 bits are zero, so that wgmma reads them from
// shared memory exactly. The corpus is split in registers, once on its one
// pass through the SM: each warp loads its 16 rows of a stage with ldmatrix
// (whose four 8 x 4 f32 matrices are the m16n8k8 tf32 A fragment) and
// splits them; A then comes from registers, B (the query halves) from
// shared memory. For each k8 step the three products are issued in
// F32Product::mma3's order (the mma.sync kernels' before them): acc +=
// A_lo q_hi, acc += A_hi q_lo, acc += A_hi q_hi. A wgmma tf32 k8 step adds
// as mma.sync m16n8k8 does, so these kernels too keep the mma.sync
// kernels' bits.
//
// The ring. A stage's TMA copies complete on its full mbarrier (expect_tx of
// the whole stage: rows outside a tensor map are zero-filled and counted).
// A warp arrives on the stage's empty mbarrier once its wgmma group has been
// waited for; its ldmatrix reads are generic-proxy reads of memory the next
// TMA refill writes through the async proxy, so each thread fences
// (`fence_proxy_async_shared`, tma_ring.cuh) before the arrive: without it
// a ring refilled stages under a warp's last reads (K4's mma.sync kernel
// before it moved onto this block, whose consumers read every stage with
// ldmatrix). A stage read by wgmma descriptors alone is read through the
// async proxy, as the refill writes it. No __syncthreads() runs inside the loop.

#pragma once

#include "flash_tiles.cuh"
#include "tma_ring.cuh"

namespace tiles {
namespace {  // the header's internal namespace, reopened

constexpr int RING_GROUPS = 2;                            // consumer warpgroups a block
constexpr int RING_CONSUMER_WARPS = 4 * RING_GROUPS;      // the producer is the next warp
constexpr int RING_THREADS = 32 * RING_CONSUMER_WARPS + 32;
constexpr int RING_ROWS = 64 * RING_GROUPS;               // corpus rows of a block
constexpr int RING_QUERIES = 128;                         // queries of a block (wgmma N)
constexpr int RING_ACC = RING_QUERIES / 2;                // accumulators a thread
constexpr int CORPUS_BOX = RING_ROWS * STAGE_BYTES;       // 16 KB
constexpr int QUERY_BOX = RING_QUERIES * STAGE_BYTES;     // 16 KB

// x = hi + lo in tf32 bit patterns (low 13 bits zero), both rounded to
// nearest: F32Product::split, once for each query value of a launch.
__global__ void split_tf32_kernel(const float* __restrict__ x, float* __restrict__ hi,
                                  float* __restrict__ lo, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float v = x[i];
    const uint32_t h = F32Product::to_tf32(v);
    hi[i] = __uint_as_float(h);
    lo[i] = __uint_as_float(F32Product::to_tf32(v - __uint_as_float(h)));
  }
}

// The 64 accumulator registers of an m64n128 wgmma: the operand list and
// the matching constraints ("+f" for f32, "+r" for s32).
#define ACC128_REGS                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "   \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "    \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "    \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define ACC128_CONSTRAINED(c, d)                                                       \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), c(d[8]),     \
      c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15]), c(d[16]),   \
      c(d[17]), c(d[18]), c(d[19]), c(d[20]), c(d[21]), c(d[22]), c(d[23]), c(d[24]),  \
      c(d[25]), c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31]), c(d[32]),  \
      c(d[33]), c(d[34]), c(d[35]), c(d[36]), c(d[37]), c(d[38]), c(d[39]), c(d[40]),  \
      c(d[41]), c(d[42]), c(d[43]), c(d[44]), c(d[45]), c(d[46]), c(d[47]), c(d[48]),  \
      c(d[49]), c(d[50]), c(d[51]), c(d[52]), c(d[53]), c(d[54]), c(d[55]), c(d[56]),  \
      c(d[57]), c(d[58]), c(d[59]), c(d[60]), c(d[61]), c(d[62]), c(d[63])
#define ACC128_OPERANDS(d) ACC128_CONSTRAINED("+f", d)

// D[64 x 128] += A[64 x 8] . B[128 x 8]^T in tf32 with f32 sums: A from
// registers (warp w of the group holds rows 16w .. 16w + 15 in the m16n8k8
// tf32 A layout) or from a descriptor, B from a K-major swizzled tile.
// Warp w holds rows 16w .. of D in the m16n8 accumulator layout, d[4j + e]
// = row g + 8 (e >> 1), column 8j + 2t + (e & 1) (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " ACC128_REGS
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : ACC128_OPERANDS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " ACC128_REGS
      ", %64, %65, p, 1, 1;\n}\n"
      : ACC128_OPERANDS(d)
      : "l"(a), "l"(b));
}

// The same in bf16, a k16 step: D[64 x 128] += A[64 x 16] . B[128 x 16]^T,
// both K-major from swizzled tiles (wgmma_ss<32>'s form at N = 128).
template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ACC128_REGS
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC128_OPERANDS(d)
      : "l"(a), "l"(b));
}

// The same in int8, a k32 step (32 bytes deep, as a bf16 k16 step is):
// D[64 x 128] += A[64 x 32] . B[128 x 32]^T in s8 with exact s32 sums, both
// K-major from swizzled tiles, D in the same register layout.
template <int N>
__device__ __forceinline__ void wgmma_ss(int32_t (&d)[N / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<128>(int32_t (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " ACC128_REGS
      ", %64, %65, p;\n}\n"
      : ACC128_CONSTRAINED("+r", d)
      : "l"(a), "l"(b));
}

#undef ACC128_REGS
#undef ACC128_OPERANDS
#undef ACC128_CONSTRAINED

// A ring of n stages of the corpus box and QUERY_BOXES query boxes (1 for
// bf16 and int8, 2 for the f32 halves): the stages from the first 1024-byte
// boundary of the block's dynamic shared memory, then n full and n empty
// mbarriers, then the kernel's other shared memory.
template <int QUERY_BOXES>
struct RowRing {
  static constexpr int STAGE = CORPUS_BOX + QUERY_BOXES * QUERY_BOX;

  // Dynamic shared memory of an n-stage ring and `extra` bytes after its
  // barriers, with the slack that lets the ring start on a 1024-byte boundary.
  static constexpr int smem_bytes(int n_stages, int extra) {
    return n_stages * (STAGE + 2 * (int)sizeof(uint64_t)) + extra + 1024;
  }

  uint8_t* stages;
  uint64_t* full;
  uint64_t* empty;
  int n;

  __device__ RowRing(uint8_t* smem, int n_stages)
      : stages(align_1024(smem)),
        full(reinterpret_cast<uint64_t*>(stages + n_stages * STAGE)),
        empty(full + n_stages),
        n(n_stages) {}

  __device__ uint8_t* stage(int s) const { return stages + s * STAGE; }
  __device__ uint8_t* after() const { return reinterpret_cast<uint8_t*>(empty + n); }

  // Thread 0 sets up the barriers; a __syncthreads() must follow.
  __device__ void init(int tid) const {
    if (tid == 0) {
      for (int s = 0; s < n; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], RING_CONSUMER_WARPS);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
};

using OneBoxRing = RowRing<1>;  // bf16 and int8
using Tf32Ring = RowRing<2>;

// A position in the ring: the slot and the parity of its current pass.
struct RingSlot {
  int slot = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance(int n) {
    if (++slot == n) {
      slot = 0;
      phase ^= 1u;
    }
  }
};

// The producer's copies into the ring's next slot, once the consumers have
// released its last use (on the first pass the parity of the phase before
// phase 0 passes at once): depth bytes [k0, k0 + 128) of corpus rows
// [row0, row0 + RING_ROWS) and of query rows [q0, q0 + RING_QUERIES) of
// `queries` (bf16, int8) or of q_hi and q_lo (f32).
template <int QUERY_BOXES>
__device__ __forceinline__ void ring_fill(const RowRing<QUERY_BOXES>& ring, RingSlot& at,
                                          const CUtensorMap* corpus, const CUtensorMap* queries,
                                          const CUtensorMap* q_lo, int k0, int row0, int q0) {
  mbar_wait(&ring.empty[at.slot], at.phase ^ 1u);
  uint8_t* stage = ring.stage(at.slot);
  uint64_t* full = &ring.full[at.slot];
  mbar_arrive_expect_tx(full, RowRing<QUERY_BOXES>::STAGE);
  tma_load(stage, corpus, k0, row0, full);
  tma_load(stage + CORPUS_BOX, queries, k0, q0, full);
  if constexpr (QUERY_BOXES == 2) tma_load(stage + CORPUS_BOX + QUERY_BOX, q_lo, k0, q0, full);
  at.advance(ring.n);
}

// The producer's last waits: every stage released, so no copy into this
// block's shared memory is in flight when it exits.
template <int QUERY_BOXES>
__device__ __forceinline__ void ring_drain(const RowRing<QUERY_BOXES>& ring, RingSlot& at) {
  for (int i = 0; i < ring.n; ++i) {
    mbar_wait(&ring.empty[at.slot], at.phase ^ 1u);
    at.advance(ring.n);
  }
}

// Releases the ring's current slot to the producer (a warp's arrive, once
// its lanes are done with the slot) and moves on.
template <int QUERY_BOXES>
__device__ __forceinline__ void ring_release(const RowRing<QUERY_BOXES>& ring, RingSlot& at,
                                             int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(&ring.empty[at.slot]);
  at.advance(ring.n);
}

// One stage of a consumer warpgroup over a one-box ring: waits for the
// ring's next slot, adds its four 32-byte-deep products to acc in ascending
// depth (bf16 k16 into f32, or int8 k32 into s32: wgmma_ss<128> of acc's
// type; A = the group's 64 corpus rows, B = the 128 query rows, both by
// descriptor), waits for them and releases the slot.
template <class Acc>
__device__ __forceinline__ void one_box_stage(Acc (&acc)[RING_ACC], const OneBoxRing& ring,
                                              RingSlot& at, int warp, int lane) {
  mbar_wait(&ring.full[at.slot], at.phase);
  const uint8_t* stage = ring.stage(at.slot);
  const uint64_t q = wgmma_desc(stage + CORPUS_BOX, 16, 1024);
  const uint64_t a = wgmma_desc(stage + (warp >> 2) * 64 * STAGE_BYTES, 16, 1024);
  fence_operands(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss<128>(acc, a + 2 * kk, q + 2 * kk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(acc);
  ring_release(ring, at, lane);
}

// One stage of a consumer warpgroup over an f32 ring: waits for the ring's
// next slot, adds its products to acc (A = the group's 64 corpus rows,
// split once here, B = the 128 query rows, 3xTF32 in K1's order per k8
// step), waits for them and releases the slot. SPLIT_EACH_STEP splits each
// k8 slice just before its products, so that they run while the next slice
// is split; otherwise the whole stage is split first. The order of the
// products is the same, and so are their bits; the time is not
// (scripts/time_tf32_variants.py, PERF.md: the windowed kernel is faster
// split step by step, the carry kernel split first).
template <bool SPLIT_EACH_STEP>
__device__ __forceinline__ void tf32_stage(float (&acc)[RING_ACC], const Tf32Ring& ring,
                                           RingSlot& at, int warp, int lane) {
  mbar_wait(&ring.full[at.slot], at.phase);
  const uint8_t* stage = ring.stage(at.slot);
  const int r = (warp >> 2) * 64 + (warp & 3) * 16 + (lane & 15);
  uint32_t raw[4][4], hi[4][4], lo[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    ldmatrix_x4(raw[kk], stage + swizzled<RING_ROWS>(r, 2 * kk + (lane >> 4)));
    if constexpr (!SPLIT_EACH_STEP) F32Product::split(raw[kk], hi[kk], lo[kk]);
  }
  const uint64_t q_hi = wgmma_desc(stage + CORPUS_BOX, 16, 1024);
  const uint64_t q_lo = wgmma_desc(stage + CORPUS_BOX + QUERY_BOX, 16, 1024);
  fence_operands(acc);
  if constexpr (!SPLIT_EACH_STEP) wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (SPLIT_EACH_STEP) {
      F32Product::split(raw[kk], hi[kk], lo[kk]);
      wgmma_fence();  // hi and lo were written outside wgmma
    }
    wgmma_tf32_rs(acc, lo[kk], q_hi + 2 * kk);
    wgmma_tf32_rs(acc, hi[kk], q_lo + 2 * kk);
    wgmma_tf32_rs(acc, hi[kk], q_hi + 2 * kk);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(acc);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    fence_operands(hi[kk]);
    fence_operands(lo[kk]);
  }
  // The slot's refill is an async-proxy write: fence the ldmatrix reads.
  fence_proxy_async_shared();
  ring_release(ring, at, lane);
}

// The stage of each element type, the parameter of the kernels' templates
// (ring_carry.cuh, windowed_scores.cu): its ring, its accumulator type, a
// consumer warpgroup's step over the ring's next slot and, where SCALED,
// the score of an accumulator (else the accumulator itself).
struct Bf16Stage {
  using Ring = OneBoxRing;
  using Acc = float;
  static constexpr int ELEMENT_BYTES = 2;
  static constexpr bool SCALED = false;
  __device__ static void step(float (&acc)[RING_ACC], const Ring& ring, RingSlot& at, int warp,
                              int lane) {
    one_box_stage(acc, ring, at, warp, lane);
  }
};

// int8 codes with per-row scales (K2): the score of an exact s32 sum is
// (f32(raw) * row_scale) * query_scale, each step rounded on its own, the
// order of the TPU kernel (pallas_retrieval.py:286-288). nvcc would
// otherwise contract a multiply and the packing's + 3 into one FMA, whose
// bits the plain twin (ops/bin_topk_int8.py) does not give. |raw| <=
// 127^2 * D stays below 2^24 for D <= 1024, so the conversion is exact.
struct Int8Stage {
  using Ring = OneBoxRing;
  using Acc = int32_t;
  static constexpr int ELEMENT_BYTES = 1;
  static constexpr bool SCALED = true;
  __device__ static void step(int32_t (&acc)[RING_ACC], const Ring& ring, RingSlot& at,
                              int warp, int lane) {
    one_box_stage(acc, ring, at, warp, lane);
  }
  __device__ static __forceinline__ float score(int32_t raw, float row_scale,
                                                float query_scale) {
    return __fmul_rn(__fmul_rn(__int2float_rn(raw), row_scale), query_scale);
  }
};

template <bool SPLIT_EACH_STEP>
struct Tf32Stage {
  using Ring = Tf32Ring;
  using Acc = float;
  static constexpr int ELEMENT_BYTES = 4;
  static constexpr bool SCALED = false;
  __device__ static void step(float (&acc)[RING_ACC], const Ring& ring, RingSlot& at, int warp,
                              int lane) {
    tf32_stage<SPLIT_EACH_STEP>(acc, ring, at, warp, lane);
  }
};

// Row (of the warpgroup's 64) and query column (of the block's 128) of
// accumulator i of this thread.
__device__ __forceinline__ int acc_row(int warp, int lane, int i) {
  return (warp & 3) * 16 + (lane >> 2) + ((i >> 1) & 1) * 8;
}

__device__ __forceinline__ int acc_col(int lane, int i) {
  return (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
}

template <class Acc>
__device__ __forceinline__ void zero_acc(Acc (&x)[RING_ACC]) {
#pragma unroll
  for (int i = 0; i < RING_ACC; ++i) x[i] = 0;
}

// The tensor maps of a launch: the corpus in boxes of RING_ROWS rows and
// the queries (bf16, int8) or their tf32 halves (f32) in boxes of
// RING_QUERIES rows, all 128 bytes deep.
struct RingMaps {
  CUtensorMap corpus, queries, q_lo;
};

// The maps of a one-box launch (bf16 or int8) over rows of `row_bytes`;
// false when one cannot be made.
inline bool one_box_maps(const void* q, const void* corpus, int B, int N, int row_bytes,
                         RingMaps& maps) {
  return encode_rows(&maps.corpus, corpus, N, row_bytes, RING_ROWS) &&
         encode_rows(&maps.queries, q, B, row_bytes, RING_QUERIES);
}

// An f32 launch's maps and the query split: q_hi and q_lo are the halves of
// `q_split` [2, B, D], written by split_tf32_kernel. Returns
// cudaErrorInvalidValue when a map cannot be made, else the launch's error.
inline int tf32_prologue(const void* q, void* q_split, const void* corpus, int B, int N, int D,
                         RingMaps& maps, cudaStream_t s) {
  float* hi = static_cast<float*>(q_split);
  float* lo = hi + (long long)B * D;
  if (!encode_rows(&maps.corpus, corpus, N, D * 4, RING_ROWS) ||
      !encode_rows(&maps.queries, hi, B, D * 4, RING_QUERIES) ||
      !encode_rows(&maps.q_lo, lo, B, D * 4, RING_QUERIES)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = (long long)B * D;
  const long long wanted = (n + 255) / 256;
  const int blocks = (int)(wanted < 1024 ? wanted : 1024);
  split_tf32_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(q), hi, lo, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace tiles
