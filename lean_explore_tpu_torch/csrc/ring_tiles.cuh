// The ring-fed wgmma block of the retrieval kernels K1 and K3 on Hopper
// (bin_topk.cu and windowed_scores.cu), over a bf16 corpus (wgmma
// m64n128k16) and a float32 one (3xTF32 on wgmma m64n128k8).
//
// Both kernels multiply a corpus [N, D] by queries [B, D], both with the
// depth contiguous (K-major, the layout wgmma takes from shared memory for
// either type). A block is two consumer warpgroups and one producer warp.
// The producer's lane 0 fills a ring of stages in dynamic shared memory
// with TMA tile copies in the 128-byte swizzle (tma_ring.cuh); a stage is
// 128 bytes of depth (64 bf16 or 32 f32 values) of the block's 128 corpus
// rows and of its 128 queries: one query box in bf16 (32 KB a stage), the
// hi and the lo halves of the queries in f32 (48 KB). Each warpgroup owns
// 64 of the corpus rows and holds their 64 x 128 f32 accumulator (64
// registers a thread). The block, the ring, its fill and drain are one
// template over the number of query boxes; only the stage's products
// differ. In bf16 the corpus stream bounds both kernels (on an NVIDIA H100
// 80GB HBM3 at 700 W the carry reads it at 2.8 TB/s, the windowed kernel at
// 3.05 TB/s beside its stores); in f32 the three products and the stream
// together (bin_topk.cu, windowed_scores.cu, PERF.md).
//
// bf16. Four m64n128k16 wgmma a stage, the depth in ascending order, A (the
// group's 64 corpus rows) and B (the queries) both K-major by descriptor
// (A loaded into registers by ldmatrix measured no different:
// scripts/time_bf16_variants.py). A wgmma bf16 k16 step adds as mma.sync
// m16n8k16 does (scripts/compare_torch_kernel_builds.py holds the kernels
// to the mma.sync kernels before them bit for bit), so the carry and the
// scores keep their bits and K4 (bin_topk_pipelined.cu) still equals K1.
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
// F32Product::mma3's order (K4's, on mma.sync): acc += A_lo q_hi, acc +=
// A_hi q_lo, acc += A_hi q_hi. A wgmma tf32 k8 step adds as mma.sync
// m16n8k8 does, so these kernels too keep the mma.sync kernels' bits.
//
// The ring. A stage's TMA copies complete on its full mbarrier (expect_tx of
// the whole stage: rows outside a tensor map are zero-filled and counted).
// A warp arrives on the stage's empty mbarrier once its wgmma group has been
// waited for; its ldmatrix reads are generic-proxy reads of memory the next
// TMA refill writes through the async proxy, so each thread fences
// (`fence_proxy_async_shared`, tma_ring.cuh) before the arrive: without it
// K4's ring refilled stages under a warp's last reads. A stage read by
// wgmma descriptors alone is read through the async proxy, as the refill
// writes it. No __syncthreads() runs inside the loop.

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
// the matching "+f" constraints.
#define ACC128_REGS                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "   \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "    \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "    \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define ACC128_OPERANDS(d)                                                                \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),     \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),          \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),       \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),       \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),       \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),       \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),       \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),       \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

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

#undef ACC128_REGS
#undef ACC128_OPERANDS

// A ring of n stages of the corpus box and QUERY_BOXES query boxes (1 for
// bf16, 2 for the f32 halves): the stages from the first 1024-byte
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

using Bf16Ring = RowRing<1>;
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
// `queries` (bf16) or of q_hi and q_lo (f32).
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

// One stage of a consumer warpgroup over a bf16 ring: waits for the ring's
// next slot, adds its four k16 products to acc in ascending depth (A = the
// group's 64 corpus rows, B = the 128 query rows, both by descriptor),
// waits for them and releases the slot.
__device__ __forceinline__ void bf16_stage(float (&acc)[RING_ACC], const Bf16Ring& ring,
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
// (bin_topk.cu, windowed_scores.cu): its ring and a consumer warpgroup's
// step over the ring's next slot.
struct Bf16Stage {
  using Ring = Bf16Ring;
  static constexpr int ELEMENT_BYTES = 2;
  __device__ static void step(float (&acc)[RING_ACC], const Ring& ring, RingSlot& at, int warp,
                              int lane) {
    bf16_stage(acc, ring, at, warp, lane);
  }
};

template <bool SPLIT_EACH_STEP>
struct Tf32Stage {
  using Ring = Tf32Ring;
  static constexpr int ELEMENT_BYTES = 4;
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

__device__ __forceinline__ void zero_acc(float (&x)[RING_ACC]) {
#pragma unroll
  for (int i = 0; i < RING_ACC; ++i) x[i] = 0.0f;
}

// The tensor maps of a launch: the corpus in boxes of RING_ROWS rows and
// the queries (bf16) or their tf32 halves (f32) in boxes of RING_QUERIES
// rows, all 128 bytes deep.
struct RingMaps {
  CUtensorMap corpus, queries, q_lo;
};

// A bf16 launch's maps; false when one cannot be made.
inline bool bf16_maps(const void* q, const void* corpus, int B, int N, int D, RingMaps& maps) {
  return encode_rows(&maps.corpus, corpus, N, D * 2, RING_ROWS) &&
         encode_rows(&maps.queries, q, B, D * 2, RING_QUERIES);
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
