// The float32 product of K1 and K3 (bin_topk.cu's and windowed_scores.cu's
// f32 entries) on Hopper: 3xTF32 on wgmma (sm_90a), fed by a TMA ring.
//
// Both kernels multiply a float32 corpus [N, D] by float32 queries [B, D],
// both with the depth contiguous (K-major, the only layout TF32 wgmma takes
// from shared memory). A block is two consumer warpgroups and one producer
// warp. The producer's lane 0 fills a ring of stages in dynamic shared
// memory with TMA tile copies in the 128-byte swizzle; a stage is 32 f32 of
// depth (128 bytes) of the block's 128 corpus rows, and of the hi and the lo
// halves of its 128 queries (48 KB). Each warpgroup owns 64 of the corpus
// rows and holds their 64 x 128 accumulator (64 registers a thread).
//
// The split. 3xTF32 writes x = hi + lo with hi = tf32(x) and lo = tf32(x -
// hi), both rounded to nearest (`cvt.rna`), and sums lo*hi + hi*lo + hi*hi
// (mma_tiles.cuh, F32Product; the bound in ops/bin_topk.py). A small
// prologue (`split_tf32_kernel`) splits the queries once a launch into
// f32 bit patterns whose low 13 bits are zero, so that wgmma reads them from
// shared memory exactly. The corpus is split in registers, once on its one
// pass through the SM: each warp loads its 16 rows of a stage with ldmatrix
// (whose four 8 x 4 f32 matrices are the m16n8k8 tf32 A fragment, the
// register layout of wgmma's A) and splits them; A then comes from
// registers, B (the query halves) from shared memory.
//
// The order. For each k8 step the three products are issued in
// F32Product::mma3's order (K4's, on mma.sync): acc += A_lo q_hi, acc +=
// A_hi q_lo, acc += A_hi q_hi, each an m64n128k8 wgmma. A wgmma tf32 k8 step
// adds as mma.sync m16n8k8 does, so the carry and the scores have the bits
// of the mma.sync kernels.
//
// The ring. A stage's TMA copies complete on its full mbarrier (expect_tx of
// the whole stage: rows outside a tensor map are zero-filled and counted).
// A warp arrives on the stage's empty mbarrier once its wgmma group has been
// waited for; its ldmatrix reads are generic-proxy reads of memory the next
// TMA refill writes through the async proxy, so each thread fences
// (`fence_proxy_async_shared`, tma_ring.cuh) before the arrive: without it
// K4's ring refilled stages under a warp's last reads. No __syncthreads()
// runs inside the loop.

#pragma once

#include "flash_tiles.cuh"
#include "tma_ring.cuh"

namespace tiles {
namespace {  // the header's internal namespace, reopened

constexpr int TF32_GROUPS = 2;                            // consumer warpgroups a block
constexpr int TF32_CONSUMER_WARPS = 4 * TF32_GROUPS;      // the producer is the next warp
constexpr int TF32_THREADS = 32 * TF32_CONSUMER_WARPS + 32;
constexpr int TF32_ROWS = 64 * TF32_GROUPS;               // corpus rows of a block
constexpr int TF32_QUERIES = 128;                         // queries of a block (wgmma N)
constexpr int TF32_ACC = TF32_QUERIES / 2;                // accumulators a thread
constexpr int CORPUS_BOX = TF32_ROWS * STAGE_BYTES;       // 16 KB
constexpr int QUERY_BOX = TF32_QUERIES * STAGE_BYTES;     // 16 KB
constexpr int TF32_STAGE = CORPUS_BOX + 2 * QUERY_BOX;    // corpus, q_hi, q_lo

// Dynamic shared memory of an n-stage ring and `extra` bytes after its
// barriers, with the slack that lets the ring start on a 1024-byte boundary.
constexpr int tf32_smem_bytes(int n_stages, int extra) {
  return n_stages * (TF32_STAGE + 2 * (int)sizeof(uint64_t)) + extra + 1024;
}

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

// D[64 x 128] += A[64 x 8] . B[128 x 8]^T in tf32 with f32 sums: A from
// registers (warp w of the group holds rows 16w .. 16w + 15 in the m16n8k8
// tf32 A layout) or from a descriptor, B from a K-major swizzled tile.
// Warp w holds rows 16w .. of D in the m16n8 accumulator layout, d[4j + e]
// = row g + 8 (e >> 1), column 8j + 2t + (e & 1) (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b));
}

// A ring of n stages: the stages from the first 1024-byte boundary of the
// block's dynamic shared memory, then n full and n empty mbarriers, then
// the kernel's other shared memory.
struct Tf32Ring {
  uint8_t* stages;
  uint64_t* full;
  uint64_t* empty;
  int n;

  __device__ Tf32Ring(uint8_t* smem, int n_stages)
      : stages(align_1024(smem)),
        full(reinterpret_cast<uint64_t*>(stages + n_stages * TF32_STAGE)),
        empty(full + n_stages),
        n(n_stages) {}

  __device__ uint8_t* stage(int s) const { return stages + s * TF32_STAGE; }
  __device__ uint8_t* after() const { return reinterpret_cast<uint8_t*>(empty + n); }

  // Thread 0 sets up the barriers; a __syncthreads() must follow.
  __device__ void init(int tid) const {
    if (tid == 0) {
      for (int s = 0; s < n; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], TF32_CONSUMER_WARPS);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
};

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
// [row0, row0 + TF32_ROWS) and of query rows [q0, q0 + TF32_QUERIES) of
// q_hi and q_lo.
__device__ __forceinline__ void tf32_fill(const Tf32Ring& ring, RingSlot& at,
                                          const CUtensorMap* corpus, const CUtensorMap* q_hi,
                                          const CUtensorMap* q_lo, int k0, int row0, int q0) {
  mbar_wait(&ring.empty[at.slot], at.phase ^ 1u);
  uint8_t* stage = ring.stage(at.slot);
  uint64_t* full = &ring.full[at.slot];
  mbar_arrive_expect_tx(full, TF32_STAGE);
  tma_load(stage, corpus, k0, row0, full);
  tma_load(stage + CORPUS_BOX, q_hi, k0, q0, full);
  tma_load(stage + CORPUS_BOX + QUERY_BOX, q_lo, k0, q0, full);
  at.advance(ring.n);
}

// The producer's last waits: every stage released, so no copy into this
// block's shared memory is in flight when it exits.
__device__ __forceinline__ void tf32_drain(const Tf32Ring& ring, RingSlot& at) {
  for (int i = 0; i < ring.n; ++i) {
    mbar_wait(&ring.empty[at.slot], at.phase ^ 1u);
    at.advance(ring.n);
  }
}

// One stage of a consumer warpgroup: waits for the ring's next slot, adds
// its products to acc (A = the group's 64 corpus rows, split once here, B =
// the 128 query rows, 3xTF32 in K1's order per k8 step), waits for them and
// releases the slot. SPLIT_EACH_STEP splits each k8 slice just before its
// products, so that they run while the next slice is split; otherwise the
// whole stage is split first. The order of the products is the same, and
// so are their bits; the time is not (scripts/time_tf32_variants.py, PERF.md:
// the windowed kernel is faster split step by step, the carry kernel split
// first).
template <bool SPLIT_EACH_STEP>
__device__ __forceinline__ void tf32_stage(float (&acc)[TF32_ACC], const Tf32Ring& ring,
                                           RingSlot& at, int warp, int lane) {
  mbar_wait(&ring.full[at.slot], at.phase);
  const uint8_t* stage = ring.stage(at.slot);
  const int r = (warp >> 2) * 64 + (warp & 3) * 16 + (lane & 15);
  uint32_t raw[4][4], hi[4][4], lo[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    ldmatrix_x4(raw[kk], stage + swizzled<TF32_ROWS>(r, 2 * kk + (lane >> 4)));
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
  __syncwarp();
  if (lane == 0) mbar_arrive(&ring.empty[at.slot]);
  at.advance(ring.n);
}

// Row (of the warpgroup's 64) and query column (of the block's 128) of
// accumulator i of this thread.
__device__ __forceinline__ int tf32_row(int warp, int lane, int i) {
  return (warp & 3) * 16 + (lane >> 2) + ((i >> 1) & 1) * 8;
}

__device__ __forceinline__ int tf32_col(int lane, int i) {
  return (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
}

__device__ __forceinline__ void zero_tf32(float (&x)[TF32_ACC]) {
#pragma unroll
  for (int i = 0; i < TF32_ACC; ++i) x[i] = 0.0f;
}

// A host-side launch's tensor maps and the query split: the corpus in boxes
// of TF32_ROWS rows, q_hi and q_lo (the halves of `q_split` [2, B, D]) in
// boxes of TF32_QUERIES rows, and split_tf32_kernel writing them. Returns
// cudaErrorInvalidValue when a map cannot be made, else the launch's error.
struct Tf32Maps {
  CUtensorMap corpus, q_hi, q_lo;
};

inline int tf32_prologue(const void* q, void* q_split, const void* corpus, int B, int N, int D,
                         Tf32Maps& maps, cudaStream_t s) {
  float* hi = static_cast<float*>(q_split);
  float* lo = hi + (long long)B * D;
  if (!encode_rows(&maps.corpus, corpus, N, D * 4, TF32_ROWS) ||
      !encode_rows(&maps.q_hi, hi, B, D * 4, TF32_QUERIES) ||
      !encode_rows(&maps.q_lo, lo, B, D * 4, TF32_QUERIES)) {
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
