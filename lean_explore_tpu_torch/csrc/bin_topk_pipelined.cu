// K1's packed bin-max carry on a ring of `n_buffers` stages, for Hopper.
//
// Replaces the TPU kernel `_bin_topk_pipelined_kernel` reached through
// `pallas_bin_topk_pipelined` (lean_explore_tpu/ops/pallas_retrieval.py:502
// and :571). On the TPU that kernel is `_bin_topk_kernel` (:214) with the
// grid's automatic pipeline replaced by a hand-driven one: the corpus stays
// in HBM and streams through `n_buffers` VMEM slots by explicit
// `make_async_copy`, each slot guarded by a DMA semaphore, and its carry is
// bit-identical to the grid kernel's.
//
// On Hopper K1 is already that kernel (bin_topk.cu): ring_carry_kernel of
// ring_carry.cuh, whose producer warp keeps a ring of TMA tile copies in
// dynamic shared memory, each stage guarded by a full and an empty
// mbarrier, while two consumer warpgroups of 64 bins multiply 128 queries
// with wgmma (bf16 m64n128k16, or 3xTF32 m64n128k8 for float32 after the
// queries' split, split_tf32_kernel) and fold each super-tile into a carry
// in shared memory. Its ring takes its depth at run time, and K1 passes a
// constant (4 stages bf16, 3 float32). So K4 here is K1's kernel with
// `n_stages = n_buffers`: the same grid (the wrapper's
// ring_supertile_groups), the same stages, the same fold. Its carry equals
// K1's bit for bit by construction: the depth of the ring changes when a
// stage is copied, never the order of a block's k steps, and the max over
// super-tiles and groups does not depend on order. The stages' reads, and
// the proxy fence that orders the float32 stage's ldmatrix reads before
// the slot's TMA refill, are ring_tiles.cuh's (its note: without such a
// fence a refill overtook a warp's last reads; the bf16 stage is read by
// wgmma descriptors, through the async proxy; stress test:
// scripts/stress_torch_pipelined.py).
//
// The depth is bounded by one block's 232,448 bytes of shared memory, by
// RowRing::smem_bytes: each stage and its two mbarriers, the 64 KB carry
// (CARRY_SMEM) and 1,024 bytes of alignment slack. A bf16 stage is 32 KB
// (a corpus box of 128 rows and a query box of 128 rows, 128 bytes deep):
// 5 stages take 230,480 bytes, 6 would take 263,264. A float32 stage is
// 48 KB (the corpus box and the queries' tf32 hi and lo boxes): 3 stages
// take 214,064 bytes, 4 would take 263,232. max_buffers computes these
// limits; the wrapper (ops/bin_topk_pipelined.py, MAX_BUFFERS) states
// them, and the entries refuse any other depth before they launch. The
// TPU kernel's limit is its VMEM; this one's is what a block holds.
//
// Bound at the serving shape (300,000 valid rows of 300,032 x 1024, B = 128,
// bins = 4096), the same work as bin_topk.cu: 616.8 MB read in bf16 (the
// corpus once, the queries and the carry), 0.1841 ms at 3.35 TB/s, against
// 78.6 GFLOP, 0.08 ms at 989 TFLOP/s; a float32 corpus reads 1,231.4 MB,
// 0.3676 ms, against 0.16 ms at the 495 TFLOP/s TF32 rate. Both are bound
// by bytes. Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): K1's
// times at K1's depths, 0.218 ms (bf16, 4 stages) and 0.70-0.76 ms
// (float32, 3 stages, 52% of its bound; the 3xTF32 products alone take
// 0.48 ms at the TF32 peak).

#include "ring_carry.cuh"

namespace tiles {
namespace {  // the headers' internal namespace, reopened

constexpr int BLOCK_SMEM = 232448;  // dynamic shared memory one block may use

// The deepest ring of Stage whose carry block fits in one block's shared memory.
template <class Stage>
constexpr int max_buffers() {
  int n = 1;
  while (Stage::Ring::smem_bytes(n + 1, carry_extra_smem<Stage>()) <= BLOCK_SMEM) ++n;
  return n;
}

static_assert(max_buffers<Bf16Stage>() == 5, "MAX_BUFFERS[bfloat16] in the wrapper");
static_assert(max_buffers<Tf32Stage<false>>() == 3, "MAX_BUFFERS[float32] in the wrapper");

template <class Stage>
constexpr bool depth_fits(int n_buffers) {
  return n_buffers >= 2 && n_buffers <= max_buffers<Stage>();
}

}  // namespace
}  // namespace tiles

extern "C" {

// Writes the packed carry [bins, B] of bf16 queries [B, D] and a bf16
// corpus [N, D] to `out` through an `n_buffers`-stage ring (2 to 5).
// `groups` and `partial` as bin_topk_carry's (the wrapper's
// ring_supertile_groups; groups * bins * B floats when groups > 1), and
// the same requirements (the wrapper checks). Returns the first CUDA error
// of the launches: cudaErrorInvalidValue, before any launch, for a depth
// out of range or a tensor map that cannot be made.
int bin_topk_pipelined_carry(const void* q, const void* corpus, void* out, void* partial,
                             int B, int N, int D, int n_valid, int bins, int steal_bits,
                             int groups, int n_buffers, void* stream) {
  tiles::RingMaps maps = {};
  if (!tiles::depth_fits<tiles::Bf16Stage>(n_buffers) ||
      !tiles::one_box_maps(q, corpus, B, N, D * 2, maps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return tiles::launch_ring_carry<tiles::Bf16Stage>(
      maps, nullptr, nullptr, out, partial, B, N, D, n_valid, bins, steal_bits, groups,
      n_buffers, static_cast<cudaStream_t>(stream));
}

// The same carry over float32 queries and corpus (3xTF32, as
// bin_topk_carry_f32, with its `q_split` scratch of 2 * B * D floats),
// through an `n_buffers`-stage ring (2 to 3). Requires D % 32 == 0.
int bin_topk_pipelined_carry_f32(const void* q, void* q_split, const void* corpus, void* out,
                                 void* partial, int B, int N, int D, int n_valid, int bins,
                                 int steal_bits, int groups, int n_buffers, void* stream) {
  using Stage = tiles::Tf32Stage<false>;
  if (!tiles::depth_fits<Stage>(n_buffers)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  tiles::RingMaps maps;
  const int split = tiles::tf32_prologue(q, q_split, corpus, B, N, D, maps, s);
  if (split != 0) return split;
  return tiles::launch_ring_carry<Stage>(maps, nullptr, nullptr, out, partial, B, N, D,
                                         n_valid, bins, steal_bits, groups, n_buffers, s);
}

}  // extern "C"
