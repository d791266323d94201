"""K1's bin-max top-k fed by a ring of ``n_buffers`` asynchronous copies (the
Hopper port of pallas_bin_topk_pipelined).

Replaces ``pallas_bin_topk_pipelined`` / ``_bin_topk_pipelined_kernel``
(lean_explore_tpu/ops/pallas_retrieval.py:571 and :502): on the TPU, K1
(``pallas_bin_topk``) with the grid's automatic pipeline replaced by
explicit async copies of the corpus from HBM into ``n_buffers`` VMEM slots,
each guarded by a DMA semaphore. Its carry is K1's, bit for bit.

On Hopper K1 already is that kernel: a producer warp keeps a ring of TMA
tile copies in shared memory, guarded by full and empty mbarriers, while
two warpgroups multiply with ``wgmma`` (``csrc/ring_carry.cuh``). Its ring
takes its depth at run time, so ``csrc/bin_topk_pipelined.cu`` is K1's
kernel with the ring's depth set to ``n_buffers``: the same grid, stages,
products and fold, so the same carry bit for bit (design and bound in its
header note). A float32 corpus takes K1-f32's 3xTF32 route, with the
queries split into tf32 halves once a launch into scratch this wrapper
allocates.

Kept divergence: ``n_buffers`` is bounded by one block's shared memory
(232,448 bytes), which holds the block's 64 KB carry and at most 5 bf16
stages of 32 KB or 3 float32 stages of 48 KB (``MAX_BUFFERS``). The TPU
kernel's bound is its VMEM, which holds many more slots of ``tile_rows x
D``. A deeper ring than the card holds is refused with ``ValueError``
rather than cut silently, since the depth is the function's one knob.

No path of the JAX package routes to the TPU kernel (no ``dense_topk``
method, no ``auto`` route), and none of the port routes to this one: it is
called by name.

On a CUDA tensor ``bin_topk_pipelined_carry`` launches the kernel, or
raises. On a CPU tensor it runs K1's plain twin,
``ops.bin_topk.bin_topk_carry_plain``, with ``n_buffers`` not read, as the
depth changes no result: the same function, so there is no second copy of
it here.
"""

import ctypes

import torch

from lean_explore_tpu_torch.ops import bin_topk as K
from lean_explore_tpu_torch.ops.cuda_build import load_library

# The float dtypes the kernel takes, with the entry point of each.
KERNEL_ENTRIES = {
    torch.bfloat16: "bin_topk_pipelined_carry",
    torch.float32: "bin_topk_pipelined_carry_f32",
}
# Shared memory of K1's carry block (csrc/ring_tiles.cuh RowRing::smem_bytes,
# csrc/ring_carry.cuh CARRY_SMEM): a ring stage holds the 128-row corpus
# box and one query box (bf16) or the queries' tf32 hi and lo boxes (f32),
# each 128 rows x 128 bytes, and the stage's full and empty mbarriers (8
# bytes each); after the ring, the two warpgroups' packed carries (64 KB);
# the ring starts on a 1024-byte boundary (the 128-byte swizzle's period),
# so a block asks for 1024 bytes more.
BOX_BYTES = K.RING_ROWS * K.STAGE_BYTES
QUERY_BOXES = {torch.bfloat16: 1, torch.float32: 2}
STAGE_BARRIER_BYTES = 16
CARRY_SMEM_BYTES = 2 * 64 * 128 * 4
RING_ALIGN = 1024
# Dynamic shared memory one block may use on the H100 (227 KB).
BLOCK_SMEM_LIMIT = 232_448
MIN_BUFFERS = 2
# The deepest ring whose block fits in BLOCK_SMEM_LIMIT (the kernel computes
# the same from its own constants and refuses deeper rings).
MAX_BUFFERS = {torch.bfloat16: 5, torch.float32: 3}


def ring_smem_bytes(n_buffers: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of a block with an ``n_buffers``-stage ring."""
    stage = BOX_BYTES * (1 + QUERY_BOXES[dtype]) + STAGE_BARRIER_BYTES
    return n_buffers * stage + CARRY_SMEM_BYTES + RING_ALIGN


def _configure(lib: ctypes.CDLL) -> None:
    for dtype, entry in KERNEL_ENTRIES.items():
        fn = getattr(lib, entry)
        pointers = 5 if dtype == torch.float32 else 4  # the f32 entry takes q_split
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int


def bin_topk_pipelined_carry(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    n_valid: int,
    bins: int,
    n_buffers: int = 3,
) -> torch.Tensor:
    """Packed bin-max carry [bins, B] f32 of ``queries @ corpus.T``: K1's.

    CPU tensors take ``bin_topk_carry_plain`` (``n_buffers`` has no effect
    there). CUDA tensors launch the ring kernel, which takes what K1's
    kernel takes (``queries`` [B, D] and ``corpus`` [N, D] of one dtype,
    bf16 or float32, contiguous and 16-byte aligned, N and bins multiples
    of 64, D a multiple of 64 or 32) and ``n_buffers`` from 2 to
    ``MAX_BUFFERS[dtype]`` (5 bf16, 3 float32: what a block's 227 KB of
    shared memory holds beside the carry); anything else raises.
    ``bin_topk_pipelined_carry.launches`` counts calls that launch: each
    runs the ring kernel (for float32 after the queries' split) and, when
    the super-tiles are split over groups (``ring_supertile_groups``), the
    max over the groups' partial carries.
    """
    n, dim = corpus.shape
    steal_bits = K.steal_bits_for(n, bins)
    if corpus.device.type == "cpu" and queries.device.type == "cpu":
        return K.bin_topk_carry_plain(queries, corpus, n_valid, bins, steal_bits)
    dtype = corpus.dtype
    if dtype not in KERNEL_ENTRIES:
        raise TypeError(
            f"bin_topk_pipelined kernel takes a bf16 or float32 corpus, got {dtype}"
        )
    K.check_carry_inputs(
        "bin_topk_pipelined", queries, corpus, n_valid, bins, dtype,
        K.depth_multiple(dtype),
    )
    if not MIN_BUFFERS <= n_buffers <= MAX_BUFFERS[dtype]:
        raise ValueError(
            f"bin_topk_pipelined kernel takes n_buffers in [{MIN_BUFFERS}, "
            f"{MAX_BUFFERS[dtype]}] for a {dtype} corpus (the ring stages one "
            f"block's shared memory holds), got {n_buffers}"
        )
    batch = queries.shape[0]
    lib = load_library("bin_topk_pipelined")
    _configure(lib)
    groups = K.ring_supertile_groups(corpus.device, n, batch, bins)
    out, partial, groups = K.carry_buffers(corpus, batch, bins, groups)
    scratch = K.split_scratch(queries) if dtype == torch.float32 else None
    split = [] if scratch is None else [scratch.data_ptr()]
    with torch.cuda.device(corpus.device):
        stream = torch.cuda.current_stream(corpus.device).cuda_stream
        status = getattr(lib, KERNEL_ENTRIES[dtype])(
            queries.data_ptr(),
            *split,
            corpus.data_ptr(),
            out.data_ptr(),
            partial.data_ptr() if partial is not None else None,
            batch,
            n,
            dim,
            int(n_valid),
            bins,
            steal_bits,
            groups,
            n_buffers,
            stream,
        )
    bin_topk_pipelined_carry.launches += 1
    if status != 0:
        raise RuntimeError(
            f"bin_topk_pipelined kernel launch failed: cudaError {status}"
        )
    return out


bin_topk_pipelined_carry.launches = 0


def bin_topk_pipelined(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    n_valid: int,
    *,
    k: int,
    bins: int = 4096,
    tile_rows: int = 512,
    n_buffers: int = 3,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused-selection top-k through the ring kernel: (scores [B, k] f32
    desc, rows [B, k] int32).

    ``pallas_bin_topk_pipelined``'s contract, and its defaults. It raises
    ``ValueError`` where that function does: corpus rows or ``bins`` not a
    multiple of ``tile_rows``, or ``k > bins``. ``tile_rows`` is validated
    only: the TPU kernel's slot height, while this kernel's ring stage is
    fixed at 128 rows by 128 depth bytes. Like ``pallas_bin_topk(...,
    exact_epilogue=True)``, and like the port's K1, the epilogue is an exact
    ``torch.topk`` over the carry (the TPU's default is
    ``lax.approx_max_k``). Queries are cast to the corpus dtype.
    """
    n = corpus.shape[0]
    if n % tile_rows != 0:
        raise ValueError(f"corpus rows {n} not a multiple of tile_rows {tile_rows}")
    if bins % tile_rows != 0:
        raise ValueError(f"bins {bins} not a multiple of tile_rows {tile_rows}")
    if k > bins:
        raise ValueError(f"k={k} exceeds bins={bins}")
    q = queries.to(corpus.dtype).contiguous()
    packed = bin_topk_pipelined_carry(q, corpus, n_valid, bins, n_buffers)
    return K.unpack_topk(
        packed, k=k, steal_bits=K.steal_bits_for(n, bins), bins=bins
    )
