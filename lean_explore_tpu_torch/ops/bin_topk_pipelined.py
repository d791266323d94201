"""K1's bin-max top-k fed by a ring of asynchronous copies (the Hopper port
of pallas_bin_topk_pipelined).

Replaces ``pallas_bin_topk_pipelined`` / ``_bin_topk_pipelined_kernel``
(lean_explore_tpu/ops/pallas_retrieval.py:571 and :502): on the TPU, K1
(``pallas_bin_topk``) with the grid's automatic pipeline replaced by
explicit async copies of the corpus from HBM into ``n_buffers`` VMEM slots.
Its carry is K1's, bit for bit, and so is this one's: ``csrc/
bin_topk_pipelined.cu`` runs K1's products and fold (``mma_tiles.cuh``)
on stages that one producer warp copies into an ``n_buffers``-stage
shared-memory ring with TMA tile copies, guarded by full and empty
mbarriers (design and bound in its header note).

No path of the JAX package routes to the TPU kernel (no ``dense_topk``
method, no ``auto`` route), and none of the port routes to this one: it is
called by name.

On a CUDA tensor ``bin_topk_pipelined_carry`` launches the kernel, or
raises. On a CPU tensor it runs K1's plain twin,
``ops.bin_topk.bin_topk_carry_plain``: the same function, so there is no
second copy of it here.
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
# Shared memory of one ring stage (csrc/bin_topk_pipelined.cu): a corpus
# tile and a query tile of 64 rows x 128 bytes, and the stage's full and
# empty mbarriers (8 bytes each); the ring starts on a 1024-byte boundary
# (the 128-byte swizzle's period), so a block asks for 1024 bytes more.
STAGE_SMEM_BYTES = 2 * K.ROW_MULTIPLE * K.STAGE_BYTES + 16
RING_ALIGN = 1024
# Dynamic shared memory one block may use on the H100 (227 KB); the kernel
# refuses more stages than fit (MAX_BUFFERS there too).
BLOCK_SMEM_LIMIT = 232_448
MIN_BUFFERS = 2
MAX_BUFFERS = (BLOCK_SMEM_LIMIT - RING_ALIGN) // STAGE_SMEM_BYTES


def ring_smem_bytes(n_buffers: int) -> int:
    """Dynamic shared memory of a block with an ``n_buffers``-stage ring."""
    return n_buffers * STAGE_SMEM_BYTES + RING_ALIGN


def _configure(lib: ctypes.CDLL) -> None:
    for entry in KERNEL_ENTRIES.values():
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
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
    ``MAX_BUFFERS`` (14, what a block's 227 KB of shared memory holds);
    anything else raises. ``bin_topk_pipelined_carry.launches`` counts calls
    that launch: each runs the ring kernel and, when the super-tiles are
    split over groups (``supertile_groups``), the max over the groups'
    partial carries.
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
    if not MIN_BUFFERS <= n_buffers <= MAX_BUFFERS:
        raise ValueError(
            f"bin_topk_pipelined kernel takes n_buffers in [{MIN_BUFFERS}, "
            f"{MAX_BUFFERS}], got {n_buffers}"
        )
    batch = queries.shape[0]
    lib = load_library("bin_topk_pipelined")
    _configure(lib)
    out, partial, groups = K.carry_buffers(corpus, batch, bins)
    with torch.cuda.device(corpus.device):
        stream = torch.cuda.current_stream(corpus.device).cuda_stream
        status = getattr(lib, KERNEL_ENTRIES[dtype])(
            queries.data_ptr(),
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
    fixed at 64 rows by 128 depth bytes. Like ``pallas_bin_topk(...,
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
