"""Fused corpus matmul + bin-max top-k (the Hopper port of pallas_bin_topk).

Replaces ``pallas_bin_topk`` / ``_bin_topk_kernel``
(lean_explore_tpu/ops/pallas_retrieval.py:402 and :214). One pass over the
corpus folds every query's inner products into a packed ``[bins, B]`` carry:
row r goes to bin r % bins, each score is stored as ``max(s + 3, 1e-30)``
with its super-tile id r // bins in the low ``steal_bits`` mantissa bits,
and pad rows (r >= n_valid) store 0. The epilogue takes the top-k over
``[B, bins]`` and strips the bits back out; the score tensor ``[B, N]``
never exists.

On a CUDA tensor ``bin_topk_carry`` launches the hand-written kernel in
``csrc/bin_topk.cu`` (design and bound in its header note), on the
ring-fed ``wgmma`` block of ``csrc/ring_tiles.cuh``: two warpgroups of 64
bins x 128 queries and a producer warp that keeps a TMA ring of corpus and
query tiles in flight, one block an SM. A bf16 corpus takes bf16 ``wgmma``
m64n128k16, bound by the corpus stream (0.22 ms at the serving shape on an
NVIDIA H100 80GB HBM3 at 700 W, 1.2x the 0.18 ms byte bound; PERF.md); a
float32 corpus (the TPU kernel's f32 at HIGHEST precision) 3xTF32 on
m64n128k8, each corpus value split into tf32 hi and lo once and the
queries once a launch into scratch this wrapper allocates (0.68 ms at the
serving shape on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md). On a CPU
tensor it runs ``bin_topk_carry_plain``, the same arithmetic in torch ops.
There is no fallback from one to the other.

Differences from the TPU version:

- The epilogue is an exact ``torch.topk``; the TPU used
  ``lax.approx_max_k`` with recall_target 0.99.
- Each result row is recovered from the unpacked provenance bits and the
  bin position, never by a gather.
- Pad rows and the ragged query batch are masked inside the kernel, so the
  query batch is not padded to a multiple of 8.
"""

import ctypes

import torch

from lean_explore_tpu_torch.ops.cuda_build import load_library

PACK_SHIFT = 3.0
PACK_FLOOR = 1e-30
# What the carry kernels take: corpus rows and bins in multiples of 64 (one
# warpgroup's rows, csrc/ring_carry.cuh: a warpgroup past N or past `bins`
# folds nothing), and the depth in stages of 128 bytes (csrc/mma_tiles.cuh
# STAGE_BYTES): 64 bf16 or 32 f32 values.
ROW_MULTIPLE = 64
STAGE_BYTES = 128
# The wgmma kernels' blocks (csrc/ring_tiles.cuh RING_ROWS, RING_QUERIES):
# 128 corpus rows (two warpgroups of 64) x 128 queries.
RING_ROWS = 128
RING_QUERIES = 128

# The float dtypes the carry kernel takes, with the entry point of each.
KERNEL_ENTRIES = {torch.bfloat16: "bin_topk_carry", torch.float32: "bin_topk_carry_f32"}


def depth_multiple(dtype: torch.dtype) -> int:
    """Depth values per 128-byte pipeline stage of the tiled kernels."""
    return STAGE_BYTES // dtype.itemsize


def steal_bits_for(n_rows: int, bins: int) -> int:
    """Mantissa bits that carry the super-tile id. Ceiling division: a
    partial final super-tile still has id ceil(n/bins) - 1, which must fit
    (pallas_retrieval.py:339-343)."""
    n_supertiles = max(-(-n_rows // bins), 1)
    return max((n_supertiles - 1).bit_length(), 1)


def fold_supertiles(
    tile_scores, n: int, batch: int, n_valid: int, bins: int, steal_bits: int, device
) -> torch.Tensor:
    """The packed carry [bins, B] from f32 scores per super-tile:
    ``tile_scores(start, stop)`` gives rows [start, stop) as [rows, B]. Pad
    rows pack 0; the low ``steal_bits`` bits carry the super-tile id. The
    plain twins of the bf16 and int8 kernels share it."""
    low_mask = (1 << steal_bits) - 1
    carry = torch.zeros(bins, batch, dtype=torch.float32, device=device)
    for p, start in enumerate(range(0, n, bins)):
        stop = min(start + bins, n)
        scores = tile_scores(start, stop)
        rows = torch.arange(start, stop, device=device)[:, None]
        shifted = torch.where(
            rows < n_valid,
            torch.clamp(scores + PACK_SHIFT, min=PACK_FLOOR),
            torch.zeros((), dtype=torch.float32, device=device),
        )
        packed = ((shifted.view(torch.int32) & ~low_mask) | p).view(torch.float32)
        carry[: stop - start] = torch.maximum(carry[: stop - start], packed)
    return carry


def bin_topk_carry_plain(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    n_valid: int,
    bins: int,
    steal_bits: int,
) -> torch.Tensor:
    """The packed carry [bins, B] in torch ops: the kernel's plain twin.

    Products are taken in float32 from the inputs' values (bf16 inputs are
    exact in f32; TF32 is off), so the only difference from the bf16 kernel
    is the order of the f32 sums, and from the f32 kernel that and its
    3xTF32 split.
    """
    qf = queries.to(torch.float32)
    return fold_supertiles(
        lambda start, stop: corpus[start:stop].to(torch.float32) @ qf.T,
        corpus.shape[0], queries.shape[0], n_valid, bins, steal_bits, corpus.device,
    )


def score_tolerance(dtype: torch.dtype, dim: int) -> float:
    """How far the tiled kernels' (K1, K3) inner product of unit rows of
    depth D may lie from the plain twins' (f32 products of the same values,
    TF32 off, within D * 2^-24 of exact by the standard dot-product error
    bound).

    bf16: the products are exact in f32 on both sides, so only the order of
    the f32 sums differs: 2 * D * 2^-24.

    float32 (3xTF32): each operand x is split into hi + lo with
    |x - hi - lo| <= 2^-22 |x|, and lo*lo is dropped, so the three products
    lie within 3 * 2^-22 |x y| of x*y; the 3D partial products (exact in
    f32) are summed by the tensor cores, whose additions may truncate
    (unit error 2^-23), within 3D * 2^-23 of their sum (sum of |x y| <= 1
    for unit rows). With the twin's D * 2^-24: 3 * 2^-22 + 7 * D * 2^-24.
    """
    if dtype == torch.float32:
        return 3.0 * 2.0**-22 + 7.0 * dim * 2.0**-24
    return 2.0 * dim * 2.0**-24


def _configure(lib: ctypes.CDLL) -> None:
    for dtype, entry in KERNEL_ENTRIES.items():
        fn = getattr(lib, entry)
        pointers = 5 if dtype == torch.float32 else 4  # the f32 entry takes q_split
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int


def ring_supertile_groups(device: torch.device, n: int, batch: int, bins: int) -> int:
    """Groups the wgmma carry kernels (K1 and K4 in bf16 and float32, K2 in
    int8) split the super-tiles of [n] rows over: their blocks of (128 bins
    x 128 queries) take one SM each, so at most one wave of them."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = -(-bins // RING_ROWS) * -(-batch // RING_QUERIES)
    return max(1, min(-(-n // bins), sms // blocks))


def split_scratch(queries: torch.Tensor) -> torch.Tensor:
    """[2, B, D] f32 for the float32 kernels' tf32 halves of the queries."""
    return torch.empty((2, *queries.shape), dtype=torch.float32, device=queries.device)


def check_carry_inputs(
    kernel: str,
    queries: torch.Tensor,
    corpus: torch.Tensor,
    n_valid: int,
    bins: int,
    dtype: torch.dtype,
    depth_multiple: int,
) -> None:
    """Raise on what a carry kernel does not take: both on one CUDA device,
    of ``dtype``, contiguous and 16-byte aligned, rows and bins multiples of
    64, depth a multiple of ``depth_multiple``, at least one query."""
    n, dim = corpus.shape
    if corpus.device.type != "cuda" or queries.device != corpus.device:
        raise ValueError(
            f"{kernel}: queries on {queries.device}, corpus on "
            f"{corpus.device}; both must be on one CUDA device"
        )
    if corpus.dtype != dtype or queries.dtype != dtype:
        raise TypeError(
            f"{kernel} kernel takes {dtype} inputs, got {queries.dtype} queries "
            f"and {corpus.dtype} corpus"
        )
    if queries.ndim != 2 or queries.shape[1] != dim:
        raise ValueError(f"queries {tuple(queries.shape)} vs corpus {(n, dim)}")
    if not (queries.is_contiguous() and corpus.is_contiguous()):
        raise ValueError(f"{kernel} kernel needs contiguous inputs")
    if n % ROW_MULTIPLE or bins % ROW_MULTIPLE or dim % depth_multiple:
        raise ValueError(
            f"{kernel} kernel needs rows ({n}) and bins ({bins}) multiples of "
            f"{ROW_MULTIPLE} and depth ({dim}) a multiple of {depth_multiple}"
        )
    if not 0 <= n_valid <= n:
        raise ValueError(f"n_valid={n_valid} outside [0, {n}]")
    if queries.data_ptr() % 16 or corpus.data_ptr() % 16:
        raise ValueError(f"{kernel} kernel needs 16-byte aligned inputs")
    if queries.shape[0] == 0:
        raise ValueError(f"{kernel} kernel needs at least one query")


def carry_buffers(
    corpus: torch.Tensor, batch: int, bins: int, groups: int
) -> tuple[torch.Tensor, torch.Tensor | None, int]:
    """(out [bins, B], partial [groups, bins, B] or None, groups)."""
    device = corpus.device
    out = torch.empty(bins, batch, dtype=torch.float32, device=device)
    partial = (
        torch.empty(groups, bins, batch, dtype=torch.float32, device=device)
        if groups > 1
        else None
    )
    return out, partial, groups


def bin_topk_carry(
    queries: torch.Tensor, corpus: torch.Tensor, n_valid: int, bins: int
) -> torch.Tensor:
    """Packed bin-max carry [bins, B] f32 of ``queries @ corpus.T``.

    CPU tensors take ``bin_topk_carry_plain``. CUDA tensors launch the
    kernel, which takes ``queries`` [B, D] and ``corpus`` [N, D] of one
    dtype, bf16 or float32, both contiguous, with N and bins multiples of
    64 and D a multiple of 64 (bf16) or 32 (f32); anything else raises.
    ``bin_topk_carry.launches`` counts calls that launch: each runs the carry
    kernel (for float32 after the queries' split) and, when the super-tiles
    are split over groups (``ring_supertile_groups``), the max over the
    groups' partial carries.
    """
    n, dim = corpus.shape
    steal_bits = steal_bits_for(n, bins)
    if corpus.device.type == "cpu" and queries.device.type == "cpu":
        return bin_topk_carry_plain(queries, corpus, n_valid, bins, steal_bits)
    dtype = corpus.dtype
    if dtype not in KERNEL_ENTRIES:
        raise TypeError(
            f"bin_topk kernel takes a bf16 or float32 corpus, got {dtype}"
        )
    check_carry_inputs(
        "bin_topk", queries, corpus, n_valid, bins, dtype, depth_multiple(dtype)
    )
    batch = queries.shape[0]
    lib = load_library("bin_topk")
    _configure(lib)
    f32 = dtype == torch.float32
    groups = ring_supertile_groups(corpus.device, n, batch, bins)
    out, partial, groups = carry_buffers(corpus, batch, bins, groups)
    scratch = split_scratch(queries) if f32 else None
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
            stream,
        )
    bin_topk_carry.launches += 1
    if status != 0:
        raise RuntimeError(f"bin_topk kernel launch failed: cudaError {status}")
    return out


bin_topk_carry.launches = 0


def unpack_topk(
    packed: torch.Tensor, *, k: int, steal_bits: int, bins: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the packed carry [bins, B], then unpack: packed
    order is score order (all values non-negative), so selection runs on
    the packed values and each row is super-tile * bins + bin."""
    top, pos = torch.topk(packed.T, k, dim=1)
    bits = top.view(torch.int32)
    low_mask = (1 << steal_bits) - 1
    scores = (bits & ~low_mask).view(torch.float32) - PACK_SHIFT
    rows = (bits & low_mask) * bins + pos.to(torch.int32)
    return scores, rows.to(torch.int32)


def bin_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    n_valid: int,
    *,
    k: int,
    bins: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused-selection top-k: (scores [B, k] f32 desc, rows [B, k] int32).

    Same contract and bin-survivorship semantics as ``pallas_bin_topk``
    with ``exact_epilogue=True``: a top-k row is lost only to a better row
    in its bin. Scores carry the packing quantum (2^steal_bits ulps of
    [2, 4)). Queries are cast to the corpus dtype, as on the TPU.
    """
    if k > bins:
        raise ValueError(f"k={k} exceeds bins={bins}")
    q = queries.to(corpus.dtype).contiguous()
    packed = bin_topk_carry(q, corpus, n_valid, bins)
    return unpack_topk(
        packed, k=k, steal_bits=steal_bits_for(corpus.shape[0], bins), bins=bins
    )
