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
``csrc/bin_topk.cu`` (design and bound in its header note); on a CPU tensor
it runs ``bin_topk_carry_plain``, the same arithmetic in torch ops. There is
no fallback from one to the other.

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
# Kernel tile sizes (csrc/bin_topk.cu BM, BK): corpus rows and bins come in
# slices of 64, and the depth in stages of 64.
ROW_MULTIPLE = 64
DEPTH_MULTIPLE = 64


def steal_bits_for(n_rows: int, bins: int) -> int:
    """Mantissa bits that carry the super-tile id. Ceiling division: a
    partial final super-tile still has id ceil(n/bins) - 1, which must fit
    (pallas_retrieval.py:339-343)."""
    n_supertiles = max(-(-n_rows // bins), 1)
    return max((n_supertiles - 1).bit_length(), 1)


def bin_topk_carry_plain(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    n_valid: int,
    bins: int,
    steal_bits: int,
) -> torch.Tensor:
    """The packed carry [bins, B] in torch ops: the kernel's plain twin.

    Products are taken in float32 from the inputs' values (bf16 inputs are
    exact in f32), so the only difference from the kernel is the order of
    the f32 sums.
    """
    n = corpus.shape[0]
    batch = queries.shape[0]
    qf = queries.to(torch.float32)
    low_mask = (1 << steal_bits) - 1
    carry = torch.zeros(bins, batch, dtype=torch.float32, device=corpus.device)
    for p, start in enumerate(range(0, n, bins)):
        stop = min(start + bins, n)
        scores = corpus[start:stop].to(torch.float32) @ qf.T  # [rows, B]
        rows = torch.arange(start, stop, device=corpus.device)[:, None]
        shifted = torch.where(
            rows < n_valid,
            torch.clamp(scores + PACK_SHIFT, min=PACK_FLOOR),
            torch.zeros((), dtype=torch.float32, device=corpus.device),
        )
        packed = ((shifted.view(torch.int32) & ~low_mask) | p).view(torch.float32)
        carry[: stop - start] = torch.maximum(carry[: stop - start], packed)
    return carry


def _configure(lib: ctypes.CDLL) -> None:
    fn = lib.bin_topk_carry
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


def _supertile_groups(device: torch.device, blocks: int, n_supertiles: int) -> int:
    """Split the super-tile loop so about four blocks run per SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(n_supertiles, -(-4 * sms // blocks)))


def bin_topk_carry(
    queries: torch.Tensor, corpus: torch.Tensor, n_valid: int, bins: int
) -> torch.Tensor:
    """Packed bin-max carry [bins, B] f32 of ``queries @ corpus.T``.

    CPU tensors take ``bin_topk_carry_plain``. CUDA tensors launch the
    kernel, which takes bf16 ``queries`` [B, D] and ``corpus`` [N, D], both
    contiguous, with N, bins and D multiples of 64; anything else raises.
    ``bin_topk_carry.launches`` counts calls that launch: each runs the carry
    kernel and, when the super-tiles are split over groups, the max over the
    groups' partial carries.
    """
    n, dim = corpus.shape
    steal_bits = steal_bits_for(n, bins)
    if corpus.device.type == "cpu" and queries.device.type == "cpu":
        return bin_topk_carry_plain(queries, corpus, n_valid, bins, steal_bits)
    if corpus.device.type != "cuda" or queries.device != corpus.device:
        raise ValueError(
            f"bin_topk_carry: queries on {queries.device}, corpus on "
            f"{corpus.device}; both must be on one CUDA device"
        )
    if corpus.dtype != torch.bfloat16 or queries.dtype != torch.bfloat16:
        raise TypeError(
            f"bin_topk kernel takes bf16 inputs, got {queries.dtype} queries "
            f"and {corpus.dtype} corpus"
        )
    if queries.ndim != 2 or queries.shape[1] != dim:
        raise ValueError(f"queries {tuple(queries.shape)} vs corpus {(n, dim)}")
    if not (queries.is_contiguous() and corpus.is_contiguous()):
        raise ValueError("bin_topk kernel needs contiguous inputs")
    if n % ROW_MULTIPLE or bins % ROW_MULTIPLE or dim % DEPTH_MULTIPLE:
        raise ValueError(
            f"bin_topk kernel needs rows ({n}) and bins ({bins}) multiples of "
            f"{ROW_MULTIPLE} and depth ({dim}) a multiple of {DEPTH_MULTIPLE}"
        )
    if not 0 <= n_valid <= n:
        raise ValueError(f"n_valid={n_valid} outside [0, {n}]")
    if queries.data_ptr() % 16 or corpus.data_ptr() % 16:
        raise ValueError("bin_topk kernel needs 16-byte aligned inputs")
    batch = queries.shape[0]
    if batch == 0:
        raise ValueError("bin_topk kernel needs at least one query")

    lib = load_library("bin_topk")
    _configure(lib)
    out = torch.empty(bins, batch, dtype=torch.float32, device=corpus.device)
    n_supertiles = -(-n // bins)
    groups = _supertile_groups(
        corpus.device, (bins // ROW_MULTIPLE) * -(-batch // 64), n_supertiles
    )
    partial = (
        torch.empty(groups, bins, batch, dtype=torch.float32, device=corpus.device)
        if groups > 1
        else None
    )
    with torch.cuda.device(corpus.device):
        stream = torch.cuda.current_stream(corpus.device).cuda_stream
        status = lib.bin_topk_carry(
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
