"""Fused int8 corpus matmul + bin-max top-k (the Hopper port of
pallas_bin_topk_int8).

Replaces ``pallas_bin_topk_int8`` / ``_bin_topk_kernel_int8``
(lean_explore_tpu/ops/pallas_retrieval.py:308 and :260). The corpus is int8
codes [N, D] with f32 row scales [N] (ops/quant.py); the queries are
quantized per row on the device. One pass folds every score
``(raw * row_scale) * query_scale`` (raw the exact int32 inner product of
the codes) into the packed ``[bins, B]`` carry of ops/bin_topk.py, and the
same epilogue unpacks it.

On a CUDA tensor ``bin_topk_int8_carry`` launches the hand-written kernel in
``csrc/bin_topk_int8.cu``; on a CPU tensor it runs
``bin_topk_int8_carry_plain``, the same arithmetic in torch ops and, since
the products are exact integers and every f32 step is rounded in the same
order, the same bits. There is no fallback from one to the other.

Differences from the TPU version: the epilogue is an exact ``torch.topk``
where the TPU used ``lax.approx_max_k`` (recall_target 0.99), and the query
batch is not padded to a multiple of 8.
"""

import ctypes

import torch

from lean_explore_tpu_torch.ops.bin_topk import (
    check_carry_inputs,
    carry_buffers,
    fold_supertiles,
    ring_supertile_groups,
    steal_bits_for,
    unpack_topk,
)
from lean_explore_tpu_torch.ops.cuda_build import load_library
from lean_explore_tpu_torch.ops.quant import int8_products, quantize_rows_device

# A ring stage of the kernel is 128 bytes deep: 128 int8 values.
DEPTH_MULTIPLE = 128


def bin_topk_int8_carry_plain(
    q_codes: torch.Tensor,
    q_scales: torch.Tensor,
    codes: torch.Tensor,
    scales: torch.Tensor,
    n_valid: int,
    bins: int,
    steal_bits: int,
) -> torch.Tensor:
    """The packed carry [bins, B] in torch ops: the kernel's plain twin.
    Products of each super-tile are exact (ops/quant.int8_products); the
    scaling is ``raw * row_scale`` then ``* query_scale``, as the kernel's."""
    return fold_supertiles(
        lambda start, stop: int8_products(codes[start:stop], q_codes)
        * scales[start:stop, None]
        * q_scales[None, :],
        codes.shape[0], q_codes.shape[0], n_valid, bins, steal_bits, codes.device,
    )


def _configure(lib: ctypes.CDLL) -> None:
    fn = lib.bin_topk_int8_carry
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


def bin_topk_int8_carry(
    q_codes: torch.Tensor,
    q_scales: torch.Tensor,
    codes: torch.Tensor,
    scales: torch.Tensor,
    n_valid: int,
    bins: int,
) -> torch.Tensor:
    """Packed bin-max carry [bins, B] f32 of the calibrated int8 scores.

    CPU tensors take ``bin_topk_int8_carry_plain``. CUDA tensors launch the
    kernel, which takes int8 ``q_codes`` [B, D] and ``codes`` [N, D] and f32
    ``q_scales`` [B] and ``scales`` [N], all contiguous, with N and bins
    multiples of 64 and D a multiple of 128; anything else raises.
    ``bin_topk_int8_carry.launches`` counts calls that launch (the carry
    kernel and, with the super-tiles split over groups
    (``ring_supertile_groups``), the max over them).
    """
    n, dim = codes.shape
    batch = q_codes.shape[0]
    steal_bits = steal_bits_for(n, bins)
    tensors = (q_codes, q_scales, codes, scales)
    if all(t.device.type == "cpu" for t in tensors):
        return bin_topk_int8_carry_plain(
            q_codes, q_scales, codes, scales, n_valid, bins, steal_bits
        )
    check_carry_inputs(
        "bin_topk_int8", q_codes, codes, n_valid, bins, torch.int8, DEPTH_MULTIPLE
    )
    for name, t, size in (("q_scales", q_scales, batch), ("scales", scales, n)):
        if t.device != codes.device or t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on {codes.device}")
        if t.shape != (size,) or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous [{size}]")
    lib = load_library("bin_topk_int8")
    _configure(lib)
    groups = ring_supertile_groups(codes.device, n, batch, bins)
    out, partial, groups = carry_buffers(codes, batch, bins, groups)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        status = lib.bin_topk_int8_carry(
            q_codes.data_ptr(),
            q_scales.data_ptr(),
            codes.data_ptr(),
            scales.data_ptr(),
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
    bin_topk_int8_carry.launches += 1
    if status != 0:
        raise RuntimeError(f"bin_topk_int8 kernel launch failed: cudaError {status}")
    return out


bin_topk_int8_carry.launches = 0


def bin_topk_int8(
    queries: torch.Tensor,
    codes: torch.Tensor,
    scales: torch.Tensor,
    n_valid: int,
    *,
    k: int,
    bins: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused-selection top-k over an int8 corpus: (scores [B, k] f32 desc,
    rows [B, k] int32), with ``pallas_bin_topk_int8``'s contract under
    ``exact_epilogue=True``: a top-k row is lost only to a better row in its
    bin, and scores carry the packing quantum. Queries are quantized per
    row on their device (ops/quant.quantize_rows_device).
    """
    if k > bins:
        raise ValueError(f"k={k} exceeds bins={bins}")
    q_codes, q_scales = quantize_rows_device(queries)
    packed = bin_topk_int8_carry(q_codes, q_scales, codes, scales, n_valid, bins)
    return unpack_topk(
        packed, k=k, steal_bits=steal_bits_for(codes.shape[0], bins), bins=bins
    )
