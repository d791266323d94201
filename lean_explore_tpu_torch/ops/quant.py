"""Int8-quantized dense retrieval, the counterpart of
lean_explore_tpu/ops/quant.py.

Symmetric per-row int8 quantization of the corpus (and, at query time, of
the query batch) halves the bytes of the retrieval pass against bfloat16,
at a small recall cost. Scores are rescaled to float32 before selection,
so ranking runs on calibrated inner products.

    quantize_rows         f32 [N, D] numpy -> (int8 [N, D], f32 [N] scales)
    quantize_rows_device  the same on a tensor, for query batches
    quantized_topk        exact top-k over a quantized corpus (plain path)
"""

import numpy as np
import torch


def quantize_rows(matrix: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8 quantization (host, numpy).

    scale_i = max|row_i| / 127; zero rows get scale 1 (all-zero codes).
    """
    matrix = np.asarray(matrix, dtype=np.float32)
    absmax = np.abs(matrix).max(axis=1)
    scales = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    codes = np.clip(np.rint(matrix / scales[:, None]), -127, 127).astype(np.int8)
    return codes, scales


def quantize_rows_device(matrix: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The same quantization on the tensor's device: (int8 codes [B, D],
    f32 scales [B]). ``torch.round`` rounds half to even, as ``rint``."""
    matrix = matrix.to(torch.float32)
    absmax = matrix.abs().amax(dim=1)
    scales = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    codes = torch.round(matrix / scales[:, None]).clamp(-127, 127).to(torch.int8)
    return codes, scales


def int8_products(a_codes: torch.Tensor, b_codes: torch.Tensor) -> torch.Tensor:
    """[M, D] x [N, D] int8 -> [M, N] exact inner products as f32.

    An f32 matmul of the int8 values is exact while every partial sum stays
    below 2^24: |sum| <= 127^2 * D, so for D <= 1040 (TF32 is off in the
    port, ops/dense.py)."""
    return a_codes.to(torch.float32) @ b_codes.to(torch.float32).T


def quantized_topk(
    queries: torch.Tensor,
    corpus_codes: torch.Tensor,
    corpus_scales: torch.Tensor,
    n_valid: int,
    *,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k inner-product search over an int8-quantized corpus.

    Args:
        queries: [B, D] float queries (quantized per row here).
        corpus_codes: [N, D] int8.
        corpus_scales: [N] float32 per-row scales.
        n_valid: number of real rows; rows >= n_valid never win.
        k: neighbors.

    Returns:
        (scores [B, k] f32 calibrated inner products, idx [B, k] int32),
        descending. Scores are ``raw * q_scale * corpus_scale`` in that
        order, as in the JAX function. Selection is always exact: the JAX
        function's ``exact=False`` is ``approx_max_k``, which is exact off a
        TPU.
    """
    q_codes, q_scales = quantize_rows_device(queries)
    raw = int8_products(q_codes, corpus_codes)
    scores = raw * q_scales[:, None] * corpus_scales[None, :]
    col = torch.arange(corpus_codes.shape[0], device=corpus_codes.device)[None, :]
    scores = scores.masked_fill(col >= n_valid, float("-inf"))
    top, idx = torch.topk(scores, k, dim=1)
    return top, idx.to(torch.int32)
