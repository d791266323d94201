"""Dense top-k retrieval ops, the counterpart of lean_explore_tpu/ops/dense.py.

Methods (the JAX package's names):

- ``full``: one matmul to [B, N], pad rows masked to -inf, exact top-k.
  ``approx`` and ``chunked`` compute the same exact result: JAX's
  ``approx_max_k`` is exact off a TPU, and its chunked scan is exact.
- ``fused``: the plain bin-max scan (``_scan_bin_topk``): one matmul per
  super-tile of ``bins`` rows folded into a running per-query bin max and
  super-tile id, then an exact top-k over the [B, bins] carry.
- ``bin_topk`` (``fused_pallas`` is the same): the same selection with
  packed provenance through ``ops.bin_topk``, the hand-written Hopper
  kernel on a CUDA tensor.
- ``windowed``: the exact windowed top-k through ``ops.windowed``, the
  hand-written fused scores + window maxima kernel on a CUDA tensor.
- ``auto``: ``full`` for small corpora (n <= max(4k, 16384), where it is
  exact and cheap); at scale ``bin_topk`` for a corpus on CUDA, bf16 or
  float32, as the JAX package takes its Pallas kernel on a TPU whatever
  the float dtype (ops/dense.py:261-269); else ``full``, which is what
  the JAX package's off-TPU ``approx`` computes on the CPU.

A float32 corpus never runs in TF32 (ops/__init__.py): float32 products
keep exact FAISS-flat scores (the JAX package uses HIGHEST precision for
the same reason, ops/dense.py:58-74), and the kernels take it as 3xTF32,
within about 3 * 2^-22 of f32 per product. Pad rows are masked before any
selection.
"""

from typing import Literal

import torch

from lean_explore_tpu_torch.ops import windowed
from lean_explore_tpu_torch.ops.bin_topk import ROW_MULTIPLE, bin_topk

Method = Literal[
    "auto", "full", "approx", "chunked", "fused", "fused_pallas", "bin_topk",
    "windowed",
]
METHODS = Method.__args__

# Rows per window of the windowed method (the JAX dense_topk default).
WINDOW = 16

# Rows of the padded device corpus come in multiples of this (the kernel's
# corpus tile; index.dense pads once to a multiple of 512).
TILE_ROWS = 512


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-normalize to unit L2 norm (mirrors faiss.normalize_L2)."""
    norm = x.to(torch.float32).square().sum(dim=-1, keepdim=True).sqrt()
    return (x / norm.clamp_min(eps)).to(x.dtype)


def pad_rows(x: torch.Tensor, multiple: int) -> tuple[torch.Tensor, int]:
    """Zero-pad rows of [N, D] to a multiple; returns (padded, n_valid)."""
    n = x.shape[0]
    padded_n = -(-n // multiple) * multiple
    if padded_n != n:
        x = torch.nn.functional.pad(x, (0, 0, 0, padded_n - n))
    return x, n


def _scores(q: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """[B, D] x [T, D] -> [B, T] inner products in f32 of the corpus-dtype
    values (bf16 values are exact in f32)."""
    return q.to(corpus.dtype).to(torch.float32) @ corpus.to(torch.float32).T


def _full_topk(q, corpus, n_valid: int, k: int):
    scores = _scores(q, corpus)
    col = torch.arange(corpus.shape[0], device=corpus.device)[None, :]
    scores = scores.masked_fill(col >= n_valid, float("-inf"))
    top, idx = torch.topk(scores, k, dim=1)
    return top, idx.to(torch.int32)


def _scan_bin_topk(q, corpus, n_valid: int, *, k: int, bins: int):
    """Plain bin-max scan (no packing): running [B, bins] max and super-tile
    id over super-tiles of ``bins`` rows (corpus rows a multiple of bins)."""
    n = corpus.shape[0]
    batch = q.shape[0]
    col = torch.arange(bins, device=corpus.device)[None, :]
    best = torch.full((batch, bins), float("-inf"), device=corpus.device)
    best_p = torch.zeros((batch, bins), dtype=torch.int32, device=corpus.device)
    for p in range(n // bins):
        scores = _scores(q, corpus[p * bins : (p + 1) * bins])
        scores = scores.masked_fill(p * bins + col >= n_valid, float("-inf"))
        better = scores > best
        best = torch.where(better, scores, best)
        best_p = torch.where(better, torch.full_like(best_p, p), best_p)
    top, pos = torch.topk(best, k, dim=1)
    rows = torch.gather(best_p, 1, pos) * bins + pos
    return top, rows.to(torch.int32)


def serving_bins(batch: int, n_rows: int, tile_rows: int = TILE_ROWS) -> int:
    """The fused kernel's bin count: 4096, halved while the packed carry
    and output (2 * bins * B * 4 bytes) exceed 8 MB or bins exceed the
    corpus, never below one tile (lean_explore_tpu/ops/dense.py:288-323)."""
    batch = max(batch, 8)
    bins = 4096
    while bins * batch * 8 > 8 * 1024 * 1024 and bins > 2 * tile_rows:
        bins //= 2
    while bins > n_rows and bins > 2 * tile_rows:
        bins //= 2
    return max(bins, tile_rows)


def dense_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    *,
    n_valid: int | None = None,
    method: Method = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k inner-product search.

    Args:
        queries: [B, D] query embeddings (L2-normalized for the fused
            methods: their packing assumes inner products in [-1, 1]).
        corpus: [N, D] corpus embeddings, padded or not.
        k: Number of neighbors, <= n_valid.
        n_valid: Number of real corpus rows; defaults to N.
        method: one of ``METHODS`` (module docstring).

    Returns:
        (scores [B, k] float32, indices [B, k] int32), sorted descending,
        on the corpus's device.
    """
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r} (have {METHODS})")
    if n_valid is None:
        n_valid = corpus.shape[0]
    n_valid = int(n_valid)
    if k > n_valid:
        raise ValueError(f"k={k} exceeds corpus size {n_valid}")

    n = corpus.shape[0]
    if method == "auto":
        at_scale = n > max(4 * k, 16384)
        on_card = corpus.device.type == "cuda"
        method = "bin_topk" if at_scale and on_card else "full"

    if method in ("full", "approx", "chunked"):
        return _full_topk(queries, corpus, n_valid, k)
    if method == "fused":
        bins = 8192
        while bins > n and bins > 1024:
            bins //= 2
        corpus, _ = pad_rows(corpus, bins)
        if k > bins:  # tiny corpora: the full scan is exact and cheap
            return _full_topk(queries, corpus, n_valid, k)
        return _scan_bin_topk(queries, corpus, n_valid, k=k, bins=bins)
    if method in ("bin_topk", "fused_pallas"):
        corpus, _ = pad_rows(corpus, TILE_ROWS)
        bins = serving_bins(queries.shape[0], corpus.shape[0])
        if k > bins:
            return _full_topk(queries, corpus, n_valid, k)
        return bin_topk(queries, corpus, n_valid, k=k, bins=bins)
    # windowed
    corpus, _ = pad_rows(corpus, ROW_MULTIPLE)
    if k * WINDOW >= corpus.shape[0]:
        return _full_topk(queries, corpus, n_valid, k)
    return windowed.windowed_topk(queries, corpus, n_valid, k=k, window=WINDOW)
