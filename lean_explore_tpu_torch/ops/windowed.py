"""Exact windowed top-k on fused scores + window maxima (the Hopper port of
fused_scores_wmax and pallas_windowed_topk).

Replaces ``fused_scores_wmax`` / ``_fused_kernel``
(lean_explore_tpu/ops/pallas_retrieval.py:60 and :30) and the epilogue of
``pallas_windowed_topk`` (:653-686). The first pass writes the masked scores
transposed, ``scores_t`` [N, B] f32 with -inf at pad rows, and the maxima
over windows of W consecutive rows, ``wmax_t`` [N / W, B]. The selection
then takes the top-k windows per query, gathers their k * W member scores
and takes the top-k of those. It is exact: if row x is in the top-k, fewer
than k scores exceed x, so fewer than k windows have a maximum above x's
window, and x's window is among the top k.

On a CUDA tensor ``fused_scores_wmax`` launches the hand-written kernel in
``csrc/windowed_scores.cu``, on the ring-fed ``wgmma`` block of
``csrc/ring_tiles.cuh`` (a TMA ring of corpus and query tiles, two
warpgroups of 64 rows x 128 queries) over a persistent grid of 128-row
tiles; each warpgroup stages its scores in shared memory, writes them out
16 bytes a store (4 when B % 4 != 0) and takes the window maxima from
them. A bf16 corpus takes bf16 ``wgmma`` m64n128k16, bound by the corpus
stream and the score stores (0.27 ms at the serving shape on an NVIDIA
H100 80GB HBM3 at 700 W, 1.15x the 0.24 ms byte bound; PERF.md); a float32
corpus (the TPU kernel's f32 at HIGHEST precision) 3xTF32 on m64n128k8,
each corpus value split into tf32 hi and lo once and the queries once a
launch into scratch this wrapper allocates. On CPU tensors it runs
``fused_scores_wmax_plain``. There is no fallback from one to the other.
Unlike the TPU version the query batch is not padded to a multiple of 8.
"""

import ctypes

import torch

from lean_explore_tpu_torch.ops.bin_topk import ROW_MULTIPLE, depth_multiple, split_scratch
from lean_explore_tpu_torch.ops.cuda_build import load_library

# The corpus dtypes the kernel takes, with the entry point of each.
KERNEL_ENTRIES = {torch.bfloat16: "windowed_scores", torch.float32: "windowed_scores_f32"}


def fused_scores_wmax_plain(
    queries: torch.Tensor, corpus: torch.Tensor, n_valid: int, window: int = 8
) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores_t [N, B], wmax_t [N / window, B]) f32 in torch ops: the
    kernel's plain twin. Queries are cast to the corpus dtype, then products
    taken in f32 (bf16 values are exact in f32; TF32 is off)."""
    n = corpus.shape[0]
    if n % window:
        raise ValueError(f"corpus rows {n} not a multiple of window {window}")
    q = queries.to(corpus.dtype).to(torch.float32)
    scores_t = corpus.to(torch.float32) @ q.T
    row = torch.arange(n, device=corpus.device)[:, None]
    scores_t = scores_t.masked_fill(row >= n_valid, float("-inf"))
    wmax_t = scores_t.view(n // window, window, -1).amax(dim=1)
    return scores_t, wmax_t


def _configure(lib: ctypes.CDLL) -> None:
    for dtype, entry in KERNEL_ENTRIES.items():
        fn = getattr(lib, entry)
        pointers = 5 if dtype == torch.float32 else 4  # the f32 entry takes q_split
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int


def fused_scores_wmax(
    queries: torch.Tensor, corpus: torch.Tensor, n_valid: int, window: int = 8
) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked transposed scores [N, B] and window maxima [N / window, B].

    CPU tensors take ``fused_scores_wmax_plain``. CUDA tensors launch the
    kernel, which takes a bf16 or float32 corpus [N, D] (queries are cast
    to its dtype), both contiguous and 16-byte aligned, with N a multiple
    of 64, D a multiple of 64 (bf16) or 32 (f32) and 64 % window == 0 (a
    window lies inside one warpgroup's 64 rows); anything else raises. ``fused_scores_wmax.launches`` counts
    launches (for float32 each runs the queries' split, then the kernel).
    """
    if corpus.device.type == "cpu" and queries.device.type == "cpu":
        return fused_scores_wmax_plain(queries, corpus, n_valid, window)
    n, dim = corpus.shape
    if corpus.device.type != "cuda" or queries.device != corpus.device:
        raise ValueError(
            f"fused_scores_wmax: queries on {queries.device}, corpus on "
            f"{corpus.device}; both must be on one CUDA device"
        )
    dtype = corpus.dtype
    if dtype not in KERNEL_ENTRIES:
        raise TypeError(
            f"the windowed_scores kernel takes a bf16 or float32 corpus, got {dtype}"
        )
    q = queries.to(dtype).contiguous()
    if q.ndim != 2 or q.shape[1] != dim or q.shape[0] == 0:
        raise ValueError(f"queries {tuple(queries.shape)} vs corpus {(n, dim)}")
    if not corpus.is_contiguous() or corpus.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("windowed_scores kernel needs a contiguous aligned corpus and queries")
    if n % ROW_MULTIPLE or dim % depth_multiple(dtype) or ROW_MULTIPLE % window:
        raise ValueError(
            f"windowed_scores kernel needs rows ({n}) a multiple of "
            f"{ROW_MULTIPLE}, depth ({dim}) a multiple of {depth_multiple(dtype)} and "
            f"a window ({window}) dividing {ROW_MULTIPLE}"
        )
    if not 0 <= n_valid <= n:
        raise ValueError(f"n_valid={n_valid} outside [0, {n}]")
    batch = q.shape[0]
    lib = load_library("windowed_scores")
    _configure(lib)
    scores_t = torch.empty(n, batch, dtype=torch.float32, device=corpus.device)
    wmax_t = torch.empty(n // window, batch, dtype=torch.float32, device=corpus.device)
    scratch = split_scratch(q) if dtype == torch.float32 else None
    split = [] if scratch is None else [scratch.data_ptr()]
    with torch.cuda.device(corpus.device):
        stream = torch.cuda.current_stream(corpus.device).cuda_stream
        status = getattr(lib, KERNEL_ENTRIES[dtype])(
            q.data_ptr(),
            *split,
            corpus.data_ptr(),
            scores_t.data_ptr(),
            wmax_t.data_ptr(),
            batch,
            n,
            dim,
            int(n_valid),
            window,
            stream,
        )
    fused_scores_wmax.launches += 1
    if status != 0:
        raise RuntimeError(f"windowed_scores kernel launch failed: cudaError {status}")
    return scores_t, wmax_t


fused_scores_wmax.launches = 0


def windowed_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    n_valid: int,
    *,
    k: int,
    window: int = 8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k through the fused pass: (scores [B, k] f32 desc,
    rows [B, k] int32), rows < n_valid for k <= n_valid. Needs
    k <= N / window (ops.dense takes the full scan otherwise). The top k
    windows per query, their k * window member scores, top-k of those."""
    scores_t, wmax_t = fused_scores_wmax(queries, corpus, n_valid, window)
    _, win_idx = torch.topk(wmax_t.T, k, dim=1)  # [B, k]
    offsets = torch.arange(window, device=win_idx.device)
    member = (win_idx[:, :, None] * window + offsets).reshape(win_idx.shape[0], -1)
    gathered = torch.gather(scores_t.T, 1, member)
    top, pos = torch.topk(gathered, k, dim=1)
    return top, torch.gather(member, 1, pos).to(torch.int32)
