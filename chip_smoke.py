"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --kernels  # phases 1-3b only (build + kernel checks)

Phases, each announced before it starts and timed after it ends:

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of ``lean_explore_tpu_torch/csrc`` with nvcc;
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it, and time both beside the card's bound
   and one PyTorch library call for the same function: bin_topk over a
   bf16 and a float32 corpus (the float32 kernels, 3xTF32 on wgmma, also
   logged beside the floor of their three products at the TF32 peak),
   bin_topk_pipelined over the same inputs
   (its carry equal to bin_topk's kernel carry bit for bit at every ring
   depth it takes, 2-5 stages bf16 and 2-3 float32, in each of 200
   repeated launches at the shortest and the deepest ring, and timed at
   each depth beside it), bin_topk_int8 (bit for bit against
   its twin, also at bins = 4160 and B = 129, and in each of 200 repeated
   launches against the first), windowed_scores over a bf16
   and a float32 corpus, and flash_attention over bf16 and float32 inputs
   at the Qwen3-0.6B geometry, at the serving shape (B 64 x T 512) and the
   training shape (B 32 x T 256), and on the masks of the paths it serves
   (4d's embed batch, 5b's documents, full rows), each timed beside its
   bound and SDPA;
   then K5's backward kernels (dq and
   dk/dv, float32 and bf16) and its forward's lse at the training shape
   (B 32 x T 256: the check's ragged mask, 5b's documents and full rows)
   and at B 64 x T 512, timed at the training shape on each mask beside
   SDPA's backward (dq and dk/dv together too, as "pair ms / library ms");
   3b. ``bin_topk_pipelined`` through its entry point at the serving shape,
   bf16 and float32: its only path, since neither package routes to it;
4. drive ``Service.search_batch`` of the port at full width: a 300,000-row
   synthetic store, a 300,000 x 1024 bf16 dense index on the card, and two
   clients of the Qwen3-0.6B geometry with random bf16 weights from a seed,
   one warm batch then two timed batches of 128 queries;
   4b. the same service over the same corpus quantized to int8
   (``DenseIndex.build(dtype="int8")``), one warm and two timed batches;
   4c. ``DenseIndex.search(method="windowed")`` over the bf16 index with
   the serving path's query embeddings of two batches;
   4d. the flash-attention path: ``EmbeddingClient.embed_sync`` of 64 long
   documents (the 512-token bucket) and ``RerankerClient.rerank_pairs_sync``
   of 64 pairs (the 256-token bucket), each with and without
   LEAN_EXPLORE_FLASH_ATTENTION=1, on the phase-4 clients, then
   ``embed_sync`` of 64 long documents on a float32 copy of the embedder;
   4e. ``DenseIndex.search`` over the phase-4 corpus held in float32 on
   the card, with the default method and the windowed one;
   4f. the reranker's variants on the phase-4 service, each one warm and
   two timed batches: (a) the W8A8 int8 reranker (``quantize_params_int8``
   of the bf16 reranker's params, ``from_components(int8=True)``; every
   projection leaf int8 on the card, its products through
   ``torch._int_mm`` on int8 tensors, its P(true) drift against bf16 on
   the last batch's groups, nonzero and finite), (b) fused QKV in both
   clients (the grouped scores' largest difference from the unfused
   reranker), (c) ``rerank_sync`` of one query's 50 documents and
   ``rerank_pairs_sync`` of 1,024 pairs in 16 same-shape buckets, its
   chained scores equal to a per-bucket ``rerank_scores`` loop bit for
   bit, both timed;
   phase 3 also holds bin_topk over a float32 corpus at phase 6's shape
   (200,000 x 384, B = 64, k = 1000) against its plain twin.
5. drive training at the Qwen3-0.6B geometry with
   LEAN_EXPLORE_FLASH_ATTENTION=1: a random f32 checkpoint written by the
   port's ``export_hf_checkpoint`` and a 2,000-declaration store of
   200-249-word informalizations; 5b the contrastive CLI
   ``lean_explore_tpu_torch.train.__main__.main`` at its defaults (batch
   32, queries 64, documents 256 tokens, AdamW lr 1e-5) to step 4 with a
   checkpoint every 2 steps, then again to step 6, resuming from step 4;
   5c one batch's loss and gradients with flash and without; 5d two
   cross-encoder steps in bf16 at max_length 256 (their pairs/s and each
   step's seconds on a line of its own). Every step launches K5's
   forward, dq and dk/dv once per layer each, and no other kernel.
6. build the index of the committed 200k chain through the port and
   evaluate it: ``make_corpus`` at the chain's arguments, a
   ``DeclarationStore`` in a temporary directory, ``generate_embeddings``
   with a float32 ``EmbeddingClient`` on runs/scale200k/embedder/checkpoint,
   ``build_indices``, ``load_index_artifacts`` with a float32 corpus on the
   card, a ``SearchEngine`` with the float32 reranker on
   runs/scale200k/reranker/checkpoint and ``evaluate_engine`` over the 512
   eval queries at rerank_top 50 (K1-f32 once a batch of 64); recall@1,
   recall@10 and MRR@10 must lie within 2 queries (0.004 for MRR) of the
   committed JAX numbers (runs/scale200k/cascade_eval.json, full_pipeline,
   a TPU run); then, on the same engine, the rerank cascade at 48,16,
   48,25 and 24,8 (LEAN_EXPLORE_RERANK_CASCADE set and popped), each held
   the same way to its own row of that record (24,8, the kept divergence
   ROADMAP C6, logged beside its row and held instead to the committed
   stage-1 keep sets of runs/scale200k/cascade_24_8_divergence.json), and
   the int8 reranker
   (the chain's reranker loaded in bf16 and quantized), logged beside the
   float32 arm; K1-f32 once a batch of 64 in every arm. A missing
   checkpoint fails the phase.
Every kernel's launch count is set to 0 just before each path of phases
3b, 4, 5 and 6 is driven and read just after it.

The line before the last is the kernel table as JSON; the last line is the
device record. Any failure raises, so the run exits non-zero with its
traceback and prints neither line. Without a CUDA device it exits 2 at once.
"""

import argparse
import asyncio
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core peak, same source
INT8_OP_PER_S = 1979e12  # dense int8 tensor-core peak, same source
TF32_FLOP_PER_S = 495e12  # dense TF32 tensor-core peak (float32 inputs), same source


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    """Prints a progress line before a phase and its seconds after it."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        log(f"[phase] {self.name} ...")
        self.start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            log(f"[phase] {self.name}: {time.perf_counter() - self.start:.1f} s")
        return False


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn, by CUDA events around reps calls
    after one warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(
    bytes_moved: float, ops: float, ops_per_s: float = BF16_FLOP_PER_S
) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tf32_floor(flops: float) -> str:
    """The log's note of a float32 retrieval kernel's 3xTF32 floor: its
    three tf32 products of `flops` operations each at the TF32 peak (the
    bound counts the operations once)."""
    return f", 3xTF32 floor {3 * flops / TF32_FLOP_PER_S * 1e3:.4f} ms at the TF32 peak"


# ----------------------------------------------------------------------
# Phase 3: K1 against its plain version
# ----------------------------------------------------------------------


def _unit_rows(
    n: int, d: int, gen: torch.Generator, device, dtype=torch.bfloat16
) -> torch.Tensor:
    x = torch.randn(n, d, generator=gen, device=device, dtype=torch.float32)
    return (x / x.norm(dim=1, keepdim=True)).to(dtype)


def _check_bin_topk_case(name, q, corpus, n_valid, k, bins, carry=None) -> float:
    """Kernel vs plain on one input; returns the max score difference.
    ``carry(q, corpus, n_valid, bins)`` is the kernel's wrapper (default
    K1's ``bin_topk_carry``).

    Tolerance: the kernel's scores lie within ``score_tolerance`` of the
    twin's
    before packing (bf16: the two differ only in the order of the f32
    sums, 2 * D * 2^-24 for unit rows), and packing truncates each to its
    quantum (2^steal_bits ulps of [2, 4), 2^-22 each). Scores must agree
    within tol = 2 quanta + score_tolerance; a row id may differ only where
    the exact f32 scores of the two rows lie within tol (a near tie), and
    every returned row's own score must match its reported one within tol
    (provenance).
    """
    from lean_explore_tpu_torch.ops import bin_topk as K

    steal = K.steal_bits_for(corpus.shape[0], bins)
    tol = 2.0 * 2.0 ** (steal - 22) + K.score_tolerance(corpus.dtype, q.shape[1])
    packed_kernel = (carry or K.bin_topk_carry)(q, corpus, n_valid, bins)
    packed_plain = K.bin_topk_carry_plain(q, corpus, n_valid, bins, steal)
    torch.cuda.synchronize()
    ks, ki = K.unpack_topk(packed_kernel, k=k, steal_bits=steal, bins=bins)
    ps, pi = K.unpack_topk(packed_plain, k=k, steal_bits=steal, bins=bins)
    err = float((ks - ps).abs().max())
    if not err <= tol:
        raise AssertionError(f"{name}: score error {err} > {tol}")
    if int(ki.max()) >= n_valid or int(ki.min()) < 0:
        raise AssertionError(f"{name}: a pad or negative row was selected")
    qf = q.float()
    true = torch.einsum(
        "bd,bkd->bk", qf, corpus[ki.long()].float()
    )  # [B, k] exact f32 scores of the returned rows
    prov = float((true - ks).abs().max())
    if not prov <= tol:
        raise AssertionError(f"{name}: provenance error {prov} > {tol}")
    differ = ki != pi
    n_differ = int(differ.sum())
    if n_differ:
        true_plain = torch.einsum("bd,bkd->bk", qf, corpus[pi.long()].float())
        gap = float((true[differ] - true_plain[differ]).abs().max())
        if not gap <= tol:
            raise AssertionError(
                f"{name}: {n_differ} ids differ with a score gap {gap} > {tol}"
            )
    log(
        f"  {name} ({corpus.dtype}): B={q.shape[0]} N={corpus.shape[0]} "
        f"n_valid={n_valid} k={k} bins={bins} max_abs_err={err:.3g} "
        f"(tol {tol:.3g}) ids_differing_at_near_ties={n_differ}"
    )
    return err


# K1's (and K4's) serving shape: 300,000 valid rows of a 300,032 x 1024
# corpus (padded to 512 rows), B = 128, k = 1000, bins = 4096.
BIN_N_REAL, BIN_DIM, BIN_BATCH, BIN_K, BIN_BINS = 300_000, 1024, 128, 1000, 4096
# Planted exact matches: one mid-corpus, one in the partial final
# super-tile; queries 0 and 1 must find them first.
BIN_PLANTED = (123_457, BIN_N_REAL - 5)


def bin_topk_inputs(device, dtype) -> tuple:
    """(q, corpus, cases) of K1's phase-3 check, from the same seed each
    call: the serving shape with the planted matches, B = 1, a partial
    final super-tile with the fewest stolen bits that hold it, and a corpus
    whose real rows all score below its pad rows (padding never selected).
    Each case is (name, queries, corpus, n_valid)."""
    gen = torch.Generator(device=device).manual_seed(30 if dtype == torch.float32 else 0)
    n_real, dim, batch = BIN_N_REAL, BIN_DIM, BIN_BATCH
    n_pad = -(-n_real // 512) * 512
    corpus = torch.zeros(n_pad, dim, dtype=dtype, device=device)
    corpus[:n_real] = _unit_rows(n_real, dim, gen, device, dtype)
    q = _unit_rows(batch, dim, gen, device, dtype)
    q[0] = corpus[BIN_PLANTED[0]]
    q[1] = corpus[BIN_PLANTED[1]]
    n_part = 3 * 4096 + 1024
    n_small, n_valid_small = 8192, 5000
    neg = torch.zeros(n_small, dim, dtype=dtype, device=device)
    neg[:n_valid_small] = -_unit_rows(n_valid_small, dim, gen, device, dtype).abs()
    pos = _unit_rows(batch, dim, gen, device, dtype).abs()
    return q, corpus, [
        ("serving shape", q, corpus, n_real),
        ("B=1", q[:1].contiguous(), corpus, n_real),
        ("partial final super-tile", q, corpus[:n_part], n_part),
        ("padding never selected", pos, neg, n_valid_small),
    ]


def expect_planted(name: str, rows: torch.Tensor) -> None:
    if (int(rows[0, 0]), int(rows[1, 0])) != BIN_PLANTED:
        raise AssertionError(f"{name}: planted exact matches were not ranked first")


def check_bin_topk(device, dtype=torch.bfloat16) -> dict:
    from lean_explore_tpu_torch.ops import bin_topk as K

    f32 = dtype == torch.float32
    n_real, dim, batch, k, bins = BIN_N_REAL, BIN_DIM, BIN_BATCH, BIN_K, BIN_BINS
    q, corpus, cases = bin_topk_inputs(device, dtype)
    n_pad = corpus.shape[0]
    err = 0.0
    for case, cq, ccorpus, n_valid in cases:
        err = max(err, _check_bin_topk_case(case, cq, ccorpus, n_valid, k, bins))
    _, rows = K.bin_topk(q, corpus, n_real, k=k, bins=bins)
    expect_planted("bin_topk", rows)

    reps = 20
    ms = cuda_ms(lambda: K.bin_topk_carry(q, corpus, n_real, bins), reps)
    with_epilogue_ms = cuda_ms(lambda: K.bin_topk(q, corpus, n_real, k=k, bins=bins), reps)
    steal = K.steal_bits_for(n_pad, bins)
    plain_ms = cuda_ms(
        lambda: K.bin_topk_carry_plain(q, corpus, n_real, bins, steal), 3
    )
    # Yardstick the port never calls (TF32 is off: an f32 GEMM in f32).
    library_ms = cuda_ms(
        lambda: torch.topk(q @ corpus[:n_real].T, k, dim=1), reps
    )
    size = corpus.element_size()
    bytes_moved = n_real * dim * size + batch * dim * size + bins * batch * 4
    # One counted launch is one wrapper call: for float32 the queries' split
    # into tf32 halves, then the carry kernel over `groups` slices of the
    # super-tiles, then, when groups > 1, a max over the groups' partial
    # carries (groups * bins * B f32 read once).
    groups = K.ring_supertile_groups(device, n_pad, batch, bins)
    per_launch = (["split_tf32_kernel", "ring_carry_kernel<Tf32Stage<false>>"] if f32
                  else ["ring_carry_kernel<Bf16Stage>"])
    per_launch += ["max_over_groups_kernel"] if groups > 1 else []
    # Operations once, at the card's fastest rate for the input type (TF32
    # for float32 inputs; the 3xTF32 product itself runs three times as
    # many).
    flops = 2.0 * n_real * batch * dim
    b_ms, b_by = bound_ms(bytes_moved, flops, TF32_FLOP_PER_S if f32 else BF16_FLOP_PER_S)
    name = "bin_topk_f32" if f32 else "bin_topk"
    log(
        f"  {name} carry kernel {ms:.4f} ms (with top-k epilogue "
        f"{with_epilogue_ms:.4f} ms), plain {plain_ms:.4f} ms, "
        f"library torch.topk(q @ corpus.T) {library_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms by {b_by} ({bytes_moved / 1e6:.1f} MB)"
        f"{tf32_floor(flops) if f32 else ''}; one launch runs {per_launch} with "
        f"groups={groups}"
    )
    return {
        "name": name,
        "route": "cuda",
        "source": "lean_explore_tpu_torch/csrc/bin_topk.cu",
        "replaces": "lean_explore_tpu/ops/pallas_retrieval.py:402",
        "launches": None,
        "kernels_per_launch": per_launch,
        "groups": groups,
        "max_abs_err": err,
        "ms": ms,
        "with_epilogue_ms": with_epilogue_ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": library_ms,
    }


# K1-f32 at the shape phase 6's quality eval gives it: the 200k chain's
# 200,000 rows of the embedder's width 384 in float32 (padded to 200,192),
# evaluate_engine's batch of 64 queries, k = 1000, the serving bins.
EVAL_N_REAL, EVAL_DIM, EVAL_BATCH = 200_000, 384, 64


def check_bin_topk_eval_shape(device) -> dict:
    """K1-f32 against its plain twin at phase 6's shape, with the f32
    tolerance of the serving cases and planted exact matches (one
    mid-corpus, one in the partial final super-tile) ranked first; the
    carry timed beside the twin. Returns the keys the bin_topk_f32 row
    takes."""
    from lean_explore_tpu_torch.ops import bin_topk as K
    from lean_explore_tpu_torch.ops.dense import serving_bins

    gen = torch.Generator(device=device).manual_seed(31)
    n_real, dim, batch, k = EVAL_N_REAL, EVAL_DIM, EVAL_BATCH, BIN_K
    n_pad = -(-n_real // 512) * 512
    corpus = torch.zeros(n_pad, dim, dtype=torch.float32, device=device)
    corpus[:n_real] = _unit_rows(n_real, dim, gen, device, torch.float32)
    q = _unit_rows(batch, dim, gen, device, torch.float32)
    planted = (76_543, n_real - 5)
    q[0], q[1] = corpus[planted[0]], corpus[planted[1]]
    bins = serving_bins(batch, n_pad)
    err = _check_bin_topk_case("quality-eval shape", q, corpus, n_real, k, bins)
    _, rows = K.bin_topk(q, corpus, n_real, k=k, bins=bins)
    if (int(rows[0, 0]), int(rows[1, 0])) != planted:
        raise AssertionError("quality-eval shape: planted exact matches were not ranked first")
    ms = cuda_ms(lambda: K.bin_topk_carry(q, corpus, n_real, bins), 20)
    steal = K.steal_bits_for(n_pad, bins)
    plain_ms = cuda_ms(lambda: K.bin_topk_carry_plain(q, corpus, n_real, bins, steal), 3)
    library_ms = cuda_ms(lambda: torch.topk(q @ corpus[:n_real].T, k, dim=1), 20)
    bytes_moved = (n_real * dim + batch * dim) * 4 + bins * batch * 4
    b_ms, b_by = bound_ms(bytes_moved, 2.0 * n_real * batch * dim, TF32_FLOP_PER_S)
    log(
        f"  bin_topk_f32 at the quality-eval shape (N={n_real} D={dim} B={batch} "
        f"bins={bins}): carry kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library torch.topk(q @ corpus.T) {library_ms:.4f} ms, bound {b_ms:.4f} "
        f"ms by {b_by}"
    )
    return {
        "eval_shape": [n_real, dim, batch, k, bins],
        "eval_shape_max_abs_err": err,
        "eval_shape_ms": ms,
        "eval_shape_plain_ms": plain_ms,
        "eval_shape_bound_ms": b_ms,
        "eval_shape_library_ms": library_ms,
    }


# ----------------------------------------------------------------------
# Phase 3: K4 (bin_topk_pipelined) against K1's kernel and the plain version
# ----------------------------------------------------------------------

# Launches of K4 per shape and depth in the repeated check: a fault of the
# ring's protocol may change a carry in only some launches (without the
# consumers' proxy fence it did; scripts/stress_torch_pipelined.py counts
# them).
PIPELINE_REPEATS = 200


def check_bin_topk_pipelined(device, dtype=torch.bfloat16) -> dict:
    """K4's carry equals K1's kernel carry bit for bit at K1's four cases
    at every ring depth the dtype takes (2 to MAX_BUFFERS[dtype]) and
    passes K1's tolerance check against the plain twin, and in each of
    PIPELINE_REPEATS launches at the shortest and at the deepest ring, at
    the serving shape and at one super-tile; at the JAX TPU test's case
    (8192 x 256, B = 16, n_valid = 8000, k = 64, bins = 2048) its scores and
    rows equal K1's. Then times it at the serving shape beside K1 (K1, K4
    at each depth, K1), the twin and the library call, and checks that its
    wrapper counted every call of this check."""
    from lean_explore_tpu_torch.ops import bin_topk as K
    from lean_explore_tpu_torch.ops import bin_topk_pipelined as K4

    f32 = dtype == torch.float32
    name = "bin_topk_pipelined_f32" if f32 else "bin_topk_pipelined"
    n_real, dim, batch, k, bins = BIN_N_REAL, BIN_DIM, BIN_BATCH, BIN_K, BIN_BINS
    depths = tuple(range(K4.MIN_BUFFERS, K4.MAX_BUFFERS[dtype] + 1))
    ends = (depths[0], depths[-1])
    wrapper = K4.bin_topk_pipelined_carry
    wrapper.launches = 0
    calls = 0
    q, corpus, cases = bin_topk_inputs(device, dtype)
    n_pad = corpus.shape[0]
    err = 0.0
    for case, cq, ccorpus, n_valid in cases:
        want = K.bin_topk_carry(cq, ccorpus, n_valid, bins)
        for n_buffers in depths:
            got = wrapper(cq, ccorpus, n_valid, bins, n_buffers)
            calls += 1
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
                raise AssertionError(
                    f"{name} {case}, n_buffers={n_buffers}: {diff} carry words "
                    f"differ from K1's kernel"
                )
        err = max(
            err,
            _check_bin_topk_case(f"{name} {case}", cq, ccorpus, n_valid, k, bins, wrapper),
        )
        calls += 1
    log(f"  {name}: carry == K1's kernel carry bit for bit (0 words differ) at "
        f"the 4 cases, n_buffers {depths}")
    # The serving shape, and its first 65,536 rows as one super-tile (bins =
    # rows, so every product reaches the carry), at the shortest and the
    # deepest ring.
    repeats = (("serving shape", corpus, n_real, bins),
               ("one super-tile", corpus[:65_536], 65_536, 65_536))
    for case, ccorpus, n_valid, cbins in repeats:
        want = K.bin_topk_carry(q, ccorpus, n_valid, cbins).view(torch.int32)
        for n_buffers in ends:
            differing = 0
            for _ in range(PIPELINE_REPEATS):
                got = wrapper(q, ccorpus, n_valid, cbins, n_buffers)
                calls += 1
                differing += int(not torch.equal(got.view(torch.int32), want))
            if differing:
                raise AssertionError(
                    f"{name} {case}, n_buffers={n_buffers}: {differing} of "
                    f"{PIPELINE_REPEATS} launches differ from K1's kernel carry"
                )
    log(f"  {name}: {PIPELINE_REPEATS} launches each at the serving shape and at "
        f"one super-tile of 65,536 rows, n_buffers {ends}: every carry == K1's "
        f"(0 launches differ)")

    gen = torch.Generator(device=device).manual_seed(40 if f32 else 10)
    small = _unit_rows(8192, 256, gen, device, dtype)
    small_q = _unit_rows(16, 256, gen, device, torch.float32)
    s4, r4 = K4.bin_topk_pipelined(small_q, small, 8000, k=64, bins=2048, tile_rows=512)
    calls += 1
    s1, r1 = K.bin_topk(small_q, small, 8000, k=64, bins=2048)
    if not (torch.equal(s4, s1) and torch.equal(r4, r1)):
        raise AssertionError(f"{name}: the JAX TPU test's case differs from K1's top-k")
    log(f"  {name}: 8192 x 256, B=16, n_valid=8000, k=64, bins=2048: scores and "
        f"rows == K1's")

    reps = 20
    carry_k1 = lambda: K.bin_topk_carry(q, corpus, n_real, bins)  # noqa: E731
    k1_before = cuda_ms(carry_k1, reps)
    by_buffers = {}
    for n_buffers in depths:
        by_buffers[n_buffers] = cuda_ms(
            lambda: wrapper(q, corpus, n_real, bins, n_buffers), reps
        )
        calls += reps + 1
    k1_after = cuda_ms(carry_k1, reps)
    with_epilogue_ms = cuda_ms(
        lambda: K4.bin_topk_pipelined(q, corpus, n_real, k=k, bins=bins), reps
    )
    calls += reps + 1
    steal = K.steal_bits_for(n_pad, bins)
    plain_ms = cuda_ms(lambda: K.bin_topk_carry_plain(q, corpus, n_real, bins, steal), 3)
    library_ms = cuda_ms(lambda: torch.topk(q @ corpus[:n_real].T, k, dim=1), reps)
    if wrapper.launches != calls:
        raise AssertionError(
            f"{name}: the wrapper counted {wrapper.launches} launches, this check "
            f"made {calls}"
        )
    size = corpus.element_size()
    bytes_moved = n_real * dim * size + batch * dim * size + bins * batch * 4
    flops = 2.0 * n_real * batch * dim
    b_ms, b_by = bound_ms(bytes_moved, flops, TF32_FLOP_PER_S if f32 else BF16_FLOP_PER_S)
    groups = K.ring_supertile_groups(device, n_pad, batch, bins)
    per_launch = (["split_tf32_kernel", "ring_carry_kernel<Tf32Stage<false>>"] if f32
                  else ["ring_carry_kernel<Bf16Stage>"])
    per_launch += ["max_over_groups_kernel"] if groups > 1 else []
    ms = by_buffers[3]
    log(
        f"  {name} carry kernel by n_buffers "
        f"{ {n: round(t, 4) for n, t in by_buffers.items()} } ms (with top-k "
        f"epilogue {with_epilogue_ms:.4f} ms at 3), K1 in turns {k1_before:.4f} "
        f"and {k1_after:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"torch.topk(q @ corpus.T) {library_ms:.4f} ms, bound {b_ms:.4f} ms by "
        f"{b_by} ({bytes_moved / 1e6:.1f} MB); {calls} launches in this check; "
        f"one launch runs {per_launch} with groups={groups}; shared memory by "
        f"n_buffers { {n: K4.ring_smem_bytes(n, dtype) for n in depths} } B "
        f"(limit {K4.BLOCK_SMEM_LIMIT})"
    )
    return {
        "name": name,
        "route": "cuda",
        "source": "lean_explore_tpu_torch/csrc/bin_topk_pipelined.cu",
        "replaces": "lean_explore_tpu/ops/pallas_retrieval.py:571",
        "launches": None,
        "check_launches": calls,
        "kernels_per_launch": per_launch,
        "groups": groups,
        "max_abs_err": err,
        "ms": ms,
        "ms_by_n_buffers": {str(n): t for n, t in by_buffers.items()},
        "with_epilogue_ms": with_epilogue_ms,
        "k1_ms": [k1_before, k1_after],
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": library_ms,
    }


def run_pipelined_path(device, kernels, card) -> None:
    """K4's path: ``bin_topk_pipelined`` called once through its entry point
    at the serving shape, bf16 and then float32, with every launch count
    set to 0 just before and read just after. No path of phases 4-5 routes
    to K4 (the JAX package has no route to its TPU kernel either), so it
    launches 0 times there: each of those paths fails if a kernel other
    than its own launches."""
    from lean_explore_tpu_torch.ops import bin_topk as K
    from lean_explore_tpu_torch.ops import bin_topk_pipelined as K4

    by_name = {k["name"]: k for k in kernels}
    for dtype, name in ((torch.bfloat16, "bin_topk_pipelined"),
                        (torch.float32, "bin_topk_pipelined_f32")):
        q, corpus, _ = bin_topk_inputs(device, dtype)
        with CountLaunches() as launched:
            scores, rows = K4.bin_topk_pipelined(q, corpus, BIN_N_REAL, k=BIN_K, bins=BIN_BINS)
            torch.cuda.synchronize()
        expect_launches(name, launched.counts, "bin_topk_pipelined", 1)
        want_s, want_r = K.bin_topk(q, corpus, BIN_N_REAL, k=BIN_K, bins=BIN_BINS)
        if not (torch.equal(scores, want_s) and torch.equal(rows, want_r)):
            raise AssertionError(f"{name}: top-k at the serving shape differs from K1's")
        expect_planted(name, rows)
        if scores.shape != (BIN_BATCH, BIN_K) or not bool(torch.isfinite(scores).all()):
            raise AssertionError(f"{name}: scores {tuple(scores.shape)} not finite")
        by_name[name]["launches"] = launched.counts["bin_topk_pipelined"]
        by_name[name]["serving_launches"] = 0
        log(
            f"  {name}: top-{BIN_K} of {BIN_BATCH} queries over {tuple(corpus.shape)} "
            f"== K1's, planted matches first; launches {launched.counts}; 0 on the "
            f"paths of phases 4-5, which fail on any other kernel's launch; {card}"
        )
        del q, corpus
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# Phase 3: K2 (bin_topk_int8) against its plain version
# ----------------------------------------------------------------------


def _quantized_unit_rows(n_real: int, n_pad: int, d: int, gen, device):
    """int8 codes [n_pad, d] and f32 scales [n_pad] of n_real unit rows,
    pad rows zero codes and scale 1 (as DenseIndex.build pads them), plus
    the f32 rows themselves."""
    from lean_explore_tpu_torch.ops.quant import quantize_rows_device

    x = torch.randn(n_real, d, generator=gen, device=device)
    x = x / x.norm(dim=1, keepdim=True)
    codes = torch.zeros(n_pad, d, dtype=torch.int8, device=device)
    scales = torch.ones(n_pad, dtype=torch.float32, device=device)
    codes[:n_real], scales[:n_real] = quantize_rows_device(x)
    return codes, scales, x


def _check_bin_topk_int8_case(name, queries, codes, scales, n_valid, k, bins) -> float:
    """Kernel vs plain on one input. The int8 products are exact integers
    and the kernel rounds each f32 step as the twin does, so the two packed
    carries must be equal bit for bit; the max difference is printed and
    returned (0). Every returned row must be real (< n_valid) and carry its
    own calibrated score within one packing quantum (provenance); a
    quantized self-match can score a little above 1, where s + 3 lies in
    [4, 8) and the quantum is 2^steal_bits ulps of that binade, 2^-21."""
    from lean_explore_tpu_torch.ops import bin_topk_int8 as K8
    from lean_explore_tpu_torch.ops.bin_topk import steal_bits_for, unpack_topk
    from lean_explore_tpu_torch.ops.quant import quantize_rows_device

    steal = steal_bits_for(codes.shape[0], bins)
    q_codes, q_scales = quantize_rows_device(queries)
    packed_kernel = K8.bin_topk_int8_carry(q_codes, q_scales, codes, scales, n_valid, bins)
    packed_plain = K8.bin_topk_int8_carry_plain(
        q_codes, q_scales, codes, scales, n_valid, bins, steal
    )
    torch.cuda.synchronize()
    err = float((packed_kernel - packed_plain).abs().max())
    if not torch.equal(packed_kernel.view(torch.int32), packed_plain.view(torch.int32)):
        raise AssertionError(f"{name}: int8 carry differs from plain by up to {err}")
    ks, ki = unpack_topk(packed_kernel, k=k, steal_bits=steal, bins=bins)
    if int(ki.max()) >= n_valid or int(ki.min()) < 0:
        raise AssertionError(f"{name}: a pad or negative row was selected")
    rows = ki.long()
    raw = torch.einsum(
        "bd,bkd->bk", q_codes.float(), codes[rows].float()
    )  # exact integer products of the returned rows
    true = raw * scales[rows] * q_scales[:, None]
    quantum = 2.0 ** (steal - 21)
    prov = float((true - ks).abs().max())
    if not prov <= quantum:
        raise AssertionError(f"{name}: provenance error {prov} > {quantum}")
    log(
        f"  {name}: B={queries.shape[0]} N={codes.shape[0]} n_valid={n_valid} "
        f"k={k} bins={bins} carry bit-identical to plain (max diff {err:.3g}); "
        f"provenance error {prov:.3g} (quantum {quantum:.3g})"
    )
    return err


def check_bin_topk_int8(device) -> dict:
    """K2's carry equals its plain twin bit for bit at the serving shape
    (with the planted matches), B = 1, B = 129 (a second query block of
    one), bins = 4160 (the last block's second warpgroup past the bins), a
    partial final super-tile and a corpus whose pad rows must never be
    selected; in each of PIPELINE_REPEATS launches at the serving shape and
    at one super-tile of 65,536 rows its carry equals the first launch's.
    Then times it beside its twin, its bound and the library call."""
    from lean_explore_tpu_torch.ops import bin_topk_int8 as K8
    from lean_explore_tpu_torch.ops.bin_topk import ring_supertile_groups, steal_bits_for
    from lean_explore_tpu_torch.ops.quant import quantize_rows_device

    gen = torch.Generator(device=device).manual_seed(10)
    n_real, dim, batch, k, bins = 300_000, 1024, 128, 1000, 4096
    n_pad = -(-n_real // 512) * 512
    codes, scales, rows = _quantized_unit_rows(n_real, n_pad, dim, gen, device)
    q = torch.randn(batch, dim, generator=gen, device=device)
    q = q / q.norm(dim=1, keepdim=True)
    # Planted exact matches: one mid-corpus, one in the partial final
    # super-tile; each must come back first.
    q[0] = rows[123_457]
    q[1] = rows[n_real - 5]
    del rows

    err = _check_bin_topk_int8_case("serving shape", q, codes, scales, n_real, k, bins)
    _, top = K8.bin_topk_int8(q, codes, scales, n_real, k=k, bins=bins)
    if int(top[0, 0]) != 123_457 or int(top[1, 0]) != n_real - 5:
        raise AssertionError("int8: planted exact matches were not ranked first")
    err = max(err, _check_bin_topk_int8_case("B=1", q[:1], codes, scales, n_real, k, bins))
    extra = torch.randn(1, dim, generator=gen, device=device)
    q129 = torch.cat([q, extra / extra.norm(dim=1, keepdim=True)])
    err = max(err, _check_bin_topk_int8_case("B=129", q129, codes, scales, n_real, k, bins))
    err = max(err, _check_bin_topk_int8_case("bins=4160", q, codes, scales, n_real, k, 4160))
    n_part = 3 * 4096 + 1024
    err = max(
        err,
        _check_bin_topk_int8_case(
            "partial final super-tile", q, codes[:n_part], scales[:n_part], n_part, k, bins
        ),
    )
    # Padding never selected: every real score is negative, pad rows pack 0.
    n_small, n_valid_small = 8192, 5000
    neg_codes, neg_scales, _ = _quantized_unit_rows(n_valid_small, n_small, dim, gen, device)
    neg_codes[:n_valid_small] = -neg_codes[:n_valid_small].abs()
    pos = torch.randn(batch, dim, generator=gen, device=device).abs()
    pos = pos / pos.norm(dim=1, keepdim=True)
    err = max(
        err,
        _check_bin_topk_int8_case(
            "padding never selected", pos, neg_codes, neg_scales, n_valid_small, k, bins
        ),
    )

    q_codes, q_scales = quantize_rows_device(q)
    # The serving shape, and its first 65,536 rows as one super-tile (bins =
    # rows, so every product reaches the carry): a fault of the ring may
    # change a carry in only some launches.
    for case, n_rows, n_valid, cbins in (("serving shape", n_pad, n_real, bins),
                                         ("one super-tile", 65_536, 65_536, 65_536)):
        args = (q_codes, q_scales, codes[:n_rows], scales[:n_rows], n_valid, cbins)
        first = K8.bin_topk_int8_carry(*args).view(torch.int32)
        differing = sum(
            int(not torch.equal(K8.bin_topk_int8_carry(*args).view(torch.int32), first))
            for _ in range(PIPELINE_REPEATS)
        )
        if differing:
            raise AssertionError(
                f"bin_topk_int8 {case}: {differing} of {PIPELINE_REPEATS} launches differ "
                f"from the first"
            )
    log(f"  bin_topk_int8: {PIPELINE_REPEATS} launches each at the serving shape and at "
        f"one super-tile of 65,536 rows: every carry == the first launch's")

    reps = 20
    ms = cuda_ms(
        lambda: K8.bin_topk_int8_carry(q_codes, q_scales, codes, scales, n_real, bins), reps
    )
    with_epilogue_ms = cuda_ms(
        lambda: K8.bin_topk_int8(q, codes, scales, n_real, k=k, bins=bins), reps
    )
    steal = steal_bits_for(n_pad, bins)
    plain_ms = cuda_ms(
        lambda: K8.bin_topk_int8_carry_plain(
            q_codes, q_scales, codes, scales, n_real, bins, steal
        ),
        3,
    )
    # Yardstick the port never calls: cuBLASLt's int8 GEMM, the same scaling
    # and an exact top-k over [B, N].
    real_t = codes[:n_real].T

    def library():
        raw = torch._int_mm(q_codes, real_t)
        scores = raw.float() * q_scales[:, None] * scales[None, :n_real]
        return torch.topk(scores, k, dim=1)

    library_ms = cuda_ms(library, reps)
    bytes_moved = (
        codes.numel() + scales.numel() * 4 + q_codes.numel() + batch * 4
        + bins * batch * 4
    )
    ops = 2.0 * n_pad * batch * dim
    b_ms, b_by = bound_ms(bytes_moved, ops, INT8_OP_PER_S)
    groups = ring_supertile_groups(device, n_pad, batch, bins)
    per_launch = ["ring_carry_kernel<Int8Stage>"] + (
        ["max_over_groups_kernel"] if groups > 1 else []
    )
    log(
        f"  bin_topk_int8 carry kernel {ms:.4f} ms (with quantisation and top-k "
        f"epilogue {with_epilogue_ms:.4f} ms), plain {plain_ms:.4f} ms, library "
        f"torch._int_mm + scaling + torch.topk {library_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms by {b_by} "
        f"({bytes_moved / 1e6:.1f} MB, {ops / 1e9:.1f} GOP); one launch runs "
        f"{per_launch} with groups={groups}"
    )
    return {
        "name": "bin_topk_int8",
        "route": "cuda",
        "source": "lean_explore_tpu_torch/csrc/bin_topk_int8.cu",
        "replaces": "lean_explore_tpu/ops/pallas_retrieval.py:308",
        "launches": None,
        "kernels_per_launch": per_launch,
        "groups": groups,
        "max_abs_err": err,
        "ms": ms,
        "with_epilogue_ms": with_epilogue_ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": library_ms,
    }


# ----------------------------------------------------------------------
# Phase 3: K3 (windowed_scores) against its plain version
# ----------------------------------------------------------------------


def _check_windowed_topk(name, scores, rows, want_scores, want_rows, exact_t, tol) -> int:
    """Windowed top-k against the exact top-k of the plain f32 scores:
    scores agree position by position within tol, and where an id
    differs, its exact score lies within tol of the one it replaced (a
    near tie). Returns the number of differing ids."""
    err = float((scores - want_scores).abs().max())
    if not err <= tol:
        raise AssertionError(f"{name}: score error {err} > {tol}")
    differ = rows.long() != want_rows
    n_differ = int(differ.sum())
    if n_differ:
        got_exact = torch.gather(exact_t.T, 1, rows.long())
        gap = float((got_exact[differ] - want_scores[differ]).abs().max())
        if not gap <= tol:
            raise AssertionError(f"{name}: {n_differ} ids differ with gap {gap} > {tol}")
    log(f"  {name}: max score error {err:.3g} (tol {tol:.3g}); ids differing at near ties {n_differ}")
    return n_differ


def check_windowed(device, dtype=torch.bfloat16) -> dict:
    from lean_explore_tpu_torch.ops import windowed as W
    from lean_explore_tpu_torch.ops.bin_topk import score_tolerance

    f32 = dtype == torch.float32
    gen = torch.Generator(device=device).manual_seed(40 if f32 else 20)
    n_real, dim, batch, window = 300_000, 1024, 128, 8
    n_pad = -(-n_real // 512) * 512
    corpus = torch.zeros(n_pad, dim, dtype=dtype, device=device)
    corpus[:n_real] = _unit_rows(n_real, dim, gen, device, dtype)
    q = _unit_rows(batch, dim, gen, device, dtype).float()
    # Tolerance: ``score_tolerance`` (bf16 inputs are exact in f32, so kernel and
    # plain differ only in the order of the f32 sums: within twice the f32
    # dot-product error bound of unit rows of depth D).
    tol = score_tolerance(dtype, dim)
    scores_t, wmax_t = W.fused_scores_wmax(q, corpus, n_real, window)
    plain_s, plain_w = W.fused_scores_wmax_plain(q, corpus, n_real, window)
    torch.cuda.synchronize()
    err = 0.0
    for label, got, want in (("scores_t", scores_t, plain_s), ("wmax_t", wmax_t, plain_w)):
        if not torch.equal(torch.isneginf(got), torch.isneginf(want)):
            raise AssertionError(f"windowed: {label} masks differ from plain")
        finite = torch.isfinite(want)
        e = float((got[finite] - want[finite]).abs().max())
        if not e <= tol:
            raise AssertionError(f"windowed: {label} error {e} > {tol}")
        err = max(err, e)
    name = "windowed_scores_f32" if f32 else "windowed_scores"
    log(
        f"  {name}: N={n_pad} n_valid={n_real} B={batch} W={window} "
        f"scores_t and wmax_t max_abs_err={err:.3g} (tol {tol:.3g})"
    )
    exact_t = plain_s  # the plain f32 scores, pad rows at -inf
    for k in (10, 1000):
        want_s, want_i = torch.topk(exact_t.T, k, dim=1)
        got_s, got_i = W.windowed_topk(q, corpus, n_real, k=k, window=window)
        _check_windowed_topk(
            f"windowed_topk k={k} vs exact torch.topk", got_s, got_i, want_s, want_i,
            exact_t, tol,
        )
    del plain_s, plain_w, exact_t

    reps = 20
    ms = cuda_ms(lambda: W.fused_scores_wmax(q, corpus, n_real, window), reps)
    with_epilogue_ms = cuda_ms(
        lambda: W.windowed_topk(q, corpus, n_real, k=1000, window=window), reps
    )
    plain_ms = cuda_ms(lambda: W.fused_scores_wmax_plain(q, corpus, n_real, window), 3)
    q_lib = q.to(dtype)

    def library():  # yardstick the port never calls (TF32 off for f32)
        scores = q_lib @ corpus.T
        return scores, scores.view(batch, n_pad // window, window).amax(dim=2)

    library_ms = cuda_ms(library, reps)
    size = corpus.element_size()
    bytes_moved = (
        n_pad * dim * size + batch * dim * size + n_pad * batch * 4
        + (n_pad // window) * batch * 4
    )
    flops = 2.0 * n_pad * batch * dim
    b_ms, b_by = bound_ms(bytes_moved, flops, TF32_FLOP_PER_S if f32 else BF16_FLOP_PER_S)
    # One counted launch is one wrapper call: for float32 the queries' split
    # into tf32 halves, then the kernel.
    per_launch = (["split_tf32_kernel", "ring_windowed_kernel<Tf32Stage<true>>"] if f32
                  else ["ring_windowed_kernel<Bf16Stage>"])
    log(
        f"  {name} kernel {ms:.4f} ms (with the k=1000 selection "
        f"{with_epilogue_ms:.4f} ms), plain {plain_ms:.4f} ms, library "
        f"q @ corpus.T + window amax {library_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"by {b_by} ({bytes_moved / 1e6:.1f} MB){tf32_floor(flops) if f32 else ''}; "
        f"one launch runs {per_launch}"
    )
    return {
        "name": name,
        "route": "cuda",
        "source": "lean_explore_tpu_torch/csrc/windowed_scores.cu",
        "replaces": "lean_explore_tpu/ops/pallas_retrieval.py:60",
        "launches": None,
        "kernels_per_launch": per_launch,
        "max_abs_err": err,
        "ms": ms,
        "with_epilogue_ms": with_epilogue_ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": library_ms,
    }


# ----------------------------------------------------------------------
# Phase 3: K5 (flash_attention) against its plain version
# ----------------------------------------------------------------------

FLASH_B, FLASH_T, FLASH_NQ, FLASH_NKV, FLASH_DH = 64, 512, 16, 8, 128


def flash_inputs(
    batch: int, seq: int, lengths: list[int], seed: int, device, dtype=torch.bfloat16
):
    """q [B, T, NQ, DH], k and v [B, T, NKV, DH] of ``dtype`` from a seed
    (unit normal, the scale of the trunk's RMS-normed q and k), and a
    right-padded 0/1 mask [B, T] with the given valid lengths."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(heads):
        return torch.randn(
            batch, seq, heads, FLASH_DH, generator=gen, device=device
        ).to(dtype)

    q, k, v = draw(FLASH_NQ), draw(FLASH_NKV), draw(FLASH_NKV)
    lens = torch.tensor(lengths, device=device)
    mask = (torch.arange(seq, device=device)[None, :] < lens[:, None]).to(torch.int32)
    return q, k, v, mask


def serving_flash_mask(device) -> torch.Tensor:
    """The serving shape's 0/1 mask [64, 512]: ragged right-padded lengths
    (1..512, from a seed) and a left-padded last row, whose first key tiles
    lie wholly in the other segment, so the running max must recover from
    the mask value."""
    gen = torch.Generator().manual_seed(50)
    ragged = [1, 255, 256, 257, 512, 64, 65, 128, 383, 384]
    lengths = ragged + torch.randint(
        1, FLASH_T + 1, (FLASH_B - len(ragged),), generator=gen
    ).tolist()
    lens = torch.tensor(lengths, device=device)
    mask = (torch.arange(FLASH_T, device=device)[None, :] < lens[:, None]).to(torch.int32)
    mask[-1] = 0
    mask[-1, 130:] = 1
    return mask


def _check_flash_case(name, q, k, v, mask) -> float:
    """Kernel vs plain on one input, within
    ``ops.flash_attention.kernel_tolerance`` (derived there); returns the
    max error on valid rows. Pad rows are not compared (the TPU kernel leaves
    them unspecified) but must be finite, like every output element."""
    from lean_explore_tpu_torch.ops import flash_attention as FA

    scale = FLASH_DH**-0.5
    got = FA.attention_flash(q, k, v, mask, scale)
    want = FA.attention_flash_plain(q, k, v, mask, scale)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"flash {name}: NaN or inf in the kernel's output")
    valid = mask.bool()
    got_v, want_v = got[valid].float(), want[valid].float()
    tol = FA.kernel_tolerance(q, k, v, want_v)
    err = float((got_v - want_v).abs().max())
    if not err <= tol:
        raise AssertionError(f"flash {name}: valid-row error {err} > {tol}")
    log(
        f"  flash_attention {name} ({q.dtype}): B={q.shape[0]} T={q.shape[1]} "
        f"valid rows max_abs_err={err:.3g} (tol {tol:.3g}), all outputs finite"
    )
    return err


def _time_flash(q, k, v, mask, reps: int = 20) -> dict:
    """CUDA-event ms of the forward kernel and of SDPA (the yardstick the
    port never calls: [B, H, T, DH] views, the same boolean mask, causal and
    same segment, grouped kv heads) on one input, and the bound from it."""
    import torch.nn.functional as nnf

    from lean_explore_tpu_torch.ops import flash_attention as FA

    scale = FLASH_DH**-0.5
    ms = cuda_ms(lambda: FA.attention_flash(q, k, v, mask, scale), reps)
    allowed = FA.allowed_keys(mask)[:, None]

    def library():
        return nnf.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=allowed, scale=scale, enable_gqa=True,
        )

    library_ms = cuda_ms(library, reps)
    # Bytes: q, k, v and out once, and the mask. Operations: QK^T and PV
    # (2 * DH each per pair) over the (query, key) pairs this mask allows.
    bytes_moved = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() + mask.numel() * 4
    pairs = float(allowed.sum())
    flops = 4.0 * FLASH_DH * FLASH_NQ * pairs
    rate = TF32_FLOP_PER_S if q.dtype == torch.float32 else BF16_FLOP_PER_S
    b_ms, b_by = bound_ms(bytes_moved, flops, rate)
    return {"ms": ms, "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
            "mb": bytes_moved / 1e6, "gflop": flops / 1e9, "pairs": pairs}


def check_flash_attention(device, dtype=torch.bfloat16) -> dict:
    """K5's forward against its plain twin at the serving shape (B 64 x
    T 512, ragged lengths and a left-padded row), the training shape (B 32
    x T 256, the backward check's mask), two B 1 x T 256 cases and the
    workload masks (``workload_flash_masks``, on the inputs of their
    shape); timed at both large shapes and on the workload masks beside the
    bound and SDPA (the row's numbers are the serving shape's; the training
    shape's follow under "training_shape", each workload mask's under
    "<label>_mask")."""
    from lean_explore_tpu_torch.ops import flash_attention as FA

    f32 = dtype == torch.float32
    q, k, v, _ = flash_inputs(FLASH_B, FLASH_T, [FLASH_T] * FLASH_B, 51, device, dtype)
    mask = serving_flash_mask(device)
    err = _check_flash_case("serving shape, ragged lengths 1..512", q, k, v, mask)
    train = flash_inputs(TRAIN_B, TRAIN_T, [TRAIN_T] * TRAIN_B, 70, device, dtype)[:3]
    train_mask = training_flash_mask(TRAIN_B, TRAIN_T, 70, device)
    err = max(err, _check_flash_case("training shape, ragged and left-padded", *train,
                                     train_mask))
    for label, lens in (("B=1 T=256 full", [256]), ("B=1 T=256 length 200", [200])):
        err = max(
            err, _check_flash_case(label, *flash_inputs(1, 256, lens, 52, device, dtype))
        )
    # The workload masks take the inputs of their shape.
    workloads = [
        (label, train if wmask.shape[0] == TRAIN_B else (q, k, v), wmask)
        for label, wmask in workload_flash_masks(device).items()
    ]
    for label, inputs, wmask in workloads:
        err = max(err, _check_flash_case(f"{label} mask", *inputs, wmask))

    scale = FLASH_DH**-0.5
    serving = _time_flash(q, k, v, mask)
    training = _time_flash(*train, train_mask)
    on_workloads = {label: _time_flash(*inputs, wmask) for label, inputs, wmask in workloads}
    plain_ms = cuda_ms(lambda: FA.attention_flash_plain(q, k, v, mask, scale), 3)
    name = "flash_attention_f32" if f32 else "flash_attention"
    timed = [("B=64 T=512", serving), ("B=32 T=256", training)]
    timed += [(f"the {label} mask", t) for label, t in on_workloads.items()]
    for shape, t in timed:
        log(
            f"  {name} at {shape}: kernel {t['ms']:.4f} ms, library "
            f"scaled_dot_product_attention(bool mask) {t['library_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms by {t['bound_by']} ({t['mb']:.1f} MB, "
            f"{t['gflop']:.1f} GFLOP over {t['pairs']:.0f} allowed pairs)"
            + (f", plain {plain_ms:.4f} ms" if t is serving else "")
        )
    del train, train_mask, workloads
    return {
        "name": name,
        "route": "cuda",
        "source": "lean_explore_tpu_torch/csrc/flash_attention.cu",
        "replaces": (
            "lean_explore_tpu/models/qwen3.py:201 (jax/experimental/pallas/ops/"
            "tpu/flash_attention.py:758, JAX 0.9.0)"
        ),
        "launches": None,
        "max_abs_err": err,
        "ms": serving["ms"],
        "plain_ms": plain_ms,
        "bound_ms": serving["bound_ms"],
        "bound_by": serving["bound_by"],
        "library_ms": serving["library_ms"],
        "training_shape": {
            key: training[key] for key in ("ms", "library_ms", "bound_ms", "bound_by")
        },
        **{
            f"{label}_mask": {key: t[key] for key in ("ms", "library_ms", "bound_ms", "bound_by")}
            for label, t in on_workloads.items()
        },
    }


# ----------------------------------------------------------------------
# Phase 3: K5's backward (dq, dk/dv) against its plain version
# ----------------------------------------------------------------------

TRAIN_B, TRAIN_T = 32, 256


def training_flash_mask(batch: int, seq: int, seed: int, device) -> torch.Tensor:
    """Ragged right-padded lengths, a one-token row and a left-padded row
    (its first key blocks wholly in the other segment)."""
    gen = torch.Generator().manual_seed(seed)
    lengths = [1, seq, seq // 2 + 3] + torch.randint(
        1, seq + 1, (batch - 3,), generator=gen
    ).tolist()
    lens = torch.tensor(lengths, device=device)
    mask = (torch.arange(seq, device=device)[None, :] < lens[:, None]).to(torch.int32)
    mask[-1] = 0
    mask[-1, 130:] = 1
    return mask


def document_flash_mask(n_docs: int, lo: int, hi: int, seed: int, seq: int,
                        device) -> torch.Tensor:
    """The 0/1 mask [n_docs, seq] of ``long_documents(n_docs, lo, hi, seed)``
    as the clients and the trainer encode them: one token a word, then the
    EOS, right-padded. With phase 4d's arguments (64, 300, 511, 60, 512) it
    is the flash ``embed_sync`` batch's mask; with phase 5b's (TRAIN_B, 200,
    250, 80, 256) the mask of TRAIN_B of the CLI's documents."""
    lens = torch.tensor(
        [len(doc.split()) + 1 for doc in long_documents(n_docs, lo, hi, seed)], device=device
    )
    return (torch.arange(seq, device=device)[None, :] < lens[:, None]).to(torch.int32)


def workload_flash_masks(device) -> dict[str, torch.Tensor]:
    """The masks of the paths the forward serves, beside the checks' ragged
    ones: 4d's embed batch (B 64 x T 512, 301-511 tokens a row), 5b's
    documents (B 32 x T 256, 201-250) and full rows at the training shape
    (a bucket that its documents fill)."""
    return {
        "embed_4d": document_flash_mask(FLASH_DOCS, 300, 511, 60, FLASH_T, device),
        "train_5b": document_flash_mask(TRAIN_B, 200, 250, 80, TRAIN_T, device),
        "train_full": torch.ones(TRAIN_B, TRAIN_T, dtype=torch.int32, device=device),
    }


def _check_flash_bwd_case(name, batch, seq, seed, device, dtype, mask=None) -> tuple:
    """Forward with lse and both backward kernels against the plain twins
    on one input (the mask given, else ``training_flash_mask``): out equal
    bit for bit with and without lse, lse within the score tolerance of the
    twin's logsumexp, and dq, dk, dv within
    ``ops.flash_attention.bwd_kernel_tolerance`` (derived there), dO zero
    on pad rows as a pooled loss gives it. Returns (errors, inputs)."""
    from lean_explore_tpu_torch.ops import flash_attention as FA

    q, k, v, _ = flash_inputs(batch, seq, [seq] * batch, seed, device, dtype)
    if mask is None:
        mask = training_flash_mask(batch, seq, seed, device)
    scale = FLASH_DH**-0.5
    out = FA.attention_flash(q, k, v, mask, scale)
    out_lse, lse = FA.attention_flash(q, k, v, mask, scale, with_lse=True)
    _, want_lse = FA.attention_flash_plain(q, k, v, mask, scale, with_lse=True)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    dout = (torch.randn(out.shape, generator=gen, device=device) * mask[..., None]).to(dtype)
    di = FA.row_dot(out, dout, FLASH_NQ)
    dq = FA.attention_flash_bwd_dq(q, k, v, mask, dout, lse, di, scale)
    dk, dv = FA.attention_flash_bwd_dkv(q, k, v, mask, dout, lse, di, scale)
    torch.cuda.synchronize()
    if not torch.equal(out, out_lse):
        raise AssertionError(f"flash {name}: the output changed with lse on")
    norms = float(q.float().norm(dim=-1).max()) * float(k.float().norm(dim=-1).max())
    split = 3 * 2.0**-22 if dtype == torch.float32 else 0.0
    lse_tol = 2 * (scale * (split + 7 * FLASH_DH * 2.0**-24) * norms
                   + 2.0**-21 * (float(want_lse.abs().max()) + 1))
    lse_err = float((lse - want_lse).abs().max())
    if not lse_err <= lse_tol:
        raise AssertionError(f"flash {name}: lse error {lse_err} > {lse_tol}")
    want = FA.attention_flash_bwd_plain(q, k, v, mask, out, lse, dout, scale)
    tols = FA.bwd_kernel_tolerance(q, k, v, mask, lse, dout, di, scale)
    errs = {}
    for label, got, ref, tol in zip(("dq", "dk", "dv"), (dq, dk, dv), want, tols):
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"flash {name}: NaN or inf in {label}")
        err = float((got.float() - ref.float()).abs().max())
        if not err <= tol:
            raise AssertionError(f"flash {name}: {label} error {err} > {tol}")
        errs[label] = (err, tol)
    del want
    log(
        f"  flash backward {name} ({dtype}): B={batch} T={seq} out unchanged with lse; "
        f"lse err {lse_err:.3g} (tol {lse_tol:.3g}); "
        + "; ".join(f"{k_} err {e:.3g} (tol {t:.3g})" for k_, (e, t) in errs.items())
    )
    return errs, (q, k, v, mask, dout, lse, di)


def _time_flash_bwd(q, k, v, mask, dout, lse, di, reps: int = 20) -> dict:
    """CUDA-event ms of the dq and dk/dv kernels and of SDPA's backward (the
    yardstick the port never calls: it computes dq, dk and dv in one call,
    same boolean mask, grouped kv heads) on one input, and each kernel's
    bound from it: q, k, v, dO, lse, di and the mask read once, its own
    gradients written once; its 3 (dq) or 4 (dk/dv) products over the
    allowed pairs."""
    import torch.nn.functional as nnf

    from lean_explore_tpu_torch.ops import flash_attention as FA

    scale = FLASH_DH**-0.5
    args = (q, k, v, mask, dout, lse, di, scale)
    times = {
        "dq": cuda_ms(lambda: FA.attention_flash_bwd_dq(*args), reps),
        "dkv": cuda_ms(lambda: FA.attention_flash_bwd_dkv(*args), reps),
    }
    allowed = FA.allowed_keys(mask)[:, None]
    leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    sdpa_out = nnf.scaled_dot_product_attention(
        *leaves, attn_mask=allowed, scale=scale, enable_gqa=True
    )
    grad_out = dout.reshape(q.shape).transpose(1, 2)
    library_ms = cuda_ms(
        lambda: torch.autograd.grad(sdpa_out, leaves, grad_out, retain_graph=True), reps
    )
    del sdpa_out, leaves
    pairs = float(allowed.sum())
    size = q.element_size()
    common = (2 * q.numel() + k.numel() + v.numel()) * size + 2 * lse.numel() * 4 + mask.numel() * 4
    rate = TF32_FLOP_PER_S if q.dtype == torch.float32 else BF16_FLOP_PER_S
    timed = {"library_ms": library_ms, "pairs": pairs}
    for kernel, written, products in (
        ("dq", q.numel() * size, 3),
        ("dkv", (k.numel() + v.numel()) * size, 4),
    ):
        flops = 2.0 * FLASH_DH * FLASH_NQ * pairs * products
        b_ms, b_by = bound_ms(common + written, flops, rate)
        timed[kernel] = {"ms": times[kernel], "library_ms": library_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "mb": (common + written) / 1e6,
                         "gflop": flops / 1e9}
    return timed


def check_flash_backward(device, dtype=torch.bfloat16) -> list[dict]:
    """K5's dq and dk/dv kernels at the training shape (B 32 x T 256, the
    check's ragged mask, then the training paths' masks: 5b's documents and
    full rows) and at the forward's B 64 x T 512, timed at the training
    shape on each mask beside their bound, the plain twin and SDPA's
    backward (the row's numbers are the check mask's; each workload mask's
    follow under "<label>_mask")."""
    from lean_explore_tpu_torch.ops import flash_attention as FA

    f32 = dtype == torch.float32
    errs = _check_flash_bwd_case("serving shape", FLASH_B, FLASH_T, 71, device, dtype)[0]
    torch.cuda.empty_cache()
    masks = {"check": None, **{
        label: mask for label, mask in workload_flash_masks(device).items()
        if mask.shape[0] == TRAIN_B
    }}
    timed = {}
    for label, mask in masks.items():
        name = "training shape" if mask is None else f"training shape, the {label} mask"
        more, inputs = _check_flash_bwd_case(name, TRAIN_B, TRAIN_T, 70, device, dtype, mask)
        errs = {k_: max(errs[k_], more[k_]) for k_ in errs}
        timed[label] = _time_flash_bwd(*inputs)
        if mask is None:
            q, k, v, check_mask, dout, lse, _ = inputs
            out = FA.attention_flash(q, k, v, check_mask, FLASH_DH**-0.5)
            plain_ms = cuda_ms(lambda: FA.attention_flash_bwd_plain(
                q, k, v, check_mask, out, lse, dout, FLASH_DH**-0.5), 3)
            del out
        del inputs
    suffix = "_f32" if f32 else ""
    rows = []
    for kernel in ("dq", "dkv"):
        name = f"flash_attention_bwd_{kernel}{suffix}"
        for label, t in timed.items():
            log(
                f"  {name} on the {label} mask: kernel {t[kernel]['ms']:.4f} ms, library SDPA "
                f"backward (dq, dk, dv together) {t['library_ms']:.4f} ms, bound "
                f"{t[kernel]['bound_ms']:.4f} ms by {t[kernel]['bound_by']} "
                f"({t[kernel]['mb']:.1f} MB, {t[kernel]['gflop']:.1f} GFLOP over "
                f"{t['pairs']:.0f} allowed pairs) at B={TRAIN_B} T={TRAIN_T}"
                + (f", plain (dq, dk, dv together) {plain_ms:.4f} ms" if label == "check" else "")
            )
        err = max(e for label, (e, _) in errs.items() if (label == "dq") == (kernel == "dq"))
        check = timed["check"][kernel]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "lean_explore_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": (
                "lean_explore_tpu/models/qwen3.py:201 (jax/experimental/pallas/ops/tpu/"
                f"flash_attention.py:{1456 if kernel == 'dq' else 1121}, JAX 0.9.0)"
            ),
            "launches": None,
            "max_abs_err": err,
            "ms": check["ms"],
            "plain_ms": plain_ms,
            "bound_ms": check["bound_ms"],
            "bound_by": check["bound_by"],
            "library_ms": check["library_ms"],
            **{
                f"{label}_mask": {key: t[kernel][key]
                                  for key in ("ms", "library_ms", "bound_ms", "bound_by")}
                for label, t in timed.items() if label != "check"
            },
        })
    for label, t in timed.items():
        log(
            f"  flash backward {dtype} pair (dq + dk/dv) on the {label} mask "
            f"{t['dq']['ms'] + t['dkv']['ms']:.4f} ms / library SDPA backward "
            f"{t['library_ms']:.4f} ms at B={TRAIN_B} T={TRAIN_T}"
        )
    torch.cuda.empty_cache()
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--kernels", action="store_true", help="build and check kernels only"
    )
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "lean_explore_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: lean_explore_tpu_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    device = torch.device("cuda")

    with Phase("card"):
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        log(card)
        log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}")

    with Phase("build kernels"):
        from lean_explore_tpu_torch.ops import cuda_build

        start = time.perf_counter()
        logs = cuda_build.build(force=True)
        log(f"  built {sorted(logs)} in {time.perf_counter() - start:.1f} s")
        for name, text in logs.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line or "smem" in line:
                    log(f"  {name}: {line.strip()}")

    with Phase("kernels against their plain versions"):
        kernels = [
            check_bin_topk(device),
            check_bin_topk(device, torch.float32),
            check_bin_topk_pipelined(device),
            check_bin_topk_pipelined(device, torch.float32),
            check_bin_topk_int8(device),
            check_windowed(device),
            check_windowed(device, torch.float32),
            check_flash_attention(device),
            check_flash_attention(device, torch.float32),
            *check_flash_backward(device, torch.float32),
            *check_flash_backward(device),
        ]
        f32_row = next(k for k in kernels if k["name"] == "bin_topk_f32")
        f32_row.update(check_bin_topk_eval_shape(device))
        f32_row["max_abs_err"] = max(f32_row["max_abs_err"], f32_row["eval_shape_max_abs_err"])
        torch.cuda.empty_cache()

    with Phase("3b. bin_topk_pipelined through its entry point at the serving shape"):
        run_pipelined_path(device, kernels, card)

    if not args.kernels:
        with Phase("serving paths at full width"):
            run_service(device, kernels, card)
        with Phase("5. training at full width"):
            run_training(device, kernels, card)
        with Phase("6. index build and quality at the 200k chain"):
            run_quality_chain(device, kernels, card, repo)

    log(json.dumps({"kernels": kernels}))
    log(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


# ----------------------------------------------------------------------
# Phase 4: the serving path
# ----------------------------------------------------------------------

WORDS = [f"w{i}" for i in range(3000)]
N_ROWS = 300_000
BATCH = 128


def _synthetic_name(i: int) -> str:
    return f"Pkg{i % 7}.ns{i % 53}.{WORDS[i % 3000]}{i}"


def make_store(db_path: str, n: int):
    """The synthetic corpus of the JAX package's pipeline bench: names from
    a 3000-word vocabulary, short informalizations, and dependencies on the
    actual names of declarations i+1..i+3. Returns (store, names)."""
    from lean_explore_tpu_torch.models.store import Declaration, DeclarationStore

    store = DeclarationStore(db_path, create=True)
    rows, names = [], []
    for i in range(n):
        name = _synthetic_name(i)
        names.append(name)
        deps = (
            json.dumps([_synthetic_name(i + j) for j in range(1, i % 4 + 1)])
            if i % 3
            else None
        )
        rows.append(
            Declaration(
                name=name,
                module=f"Pkg{i % 7}.Mod{i % 101}",
                source_text=f"def {name} := x{i}",
                source_link=f"https://example/{i}",
                dependencies=deps,
                informalization=(
                    f"**Thing {i}.** does {WORDS[i % 3000]} "
                    f"{WORDS[(i * 7) % 3000]} stuff {i % 200}"
                ),
            )
        )
        if len(rows) == 10_000:
            store.insert_many(rows)
            rows = []
    if rows:
        store.insert_many(rows)
    return store, names


def make_tokenizer(tmp_dir: str):
    """A WordLevel tokenizer.json over the corpus vocabulary (with the
    reranker's true/false), read back by the port's own reader."""
    from lean_explore_tpu_torch.models.tokenizer import WordLevelTokenizer

    vocab = {"<pad>": 0, "<unk>": 1, "<eos>": 2, "true": 3, "false": 4}
    for w in WORDS:
        vocab[w] = len(vocab)
    for w in (
        "instruct", "given", "a", "web", "search", "query", "retrieve",
        "relevant", "passages", "that", "answer", "the", "find", "lean",
        "math", "declarations", "nat", "thing", "does", "stuff", ":", ".",
        "<", ">", "**", "4",
    ):
        vocab.setdefault(w, len(vocab))
    for i in range(200):
        vocab.setdefault(str(i), len(vocab))
    spec = {
        "version": "1.0",
        "truncation": None,
        "padding": None,
        "added_tokens": [],
        "normalizer": None,
        "pre_tokenizer": {"type": "Whitespace"},
        "post_processor": None,
        "decoder": None,
        "model": {"type": "WordLevel", "vocab": vocab, "unk_token": "<unk>"},
    }
    path = Path(tmp_dir) / "tokenizer.json"
    path.write_text(json.dumps(spec))
    return WordLevelTokenizer.from_file(
        path, pad_token="<pad>", eos_token="<eos>", unk_token="<unk>"
    )


def qwen06b_config():
    """Qwen3-0.6B geometry; the vocabulary is the smoke tokenizer's."""
    from lean_explore_tpu_torch.models.qwen3 import Qwen3Config

    return Qwen3Config(
        vocab_size=4096,
        hidden_size=1024,
        num_hidden_layers=28,
        num_attention_heads=16,
        num_key_value_heads=8,
        head_dim=128,
        intermediate_size=3072,
    )


def queries_for(rep: int) -> list[str]:
    return [
        f"{WORDS[(i * 13 + rep * 31) % 3000]} nat thing {(i + rep) % 97}"
        for i in range(BATCH)
    ]


def check_grouped_rerank_f32(device) -> float:
    """On the card, in f32 at a small size: the grouped prefix-KV scores
    equal the flat forward's on the unsplit pairs (the JAX package pins the
    same within 1e-5; TF32 is off, so only the sum order differs)."""
    from lean_explore_tpu_torch.models import qwen3

    config = qwen3.Qwen3Config(
        vocab_size=64, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        intermediate_size=128,
    )
    gen = torch.Generator(device=device).manual_seed(5)
    params = qwen3.init_params(config, gen, device=device)
    prefix = torch.randint(5, 64, (2, 8), generator=gen, device=device)
    prefix_mask = torch.ones(2, 8, dtype=torch.int32, device=device)
    prefix_mask[1, 6:] = 0
    suffix = torch.randint(5, 64, (2, 3, 4), generator=gen, device=device)
    suffix_mask = torch.ones(2, 3, 4, dtype=torch.int32, device=device)
    suffix_mask[0, 1, 2:] = 0
    offsets = prefix_mask.sum(dim=1)
    kw = dict(token_true=3, token_false=4)
    pk, pv = qwen3.prefix_kv(params, config, prefix, prefix_mask)
    grouped = qwen3.rerank_scores_grouped(
        params, config, pk, pv, prefix_mask, suffix, suffix_mask, offsets,
        group_chunk=1, **kw,
    )
    err = 0.0
    for g in range(2):
        for d in range(3):
            pair = torch.cat(
                [prefix[g, prefix_mask[g] == 1], suffix[g, d, suffix_mask[g, d] == 1]]
            )[None]
            flat = qwen3.rerank_scores(
                params, config, pair, torch.ones_like(pair), **kw
            )
            err = max(err, abs(float(flat[0]) - float(grouped[g, d])))
    if not err <= 1e-5:
        raise AssertionError(f"grouped rerank differs from flat by {err}")
    return err


def seeded_corpus(device, n_rows: int, dim: int) -> torch.Tensor:
    """Unit rows [n_rows, dim] f32 on the card from seed 2: the dense corpus
    of every serving phase, whatever its dtype on the card."""
    gen = torch.Generator(device=device).manual_seed(2)
    corpus = torch.randn(n_rows, dim, generator=gen, device=device)
    return corpus / corpus.norm(dim=1, keepdim=True)


@dataclasses.dataclass
class Serving:
    """The serving set-up at full width: store, BM25 name indices with a
    bf16 dense index (``artifacts``), and the two clients."""

    tmp: str
    device: torch.device
    store: object
    artifacts: object
    embedder: object
    reranker: object

    def service(self, dense=None):
        """A Service over this set-up, with ``dense`` in place of the bf16
        index when given."""
        from lean_explore_tpu_torch.search.engine import SearchEngine
        from lean_explore_tpu_torch.search.service import Service

        artifacts = self.artifacts
        if dense is not None:
            artifacts = dataclasses.replace(artifacts, dense=dense)
        engine = SearchEngine(
            self.tmp,
            store=self.store,
            artifacts=artifacts,
            embedding_client=self.embedder,
            reranker_client=self.reranker,
            preload_metadata=True,
            device=self.device,
        )
        return Service(engine)


def build_service(device, tmp: str, n_rows: int = N_ROWS) -> Serving:
    """The serving set-up at full width in ``tmp``: synthetic store, BM25
    name indices, a bf16 dense index on the card and two clients of the
    Qwen3-0.6B geometry with random bf16 weights from seeds."""
    from lean_explore_tpu_torch.index.artifacts import (
        IndexArtifacts,
        build_bm25_name_indices,
    )
    from lean_explore_tpu_torch.index.dense import DenseIndex
    from lean_explore_tpu_torch.models import qwen3
    from lean_explore_tpu_torch.util.embedding_client import EmbeddingClient
    from lean_explore_tpu_torch.util.reranker_client import RerankerClient

    t = time.perf_counter()
    tokenizer = make_tokenizer(tmp)
    store, names = make_store(f"{tmp}/declarations.db", n_rows)
    log(f"  store: {n_rows} rows in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    bm25_spaced, bm25_raw = build_bm25_name_indices(names)
    log(f"  BM25 name indices in {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    config = qwen06b_config()
    ids = np.arange(1, n_rows + 1)
    corpus = seeded_corpus(device, n_rows, config.hidden_size).to(torch.bfloat16)
    dense = DenseIndex(corpus, ids, normalized=True)
    del corpus
    embed_params = qwen3.init_params(
        config, torch.Generator(device=device).manual_seed(0),
        dtype=torch.bfloat16, device=device,
    )
    rerank_params = qwen3.init_params(
        config, torch.Generator(device=device).manual_seed(1),
        dtype=torch.bfloat16, device=device,
    )
    embedder = EmbeddingClient.from_components(
        embed_params, config, tokenizer, model_name="smoke-qwen3-0.6b-embed",
        max_length=512, batch_size=BATCH,
        query_prompt="instruct : given a web search query retrieve : ",
    )
    reranker = RerankerClient.from_components(
        rerank_params, config, tokenizer, model_name="smoke-qwen3-0.6b-rerank",
        max_length=256, instruction="find relevant lean 4 math declarations",
        batch_size=BATCH,
    )
    artifacts = IndexArtifacts(
        dense=dense, bm25_spaced=bm25_spaced, bm25_raw=bm25_raw,
        bm25_ids=ids, manifest={"smoke": True},
    )
    torch.cuda.synchronize()
    log(
        f"  dense index {tuple(dense.embeddings.shape)} bf16 on the card, "
        f"two 0.6B-geometry clients in {time.perf_counter() - t:.1f} s"
    )
    return Serving(tmp, device, store, artifacts, embedder, reranker)


def launch_counters() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from lean_explore_tpu_torch.ops import (
        bin_topk,
        bin_topk_int8,
        bin_topk_pipelined,
        flash_attention,
        windowed,
    )

    return {
        "bin_topk": bin_topk.bin_topk_carry,
        "bin_topk_int8": bin_topk_int8.bin_topk_int8_carry,
        "bin_topk_pipelined": bin_topk_pipelined.bin_topk_pipelined_carry,
        "windowed_scores": windowed.fused_scores_wmax,
        "flash_attention": flash_attention.attention_flash,
        "flash_attention_bwd_dq": flash_attention.attention_flash_bwd_dq,
        "flash_attention_bwd_dkv": flash_attention.attention_flash_bwd_dkv,
    }


class CountLaunches:
    """Sets every kernel's launch count to 0 on entry and reads them all
    on exit into ``self.counts``."""

    def __enter__(self):
        for wrapper in launch_counters().values():
            wrapper.launches = 0
        return self

    def __exit__(self, *exc):
        self.counts = {n: w.launches for n, w in launch_counters().items()}
        return False


def expect_launches(path: str, counts: dict, kernel: str, at_least: int) -> None:
    """``kernel`` launched at least ``at_least`` times on ``path`` and no
    other kernel launched there."""
    if counts[kernel] < at_least:
        raise AssertionError(f"{path}: {kernel} launched {counts[kernel]} times")
    others = {n: c for n, c in counts.items() if n != kernel and c}
    if others:
        raise AssertionError(f"{path}: other kernels launched: {others}")


def drive_service(service, store, label: str, kernel: str, card: str) -> dict:
    """One warm batch, then two timed batches of 128 with every launch
    count set to 0 before them; returns the counts read after them."""
    from lean_explore_tpu_torch.util.profiling import StageTimings

    t = time.perf_counter()
    warm = asyncio.run(service.search_batch(queries_for(999)))
    log(f"  {label}: warm batch of {BATCH}: {time.perf_counter() - t:.2f} s")
    check_results(warm, store)

    reps = 2
    totals: dict[str, float] = {}
    with CountLaunches() as launched:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for rep in range(reps):
            timings = StageTimings()
            out = asyncio.run(service.search_batch(queries_for(rep), timings=timings))
            for stage, ms in timings.as_dict().items():
                totals[stage] = totals.get(stage, 0.0) + ms
        torch.cuda.synchronize()
        elapsed = (time.perf_counter() - t0) / reps
    check_results(out, store)
    expect_launches(label, launched.counts, kernel, reps)
    for forbidden in ("jax", "lean_explore_tpu"):
        if forbidden in sys.modules:
            raise AssertionError(f"{forbidden} was imported on the serving path")
    stage_ms = {k: round(v / reps, 2) for k, v in totals.items()}
    log(
        f"  {label}: {BATCH / elapsed:.2f} q/s, {elapsed * 1000:.1f} ms per batch "
        f"of {BATCH}; stage ms {stage_ms}; launches {launched.counts}; {card}"
    )
    return launched.counts


def run_service(device, kernels, card) -> None:
    from lean_explore_tpu_torch import native
    from lean_explore_tpu_torch.index.dense import DenseIndex

    by_name = {k["name"]: k for k in kernels}
    err = check_grouped_rerank_f32(device)
    log(f"  grouped rerank == flat rerank in f32 on the card: max diff {err:.3g}")
    # The lexical and fuse stages run in native/lexcore.cpp when it builds
    # and in numpy otherwise; the stage times below depend on which.
    lexcore = native.load_lexcore() is not None
    log(f"  host route: lexcore native library loaded = {lexcore}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        serving = build_service(device, tmp)
        bf16 = serving.artifacts.dense
        embedder = serving.embedder

        with Phase("4. Service.search_batch, bf16 corpus"):
            counts = drive_service(
                serving.service(), serving.store, "bf16 corpus", "bin_topk", card
            )
            by_name["bin_topk"]["launches"] = counts["bin_topk"]
            recall = dense_recall_at_10(embedder, bf16, queries_for(0))
            log(f"  bf16 dense recall@10 of the kernel path vs exact {recall:.4f}")

        with Phase("4b. Service.search_batch, int8 corpus"):
            t = time.perf_counter()
            host = seeded_corpus(device, N_ROWS, bf16.dim).cpu().numpy()
            int8 = DenseIndex.build(host, bf16.ids, dtype="int8", device=device)
            del host
            service = serving.service(int8)
            log(
                f"  int8 index {tuple(int8.embeddings.shape)} and engine in "
                f"{time.perf_counter() - t:.1f} s"
            )
            counts = drive_service(
                service, serving.store, "int8 corpus", "bin_topk_int8", card
            )
            by_name["bin_topk_int8"]["launches"] = counts["bin_topk_int8"]
            recall = dense_recall_at_10(embedder, int8, queries_for(0))
            log(
                f"  int8 dense recall@10 of the kernel path vs the exact int8 "
                f"scan {recall:.4f}"
            )
            del service, int8

        with Phase("4c. DenseIndex.search(method='windowed'), bf16 corpus"):
            by_name["windowed_scores"]["launches"] = run_windowed_search(
                embedder, bf16, card
            )
        with Phase("4d. flash attention: embed_sync at T=512 (bf16, f32), rerank_pairs_sync at T=256"):
            embed_launches, rerank_launches, f32_launches = run_flash_path(
                embedder, serving.reranker, card
            )
            by_name["flash_attention"]["launches"] = embed_launches
            by_name["flash_attention"]["rerank_launches"] = rerank_launches
            by_name["flash_attention_f32"]["launches"] = f32_launches
        with Phase("4e. DenseIndex.search over a float32 corpus"):
            k1, k3 = run_f32_corpus_search(embedder, bf16.ids, card)
            by_name["bin_topk_f32"]["launches"] = k1
            by_name["windowed_scores_f32"]["launches"] = k3
        with Phase("4f. the reranker's variants: int8 trunk, fused QKV, rerank_sync and chained scoring"):
            run_reranker_variants(serving, card)
        log(f"  lexcore native {lexcore}")


def clone_reranker(client, params, **kw):
    """A reranker with ``client``'s tokenizer and settings around
    ``params``."""
    from lean_explore_tpu_torch.util.reranker_client import RerankerClient

    settings = dict(
        model_name=client.model_name, max_length=client.max_length,
        instruction=client.instruction, batch_size=client.batch_size,
    )
    return RerankerClient.from_components(
        params, client.config, client.tokenizer, **{**settings, **kw}
    )


class CountIntMM:
    """Counts ``torch._int_mm`` calls while active and checks that each
    multiplies int8 tensors on the card."""

    def __enter__(self):
        self.calls = 0
        self._real = torch._int_mm

        def counted(a, b):
            if a.dtype != torch.int8 or b.dtype != torch.int8 or a.device.type != "cuda":
                raise AssertionError(f"_int_mm on {a.dtype} x {b.dtype} on {a.device}")
            self.calls += 1
            return self._real(a, b)

        torch._int_mm = counted
        return self

    def __exit__(self, *exc):
        torch._int_mm = self._real
        return False


def capture_groups(client) -> list:
    """Records the (queries, groups) of ``client``'s grouped rerank calls."""
    calls = []
    real = client.rerank_grouped_sync

    def spy(queries, docs_grouped, **kw):
        calls.append((list(queries), [list(d) for d in docs_grouped]))
        return real(queries, docs_grouped, **kw)

    client.rerank_grouped_sync = spy
    return calls


def score_diff(a: list, b: list) -> np.ndarray:
    return np.abs(np.concatenate([np.asarray(x) - np.asarray(y) for x, y in zip(a, b)]))


def check_int_mm(device) -> None:
    """``torch._int_mm``'s own refusals on the card at the shapes that
    ``qwen3._linear_q8`` pads (16 rows) or raises on (inner 12, outer 20),
    and ``quantize_params_int8`` and ``_linear_q8`` on the card equal to
    their CPU results bit for bit (``_linear_q8`` at 5 padded and 40 rows:
    int32 sums are exact; the scales are IEEE quotients, the rescale two
    IEEE products)."""
    from lean_explore_tpu_torch.models import qwen3

    refusals = []
    for m, k, n in ((16, 32, 32), (32, 12, 32), (32, 32, 20)):
        a = torch.ones(m, k, dtype=torch.int8, device=device)
        b = torch.ones(k, n, dtype=torch.int8, device=device)
        try:
            torch._int_mm(a, b)
            refusals.append(f"[{m}, {k}] x [{k}, {n}] accepted")
        except RuntimeError as err:
            refusals.append(f"[{m}, {k}] x [{k}, {n}]: {str(err).splitlines()[0]}")
    log("  torch._int_mm on the card: " + " | ".join(refusals))
    gen = torch.Generator().manual_seed(8)
    w = torch.randn(1, 1024, 3072, generator=gen) * 0.02
    layers = qwen3.quantize_params_int8({"layers": {"up_proj": w}})["layers"]
    on_card = qwen3.quantize_params_int8({"layers": {"up_proj": w.to(device)}})["layers"]
    for key in ("w8", "scale"):
        if not torch.equal(on_card["up_proj"][key].cpu(), layers["up_proj"][key]):
            raise AssertionError(f"quantize_params_int8 on the card: {key} differs from the CPU's")
    quant = {k: v[0] for k, v in layers["up_proj"].items()}
    for rows in (5, 40):
        h = torch.randn(rows, 1024, generator=gen)
        want = qwen3._linear_q8(h, quant)
        got = qwen3._linear_q8(h.to(device), {k: v.to(device) for k, v in quant.items()}).cpu()
        if not torch.equal(got, want):
            raise AssertionError(
                f"_linear_q8 at {rows} rows: card differs from CPU by {(got - want).abs().max()}"
            )
    log("  quantize_params_int8 and _linear_q8 (5 padded and 40 rows) on the card == on the CPU bit for bit")


CHAIN_PAIRS, CHAIN_PAIR_BATCH = 1024, 64


def run_reranker_variants(serving, card) -> None:
    """Phase 4f on the phase-4 set-up: (a) the int8 reranker
    (``quantize_params_int8`` of the bf16 reranker's params through
    ``from_components(int8=True)``), (b) fused QKV in both clients, each
    through ``drive_service``; (c) ``rerank_sync`` of one query's 50
    documents and ``rerank_pairs_sync`` of 1,024 pairs in 16 same-shape
    buckets, held bit for bit to a per-bucket ``rerank_scores`` loop."""
    from lean_explore_tpu_torch.models import qwen3
    from lean_explore_tpu_torch.models.tokenizer import encode_batch
    from lean_explore_tpu_torch.util.embedding_client import EmbeddingClient

    bf16 = serving.reranker
    check_int_mm(serving.device)
    # (a) The int8 reranker.
    int8 = clone_reranker(bf16, qwen3.quantize_params_int8(bf16.params), int8=True)
    expect_int8_leaves(int8)
    groups = capture_groups(int8)
    with CountIntMM() as int_mm:
        drive_service(
            dataclasses.replace(serving, reranker=int8).service(), serving.store,
            "int8 reranker, bf16 corpus", "bin_topk", card,
        )
    if int_mm.calls == 0:
        raise AssertionError("the int8 reranker never reached torch._int_mm")
    queries, docs = groups[-1]
    want = bf16.rerank_grouped_sync(queries, docs)
    drift = score_diff(int8.rerank_grouped_sync(queries, docs), want)
    if not (np.isfinite(drift).all() and drift.max() > 0):
        raise AssertionError(f"int8 P(true) drift {drift.max()}")
    log(
        f"  int8 reranker: torch._int_mm calls {int_mm.calls} (int8 on the card); "
        f"P(true) drift against bf16 on {len(drift)} pairs of the last batch: max "
        f"{drift.max():.5f}, mean {drift.mean():.6f}; {card}"
    )
    del int8

    # (b) Fused QKV in both clients.
    emb = serving.embedder
    fused_embedder = EmbeddingClient.from_components(
        qwen3.fuse_params_for_serving(emb.params), emb.config, emb.tokenizer,
        model_name=emb.model_name, max_length=emb.max_length, batch_size=emb.batch_size,
        append_eos=emb.append_eos, query_prompt=emb.query_prompt,
    )
    fused = clone_reranker(bf16, qwen3.fuse_params_for_serving(bf16.params))
    drive_service(
        dataclasses.replace(serving, embedder=fused_embedder, reranker=fused).service(),
        serving.store, "fused QKV, both clients", "bin_topk", card,
    )
    diff = score_diff(fused.rerank_grouped_sync(queries, docs), want)
    emb_diff = float((fused_embedder.embed_device(queries, True)
                      - emb.embed_device(queries, True)).abs().max())
    log(
        f"  fused QKV: grouped scores' largest difference from the unfused "
        f"reranker {diff.max():.3g} over {len(diff)} pairs; query embeddings' "
        f"{emb_diff:.3g}; {card}"
    )
    del fused, fused_embedder
    torch.cuda.empty_cache()

    # (c) rerank_sync, and rerank_pairs_sync on chained buckets.
    rows = [serving.store.get_by_id(i) for i in range(1, CHAIN_PAIRS + 1)]
    documents = [f"{d.name}: {d.informalization}" for d in rows]
    query = queries_for(0)[0]
    torch.cuda.synchronize()
    t = time.perf_counter()
    single = bf16.rerank_sync(query, documents[:50])
    single_ms = (time.perf_counter() - t) * 1e3
    if len(single.scores) != 50 or not np.isfinite(single.scores).all():
        raise AssertionError(f"rerank_sync gave {len(single.scores)} scores")
    client = clone_reranker(bf16, bf16.params, batch_size=CHAIN_PAIR_BATCH)
    pair_queries = [queries_for(1)[i % BATCH] for i in range(CHAIN_PAIRS)]
    pairs = [client._format_pair(q, d) for q, d in zip(pair_queries, documents)]
    order = sorted(range(len(pairs)), key=lambda i: len(pairs[i]))
    chunks = [order[s : s + CHAIN_PAIR_BATCH] for s in range(0, len(order), CHAIN_PAIR_BATCH)]
    encoded = [encode_batch(client.tokenizer, [pairs[i] for i in c], max_length=client.max_length)
               for c in chunks]
    shapes = {}
    for batch in encoded:
        shapes[batch.input_ids.shape] = shapes.get(batch.input_ids.shape, 0) + 1
    if max(shapes.values()) < 16:
        raise AssertionError(f"bucket shapes {shapes}: no 16 of one shape")

    def per_bucket_loop() -> list[float]:
        """The earlier rerank_pairs_sync: one rerank_scores call and one
        copy back a bucket."""
        out = [0.0] * len(pairs)
        with torch.no_grad():
            for chunk, batch in zip(chunks, encoded):
                scores = qwen3.rerank_scores(
                    client.params, client.config, client._tensor(batch.input_ids),
                    client._tensor(batch.attention_mask),
                    token_true=client.token_true_id, token_false=client.token_false_id,
                ).cpu().numpy()
                for i, s in zip(chunk, scores):
                    out[i] = float(s)
        return out

    client.rerank_pairs_sync(pair_queries, documents)  # warm
    with CountLaunches() as launched:
        t = time.perf_counter()
        chained = client.rerank_pairs_sync(pair_queries, documents)
        chained_s = time.perf_counter() - t
    t = time.perf_counter()
    loop = per_bucket_loop()
    loop_s = time.perf_counter() - t
    differ = sum(a != b for a, b in zip(chained, loop))
    if differ:
        raise AssertionError(f"chained scores differ from the per-bucket loop at {differ} pairs")
    if any(launched.counts.values()):
        raise AssertionError(f"rerank_pairs_sync launched {launched.counts}")
    log(
        f"  rerank_sync of 50 documents {single_ms:.1f} ms; rerank_pairs_sync of "
        f"{CHAIN_PAIRS} pairs in buckets {shapes}: {CHAIN_PAIRS / chained_s:.1f} pairs/s "
        f"chained (8 buckets a call) against {CHAIN_PAIRS / loop_s:.1f} for the "
        f"per-bucket loop, equal bit for bit; {card}"
    )


def run_windowed_search(embedder, dense, card) -> int:
    """The windowed method over the serving index for the query embeddings
    of two serving batches: exact, so it must give the full scan's scores
    (within the f32 sum-order tolerance) and, away from near ties, its ids.
    Returns the windowed kernel's launches."""
    embs = [embedder.embed_device(queries_for(rep), True) for rep in range(2)]
    torch.cuda.synchronize()
    with CountLaunches() as launched:
        t0 = time.perf_counter()
        got = [dense.search(e, 10, method="windowed") for e in embs]
        torch.cuda.synchronize()
        windowed_ms = (time.perf_counter() - t0) / len(embs) * 1e3
    expect_launches("windowed search", launched.counts, "windowed_scores", len(embs))
    t0 = time.perf_counter()
    want = [dense.search(e, 10, method="full") for e in embs]
    full_ms = (time.perf_counter() - t0) / len(embs) * 1e3
    tol = 2.0 * dense.dim * 2.0**-24
    err = max(float(np.abs(g[0] - w[0]).max()) for g, w in zip(got, want))
    if not err <= tol:
        raise AssertionError(f"windowed search: score error {err} > {tol}")
    n_differ = sum(int((g[1] != w[1]).sum()) for g, w in zip(got, want))
    log(
        f"  windowed search: {windowed_ms:.2f} ms per batch of {BATCH} (full "
        f"scan {full_ms:.2f} ms); max score error vs full {err:.3g} (tol "
        f"{tol:.3g}); ids differing at near ties {n_differ}; launches "
        f"{launched.counts}; {card}"
    )
    return launched.counts["windowed_scores"]


FLASH_ENV = "LEAN_EXPLORE_FLASH_ATTENTION"
FLASH_DOCS = 64
# P(true) of the two attention paths may differ by this much: they differ
# only in where the attention probabilities are rounded to bf16 (2^-9
# relative per rounding), which through 28 layers moves the pooled hidden
# state by a few parts in a thousand (the embeddings' cosine gate, 0.999);
# P(true) = sigmoid(l_true - l_false) moves by at most a quarter of the
# logit difference, a 0.02 logit shift giving 0.005.
RERANK_FLASH_TOL = 0.02


def long_documents(n: int, lo: int, hi: int, seed: int) -> list[str]:
    """n synthetic documents of lo..hi-1 corpus words (one token each)."""
    rng = np.random.default_rng(seed)
    return [
        " ".join(WORDS[j] for j in rng.integers(0, len(WORDS), int(rng.integers(lo, hi))))
        for _ in range(n)
    ]


FLASH_REPS = 3


def _timed(fn, flash: bool, reps: int = FLASH_REPS):
    """(result, mean seconds, launch counts of each call) of ``reps`` calls
    of fn with the flash variable set or unset, every count set to 0 just
    before each call and read just after it."""
    if flash:
        os.environ[FLASH_ENV] = "1"
    else:
        os.environ.pop(FLASH_ENV, None)
    seconds, counts = 0.0, []
    try:
        for _ in range(reps):
            with CountLaunches() as launched:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                seconds += time.perf_counter() - t0
            counts.append(launched.counts)
    finally:
        os.environ.pop(FLASH_ENV, None)
    return out, seconds / reps, counts


def _expect_flash(path: str, per_call: list[dict], launches: int) -> None:
    """Every call launched K5 ``launches`` times and no other kernel."""
    for counts in per_call:
        if counts["flash_attention"] != launches:
            raise AssertionError(
                f"{path}: flash_attention launched {counts['flash_attention']} "
                f"times in a call, want {launches}"
            )
        others = {n: c for n, c in counts.items() if n != "flash_attention" and c}
        if others:
            raise AssertionError(f"{path}: other kernels launched: {others}")


def compare_embed_modes(client, docs: list[str], label: str, card: str) -> int:
    """embed_sync of ``docs`` (one forward batch in the 512-token bucket)
    three times with LEAN_EXPLORE_FLASH_ATTENTION=1 and three times without,
    after a warm call of each: K5 launches once per layer in every flagged
    call and never otherwise, and the embeddings agree (cosine >= 0.999 per
    row). Returns K5's launches in one flagged call."""
    from lean_explore_tpu_torch.models.tokenizer import encode_batch

    width = encode_batch(client.tokenizer, docs, max_length=client.max_length)
    if width.input_ids.shape[1] != 512 or len(docs) > client.batch_size:
        raise AssertionError(f"{label}: not one forward batch in the 512 bucket")
    for flash in (True, False):  # warm both paths at these shapes
        _timed(lambda: client.embed_sync(docs), flash, reps=1)
    emb_flash, s_flash, c_flash = _timed(lambda: client.embed_sync(docs), True)
    emb_plain, s_plain, c_plain = _timed(lambda: client.embed_sync(docs), False)
    _expect_flash(f"{label} with flash", c_flash, client.config.num_hidden_layers)
    _expect_flash(f"{label} without flash", c_plain, 0)
    if not (np.isfinite(emb_flash).all() and emb_flash.shape == emb_plain.shape):
        raise AssertionError(f"{label}: flash embeddings not finite or misshapen")
    cosine = (emb_flash * emb_plain).sum(axis=1) / (
        np.linalg.norm(emb_flash, axis=1) * np.linalg.norm(emb_plain, axis=1)
    )
    diff = float(np.abs(emb_flash - emb_plain).max())
    if not float(cosine.min()) >= 0.999:
        raise AssertionError(f"{label}: flash vs einsum min cosine {cosine.min()}")
    log(
        f"  {label} of {len(docs)} docs at T=512: flash "
        f"{len(docs) / s_flash:.2f} docs/s, einsum {len(docs) / s_plain:.2f} "
        f"docs/s; min cosine {float(cosine.min()):.8f}, max abs diff {diff:.3g}; "
        f"K5 launches {c_flash[0]['flash_attention']} per call (0 without); "
        f"mean of {FLASH_REPS} calls each; {card}"
    )
    return c_flash[0]["flash_attention"]


def run_flash_path(embedder, reranker, card) -> tuple[int, int, int]:
    """The flash path on the phase-4 clients: embed_sync of 64 documents in
    the 512-token bucket (``compare_embed_modes``), rerank_pairs_sync of 64
    pairs in the 256-token bucket the same way (scores within
    RERANK_FLASH_TOL), then embed_sync on a float32 copy of the embedder
    (K5's f32 instantiation). Returns K5's launches in one flagged call of
    each: bf16 embed, rerank, f32 embed."""
    from lean_explore_tpu_torch.models.tokenizer import encode_batch
    from lean_explore_tpu_torch.util.embedding_client import EmbeddingClient

    embed_launches = compare_embed_modes(
        embedder, long_documents(FLASH_DOCS, 300, 511, seed=60), "embed_sync", card
    )

    queries = [f"{WORDS[i * 7 % 3000]} nat thing {i}" for i in range(FLASH_DOCS)]
    pair_docs = long_documents(FLASH_DOCS, 200, 300, seed=61)
    pairs = [reranker._format_pair(q, d) for q, d in zip(queries, pair_docs)]
    width = encode_batch(reranker.tokenizer, pairs, max_length=reranker.max_length)
    if width.input_ids.shape[1] != 256 or FLASH_DOCS > reranker.batch_size:
        raise AssertionError("pairs are not one forward batch in the 256 bucket")
    for flash in (True, False):
        _timed(lambda: reranker.rerank_pairs_sync(queries, pair_docs), flash, reps=1)
    sc_flash, r_flash, rc_flash = _timed(
        lambda: reranker.rerank_pairs_sync(queries, pair_docs), True
    )
    sc_plain, r_plain, rc_plain = _timed(
        lambda: reranker.rerank_pairs_sync(queries, pair_docs), False
    )
    _expect_flash("rerank_pairs_sync with flash", rc_flash, reranker.config.num_hidden_layers)
    _expect_flash("rerank_pairs_sync without flash", rc_plain, 0)
    sc_flash, sc_plain = np.asarray(sc_flash), np.asarray(sc_plain)
    score_diff = float(np.abs(sc_flash - sc_plain).max())
    if not (np.isfinite(sc_flash).all() and score_diff <= RERANK_FLASH_TOL):
        raise AssertionError(
            f"flash vs einsum rerank scores differ by {score_diff} > {RERANK_FLASH_TOL}"
        )
    log(
        f"  rerank_pairs_sync of {FLASH_DOCS} pairs at T=256: flash "
        f"{FLASH_DOCS / r_flash:.2f} pairs/s, einsum {FLASH_DOCS / r_plain:.2f} "
        f"pairs/s; max score diff {score_diff:.3g} (tol {RERANK_FLASH_TOL}); "
        f"K5 launches {rc_flash[0]['flash_attention']} per call (0 without); "
        f"mean of {FLASH_REPS} calls each; {card}"
    )

    f32_client = EmbeddingClient.from_components(
        as_float32(embedder.params), embedder.config, embedder.tokenizer,
        model_name="smoke-qwen3-0.6b-embed-f32", max_length=embedder.max_length,
        batch_size=embedder.batch_size, query_prompt=embedder.query_prompt,
    )
    f32_launches = compare_embed_modes(
        f32_client, long_documents(FLASH_DOCS, 300, 511, seed=62), "f32 embed_sync", card
    )
    del f32_client
    torch.cuda.empty_cache()
    return embed_launches, rc_flash[0]["flash_attention"], f32_launches


def as_float32(params: dict) -> dict:
    """A float32 copy of a trunk's params (the clients' parity setting)."""
    def cast(value):
        if value is None:
            return None
        if isinstance(value, dict):
            return {name: w.float() for name, w in value.items()}
        return value.float()

    return {name: cast(value) for name, value in params.items()}


def run_f32_corpus_search(embedder, ids, card) -> tuple[int, int]:
    """The phase-4 corpus held in float32 on the card, searched with the
    query embeddings of two serving batches: the default method takes K1's
    f32 instantiation (recall@10 against the exact f32 scan >= 0.97), the
    windowed method K3's (scores within score_tolerance of the exact scan, ids
    equal away from near ties). Returns their launches."""
    from lean_explore_tpu_torch.index.dense import DenseIndex
    from lean_explore_tpu_torch.ops.bin_topk import score_tolerance

    dense = DenseIndex(seeded_corpus(embedder.device, len(ids), embedder.dim), ids)
    embs = [embedder.embed_device(queries_for(rep), True) for rep in range(2)]
    torch.cuda.synchronize()
    with CountLaunches() as auto_launched:
        t0 = time.perf_counter()
        got = [dense.search(e, 10) for e in embs]
        torch.cuda.synchronize()
        auto_ms = (time.perf_counter() - t0) / len(embs) * 1e3
    expect_launches("f32 corpus, default method", auto_launched.counts, "bin_topk", len(embs))
    with CountLaunches() as win_launched:
        t0 = time.perf_counter()
        got_win = [dense.search(e, 10, method="windowed") for e in embs]
        torch.cuda.synchronize()
        win_ms = (time.perf_counter() - t0) / len(embs) * 1e3
    expect_launches(
        "f32 corpus, windowed", win_launched.counts, "windowed_scores", len(embs)
    )
    t0 = time.perf_counter()
    want = [dense.search(e, 10, method="full") for e in embs]
    full_ms = (time.perf_counter() - t0) / len(embs) * 1e3
    recall = float(np.mean([
        len(set(g) & set(w)) / 10 for a, b in zip(got, want) for g, w in zip(a[1], b[1])
    ]))
    if not recall >= 0.97:
        raise AssertionError(f"f32 corpus: recall@10 {recall} below 0.97")
    tol = score_tolerance(torch.float32, embedder.dim)
    err = max(float(np.abs(g[0] - w[0]).max()) for g, w in zip(got_win, want))
    if not err <= tol:
        raise AssertionError(f"f32 corpus windowed: score error {err} > {tol}")
    n_differ = sum(int((g[1] != w[1]).sum()) for g, w in zip(got_win, want))
    log(
        f"  f32 corpus {tuple(dense.embeddings.shape)}: default method "
        f"{auto_ms:.2f} ms per batch of {BATCH}, recall@10 vs the exact f32 scan "
        f"{recall:.4f}; windowed {win_ms:.2f} ms, max score error {err:.3g} (tol "
        f"{tol:.3g}), ids differing at near ties {n_differ}; full scan "
        f"{full_ms:.2f} ms; launches {auto_launched.counts} then "
        f"{win_launched.counts}; {card}"
    )
    return auto_launched.counts["bin_topk"], win_launched.counts["windowed_scores"]


def check_results(responses, store) -> None:
    """Every query answered, with real declarations in score order."""
    if len(responses) != BATCH or not all(r.count > 0 for r in responses):
        raise AssertionError("a query came back without results")
    for r in responses:
        if r.count != len(r.results) or r.count > 20:
            raise AssertionError(f"bad envelope for {r.query!r}")
        for res in r.results:
            decl = store.get_by_id(res.id)
            if decl is None or decl.name != res.name:
                raise AssertionError(f"result {res.id} is not the stored row")


def dense_recall_at_10(embedder, dense, queries) -> float:
    """Recall@10 of the kernel path against the exact scan of the same
    index (``method="full"``: the f32 scan of a bf16 index, the exact
    quantized scan of an int8 one) on the same query embeddings; bin
    survivorship loses a top-10 row only to a better row in its bin, so
    this stays near 1."""
    emb = embedder.embed_device(queries, True)
    _, got = dense.search(emb, 10)
    _, want = dense.search(emb, 10, method="full")
    recall = float(np.mean([len(set(g) & set(w)) / 10 for g, w in zip(got, want)]))
    if not recall >= 0.97:
        raise AssertionError(f"dense recall@10 {recall} below 0.97")
    return recall


# ----------------------------------------------------------------------
# Phase 5: training at full width
# ----------------------------------------------------------------------

TRAIN_DECLS = 2000
TRAIN_STEPS, TRAIN_STEPS_RESUMED = 4, 6
# Flash against einsum gradients, f32 at the 0.6B geometry: each layer's
# f32 flash attention lies within eps_attn (relative) of the einsum's,
# ``kernel_tolerance``'s worst case at T = 256, DH = 128 with the RMS-normed
# |q| = |k| = sqrt(DH) (unit norm weights at init): 4 eps + 3 * 2^-22 +
# 7 T 2^-24 with eps = DH^-0.5 (3 * 2^-22 + 7 DH 2^-24) DH, 2.6e-3. The
# perturbations of the L layers add, in the forward and again in the
# backward: loss and every gradient within a relative (L2) 2 L eps_attn.
FLASH_EPS_ATTN = (
    4 * FLASH_DH**-0.5 * (3 * 2.0**-22 + 7 * FLASH_DH * 2.0**-24) * FLASH_DH
    + 3 * 2.0**-22 + 7 * 256 * 2.0**-24
)


def write_training_data(tmp: str):
    """A declaration store of TRAIN_DECLS rows whose informalizations are
    200-249 corpus words (one token each, so the 256-token document bucket
    holds real tokens) and the smoke tokenizer with its special tokens.
    Returns (data_dir, tokenizer)."""
    from lean_explore_tpu_torch.models.store import Declaration, DeclarationStore

    data = Path(tmp) / "train_data"
    data.mkdir()
    tokenizer = make_tokenizer(str(data))
    (data / "tokenizer_config.json").write_text(
        json.dumps({"pad_token": "<pad>", "eos_token": "<eos>", "unk_token": "<unk>"})
    )
    docs = long_documents(TRAIN_DECLS, 200, 250, seed=80)
    store = DeclarationStore(str(data / "declarations.db"), create=True)
    store.insert_many([
        Declaration(
            name=_synthetic_name(i), module=f"Pkg{i % 7}", source_text=f"def x{i}",
            source_link=f"https://example/{i}", informalization=doc,
        )
        for i, doc in enumerate(docs)
    ])
    return data, tokenizer


def export_random_06b(device, data_dir, out_dir) -> float:
    """A random Qwen3-0.6B-geometry f32 checkpoint (seed 3) written by the
    port's ``export_hf_checkpoint``, with the smoke tokenizer. Returns
    seconds."""
    from lean_explore_tpu_torch.models import qwen3
    from lean_explore_tpu_torch.train.export import export_hf_checkpoint

    t = time.perf_counter()
    config = qwen06b_config()
    params = qwen3.init_params(
        config, torch.Generator(device=device).manual_seed(3), device=device
    )
    export_hf_checkpoint(params, config, out_dir, tokenizer_dir=data_dir)
    del params
    torch.cuda.empty_cache()
    return time.perf_counter() - t


def _expect_training_launches(path: str, counts: dict, steps: int, layers: int) -> None:
    """K5's forward, dq and dk/dv each launched once per layer per step,
    and no other kernel."""
    want = {
        "flash_attention": steps * layers,
        "flash_attention_bwd_dq": steps * layers,
        "flash_attention_bwd_dkv": steps * layers,
    }
    got = {n: c for n, c in counts.items() if c}
    if got != want:
        raise AssertionError(f"{path}: launches {got}, want {want}")


# The variables with which an environment can ask the training CLI for the
# CPU (``util.platform.requested_device``, the JAX package's own): unset
# while the CLI runs here, so that it trains on the card whatever a
# machine sets for JAX.
CPU_REQUEST_VARS = ("JAX_PLATFORMS", "XLA_FLAGS")


def run_cli(model_dir, data_dir, ckpt_dir, steps: int, card: str, layers: int):
    """``python -m lean_explore_tpu_torch.train`` in-process with flash on,
    at the CLI defaults (batch 32, queries 64, documents 256 tokens, lr
    1e-5), checkpointing every 2 steps; returns (records, launch counts,
    peak bytes)."""
    from lean_explore_tpu_torch.train.__main__ import main as train_main

    argv = [
        "--model-dir", str(model_dir), "--data-dir", str(data_dir), "--steps", str(steps),
        "--checkpoint-dir", str(ckpt_dir), "--checkpoint-every", "2", "--log-every", "1",
    ]
    saved = {name: os.environ.pop(name) for name in CPU_REQUEST_VARS if name in os.environ}
    if saved:
        log(f"  unset while the CLI trains on the card: {saved}")
    os.environ[FLASH_ENV] = "1"
    torch.cuda.reset_peak_memory_stats()
    try:
        with CountLaunches() as launched:
            records = train_main(argv)
            torch.cuda.synchronize()
    finally:
        os.environ.pop(FLASH_ENV, None)
        os.environ.update(saved)
    peak = torch.cuda.max_memory_allocated()
    if not records or not all(np.isfinite(r["loss"]) for r in records):
        raise AssertionError(f"CLI to step {steps}: losses {records}")
    _expect_training_launches(f"CLI to step {steps}", launched.counts, len(records), layers)
    log(
        f"  CLI to step {steps}: steps {[r['step'] for r in records]}, losses "
        f"{[round(r['loss'], 5) for r in records]}, pairs/s per step "
        f"{[round(TRAIN_B / r['seconds'], 2) for r in records]}, peak memory "
        f"{peak / 2**30:.2f} GiB; launches {launched.counts}; {card}"
    )
    return records, launched.counts, peak


def compare_flash_gradients(device, data_dir, model_dir, card) -> tuple[float, float]:
    """One CLI batch, one InfoNCE loss and backward with the flash variable
    and one without, from the same f32 params: the loss and each parameter
    tensor's gradient within a relative (L2) 2 L FLASH_EPS_ATTN (derived
    above). Returns (loss difference, largest gradient error)."""
    from lean_explore_tpu_torch.models.hf_loader import load_params
    from lean_explore_tpu_torch.models.tokenizer import load_tokenizer
    from lean_explore_tpu_torch.models.store import DeclarationStore
    from lean_explore_tpu_torch.train import ContrastiveDataLoader, infonce_loss, pairs_from_store
    from lean_explore_tpu_torch.train.contrastive import param_leaves, trainable

    params, config = load_params(model_dir, dtype=torch.float32, device=device)
    params = trainable(params)
    pairs = pairs_from_store(DeclarationStore(str(Path(data_dir) / "declarations.db")))
    batch = next(iter(ContrastiveDataLoader(load_tokenizer(model_dir), pairs, seed=5))).to(device)
    results = {}
    for flash in (True, False):
        if flash:
            os.environ[FLASH_ENV] = "1"
        try:
            with CountLaunches() as launched:
                loss, _ = infonce_loss(params, config, batch)
                loss.backward()
                torch.cuda.synchronize()
        finally:
            os.environ.pop(FLASH_ENV, None)
        layers = config.num_hidden_layers if flash else 0
        want = {n: layers for n in
                ("flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")}
        got = {n: launched.counts[n] for n in want}
        if got != want or any(c for n, c in launched.counts.items() if n not in want):
            raise AssertionError(f"flash={flash} gradients: launches {launched.counts}")
        grads = [p.grad.detach().clone() for p in param_leaves(params)]
        results[flash] = (float(loss.detach()), grads)
        for p in param_leaves(params):
            p.grad = None
    tol = 2 * config.num_hidden_layers * FLASH_EPS_ATTN
    loss_diff = abs(results[True][0] - results[False][0])
    if not (np.isfinite(results[True][0]) and loss_diff <= tol * abs(results[False][0])):
        raise AssertionError(f"flash vs einsum loss {results[True][0]} vs {results[False][0]}")
    worst = 0.0
    for g_flash, g_einsum in zip(results[True][1], results[False][1]):
        rel = float((g_flash - g_einsum).norm() / g_einsum.norm().clamp_min(1e-30))
        worst = max(worst, rel)
    if not worst <= tol:
        raise AssertionError(f"flash vs einsum gradients: relative L2 {worst} > {tol}")
    log(
        f"  flash vs einsum at the 0.6B geometry (f32, B={TRAIN_B}): loss "
        f"{results[True][0]:.6f} vs {results[False][0]:.6f} (diff {loss_diff:.3g}); "
        f"worst parameter-gradient relative L2 error {worst:.3g} (tol {tol:.3g}); {card}"
    )
    del params, results
    torch.cuda.empty_cache()
    return loss_diff, worst


def run_cross_encoder(device, data_dir, card) -> dict:
    """Two ``make_ce_train_step`` steps at the 0.6B geometry in bf16 (the
    reranker's serving dtype), pairs truncated to max_length 256, flash on:
    K5 forward, dq and dk/dv once per layer per step, finite losses.
    Returns the launch counts."""
    from lean_explore_tpu_torch.models.tokenizer import load_tokenizer
    from lean_explore_tpu_torch.models.store import DeclarationStore
    from lean_explore_tpu_torch.train import (
        CrossEncoderDataLoader,
        init_train_state,
        make_ce_train_step,
        make_optimizer,
        pairs_from_store,
    )

    config = qwen06b_config()
    optimizer = make_optimizer()
    params, opt_state = init_train_state(
        config, optimizer, seed=4, dtype=torch.bfloat16, device=device
    )
    pairs = pairs_from_store(DeclarationStore(str(Path(data_dir) / "declarations.db")))
    # Matches and mismatches: each query with its own document, and with
    # the next declaration's.
    examples = [(q, d, 1) for q, d in pairs[:64]] + [
        (q, pairs[i + 1][1], 0) for i, (q, _) in enumerate(pairs[:64])
    ]
    loader = iter(CrossEncoderDataLoader(
        load_tokenizer(data_dir), examples, batch_size=TRAIN_B, max_length=256, seed=6
    ))
    step = make_ce_train_step(config, token_true=3, token_false=4)
    batches = [next(loader).to(device) for _ in range(2)]
    os.environ[FLASH_ENV] = "1"
    try:
        with CountLaunches() as launched:
            losses, step_s = [], []
            for batch in batches:
                t0 = time.perf_counter()
                params, opt_state, metrics = step(params, opt_state, batch)
                losses.append(float(metrics["loss"]))  # waits for the step
                step_s.append(time.perf_counter() - t0)
            seconds = sum(step_s)
    finally:
        os.environ.pop(FLASH_ENV, None)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"cross-encoder losses {losses}")
    _expect_training_launches("cross-encoder", launched.counts, 2, config.num_hidden_layers)
    pairs_per_s = 2 * TRAIN_B / seconds
    log(
        f"  cross-encoder (bf16, T=256, B={TRAIN_B}): losses {[round(x, 5) for x in losses]}, "
        f"{pairs_per_s:.2f} pairs/s over 2 steps; launches {launched.counts}; {card}"
    )
    log(f"  5d: {pairs_per_s:.2f} cross-encoder pairs/s (bf16 backward through the dq and "
        f"dk/dv kernels); step seconds {[round(x, 4) for x in step_s]} "
        f"({[round(TRAIN_B / x, 2) for x in step_s]} pairs/s); {card}")
    del params, opt_state
    torch.cuda.empty_cache()
    return launched.counts, pairs_per_s


def run_training(device, kernels, card) -> None:
    """Phase 5: 5b the training CLI to step 4 and, resumed, to step 6; 5c
    flash against einsum gradients; 5d two cross-encoder steps. The kernel
    checks at the training shape (5a) ran in phase 3."""
    by_name = {k["name"]: k for k in kernels}
    layers = qwen06b_config().num_hidden_layers
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        data_dir, _ = write_training_data(tmp)
        model_dir = Path(tmp) / "model"
        seconds = export_random_06b(device, data_dir, model_dir)
        size = (model_dir / "model.safetensors").stat().st_size
        log(f"  random 0.6B f32 checkpoint exported ({size / 1e9:.2f} GB) in {seconds:.1f} s")
        ckpt = Path(tmp) / "ckpt"
        with Phase("5b. training CLI, 4 steps then resumed to 6"):
            first, counts, _ = run_cli(model_dir, data_dir, ckpt, TRAIN_STEPS, card, layers)
            if [r["step"] for r in first] != list(range(1, TRAIN_STEPS + 1)):
                raise AssertionError(f"first run steps {[r['step'] for r in first]}")
            resumed, _, _ = run_cli(model_dir, data_dir, ckpt, TRAIN_STEPS_RESUMED, card, layers)
            want = list(range(TRAIN_STEPS + 1, TRAIN_STEPS_RESUMED + 1))
            if [r["step"] for r in resumed] != want:
                raise AssertionError(f"the rerun did not resume: {[r['step'] for r in resumed]}")
            for suffix in ("dq", "dkv"):
                row = by_name[f"flash_attention_bwd_{suffix}_f32"]
                row["launches"] = counts[f"flash_attention_bwd_{suffix}"]
                row["launches_per_step"] = layers
        with Phase("5c. flash against einsum gradients at full width"):
            compare_flash_gradients(device, data_dir, model_dir, card)
        with Phase("5d. cross-encoder, two steps"):
            counts, pairs_per_s = run_cross_encoder(device, data_dir, card)
            for suffix in ("dq", "dkv"):
                row = by_name[f"flash_attention_bwd_{suffix}"]
                row["launches"] = counts[f"flash_attention_bwd_{suffix}"]
                row["launches_per_step"] = layers
                row["cross_encoder_pairs_per_s"] = pairs_per_s
    for forbidden in ("jax", "lean_explore_tpu"):
        if forbidden in sys.modules:
            raise AssertionError(f"{forbidden} was imported on the training path")


# ----------------------------------------------------------------------
# Phase 6: index build and quality at the 200k chain
# ----------------------------------------------------------------------

# The committed chain (runs/scale200k): its corpus (runs/scale200k/*/eval.json,
# "task"), its serving lengths (embedder 128, reranker 192: docs/training.md
# "Config-5 scale", runs/scale200k/trunc_probe.json) and its full-pipeline
# quality from the JAX package on a TPU (runs/scale200k/cascade_eval.json,
# pinned by tests/test_torch_evaluation.py).
CHAIN_DIR = Path("runs") / "scale200k"
CHAIN_CORPUS = dict(n_decls=200_000, n_concepts=6000, n_eval=512, seed=0, body_sentences=5)
CHAIN_EMB_MAX_LENGTH, CHAIN_RR_MAX_LENGTH, CHAIN_RERANK_TOP = 128, 192, 50
CHAIN_REFERENCE = {"recall_at_1": 0.9688, "recall_at_10": 0.9883, "mrr_at_10": 0.9785}
# The cascade arms of the same record, each held to its own row, except
# 24,8, the kept divergence ROADMAP C6: on the coverage cliff its keep sets
# turn on P(true) gaps of 1e-5 and less, and the port's equal the JAX
# client's in f32 on every query whose top-1 the cascade changes
# (tests/test_torch_rerank_cascade.py), so that arm is logged beside its
# row and held instead to the committed keep sets of the closest queries
# (CHAIN_CLIFF, scripts/dump_cascade_divergence.py).
CHAIN_CASCADE_POINTS = ("48,16", "48,25", "24,8")
CHAIN_DIVERGENT_ARM = "cascade_24_8"
CHAIN_CLIFF = CHAIN_DIR / "cascade_24_8_divergence.json"
CHAIN_CASCADE_REFERENCE = {
    "cascade_48_16": {"recall_at_1": 0.9648, "recall_at_10": 0.9883, "mrr_at_10": 0.974},
    "cascade_48_25": {"recall_at_1": 0.9707, "recall_at_10": 0.9883, "mrr_at_10": 0.9785},
    "cascade_24_8": {"recall_at_1": 0.7773, "recall_at_10": 0.9531, "mrr_at_10": 0.8445},
}
CHAIN_QUERY_SLACK, CHAIN_MRR_SLACK = 2, 0.004


def chain_checkpoints(repo: Path) -> tuple[Path, Path]:
    """The chain's committed embedder and reranker directories; raises when
    either is incomplete (no random stand-in)."""
    dirs = tuple(repo / CHAIN_DIR / m / "checkpoint" for m in ("embedder", "reranker"))
    for d in dirs:
        for name in ("config.json", "model.safetensors", "tokenizer.json"):
            if not (d / name).is_file():
                raise FileNotFoundError(f"phase 6 needs the committed checkpoint file {d / name}")
    return dirs


def tree_bytes(root: Path) -> int:
    """Bytes of the files under ``root`` (the copy this run works from),
    the kernels' build directory left out."""
    total = 0
    for dirpath, dirnames, filenames in os.walk(root):
        if Path(dirpath) == root:
            dirnames[:] = [d for d in dirnames if d not in (".git", "build")]
        total += sum(os.path.getsize(os.path.join(dirpath, f)) for f in filenames)
    return total


def load_script(repo: Path, name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, repo / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SPLIT_DOCS = 20_000


def embed_split(embedder, corpus, seconds: dict, card: str) -> None:
    """Where the embedding stage's time goes, from its first SPLIT_DOCS
    documents in the stage's batches: the host tokenizer alone
    (``encode_batch``), then ``embed_sync`` (tokenizer, trunk and copy
    back); the rest of the stage, scaled to its documents, is the store's
    reads and writes."""
    from lean_explore_tpu_torch.models.tokenizer import encode_batch

    docs = [d.informalization for d in corpus.declarations[:SPLIT_DOCS]]
    batch = embedder.batch_size
    t = time.perf_counter()
    for start in range(0, len(docs), batch):
        encode_batch(embedder.tokenizer, docs[start : start + batch],
                     max_length=embedder.max_length, append_eos=True)
    tok_s = time.perf_counter() - t
    t = time.perf_counter()
    for start in range(0, len(docs), batch):
        embedder.embed_sync(docs[start : start + batch])
    embed_s = time.perf_counter() - t
    scale = len(corpus.declarations) / len(docs)
    store_s = seconds["embed"] - embed_s * scale
    log(
        f"  embedding stage split over {len(docs)} docs: tokenizer "
        f"{len(docs) / tok_s:.1f} docs/s ({tok_s * scale:.1f} s of the stage), "
        f"trunk and copy {(embed_s - tok_s) * scale:.1f} s, store reads and "
        f"writes {store_s:.1f} s, of {seconds['embed']:.1f} s; {card}"
    )
    seconds.update(split_tokenizer=tok_s * scale, split_trunk=(embed_s - tok_s) * scale,
                   split_store=store_s)


def eval_arm(engine, corpus, batches: int, point: str | None) -> tuple[dict, float, dict]:
    """``evaluate_engine`` over the chain's eval queries with every launch
    count set to 0 before and read after, LEAN_EXPLORE_RERANK_CASCADE set
    to ``point`` (popped after, and before when None); K1-f32 must launch
    once per batch of 64 and no other kernel. Returns the metrics, the
    seconds and the counts."""
    from lean_explore_tpu_torch.evaluation import evaluate_engine

    os.environ.pop("LEAN_EXPLORE_RERANK_CASCADE", None)
    if point is not None:
        os.environ["LEAN_EXPLORE_RERANK_CASCADE"] = point
    try:
        with CountLaunches() as launched:
            t = time.perf_counter()
            metrics = evaluate_engine(engine, corpus.eval_queries, rerank_top=CHAIN_RERANK_TOP)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t
    finally:
        os.environ.pop("LEAN_EXPLORE_RERANK_CASCADE", None)
    expect_launches(f"quality eval ({point or 'full'})", launched.counts, "bin_topk", batches)
    if launched.counts["bin_topk"] != batches:
        raise AssertionError(f"K1-f32 launched {launched.counts['bin_topk']} times, not {batches}")
    if metrics["n_queries"] != CHAIN_CORPUS["n_eval"]:
        raise AssertionError(f"quality eval ran {metrics['n_queries']} queries")
    return metrics, seconds, launched.counts


def hold_to_reference(label, metrics, reference, seconds, counts, batches, card) -> list[str]:
    """Logs ``metrics`` beside the committed JAX row and returns the keys
    beyond CHAIN_QUERY_SLACK queries (CHAIN_MRR_SLACK for MRR)."""
    n = metrics["n_queries"]
    lines, misses = [], []
    for key, want in reference.items():
        got = metrics[key]
        if key.startswith("recall"):
            diff = round(got * n) - round(want * n)
            lines.append(f"{key} {got:.4f} (JAX {want:.4f}, {diff:+d} queries)")
            if abs(diff) > CHAIN_QUERY_SLACK:
                misses.append(f"{label} {key}")
        else:
            lines.append(f"{key} {got:.4f} (JAX {want:.4f}, {got - want:+.4f})")
            if abs(got - want) > CHAIN_MRR_SLACK + 1e-9:
                misses.append(f"{label} {key}")
    log(
        f"  {label} over {n} queries at rerank_top {CHAIN_RERANK_TOP}: "
        f"{'; '.join(lines)}; eval {seconds:.1f} s; K1-f32 launches "
        f"{counts['bin_topk']} ({batches} batches); {card}"
    )
    return misses


def check_cliff_keep_sets(reranker, repo: Path, card: str) -> None:
    """The cascade's stage 1 on the card keeps, for each query of
    CHAIN_CLIFF, the committed keep set (equal to the JAX client's in f32,
    tests/test_torch_rerank_cascade.py)."""
    record = json.loads((repo / CHAIN_CLIFF).read_text())
    rows = record["queries"]
    scores = reranker.rerank_grouped_sync(
        [r["query"] for r in rows], [r["documents"] for r in rows],
        suffix_cap=record["cap"],
    )
    keep = record["keep"]
    differ = [
        r["index"] for r, s in zip(rows, scores)
        if sorted(range(len(s)), key=lambda j: s[j], reverse=True)[:keep] != r["keep"]
    ]
    err = max(float(np.abs(np.asarray(s) - r["stage1_scores"]).max()) for r, s in zip(rows, scores))
    gaps = sorted(r["gap"] for r in rows)
    log(
        f"  cascade {record['point']} at the cliff: {len(rows)} queries whose target sits "
        f"{gaps[0]:.3g}-{gaps[-1]:.3g} in P(true) from the keep boundary; keep sets "
        f"differing from the committed ones {differ}; stage-1 scores within {err:.3g} of "
        f"the committed; {card}"
    )
    if differ:
        raise AssertionError(f"stage-1 keep sets at the cliff differ for queries {differ}")


def expect_int8_leaves(client) -> None:
    """Every projection leaf of ``client`` is int8 on the card."""
    from lean_explore_tpu_torch.models import qwen3

    leaves = {n: w for n, w in client.params["layers"].items() if n in qwen3._INT8_PROJS}
    if not client.int8 or len(leaves) != 7 or any(
        w["w8"].dtype != torch.int8 or w["w8"].device.type != "cuda" for w in leaves.values()
    ):
        raise AssertionError(
            f"int8 reranker leaves: {[(n, w['w8'].dtype, w['w8'].device) for n, w in leaves.items()]}"
        )


def run_quality_chain(device, kernels, card, repo: Path) -> None:
    """Phase 6 through scripts/eval_torch_quality.py's stages: build the
    chain's index on the card, then evaluate it with every launch count set
    to 0 before and read after, in five arms: the full pipeline, the
    cascade at each of CHAIN_CASCADE_POINTS, each held to its row of the
    committed record, and the int8 reranker (the chain's reranker loaded in
    bf16 and quantized), gated only on its int8 leaves and launch counts.
    K1-f32 must launch once per batch of 64 in each arm."""
    from lean_explore_tpu_torch.search.engine import SearchEngine
    from lean_explore_tpu_torch.train.synthetic import make_corpus
    from lean_explore_tpu_torch.util.embedding_client import EmbeddingClient
    from lean_explore_tpu_torch.util.reranker_client import RerankerClient

    log(card)
    embedder_dir, reranker_dir = chain_checkpoints(repo)
    ckpt_bytes = sum(
        f.stat().st_size for d in (embedder_dir, reranker_dir) for f in d.iterdir()
    )
    log(
        f"  checkpoints {ckpt_bytes / 1e6:.1f} MB; this copy of the repo "
        f"{tree_bytes(repo) / 1e6:.1f} MB"
    )
    script = load_script(repo, "eval_torch_quality")
    t = time.perf_counter()
    corpus = make_corpus(**CHAIN_CORPUS)
    log(f"  make_corpus {CHAIN_CORPUS} in {time.perf_counter() - t:.1f} s")
    embedder = EmbeddingClient(
        str(embedder_dir), max_length=CHAIN_EMB_MAX_LENGTH,
        batch_size=script.EMBED_BATCH, dtype=torch.float32, device=device,
    )
    reranker = RerankerClient(
        str(reranker_dir), max_length=CHAIN_RR_MAX_LENGTH, dtype=torch.float32,
        device=device,
    )
    with tempfile.TemporaryDirectory(prefix="chip_smoke_chain_") as tmp:
        store, seconds = script.build_index(corpus, embedder, Path(tmp))
        log(
            f"  store {seconds['store']:.1f} s; embedding stage "
            f"{seconds['embed_docs_per_s']:.1f} docs/s ({len(corpus.declarations)} "
            f"docs in {seconds['embed']:.1f} s, f32, max_length "
            f"{CHAIN_EMB_MAX_LENGTH}); artifact build (build_indices) "
            f"{seconds['build']:.1f} s; {card}"
        )
        embed_split(embedder, corpus, seconds, card)
        engine, load_s = script.open_engine(Path(tmp), store, embedder, reranker, device)
        dense = engine._artifacts.dense
        if dense.embeddings.dtype != torch.float32 or dense.device.type != "cuda":
            raise AssertionError(f"the eval corpus is {dense.embeddings.dtype} on {dense.device}")
        log(f"  load_index_artifacts {tuple(dense.embeddings.shape)} float32 on the card in {load_s:.1f} s")
        batches = -(-len(corpus.eval_queries) // 64)
        arms = {}
        for label, point in [("full_pipeline", None)] + [
            (f"cascade_{p.replace(',', '_')}", p) for p in CHAIN_CASCADE_POINTS
        ]:
            arms[label] = eval_arm(engine, corpus, batches, point)
        int8_reranker = RerankerClient(
            str(reranker_dir), max_length=CHAIN_RR_MAX_LENGTH, dtype="int8", device=device,
        )
        expect_int8_leaves(int8_reranker)
        int8_engine = SearchEngine(
            Path(tmp), store=store, artifacts=engine._artifacts, embedding_client=embedder,
            reranker_client=int8_reranker, device=device,
        )
        with CountIntMM() as int_mm:
            arms["int8_reranker"] = eval_arm(int8_engine, corpus, batches, None)
        if int_mm.calls == 0:
            raise AssertionError("the int8 reranker arm never reached torch._int_mm")
        store.close()
    metrics, eval_s, counts = arms["full_pipeline"]
    misses = hold_to_reference("quality", metrics, CHAIN_REFERENCE, eval_s, counts, batches, card)
    log("  " + json.dumps({"quality_chain": metrics, "seconds": {
        **{k: round(v, 3) for k, v in seconds.items()}, "load": round(load_s, 3),
        "eval": round(eval_s, 3)}, "launches": counts}))
    for label, reference in CHAIN_CASCADE_REFERENCE.items():
        arm_metrics, arm_s, arm_counts = arms[label]
        arm_misses = hold_to_reference(
            label, arm_metrics, reference, arm_s, arm_counts, batches, card
        )
        if label == CHAIN_DIVERGENT_ARM:
            log(f"  {label}: beyond its TPU row {arm_misses or 'nowhere'} (kept divergence, ROADMAP C6)")
        else:
            misses += arm_misses
    check_cliff_keep_sets(reranker, repo, card)
    int8_metrics, int8_s, int8_counts = arms["int8_reranker"]
    log(
        f"  int8 reranker arm (runs/scale200k reranker loaded in bf16 and quantized; "
        f"torch._int_mm calls {int_mm.calls}): "
        + "; ".join(
            f"{k} {int8_metrics[k]:.4f} ({int8_metrics[k] - metrics[k]:+.4f} against f32)"
            for k in CHAIN_REFERENCE
        )
        + f"; eval {int8_s:.1f} s; K1-f32 launches {int8_counts['bin_topk']}; {card}"
    )
    log("  " + json.dumps({"quality_chain_arms": {
        label: {**m, "seconds": round(t, 3)} for label, (m, t, _) in arms.items()}}))
    by_name = {k["name"]: k for k in kernels}
    by_name["bin_topk_f32"]["quality_eval_launches"] = counts["bin_topk"]
    if misses:
        raise AssertionError(
            f"quality eval: {misses} beyond {CHAIN_QUERY_SLACK} queries (MRR "
            f"{CHAIN_MRR_SLACK}) of the committed JAX numbers"
        )
    for forbidden in ("jax", "lean_explore_tpu"):
        if forbidden in sys.modules:
            raise AssertionError(f"{forbidden} was imported on the index-build path")


if __name__ == "__main__":
    sys.exit(main())
