"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --kernels  # phases 1-3b only (build + kernel checks)
    python3 chip_smoke.py --training-chain [--seed N]  # phases 1, 2 and 7
    python3 chip_smoke.py --extraction  # phases 1, 2 and 8
    python3 chip_smoke.py --mesh  # phases 1, 2 and 9
    python3 chip_smoke.py --tools  # phases 1, 2, 6 (embedded without 8) and 10

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
   4g. the serving surfaces in-process on the phase-4 bf16 service: the
   port's HTTP server (``api.server.serve``, coalescing window 100 ms,
   max batch 128) answering one burst of 128 concurrent /search requests
   through ``ApiClient``, each answer's ids equal to a direct
   ``Service.search_batch`` of the engine batch the batcher ran, K1 once
   per engine batch and no other kernel, the same burst from another
   process (``scripts/http_openloop_client.py``), then ``/declarations/{id}``, a
   request without the key (401) and ``/healthz``; and the MCP app's
   ``run_stdio`` on ``os.pipe``s (initialize, tools/list, search_summary,
   search, get_source_code), its answers equal to ``Service.search``'s;
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
8. (before phase 6, which uses its embeddings; its host stages, parse,
   informalize and the BPE timing, run in a child process started with
   phase 7's, beside phases 4 and 5, since they load one core of the host
   and nothing of the card) build the
   index of the committed 200k chain with the port's extraction pipeline
   from doc-gen4's output: ``make_corpus`` at the chain's arguments
   written as a doc-gen4 workspace (one Lean source file per module and
   an api-docs.db with a RenderedCode type for each declaration), the
   data and cache roots set to a
   fresh temporary directory, then ``extract.__main__.run_pipeline`` with
   parse, informalize (an in-process client answering each prompt with
   its declaration's synthetic informalization), embed (a float32
   ``EmbeddingClient`` on runs/scale200k/embedder/checkpoint, on the card)
   and index, each stage timed with its rows/s; before it, 1,000 other
   declarations parsed and informalized through ``OpenRouterClient``
   against a stub server on localhost. The store must equal
   ``make_corpus``'s (names, modules, source texts, informalizations),
   every declaration must be informalized and embedded once (the
   manifest's n_embedded 200,000), ``evaluate_engine`` over the artifacts
   (float32 corpus, K1-f32 once a batch of 64) must lie within 2 queries
   of the committed JAX numbers, and one ``Service.search_batch`` of 128
   queries at the serving defaults (bf16 corpus, K1 once) must give the
   ids of an in-process engine built the same default way; the
   byte-level BPE reader (tests/fixtures/bpe_qwen_style) encodes and
   decodes every informalization back, beside the WordLevel reader.
6. index the 200k chain as the committed runs did and evaluate it: a
   ``DeclarationStore`` of ``make_corpus``'s declarations in the corpus's
   order (the fusion breaks ties by id, so the pipeline's module-ordered
   ids move the cascade arms by up to 5 queries), each with the embedding
   phase 8 computed on the card for it, ``build_indices``; the first
   20,000 documents' ``embed_sync`` rows within 1e-5 of the pipeline's,
   ``load_index_artifacts`` with a float32 corpus on the
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
   6b. the entry points as processes over the chain's artifacts, with
   the chain's checkpoints, serving lengths and a float32 corpus given
   through the environment: ``python -m lean_explore_tpu_torch.api.server
   --warmup`` queried through ``ApiClient``, a stdio session with
   ``python -m lean_explore_tpu_torch.mcp.server --backend local`` and
   ``python -m lean_explore_tpu_torch.cli.main search --local``; each
   answer's ids (the CLI's names) equal to an in-process
   ``SearchEngine(data_dir, device="cuda")`` built the same default way.
   A child that exits non-zero, prints outside its protocol or times out
   fails the phase, with the tail of its stderr.
7. train both models end to end at the committed 20k chain's task and
   widths (runs/embedder/eval.json, runs/reranker/eval.json: 20,000
   declarations, 1,200 concepts, 512 held-out queries) with the port's
   scripts, in a child process of the card started once phase 3b has
   ended, so that its host-bound training runs beside phases 4-6, 8, 9
   and 10 (read after phase 10; ``--training-chain`` runs it alone, the
   way to time its steps): scripts/train_torch_embedder_e2e.py at 384 x 6,
   3000 steps, --paraphrases, then scripts/train_torch_reranker_e2e.py at
   4000 steps on the embedder it trained (every other flag at its
   default, --seed 0 unless ``--seed`` says otherwise; both start from
   the JAX package's init at that seed, the scripts' draw). At seed 0
   the task data must equal the records (train split, padded
   vocabularies, the reranker's examples), the trained embedder must land
   within 4 queries of 512 of the JAX script's own float32 run from the
   same init (runs/jax_f32_cpu/embedder_eval.json), and the reranker's
   direct recall@1-of-50 and full-pipeline recall@1 and @10 must lie no
   more than 4 queries under the JAX reranker script's own float32 run
   from that init (runs/jax_f32_cpu/reranker_eval.json; one-sided, its
   training being chaotic, ROADMAP C7 and C8). The floors set from the
   committed JAX numbers (a TPU run) are logged beside them at every
   seed. At every seed BM25 alone and the random inits must stay near
   zero. A torch.profiler trace of each trainer's last 20 steps gives
   the device's busy share of a step.
   K1-f32 must launch once per batch of 64 in every eval arm with a
   dense stage and no other kernel, and no kernel may launch during the
   training steps (every length <= 128, under flash attention's 256); the
   trained geometry's K1-f32 top-10 must equal its plain twin's where
   scores are untied and overlap the exact scan's >= 0.97. Logged beside
   the card: each trainer's pairs/s after its first 100 steps, the
   loader's share of a step, peak memory, embedding docs/s and each eval
   arm's seconds.
9. the mesh on the one card, as virtual devices (the JAX tests' host
   devices are virtual too; real cross-card traffic needs more cards).
   9a (after 4g, on the phase-4 set-up): a ``ShardedDenseIndex`` over
   ``make_mesh((2, 4), devices=[cuda:0] * 8)`` from the phase-4 corpus in
   bf16 (300,000 rows padded to 301,056, shards of 75,264), the phase-4
   clients on the flat data mesh of those 8, ``Service.search_batch``: one
   warm and two timed batches of 128, K1 exactly 8 times a batch (each
   position's 64 queries over its shard) and no other kernel; each shard's
   K1 carry against its plain twin, the merged top-1000 against the plain
   sharded twin (the same search with the plain carries), dense recall@10
   against the exact scan >= 0.97, the DP rerank's P(true) on the last
   batch's groups within RERANK_DP_TOL of one device's, and the final ids
   logged against phase 4's single-device service (equal top-10s, and for
   each difference whether the dense candidates or the rerank changed).
   9b the same index over the corpus in int8 through K2: one warm and one
   timed batch, K2 8 times a batch, each shard's carry and the merge equal
   to their plain twins. 9c (after 5d): the contrastive CLI
   in four processes on the card at ``--mesh 2,2`` (gloo), at phase 5's
   width cut to 2 layers, flash on, batch 32, queries 64, documents 256:
   two steps with a checkpoint each, resumed to step 3; then on one device
   to step 2 from the same init and from the mesh's step-2 checkpoint to
   step 3. Step 1's AdamW first moments (a tenth of step 1's gradients,
   from the same params and batch) within MESH_GRAD_REL_L2 of each other,
   each step's loss and the params at steps 2 and 3 within the CPU
   test's tolerance of each other; on every rank K5's forward, dq and
   dk/dv once per layer per step and no other kernel; each mesh step's
   seconds logged as four processes on one card.
10. (after phase 6) the quality and cascade-calibration tools of
   ``lean_explore_tpu_torch.evaluation`` at full width on the committed
   checkpoints. 10a on phase 6's engine: one capture
   (``capture_rerank_groups``) of the 192 queries of both cascade records
   (``make_corpus`` at the chain's arguments with n_eval 192, whose
   picks search phase 6's declarations), K1-f32 once a batch of 64 and
   no other kernel, then the caps 8, 12, 16, 24, 32, 48, 64 and 96, each
   scored once (``score_caps``), and from that one scoring the
   calibration's rows (keep 16, floor 0.95), which must recommend cap 48
   with containment_top1 and _top3 within 2 queries of
   runs/scale200k/cascade_calibration.json, and the coverage's, whose
   top-8/12/16/25 shares must lie within 2 queries of
   runs/scale200k/prescreen_coverage.json. 10b: the committed 20k chain
   (runs/embedder and runs/reranker checkpoints in float32, lengths 64 and
   128) indexed on the card; the three name classes of
   ``make_name_queries`` (128 queries each) in the four configurations of
   scripts/eval_query_classes.py and the semantic class's full pipeline,
   each within 2 queries (MRR 0.004) of runs/query_classes/eval.json,
   K1-f32 once a batch of 64 in every arm with a dense stage and no
   kernel in BM25's; then the int8 effects on the same index, held to
   runs/int8_effects.json: the plain bin-max scan's and the int8 corpus's
   (K2, once, its carry equal to its twin's bit for bit) dense recall@10
   within 0.01, the W8A8 reranker's recall@1-of-50 beside the float32
   one's and their top-1 agreement within 2 queries of 128. The rows of
   the kept divergence ROADMAP C11 (calibration cap 24, the semantic full
   pipeline, the plain scan's dense recall) are held instead to JAX's own
   float32 runs on the CPU (runs/scale200k/cascade_calibration_cap24_divergence.json,
   runs/jax_f32_cpu) and logged beside their TPU rows.
Every kernel's launch count is set to 0 just before each path of phases
3b, 4, 4g, 5, 6, 7, 8, 9 and 10 is driven and read just after it.

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
    parser.add_argument(
        "--training-chain", action="store_true",
        help="phases 1, 2 and 7 only: build the kernels, then train and "
        "evaluate the 20k chain",
    )
    parser.add_argument(
        "--extraction", action="store_true",
        help="phases 1, 2 and 8 only: build the kernels, then run the extraction "
        "pipeline at the 200k chain",
    )
    parser.add_argument(
        "--mesh", action="store_true",
        help="phases 1, 2 and 9 only: build the kernels, then serve and train on a "
        "mesh of virtual devices on the card",
    )
    parser.add_argument(
        "--tools", action="store_true",
        help="phases 1, 2, 6 and 10 only: build the kernels, index the 200k chain "
        "(embedded without phase 8) and hold the quality tools to their records",
    )
    parser.add_argument("--tools-dump", type=Path, default=None,
                        help="write 10a's captured groups and cap scores here")
    parser.add_argument("--seed", type=int, default=0, help="phase 7's --seed")
    parser.add_argument("--extraction-host", type=Path, default=None,
                        help=argparse.SUPPRESS)  # phase 8's child process
    parser.add_argument("--training-chain-child", type=Path, default=None,
                        help=argparse.SUPPRESS)  # phase 7's child process
    parser.add_argument("--card", default="", help=argparse.SUPPRESS)
    parser.add_argument("--mesh-rank", type=int, default=None,
                        help=argparse.SUPPRESS)  # a rank of phase 9c
    parser.add_argument("--mesh-job", type=Path, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.extraction_host is not None:
        # Phase 8's host stages, in the child that phase 8 starts: no card.
        return run_extraction_host(args.extraction_host, args.card)
    if args.mesh_rank is not None:
        return run_mesh_rank(args.mesh_job, args.mesh_rank)
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
    if args.training_chain_child is not None:
        # Phase 7 in the child that the default run starts: the kernels
        # are built already.
        return run_training_chain_child(args.training_chain_child, device, args.card,
                                        repo, args.seed)

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

    if args.training_chain:
        kernels = [{"name": "bin_topk_f32"}]
        with Phase("7. training end to end at the 20k chain"):
            run_training_chain(device, kernels, card, repo, args.seed)
        log(json.dumps({"kernels": kernels}))
        log(json.dumps(device_record()))
        return 0

    if args.extraction:
        kernels = [{"name": "bin_topk"}, {"name": "bin_topk_f32"}]
        with tempfile.TemporaryDirectory(prefix="chip_smoke_chain_") as root:
            host = extraction_host(Path(root), card)
            try:
                with Phase(EXTRACTION_PHASE):
                    built = run_extraction_chain(device, kernels, card, repo, Path(root), host)
                built["store"].close()
            finally:
                host.stop()
        log(json.dumps({"kernels": kernels}))
        log(json.dumps(device_record()))
        return 0

    if args.tools:
        kernels = [{"name": "bin_topk_f32"}, {"name": "bin_topk_int8"}]
        with tempfile.TemporaryDirectory(prefix="chip_smoke_chain_") as root:
            with Phase("6. index of the 200k chain in the corpus's order and its quality"):
                built = embed_chain(device, repo, Path(root), card)
                engine = run_quality_chain(device, kernels, card, repo, built)
            with Phase(TOOLS_PHASE):
                run_tools(engine, built, device, kernels, card, repo,
                          Path(root), args.tools_dump)
            engine.store.close()
        log(json.dumps({"kernels": kernels}))
        log(json.dumps(device_record()))
        return 0

    if args.mesh:
        kernels = [{"name": name} for name in MESH_KERNEL_ROWS]
        run_mesh_phases(device, kernels, card)
        log(json.dumps({"kernels": kernels}))
        log(json.dumps(device_record()))
        return 0

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
        with tempfile.TemporaryDirectory(prefix="chip_smoke_chain_") as root:
            # Phase 7's training and phase 8's host stages run in children
            # beside the other phases: both leave the card mostly idle.
            chain = ChildPhase(Path(root), "training_chain", "--training-chain-child",
                               "--card", card, "--seed", str(args.seed))
            host = extraction_host(Path(root), card)
            try:
                with Phase("serving paths at full width"):
                    run_service(device, kernels, card)
                with Phase("5. training at full width"):
                    run_training(device, kernels, card)
                with Phase(EXTRACTION_PHASE):
                    built = run_extraction_chain(device, kernels, card, repo, Path(root), host)
                with Phase("6. index of the 200k chain in the corpus's order and its quality"):
                    engine = run_quality_chain(device, kernels, card, repo, built)
                with Phase(TOOLS_PHASE):
                    run_tools(engine, built, device, kernels, card, repo,
                              Path(root), args.tools_dump)
                engine.store.close()
                built["store"].close()
                with Phase("7. training end to end at the 20k chain (its child, waited for)"):
                    f32_row.update(chain.result())
            finally:
                host.stop()
                chain.stop()

    log(json.dumps({"kernels": kernels}))
    log(json.dumps(device_record()))
    return 0


def device_record() -> dict:
    """The last line's record of the card the run used."""
    return {
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }


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
        with Phase("4g. the serving surfaces in-process: HTTP burst through ApiClient, MCP on pipes"):
            http_launches, service = run_http_surface(serving, card)
            mcp_launches = run_mcp_surface(service, card)
            by_name["bin_topk"]["http_launches"] = http_launches
            by_name["bin_topk"]["mcp_launches"] = mcp_launches
            del service
        run_mesh_serving(serving, kernels, card)
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
# Phase 4g: the serving surfaces in-process
# ----------------------------------------------------------------------

SURFACE_KEY = "chip-smoke-key"
SURFACE_LIMIT = 20
COALESCE_MS = 100.0


def _ids(response) -> list[int]:
    return [r.id for r in response.results]


def run_http_surface(serving, card) -> tuple[int, object]:
    """The port's HTTP server (``api.server.serve``) in-process on the
    phase-4 bf16 service: one burst of BATCH concurrent /search requests
    through ``ApiClient`` with every launch count set to 0 before it and
    read after it; each answer's ids equal to a direct
    ``Service.search_batch`` of the batch the batcher ran (its queries in
    its order), K1 launched once per engine batch and no other kernel;
    then ``/declarations/{id}``, a request without the key (401) and
    ``/healthz``. Returns K1's launches and the direct service."""
    import threading
    import urllib.error
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from lean_explore_tpu_torch.api import ApiClient
    from lean_explore_tpu_torch.api.server import serve
    from lean_explore_tpu_torch.search.service import Service

    class RecordingService(Service):
        """Records each search_batch call's queries, in the order run."""

        def __init__(self, engine):
            super().__init__(engine)
            self.batches: list[tuple[list[str], dict]] = []

        async def search_batch(self, queries, **kwargs):
            self.batches.append((list(queries), dict(kwargs)))
            return await super().search_batch(queries, **kwargs)

    direct = serving.service()
    service = RecordingService(direct.engine)
    t = time.perf_counter()
    asyncio.run(service.warmup(batch=BATCH))
    log(f"  Service.warmup(batch={BATCH}) {time.perf_counter() - t:.2f} s")
    server = serve(
        service, port=0, api_key=SURFACE_KEY, coalesce_ms=COALESCE_MS, max_batch=BATCH
    )
    threading.Thread(target=server.serve_forever, name="http-surface", daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    client = ApiClient(api_key=SURFACE_KEY, base_url=f"{url}/api/v2", timeout=600)
    try:
        asyncio.run(client.search(queries_for(7)[0], limit=SURFACE_LIMIT))  # warm
        queries = queries_for(3)
        batcher = server.batcher
        runs_before, sizes_before = batcher.batches_run, len(batcher.batch_sizes)
        service.batches.clear()
        # When each request reached the batcher (handler threads call
        # submit_search once the request is parsed).
        arrivals: list[float] = []
        submit = batcher.submit_search

        def timed_submit(*args, **kwargs):
            arrivals.append(time.perf_counter())
            return submit(*args, **kwargs)

        batcher.submit_search = timed_submit

        async def burst():
            asyncio.get_running_loop().set_default_executor(ThreadPoolExecutor(BATCH))

            async def one(query):
                start = time.perf_counter()
                response = await client.search(query, limit=SURFACE_LIMIT)
                return response, time.perf_counter() - start

            start = time.perf_counter()
            out = await asyncio.gather(*(one(q) for q in queries))
            return out, time.perf_counter() - start, start

        with CountLaunches() as launched:
            answers, wall, burst_start = asyncio.run(burst())
            torch.cuda.synchronize()
        n_batches = batcher.batches_run - runs_before
        sizes = batcher.batch_sizes[sizes_before:]
        if len(answers) != BATCH or sum(sizes) != BATCH or len(service.batches) != n_batches:
            raise AssertionError(
                f"burst of {BATCH}: {len(answers)} answers, batches {n_batches} of "
                f"sizes {sizes}, {len(service.batches)} search_batch calls"
            )
        expect_launches("HTTP burst", launched.counts, "bin_topk", n_batches)
        if launched.counts["bin_topk"] != n_batches:
            raise AssertionError(
                f"HTTP burst: K1 launched {launched.counts['bin_topk']} times in "
                f"{n_batches} engine batches"
            )
        got = {r.query: r for r, _ in answers}
        check_results([got[q] for q in queries], serving.store)
        differ = []
        for batch_queries, kwargs in service.batches:
            if kwargs != {"limit": SURFACE_LIMIT, "rerank_top": 50, "packages": None}:
                raise AssertionError(f"engine batch kwargs {kwargs}")
            for q, want in zip(batch_queries, asyncio.run(direct.search_batch(batch_queries, **kwargs))):
                if _ids(got[q]) != _ids(want):
                    differ.append(q)
        if differ:
            raise AssertionError(
                f"{len(differ)} HTTP answers differ from the direct search_batch of "
                f"their engine batch, first {differ[0]!r}"
            )
        torch.cuda.synchronize()
        t = time.perf_counter()
        canonical = asyncio.run(direct.search_batch(queries, limit=SURFACE_LIMIT))
        direct_s = time.perf_counter() - t
        canonical_differ = [q for q, w in zip(queries, canonical) if _ids(got[q]) != _ids(w)]
        latency = [s * 1e3 for _, s in answers]
        spread = [(t - burst_start) * 1e3 for t in sorted(arrivals)]
        in_window = sum(t - spread[0] <= COALESCE_MS for t in spread)
        log(
            f"  HTTP burst of {BATCH} concurrent /search (limit {SURFACE_LIMIT}, "
            f"rerank_top default 50) through ApiClient: all 200, {BATCH / wall:.2f} q/s "
            f"({wall * 1e3:.1f} ms wall), latency p50 {np.percentile(latency, 50):.1f} / "
            f"p90 {np.percentile(latency, 90):.1f} / max {max(latency):.1f} ms; engine "
            f"batches {n_batches} of sizes {sizes} (coalesce {COALESCE_MS:.0f} ms, "
            f"max batch {BATCH}); requests reached the batcher {spread[0]:.1f}-"
            f"{spread[-1]:.1f} ms after the burst began, {in_window} within the "
            f"window of the first; ids equal to the direct search_batch of each engine "
            f"batch; launches {launched.counts}; direct Service.search_batch of the "
            f"same {BATCH} queries {BATCH / direct_s:.2f} q/s ({direct_s * 1e3:.1f} ms), "
            f"in their own order, its ids differing from the HTTP answers' for "
            f"{len(canonical_differ)} queries; {card}"
        )
        if canonical_differ:
            log(f"  ids differ from the direct batch in the canonical order for {canonical_differ[:4]}")

        run_openloop_burst(url, batcher, service, arrivals, card)

        first = got[queries[0]].results[0].id
        hit = asyncio.run(client.get_by_id(first))
        if hit is None or hit.model_dump() != asyncio.run(direct.get_by_id(first)).model_dump():
            raise AssertionError(f"/declarations/{first} gave {hit}")
        try:
            urllib.request.urlopen(f"{url}/api/v2/search?q=nat", timeout=60)
            raise AssertionError("a request without the key was answered")
        except urllib.error.HTTPError as error:
            if error.code != 401:
                raise AssertionError(f"a request without the key got {error.code}") from error
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as response:
            health = json.loads(response.read())
        if health["status"] != "ok" or health["batches_run"] != batcher.batches_run:
            raise AssertionError(f"/healthz {health}")
        log(f"  /declarations/{first} equal to Service.get_by_id; no key -> 401; /healthz {health}")
    finally:
        server.shutdown()
        server.batcher.stop()
        server.server_close()
    return launched.counts["bin_topk"], direct


def run_openloop_burst(url, batcher, service, arrivals, card) -> None:
    """The same burst from another process: scripts/http_openloop_client.py
    (stdlib only) sends BATCH requests at once over raw sockets, as a
    benchmark's client would; every request answered 200 with results, K1
    once per engine batch and no other kernel."""
    client = Path(__file__).resolve().parent / "scripts" / "http_openloop_client.py"
    runs_before, sizes_before = batcher.batches_run, len(batcher.batch_sizes)
    service.batches.clear()
    arrivals.clear()
    with tempfile.NamedTemporaryFile("w", suffix=".txt") as f:
        f.write("\n".join(queries_for(4)) + "\n")
        f.flush()
        with CountLaunches() as launched:
            proc = subprocess.run(
                [sys.executable, str(client), f"{url}/api/v2", f.name, "--api-key",
                 SURFACE_KEY, "--limit", str(SURFACE_LIMIT)],
                capture_output=True, text=True, timeout=600,
            )
            torch.cuda.synchronize()
    if proc.returncode != 0:
        raise AssertionError(f"open-loop client exited {proc.returncode}: {proc.stdout} {proc.stderr[-2000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    n_batches = batcher.batches_run - runs_before
    sizes = batcher.batch_sizes[sizes_before:]
    if report["n_ok"] != BATCH or sum(sizes) != BATCH:
        raise AssertionError(f"open-loop burst: {report}, batch sizes {sizes}")
    expect_launches("open-loop burst", launched.counts, "bin_topk", n_batches)
    if launched.counts["bin_topk"] != n_batches:
        raise AssertionError(f"open-loop burst: K1 launched {launched.counts['bin_topk']} times")
    spread = (max(arrivals) - min(arrivals)) * 1e3
    log(
        f"  open-loop burst of {BATCH} from another process "
        f"(scripts/http_openloop_client.py): all 200, {report['qps']} q/s, latency "
        f"{report['latency_ms']} ms; engine batches {n_batches} of sizes {sizes}; "
        f"requests reached the batcher over {spread:.1f} ms; launches "
        f"{launched.counts}; {card}"
    )


def run_mcp_surface(service, card) -> int:
    """The port's MCP app (``mcp_app.run_stdio``) on ``os.pipe``s with the
    phase-4 service as its backend: initialize, tools/list (8 tools), then
    search_summary, search and get_source_code, one message at a time,
    each answer held to the service's own; every launch count set to 0
    before the session and read after it (K1 once per search)."""
    import threading

    from lean_explore_tpu_torch.mcp import tools  # noqa: F401 — registers the tools
    from lean_explore_tpu_torch.mcp.app import mcp_app, set_backend_service

    set_backend_service(service)
    read_in, write_in = os.pipe()
    read_out, write_out = os.pipe()
    stdin_w, stdout_r = os.fdopen(write_in, "w"), os.fdopen(read_out)
    stdin_r, stdout_w = os.fdopen(read_in), os.fdopen(write_out, "w")

    def serve_pipes():
        try:
            mcp_app.run_stdio(stdin=stdin_r, stdout=stdout_w)
        finally:
            stdout_w.close()

    thread = threading.Thread(target=serve_pipes, name="mcp-stdio", daemon=True)
    queries = queries_for(5)[:2]
    walls = {}

    def ask(msg_id, method, params=None):
        message = {"jsonrpc": "2.0", "id": msg_id, "method": method, "params": params or {}}
        start = time.perf_counter()
        stdin_w.write(json.dumps(message) + "\n")
        stdin_w.flush()
        reply = json.loads(stdout_r.readline())
        walls[msg_id] = (time.perf_counter() - start) * 1e3
        if reply.get("id") != msg_id or "result" not in reply:
            raise AssertionError(f"MCP {method}: {reply}")
        return reply["result"]

    def call(msg_id, name, **arguments):
        result = ask(msg_id, "tools/call", {"name": name, "arguments": arguments})
        if result["isError"]:
            raise AssertionError(f"MCP {name}: {result['content']}")
        return result["structuredContent"]

    thread.start()
    try:
        init = ask(1, "initialize")
        n_tools = len(ask(2, "tools/list")["tools"])
        if init["serverInfo"]["name"] != "LeanExploreMCPServer" or n_tools != 8:
            raise AssertionError(f"MCP initialize {init['serverInfo']}, {n_tools} tools")
        with CountLaunches() as launched:
            summary = call(3, "search_summary", query=queries[0], limit=10)
            full = call(4, "search", query=queries[1], limit=10)
            first = full["results"][0]["id"]
            source = call(5, "get_source_code", declaration_id=first)
            torch.cuda.synchronize()
    finally:
        stdin_w.close()
        thread.join(timeout=60)
        stdout_r.close()
        stdin_r.close()
    expect_launches("MCP session", launched.counts, "bin_topk", 2)
    if launched.counts["bin_topk"] != 2:
        raise AssertionError(f"MCP session: K1 launched {launched.counts['bin_topk']} times")
    want_summary = asyncio.run(service.search(queries[0], limit=10))
    want_full = asyncio.run(service.search(queries[1], limit=10))
    if [(r["id"], r["name"]) for r in summary["results"]] != [
        (r.id, r.name) for r in want_summary.results
    ]:
        raise AssertionError("MCP search_summary differs from Service.search")
    if full["results"] != [r.model_dump(exclude_none=True) for r in want_full.results]:
        raise AssertionError("MCP search differs from Service.search")
    if source["source_text"] != want_full.results[0].source_text:
        raise AssertionError("MCP get_source_code differs from the store")
    log(
        f"  MCP on pipes: initialize, tools/list ({n_tools} tools); search_summary "
        f"{walls[3]:.1f} ms wall (processing_time_ms {summary['processing_time_ms']}), "
        f"search {walls[4]:.1f} ms wall (processing_time_ms {full['processing_time_ms']}), "
        f"get_source_code {walls[5]:.1f} ms; answers equal to Service.search; "
        f"launches {launched.counts}; {card}"
    )
    return launched.counts["bin_topk"]


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
        with Phase("9c. training CLI on a (2, 2) mesh of four processes on the card, and on one device"):
            run_mesh_training(device, kernels, data_dir, Path(tmp), card)
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


def embed_split(embedder, corpus, seconds: dict, card: str) -> np.ndarray:
    """Where the embedding stage's time goes, from its first SPLIT_DOCS
    documents in the stage's batches: the host tokenizer alone
    (``encode_batch``), then ``embed_sync`` (tokenizer, trunk and copy
    back); the rest of the stage, scaled to its documents, is the store's
    reads and writes. Returns ``embed_sync``'s rows."""
    from lean_explore_tpu_torch.models.tokenizer import encode_batch

    docs = [d.informalization for d in corpus.declarations[:SPLIT_DOCS]]
    batch = embedder.batch_size
    t = time.perf_counter()
    for start in range(0, len(docs), batch):
        encode_batch(embedder.tokenizer, docs[start : start + batch],
                     max_length=embedder.max_length, append_eos=True)
    tok_s = time.perf_counter() - t
    t = time.perf_counter()
    vectors = [embedder.embed_sync(docs[start : start + batch])
               for start in range(0, len(docs), batch)]
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
    return np.concatenate(vectors)


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


def hold_rows(label, got: dict, want: dict, keys, misses: list, card: str, note: str = "") -> None:
    """Logs ``got`` beside the committed row ``want`` key by key and adds
    to ``misses`` each share beyond CHAIN_QUERY_SLACK queries (MRR beyond
    CHAIN_MRR_SLACK)."""
    n_got = got.get("n", got.get("n_queries"))
    n_want = want.get("n", want.get("n_queries", n_got))
    parts = []
    for key in keys:
        if key.startswith("mrr"):
            diff = got[key] - want[key]
            parts.append(f"{key} {got[key]:.4f} ({want[key]:.4f}, {diff:+.4f})")
            if abs(diff) > CHAIN_MRR_SLACK + 1e-9:
                misses.append(f"{label} {key}")
        else:
            diff = round(got[key] * n_got) - round(want[key] * n_want)
            parts.append(f"{key} {got[key]:.4f} ({want[key]:.4f}, {diff:+d} queries)")
            if abs(diff) > CHAIN_QUERY_SLACK:
                misses.append(f"{label} {key}")
    if abs(n_got - n_want) > CHAIN_QUERY_SLACK:
        misses.append(f"{label} n")
    log(f"  {label}{note} over {n_got} (record {n_want}): {'; '.join(parts)}; {card}")


def hold_to_reference(label, metrics, reference, seconds, counts, batches, card) -> list[str]:
    """Logs ``metrics`` beside the committed JAX row and returns the keys
    beyond CHAIN_QUERY_SLACK queries (CHAIN_MRR_SLACK for MRR)."""
    misses: list[str] = []
    hold_rows(
        label, metrics, reference, reference, misses, card,
        note=f" at rerank_top {CHAIN_RERANK_TOP} (eval {seconds:.1f} s; K1-f32 launches "
        f"{counts['bin_topk']}, {batches} batches; against JAX)",
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


# Phase 6b: the entry points as processes over the chain's artifacts, each
# with the chain's committed checkpoints and serving lengths in a float32
# corpus, as the environment gives them to a deployment.
ENTRY_QUERIES = 4
ENTRY_LIMIT = 10
ENTRY_TIMEOUT_S = 300


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _child_env(embedder_dir: Path, reranker_dir: Path) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in CPU_REQUEST_VARS}
    env.update(
        LEAN_EXPLORE_EMBEDDING_MODEL=str(embedder_dir),
        LEAN_EXPLORE_RERANKER_MODEL=str(reranker_dir),
        LEAN_EXPLORE_CORPUS_DTYPE="float32",
        LEAN_EXPLORE_EMBEDDING_MAX_LENGTH=str(CHAIN_EMB_MAX_LENGTH),
        LEAN_EXPLORE_RERANKER_MAX_LENGTH=str(CHAIN_RR_MAX_LENGTH),
    )
    return env


def _reference_service(data_dir: Path, embedder_dir: Path, reranker_dir: Path, device):
    """An in-process Service over ``SearchEngine(data_dir, device=device)``
    built the default way, with the settings ``_child_env`` gives the
    children (read from Config at construction and at first use)."""
    from lean_explore_tpu_torch.config import Config
    from lean_explore_tpu_torch.search.engine import SearchEngine
    from lean_explore_tpu_torch.search.service import Service

    Config.CORPUS_DTYPE = "float32"
    Config.EMBEDDING_MAX_LENGTH = CHAIN_EMB_MAX_LENGTH
    Config.RERANKER_MAX_LENGTH = CHAIN_RR_MAX_LENGTH
    engine = SearchEngine(
        data_dir, embedding_model_name=str(embedder_dir),
        reranker_model_name=str(reranker_dir), device=device,
    )
    service = Service(engine)
    service.engine.embedding_client, service.engine.reranker_client  # load now
    return service


def _tail(path: Path) -> str:
    return path.read_text(errors="replace")[-3000:] if path.exists() else ""


def _api_server_child(repo, data_dir, env, queries, want, logs) -> float:
    """``python -m lean_explore_tpu_torch.api.server --warmup``: each query
    through ApiClient one at a time, then SIGINT, which must end it with 0
    and nothing on stdout. Returns the seconds to /healthz."""
    import signal
    import urllib.request

    from lean_explore_tpu_torch.api import ApiClient

    port = _free_port()
    err = logs / "api_server.stderr"
    start = time.perf_counter()
    with open(err, "w") as stderr:
        proc = subprocess.Popen(
            [sys.executable, "-m", "lean_explore_tpu_torch.api.server", "--data-dir",
             str(data_dir), "--port", str(port), "--api-key", "k", "--warmup"],
            stdout=subprocess.PIPE, stderr=stderr, env=env, cwd=repo, text=True,
        )
        try:
            while True:
                if proc.poll() is not None:
                    raise AssertionError(f"API server exited {proc.returncode}: {_tail(err)}")
                if time.perf_counter() - start > ENTRY_TIMEOUT_S:
                    raise AssertionError(f"API server not up in {ENTRY_TIMEOUT_S} s: {_tail(err)}")
                try:
                    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5):
                        break
                except OSError:
                    time.sleep(0.5)
            up_s = time.perf_counter() - start
            client = ApiClient(api_key="k", base_url=f"http://127.0.0.1:{port}/api/v2", timeout=120)
            for q in queries:
                got = _ids(asyncio.run(client.search(q, limit=ENTRY_LIMIT)))
                if got != _ids(want[q]):
                    raise AssertionError(f"API server child: {q!r} gave {got}, in-process {_ids(want[q])}")
            proc.send_signal(signal.SIGINT)
            out, _ = proc.communicate(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if proc.returncode != 0 or out:
        raise AssertionError(f"API server child exited {proc.returncode}, stdout {out[:500]!r}: {_tail(err)}")
    return up_s


def _mcp_server_child(repo, data_dir, env, queries, want, logs) -> float:
    """A stdio session with ``python -m lean_explore_tpu_torch.mcp.server
    --backend local``: every stdout line a JSON-RPC response, each search
    answered with the in-process ids. Returns its seconds."""
    messages = [{"jsonrpc": "2.0", "id": 0, "method": "initialize", "params": {}}]
    messages += [
        {"jsonrpc": "2.0", "id": i + 1, "method": "tools/call",
         "params": {"name": "search", "arguments": {"query": q, "limit": ENTRY_LIMIT}}}
        for i, q in enumerate(queries)
    ]
    err = logs / "mcp_server.stderr"
    start = time.perf_counter()
    with open(err, "w") as stderr:
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "lean_explore_tpu_torch.mcp.server", "--backend",
                 "local", "--data-dir", str(data_dir)],
                input="".join(json.dumps(m) + "\n" for m in messages), stdout=subprocess.PIPE,
                stderr=stderr, env=env, cwd=repo, text=True, timeout=ENTRY_TIMEOUT_S,
            )
        except subprocess.TimeoutExpired as error:
            raise AssertionError(f"MCP server child timed out: {_tail(err)}") from error
    seconds = time.perf_counter() - start
    if proc.returncode != 0:
        raise AssertionError(f"MCP server child exited {proc.returncode}: {_tail(err)}")
    replies = []
    for line in proc.stdout.splitlines():
        reply = json.loads(line)
        if reply.get("jsonrpc") != "2.0":
            raise AssertionError(f"MCP server child printed {line[:200]!r}")
        replies.append(reply)
    if [r["id"] for r in replies] != [m["id"] for m in messages]:
        raise AssertionError(f"MCP server child answered ids {[r.get('id') for r in replies]}")
    for q, reply in zip(queries, replies[1:]):
        got = [r["id"] for r in reply["result"]["structuredContent"]["results"]]
        if got != _ids(want[q]):
            raise AssertionError(f"MCP server child: {q!r} gave {got}, in-process {_ids(want[q])}")
    return seconds


def _cli_child(repo, data_dir, env, query, want_names, logs) -> float:
    """``python -m lean_explore_tpu_torch.cli.main search --local``: the
    names it prints, in order, are the in-process top 5."""
    import re

    start = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "lean_explore_tpu_torch.cli.main", "search", "--local",
             "--data-dir", str(data_dir), query],
            capture_output=True, env=env, cwd=repo, text=True, timeout=ENTRY_TIMEOUT_S,
        )
    except subprocess.TimeoutExpired as error:
        raise AssertionError("CLI child timed out") from error
    seconds = time.perf_counter() - start
    (logs / "cli.stderr").write_text(proc.stderr)
    if proc.returncode != 0:
        raise AssertionError(f"CLI child exited {proc.returncode}: {proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    names = [m.group(1) for line in lines if (m := re.match(r"\[\d+\] (\S+)   \S+   #\d+$", line))]
    if lines[0] != f"Searching locally for: '{query}'..." or names != want_names:
        raise AssertionError(f"CLI child printed {proc.stdout[:1500]!r}, in-process {want_names}")
    return seconds


def run_entry_points(data_dir: Path, corpus, embedder_dir, reranker_dir, repo, device, card) -> None:
    """Phase 6b: the API server, the MCP server and the CLI as processes,
    run at the same time, over the chain's artifacts, each answer's ids
    (the names, for the CLI's text) equal to an in-process
    ``SearchEngine(data_dir, device="cuda")`` built the same default way."""
    from lean_explore_tpu_torch.config import Config

    saved = Config.CORPUS_DTYPE, Config.EMBEDDING_MAX_LENGTH, Config.RERANKER_MAX_LENGTH
    try:
        service = _reference_service(data_dir, embedder_dir, reranker_dir, device)
        queries = [q for q, _ in corpus.eval_queries[:ENTRY_QUERIES]]
        want = {q: asyncio.run(service.search(q, limit=ENTRY_LIMIT)) for q in queries}
        cli_want = [r.name for r in asyncio.run(service.search(queries[0], limit=5)).results]
        del service
        torch.cuda.empty_cache()
    finally:
        Config.CORPUS_DTYPE, Config.EMBEDDING_MAX_LENGTH, Config.RERANKER_MAX_LENGTH = saved
    env = _child_env(embedder_dir, reranker_dir)
    logs = data_dir / "entry_point_logs"
    logs.mkdir(exist_ok=True)
    # The three children at once: each starts its own interpreter and
    # loads the chain's models, and none depends on another.
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=3) as pool:
        futures = (
            pool.submit(_api_server_child, repo, data_dir, env, queries, want, logs),
            pool.submit(_mcp_server_child, repo, data_dir, env, queries, want, logs),
            pool.submit(_cli_child, repo, data_dir, env, queries[0], cli_want, logs),
        )
        api_up, mcp_s, cli_s = (f.result() for f in futures)
    log(
        f"  entry points over the chain's artifacts (float32 corpus, checkpoints "
        f"runs/scale200k, lengths {CHAIN_EMB_MAX_LENGTH}/{CHAIN_RR_MAX_LENGTH}): "
        f"api.server --warmup up in {api_up:.1f} s, {len(queries)} queries through "
        f"ApiClient; mcp.server --backend local session of {len(queries)} searches "
        f"{mcp_s:.1f} s; cli.main search --local {cli_s:.1f} s; every answer's ids "
        f"(the CLI's names) equal to the in-process engine's; {card}"
    )



def run_quality_chain(device, kernels, card, repo: Path, built: dict) -> None:
    """Phase 6 on the chain as scripts/eval_torch_quality.py builds it: a
    store of ``make_corpus``'s declarations in the corpus's order (the
    order of the committed runs, whose fusion breaks ties by id), each
    with the embedding that phase 8's pipeline computed on the card for its
    text (``built``: the corpus, the stage seconds, the stored embeddings
    by name and the f32 embedder), and its artifacts. Then where the
    embedding stage's time goes, the first SPLIT_DOCS documents'
    ``embed_sync`` rows within EXTRACTION_EMBED_TOL of the pipeline's, and
    the quality eval with every launch count set to 0 before and read
    after, in five arms: the full pipeline, the cascade at each of
    CHAIN_CASCADE_POINTS, each held to its row of the committed record, and
    the int8 reranker (the chain's reranker loaded in bf16 and quantized),
    gated only on its int8 leaves and launch counts. K1-f32 must launch
    once per batch of 64 in each arm."""
    from lean_explore_tpu_torch.evaluation import guard_store_vocab
    from lean_explore_tpu_torch.extract.index import build_indices
    from lean_explore_tpu_torch.models.store import DeclarationStore
    from lean_explore_tpu_torch.search.engine import SearchEngine
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
    corpus, embedder, embeddings = built["corpus"], built["embedder"], built["embeddings"]
    seconds = {"embed": built["seconds"]["embed"]}
    reranker = RerankerClient(
        str(reranker_dir), max_length=CHAIN_RR_MAX_LENGTH, dtype=torch.float32,
        device=device,
    )
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_chain_", dir=built["extraction"].parent))
    t = time.perf_counter()
    (work / "store").mkdir()
    store = DeclarationStore(work / "store" / "declarations.db", create=True)
    store.insert_many(
        dataclasses.replace(d, informalization_embedding=embeddings[d.name])
        for d in corpus.declarations
    )
    seconds["store"] = time.perf_counter() - t
    guard_store_vocab(store, embedder.tokenizer)
    t = time.perf_counter()
    build_indices(store, work)
    seconds["build"] = time.perf_counter() - t
    log(
        f"  store of the corpus in its order with phase 8's embeddings {seconds['store']:.1f} s; "
        f"embedding stage (phase 8's) {len(corpus.declarations) / seconds['embed']:.1f} docs/s "
        f"({len(corpus.declarations)} docs in {seconds['embed']:.1f} s, f32, max_length "
        f"{CHAIN_EMB_MAX_LENGTH}); artifact build (build_indices) {seconds['build']:.1f} s; {card}"
    )
    vectors = embed_split(embedder, corpus, seconds, card)
    worst = max(
        float(np.abs(v - embeddings[d.name]).max())
        for d, v in zip(corpus.declarations, vectors)
    )
    if worst > EXTRACTION_EMBED_TOL:
        raise AssertionError(f"phase 8's embedding rows differ from embed_sync's by {worst}")
    log(f"  the first {len(vectors)} documents' embed_sync rows within {worst:.2e} of "
        f"phase 8's stored rows (tolerance {EXTRACTION_EMBED_TOL})")
    engine, load_s = script.open_engine(work, store, embedder, reranker, device)
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
        work, store=store, artifacts=engine._artifacts, embedding_client=embedder,
        reranker_client=int8_reranker, device=device,
    )
    with CountIntMM() as int_mm:
        arms["int8_reranker"] = eval_arm(int8_engine, corpus, batches, None)
    if int_mm.calls == 0:
        raise AssertionError("the int8 reranker arm never reached torch._int_mm")
    del int8_engine, int8_reranker
    with Phase("6b. the entry points as processes over the chain's artifacts"):
        run_entry_points(work, corpus, embedder_dir, reranker_dir, repo, device, card)
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
    return engine


def embed_chain(device, repo: Path, root: Path, card: str) -> dict:
    """What phase 8 hands phase 6, without the extraction pipeline (for
    ``--tools``): the chain's corpus, its float32 embedder on the card and
    every declaration's ``embed_sync`` row by name, in the stage's batches."""
    from lean_explore_tpu_torch.evaluation import EMBED_BATCH
    from lean_explore_tpu_torch.train.synthetic import make_corpus
    from lean_explore_tpu_torch.util.embedding_client import EmbeddingClient

    embedder_dir, _ = chain_checkpoints(repo)
    corpus = make_corpus(**CHAIN_CORPUS)
    embedder = EmbeddingClient(
        str(embedder_dir), max_length=CHAIN_EMB_MAX_LENGTH, batch_size=EMBED_BATCH,
        dtype=torch.float32, device=device,
    )
    docs = [d.informalization for d in corpus.declarations]
    t = time.perf_counter()
    rows = np.concatenate([
        embedder.embed_sync(docs[start : start + EMBED_BATCH])
        for start in range(0, len(docs), EMBED_BATCH)
    ])
    embed_s = time.perf_counter() - t
    log(f"  embed_sync of the chain's {len(docs)} documents {embed_s:.1f} s "
        f"({len(docs) / embed_s:.1f} docs/s); {card}")
    (root / "extraction").mkdir()
    return dict(
        corpus=corpus, embedder=embedder, seconds={"embed": embed_s},
        embeddings={d.name: r for d, r in zip(corpus.declarations, rows)},
        extraction=root / "extraction",
    )


# ----------------------------------------------------------------------
# Phase 10: the quality and cascade-calibration tools at full width
# ----------------------------------------------------------------------

TOOLS_PHASE = "10. the quality and cascade-calibration tools on the committed checkpoints"
# 10a, on phase 6's engine: the 192 queries of both cascade records
# (make_corpus draws its eval picks after every declaration, so these
# search phase 6's declarations), the calibration's and the coverage
# script's caps, each scored once, the calibration's keep and floor.
TOOLS_N_QUERIES = 192
TOOLS_CALIBRATION = CHAIN_DIR / "cascade_calibration.json"
TOOLS_COVERAGE = CHAIN_DIR / "prescreen_coverage.json"
TOOLS_CAPS = (8, 12, 16, 24, 32, 48, 64, 96)
TOOLS_RECOMMENDED_CAP = 48
# The kept divergence ROADMAP C11: at cap 24 the TPU record keeps the
# full-length top-3 in 39 groups, the card in 36; the card's, the port's
# and the JAX client's float32 rankings agree on all 192 groups
# (scripts/compare_torch_cap_rankings.py), so that row is held to the JAX
# float32 row of this record and logged beside the TPU row.
TOOLS_CAP_DIVERGENCE = CHAIN_DIR / "cascade_calibration_cap24_divergence.json"
# 10b: the committed 20k chain (runs/embedder, runs/reranker) at the
# records' arguments and lengths (scripts/eval_query_classes.py,
# scripts/measure_int8_effects.py).
TOOLS_20K_DIR = Path("runs")
TOOLS_20K_CORPUS = dict(n_decls=20_000, n_concepts=1200, n_eval=512, seed=0)
TOOLS_20K_EMB_MAX_LENGTH, TOOLS_20K_RR_MAX_LENGTH = 64, 128
TOOLS_QUERY_CLASSES = TOOLS_20K_DIR / "query_classes" / "eval.json"
TOOLS_INT8_EFFECTS = TOOLS_20K_DIR / "int8_effects.json"
TOOLS_N_PER_CLASS, TOOLS_INT8_QUERIES = 128, 128
TOOLS_DENSE_RECALL_TOL = 0.01
# ROADMAP C11 too: the rows whose TPU records the JAX scripts' own float32
# runs on the CPU miss as the card does (runs/jax_f32_cpu: the scripts at
# their defaults with --platform cpu); each is held to that run and logged
# beside its TPU row.
TOOLS_F32_QUERY_CLASSES = Path("runs") / "jax_f32_cpu" / "query_classes_eval.json"
TOOLS_F32_INT8_EFFECTS = Path("runs") / "jax_f32_cpu" / "int8_effects.json"
TOOLS_F32_ROWS = {("semantic", "full_pipeline"), ("dense", "fused_f32_vs_exact")}


def twenty_k_checkpoints(repo: Path) -> tuple[Path, Path]:
    """The committed 20k chain's embedder and reranker directories; raises
    when either is incomplete."""
    dirs = tuple(repo / TOOLS_20K_DIR / m / "checkpoint" for m in ("embedder", "reranker"))
    for d in dirs:
        for name in ("config.json", "model.safetensors", "tokenizer.json"):
            if not (d / name).is_file():
                raise FileNotFoundError(f"phase 10 needs the committed checkpoint file {d / name}")
    return dirs


def run_tools_calibration(engine, reranker, kernels, card, repo: Path, dump: Path | None,
                          eval_queries=None) -> list:
    """10a on phase 6's engine: one capture of the records' 192 queries
    (``eval_queries`` when phase 8's host child made them, else made
    here; K1-f32 once a batch of 64 and no other kernel), every cap of
    TOOLS_CAPS scored once, and from that one scoring the calibration's
    rows (held to runs/scale200k/cascade_calibration.json, which
    recommends cap 48) and the coverage's rows (held to
    runs/scale200k/prescreen_coverage.json). Returns the misses."""
    from lean_explore_tpu_torch import evaluation
    from lean_explore_tpu_torch.train.synthetic import make_corpus

    calibration = json.loads((repo / TOOLS_CALIBRATION).read_text())
    coverage = json.loads((repo / TOOLS_COVERAGE).read_text())
    keep, floor = calibration["task"]["keep"], calibration["task"]["top1_floor"]
    t = time.perf_counter()
    if eval_queries is None:
        eval_queries = make_corpus(**{**CHAIN_CORPUS, "n_eval": TOOLS_N_QUERIES}).eval_queries
    corpus_s = time.perf_counter() - t
    queries = [q for q, _ in eval_queries]
    with CountLaunches() as launched:
        t = time.perf_counter()
        groups = evaluation.capture_rerank_groups(engine, queries, CHAIN_RERANK_TOP, batch=64)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t
    batches = -(-len(queries) // 64)
    expect_launches("10a capture", launched.counts, "bin_topk", batches)
    if launched.counts["bin_topk"] != batches:
        raise AssertionError(f"10a: K1-f32 launched {launched.counts['bin_topk']} times, not {batches}")
    with CountLaunches() as scoring:
        scored = evaluation.score_caps(reranker, groups, TOOLS_CAPS)
    if any(scoring.counts.values()):
        raise AssertionError(f"10a: kernels launched while scoring the caps: {scoring.counts}")
    cal_rows = {
        cap: evaluation.calibration_row(groups, scored[cap][0], keep, scored[cap][1])
        for cap in TOOLS_CAPS
    }
    target_by_query = dict(eval_queries)
    cov_rows = {
        cap: evaluation.coverage_row(
            evaluation.gold_stage1_ranks(groups, scored[cap][0], target_by_query), scored[cap][1]
        )
        for cap in TOOLS_CAPS
    }
    record_caps = [int(c) for c in calibration["caps"]]
    recommended = evaluation.recommended_cap({c: cal_rows[c] for c in record_caps}, floor)
    log(
        f"  {TOOLS_N_QUERIES} queries {corpus_s:.1f} s; capture of {len(groups)} "
        f"groups {capture_s:.1f} s, K1-f32 launches {launched.counts['bin_topk']} "
        f"({batches} batches); {len(TOOLS_CAPS)} caps scored once, "
        f"{sum(sc for _, sc in scored.values()):.1f} s; {card}"
    )
    divergence = json.loads((repo / TOOLS_CAP_DIVERGENCE).read_text())["caps"]
    misses: list[str] = []
    for cap in record_caps:
        keys = ("containment_top1", "containment_top3")
        if str(cap) not in divergence:
            hold_rows(f"calibration cap {cap}", cal_rows[cap], calibration["caps"][str(cap)],
                      keys, misses, card)
            continue
        kept = divergence[str(cap)]
        differ = [
            i for i, (g, s) in enumerate(zip(groups, scored[cap][0]))
            if {"full_top3": evaluation.ranking(g.scores)[:3],
                "keep_set": sorted(evaluation.ranking(s)[:keep])} != kept["jax_rankings"][i]
        ]
        hold_rows(f"calibration cap {cap}", cal_rows[cap], kept["jax_f32_cpu_row"], keys,
                  misses, card, " against JAX f32 on the CPU (ROADMAP C11)")
        hold_rows(f"calibration cap {cap}", cal_rows[cap], calibration["caps"][str(cap)], keys,
                  [], card, " against its TPU row, logged")
        log(f"  calibration cap {cap}: groups whose full top-3 or keep set differ from the "
            f"committed JAX float32 rankings: {differ}")
    for cap in (int(c) for c in coverage["caps"]):
        hold_rows(f"coverage cap {cap}", cov_rows[cap], coverage["caps"][str(cap)],
                  ("top8", "top12", "top16", "top25"), misses, card)
    log(f"  recommended cap {recommended} (record {calibration['recommended_cap']}, "
        f"floor {floor}, keep {keep}); cap 12 {json.dumps(cal_rows[12])}, "
        f"cap 96 coverage {json.dumps(cov_rows[96])}")
    if recommended != TOOLS_RECOMMENDED_CAP:
        misses.append(f"recommended cap {recommended}")
    log("  " + json.dumps({"tools_calibration": {str(c): r for c, r in cal_rows.items()},
                           "tools_coverage": {str(c): r for c, r in cov_rows.items()},
                           "recommended_cap": recommended}))
    if dump is not None:
        dump.mkdir(parents=True, exist_ok=True)
        (dump / "tools_groups.json").write_text(json.dumps({
            "queries": queries, "targets": [t for _, t in eval_queries],
            "keep": keep, "rr_max_length": CHAIN_RR_MAX_LENGTH,
            "device": torch.cuda.get_device_name(0),
            "groups": [g._asdict() for g in groups],
            "cap_scores": {str(c): scored[c][0] for c in TOOLS_CAPS},
        }))
    by_name = {k["name"]: k for k in kernels}
    by_name["bin_topk_f32"]["tools_capture_launches"] = launched.counts["bin_topk"]
    return misses


def hold_k2_to_twin(queries, corpus_mat) -> int:
    """K2's carry over the quantized corpus equals its plain twin's bit for
    bit (launches here do not count); returns the rows compared."""
    from lean_explore_tpu_torch.index.dense import ROW_ALIGN
    from lean_explore_tpu_torch.ops import bin_topk_int8 as K8
    from lean_explore_tpu_torch.ops.bin_topk import steal_bits_for
    from lean_explore_tpu_torch.ops.dense import serving_bins
    from lean_explore_tpu_torch.ops.quant import quantize_rows_device

    n = corpus_mat.shape[0]
    codes, scales = quantize_rows_device(
        torch.nn.functional.pad(corpus_mat, (0, 0, 0, (-n) % ROW_ALIGN))
    )
    q_codes, q_scales = quantize_rows_device(queries)
    bins = serving_bins(queries.shape[0], codes.shape[0])
    got = K8.bin_topk_int8_carry(q_codes, q_scales, codes, scales, n, bins)
    want = K8.bin_topk_int8_carry_plain(
        q_codes, q_scales, codes, scales, n, bins, steal_bits_for(codes.shape[0], bins)
    )
    if not torch.equal(got, want):
        raise AssertionError(f"10b: K2's carry differs from its twin at {(got != want).sum()} places")
    return codes.shape[0]


def run_tools_20k(device, kernels, card, repo: Path, root: Path) -> list:
    """10b: the committed 20k chain's index built on the card at the
    records' lengths; the query classes in each configuration and the
    int8 effects, each held to its record. Returns the misses."""
    from lean_explore_tpu_torch import evaluation
    from lean_explore_tpu_torch.train.synthetic import make_corpus, make_name_queries
    from lean_explore_tpu_torch.util.reranker_client import RerankerClient

    embedder_dir, reranker_dir = twenty_k_checkpoints(repo)
    classes = json.loads((repo / TOOLS_QUERY_CLASSES).read_text())["results"]
    int8_record = json.loads((repo / TOOLS_INT8_EFFECTS).read_text())
    f32_classes = json.loads((repo / TOOLS_F32_QUERY_CLASSES).read_text())["results"]
    f32_int8 = json.loads((repo / TOOLS_F32_INT8_EFFECTS).read_text())
    t = time.perf_counter()
    corpus = make_corpus(**TOOLS_20K_CORPUS)
    embedder, reranker = evaluation.float32_clients(
        embedder_dir, reranker_dir, TOOLS_20K_EMB_MAX_LENGTH, TOOLS_20K_RR_MAX_LENGTH, device
    )
    work = root / "tools_20k"
    with CountLaunches() as building:
        store, built_s = evaluation.build_index(corpus, embedder, work)
    engine, load_s = evaluation.open_engine(work, store, embedder, reranker, device)
    build_s = time.perf_counter() - t
    if any(building.counts.values()):
        raise AssertionError(f"10b: kernels launched while building the index: {building.counts}")
    log(
        f"  20k index on the card {build_s:.1f} s (embed {built_s['embed']:.1f} s, "
        f"{built_s['embed_docs_per_s']:.1f} docs/s; artifacts {built_s['build']:.1f} s; "
        f"load {load_s:.1f} s); {card}"
    )
    sets = {
        **make_name_queries(corpus, np.random.default_rng(TOOLS_20K_CORPUS["seed"] + 3),
                            n_per_class=TOOLS_N_PER_CLASS),
        "semantic": corpus.eval_queries,
    }
    misses: list[str] = []
    metric_keys = ("recall_at_1", "recall_at_10", "mrr_at_10")
    launches = 0
    for qclass, labeled in sets.items():
        configs = ("full_pipeline",) if qclass == "semantic" else tuple(evaluation.QUERY_CLASS_CONFIGS)
        for config in configs:
            with CountLaunches() as launched:
                row = evaluation.evaluate_query_classes(
                    engine, {qclass: labeled}, CHAIN_RERANK_TOP, configs=(config,)
                )[qclass][config]
            batches = -(-len(labeled) // 64) if config != "bm25_only" else 0
            if config == "bm25_only":
                if any(launched.counts.values()):
                    raise AssertionError(f"10b {qclass}/{config}: kernels launched {launched.counts}")
            else:
                expect_launches(f"10b {qclass}/{config}", launched.counts, "bin_topk", batches)
                if launched.counts["bin_topk"] != batches:
                    raise AssertionError(
                        f"10b {qclass}/{config}: K1-f32 launched {launched.counts['bin_topk']} "
                        f"times, not {batches}"
                    )
            launches += launched.counts["bin_topk"]
            note = f" ({row['seconds']} s, K1-f32 {launched.counts['bin_topk']})"
            if (qclass, config) in TOOLS_F32_ROWS:
                hold_rows(f"{qclass}/{config}", row, f32_classes[qclass][config], metric_keys,
                          misses, card, note + " against JAX f32 on the CPU (ROADMAP C11)")
                hold_rows(f"{qclass}/{config}", row, classes[qclass][config], metric_keys, [],
                          card, " against its TPU row, logged")
            else:
                hold_rows(f"{qclass}/{config}", row, classes[qclass][config], metric_keys,
                          misses, card, note)
    # The int8 effects on the same index: its float32 rows, the record's
    # 128 queries, the float32 reranker beside the W8A8 one.
    dense = engine._artifacts.dense
    corpus_mat = dense.embeddings[: dense.n]
    q_vecs = embedder.embed_device(
        [q for q, _ in corpus.eval_queries[:TOOLS_INT8_QUERIES]], is_query=True
    )
    q8 = RerankerClient(
        str(reranker_dir), max_length=TOOLS_20K_RR_MAX_LENGTH, dtype="int8", device=device,
    )
    t = time.perf_counter()
    with CountLaunches() as launched:
        recall = evaluation.dense_int8_recall(corpus_mat, q_vecs)
        drift = evaluation.reranker_int8_drift(
            reranker, q8, *evaluation.direct_eval_groups(corpus, TOOLS_INT8_QUERIES,
                                                         TOOLS_20K_CORPUS["seed"])
        )
    int8_s = time.perf_counter() - t
    expect_launches("10b int8 effects", launched.counts, "bin_topk_int8", 1)
    rows = hold_k2_to_twin(q_vecs, corpus_mat)
    want_recall = dict(int8_record["dense_trained_geometry"]["recall_at_10"])
    f32_recall = f32_int8["dense_trained_geometry"]["recall_at_10"]
    for key in want_recall:
        if ("dense", key) in TOOLS_F32_ROWS:
            want_recall[key] = f32_recall[key]
    for key, got in recall["recall_at_10"].items():
        if abs(got - want_recall[key]) > TOOLS_DENSE_RECALL_TOL + 1e-9:
            misses.append(f"int8 dense {key}")
    want_drift = int8_record["reranker_int8_drift"]
    hold_rows("int8 reranker", drift, want_drift,
              ("recall_at_1_of_50_f32", "recall_at_1_of_50_int8", "top1_agreement"), misses, card)
    log(
        f"  int8 effects {int8_s:.1f} s: dense recall@10 {json.dumps(recall['recall_at_10'])} "
        f"(held to {json.dumps(want_recall)}, tolerance {TOOLS_DENSE_RECALL_TOL}; TPU record "
        f"{json.dumps(int8_record['dense_trained_geometry']['recall_at_10'])}, JAX f32 on the "
        f"CPU {json.dumps(f32_recall)}, kept divergence ROADMAP C11); K2 launches "
        f"{launched.counts['bin_topk_int8']}, its carry over {rows} rows equal to its twin's; "
        f"P(true) drift mean {drift['p_true_drift_mean']} max {drift['p_true_drift_max']} "
        f"(record {want_drift['p_true_drift_mean']}, {want_drift['p_true_drift_max']}); {card}"
    )
    log("  " + json.dumps({"tools_int8_effects": {"dense_trained_geometry": recall,
                                                  "reranker_int8_drift": drift}}))
    store.close()
    by_name = {k["name"]: k for k in kernels}
    by_name["bin_topk_f32"]["tools_20k_launches"] = launches
    by_name["bin_topk_int8"]["tools_int8_launches"] = launched.counts["bin_topk_int8"]
    return misses


def run_tools(engine, built: dict, device, kernels, card, repo: Path, root: Path,
              dump: Path | None) -> None:
    """Phase 10: 10a on phase 6's engine, then 10b; fails on any miss
    after both have logged their rows."""
    with Phase("10a. cascade calibration and prescreen coverage on phase 6's engine"):
        misses = run_tools_calibration(engine, engine.reranker_client, kernels, card, repo,
                                       dump, built.get("tools_eval_queries"))
    with Phase("10b. query classes and int8 effects on the committed 20k chain"):
        misses += run_tools_20k(device, kernels, card, repo, root)
    if misses:
        raise AssertionError(
            f"phase 10: {misses} beyond {CHAIN_QUERY_SLACK} queries (MRR {CHAIN_MRR_SLACK}, "
            f"dense recall {TOOLS_DENSE_RECALL_TOL}) of the committed records"
        )
    for forbidden in ("jax", "lean_explore_tpu"):
        if forbidden in sys.modules:
            raise AssertionError(f"{forbidden} was imported on the tools' path")


# ----------------------------------------------------------------------
# Phase 7: training end to end at the 20k chain
# ----------------------------------------------------------------------

# The committed runs' task and widths (runs/embedder/eval.json,
# runs/reranker/eval.json: 20,000 declarations, 1,200 concepts, 512
# held-out queries; embedder 384 x 6, 3000 steps, --paraphrases; reranker
# 256 x 4, 4000 steps), every other flag at the scripts' defaults.
E2E_EMBEDDER_ARGS = ["--hidden-size", "384", "--num-layers", "6", "--steps", "3000", "--paraphrases"]
E2E_RERANKER_ARGS = ["--steps", "4000"]
E2E_N_EVAL, E2E_EVAL_BATCH = 512, 64
# Their deterministic task data at seed 0, which the port's must equal:
# the train split, the padded vocabularies and the reranker's examples.
E2E_TASK = {
    ("embedder", "n_train_decls"): 16000,
    ("embedder", "vocab_size"): 2440,
    ("reranker", "vocab_size"): 2448,
    ("reranker", "n_examples"): 119628,
    ("reranker", "n_positive"): 39876,
}
# Ceilings held at every seed: BM25 alone and the random inits stay near
# zero, as in the committed JAX runs: (report, path, bound, the committed
# value).
E2E_CEILINGS = (
    ("embedder", ("results", "trained", "bm25_only", "recall_at_10"), 0.05, 0.0),
    ("embedder", ("results", "random_init", "dense_only", "recall_at_10"), 0.05, 0.0059),
    ("reranker", ("reranker_direct", "random_init", "recall_at_1_of_50"), 0.10, 0.0312),
)
# One-sided floors from the committed JAX runs, a TPU's (float32 products
# at the TPU's default precision): (report, path, floor, the committed
# value, the JAX script's own float32 run from the same init). Logged at
# every seed, held at none: the trained models are held to the JAX
# scripts' own float32 runs from the same init instead (ROADMAP C7,
# decided): the embedder by E2E_SAME_INIT, the reranker by
# E2E_RERANKER_FLOORS.
E2E_FLOORS = (
    ("embedder", ("results", "trained", "dense_only", "recall_at_10"), 0.9785 - 10 / 512, 0.9785, 0.9609),
    ("embedder", ("results", "trained", "dense_only", "recall_at_1"), 0.8984 - 20 / 512, 0.8984, 0.8574),
    ("embedder", ("results", "trained", "dense_only", "mrr_at_10"), 0.9289 - 0.03, 0.9289, 0.8971),
    ("embedder", ("results", "trained", "hybrid", "recall_at_10"), 0.9688 - 10 / 512, 0.9688, 0.9551),
    ("reranker", ("reranker_direct", "trained", "recall_at_1_of_50"), 0.832 - 0.05, 0.832, 0.6738),
    ("reranker", ("pipeline", "full_pipeline_trained", "recall_at_10"), 0.9902 - 10 / 512, 0.9902, 0.9805),
    ("reranker", ("pipeline", "full_pipeline_trained", "recall_at_1"), 0.8105 - 0.05, 0.8105, 0.457),
)
# What the trained embedder is held to at seed 0, either way within
# E2E_SAME_INIT_SLACK: the JAX script's own float32 run from the same
# init, PRNGKey(0), which the port's draw repeats
# (runs/jax_f32_cpu/embedder_eval.json: scripts/train_embedder_e2e.py at
# these arguments with --platform cpu). The port from that init has
# matched it to the fourth decimal on the CPU and on the card. The
# reranker's run is not held so: its training is chaotic (ROADMAP C8:
# JAX's own run from the init moved one ulp leaves JAX's as early as the
# port's does, runs/jax_f32_cpu/reranker_trajectory.json), so from the
# same init the JAX script and the port reach direct 0.6738 and 0.7949
# on one CPU.
E2E_SAME_INIT = {
    ("results", "trained", "dense_only", "recall_at_10"): 0.9609,
    ("results", "trained", "dense_only", "recall_at_1"): 0.8574,
    ("results", "trained", "dense_only", "mrr_at_10"): 0.8971,
    ("results", "trained", "hybrid", "recall_at_10"): 0.9551,
    ("results", "random_init", "dense_only", "recall_at_10"): 0.0059,
}
# Four queries of 512: a metric of one query in [0, 1] each (a recall, or
# MRR's reciprocal rank) moves by at most this when four queries change.
E2E_SAME_INIT_SLACK = 4 / 512
# The reranker at seed 0, one-sided: each figure at least the JAX
# script's own float32 run from the same init
# (runs/jax_f32_cpu/reranker_eval.json) less E2E_SAME_INIT_SLACK. The
# floor is the lower of that run and its perturbed twin's; the twin's
# figures are not measured (a JAX run of both scripts on the CPU takes
# about three hours), so the run alone sets it.
E2E_RERANKER_FLOORS = {
    ("reranker_direct", "trained", "recall_at_1_of_50"): 0.6738,
    ("pipeline", "full_pipeline_trained", "recall_at_1"): 0.457,
    ("pipeline", "full_pipeline_trained", "recall_at_10"): 0.9805,
}
# full_pipeline_random_rerank's recall@1 lies at least this far under the
# trained arm's (committed: 0.3164 against 0.8105; the JAX script's own
# float32 run from the same init: 0.2852 against 0.457, so logged, as
# E2E_FLOORS are).
E2E_RANDOM_RERANK_GAP = 0.2
# K1-f32's top-10 overlap with the exact scan on the trained geometry
# (committed for the fused scan: 0.9812).
E2E_SELECTION_MIN, E2E_SELECTION_COMMITTED = 0.97, 0.9812


class CountArms:
    """Wraps a script's ``evaluate_engine``: every launch count set to 0
    before each call and read after it, kept with the call's keywords."""

    def __init__(self, evaluate):
        self.evaluate = evaluate
        self.arms: list[tuple[dict, dict, float]] = []

    def __call__(self, engine, labeled, **kw):
        with CountLaunches() as launched:
            t = time.perf_counter()
            metrics = self.evaluate(engine, labeled, **kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t
        self.arms.append((kw, launched.counts, seconds))
        return metrics

    def check(self, script: str, card: str) -> int:
        """K1-f32 once per batch of 64 in every arm with a dense stage and
        no other kernel; no kernel at all in a BM25-only arm. Returns the
        K1-f32 launches over all arms."""
        batches = -(-E2E_N_EVAL // E2E_EVAL_BATCH)
        total = 0
        for kw, counts, seconds in self.arms:
            path = f"{script} eval {kw}"
            if kw.get("dense_k", 1000) > 0:
                expect_launches(path, counts, "bin_topk", batches)
                if counts["bin_topk"] != batches:
                    raise AssertionError(f"{path}: K1-f32 launched {counts['bin_topk']} times, not {batches}")
            elif any(counts.values()):
                raise AssertionError(f"{path}: kernels launched without a dense stage: {counts}")
            total += counts["bin_topk"]
            log(f"  {path}: {seconds:.1f} s, K1-f32 launches {counts['bin_topk']}; {card}")
        return total


# The last steps of each trainer run under torch.profiler: the device's
# busy time a step, against the step time of the run's untraced steps.
E2E_TRACE_STEPS = 20


class TraceSteps:
    """Wraps a train step: its last ``n`` calls of ``steps`` run under
    ``torch.profiler`` (CPU and CUDA activity). ``result`` gives the
    device's busy ms a step (the union of its kernel, copy and set
    intervals) and its device ops a step, or None where the trace holds no
    device event."""

    def __init__(self, step_fn, steps: int, n: int = E2E_TRACE_STEPS):
        self.step_fn, self.first, self.n = step_fn, steps - n + 1, n
        self.calls, self.profile, self.error = 0, None, None

    def __call__(self, *args):
        self.calls += 1
        if self.calls == self.first:
            torch.cuda.synchronize()
            try:
                profile = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
                ])
                profile.__enter__()
                self.profile = profile
            except Exception as exc:  # the trace is a measurement, not a check
                self.error = repr(exc)
        out = self.step_fn(*args)
        if self.calls == self.first + self.n - 1 and self.profile is not None:
            torch.cuda.synchronize()
            self.profile.__exit__(None, None, None)
        return out

    def result(self) -> dict | None:
        if self.profile is None:
            return None
        spans = sorted(
            (e.time_range.start, e.time_range.end) for e in self.profile.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
        )
        if not spans:
            return None
        busy, end = 0.0, float("-inf")
        for lo, hi in spans:
            busy += max(0.0, hi - max(lo, end))
            end = max(end, hi)
        return {"steps": self.n, "device_busy_ms": busy / 1e3 / self.n,
                "device_ops": len(spans) / self.n}


class CountTraining:
    """Wraps ``train.e2e.train_steps``: the launch counts over the steps,
    and a trace of the last steps (``TraceSteps``)."""

    def __init__(self, train_steps):
        self.train_steps = train_steps
        self.counts: list[dict] = []
        self.traces: list[dict] = []

    def __call__(self, step_fn, *args, steps: int, **kw):
        trace = TraceSteps(step_fn, steps)
        with CountLaunches() as launched:
            out = self.train_steps(trace, *args, steps=steps, **kw)
            torch.cuda.synchronize()
        self.counts.append(launched.counts)
        self.traces.append(trace.result() or {"error": trace.error})
        return out


class CheckSelection:
    """Wraps the embedder script's ``selection_check``: after it, K1-f32
    against its plain twin on the same queries and trained corpus matrix,
    padded as ``dense_topk``'s bin_topk method pads it (top-10 ids equal
    where the scores are untied, ``_check_bin_topk_case``)."""

    def __init__(self, selection_check):
        self.selection_check = selection_check
        self.max_abs_err = None

    def __call__(self, q_vecs, corpus_mat):
        from lean_explore_tpu_torch.ops.dense import TILE_ROWS, pad_rows, serving_bins

        out = self.selection_check(q_vecs, corpus_mat)
        corpus, n_valid = pad_rows(corpus_mat, TILE_ROWS)
        bins = serving_bins(q_vecs.shape[0], corpus.shape[0])
        self.max_abs_err = _check_bin_topk_case(
            "selection on the trained geometry", q_vecs.contiguous(), corpus, n_valid, 10, bins
        )
        return out


def _at(report: dict, path: tuple):
    for key in path:
        report = report[key]
    return report


def run_training_chain(device, kernels, card, repo: Path, seed: int) -> None:
    """Phase 7: the port's two training scripts at the committed runs'
    task and widths, the embedder first and the reranker on the embedder
    it trained, in one temporary directory; then the task data (at seed
    0), the quality gates, the launches of every eval arm and of the
    training steps, and the selection check, each logged beside the card."""
    import lean_explore_tpu_torch.train.e2e as e2e

    log(card)
    started = time.perf_counter()
    embedder_script = load_script(repo, "train_torch_embedder_e2e")
    reranker_script = load_script(repo, "train_torch_reranker_e2e")
    training = CountTraining(e2e.train_steps)
    arms = {"embedder": CountArms(embedder_script.evaluate_engine),
            "reranker": CountArms(reranker_script.evaluate_engine)}
    selection = CheckSelection(embedder_script.selection_check)
    embedder_script.evaluate_engine = arms["embedder"]
    reranker_script.evaluate_engine = arms["reranker"]
    embedder_script.selection_check = selection
    e2e.train_steps = training
    reports, timings = {}, {}
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_e2e_") as tmp:
            out = {name: Path(tmp) / name for name in ("embedder", "reranker")}
            with Phase("7a. scripts/train_torch_embedder_e2e.py"):
                reports["embedder"] = embedder_script.main(
                    ["--out", str(out["embedder"]), "--seed", str(seed), *E2E_EMBEDDER_ARGS]
                )
            with Phase("7b. scripts/train_torch_reranker_e2e.py on that embedder"):
                reports["reranker"] = reranker_script.main(
                    ["--out", str(out["reranker"]), "--seed", str(seed),
                     "--embedder", str(out["embedder"] / "checkpoint"), *E2E_RERANKER_ARGS]
                )
            for name in out:
                timings[name] = json.loads((out[name] / "timing.json").read_text())
    finally:
        e2e.train_steps = training.train_steps

    for (name, timing), trace in zip(timings.items(), training.traces):
        train = timing["train"]
        if "error" in trace:
            error = f" ({trace['error']})" if trace["error"] else ""
            log(f"  {name} trace: no device event{error}; the device's busy share is not measured")
        else:
            trace["busy_share"] = trace["device_busy_ms"] / train["step_ms"]
            train["trace"] = trace
            log(
                f"  {name} trace of the last {trace['steps']} steps: the device busy "
                f"{trace['device_busy_ms']:.3f} ms a step, {trace['busy_share']:.1%} of the "
                f"run's {train['step_ms']:.3f} ms step; {trace['device_ops']:.0f} device ops "
                f"a step; {card}"
            )
        log(
            f"  {name} training: {train['pairs_per_s']:.1f} pairs/s over the "
            f"{train['timed_steps']} steps after the first {e2e.WARM_STEPS} "
            f"({train['step_ms']:.3f} ms a step); loader alone {train['loader_ms']:.3f} ms "
            f"a batch, {train['loader_share']:.1%} of a step; peak memory "
            f"{train['peak_memory_gib']} GiB; {train['seconds']:.1f} s for "
            f"{train['steps']} steps; embedding {timing['embed_docs_per_s']} docs/s; "
            f"script {timing['total_seconds']:.1f} s; {card}"
        )
        log("  " + json.dumps({f"training_chain_{name}": {"report": reports[name], "timing": timing}}))

    problems = []
    for counts in training.counts:
        if any(counts.values()):
            problems.append(f"kernels launched during training: {counts}")
    launches = sum(arms[name].check(name, card) for name in arms)
    if seed == 0:
        for (name, key), want in E2E_TASK.items():
            task = reports[name]["task"]
            got = task["model"][key] if key == "vocab_size" else task[key]
            log(f"  task {name} {key}: {got} (committed {want})")
            if got != want:
                problems.append(f"{name} {key} {got} != committed {want}")
    for name, path, bound, committed in E2E_CEILINGS:
        got = _at(reports[name], path)
        ok = got <= bound + 1e-9
        log(f"  {name} {'/'.join(path)}: {got:.4f} (max {bound:.4f}; committed "
            f"{committed:.4f}){'' if ok else ' MISS'}")
        if not ok:
            problems.append(f"{name} {'/'.join(path)} {got} over {bound}")
    for name, path, bound, committed, reference in E2E_FLOORS:
        got = _at(reports[name], path)
        log(
            f"  {name} {'/'.join(path)}: {got:.4f} (TPU floor {bound:.4f}, logged; committed "
            f"{committed:.4f}, {got - committed:+.4f}; JAX float32 from the same init "
            f"{reference:.4f}){'' if got >= bound - 1e-9 else ' under the TPU floor'}"
        )
    if seed == 0:
        for path, want in E2E_RERANKER_FLOORS.items():
            got = _at(reports["reranker"], path)
            ok = got >= want - E2E_SAME_INIT_SLACK - 1e-9
            log(
                f"  reranker {'/'.join(path)}: {got:.4f} (min {want - E2E_SAME_INIT_SLACK:.4f}: "
                f"JAX float32 from the same init {want:.4f}, {got - want:+.4f}){'' if ok else ' MISS'}"
            )
            if not ok:
                problems.append(f"reranker {'/'.join(path)} {got} more than "
                                f"{E2E_SAME_INIT_SLACK} under JAX's {want}")
        for path, want in E2E_SAME_INIT.items():
            got = _at(reports["embedder"], path)
            ok = abs(got - want) <= E2E_SAME_INIT_SLACK + 1e-9
            log(
                f"  embedder {'/'.join(path)}: {got:.4f} (JAX float32 from the same init "
                f"{want:.4f}, {got - want:+.4f}, within {E2E_SAME_INIT_SLACK:.4f})"
                f"{'' if ok else ' MISS'}"
            )
            if not ok:
                problems.append(f"embedder {'/'.join(path)} {got} not within "
                                f"{E2E_SAME_INIT_SLACK} of JAX's {want}")
    pipeline = reports["reranker"]["pipeline"]
    gap = pipeline["full_pipeline_trained"]["recall_at_1"] - pipeline["full_pipeline_random_rerank"]["recall_at_1"]
    log(f"  reranker: full_pipeline_random_rerank recall@1 {gap:.4f} under the trained arm's "
        f"(TPU floor {E2E_RANDOM_RERANK_GAP}, logged)")
    fused = reports["embedder"]["fused_selection_on_trained_geometry"]["recall_at_10_vs_exact"]
    k1 = reports["embedder"]["bin_topk_selection_on_trained_geometry"]["recall_at_10_vs_exact"]
    log(
        f"  selection recall@10 against the exact scan on the trained geometry: K1-f32 "
        f"{k1:.4f} (min {E2E_SELECTION_MIN}), fused {fused:.4f}, committed fused "
        f"{E2E_SELECTION_COMMITTED}; K1-f32 against its plain twin max_abs_err "
        f"{selection.max_abs_err:.3g}; {card}"
    )
    if k1 < E2E_SELECTION_MIN:
        problems.append(f"K1-f32 selection recall@10 {k1} < {E2E_SELECTION_MIN}")
    by_name = {k["name"]: k for k in kernels}
    by_name["bin_topk_f32"]["training_chain_eval_launches"] = launches
    log(f"  phase 7 (seed {seed}): {time.perf_counter() - started:.1f} s; {card}")
    if problems:
        raise AssertionError(f"training chain: {problems}")
    for forbidden in ("jax", "lean_explore_tpu", "optax"):
        if forbidden in sys.modules:
            raise AssertionError(f"{forbidden} was imported on the training chain")


def run_training_chain_child(root: Path, device, card: str, repo: Path, seed: int) -> int:
    """Phase 7's ``ChildPhase``: phase 7, its K1-f32 eval launches
    written to ROOT/training_chain.json."""
    kernels = [{"name": "bin_topk_f32"}]
    with Phase("7. training end to end at the 20k chain"):
        run_training_chain(device, kernels, card, repo, seed)
    launches = kernels[0]["training_chain_eval_launches"]
    (root / "training_chain.json").write_text(json.dumps({"training_chain_eval_launches": launches}))
    return 0


# ----------------------------------------------------------------------
# Phase 8: the extraction pipeline, from doc-gen4's output to a served query
# ----------------------------------------------------------------------

# Declarations informalized over HTTP, through the port's OpenRouterClient
# against a stub server on localhost, in an extraction of their own.
EXTRACTION_PHASE = "8. the extraction pipeline from doc-gen4's output at the 200k chain"
EXTRACTION_HTTP = dict(n_decls=1000, n_concepts=100, n_eval=32, seed=1, body_sentences=5)
EXTRACTION_MAX_CONCURRENT = 100
# The pipeline's embedding rows against phase 6's rows of the same
# documents: one float32 client, one input, so the same bits but for the
# batch a document falls in (the trunk pads each batch to its own length).
EXTRACTION_EMBED_TOL = 1e-5
EXTRACTION_SERVICE_BATCH = 128
BPE_FIXTURE = Path("tests") / "fixtures" / "bpe_qwen_style"


def _blob_nat(n: int) -> bytes:
    out = bytearray()
    while True:
        low, n = n & 0x7F, n >> 7
        out.append(low | 0x80 if n else low)
        if not n:
            return bytes(out)


def _blob_string(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _blob_nat(len(raw)) + raw


def _blob_const(name: str, child: bytes) -> bytes:
    """leansqlite's RenderedCode: a const tag naming ``name`` (Name.str
    parts), over ``child``."""
    parts = name.split(".")
    name_bytes = bytes([1] * len(parts)) + b"\x00" + b"".join(_blob_string(p) for p in parts)
    return b"\x01\x02" + name_bytes + child


def _blob_text(s: str) -> bytes:
    return b"\x00" + _blob_string(s)


def write_docgen_workspace(corpus, lean_root: Path) -> Path:
    """doc-gen4's output for ``corpus`` in the mathlib workspace of
    ``lean_root``: one Lean file per module under .lake/packages/mathlib4,
    each declaration's source text on a line of its own, and
    .lake/build/api-docs.db (name_info with a RenderedCode type naming
    the declaration itself, a dependency the parse drops, so the store's
    dependencies stay the corpus's none and the engine's dependency boost
    leaves the chain's ranking as phase 6 measures it;
    declaration_ranges; markdown docstrings; modules with their source
    URLs)."""
    import sqlite3

    ws = lean_root / "mathlib"
    build = ws / ".lake" / "build"
    build.mkdir(parents=True)
    by_module: dict[str, list] = {}
    for decl in corpus.declarations:
        by_module.setdefault(decl.module, []).append(decl)
    name_info, ranges, docs, modules = [], [], [], []
    for module, decls in by_module.items():
        path = Path(*module.split(".")).with_suffix(".lean")
        source = ws / ".lake" / "packages" / "mathlib4" / path
        source.parent.mkdir(parents=True, exist_ok=True)
        source.write_text("".join(d.source_text + "\n" for d in decls), encoding="utf-8")
        modules.append((module, "https://github.com/leanprover-community/mathlib4/blob/"
                                f"chip-smoke/{path.as_posix()}"))
        for pos, decl in enumerate(decls):
            blob = _blob_const(decl.name, _blob_text(decl.source_text))
            name_info.append((module, pos, "theorem", decl.name, blob, 1))
            ranges.append((module, pos, pos + 1, pos + 1))
            if decl.docstring:
                docs.append((module, pos, decl.docstring))
    conn = sqlite3.connect(str(build / "api-docs.db"))
    try:
        conn.executescript(
            "CREATE TABLE name_info (module_name TEXT, position INT, kind TEXT, name TEXT,"
            " type BLOB, render INT);"
            "CREATE TABLE declaration_ranges (module_name TEXT, position INT,"
            " start_line INT, end_line INT);"
            "CREATE TABLE declaration_markdown_docstrings (module_name TEXT, position INT,"
            " text TEXT);"
            "CREATE TABLE modules (name TEXT, source_url TEXT);"
        )
        conn.executemany("INSERT INTO name_info VALUES (?,?,?,?,?,?)", name_info)
        conn.executemany("INSERT INTO declaration_ranges VALUES (?,?,?,?)", ranges)
        conn.executemany("INSERT INTO declaration_markdown_docstrings VALUES (?,?,?)", docs)
        conn.executemany("INSERT INTO modules VALUES (?,?)", modules)
        conn.commit()
    finally:
        conn.close()
    return lean_root


def _prompt_name(prompt: str) -> str:
    start = prompt.index("Declaration name: ") + len("Declaration name: ")
    return prompt[start : prompt.index("\n", start)]


class CorpusInformalizer:
    """The informalization stage's client in process: answers each prompt
    with its declaration's synthetic informalization."""

    def __init__(self, corpus):
        self.texts = {d.name: d.informalization for d in corpus.declarations}
        self.calls = 0

    async def generate(self, prompt, model, temperature=0.3):
        self.calls += 1
        return self.texts[_prompt_name(prompt)]


class StubOpenRouter:
    """A chat-completions server on localhost answering each prompt with
    its declaration's synthetic informalization; records the names."""

    def __init__(self, corpus):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        texts = {d.name: d.informalization for d in corpus.declarations}
        self.served: list[str] = []
        served = self.served

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                name = _prompt_name(body["messages"][0]["content"])
                served.append(name)
                data = json.dumps({"choices": [{"message": {"content": texts[name]}}]}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        class Server(ThreadingHTTPServer):
            # The client's requests in flight, each on a connection of its
            # own: a listen backlog under that drops connections, which the
            # kernel retries only after a second.
            request_queue_size = 4 * EXTRACTION_MAX_CONCURRENT
            daemon_threads = True

        self.server = Server(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}/api/v1"

    def __enter__(self):
        import threading

        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=30)
        return False


def run_extraction_stages(corpus, root: Path, *, stages, informalize_client=None,
                          embed_client=None, embed_batch_size: int = 256,
                          extraction: Path | None = None) -> tuple[Path, dict]:
    """The port's ``run_pipeline`` with ``stages`` over the doc-gen4
    workspace of ``corpus`` under ``root``, with the data and cache roots set
    to fresh directories there (so no earlier declarations.db feeds the
    stages' caches). Without ``extraction`` the workspace is written first
    (its seconds as "workspace") and a new extraction directory made; with
    it the stages go on in that one. Returns the extraction directory and
    each stage's seconds."""
    from lean_explore_tpu_torch.config import Config
    from lean_explore_tpu_torch.extract import __main__ as extract_cli
    from lean_explore_tpu_torch.extract import doc_parser

    seconds = {}
    if extraction is None:
        t = time.perf_counter()
        write_docgen_workspace(corpus, root / "lean")
        seconds["workspace"] = time.perf_counter() - t
    saved = Config.DATA_DIRECTORY, Config.CACHE_DIRECTORY, doc_parser.get_extraction_order
    Config.DATA_DIRECTORY, Config.CACHE_DIRECTORY = root / "data", root / "cache"
    # The synthetic workspace is mathlib's alone.
    doc_parser.get_extraction_order = lambda: ["mathlib"]
    try:
        extraction = extraction or Config.create_timestamped_extraction_path()
        seconds.update(asyncio.run(extract_cli.run_pipeline(
            extraction, **{f"run_{s}": s in stages for s in ("docgen", "parse", "informalize",
                                                            "embed", "index")},
            lean_root=root / "lean", informalize_model="chip-smoke",
            max_concurrent=EXTRACTION_MAX_CONCURRENT, embed_batch_size=embed_batch_size,
            limit=None, informalize_client=informalize_client, embed_client=embed_client,
        )))
    finally:
        Config.DATA_DIRECTORY, Config.CACHE_DIRECTORY, doc_parser.get_extraction_order = saved
    return extraction, seconds


def hold_store_to_corpus(extraction: Path, corpus) -> dict[str, np.ndarray]:
    """The parsed and informalized store holds ``corpus``'s declarations:
    names, modules, source texts (each its doc-gen4 line, so with the
    line's newline) and informalizations. Returns the stored embeddings by
    name (empty when the stage did not run)."""
    import sqlite3

    conn = sqlite3.connect(str(extraction / "declarations.db"))
    try:
        rows = conn.execute("SELECT name, module, source_text, informalization, "
                            "informalization_embedding FROM declarations").fetchall()
    finally:
        conn.close()
    want = {d.name: (d.module, d.source_text + "\n", d.informalization)
            for d in corpus.declarations}
    got = {name: (module, source, text) for name, module, source, text, _ in rows}
    if got != want:
        missing = sorted(set(want) - set(got))[:3]
        differing = [n for n in want if n in got and got[n] != want[n]][:3]
        raise AssertionError(f"the extracted store differs from make_corpus: {len(got)} rows of "
                             f"{len(want)}, missing {missing}, differing "
                             f"{[(n, got[n], want[n]) for n in differing]}")
    return {name: np.frombuffer(blob, "<f4") for name, *_, blob in rows if blob is not None}


def check_bpe_reader(corpus, repo: Path, card: str) -> dict:
    """The byte-level BPE reader (the committed Qwen-style fixture) over
    every informalization of ``corpus``: docs/s of the encode and of the
    decode round trip, which must give each text back, beside the
    WordLevel reader of the chain's embedder on the first SPLIT_DOCS."""
    from lean_explore_tpu_torch.models.bpe import ByteLevelBPETokenizer
    from lean_explore_tpu_torch.models.tokenizer import load_tokenizer

    docs = [d.informalization for d in corpus.declarations]
    bpe = load_tokenizer(repo / BPE_FIXTURE)
    if not isinstance(bpe, ByteLevelBPETokenizer):
        raise AssertionError(f"{BPE_FIXTURE} loaded as {type(bpe).__name__}")
    t = time.perf_counter()
    rows = bpe(docs)["input_ids"]
    encode_s = time.perf_counter() - t
    t = time.perf_counter()
    bad = sum(bpe.decode(ids) != doc for ids, doc in zip(rows, docs))
    decode_s = time.perf_counter() - t
    if bad:
        raise AssertionError(f"BPE decode round trip: {bad} of {len(docs)} texts differ")
    wordlevel = load_tokenizer(repo / CHAIN_DIR / "embedder" / "checkpoint")
    t = time.perf_counter()
    wordlevel(docs[:SPLIT_DOCS])
    word_s = time.perf_counter() - t
    rates = {"bpe_docs_per_s": len(docs) / encode_s, "bpe_decode_docs_per_s": len(docs) / decode_s,
             "wordlevel_docs_per_s": min(SPLIT_DOCS, len(docs)) / word_s,
             "bpe_tokens_per_doc": sum(map(len, rows)) / len(docs)}
    log(
        f"  BPE reader ({BPE_FIXTURE}, {len(bpe.vocab)} tokens) over {len(docs)} "
        f"informalizations: encode {rates['bpe_docs_per_s']:.1f} docs/s "
        f"({rates['bpe_tokens_per_doc']:.1f} tokens a doc), decode round trip "
        f"{rates['bpe_decode_docs_per_s']:.1f} docs/s, every text back; the chain's "
        f"WordLevel reader {rates['wordlevel_docs_per_s']:.1f} docs/s over the first "
        f"{min(SPLIT_DOCS, len(docs))}; host CPU; {card}"
    )
    return rates


def extraction_host_stages(repo: Path, root: Path, card: str) -> dict:
    """Phase 8's host stages, which launch nothing on the card: 8a, 1,000
    declarations parsed and informalized through ``OpenRouterClient``
    against a stub server on localhost; the chain's doc-gen4 workspace
    written, parsed and informalized by the in-process client (the store
    held to ``make_corpus``); the BPE reader over every informalization.
    Returns what the device stages go on from."""
    from lean_explore_tpu_torch.train.synthetic import make_corpus
    from lean_explore_tpu_torch.util.openrouter_client import OpenRouterClient

    small = make_corpus(**EXTRACTION_HTTP)
    with StubOpenRouter(small) as stub:
        client = OpenRouterClient(api_key="chip-smoke", base_url=stub.url)
        http_extraction, http_s = run_extraction_stages(
            small, root / "http", stages=("parse", "informalize"), informalize_client=client)
    hold_store_to_corpus(http_extraction, small)
    if sorted(stub.served) != sorted(d.name for d in small.declarations):
        raise AssertionError(f"the stub served {len(stub.served)} prompts, "
                             f"{len(set(stub.served))} names, of {len(small.declarations)}")
    n_http = len(small.declarations)
    log(f"  8a. {n_http} declarations parsed and informalized through OpenRouterClient "
        f"against a localhost stub ({EXTRACTION_MAX_CONCURRENT} in flight): parse "
        f"{http_s['parse']:.1f} s, informalize {http_s['informalize']:.1f} s "
        f"({n_http / http_s['informalize']:.1f} rows/s), every declaration served once")

    t = time.perf_counter()
    corpus = make_corpus(**CHAIN_CORPUS)
    log(f"  make_corpus {CHAIN_CORPUS} in {time.perf_counter() - t:.1f} s")
    informalizer = CorpusInformalizer(corpus)
    extraction, seconds = run_extraction_stages(
        corpus, root / "chain", stages=("parse", "informalize"), informalize_client=informalizer)
    hold_store_to_corpus(extraction, corpus)
    if informalizer.calls != len(corpus.declarations):
        raise AssertionError(f"informalized {informalizer.calls} of {len(corpus.declarations)}")
    rates = check_bpe_reader(corpus, repo, card)
    t = time.perf_counter()
    tools_queries = make_corpus(**{**CHAIN_CORPUS, "n_eval": TOOLS_N_QUERIES}).eval_queries
    log(f"  phase 10a's {TOOLS_N_QUERIES} queries (make_corpus at the chain's arguments) "
        f"in {time.perf_counter() - t:.1f} s")
    return {"extraction": str(extraction), "seconds": seconds, "http_seconds": http_s,
            "tokenizers": rates, "tools_eval_queries": tools_queries}


class ChildPhase:
    """Part of a phase in a child process of this script (``chip_smoke.py
    FLAG ROOT ...``), started before the phases it runs beside: phase 7
    (``--training-chain-child``, host-bound training, the device busy a
    fifth of a step) and phase 8's host stages (``--extraction-host``, one
    core of the host and nothing of the card). ``result`` waits for the
    child, logs its phase and indented lines and returns the record it
    wrote to ROOT/NAME.json; a child that fails or hangs fails the phase,
    and a child still running when the parent stops is killed."""

    TIMEOUT_S = 1000

    def __init__(self, root: Path, name: str, flag: str, *args: str):
        self.root, self.name, self.log = root, name, root / f"{name}.log"
        with open(self.log, "w") as out:
            self.proc = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), flag, str(root), *args],
                stdout=out, stderr=subprocess.STDOUT, cwd=Path(__file__).resolve().parent,
            )

    def result(self) -> dict:
        try:
            returncode = self.proc.wait(timeout=self.TIMEOUT_S)
        except subprocess.TimeoutExpired as error:
            raise AssertionError(f"child {self.name} hung: {self.log.read_text()[-3000:]}") from error
        finally:
            self.stop()
        text = self.log.read_text()
        for line in text.splitlines():
            if line.startswith(("  ", "[phase]")):
                log(line)
        if returncode != 0:
            raise AssertionError(f"child {self.name} exited {returncode}: {text[-3000:]}")
        return json.loads((self.root / f"{self.name}.json").read_text())

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def extraction_host(root: Path, card: str) -> ChildPhase:
    return ChildPhase(root, "extraction_host", "--extraction-host", "--card", card)


def run_extraction_host(root: Path, card: str) -> int:
    """Phase 8's host ``ChildPhase``: the host stages, their record
    written to ROOT/extraction_host.json."""
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    record = extraction_host_stages(repo, root, card)
    (root / "extraction_host.json").write_text(json.dumps(record))
    return 0


def run_extraction_chain(device, kernels, card, repo: Path, root: Path,
                         host: ChildPhase) -> dict:
    """Phase 8 in ``root``: the 200k chain built by the port's extraction
    pipeline, from doc-gen4's output (written here) through parse and
    informalize (``host``, the child process) and then embed, on the card,
    and index, each stage timed; then the quality eval over its artifacts
    and one Service batch at the serving defaults. Returns what phase 6
    reuses: the corpus, the extraction directory, its open store, the stage
    seconds, the stored embeddings by name and the f32 embedder."""
    from lean_explore_tpu_torch.models.store import DeclarationStore
    from lean_explore_tpu_torch.search.engine import SearchEngine
    from lean_explore_tpu_torch.train.synthetic import make_corpus
    from lean_explore_tpu_torch.util.embedding_client import EmbeddingClient
    from lean_explore_tpu_torch.util.reranker_client import RerankerClient

    log(card)
    embedder_dir, reranker_dir = chain_checkpoints(repo)
    script = load_script(repo, "eval_torch_quality")
    hosted = host.result()
    corpus = make_corpus(**CHAIN_CORPUS)
    embedder = EmbeddingClient(
        str(embedder_dir), max_length=CHAIN_EMB_MAX_LENGTH, batch_size=script.EMBED_BATCH,
        dtype=torch.float32, device=device,
    )
    extraction, device_s = run_extraction_stages(
        corpus, root / "chain", stages=("embed", "index"), embed_client=embedder,
        embed_batch_size=script.EMBED_BATCH, extraction=Path(hosted["extraction"]),
    )
    seconds = {**hosted["seconds"], **device_s}
    n = len(corpus.declarations)
    embeddings = hold_store_to_corpus(extraction, corpus)
    manifest = json.loads((extraction / "manifest.json").read_text())
    if len(embeddings) != n or manifest["n_embedded"] != n:
        raise AssertionError(f"embedded {len(embeddings)}, manifest n_embedded "
                             f"{manifest['n_embedded']}, of {n}")
    log("  8b. stages (s, rows/s): " + "; ".join(
        f"{stage} {s:.1f} ({n / s:.1f})" for stage, s in seconds.items())
        + f"; {n} declarations, the store equal to make_corpus's, manifest n_embedded "
        f"{manifest['n_embedded']}; parse and informalize in a child process beside "
        f"phases 4 and 5; {card}")

    # 8c. The quality eval over the pipeline's artifacts, f32 corpus.
    store = DeclarationStore(extraction / "declarations.db")
    reranker = RerankerClient(str(reranker_dir), max_length=CHAIN_RR_MAX_LENGTH,
                              dtype=torch.float32, device=device)
    engine, load_s = script.open_engine(extraction, store, embedder, reranker, device)
    batches = -(-len(corpus.eval_queries) // 64)
    metrics, eval_s, counts = eval_arm(engine, corpus, batches, None)
    misses = hold_to_reference("8c. extraction's index", metrics, CHAIN_REFERENCE, eval_s,
                               counts, batches, card)
    if misses:
        raise AssertionError(f"the extraction's index: {misses} beyond {CHAIN_QUERY_SLACK} "
                             f"queries (MRR {CHAIN_MRR_SLACK}) of the committed JAX numbers")
    del engine, reranker

    # 8d. One Service batch at the serving defaults (bf16 corpus, K1 once)
    # against an in-process engine built the same default way.
    from lean_explore_tpu_torch.config import Config
    from lean_explore_tpu_torch.search.service import Service

    queries = [q for q, _ in corpus.eval_queries[:EXTRACTION_SERVICE_BATCH]]
    saved = Config.EMBEDDING_MAX_LENGTH, Config.RERANKER_MAX_LENGTH
    Config.EMBEDDING_MAX_LENGTH, Config.RERANKER_MAX_LENGTH = CHAIN_EMB_MAX_LENGTH, CHAIN_RR_MAX_LENGTH
    try:
        def default_engine():
            engine = SearchEngine(extraction, embedding_model_name=str(embedder_dir),
                                  reranker_model_name=str(reranker_dir), device=device)
            engine.embedding_client, engine.reranker_client  # load now
            return engine

        service, reference = Service(default_engine()), default_engine()
        dense = service.engine._artifacts.dense
        if dense.embeddings.dtype != torch.bfloat16:
            raise AssertionError(f"the serving corpus is {dense.embeddings.dtype}")
        with CountLaunches() as launched:
            t = time.perf_counter()
            responses = asyncio.run(service.search_batch(queries))
            torch.cuda.synchronize()
            batch_s = time.perf_counter() - t
        expect_launches("8d. Service.search_batch", launched.counts, "bin_topk", 1)
        if launched.counts["bin_topk"] != 1:
            raise AssertionError(f"K1 launched {launched.counts['bin_topk']} times in one batch")
        want = asyncio.run(reference.search_batch(queries, limit=20, rerank_top=50))
        got_ids = [[r.id for r in resp.results] for resp in responses]
        want_ids = [[r.id for r in results] for results in want]
        if got_ids != want_ids:
            bad = sum(g != w for g, w in zip(got_ids, want_ids))
            raise AssertionError(f"8d: {bad} of {len(queries)} queries' ids differ")
    finally:
        Config.EMBEDDING_MAX_LENGTH, Config.RERANKER_MAX_LENGTH = saved
    del service, reference
    torch.cuda.empty_cache()
    log(f"  8d. Service.search_batch of {len(queries)} queries at the serving defaults "
        f"(bf16 corpus): {batch_s * 1e3:.1f} ms, K1 launches {launched.counts['bin_topk']}, "
        f"ids equal to an in-process engine built the same default way; {card}")
    rates = hosted["tokenizers"]
    log("  " + json.dumps({"extraction_chain": {
        "seconds": {k: round(v, 3) for k, v in seconds.items()},
        "rows_per_s": {k: round(n / v, 1) for k, v in seconds.items()},
        "http_seconds": {k: round(v, 3) for k, v in hosted["http_seconds"].items()},
        "quality": metrics, "eval_s": round(eval_s, 3), "load_s": round(load_s, 3),
        "service_batch_ms": round(batch_s * 1e3, 1), "tokenizers": rates}}))
    by_name = {k["name"]: k for k in kernels}
    if "bin_topk" in by_name:
        by_name["bin_topk"]["extraction_service_launches"] = launched.counts["bin_topk"]
    by_name["bin_topk_f32"]["extraction_eval_launches"] = counts["bin_topk"]
    for forbidden in ("jax", "lean_explore_tpu"):
        if forbidden in sys.modules:
            raise AssertionError(f"{forbidden} was imported on the extraction path")
    return dict(corpus=corpus, extraction=extraction, store=store, seconds=seconds,
                embeddings=embeddings, embedder=embedder,
                tools_eval_queries=[tuple(pair) for pair in hosted["tools_eval_queries"]])


# ----------------------------------------------------------------------
# Phase 9: the mesh on the one card
# ----------------------------------------------------------------------

# 9a/9b: a (data, corpus) = (2, 4) serving mesh of eight virtual devices,
# all cuda:0, as the JAX tests' host devices are virtual. Real cross-card
# traffic needs a machine with more cards.
MESH_SERVE_SHAPE = (2, 4)
# DP rerank against one device: each device scores its 16 groups as the
# single-device path scores the same 16 (one group chunk), but the prefix
# forward runs 16 rows where one device runs 128, and cuBLAS may sum a
# product's depth in another order for another row count. Each bf16 output
# then rounds at most one ulp apart (2^-8 relative), the scale of
# RERANK_FLASH_TOL's rounding (2^-9 per rounding through 28 layers), so
# the same bound holds.
RERANK_DP_TOL = RERANK_FLASH_TOL
# 9c: phase 5's width at 2 of its 28 layers, to fit the time (the whole
# script ran 1,190 s of its 1,200 at 4 on a slow host).
MESH_TRAIN_SHAPE, MESH_TRAIN_LAYERS = (2, 2), 2
MESH_RANK_TIMEOUT_S = 300
# The CPU tests' tolerance (tests/test_torch_parallel_train.py): a loss
# within 1e-5 relative plus twice its first-order change, params within
# 2 sum_t lr U_t + 2^-23 |p|, U_t Adam's largest update of one entry at
# step t (1, 1.00136, 1.00362 at steps 1-3, rounded up).
MESH_LOSS_RTOL = 1e-5
ADAM_U = (1.0, 1.0014, 1.0037)
# Step 1's gradients, mesh against one device (relative L2 a leaf): both
# run the same kernels on the same rows and heads, and differ only where
# f32 sums run in another order (the row-split o/down products summed over
# model, the gradients over data), a few 2^-24 a value; the CPU test holds
# that within 1e-5 (GRAD_REL_L2), and 1e-4 leaves ten times that for cuBLAS
# choosing other kernels at the mesh's half shapes. A missed or doubled
# reduction moves a gradient by half of it or more.
MESH_GRAD_REL_L2 = 1e-4


class PlainCarries:
    """Within it, the K1 and K2 wrappers' modules compute the plain twin
    on the card (their kernels untouched), so a sharded search runs its
    plain version on the same inputs."""

    def __enter__(self):
        from lean_explore_tpu_torch.ops import bin_topk as K1
        from lean_explore_tpu_torch.ops import bin_topk_int8 as K2

        self._real = (K1.bin_topk_carry, K2.bin_topk_int8_carry)

        def k1(q, corpus, n_valid, bins):
            steal = K1.steal_bits_for(corpus.shape[0], bins)
            return K1.bin_topk_carry_plain(q, corpus, n_valid, bins, steal)

        def k2(q_codes, q_scales, codes, scales, n_valid, bins):
            steal = K1.steal_bits_for(codes.shape[0], bins)
            return K2.bin_topk_int8_carry_plain(
                q_codes, q_scales, codes, scales, n_valid, bins, steal
            )

        K1.bin_topk_carry, K2.bin_topk_int8_carry = k1, k2
        return self

    def __exit__(self, *exc):
        from lean_explore_tpu_torch.ops import bin_topk as K1
        from lean_explore_tpu_torch.ops import bin_topk_int8 as K2

        K1.bin_topk_carry, K2.bin_topk_int8_carry = self._real
        return False


def clone_embedder(client, **kw):
    """An embedder with ``client``'s params, tokenizer and settings."""
    from lean_explore_tpu_torch.util.embedding_client import EmbeddingClient

    return EmbeddingClient.from_components(
        client.params, client.config, client.tokenizer, model_name=client.model_name,
        max_length=client.max_length, batch_size=client.batch_size,
        append_eos=client.append_eos, query_prompt=client.query_prompt, **kw,
    )


def sharded_rows(index) -> torch.Tensor:
    """The sharded index's padded rows in f32 on its first device (int8
    dequantized): the exact scores of any returned row."""
    rows = [s.to(torch.float32) for s in index.shards[0]]
    if index.scales is not None:
        rows = [r * s[:, None] for r, s in zip(rows, index.scales[0])]
    return torch.cat(rows)


def check_shard_carries(index, q: torch.Tensor, k: int) -> float:
    """Each (data, corpus) position's carry against its plain twin on its
    shard, with the position's query slice, local valid rows and bins: K1
    within ``_check_bin_topk_case``'s tolerance, K2 bit for bit."""
    from lean_explore_tpu_torch.parallel.sharded import _shard_bins

    n_data, n_corpus = index.mesh.devices.shape
    per = q.shape[0] // n_data
    rows = index.shard_rows
    err = 0.0
    for (d, c), shard in np.ndenumerate(index.shards):
        q_d = q[d * per : (d + 1) * per]
        local_valid = min(max(index.n - c * rows, 0), rows)
        bins = _shard_bins(rows, per)
        name = f"shard ({d}, {c})"
        if index.scales is not None:
            err = max(err, _check_bin_topk_int8_case(
                name, q_d.contiguous(), shard, index.scales[d, c], local_valid, k, bins
            ))
        else:
            err = max(err, _check_bin_topk_case(
                name, q_d.to(shard.dtype).contiguous(), shard, local_valid, k, bins
            ))
    return err


def check_sharded_merge(index, q: torch.Tensor, k: int, tol: float) -> int:
    """The sharded top-k through the kernels against the same search on the
    plain twins (``PlainCarries``): scores within ``tol``; an id may
    differ only at a near tie (the exact scores of the two rows within
    ``tol``). Returns the count of ids that differ."""
    with CountLaunches() as plain_run:
        with PlainCarries():
            want_s, want_ids = index.search(q, k)
    if any(plain_run.counts.values()):
        raise AssertionError(f"the plain sharded search launched {plain_run.counts}")
    got_s, got_ids = index.search(q, k)
    err = float(np.abs(got_s - want_s).max())
    if not err <= tol:
        raise AssertionError(f"sharded top-{k}: score error {err} > {tol} against the plain twin")
    differ = got_ids != want_ids
    if differ.any():
        rows = sharded_rows(index)
        qf = q.to(torch.float32)
        exact = [
            torch.einsum("bd,bkd->bk", qf, rows[torch.from_numpy(ids - 1).to(rows.device)])
            for ids in (got_ids, want_ids)
        ]
        gap = float((exact[0] - exact[1]).abs()[torch.from_numpy(differ).to(rows.device)].max())
        if not gap <= tol:
            raise AssertionError(
                f"sharded top-{k}: {int(differ.sum())} ids differ with a score gap {gap} > {tol}"
            )
    return int(differ.sum())


def sharded_recall_at_10(index, q: torch.Tensor) -> float:
    """Recall@10 of the sharded kernel path against the exact scan of the
    same rows."""
    rows = sharded_rows(index)[: index.n]
    want = torch.topk(q.to(torch.float32) @ rows.T, 10, dim=1).indices.cpu().numpy() + 1
    _, got = index.search(q, 10)
    recall = float(np.mean([len(set(g) & set(w)) / 10 for g, w in zip(got, want)]))
    if not recall >= 0.97:
        raise AssertionError(f"sharded dense recall@10 {recall} below 0.97")
    return recall


def drive_mesh_service(service, store, label: str, kernel: str, per_batch: int,
                       reps: int, card: str):
    """One warm batch, then ``reps`` timed batches with every launch count
    set to 0 before them: ``kernel`` exactly ``per_batch`` times a batch and
    no other kernel. Returns (counts, the first timed batch's responses,
    ms a batch)."""
    from lean_explore_tpu_torch.util.profiling import StageTimings

    t = time.perf_counter()
    check_results(asyncio.run(service.search_batch(queries_for(999))), store)
    log(f"  {label}: warm batch of {BATCH}: {time.perf_counter() - t:.2f} s")
    totals: dict[str, float] = {}
    batch_ms = []
    with CountLaunches() as launched:
        for rep in range(reps):
            timings = StageTimings()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = asyncio.run(service.search_batch(queries_for(rep), timings=timings))
            torch.cuda.synchronize()
            batch_ms.append((time.perf_counter() - t0) * 1e3)
            check_results(out, store)
            first = out if rep == 0 else first
            for stage, ms in timings.as_dict().items():
                totals[stage] = totals.get(stage, 0.0) + ms
    counts = launched.counts
    if counts[kernel] != per_batch * reps or any(c for n, c in counts.items() if n != kernel):
        raise AssertionError(f"{label}: launches {counts}, want {kernel} {per_batch} a batch")
    stage_ms = {k: round(v / reps, 2) for k, v in totals.items()}
    log(
        f"  {label}: ms per batch of {BATCH} {[round(x, 1) for x in batch_ms]}; stage ms "
        f"{stage_ms}; launches {counts}; {len(service.engine.embedding_client.mesh.devices)} "
        f"virtual devices on one card (not a multi-card figure); {card}"
    )
    return counts, first, batch_ms


def compare_with_single_device(single_out, mesh_out, single, mesh_service, queries,
                               card: str) -> None:
    """Logs the mesh's final ids against the single-device service's on the
    same queries: equal top-10s and, for each query that differs, whether
    the dense candidates (the ordered top-1000 of each path's own query
    embeddings) changed or only the rerank and fusion."""
    k = 1000
    emb_single = single.engine.embedding_client.embed_device(queries, True)
    emb_mesh = mesh_service.engine.embedding_client.embed_device(queries, True)
    _, dense_single = single.engine._artifacts.dense.search(emb_single, k)
    _, dense_mesh = mesh_service.engine._artifacts.dense.search(emb_mesh, k)
    equal, dense_changed, rerank_changed = 0, 0, 0
    for i, (a, b) in enumerate(zip(single_out, mesh_out)):
        if [r.id for r in a.results[:10]] == [r.id for r in b.results[:10]]:
            equal += 1
        elif list(dense_single[i]) != list(dense_mesh[i]):
            dense_changed += 1
        else:
            rerank_changed += 1
    emb_diff = float((emb_single - emb_mesh.to(emb_single.device)).abs().max())
    log(
        f"  mesh vs single-device service on {len(queries)} queries: {equal} equal top-10s; "
        f"of the others, {dense_changed} with other dense candidates, {rerank_changed} "
        f"with the same dense candidates (rerank and fusion); query embeddings' largest "
        f"difference {emb_diff:.3g} (data-parallel embed, 16 rows a forward); {card}"
    )


def run_mesh_serving(serving, kernels, card) -> None:
    """Phases 9a and 9b on the phase-4 set-up: the phase-4 corpus sharded
    over a (2, 4) mesh of cuda:0 eight times, the phase-4 clients on the
    flat data mesh of those 8, through ``Service.search_batch``."""
    from lean_explore_tpu_torch.parallel import ShardedDenseIndex, make_mesh, rerank_data_mesh
    from lean_explore_tpu_torch.ops.bin_topk import score_tolerance, steal_bits_for
    from lean_explore_tpu_torch.parallel.sharded import _shard_bins

    by_name = {k["name"]: k for k in kernels}
    device = serving.device
    mesh = make_mesh(MESH_SERVE_SHAPE, devices=[device] * 8)
    data_mesh = rerank_data_mesh(mesh)
    embedder = clone_embedder(serving.embedder, mesh=data_mesh)
    reranker = clone_reranker(serving.reranker, serving.reranker.params, mesh=data_mesh)
    host = seeded_corpus(device, N_ROWS, serving.embedder.dim).cpu().numpy()
    ids = np.arange(1, N_ROWS + 1)
    with Phase("9a. Service.search_batch on a (2, 4) mesh of cuda:0, bf16 corpus"):
        t = time.perf_counter()
        index = ShardedDenseIndex(host, ids, mesh, dtype="bfloat16")
        torch.cuda.synchronize()
        if index.method != "fused" or index.shards[0, 0].shape[0] != 75_264:
            raise AssertionError(f"sharded index: {index.method}, {index.shards[0, 0].shape}")
        log(
            f"  sharded index: {N_ROWS} rows padded to {index.shard_rows * 4}, shards of "
            f"{index.shard_rows} x {index.dim} bf16 (one copy each on cuda:0), "
            f"{time.perf_counter() - t:.1f} s"
        )
        service = dataclasses.replace(serving, embedder=embedder, reranker=reranker).service(index)
        groups = capture_groups(reranker)
        counts, mesh_out, batch_ms = drive_mesh_service(
            service, serving.store, "mesh bf16 corpus", "bin_topk", 8, 2, card
        )
        by_name["bin_topk"]["mesh_launches"] = counts["bin_topk"]
        by_name["bin_topk"]["mesh_launches_per_batch"] = 8
        by_name["bin_topk"]["mesh_batch_ms"] = batch_ms
        q = embedder.embed_device(queries_for(0), True)
        q = q / q.norm(dim=1, keepdim=True)
        carry_err = check_shard_carries(index, q, BIN_K)
        steal = steal_bits_for(index.shard_rows, _shard_bins(index.shard_rows, BATCH // 2))
        tol = 2.0 * 2.0 ** (steal - 22) + score_tolerance(torch.bfloat16, index.dim)
        differ = check_sharded_merge(index, q, BIN_K, tol)
        recall = sharded_recall_at_10(index, q)
        log(
            f"  8 shard carries against their plain twins: max score error {carry_err:.3g}; "
            f"merged top-{BIN_K} against the plain sharded twin within {tol:.3g}, "
            f"{differ} ids differing at near ties; dense recall@10 against the exact scan "
            f"{recall:.4f}"
        )
        queries, docs = groups[-1]
        drift = score_diff(
            reranker.rerank_grouped_sync(queries, docs),
            serving.reranker.rerank_grouped_sync(queries, docs),
        )
        if not drift.max() <= RERANK_DP_TOL:
            raise AssertionError(f"DP rerank P(true) differs from one device by {drift.max()}")
        log(
            f"  DP rerank over 8 virtual devices against one device on {len(drift)} pairs "
            f"of the last batch: P(true) max difference {drift.max():.3g} (tol "
            f"{RERANK_DP_TOL}), mean {drift.mean():.3g}"
        )
        single = serving.service()
        single_out = asyncio.run(single.search_batch(queries_for(0)))
        compare_with_single_device(single_out, mesh_out, single, service, queries_for(0), card)
        by_name["bin_topk"]["mesh_max_abs_err"] = carry_err
        del index, service, single
        torch.cuda.empty_cache()

    with Phase("9b. Service.search_batch on the (2, 4) mesh, int8 corpus"):
        t = time.perf_counter()
        index = ShardedDenseIndex(host, ids, mesh, dtype="int8")
        log(f"  int8 sharded index ({index.method}) in {time.perf_counter() - t:.1f} s")
        del host
        service = dataclasses.replace(serving, embedder=embedder, reranker=reranker).service(index)
        counts, _, batch_ms = drive_mesh_service(
            service, serving.store, "mesh int8 corpus", "bin_topk_int8", 8, 1, card
        )
        by_name["bin_topk_int8"]["mesh_launches"] = counts["bin_topk_int8"]
        by_name["bin_topk_int8"]["mesh_launches_per_batch"] = 8
        by_name["bin_topk_int8"]["mesh_batch_ms"] = batch_ms
        q = embedder.embed_device(queries_for(0), True)
        q = q / q.norm(dim=1, keepdim=True)
        check_shard_carries(index, q, BIN_K)
        differ = check_sharded_merge(index, q, BIN_K, 0.0)
        log(f"  8 int8 shard carries equal their plain twins bit for bit; merged top-"
            f"{BIN_K} equal to the plain sharded twin's ({differ} ids differ)")
        del index, service
        torch.cuda.empty_cache()


MESH_KERNEL_ROWS = (
    "bin_topk", "bin_topk_int8", "flash_attention_f32", "flash_attention_bwd_dq_f32",
    "flash_attention_bwd_dkv_f32",
)


def run_mesh_phases(device, kernels, card) -> None:
    """``--mesh``: phase 4's serving set-up and phase 5's training data
    built alone, then phases 9a-9c on them."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        run_mesh_serving(build_service(device, tmp), kernels, card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        data_dir, _ = write_training_data(tmp)
        with Phase("9c. training CLI on a (2, 2) mesh of four processes on the card, and on one device"):
            run_mesh_training(device, kernels, data_dir, Path(tmp), card)


def export_random_mesh_model(device, data_dir, out_dir) -> None:
    """Phase 5's random 0.6B-width checkpoint at MESH_TRAIN_LAYERS layers."""
    from lean_explore_tpu_torch.models import qwen3
    from lean_explore_tpu_torch.train.export import export_hf_checkpoint

    config = dataclasses.replace(qwen06b_config(), num_hidden_layers=MESH_TRAIN_LAYERS)
    params = qwen3.init_params(config, torch.Generator(device=device).manual_seed(3), device=device)
    export_hf_checkpoint(params, config, out_dir, tokenizer_dir=data_dir)
    del params
    torch.cuda.empty_cache()


def mesh_cli_argv(model_dir, data_dir, ckpt, steps: int, mesh: str) -> list[str]:
    """The training CLI at its defaults (batch 32, queries 64, documents
    256, lr 1e-5), a checkpoint every step."""
    return [
        "--model-dir", str(model_dir), "--data-dir", str(data_dir), "--steps", str(steps),
        "--checkpoint-dir", str(ckpt), "--checkpoint-every", "1", "--log-every", "1",
        "--mesh", mesh,
    ]


def run_mesh_rank(job_path: Path, rank: int) -> int:
    """One rank of 9c (``chip_smoke.py --mesh-rank R --mesh-job JOB``): the
    training CLI with flash on, once for each of JOB's ``argvs`` in turn
    (the second resumes the first's checkpoint), each run's launch counts
    and records written to JOB's ``out`` with the rank appended."""
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    job = json.loads(Path(job_path).read_text())
    for name in CPU_REQUEST_VARS:
        os.environ.pop(name, None)
    os.environ[FLASH_ENV] = "1"
    import torch.distributed as dist

    from lean_explore_tpu_torch.parallel.mesh import init_distributed
    from lean_explore_tpu_torch.train.__main__ import main as train_main

    mesh = init_distributed(
        tuple(job["shape"]), init_method=job["init"], world_size=job["world"], rank=rank
    )
    runs = []
    for argv in job["argvs"]:
        with CountLaunches() as launched:
            records = train_main(argv)
            torch.cuda.synchronize()
        runs.append({"records": records, "counts": launched.counts})
    Path(f"{job['out']}.{rank}").write_text(json.dumps({
        "runs": runs, "backend": dist.get_backend(), "device": str(mesh.device),
        "coords": mesh.coords,
    }))
    dist.destroy_process_group()
    return 0


def run_mesh_cli(tmp: Path, name: str, argvs: list[list[str]]) -> list[dict]:
    """The CLI in one process per position of MESH_TRAIN_SHAPE on the card,
    each process running ``argvs`` in turn; returns each rank's record. A
    rank that fails or hangs fails the phase with its log's tail, and
    every rank is stopped."""
    world = MESH_TRAIN_SHAPE[0] * MESH_TRAIN_SHAPE[1]
    run_dir = tmp / name
    run_dir.mkdir()
    job = run_dir / "job.json"
    job.write_text(json.dumps({
        "shape": MESH_TRAIN_SHAPE, "world": world, "argvs": argvs,
        "init": f"file://{run_dir / 'rendezvous'}", "out": str(run_dir / "rank"),
    }))
    # Two host threads a rank: four ranks with a thread a core each
    # oversubscribe the host, and gloo reduces on it.
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    procs = []
    try:
        for rank in range(world):
            with open(run_dir / f"rank{rank}.log", "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), "--mesh-rank", str(rank),
                     "--mesh-job", str(job)],
                    stdout=out, stderr=subprocess.STDOUT, cwd=Path(__file__).resolve().parent,
                    env=env,
                ))
        deadline = time.monotonic() + MESH_RANK_TIMEOUT_S
        for rank, proc in enumerate(procs):
            try:
                code = proc.wait(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                code = "timeout"
            if code != 0:
                tail = (run_dir / f"rank{rank}.log").read_text()[-3000:]
                raise AssertionError(f"9c {name}: rank {rank} ended with {code}: {tail}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return [json.loads(Path(f"{run_dir / 'rank'}.{r}").read_text()) for r in range(world)]


def mesh_loss_grads(device, ckpt: Path, config, batch):
    """The one-device InfoNCE gradients at a checkpoint's params on a batch."""
    from lean_explore_tpu_torch.train.contrastive import infonce_loss, param_leaves, trainable

    saved = torch.load(ckpt, map_location=device, weights_only=True)["params"]
    params = trainable(saved)
    loss, _ = infonce_loss(params, config, batch)
    loss.backward()
    return [p.grad for p in param_leaves(params)], params


def run_mesh_training(device, kernels, data_dir: Path, tmp: Path, card: str) -> None:
    """Phase 9c: the contrastive CLI on a (2, 2) mesh of four processes on
    the card (two steps, a checkpoint each, then resumed to step 3 in the
    same processes), and the
    same on one device: to step 2 from the same init, and resumed from the
    mesh's step-2 checkpoint to step 3."""
    from lean_explore_tpu_torch.models.tokenizer import load_tokenizer
    from lean_explore_tpu_torch.models.store import DeclarationStore
    from lean_explore_tpu_torch.train import ContrastiveDataLoader, pairs_from_store
    from lean_explore_tpu_torch.train.__main__ import main as train_main
    from lean_explore_tpu_torch.train.contrastive import param_leaves

    by_name = {k["name"]: k for k in kernels}
    model_dir = tmp / "mesh_model"
    export_random_mesh_model(device, data_dir, model_dir)

    mesh_ckpt, one_ckpt, resumed_ckpt = tmp / "mesh_ckpt", tmp / "one_ckpt", tmp / "resumed_ckpt"
    shape = ",".join(map(str, MESH_TRAIN_SHAPE))
    ranks = run_mesh_cli(tmp, "mesh", [
        mesh_cli_argv(model_dir, data_dir, mesh_ckpt, 2, shape),
        mesh_cli_argv(model_dir, data_dir, mesh_ckpt, 3, shape),  # resumes at step 2
    ])
    for rank, record in enumerate(ranks):
        if record["backend"] != "gloo":
            raise AssertionError(f"rank {rank} ran on {record['backend']}, want gloo")
        for run, steps in zip(record["runs"], (2, 1)):
            _expect_training_launches(f"9c rank {rank}", run["counts"], steps, MESH_TRAIN_LAYERS)
    mesh_records = [r for run in ranks[0]["runs"] for r in run["records"]]
    for record in ranks[1:]:
        losses = [r["loss"] for run in record["runs"] for r in run["records"]]
        if losses != [r["loss"] for r in mesh_records]:
            raise AssertionError(f"ranks disagree on the losses: {losses}")

    saved = {name: os.environ.pop(name) for name in CPU_REQUEST_VARS if name in os.environ}
    os.environ[FLASH_ENV] = "1"
    try:
        one = train_main(mesh_cli_argv(model_dir, data_dir, one_ckpt, 2, "1,1"))
        resumed_ckpt.mkdir()
        os.link(mesh_ckpt / "step_00000002", resumed_ckpt / "step_00000002")
        one += train_main(mesh_cli_argv(model_dir, data_dir, resumed_ckpt, 3, "1,1"))
    finally:
        os.environ.pop(FLASH_ENV, None)
        os.environ.update(saved)
    if [r["step"] for r in mesh_records] != [1, 2, 3] or [r["step"] for r in one] != [1, 2, 3]:
        raise AssertionError(f"9c steps {mesh_records} / {one}")

    # Step 1 runs from the same params on the same batch on both sides, so
    # its first moments (0.1 x the gradients) hold the mesh's reductions.
    moments = [
        torch.load(c / "step_00000001", map_location=device, weights_only=True)
        ["opt_state"]["state"]
        for c in (mesh_ckpt, one_ckpt)
    ]
    grad_err = max(
        float((moments[0][i]["exp_avg"] - want["exp_avg"]).norm()
              / want["exp_avg"].norm().clamp_min(1e-30))
        for i, want in moments[1].items()
    )
    del moments
    if not grad_err <= MESH_GRAD_REL_L2:
        raise AssertionError(
            f"9c step-1 first moments: relative L2 {grad_err} > {MESH_GRAD_REL_L2}"
        )

    # Step 1 and the resumed step 3 start from the same params on both
    # sides; step 2 from params one step apart, whose first-order effect on
    # the loss is the one-device gradient at its params times the gap.
    config = dataclasses.replace(qwen06b_config(), num_hidden_layers=MESH_TRAIN_LAYERS)
    pairs = pairs_from_store(DeclarationStore(str(data_dir / "declarations.db")))
    loader = iter(ContrastiveDataLoader(load_tokenizer(model_dir), pairs, seed=0))
    next(loader)
    batch2 = next(loader).to(device)
    os.environ[FLASH_ENV] = "1"
    try:
        grads, one_params = mesh_loss_grads(device, one_ckpt / "step_00000001", config, batch2)
    finally:
        os.environ.pop(FLASH_ENV, None)
    mesh_params = torch.load(mesh_ckpt / "step_00000001", map_location=device,
                             weights_only=True)["params"]
    first_order = sum(
        float((g * (m.detach() - p.detach())).abs().sum())
        for g, m, p in zip(grads, param_leaves(mesh_params), param_leaves(one_params))
    )
    del grads, one_params, mesh_params
    tols = [MESH_LOSS_RTOL * abs(r["loss"]) for r in one]
    tols[1] += 2 * first_order
    diffs = [abs(m["loss"] - o["loss"]) for m, o in zip(mesh_records, one)]
    if not all(d <= t for d, t in zip(diffs, tols)):
        raise AssertionError(f"9c losses: mesh {mesh_records}, one device {one}, tol {tols}")
    lr = 1e-5
    worst = {}
    for step, ckpts, bound in (
        (2, (mesh_ckpt, one_ckpt), 2 * lr * (ADAM_U[0] + ADAM_U[1])),
        (3, (mesh_ckpt, resumed_ckpt), 2 * lr * ADAM_U[2]),
    ):
        a, b = ([leaf.detach() for leaf in param_leaves(torch.load(
            c / f"step_{step:08d}", map_location=device, weights_only=True)["params"])]
            for c in ckpts)
        excess = 0.0
        for x, y in zip(a, b):
            slack = bound + 2.0**-23 * y.abs()
            excess = max(excess, float(((x - y).abs() - slack).max()))
        if excess > 0:
            raise AssertionError(f"9c step-{step} params differ beyond the bound by {excess}")
        worst[step] = float(max((x - y).abs().max() for x, y in zip(a, b)))
        del a, b
    torch.cuda.empty_cache()
    mesh_s = [r["seconds"] for r in mesh_records]
    log(
        f"  9c losses mesh {[round(r['loss'], 6) for r in mesh_records]} vs one device "
        f"{[round(r['loss'], 6) for r in one]} (differences {[f'{d:.3g}' for d in diffs]}, "
        f"tol {[f'{t:.3g}' for t in tols]}); step 1's first moments' worst relative L2 "
        f"{grad_err:.3g} (tol {MESH_GRAD_REL_L2:.3g}); params' largest difference at step 2 "
        f"{worst[2]:.3g}, after the resumed step 3 {worst[3]:.3g}"
    )
    log(
        f"  9c: (2, 2) mesh step seconds {[round(s, 3) for s in mesh_s]} (gloo, four "
        f"processes on one card: not a multi-card figure) against one device "
        f"{[round(r['seconds'], 3) for r in one]}; each rank's launches per step "
        f"{MESH_TRAIN_LAYERS} forward, dq and dk/dv; {card}"
    )
    for name in ("flash_attention_f32", "flash_attention_bwd_dq_f32", "flash_attention_bwd_dkv_f32"):
        by_name[name]["mesh_launches_per_rank"] = [
            sum(run["counts"][name.removesuffix("_f32")] for run in record["runs"])
            for record in ranks
        ]
        by_name[name]["mesh_launches_per_rank_step"] = MESH_TRAIN_LAYERS


if __name__ == "__main__":
    sys.exit(main())
