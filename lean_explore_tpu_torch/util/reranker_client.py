"""Cross-encoder reranker client: Qwen3-Reranker forwards in PyTorch
(lean_explore_tpu/util/reranker_client.py).

Same ``<Instruct>/<Query>/<Document>`` pair format, last-token true/false
softmax and surface as the JAX client: ``rerank`` / ``rerank_sync`` for one
query, ``rerank_pairs`` for pairs of different queries, and the serving
path ``rerank_grouped``, where each query's pairs share one prefix forward
whose per-layer K/V the document suffixes attend to. Opt-in, as in JAX:
the two-stage cascade (LEAN_EXPLORE_RERANK_CASCADE="<cap>,<keep>"), the
W8A8 int8 trunk (LEAN_EXPLORE_RERANKER_INT8=1 or ``dtype="int8"``) and the
fused q/k/v and gate/up projections (LEAN_EXPLORE_FUSED_QKV=1).
"""

import asyncio
import contextlib
import logging
import os
import threading
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from lean_explore_tpu_torch.models import qwen3 as qwen3_mod
from lean_explore_tpu_torch.models.hf_loader import load_params
from lean_explore_tpu_torch.models.tokenizer import (
    bucket_batch,
    bucket_length,
    encode_batch,
    load_tokenizer,
)
from lean_explore_tpu_torch.parallel.rerank import (
    make_sharded_grouped_scorer,
    rerank_data_mesh,
    replicate_params,
)
from lean_explore_tpu_torch.util.embedding_client import resolve_model_dir
from lean_explore_tpu_torch.util.platform import resolve_device
from lean_explore_tpu_torch.util.profiling import count, span

logger = logging.getLogger(__name__)

DEFAULT_INSTRUCTION = "Find relevant Lean 4 math declarations"
DEFAULT_BATCH_SIZE = 64
# Suffix-length buckets of the grouped path: with the prefix cached, the
# suffix is all that is forwarded, and typical "name: informalization"
# suffixes are 12-20 tokens.
SUFFIX_BUCKETS = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256)
# Query groups per grouped forward step (bounds the score tensor).
GROUP_CHUNK = 16

# Same-shape buckets scored per ``rerank_scores_chained`` call; fixed, as in
# the JAX client, so the set of chain shapes stays small.
CHAIN = 8

_PARAM_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "int8": torch.int8}


def resolve_param_dtype(dtype: str | torch.dtype | None) -> torch.dtype:
    """The trunk's parameter dtype, chosen as the JAX client chooses it
    (lean_explore_tpu/util/reranker_client.py:113-119): None means bf16,
    or int8 when LEAN_EXPLORE_RERANKER_INT8=1; an explicit dtype wins.
    ``torch.int8`` stands for the W8A8 trunk (loaded in bf16, then
    quantized)."""
    if dtype is None:
        dtype = "int8" if os.getenv("LEAN_EXPLORE_RERANKER_INT8") == "1" else "bfloat16"
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _PARAM_DTYPES:
        raise ValueError(f"reranker dtype {dtype!r} (have {sorted(_PARAM_DTYPES)})")
    return _PARAM_DTYPES[dtype]


@dataclass
class RerankerResponse:
    """Response of ``rerank``: the JAX client's schema as a plain dataclass."""

    query: str
    scores: list[float]
    model: str


def format_pair(query: str, document: str, instruction: str = DEFAULT_INSTRUCTION) -> str:
    """The pair template the reranker scores."""
    return (
        f"<Instruct>: {instruction}\n<Query>: {query}\n"
        f"<Document>: {document}"
    )


class RerankerClient:
    """Scores query-document pairs with P("true") from a causal LM."""

    MIN_SHARED_PREFIX = 4  # tokens; below this the split costs more than it saves

    def __init__(
        self,
        model_name: str = "Qwen/Qwen3-Reranker-0.6B",
        *,
        model_dir: str | Path | None = None,
        max_length: int = 512,
        instruction: str = DEFAULT_INSTRUCTION,
        batch_size: int | None = None,
        dtype: str | torch.dtype | None = None,
        device: str | torch.device | None = None,
        mesh=None,
    ):
        """Load tokenizer + params onto ``device`` (default CUDA).

        Args:
            model_name: HF id (reporting) or local path.
            model_dir: Local checkpoint directory (see EmbeddingClient).
            max_length: Pair truncation length (the engine passes 256).
            instruction: Task instruction in the pair template.
            batch_size: Falls back to LEAN_EXPLORE_RERANKER_BATCH_SIZE,
                then 64.
            dtype: Parameter dtype (bf16 serving, f32 parity, "int8" for
                the W8A8 trunk); None is bf16 unless
                LEAN_EXPLORE_RERANKER_INT8=1 (``resolve_param_dtype``). Int8
                loads bf16 and quantizes the projections, so embed, norms
                and the tied head stay bf16.
            device: Where the params live; CUDA unless the CPU is asked for.
            mesh: Optional ``parallel.Mesh`` with a ``data`` axis: the
                params load onto its first device and are copied once to
                each other distinct device, and the grouped prefix-KV path
                splits its query groups over ``data``
                (``parallel.rerank``); the flat path runs on the first.
                Without one, the grouped path runs on a data mesh of
                ``device`` alone.

        LEAN_EXPLORE_FUSED_QKV=1 fuses the projections before any
        quantization (``qwen3.fuse_params_for_serving``).
        """
        dtype = resolve_param_dtype(dtype)
        int8 = dtype == torch.int8
        resolved = Path(model_dir) if model_dir else resolve_model_dir(model_name)
        if batch_size is not None and batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        env_batch = os.getenv("LEAN_EXPLORE_RERANKER_BATCH_SIZE")
        logger.info("Loading reranker model %s from %s", model_name, resolved)
        params, config = load_params(
            resolved,
            dtype=torch.bfloat16 if int8 else dtype,
            device=mesh.devices.flat[0] if mesh is not None else resolve_device(device),
        )
        if os.getenv("LEAN_EXPLORE_FUSED_QKV") == "1":
            params = qwen3_mod.fuse_params_for_serving(params)
        if int8:
            params = qwen3_mod.quantize_params_int8(params)
        self._init(
            params,
            config,
            load_tokenizer(resolved),
            model_name=model_name,
            model_dir=resolved,
            max_length=max_length,
            instruction=instruction,
            batch_size=(
                batch_size
                if batch_size is not None
                else (int(env_batch) if env_batch else DEFAULT_BATCH_SIZE)
            ),
            int8=int8,
            mesh=mesh,
        )

    @classmethod
    def from_components(
        cls,
        params,
        config,
        tokenizer,
        *,
        model_name: str = "in-memory",
        model_dir=None,
        max_length: int = 512,
        instruction: str = DEFAULT_INSTRUCTION,
        batch_size: int = 64,
        int8: bool = False,
        mesh=None,
    ) -> "RerankerClient":
        """A client around already-loaded params (on their device, the
        mesh's first device when ``mesh`` is given), config and tokenizer:
        random-weight benchmarks and tests. The params are taken as they
        are; pass ``int8=True`` when they are already quantized
        (``qwen3.quantize_params_int8``), as in JAX."""
        self = object.__new__(cls)
        self._init(
            params, config, tokenizer, model_name=model_name,
            model_dir=model_dir, max_length=max_length,
            instruction=instruction, batch_size=batch_size, int8=int8, mesh=mesh,
        )
        return self

    def _init(
        self, params, config, tokenizer, *, model_name, model_dir, max_length,
        instruction, batch_size, int8, mesh,
    ) -> None:
        """Every attribute the scoring paths touch, in one place."""
        self.model_name = model_name
        self.model_dir = model_dir
        self.max_length = max_length
        self.instruction = instruction
        self.batch_size = batch_size
        self.tokenizer = tokenizer
        self._tokenizer_lock = threading.Lock()
        self.int8 = int8
        self.params, self.config = params, config
        self.device = params["embed"].device
        # Off a mesh, a data mesh of the params' one device.
        self.mesh = mesh if mesh is not None else rerank_data_mesh(devices=[self.device])
        self._replicas = replicate_params(params, self.mesh)
        self._sharded_scorers: dict = {}
        if self.mesh.shape["data"] > 1:
            logger.info("reranker DP over %d devices", self.mesh.shape["data"])
        self.token_true_id = tokenizer.convert_tokens_to_ids("true")
        self.token_false_id = tokenizer.convert_tokens_to_ids("false")
        if self.token_true_id is None or self.token_false_id is None:
            raise ValueError(
                "Tokenizer lacks 'true'/'false' tokens required for "
                "reranker scoring."
            )

    def _sharded_scorer(self, chunk: int):
        """The mesh's grouped scorer for ``chunk`` groups a step, built once."""
        scorer = self._sharded_scorers.get(chunk)
        if scorer is None:
            scorer = make_sharded_grouped_scorer(
                self.config, self.mesh, token_true=int(self.token_true_id),
                token_false=int(self.token_false_id), group_chunk=chunk,
            )
            self._sharded_scorers[chunk] = scorer
        return scorer

    def _format_pair(self, query: str, document: str) -> str:
        return format_pair(query, document, self.instruction)

    def _tensor(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.device)

    def _truncate_docs(self, documents: list[str], cap: int) -> list[str]:
        """Each document cut to its first ``cap`` tokens of text (tokenized
        alone, capped, decoded): the cascade's prescreen on the paths
        without the prefix/suffix split."""
        with self._tokenizer_lock:
            ids = self.tokenizer(
                documents, truncation=True, max_length=cap,
                add_special_tokens=False,
            )["input_ids"]
            return [self.tokenizer.decode(row) for row in ids]

    @torch.no_grad()
    def _score_encoded(self, encoded: list) -> list[np.ndarray]:
        """Scores of many padded buckets, one [B_pad] array each.

        Buckets of one (B, T) shape go through ``rerank_scores_chained``
        CHAIN at a time, the rest through ``rerank_scores``; every call is
        issued before the one copy back to the host. Each bucket is counted
        as the grouped path counts its buckets (``rerank/pack``), with its
        pairs as suffixes and no prefix; ``rerank/device`` runs from the
        first launch to the last, as there.
        """
        groups: dict[tuple, list[int]] = {}
        for idx, batch in enumerate(encoded):
            groups.setdefault(batch.input_ids.shape, []).append(idx)
        kw = dict(token_true=int(self.token_true_id), token_false=int(self.token_false_id))
        order: list[int] = []
        outs: list[torch.Tensor] = []
        with contextlib.ExitStack() as launched:
            for (rows, length), indices in groups.items():
                with span("rerank/pack"):
                    count("docs", sum(encoded[i].n_valid for i in indices))
                    count("docs_padded", rows * len(indices))
                    count("suffix_tokens", sum(
                        int(encoded[i].attention_mask[: encoded[i].n_valid].sum())
                        for i in indices
                    ))
                    count("suffix_tokens_padded", rows * length * len(indices))
                if not outs:
                    launched.enter_context(span("rerank/device", device=self.device))
                full = len(indices) // CHAIN * CHAIN
                for base in range(0, full, CHAIN):
                    members = indices[base : base + CHAIN]
                    ids = np.stack([encoded[i].input_ids for i in members])
                    mask = np.stack([encoded[i].attention_mask for i in members])
                    outs.append(qwen3_mod.rerank_scores_chained(
                        self.params, self.config, self._tensor(ids), self._tensor(mask), **kw
                    ).reshape(-1))
                    order.extend(members)
                for idx in indices[full:]:
                    batch = encoded[idx]
                    outs.append(qwen3_mod.rerank_scores(
                        self.params, self.config, self._tensor(batch.input_ids),
                        self._tensor(batch.attention_mask), **kw,
                    ))
                    order.append(idx)
        host = torch.cat(outs).cpu().numpy()
        results: list[np.ndarray | None] = [None] * len(encoded)
        start = 0
        for idx in order:
            rows = encoded[idx].input_ids.shape[0]
            results[idx] = host[start : start + rows]
            start += rows
        return results

    def rerank_sync(
        self, query: str, documents: list[str], batch_size: int | None = None
    ) -> RerankerResponse:
        """Score documents against one query: every batch tokenized first,
        then scored through ``_score_encoded``."""
        if not documents:
            return RerankerResponse(query=query, scores=[], model=self.model_name)
        if batch_size is not None and batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        step = batch_size if batch_size is not None else self.batch_size
        with span("rerank/tokenize"):
            pairs = [self._format_pair(query, d) for d in documents]
            with self._tokenizer_lock:
                encoded = [
                    encode_batch(
                        self.tokenizer, pairs[start : start + step], max_length=self.max_length
                    )
                    for start in range(0, len(pairs), step)
                ]
        scores: list[float] = []
        for batch, bucket in zip(encoded, self._score_encoded(encoded)):
            scores.extend(float(s) for s in bucket[: batch.n_valid])
        return RerankerResponse(query=query, scores=scores, model=self.model_name)

    async def rerank(
        self, query: str, documents: list[str], batch_size: int | None = None
    ) -> RerankerResponse:
        return await asyncio.to_thread(self.rerank_sync, query, documents, batch_size)

    def rerank_pairs_sync(self, queries: list[str], documents: list[str]) -> list[float]:
        """Score pairs where each document has its own query: flat padded
        batches, in length-sorted order so each batch pads to its own
        bucket, all tokenized before any is scored."""
        if len(queries) != len(documents):
            raise ValueError("queries and documents must align")
        if not documents:
            return []
        with span("rerank/tokenize"):
            pairs = [self._format_pair(q, d) for q, d in zip(queries, documents)]
            order = sorted(range(len(pairs)), key=lambda i: len(pairs[i]))
            chunks = [
                order[start : start + self.batch_size]
                for start in range(0, len(order), self.batch_size)
            ]
            with self._tokenizer_lock:
                encoded = [
                    encode_batch(
                        self.tokenizer, [pairs[i] for i in chunk], max_length=self.max_length
                    )
                    for chunk in chunks
                ]
        scores = [0.0] * len(pairs)
        for chunk, bucket in zip(chunks, self._score_encoded(encoded)):
            for i, s in zip(chunk, bucket):
                scores[i] = float(s)
        return scores

    async def rerank_pairs(self, queries: list[str], documents: list[str]) -> list[float]:
        return await asyncio.to_thread(self.rerank_pairs_sync, queries, documents)

    def rerank_grouped_cascade_sync(
        self,
        queries: list[str],
        docs_grouped: list[list[str]],
        *,
        stage1_doc_tokens: int,
        keep: int,
    ) -> list[list[float]]:
        """Two-stage rerank: a truncated prescreen, a full-length rescore.

        Stage 1 scores the pairs of every group with more than ``keep``
        documents with the documents cut to ``stage1_doc_tokens`` suffix
        tokens; stage 2 rescores each group's top ``keep`` by stage-1 score
        (all of a smaller group) at full length. Rescored candidates carry
        their stage-2 scores; pruned ones keep their stage-1 order in a thin
        band just under the worst rescored score (``floor - 1e-4 (j + 1)``),
        since truncated and full-length scores are not on one scale. The
        order uses Python's stable sort on host floats, as JAX does. Spans:
        ``rerank/stage1``, ``rerank/select`` (the sort between the stages)
        and ``rerank/stage2``.
        """
        if keep <= 0 or stage1_doc_tokens <= 0:
            raise ValueError("keep and stage1_doc_tokens must be positive")
        need = [i for i, docs in enumerate(docs_grouped) if len(docs) > keep]
        stage1: dict[int, list[float]] = {}
        if need:
            with span("rerank/stage1"):
                scored = self.rerank_grouped_sync(
                    [queries[i] for i in need],
                    [docs_grouped[i] for i in need],
                    suffix_cap=stage1_doc_tokens,
                )
            stage1 = dict(zip(need, scored))
        slots: list[list[int]] = []
        with span("rerank/select"):
            for gi, docs in enumerate(docs_grouped):
                if gi in stage1:
                    top = sorted(
                        range(len(docs)), key=lambda i: stage1[gi][i], reverse=True
                    )[:keep]
                else:
                    top = list(range(len(docs)))
                slots.append(top)
            kept_docs = [[docs[i] for i in top] for docs, top in zip(docs_grouped, slots)]
        with span("rerank/stage2"):
            stage2 = self.rerank_grouped_sync(queries, kept_docs)
        out = [
            list(stage1[gi]) if gi in stage1 else [0.0] * len(docs)
            for gi, docs in enumerate(docs_grouped)
        ]
        for gi, (top, rescored) in enumerate(zip(slots, stage2)):
            for pos, score in zip(top, rescored):
                out[gi][pos] = score
            kept = set(top)
            pruned = [i for i in range(len(out[gi])) if i not in kept]
            if pruned and rescored:
                floor = min(rescored)
                ranked = sorted(pruned, key=lambda i: stage1[gi][i], reverse=True)
                for j, i in enumerate(ranked):
                    out[gi][i] = floor - 1e-4 * (j + 1)
        return out

    def rerank_grouped_sync(
        self,
        queries: list[str],
        docs_grouped: list[list[str]],
        *,
        suffix_cap: int | None = None,
    ) -> list[list[float]]:
        """Score each query's documents with shared-prefix KV reuse.

        The shared prefix is the longest common *token* prefix of the
        group's pairs; it runs once per query through ``prefix_kv``, and the
        document suffixes attend to its cached K/V at their true positions.
        Groups whose shared prefix is under MIN_SHARED_PREFIX tokens go
        through the flat path. LEAN_EXPLORE_RERANK_PREFIX=0 sends every
        group through the flat path.

        ``suffix_cap`` (the cascade's stage 1) cuts each document suffix to
        that many tokens after the prefix is found on the whole pairs, and
        the documents themselves (``_truncate_docs``) on the flat paths.
        """
        if len(queries) != len(docs_grouped):
            raise ValueError("queries and docs_grouped must align")
        if os.getenv("LEAN_EXPLORE_RERANK_PREFIX", "1") == "0":
            flat_q = [q for q, docs in zip(queries, docs_grouped) for _ in docs]
            flat_d = [d for docs in docs_grouped for d in docs]
            if suffix_cap is not None:
                flat_d = self._truncate_docs(flat_d, suffix_cap)
            flat = self.rerank_pairs_sync(flat_q, flat_d)
            out, start = [], 0
            for docs in docs_grouped:
                out.append(flat[start : start + len(docs)])
                start += len(docs)
            return out

        results: list[list[float]] = [[] for _ in queries]
        # group records: (out_idx, shared_prefix_tokens, suffix_token_lists)
        records: list[tuple[int, list[int], list[list[int]]]] = []
        fallback_q: list[str] = []
        fallback_d: list[str] = []
        fallback_slots: list[tuple[int, int]] = []

        with span("rerank/tokenize"):
            for gi, (query, docs) in enumerate(zip(queries, docs_grouped)):
                if not docs:
                    continue
                pairs = [self._format_pair(query, d) for d in docs]
                with self._tokenizer_lock:
                    token_lists = self.tokenizer(
                        pairs, truncation=True, max_length=self.max_length
                    )["input_ids"]
                # Longest common token prefix: one slice compare per row in the
                # common case, bisection on a mismatch.
                row0 = token_lists[0]
                shared = len(row0)
                for row in token_lists[1:]:
                    limit = min(shared, len(row))
                    if row[:limit] == row0[:limit]:
                        shared = limit
                        continue
                    lo, hi = 0, limit
                    while lo < hi:
                        mid = (lo + hi + 1) // 2
                        if row[:mid] == row0[:mid]:
                            lo = mid
                        else:
                            hi = mid - 1
                    shared = lo
                    if shared == 0:
                        break
                shared = min(shared, min(len(row) for row in token_lists) - 1)
                if shared < self.MIN_SHARED_PREFIX:
                    for pos, doc in enumerate(docs):
                        fallback_q.append(query)
                        fallback_d.append(doc)
                        fallback_slots.append((gi, pos))
                    results[gi] = [0.0] * len(docs)
                    continue
                suffixes = [row[shared:] for row in token_lists]
                if suffix_cap is not None:
                    suffixes = [sfx[:suffix_cap] for sfx in suffixes]
                records.append((gi, row0[:shared], suffixes))

        pad_id = self.tokenizer.pad_token_id
        if pad_id is None:
            pad_id = self.tokenizer.eos_token_id or 0

        # Partition groups by suffix-length bucket (a group's bucket is its
        # longest document); D pads to the partition's max document count.
        by_bucket: dict[int, list] = {}
        for rec in records:
            s_bucket = bucket_length(
                max(len(sfx) for sfx in rec[2]), self.max_length, buckets=SUFFIX_BUCKETS
            )
            by_bucket.setdefault(s_bucket, []).append(rec)

        # One ``rerank/pack`` span a bucket, counting its real and padded
        # groups, documents and tokens; ``rerank/device`` from the first
        # launch to the last (later buckets pack inside it).
        fetches = []
        with contextlib.ExitStack() as launched:
            for s_bucket, recs in sorted(by_bucket.items()):
                with span("rerank/pack"):
                    chunk = min(GROUP_CHUNK, bucket_batch(len(recs)))
                    # G splits evenly over the data devices, so it pads to a
                    # multiple of data x chunk; pad groups are discarded below.
                    g_align = chunk * self.mesh.shape["data"]
                    g_pad = -(-len(recs) // g_align) * g_align
                    d_pad = max(len(r[2]) for r in recs)
                    p_pad = bucket_length(max(len(r[1]) for r in recs), self.max_length)
                    prefix_ids = np.full((g_pad, p_pad), pad_id, dtype=np.int32)
                    prefix_mask = np.zeros((g_pad, p_pad), dtype=np.int32)
                    suffix_ids = np.full((g_pad, d_pad, s_bucket), pad_id, dtype=np.int32)
                    suffix_mask = np.zeros((g_pad, d_pad, s_bucket), dtype=np.int32)
                    pos_offset = np.zeros((g_pad,), dtype=np.int32)
                    n_docs = n_prefix = n_suffix = 0
                    for row, (_gi, head, suffixes) in enumerate(recs):
                        shared = len(head)
                        prefix_ids[row, :shared] = head
                        prefix_mask[row, :shared] = 1
                        pos_offset[row] = shared
                        n_prefix += shared
                        n_docs += len(suffixes)
                        for di, sfx in enumerate(suffixes):
                            sfx = sfx[:s_bucket]
                            suffix_ids[row, di, : len(sfx)] = sfx
                            suffix_mask[row, di, : len(sfx)] = 1
                            n_suffix += len(sfx)
                    # Pad rows/docs keep one valid token so softmax and pooling
                    # indices stay benign; their scores are discarded.
                    prefix_mask[len(recs) :, 0] = 1
                    flat_mask = suffix_mask.reshape(g_pad * d_pad, s_bucket)
                    flat_mask[~flat_mask.any(axis=1), 0] = 1
                    count("groups", len(recs))
                    count("groups_padded", g_pad)
                    count("docs", n_docs)
                    count("docs_padded", g_pad * d_pad)
                    count("prefix_tokens", n_prefix)
                    count("prefix_tokens_padded", g_pad * p_pad)
                    count("suffix_tokens", n_suffix)
                    count("suffix_tokens_padded", g_pad * d_pad * s_bucket)

                if not fetches:
                    launched.enter_context(span("rerank/device", device=self.device))
                scores = self._sharded_scorer(chunk)(
                    self._replicas, prefix_ids, prefix_mask, suffix_ids, suffix_mask,
                    pos_offset,
                )
                fetches.append((recs, scores))
        # Every bucket is issued before the first copy back.
        for recs, scores in fetches:
            host = scores.cpu().numpy()
            for row, (gi, _head, suffixes) in enumerate(recs):
                results[gi] = [float(s) for s in host[row, : len(suffixes)]]

        if fallback_q:
            if suffix_cap is not None:
                fallback_d = self._truncate_docs(fallback_d, suffix_cap)
            flat = self.rerank_pairs_sync(fallback_q, fallback_d)
            for (gi, pos), score in zip(fallback_slots, flat):
                results[gi][pos] = score
        return results

    async def rerank_grouped(
        self, queries: list[str], docs_grouped: list[list[str]]
    ) -> list[list[float]]:
        """The engine's rerank: the cascade when LEAN_EXPLORE_RERANK_CASCADE
        is "<stage1_doc_tokens>,<keep>" (read per call), else the full
        grouped rerank."""
        cascade = os.getenv("LEAN_EXPLORE_RERANK_CASCADE")
        if cascade:
            try:
                stage1_tokens, keep = (int(x) for x in cascade.split(","))
            except ValueError:
                raise ValueError(
                    "LEAN_EXPLORE_RERANK_CASCADE must be "
                    "'<stage1_doc_tokens>,<keep>', e.g. '32,8'"
                ) from None
            return await asyncio.to_thread(
                self.rerank_grouped_cascade_sync,
                queries,
                docs_grouped,
                stage1_doc_tokens=stage1_tokens,
                keep=keep,
            )
        return await asyncio.to_thread(self.rerank_grouped_sync, queries, docs_grouped)

