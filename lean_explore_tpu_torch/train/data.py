"""Training data: contrastive (query, document) pairs from a declaration
store, the counterpart of lean_explore_tpu/train/data.py.

Queries are what users type (declaration names and the informal titles);
documents are the informalizations the serving index embeds. Given the same
seed, pairs and tokenizer file, the loader yields the same ids, masks and
duplicate masks as the JAX loader, batch for batch: the same numpy
``default_rng`` permutation, fixed-shape padding and appended EOS.
"""

import logging
from collections.abc import Iterator

import numpy as np
import torch

from lean_explore_tpu_torch.models.search_types import extract_bold_description
from lean_explore_tpu_torch.models.tokenizer import encode_batch
from lean_explore_tpu_torch.train.contrastive import ContrastiveBatch

logger = logging.getLogger(__name__)


def pairs_from_store(store) -> list[tuple[str, str]]:
    """(query, positive document) pairs for every informalized declaration:
    the name, and the ``**Title.**`` header when there is one."""
    pairs: list[tuple[str, str]] = []
    for decl in store.iter_all(with_embeddings=False):
        if not decl.informalization:
            continue
        document = decl.informalization
        pairs.append((decl.name, document))
        title = extract_bold_description(decl.informalization)
        if title:
            pairs.append((title, document))
    logger.info("built %d contrastive pairs", len(pairs))
    return pairs


def encode_fixed(tokenizer, texts: list[str], max_length: int, *, append_eos: bool):
    """Tokenize to a fixed [len(texts), max_length] shape (right padding
    with the pad id, or 0): (ids, mask) int32 tensors on the CPU."""
    batch = encode_batch(
        tokenizer, texts, max_length=max_length, pad_to_buckets=False,
        append_eos=append_eos,
    )
    ids, mask = batch.input_ids, batch.attention_mask
    pad = max_length - ids.shape[1]
    if pad > 0:
        pad_id = tokenizer.pad_token_id or 0
        ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=pad_id)
        mask = np.pad(mask, ((0, 0), (0, pad)))
    return torch.from_numpy(ids), torch.from_numpy(mask)


class ContrastiveDataLoader:
    """Shuffled, tokenized, fixed-shape batches of contrastive pairs (on the
    CPU; the trainer moves each batch to its device)."""

    def __init__(
        self,
        tokenizer,
        pairs: list[tuple[str, str]],
        *,
        batch_size: int = 32,
        query_max_length: int = 64,
        doc_max_length: int = 256,
        seed: int = 0,
        append_eos: bool = True,
    ):
        if not pairs:
            raise ValueError("no training pairs")
        if len(pairs) < batch_size:
            raise ValueError(
                f"{len(pairs)} pairs < batch_size {batch_size}: every epoch "
                "would yield zero full batches (partial batches are dropped "
                "for fixed shapes)"
            )
        self.tokenizer = tokenizer
        self.pairs = pairs
        self.batch_size = batch_size
        self.query_max_length = query_max_length
        self.doc_max_length = doc_max_length
        # Serving parity: the embedding client appends EOS and pools it.
        self.append_eos = append_eos
        self._rng = np.random.default_rng(seed)

    def epoch(self) -> Iterator[ContrastiveBatch]:
        """One shuffled pass; the trailing partial batch is dropped."""
        order = self._rng.permutation(len(self.pairs))
        for start in range(0, len(order) - self.batch_size + 1, self.batch_size):
            chunk = [self.pairs[i] for i in order[start : start + self.batch_size]]
            q_ids, q_mask = encode_fixed(
                self.tokenizer, [q for q, _ in chunk], self.query_max_length,
                append_eos=self.append_eos,
            )
            d_ids, d_mask = encode_fixed(
                self.tokenizer, [d for _, d in chunk], self.doc_max_length,
                append_eos=self.append_eos,
            )
            docs = np.array([d for _, d in chunk], dtype=object)
            dup = (docs[:, None] == docs[None, :]) & ~np.eye(len(chunk), dtype=bool)
            yield ContrastiveBatch(q_ids, q_mask, d_ids, d_mask, torch.from_numpy(dup))

    def __iter__(self) -> Iterator[ContrastiveBatch]:
        while True:
            yield from self.epoch()
