"""Cross-encoder (reranker) fine-tuning: the true/false readout objective,
the counterpart of lean_explore_tpu/train/cross_encoder.py.

Binary softmax cross-entropy over the (false, true) logits at the last
valid position of ``format_pair`` texts, on labeled (query, document,
match?) triples: exactly the two vocabulary columns ``RerankerClient``
reads as P(true).

On a (data, model) mesh of processes the step is the contrastive step's
(``train.contrastive``), with one difference: the loss is a mean over each
rank's rows, so the gradients are averaged over the data group (the mean
of the ranks' means is the global batch's mean, GSPMD's). An untied
lm_head is split by columns, so the two pair columns are gathered from
whichever model rank holds them before the pair logits.
"""

from collections.abc import Iterator
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from lean_explore_tpu_torch.models import qwen3
from lean_explore_tpu_torch.models.qwen3 import Qwen3Config
from lean_explore_tpu_torch.parallel.collectives import all_reduce_, tensor_parallel
from lean_explore_tpu_torch.train.contrastive import (
    apply_schedule,
    local_rows,
    reduce_gradients,
)
from lean_explore_tpu_torch.train.data import encode_fixed

# The serving client's definition: training sees byte-identical pairs.
from lean_explore_tpu_torch.util.reranker_client import (  # noqa: E402
    DEFAULT_INSTRUCTION,
    format_pair,
)


class CrossEncoderBatch(NamedTuple):
    """One training batch of formatted pairs with 0/1 match labels."""

    input_ids: torch.Tensor  # [B, T] int32
    attention_mask: torch.Tensor  # [B, T] int32
    labels: torch.Tensor  # [B] int64; 1 = match ("true"), 0 = non-match

    def to(self, device) -> "CrossEncoderBatch":
        return CrossEncoderBatch(*(x.to(device) for x in self))


def _pair_logits(params, pooled, token_false: int, token_true: int, tp):
    """``qwen3._pair_logits``; with a column-split lm_head, the two columns
    are taken from the rank that holds each (zeros elsewhere) and summed
    over the model group: an all-reduce forward whose identity backward
    hands each column's gradient to its owner."""
    head = params.get("lm_head")
    if head is None or tp is None:
        return qwen3._pair_logits(params, pooled, token_false, token_true)
    width = head.shape[1]
    sliver = [
        head[:, col - tp.index * width] if col // width == tp.index
        else head.new_zeros(head.shape[0])
        for col in (token_false, token_true)
    ]
    sliver = tp.reduce(torch.stack(sliver, dim=1))
    return pooled.to(torch.float32) @ sliver.to(torch.float32)


def cross_encoder_loss(
    params: dict,
    config: Qwen3Config,
    batch: CrossEncoderBatch,
    *,
    token_true: int,
    token_false: int,
    mesh=None,
) -> tuple[torch.Tensor, dict]:
    """Binary CE over the (false, true) logits at the last valid token;
    label 1 is the "true" column, the one the client's softmax reads. On a
    mesh, ``batch`` holds this rank's rows and the loss is their mean."""
    tp = tensor_parallel(mesh)
    hidden = qwen3.forward_hidden(
        params, config, batch.input_ids, batch.attention_mask, tp=tp
    )
    pooled = qwen3._pool_last(hidden, batch.attention_mask)
    pair = _pair_logits(params, pooled, token_false, token_true, tp)  # [B, 2]
    labels = batch.labels.long()
    loss = F.cross_entropy(pair, labels)
    accuracy = (pair.argmax(dim=1) == labels).float().mean()
    return loss, {"loss": loss.detach(), "accuracy": accuracy}


def make_ce_train_step(
    config: Qwen3Config, *, token_true: int, token_false: int, mesh=None
):
    """Train step (params, opt_state, batch) -> (params, opt_state, metrics)
    with the scheduled rate and the updates in place, as
    ``contrastive.make_train_step``; on a ``mesh`` the gradients are
    averaged over the data group, and the metrics are the global batch's
    (the ranks' means averaged)."""

    def step(params, opt_state, batch: CrossEncoderBatch):
        apply_schedule(opt_state)
        opt_state.zero_grad(set_to_none=True)
        loss, metrics = cross_encoder_loss(
            params, config, local_rows(batch, mesh),
            token_true=token_true, token_false=token_false, mesh=mesh,
        )
        loss.backward()
        reduce_gradients(params, mesh, mean=True)
        opt_state.step()
        data = 1 if mesh is None else mesh.shape.get("data", 1)
        if data > 1:
            both = all_reduce_(
                torch.stack([metrics["loss"], metrics["accuracy"]]), mesh.groups["data"]
            ) / data
            metrics = {"loss": both[0], "accuracy": both[1]}
        return params, opt_state, metrics

    return step


class CrossEncoderDataLoader:
    """Shuffled, tokenized, fixed-shape batches of labeled pair examples,
    formatted with the serving pair template and padded to
    [batch, max_length] (on the CPU), in the JAX loader's order."""

    def __init__(
        self,
        tokenizer,
        examples: list[tuple[str, str, int]],
        *,
        batch_size: int = 64,
        max_length: int = 96,
        instruction: str = DEFAULT_INSTRUCTION,
        seed: int = 0,
        truncation_augment: float = 0.0,
        truncation_caps: tuple[int, int] = (24, 96),
    ):
        if not examples:
            raise ValueError("no training examples")
        if len(examples) < batch_size:
            raise ValueError(
                f"{len(examples)} examples < batch_size {batch_size}: every "
                "epoch would yield zero full batches (partial batches are "
                "dropped for fixed shapes)"
            )
        self.tokenizer = tokenizer
        self.examples = examples
        self.batch_size = batch_size
        self.max_length = max_length
        self.instruction = instruction
        self.truncation_augment = truncation_augment
        self.truncation_caps = truncation_caps
        self._rng = np.random.default_rng(seed)

    def _truncate_doc(self, doc: str, cap: int) -> str:
        """Tokenize, cap, decode: the serving cascade's prescreen
        truncation (measured negative as training augmentation, off by
        default)."""
        ids = self.tokenizer(
            doc, truncation=True, max_length=cap, add_special_tokens=False
        )["input_ids"]
        return self.tokenizer.decode(ids)

    def epoch(self) -> Iterator[CrossEncoderBatch]:
        order = self._rng.permutation(len(self.examples))
        for start in range(0, len(order) - self.batch_size + 1, self.batch_size):
            chunk = [self.examples[i] for i in order[start : start + self.batch_size]]
            if self.truncation_augment > 0.0:
                lo, hi = self.truncation_caps
                chunk = [
                    (
                        q,
                        self._truncate_doc(d, int(self._rng.integers(lo, hi + 1)))
                        if self._rng.random() < self.truncation_augment
                        else d,
                        y,
                    )
                    for q, d, y in chunk
                ]
            ids, mask = encode_fixed(
                self.tokenizer,
                [format_pair(q, d, self.instruction) for q, d, _ in chunk],
                self.max_length,
                append_eos=False,
            )
            labels = torch.tensor([y for _, _, y in chunk], dtype=torch.int64)
            yield CrossEncoderBatch(ids, mask, labels)

    def __iter__(self) -> Iterator[CrossEncoderBatch]:
        while True:
            yield from self.epoch()
