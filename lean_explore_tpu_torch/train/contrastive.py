"""Contrastive (InfoNCE) fine-tuning of the Qwen3 embedder on one device,
the counterpart of lean_explore_tpu/train/contrastive.py.

In-batch negatives: query i's positive is document i, every other document
in the batch is a negative, except documents with the same text as i's
(``doc_dup_mask``). The mesh (data and model axes, ``param_partition_specs``,
``shard_params``, ``commit_to_mesh``) is not ported: one device only.

Parameters are the trunk's dict of tensors (``models.qwen3``), each leaf a
leaf tensor with ``requires_grad``. The PyTorch idiom replaces JAX's pure
update: the optimizer state is a ``torch.optim.AdamW`` bound to those
tensors, and a train step updates both in place and returns them.
"""

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from lean_explore_tpu_torch.models import qwen3
from lean_explore_tpu_torch.models.qwen3 import Qwen3Config
from lean_explore_tpu_torch.util.platform import resolve_device


class ContrastiveBatch(NamedTuple):
    """One training batch of (query, positive-document) pairs."""

    query_ids: torch.Tensor  # [B, Tq] int32
    query_mask: torch.Tensor  # [B, Tq] int32
    doc_ids: torch.Tensor  # [B, Td] int32
    doc_mask: torch.Tensor  # [B, Td] int32
    # True at [i, j] (i != j) when doc_j is the same text as doc_i: several
    # queries per document (name and title) can put duplicate positives in
    # one batch, which InfoNCE must not count as negatives.
    doc_dup_mask: torch.Tensor  # [B, B] bool

    def to(self, device) -> "ContrastiveBatch":
        return ContrastiveBatch(*(x.to(device) for x in self))


def param_leaves(params: dict) -> list[torch.Tensor]:
    """The parameter tensors in a fixed order: embed, the layer stacks by
    name, final_norm, lm_head when untied. The optimizer, the checkpoint
    and the JAX state converter all use this order."""
    leaves = [params["embed"]]
    leaves += [params["layers"][name] for name in sorted(params["layers"])]
    leaves.append(params["final_norm"])
    if params.get("lm_head") is not None:
        leaves.append(params["lm_head"])
    return leaves


def infonce_loss(
    params: dict,
    config: Qwen3Config,
    batch: ContrastiveBatch,
    temperature: float = 0.05,
) -> tuple[torch.Tensor, dict]:
    """Symmetric InfoNCE with in-batch negatives, duplicate-positive
    columns at -1e9: (loss, {"loss", "accuracy"}), as the JAX function."""
    q = qwen3.embed_pool(params, config, batch.query_ids, batch.query_mask)
    d = qwen3.embed_pool(params, config, batch.doc_ids, batch.doc_mask)
    logits = (q @ d.T) / temperature  # [B, B] f32
    logits = logits.masked_fill(batch.doc_dup_mask.to(torch.bool), -1e9)
    labels = torch.arange(logits.shape[0], device=logits.device)
    loss = 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))
    accuracy = (logits.argmax(dim=1) == labels).float().mean()
    return loss, {"loss": loss.detach(), "accuracy": accuracy}


@dataclass(frozen=True)
class AdamW:
    """``make_optimizer``'s result: builds a ``torch.optim.AdamW`` over a
    params dict. optax.adamw and torch's AdamW take the same step: moments
    mu = b1 mu + (1 - b1) g and nu = b2 nu + (1 - b2) g^2, bias-corrected
    by 1 - b^count, and p -= lr (mu_hat / (sqrt(nu_hat) + eps) + wd p) with
    the decay on every leaf and on the pre-update p (torch scales p by
    1 - lr wd first, the same value)."""

    learning_rate: float = 1e-5
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def __call__(self, params: dict) -> torch.optim.AdamW:
        return torch.optim.AdamW(
            param_leaves(params),
            lr=self.learning_rate,
            betas=(self.b1, self.b2),
            eps=self.eps,
            weight_decay=self.weight_decay,
        )


def make_optimizer(learning_rate: float = 1e-5, weight_decay: float = 0.01) -> AdamW:
    """AdamW with optax's defaults (betas 0.9/0.999, eps 1e-8, decay on
    every leaf), as the JAX package's ``optax.adamw(lr, weight_decay=wd)``."""
    return AdamW(learning_rate, weight_decay)


def make_train_step(config: Qwen3Config, temperature: float = 0.05):
    """Train step (params, opt_state, batch) -> (params, opt_state, metrics).

    ``opt_state`` is the ``torch.optim.AdamW`` that ``make_optimizer``'s
    result built over ``params`` and holds the hyperparameters (the JAX
    step takes the optax transformation for them instead). The step takes
    the loss's gradient by autograd and lets the optimizer update the params
    and its moments in place, so it returns the objects it was given;
    metrics are detached scalars.
    """

    def step(params, opt_state, batch: ContrastiveBatch):
        opt_state.zero_grad(set_to_none=True)
        loss, metrics = infonce_loss(params, config, batch, temperature)
        loss.backward()
        opt_state.step()
        return params, opt_state, metrics

    return step


def trainable(params: dict) -> dict:
    """The params with every leaf a leaf tensor that requires grad."""
    for leaf in param_leaves(params):
        leaf.requires_grad_(True)
    return params


def init_train_state(
    config: Qwen3Config,
    optimizer: AdamW,
    *,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
):
    """Random-init params (``qwen3.init_params`` from a ``torch.Generator``
    seeded with ``seed`` on ``device``, CUDA unless the caller asks for the
    CPU) and the matching optimizer state."""
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    params = trainable(qwen3.init_params(config, generator, dtype=dtype, device=device))
    return params, optimizer(params)


def opt_state_from_optax(
    optimizer: AdamW, params: dict, mu: dict, nu: dict, count: int
) -> torch.optim.AdamW:
    """An optimizer state over ``params`` carrying a JAX ``optax.adamw``
    state mid-run: its first and second moments ``mu`` and ``nu`` (params
    trees of numpy arrays, the layout of ``hf_loader.params_from_jax``'s
    input) and its step ``count``."""
    opt_state = optimizer(params)
    for leaf, m, v in zip(param_leaves(params), param_leaves(mu), param_leaves(nu)):
        def tensor(x):
            return torch.tensor(np.array(x), dtype=leaf.dtype, device=leaf.device)

        opt_state.state[leaf] = {
            "step": torch.tensor(float(count)),
            "exp_avg": tensor(m),
            "exp_avg_sq": tensor(v),
        }
    return opt_state
