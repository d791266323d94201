"""Training subsystem on one device: contrastive fine-tuning of the
embedder and cross-encoder fine-tuning of the reranker (the JAX package's
``lean_explore_tpu.train`` without its mesh functions)."""

from lean_explore_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from lean_explore_tpu_torch.train.contrastive import (
    ContrastiveBatch,
    infonce_loss,
    init_train_state,
    make_optimizer,
    make_train_step,
)
from lean_explore_tpu_torch.train.cross_encoder import (
    CrossEncoderBatch,
    CrossEncoderDataLoader,
    cross_encoder_loss,
    make_ce_train_step,
)
from lean_explore_tpu_torch.train.data import ContrastiveDataLoader, pairs_from_store

__all__ = [
    "ContrastiveBatch",
    "ContrastiveDataLoader",
    "CrossEncoderBatch",
    "CrossEncoderDataLoader",
    "cross_encoder_loss",
    "infonce_loss",
    "init_train_state",
    "latest_checkpoint",
    "make_ce_train_step",
    "make_optimizer",
    "make_train_step",
    "pairs_from_store",
    "restore_checkpoint",
    "save_checkpoint",
]
