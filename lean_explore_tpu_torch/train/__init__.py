"""Training subsystem: contrastive fine-tuning of the embedder and
cross-encoder fine-tuning of the reranker, on one device or a (data, model)
mesh of processes (the JAX package's ``lean_explore_tpu.train``)."""

from lean_explore_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from lean_explore_tpu_torch.train.contrastive import (
    ContrastiveBatch,
    commit_to_mesh,
    infonce_loss,
    init_train_state,
    make_optimizer,
    make_train_step,
    param_partition_specs,
    shard_params,
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
    "commit_to_mesh",
    "cross_encoder_loss",
    "infonce_loss",
    "init_train_state",
    "latest_checkpoint",
    "make_ce_train_step",
    "make_optimizer",
    "make_train_step",
    "pairs_from_store",
    "param_partition_specs",
    "restore_checkpoint",
    "save_checkpoint",
    "shard_params",
]
