"""Parallelism layer: meshes, corpus-sharded retrieval, data-parallel
rerank and the training mesh's collectives (lean_explore_tpu/parallel)."""

from lean_explore_tpu_torch.parallel.mesh import (
    SERVE_AXES,
    TRAIN_AXES,
    Mesh,
    init_distributed,
    make_mesh,
    serve_mesh_from_config,
)
from lean_explore_tpu_torch.parallel.rerank import (
    make_sharded_grouped_scorer,
    rerank_data_mesh,
    replicate_params,
)
from lean_explore_tpu_torch.parallel.sharded import ShardedDenseIndex, make_sharded_topk

__all__ = [
    "SERVE_AXES",
    "TRAIN_AXES",
    "Mesh",
    "ShardedDenseIndex",
    "init_distributed",
    "make_mesh",
    "make_sharded_grouped_scorer",
    "rerank_data_mesh",
    "replicate_params",
    "serve_mesh_from_config",
    "make_sharded_topk",
]
