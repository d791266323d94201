"""Retrieval and attention ops: dense top-k, the int8 corpus, the trunk's
flash attention and the hand-written kernels.

Float32 products in these ops never run in TF32: exact f32 scores for a
float32 corpus, and exact int8 products through f32 matmuls (ops/quant.py).
The names of the JAX package's ``ops.__all__`` load on first use.
"""

from importlib import import_module
from typing import TYPE_CHECKING

import torch

torch.backends.cuda.matmul.allow_tf32 = False

_LAZY = {
    "dense_topk": "lean_explore_tpu_torch.ops.dense",
    "l2_normalize": "lean_explore_tpu_torch.ops.dense",
    "pad_rows": "lean_explore_tpu_torch.ops.dense",
    "quantize_rows": "lean_explore_tpu_torch.ops.quant",
    "quantized_topk": "lean_explore_tpu_torch.ops.quant",
}

if TYPE_CHECKING:  # pragma: no cover
    from lean_explore_tpu_torch.ops.dense import dense_topk, l2_normalize, pad_rows
    from lean_explore_tpu_torch.ops.quant import quantize_rows, quantized_topk


def __getattr__(name: str):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(import_module(module), name)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
