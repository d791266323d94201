"""Retrieval and attention ops: dense top-k, the int8 corpus, the trunk's
flash attention and the hand-written kernels.

Float32 products in these ops never run in TF32: exact f32 scores for a
float32 corpus, and exact int8 products through f32 matmuls (ops/quant.py).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
