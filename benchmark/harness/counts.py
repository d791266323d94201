"""What the traffic needs of the card, counted from the inputs: model
FLOPs of a batch and K1's bytes.

FLOPs are counted on real (unpadded) tokens, by the reference tokenizer, so
the count is the same whatever implements the work: per token and layer the
q/k/v/o projections and the SwiGLU MLP (2 x their weights), and causal
attention to every earlier position of the sequence (QK and PV, 2 x head
width x heads each). The reranker's group shares its prefix: the prefix
runs once a group, each suffix attends to it; its head reads two columns.
The dense scan is 2 x B x N x D.

``k1_bytes`` is a frozen copy of ``chip_smoke.py``'s byte arithmetic of
K1 (``check_bin_topk``, commit 4369825): each corpus, query and carry byte
once; the peaks are the same file's NVIDIA data-sheet figures.
"""

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core peak, same source


def linear_flops_per_token(m: dict) -> float:
    h, dh, i = m["hidden_size"], m["head_dim"], m["intermediate_size"]
    nq, nkv = m["num_attention_heads"], m["num_key_value_heads"]
    per_layer = 2 * h * (nq * dh + 2 * nkv * dh) + 2 * nq * dh * h + 2 * 3 * h * i
    return per_layer * m["num_hidden_layers"]


def attention_flops(m: dict, new: int, before: int) -> float:
    """``new`` tokens after ``before`` cached ones, causal."""
    width = m["num_attention_heads"] * m["head_dim"] * m["num_hidden_layers"]
    keys = new * before + new * (new + 1) / 2
    return 4 * width * keys


def sequence_flops(m: dict, tokens: int) -> float:
    return linear_flops_per_token(m) * tokens + attention_flops(m, tokens, 0)


def suffix_flops(m: dict, prefix: int, suffix: int) -> float:
    return linear_flops_per_token(m) * suffix + attention_flops(m, suffix, prefix) + 2 * 2 * m["hidden_size"]


def k1_bytes(n_rows: int, dim: int, batch: int, bins: int, size: int = 2) -> float:
    return n_rows * dim * size + batch * dim * size + bins * batch * 4


def k1_bound_s(n_rows: int, dim: int, batch: int, bins: int) -> float:
    t_bytes = k1_bytes(n_rows, dim, batch, bins) / HBM_BYTES_PER_S
    t_ops = 2.0 * n_rows * batch * dim / BF16_FLOP_PER_S
    return max(t_bytes, t_ops)
