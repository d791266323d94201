"""Random bf16 weights of one Qwen3 trunk, made on the device from a seed.

One normal draw per model, in the type the models serve in, then cut into
the leaves (projections scaled by 0.02, norm weights one): the layout the
program's clients take and the reference reads.
"""

import torch


def leaf_shapes(cfg: dict) -> dict[str, tuple]:
    h, dh, i, n = cfg["hidden_size"], cfg["head_dim"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    nq, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    return {
        "embed": (cfg["vocab_size"], h),
        "q_proj": (n, h, nq * dh),
        "k_proj": (n, h, nkv * dh),
        "v_proj": (n, h, nkv * dh),
        "o_proj": (n, nq * dh, h),
        "gate_proj": (n, h, i),
        "up_proj": (n, h, i),
        "down_proj": (n, i, h),
    }


def make_params(cfg: dict, seed: int, device) -> dict:
    shapes = leaf_shapes(cfg)
    sizes = [int(torch.Size(s).numel()) for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.bfloat16)
    flat.mul_(0.02)
    leaves = dict(zip(shapes, (part.view(s) for part, s in zip(flat.split(sizes), shapes.values()))))
    n, h, dh = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["head_dim"]

    def ones(*shape):
        return torch.ones(shape, dtype=torch.bfloat16, device=device)

    layers = {k: v for k, v in leaves.items() if k != "embed"}
    layers.update(input_norm=ones(n, h), post_norm=ones(n, h), q_norm=ones(n, dh), k_norm=ones(n, dh))
    return {"embed": leaves["embed"], "layers": layers, "final_norm": ones(h), "lm_head": None}


def model_seed(seed: int, model: str) -> int:
    """The generator seed of one model's weights (or the corpus rows)."""
    salt = {"embedder": 1, "reranker": 2, "corpus": 3}[model]
    return (seed * 4 + salt) % (1 << 63)
