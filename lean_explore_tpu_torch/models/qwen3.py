"""Qwen3 decoder trunk in PyTorch: the compute core of the embedder and the
reranker, the counterpart of lean_explore_tpu/models/qwen3.py.

The parameter layout is the JAX package's, so weights carry across as they
are (``hf_loader.params_from_jax``):

    embed       [V, H]
    layers      {input_norm [L, H], q_proj [L, H, NQ*DH], k_proj/v_proj
                 [L, H, NKV*DH], o_proj [L, NQ*DH, H], q_norm/k_norm
                 [L, DH], post_norm [L, H], gate_proj/up_proj [L, H, I],
                 down_proj [L, I, H]}   (stacked over layers, [in, out])
    final_norm  [H]
    lm_head     [H, V] or None (tied: embed.T)

Two serving layouts derive from it, as in JAX: ``fuse_params_for_serving``
(q/k/v as ``qkv_proj``, gate/up as ``gate_up_proj``) and
``quantize_params_int8`` (each projection an int8 quant dict, multiplied
by ``torch._int_mm``); every forward projects through ``_proj``, so both
serve the full forward, ``prefix_kv`` and the grouped suffix forward.

Numerics follow the JAX trunk: matmuls run in the param dtype (bf16 for
serving) with f32 accumulation; RMSNorm, attention scores, softmax and the
logits run in f32. Positions are ``arange(T)`` whatever the padding. The
attention mask is an additive -1e9 bias, never a boolean mask: a fully
masked pad row would give NaN softmax rows that leak into valid rows.
Attention is plain torch ops (the JAX trunk's default is XLA einsums), or,
opt-in through LEAN_EXPLORE_FLASH_ATTENTION as in the JAX trunk, the flash
attention of ``ops.flash_attention``: the hand-written Hopper kernels on the
card, the port of the Pallas TPU kernel the JAX trunk calls there, with its
backward kernels when a gradient is taken. Only the two scored vocabulary
columns of the head are computed for reranking.

``forward_hidden``, ``embed_pool``, ``last_token_logits``, ``rerank_scores``
and ``_pair_logits`` are differentiable, as the JAX functions are, for the
trainers of ``lean_explore_tpu_torch.train``; serving builds no graph
because its params need no gradient and the clients call the trunk under
``torch.no_grad``. The prefix-KV reranker stays no-grad: it serves only.
"""

import json
import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from lean_explore_tpu_torch.models import threefry
from lean_explore_tpu_torch.ops import flash_attention as flash_ops
from lean_explore_tpu_torch.util.platform import resolve_device


@dataclass(frozen=True)
class Qwen3Config:
    """Shape/hyperparameter config (subset of HF config.json)."""

    vocab_size: int
    hidden_size: int
    num_hidden_layers: int
    num_attention_heads: int
    num_key_value_heads: int
    head_dim: int
    intermediate_size: int
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    tie_word_embeddings: bool = True

    @classmethod
    def from_hf(cls, cfg: dict) -> "Qwen3Config":
        return cls(
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            num_hidden_layers=cfg["num_hidden_layers"],
            num_attention_heads=cfg["num_attention_heads"],
            num_key_value_heads=cfg["num_key_value_heads"],
            head_dim=cfg.get(
                "head_dim", cfg["hidden_size"] // cfg["num_attention_heads"]
            ),
            intermediate_size=cfg["intermediate_size"],
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
            rope_theta=cfg.get("rope_theta", 1_000_000.0),
            tie_word_embeddings=cfg.get("tie_word_embeddings", True),
        )

    @classmethod
    def tiny(cls, vocab_size: int = 512) -> "Qwen3Config":
        """Small config for tests and smoke runs (the JAX package's)."""
        return cls(
            vocab_size=vocab_size,
            hidden_size=64,
            num_hidden_layers=2,
            num_attention_heads=4,
            num_key_value_heads=2,
            head_dim=16,
            intermediate_size=128,
        )

    @classmethod
    def from_dir(cls, path: str | Path) -> "Qwen3Config":
        config_path = Path(path) / "config.json"
        if not config_path.exists():
            raise FileNotFoundError(
                f"No HF model config at {config_path}. Pass a local directory "
                "containing config.json + *.safetensors."
            )
        with open(config_path) as f:
            return cls.from_hf(json.load(f))


def init_params(
    config: Qwen3Config,
    generator: torch.Generator,
    *,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
) -> dict:
    """Random-normal params (scale 0.02, unit norms) drawn on ``device``
    from ``generator``, which must live on the same device. With no
    ``device`` the generator's device is taken; a CUDA device raises when
    CUDA is missing."""
    device = resolve_device(generator.device if device is None else device)

    def draw(shape):
        # Drawn in f32, then rounded: bf16 normal draws are not supported
        # on every device.
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)

    return _random_params(config, draw, dtype, device)


def init_params_threefry(
    config: Qwen3Config,
    seed: int,
    *,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
) -> dict:
    """The JAX package's init, ``init_params(config, PRNGKey(seed))``,
    drawn on the host by ``threefry`` (its keys and bits exactly, its
    normals to a few units in the last place) and moved to ``device``,
    CUDA unless the caller asks for the CPU."""
    device = resolve_device(device)
    keys = iter(threefry.split(threefry.key(seed), 16))

    def draw(shape):
        return torch.from_numpy(threefry.normal(next(keys), shape)).to(device)

    return _random_params(config, draw, dtype, device)


def _random_params(config: Qwen3Config, draw, dtype: torch.dtype, device) -> dict:
    """The params' layout, each projection ``0.02 * draw(shape)`` in the
    JAX package's order of draws and each norm weight one."""
    h, dh = config.hidden_size, config.head_dim
    nq, nkv = config.num_attention_heads, config.num_key_value_heads
    inter, layers = config.intermediate_size, config.num_hidden_layers

    def w(*shape):
        return (draw(shape) * 0.02).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    return {
        "embed": w(config.vocab_size, h),
        "layers": {
            "input_norm": ones(layers, h),
            "q_proj": w(layers, h, nq * dh),
            "k_proj": w(layers, h, nkv * dh),
            "v_proj": w(layers, h, nkv * dh),
            "o_proj": w(layers, nq * dh, h),
            "q_norm": ones(layers, dh),
            "k_norm": ones(layers, dh),
            "post_norm": ones(layers, h),
            "gate_proj": w(layers, h, inter),
            "up_proj": w(layers, h, inter),
            "down_proj": w(layers, inter, h),
        },
        "final_norm": ones(h),
        "lm_head": None if config.tie_word_embeddings else w(h, config.vocab_size),
    }


def _rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    scale = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * weight


def _rope_tables(
    config: Qwen3Config, seq_len: int, device
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [T, DH] (rotate-half convention, f32)."""
    dh = config.head_dim
    inv_freq = 1.0 / (
        config.rope_theta ** (np.arange(0, dh, 2, dtype=np.float64) / dh)
    )
    angles = np.arange(seq_len, dtype=np.float64)[:, None] * inv_freq[None, :]
    emb = np.concatenate([angles, angles], axis=-1)
    return (
        torch.as_tensor(np.cos(emb), dtype=torch.float32, device=device),
        torch.as_tensor(np.sin(emb), dtype=torch.float32, device=device),
    )


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _additive_bias(allowed: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=torch.float32, device=allowed.device)
    return torch.where(allowed, zero, torch.full_like(zero, -1e9))


def _attention(q, k, v, bias):
    """GQA attention. q: [B,T,NQ,DH], k/v: [B,T,NKV,DH], bias: [B,1,T,T]."""
    b, t, nq, dh = q.shape
    nkv = k.shape[2]
    qg = q.reshape(b, t, nkv, nq // nkv, dh)
    scores = torch.einsum(
        "btkgd,bskd->bkgts", qg.to(torch.float32), k.to(torch.float32)
    ) * (dh**-0.5)
    scores = scores + bias[:, :, None, :, :]
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v)
    return out.reshape(b, t, nq * dh)


def _attention_flash(q, k, v, attention_mask):
    """Flash attention (lean_explore_tpu/models/qwen3.py:201-236): the
    [B, T, T] probabilities never exist. Padding is expressed as segment
    ids (the 0/1 mask: pad tokens in segment 0, valid ones in segment 1),
    so a valid query sees only valid keys; pad rows' outputs are discarded
    by the mask-aware pooling, so their gradients are zero. GQA takes kv
    head h / (NQ / NKV) inside the kernels, the JAX path's ``jnp.repeat``
    without the copy. When a gradient is taken, ``FlashAttention`` keeps
    the row log-sum-exp for its backward kernels; otherwise (serving) the
    forward runs alone, without it."""
    dh = q.shape[-1]
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return flash_ops.FlashAttention.apply(q, k, v, attention_mask, dh**-0.5)
    return flash_ops.attention_flash(q, k, v, attention_mask, dh**-0.5)


FLASH_MIN_SEQ = 256


def _use_flash(seq_len: int, device) -> bool:
    """Opt-in via LEAN_EXPLORE_FLASH_ATTENTION (any non-empty value, as in
    the JAX trunk): seq >= 256 and a multiple of 128, on a CUDA device (in
    the place of the JAX trunk's TPU backend). Off by default; no speed is
    claimed for it."""
    if not os.environ.get("LEAN_EXPLORE_FLASH_ATTENTION"):
        return False
    if seq_len < FLASH_MIN_SEQ or seq_len % 128 != 0:
        return False
    return torch.device(device).type == "cuda"


# W8A8 dynamic int8 projections (lean_explore_tpu/models/qwen3.py:720-797):
# per-output-channel weight scales, per-row activation scales, an int8 x
# int8 -> int32 product, and everything else (embed, norms, RoPE,
# attention, the head) in the activation's dtype or f32. Opt-in through
# RerankerClient(dtype="int8") / LEAN_EXPLORE_RERANKER_INT8=1; serving only.
_INT8_PROJS = (
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
    "down_proj", "qkv_proj", "gate_up_proj",  # fused serving layout
)
# What torch._int_mm takes on CUDA: more than 16 rows, and inner and outer
# sizes that are positive multiples of 8.
INT_MM_MIN_ROWS = 17
INT_MM_MULTIPLE = 8


def _max_abs_scale(x: torch.Tensor, dim: int) -> torch.Tensor:
    """max |x| over ``dim`` / 127, floored at 1e-12, in f32. The divisor is
    a tensor on x's device: CUDA divides by a Python scalar as a product
    with its rounded reciprocal, which is not JAX's quotient."""
    amax = x.abs().amax(dim=dim, keepdim=True)
    return (amax / torch.full((), 127.0, device=x.device)).clamp_min(1e-12)


def quantize_params_int8(params: dict) -> dict:
    """Per-output-channel int8 quantization of the linear projections.

    Each projection leaf becomes ``{"w8": int8 [L, in, out], "scale": f32
    [L, 1, out]}`` with JAX's values; the other leaves are unchanged. Each
    layer's ``w8`` is stored column-major (out-major in memory), the layout
    in which cuBLAS takes ``torch._int_mm``'s second operand.
    """

    def quant(w):
        wf = w.to(torch.float32)
        scale = _max_abs_scale(wf, -2)
        w8 = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
        return {"w8": w8.transpose(-1, -2).contiguous().transpose(-1, -2), "scale": scale}

    layers = dict(params["layers"])
    for name in _INT8_PROJS:
        if name in layers:  # per-projection or fused serving layout
            layers[name] = quant(layers[name])
    return {**params, "layers": layers}


def _int_mm(a8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] x int8 [K, N] -> int32 [M, N] through ``torch._int_mm``.

    Rows are zero-padded up to INT_MM_MIN_ROWS and sliced off again, on
    every device, so the CPU runs what the card runs. An inner or outer
    size the op cannot take raises; nothing falls back to a float product.
    """
    m, k = a8.shape
    n = w8.shape[1]
    if k % INT_MM_MULTIPLE or n % INT_MM_MULTIPLE:
        raise ValueError(
            f"int8 projection [{k}, {n}]: torch._int_mm needs inner and outer "
            f"sizes that are multiples of {INT_MM_MULTIPLE}"
        )
    if m < INT_MM_MIN_ROWS:
        a8 = torch.cat([a8, a8.new_zeros(INT_MM_MIN_ROWS - m, k)])
    return torch._int_mm(a8.contiguous(), w8)[:m]


def _linear_q8(h: torch.Tensor, q: dict) -> torch.Tensor:
    """Dynamic W8A8 linear: h [..., K] @ {w8 [K, N], scale [1, N]}.

    Rows of h are quantized with max-abs scales in f32 (round half to
    even, clipped to +-127), multiplied in int8 into int32, and rescaled by
    both scales back to h's dtype, as JAX's ``_linear_q8``.
    """
    hf = h.to(torch.float32)
    a_scale = _max_abs_scale(hf, -1)
    h8 = torch.clamp(torch.round(hf / a_scale), -127, 127).to(torch.int8)
    acc = _int_mm(h8.reshape(-1, h8.shape[-1]), q["w8"])
    acc = acc.reshape(*h8.shape[:-1], acc.shape[-1])
    return (acc.to(torch.float32) * a_scale * q["scale"]).to(h.dtype)


def _proj(h: torch.Tensor, p) -> torch.Tensor:
    """One linear projection: a dense [in, out] matrix or an int8 quant
    dict."""
    if isinstance(p, dict):
        return _linear_q8(h, p)
    return h @ p


def fuse_params_for_serving(params: dict) -> dict:
    """Concatenate q/k/v into ``qkv_proj`` [L, H, (NQ+2*NKV)*DH] and
    gate/up into ``gate_up_proj`` [L, H, 2I]: fewer, larger products from
    the same activation, each output column the same dot product. Serving
    only (training and the HF export keep the per-projection layout);
    quantize after fusing, never before."""
    layers = dict(params["layers"])
    if "qkv_proj" in layers:
        raise ValueError(
            "params are already fused for serving (qkv_proj present); "
            "fuse_params_for_serving is not idempotent — fuse the "
            "per-projection checkpoint once"
        )
    for name in ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj"):
        if isinstance(layers.get(name), dict):
            raise ValueError(
                "fuse_params_for_serving expects dense weights; apply "
                "quantize_params_int8 after fusing"
            )
    layers["qkv_proj"] = torch.cat(
        [layers.pop("q_proj"), layers.pop("k_proj"), layers.pop("v_proj")], dim=-1
    )
    layers["gate_up_proj"] = torch.cat(
        [layers.pop("gate_proj"), layers.pop("up_proj")], dim=-1
    )
    return {**params, "layers": layers}


def _qkv(h, p: dict, lead: tuple, nq: int, nkv: int, dh: int):
    """q, k, v from the fused or the per-projection layout."""
    if "qkv_proj" in p:
        q, k, v = torch.split(
            _proj(h, p["qkv_proj"]), [nq * dh, nkv * dh, nkv * dh], dim=-1
        )
    else:
        q, k, v = (_proj(h, p[name]) for name in ("q_proj", "k_proj", "v_proj"))
    return (
        q.reshape(*lead, nq, dh),
        k.reshape(*lead, nkv, dh),
        v.reshape(*lead, nkv, dh),
    )


def _mlp(h, p: dict):
    """SwiGLU MLP from the fused or the per-projection layout."""
    if "gate_up_proj" in p:
        gate, up = torch.chunk(_proj(h, p["gate_up_proj"]), 2, dim=-1)
    else:
        gate, up = _proj(h, p["gate_proj"]), _proj(h, p["up_proj"])
    return _proj(torch.nn.functional.silu(gate) * up, p["down_proj"])


def _layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s leaves; an int8 projection's quant dict is indexed
    inside (``{"w8": w8[i], "scale": scale[i]}``)."""
    return {
        name: (
            {k: leaf[i] for k, leaf in w.items()} if isinstance(w, dict) else w[i]
        )
        for name, w in params["layers"].items()
    }


def _layer_body(x, p, *, lead, nq, nkv, dh, eps, rope, attend, tp=None):
    """One transformer layer; returns (new_x, (k_rotated, v)). The full
    forward, the prefix-KV builder and the suffix scorer share it, as in the
    JAX trunk, and every projection goes through ``_proj``, so the fused
    and the int8 layouts serve all three.

    With ``tp`` (``parallel.collectives.TensorParallel``) the layer holds
    this rank's heads and MLP columns: the normed activation enters the
    column-split projections through ``tp.enter`` and the row-split o/down
    products are summed over the ranks by ``tp.reduce``."""
    h = _rms_norm(x, p["input_norm"], eps)
    if tp is not None:
        h = tp.enter(h)
    q, k, v = _qkv(h, p, lead, nq, nkv, dh)
    q = rope(_rms_norm(q, p["q_norm"], eps))
    k = rope(_rms_norm(k, p["k_norm"], eps))
    out = _proj(attend(q, k, v), p["o_proj"])
    x = x + (out if tp is None else tp.reduce(out))
    h = _rms_norm(x, p["post_norm"], eps)
    if tp is not None:
        return x + tp.reduce(_mlp(tp.enter(h), p)), (k, v)
    return x + _mlp(h, p), (k, v)


def _trunk(
    params, config, input_ids, attention_mask, *, keep_kv: bool, flash=False, tp=None
):
    batch, seq = input_ids.shape
    device = input_ids.device
    x = params["embed"][input_ids.long()]
    cos, sin = _rope_tables(config, seq, device)
    if flash:
        def attend(q, k, v):
            return _attention_flash(q, k, v, attention_mask)
    else:
        causal = torch.tril(torch.ones(seq, seq, dtype=torch.bool, device=device))
        valid_key = attention_mask.to(torch.bool)[:, None, None, :]
        bias = _additive_bias(causal[None, None] & valid_key)  # [B,1,T,T]

        def attend(q, k, v):
            return _attention(q, k, v, bias)
    c = cos[None, :, None, :].to(x.dtype)
    s = sin[None, :, None, :].to(x.dtype)
    ranks = 1 if tp is None else tp.size
    nq, nkv, dh = (
        config.num_attention_heads // ranks,
        config.num_key_value_heads // ranks,
        config.head_dim,
    )
    ks, vs = [], []
    for i in range(config.num_hidden_layers):
        x, (k, v) = _layer_body(
            x, _layer_params(params, i), lead=(batch, seq), nq=nq, nkv=nkv,
            dh=dh, eps=config.rms_norm_eps,
            rope=lambda t: t * c + _rotate_half(t) * s,
            attend=attend, tp=tp,
        )
        if keep_kv:
            ks.append(k)
            vs.append(v)
    return x, ks, vs


def forward_hidden(
    params, config, input_ids, attention_mask, *, flash: bool | None = None, tp=None
) -> torch.Tensor:
    """Trunk forward: [B, T] ids + 0/1 mask -> final-norm hidden [B, T, H].

    flash=None defers to ``_use_flash`` (LEAN_EXPLORE_FLASH_ATTENTION, off
    by default); flash=True takes ``ops.flash_attention`` whatever the
    device (its plain twin on the CPU). The variable is read on every call;
    the JAX trunk reads it at trace time, once per compiled shape. ``tp``
    (``parallel.collectives.TensorParallel``) runs this rank's shard of
    tensor-parallel params (``train.contrastive.shard_params``): its
    1/size of the heads and MLP columns, with the full hidden state.
    """
    if flash is None:
        flash = _use_flash(int(input_ids.shape[1]), input_ids.device)
    x, _, _ = _trunk(
        params, config, input_ids, attention_mask, keep_kv=False, flash=flash, tp=tp
    )
    return _rms_norm(x, params["final_norm"], config.rms_norm_eps)


def _last_valid_index(attention_mask: torch.Tensor) -> torch.Tensor:
    """Index of the last 1 in each mask row (padding-side agnostic)."""
    seq = attention_mask.shape[1]
    positions = torch.arange(seq, device=attention_mask.device)[None, :]
    minus_one = torch.full_like(positions, -1)
    return torch.where(attention_mask.to(torch.bool), positions, minus_one).amax(1)


def _pool_last(hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    last = _last_valid_index(attention_mask)
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), last]


def embed_pool(params, config, input_ids, attention_mask, *, tp=None) -> torch.Tensor:
    """Last-valid-token hidden state, L2-normalized, f32 [B, H]."""
    hidden = forward_hidden(params, config, input_ids, attention_mask, tp=tp)
    pooled = _pool_last(hidden, attention_mask).to(torch.float32)
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp_min(1e-12)


@torch.no_grad()
def embed_pool_from_ids(params, config, input_ids, lengths) -> torch.Tensor:
    """embed_pool with the [B, T] mask built from row lengths: rows are
    right-padded, and every row keeps at least one valid position."""
    seq = input_ids.shape[1]
    valid_len = lengths.clamp(1, seq)
    mask = (
        torch.arange(seq, device=input_ids.device)[None, :] < valid_len[:, None]
    ).to(torch.int32)
    return embed_pool(params, config, input_ids, mask)


def _lm_head(params, hidden: torch.Tensor) -> torch.Tensor:
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return hidden.to(torch.float32) @ head.to(torch.float32)


def last_token_logits(params, config, input_ids, attention_mask) -> torch.Tensor:
    """Logits at the last valid position only, [B, V] f32: the head runs on
    one position instead of all T."""
    hidden = forward_hidden(params, config, input_ids, attention_mask)
    return _lm_head(params, _pool_last(hidden, attention_mask))


def _pair_logits(params, hidden, token_false: int, token_true: int):
    """Logits at exactly (false, true) -> [B, 2] f32."""
    head = params.get("lm_head")
    cols = [token_false, token_true]
    sliver = params["embed"][cols].T if head is None else head[:, cols]
    return hidden.to(torch.float32) @ sliver.to(torch.float32)


def rerank_scores(
    params, config, input_ids, attention_mask, *, token_true: int, token_false: int
) -> torch.Tensor:
    """P("true") from the last-token true/false logits [B] (f32)."""
    hidden = forward_hidden(params, config, input_ids, attention_mask)
    pooled = _pool_last(hidden, attention_mask)
    pair = _pair_logits(params, pooled, token_false, token_true)
    return torch.softmax(pair, dim=1)[:, 1]


@torch.no_grad()
def rerank_scores_chained(
    params, config, input_ids, attention_mask, *, token_true: int, token_false: int
) -> torch.Tensor:
    """``rerank_scores`` over G stacked same-shape buckets: [G, B, T] ->
    [G, B] f32, with no host sync inside, so row g equals the separate call
    on bucket g bit for bit (JAX's is one ``lax.scan`` dispatch)."""
    return torch.stack([
        rerank_scores(
            params, config, ids, mask, token_true=token_true, token_false=token_false
        )
        for ids, mask in zip(input_ids, attention_mask)
    ])


@torch.no_grad()
def prefix_kv(params, config, input_ids, attention_mask):
    """Forward a batch of shared pair prefixes [G, P]; returns the post-RoPE,
    post-norm (k, v) of every layer, each [L, G, P, NKV, DH]."""
    _, ks, vs = _trunk(params, config, input_ids, attention_mask, keep_kv=True)
    return torch.stack(ks), torch.stack(vs)


def _suffix_attention(q, pk, pv, k, v, bias):
    """Suffix queries over [prefix-KV | suffix-KV].

    q: [C, D, S, NQ, DH]; pk/pv: [C, P, NKV, DH], shared by each group's D
    documents; k/v: [C, D, S, NKV, DH]; bias: [C, D, 1, S, P+S].
    """
    c, d, s, nq, dh = q.shape
    p = pk.shape[1]
    nkv = k.shape[3]
    qg = q.reshape(c, d, s, nkv, nq // nkv, dh).to(torch.float32)
    scores_p = torch.einsum("cdtkge,cpke->cdkgtp", qg, pk.to(torch.float32))
    scores_s = torch.einsum("cdtkge,cduke->cdkgtu", qg, k.to(torch.float32))
    scores = torch.cat([scores_p, scores_s], dim=-1) * (dh**-0.5)
    scores = scores + bias[:, :, :, None, :, :]
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out_p = torch.einsum("cdkgtp,cpke->cdtkge", probs[..., :p], pv)
    out_s = torch.einsum("cdkgtu,cduke->cdtkge", probs[..., p:], v)
    return (out_p + out_s).reshape(c, d, s, nq * dh)


def _suffix_forward_scores(
    params, config, pk_c, pv_c, prefix_mask, input_ids, attention_mask,
    pos_offset, cos_full, sin_full, token_true, token_false,
):
    """C query groups: suffixes [C, D, S] attend prefix KV [L, C, P]."""
    c, d, s = input_ids.shape
    device = input_ids.device
    x = params["embed"][input_ids.long()]
    # Suffix token t sits at absolute position pos_offset + t, exactly where
    # it would be in the unsplit pair forward.
    pos = pos_offset.long()[:, None] + torch.arange(s, device=device)[None, :]
    cc = cos_full[pos][:, None, :, None, :].to(x.dtype)  # [C,1,S,1,DH]
    ss = sin_full[pos][:, None, :, None, :].to(x.dtype)

    causal = torch.tril(torch.ones(s, s, dtype=torch.bool, device=device))
    valid_suffix = attention_mask.to(torch.bool)[:, :, None, None, :]
    bias_s = _additive_bias(causal[None, None, None] & valid_suffix)  # [C,D,1,S,S]
    bias_p = _additive_bias(prefix_mask.to(torch.bool)[:, None, None, None, :])
    bias = torch.cat(
        [bias_p.expand(c, d, 1, s, prefix_mask.shape[1]), bias_s], dim=-1
    )  # [C, D, 1, S, P+S]

    nq, nkv, dh = (
        config.num_attention_heads,
        config.num_key_value_heads,
        config.head_dim,
    )
    for i in range(config.num_hidden_layers):
        pk, pv = pk_c[i], pv_c[i]
        x, _ = _layer_body(
            x, _layer_params(params, i), lead=(c, d, s), nq=nq, nkv=nkv,
            dh=dh, eps=config.rms_norm_eps,
            rope=lambda t: t * cc + _rotate_half(t) * ss,
            attend=lambda q, k, v, pk=pk, pv=pv: _suffix_attention(
                q, pk, pv, k, v, bias
            ),
        )
    hidden = _rms_norm(x, params["final_norm"], config.rms_norm_eps)
    pooled = _pool_last(hidden.reshape(c * d, s, -1), attention_mask.reshape(c * d, s))
    pair = _pair_logits(params, pooled, token_false, token_true)
    return torch.softmax(pair, dim=1)[:, 1].reshape(c, d)


@torch.no_grad()
def rerank_scores_grouped(
    params, config, pk, pv, prefix_mask, suffix_ids, suffix_mask, pos_offset,
    *, token_true: int, token_false: int, group_chunk: int = 4,
) -> torch.Tensor:
    """P("true") for G query groups of D document suffixes each -> [G, D].

    Args:
        pk/pv: [L, G, P, NKV, DH] from ``prefix_kv``.
        prefix_mask: [G, P].
        suffix_ids/suffix_mask: [G, D, S] right-padded document suffixes.
        pos_offset: [G] each group's true (unpadded) prefix length.
        group_chunk: query groups per step (G % group_chunk == 0); bounds
            the [C, D, NKV, G, S, P+S] score tensor.
    """
    g, d, s = suffix_ids.shape
    if g % group_chunk:
        raise ValueError(f"G={g} not a multiple of group_chunk={group_chunk}")
    cos_full, sin_full = _rope_tables(config, pk.shape[2] + s, suffix_ids.device)
    out = []
    for start in range(0, g, group_chunk):
        sl = slice(start, start + group_chunk)
        out.append(
            _suffix_forward_scores(
                params, config, pk[:, sl], pv[:, sl], prefix_mask[sl],
                suffix_ids[sl], suffix_mask[sl], pos_offset[sl],
                cos_full, sin_full, token_true, token_false,
            )
        )
    return torch.cat(out, dim=0)
