"""Plain Qwen3 trunk in float32: the reference both served models are held to.

Written from the published architecture (Qwen3 decoder: RMSNorm before
attention and MLP, per-head RMSNorm on q and k, rotate-half RoPE with
theta from the configuration, grouped-query causal attention, SwiGLU MLP,
a final RMSNorm, the head tied to the embedding table), one sequence at a
time, right padded, with no cache, no kernel and no batching trick. It
imports nothing of the program. Parameters are the benchmark's own
(``harness.weights``): the layout

    embed [V, H]; layers {input_norm [L, H], q_proj [L, H, NQ*DH],
    k_proj / v_proj [L, H, NKV*DH], o_proj [L, NQ*DH, H], q_norm / k_norm
    [L, DH], post_norm [L, H], gate_proj / up_proj [L, H, I],
    down_proj [L, I, H]}; final_norm [H]

``precision="fp8"`` is the control: every matrix product takes its two
operands rounded to float8 e4m3 (one scale per row of the left operand and
per column of the right), the step below the bf16 the configuration serves.
"""

import math

import torch

FP8_MAX = 448.0


def _round_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a [..., K] @ b [K, N] (or batched), float32 out."""
    if precision == "fp8":
        a = _round_fp8(a, -1)
        b = _round_fp8(b, -2)
    return torch.matmul(a, b)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * weight.float()


def rope_tables(seq: int, head_dim: int, theta: float, device):
    inv = 1.0 / theta ** (torch.arange(0, head_dim, 2, dtype=torch.float64) / head_dim)
    ang = torch.arange(seq, dtype=torch.float64)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos().float().to(device), ang.sin().float().to(device)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def hidden_states(params: dict, cfg: dict, ids: torch.Tensor, lengths: torch.Tensor,
                  precision: str = "f32") -> torch.Tensor:
    """Final-norm hidden states [B, T, H] in float32 of right-padded token
    rows ``ids`` [B, T] whose first ``lengths`` [B] positions are real."""
    b, t = ids.shape
    nq, nkv, dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    eps = cfg["rms_norm_eps"]
    dev = ids.device
    x = params["embed"][ids].float()
    cos, sin = rope_tables(t, dh, cfg["rope_theta"], dev)
    pos = torch.arange(t, device=dev)
    allowed = (pos[None, :] <= pos[:, None])[None] & (pos[None, None, :] < lengths[:, None, None])
    bias = torch.zeros(b, 1, t, t, device=dev).masked_fill(~allowed[:, None], float("-inf"))
    lay = params["layers"]
    for i in range(cfg["num_hidden_layers"]):
        h = rms_norm(x, lay["input_norm"][i], eps)
        q = matmul(h, lay["q_proj"][i].float(), precision).view(b, t, nq, dh)
        k = matmul(h, lay["k_proj"][i].float(), precision).view(b, t, nkv, dh)
        v = matmul(h, lay["v_proj"][i].float(), precision).view(b, t, nkv, dh)
        q = rms_norm(q, lay["q_norm"][i], eps)
        k = rms_norm(k, lay["k_norm"][i], eps)
        q = q * cos[None, :, None] + rotate_half(q) * sin[None, :, None]
        k = k * cos[None, :, None] + rotate_half(k) * sin[None, :, None]
        rep = nq // nkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
        q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)  # [B, NQ, T, DH]
        scores = matmul(q, k.transpose(-1, -2), precision) / math.sqrt(dh) + bias
        probs = torch.softmax(scores, dim=-1).nan_to_num(0.0)
        att = matmul(probs, v, precision).transpose(1, 2).reshape(b, t, nq * dh)
        x = x + matmul(att, lay["o_proj"][i].float(), precision)
        h = rms_norm(x, lay["post_norm"][i], eps)
        gate = matmul(h, lay["gate_proj"][i].float(), precision)
        up = matmul(h, lay["up_proj"][i].float(), precision)
        x = x + matmul(torch.nn.functional.silu(gate) * up, lay["down_proj"][i].float(), precision)
    return rms_norm(x, params["final_norm"], eps)


def _padded(rows: list[list[int]], device) -> tuple[torch.Tensor, torch.Tensor]:
    t = max(len(r) for r in rows)
    ids = torch.zeros(len(rows), t, dtype=torch.long)
    for i, r in enumerate(rows):
        ids[i, : len(r)] = torch.tensor(r, dtype=torch.long)
    lengths = torch.tensor([len(r) for r in rows], dtype=torch.long)
    return ids.to(device), lengths.to(device)


def _chunks(rows: list[list[int]], max_tokens: int):
    """Runs of rows, sorted by length, of at most ``max_tokens`` padded
    tokens each; yields (indices, rows)."""
    order = sorted(range(len(rows)), key=lambda i: len(rows[i]))
    start = 0
    while start < len(order):
        end = start + 1
        while end < len(order) and (end + 1 - start) * len(rows[order[end]]) <= max_tokens:
            end += 1
        idx = order[start:end]
        yield idx, [rows[i] for i in idx]
        start = end


@torch.no_grad()
def embed(params, cfg, rows: list[list[int]], device, precision="f32",
          max_tokens: int = 16384) -> torch.Tensor:
    """L2-normalised last-token hidden state of each token row, [N, H] f32."""
    out = torch.empty(len(rows), cfg["hidden_size"], device=device)
    for idx, chunk in _chunks(rows, max_tokens):
        ids, lengths = _padded(chunk, device)
        hid = hidden_states(params, cfg, ids, lengths, precision)
        last = hid[torch.arange(len(chunk), device=device), lengths - 1]
        out[torch.tensor(idx, device=device)] = last / last.norm(dim=-1, keepdim=True)
    return out


@torch.no_grad()
def yes_no_logit(params, cfg, rows: list[list[int]], token_true: int, token_false: int,
                 device, precision="f32", max_tokens: int = 16384) -> torch.Tensor:
    """logit("true") - logit("false") at each row's last token, [N] f32:
    the log-odds whose sigmoid is the reranker's P("true")."""
    out = torch.empty(len(rows), device=device)
    head = params["embed"][[token_false, token_true]].float()  # tied head [2, H]
    for idx, chunk in _chunks(rows, max_tokens):
        ids, lengths = _padded(chunk, device)
        hid = hidden_states(params, cfg, ids, lengths, precision)
        last = hid[torch.arange(len(chunk), device=device), lengths - 1]
        pair = matmul(last, head.T, precision)
        out[torch.tensor(idx, device=device)] = pair[:, 1] - pair[:, 0]
    return out
