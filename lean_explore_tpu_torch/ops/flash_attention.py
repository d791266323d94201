"""Causal GQA flash attention with segment ids (the Hopper port of the
Pallas TPU flash attention that the JAX trunk's ``_attention_flash`` calls),
forward and backward.

Replaces ``jax.experimental.pallas.ops.tpu.flash_attention`` as
``_attention_flash`` (lean_explore_tpu/models/qwen3.py:201) uses it:
causal attention where a query sees a key only if the key is not later and
both lie in the same segment, the segment ids being the 0/1 attention mask
(pad 0, valid 1). ``sm_scale`` is DH^-0.5 in the trunk. The score tensor
[B, NQ, T, T] never exists: the kernel streams key blocks through an online
softmax.

On CUDA tensors ``attention_flash`` launches the hand-written kernel in
``csrc/flash_attention.cu`` (design and bound in its header note): bf16
products for bf16 inputs, 3xTF32 ones for float32 inputs (the trunk's f32
parity setting); on CPU tensors it runs ``attention_flash_plain``. There is
no fallback from one to the other.

The backward (JAX's ``_flash_attention_bwd_dkv`` and
``_flash_attention_bwd_dq`` Pallas kernels) is ``FlashAttention``, a
``torch.autograd.Function``: its forward also keeps the row log-sum-exp,
and its backward computes di = rowsum(dO * O) in torch, as JAX does outside
its kernels, then ``attention_flash_bwd_dq`` and ``attention_flash_bwd_dkv``
launch the two kernels of ``csrc/flash_attention_bwd.cu`` on CUDA tensors
or run their plain twin ``attention_flash_bwd_plain`` on CPU tensors.
"""

import ctypes

import torch

from lean_explore_tpu_torch.ops.cuda_build import load_library

# The TPU kernel's mask value (DEFAULT_MASK_VALUE): finite, so that a row
# whose keys in some block are all masked gives no NaN.
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# T must be a multiple of BLOCK: the kernels run 128-query blocks, the last
# of which may be half full (csrc/flash_attention.cu).
BLOCK = 64
HEAD_DIMS = (64, 128)
# The input dtypes the kernel takes, with the entry point of each.
KERNEL_ENTRIES = {torch.bfloat16: "flash_attention_fwd", torch.float32: "flash_attention_fwd_f32"}
# The same, also writing the row log-sum-exp.
LSE_ENTRIES = {
    torch.bfloat16: "flash_attention_fwd_lse",
    torch.float32: "flash_attention_fwd_f32_lse",
}
# The backward kernels' entry points (csrc/flash_attention_bwd.cu).
DQ_ENTRIES = {torch.bfloat16: "flash_attention_bwd_dq", torch.float32: "flash_attention_bwd_dq_f32"}
DKV_ENTRIES = {
    torch.bfloat16: "flash_attention_bwd_dkv",
    torch.float32: "flash_attention_bwd_dkv_f32",
}


def allowed_keys(mask: torch.Tensor) -> torch.Tensor:
    """[B, T, T] bool: query i sees key j iff j <= i and both have the same
    segment id (the mask value)."""
    seg = mask.to(torch.int32)
    t = seg.shape[1]
    causal = torch.tril(torch.ones(t, t, dtype=torch.bool, device=seg.device))
    return causal[None] & (seg[:, :, None] == seg[:, None, :])


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, T, H * DH] or [B, T, H, DH] -> [B, H, T, DH] in f32."""
    b, t = x.shape[:2]
    return x.reshape(b, t, heads, -1).permute(0, 2, 1, 3).to(torch.float32)


def _masked_scores(q, k, mask, sm_scale) -> torch.Tensor:
    """[B, NQ, T, T] f32 scaled scores, masked keys at MASK_VALUE; kv heads
    repeated to the q heads."""
    group = q.shape[2] // k.shape[2]
    qh = _heads(q, q.shape[2])
    kh = _heads(k, k.shape[2]).repeat_interleave(group, dim=1)
    scores = (qh @ kh.transpose(-1, -2)) * sm_scale
    return scores.masked_fill(~allowed_keys(mask)[:, None], MASK_VALUE)


def attention_flash_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    sm_scale: float,
    *,
    with_lse: bool = False,
):
    """[B, T, NQ * DH] in q's dtype, in torch ops: the kernel's plain twin.

    q [B, T, NQ, DH], k and v [B, T, NKV, DH], mask [B, T]. QK^T in f32
    from the inputs' values, the segment and causal mask, softmax in f32,
    the probabilities cast to v's dtype, PV accumulated in f32, the result
    cast to q's dtype. With ``with_lse`` also the row log-sum-exp of the
    masked scores, lse [B, NQ, T] f32 (natural log). It builds the
    [B, NQ, T, T] scores, so it is for the tests, the chip check and the
    CPU path only.
    """
    b, t, nq, dh = q.shape
    group = nq // k.shape[2]
    vh = v.permute(0, 2, 1, 3).repeat_interleave(group, dim=1)
    scores = _masked_scores(q, k, mask, sm_scale)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = probs.to(torch.float32) @ vh.to(torch.float32)
    out = out.to(q.dtype).permute(0, 2, 1, 3).reshape(b, t, nq * dh)
    if with_lse:
        return out, torch.logsumexp(scores, dim=-1)
    return out


def row_dot(out: torch.Tensor, dout: torch.Tensor, heads: int) -> torch.Tensor:
    """di = rowsum(dO * O) [B, NQ, T] f32 of out and dout [B, T, NQ * DH]:
    the backward's per-row term, computed in torch as JAX computes it
    outside its kernels (flash_attention.py:273-274)."""
    return (_heads(out, heads) * _heads(dout, heads)).sum(dim=-1).contiguous()


def attention_flash_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    sm_scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the inputs' dtype and layouts: the plain twin of the
    two backward kernels, written out (not autograd).

    out and dout are [B, T, NQ * DH], lse [B, NQ, T] from the forward. With
    S the masked scaled scores, P = exp(S - lse) (exactly 0 at masked keys),
    dV = P^T dO, dP = dO V^T, D = rowsum(dO * O), dS = P * (dP - D) * scale,
    dQ = dS K and dK = dS^T Q, dK and dV summed over each GQA group. As in
    the kernels and the TPU ones, P and dS are cast to the input dtype
    before their products, which run in f32 on f32 values.
    """
    return _bwd_plain(q, k, v, mask, lse, dout, row_dot(out, dout, q.shape[2]), sm_scale)


def _bwd_terms(q, k, v, mask, lse, dout, sm_scale):
    """The backward's f32 operands on [B, NQ, T, .] heads (kv heads
    repeated): qh, kh, vh, dO and P = exp(S - lse), exactly 0 at masked
    keys."""
    nq, nkv = q.shape[2], k.shape[2]
    group = nq // nkv
    qh = _heads(q, nq)
    kh = _heads(k, nkv).repeat_interleave(group, dim=1)
    vh = _heads(v, nkv).repeat_interleave(group, dim=1)
    do = _heads(dout.to(q.dtype), nq)
    p = torch.exp(_masked_scores(q, k, mask, sm_scale) - lse[..., None])
    return qh, kh, vh, do, p


def _group_sum(x: torch.Tensor, nkv: int) -> torch.Tensor:
    """[B, NQ, T, DH] -> [B, T, NKV, DH]: the sum over each GQA group."""
    b, nq, t, dh = x.shape
    return x.reshape(b, nkv, nq // nkv, t, dh).sum(dim=2).permute(0, 2, 1, 3)


def _bwd_plain(q, k, v, mask, lse, dout, di, sm_scale):
    dtype, nkv = q.dtype, k.shape[2]
    qh, kh, vh, do, p = _bwd_terms(q, k, v, mask, lse, dout, sm_scale)
    dv = p.to(dtype).to(torch.float32).transpose(-1, -2) @ do
    ds = p * ((do @ vh.transpose(-1, -2)) - di[..., None]) * sm_scale
    ds = ds.to(dtype).to(torch.float32)
    dq = ds @ kh
    dk = ds.transpose(-1, -2) @ qh
    return (
        dq.permute(0, 2, 1, 3).to(dtype),
        _group_sum(dk, nkv).to(dtype),
        _group_sum(dv, nkv).to(dtype),
    )


def bwd_kernel_tolerance(q, k, v, mask, lse, dout, di, sm_scale) -> tuple[float, float, float]:
    """How far the backward kernels' (dq, dk, dv) may lie from the plain
    twin's on the same inputs and residuals: a bound per output element,
    derived from the terms of the products, of which the max is returned.

    Scores: s = scale <q, k> differs between the two by at most
    eps_s = scale (c_split + 7 DH 2^-24) max|q_i| max|k_j| (the twin's f32
    sum and the tensor cores' truncating one; c_split = 3 * 2^-22 for the
    3xTF32 split of f32 inputs, 0 for bf16, whose products are exact in
    f32), and dp = <dO, v> by eps_dp, the same with |dO| |v|. exp2 of the
    log2-scaled s - lse against exp of s - lse adds 2^-21 (max|s| +
    max|lse| + 1) to the exponent, so each p lies within a factor
    exp(+-rel_p), rel_p = 2 (eps_s + that) (both sides). Then

        E_p  = p (rel_p + r),                 r = 2^-8 in bf16, where one
                                              side may round p to the next
                                              bf16 (dV's operand), else 0;
        E_ds = scale p (rel_p |dp - di| + eps_dp) + r |ds|;
        dV: E_p^T |dO| + c_n (p^T |dO|),  dQ: E_ds |K| + c_n (|dS| |K|),
        dK: E_ds^T |Q| + c_n (|dS|^T |Q|),

    with c_n = c_split + 7 n 2^-24 for a sum of n terms (T for dQ, T times
    the group for dK and dV, whose group sums the twin takes after the
    products), and in bf16 2^-8 max|grad| for the two output roundings.
    """
    bf16 = q.dtype == torch.bfloat16
    nq, nkv = q.shape[2], k.shape[2]
    dh, t, group = q.shape[3], q.shape[1], nq // nkv
    c_split = 0.0 if bf16 else 3 * 2.0**-22
    r = 2.0**-8 if bf16 else 0.0
    qh, kh, vh, do, p = _bwd_terms(q, k, v, mask, lse, dout, sm_scale)
    qn, kn = float(qh.norm(dim=-1).max()), float(kh.norm(dim=-1).max())
    don, vn = float(do.norm(dim=-1).max()), float(vh.norm(dim=-1).max())
    eps_s = sm_scale * (c_split + 7 * dh * 2.0**-24) * qn * kn
    eps_dp = (c_split + 7 * dh * 2.0**-24) * don * vn
    s_max = sm_scale * qn * kn
    rel_p = 2 * (eps_s + 2.0**-21 * (s_max + float(lse.abs().max()) + 1))
    dp_di = (do @ vh.transpose(-1, -2)) - di[..., None]
    ds = (sm_scale * p * dp_di).abs()
    e_ds = sm_scale * p * (rel_p * dp_di.abs() + eps_dp) + r * ds
    c_t = c_split + 7 * t * 2.0**-24
    c_gt = c_split + 7 * group * t * 2.0**-24
    tol_dq = e_ds @ kh.abs() + c_t * (ds @ kh.abs())
    tol_dk = e_ds.transpose(-1, -2) @ qh.abs() + c_gt * (ds.transpose(-1, -2) @ qh.abs())
    tol_dv = (p * (rel_p + r)).transpose(-1, -2) @ do.abs() + c_gt * (
        p.transpose(-1, -2) @ do.abs()
    )
    tols = [float(tol_dq.max()), float(_group_sum(tol_dk, nkv).max()),
            float(_group_sum(tol_dv, nkv).max())]
    if bf16:
        grads = _bwd_plain(q, k, v, mask, lse, dout, di, sm_scale)
        tols = [tol + 2.0**-8 * float(g.float().abs().max()) for tol, g in zip(tols, grads)]
    return tuple(tols)


def kernel_tolerance(q, k, v, out) -> float:
    """How far the kernel's valid rows may lie from the plain twin's ``out``
    on the same q, k, v.

    bf16: both take QK^T from the same bf16 values in f32 and the softmax
    in f32; they differ in where the probabilities are rounded to bf16 (the
    kernel rounds exp(s - m) in [0, 1] before PV, as the TPU kernel does;
    the twin rounds the normalised probabilities), each rounding within
    2^-9 of p, so each side's PV lies within 2^-9 * max|v| of the exact
    one: 2^-8 * max|v| for the two. Each output is then rounded to bf16,
    within half an ulp, 2^-8 |out|, each side: 2^-7 * max|out|. The f32 sums
    in other orders and the kernel's exp2 against exp move p by under 1e-4
    relative (scores of magnitude <= 16 at DH = 128), covered by another
    2^-8 * max|v|. So 2^-7 * (max|v| + max|out|), about two bf16 ulps of
    the output's magnitude.

    float32 (3xTF32 products, p kept in f32): each score s = scale <q, k>
    lies within eps = scale * (3 * 2^-22 + 7 * DH * 2^-24) * |q| |k| of the
    twin's (``ops.bin_topk.score_tolerance``'s terms, scaled by the rows'
    norms), which moves each softmax weight by a factor within
    exp(+-2 eps), so the output by at most 2 eps * max|v|; doubled to
    4 eps for the kernel's exp2 against exp. PV is a 3xTF32 sum over up to
    T keys (truncating tensor-core sums, rescaled f32 accumulators), within
    (3 * 2^-22 + 7 * T * 2^-24) * max|v| of the twin's, and the division
    adds 2^-22 * max|out|.
    """
    vmax = float(v.float().abs().max())
    omax = float(out.float().abs().max())
    if q.dtype == torch.float32:
        dh, t = q.shape[-1], q.shape[1]
        norms = float(q.norm(dim=-1).max()) * float(k.norm(dim=-1).max())
        eps = dh**-0.5 * (3 * 2.0**-22 + 7 * dh * 2.0**-24) * norms
        return vmax * (4 * eps + 3 * 2.0**-22 + 7 * t * 2.0**-24) + 2.0**-22 * omax
    return 2.0**-7 * (vmax + omax)


def _configure(lib: ctypes.CDLL) -> None:
    tail = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    for entry in KERNEL_ENTRIES.values():
        getattr(lib, entry).argtypes = [ctypes.c_void_p] * 5 + tail
    for entry in LSE_ENTRIES.values():
        getattr(lib, entry).argtypes = [ctypes.c_void_p] * 6 + tail
    for entry in (*KERNEL_ENTRIES.values(), *LSE_ENTRIES.values()):
        getattr(lib, entry).restype = ctypes.c_int


def _configure_bwd(lib: ctypes.CDLL) -> None:
    tail = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    for entry in DQ_ENTRIES.values():
        getattr(lib, entry).argtypes = [ctypes.c_void_p] * 8 + tail
        getattr(lib, entry).restype = ctypes.c_int
    for entry in DKV_ENTRIES.values():
        getattr(lib, entry).argtypes = [ctypes.c_void_p] * 9 + tail
        getattr(lib, entry).restype = ctypes.c_int


def _check_inputs(q, k, v, mask) -> None:
    """Raise on what the kernels do not take."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(
            f"attention_flash: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}; want [B, T, NQ, DH] and [B, T, NKV, DH]"
        )
    b, t, nq, dh = q.shape
    if k.shape[:2] != (b, t) or k.shape[3] != dh or nq % k.shape[2]:
        raise ValueError(f"attention_flash: k/v {tuple(k.shape)} vs q {tuple(q.shape)}")
    if tuple(mask.shape) != (b, t):
        raise ValueError(f"attention_flash: mask {tuple(mask.shape)}, want {(b, t)}")
    tensors = (q, k, v, mask)
    if any(x.device.type != "cuda" or x.device != q.device for x in tensors):
        raise ValueError(
            "attention_flash: q, k, v and mask must lie on one CUDA device, got "
            f"{[str(x.device) for x in tensors]}"
        )
    if q.dtype not in KERNEL_ENTRIES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            "the flash_attention kernel takes q, k and v of one dtype, bf16 or "
            f"float32, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if t % BLOCK or dh not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention kernel needs T ({t}) a multiple of {BLOCK} and a "
            f"head dim ({dh}) in {HEAD_DIMS}"
        )
    if not all(x.is_contiguous() for x in (q, k, v)):
        raise ValueError("flash_attention kernel needs contiguous q, k and v")


def _check_residuals(q, dout, lse, di) -> None:
    """Raise on backward inputs the kernels do not take."""
    b, t, nq, dh = q.shape
    if tuple(dout.shape) not in ((b, t, nq * dh), (b, t, nq, dh)):
        raise ValueError(f"flash backward: dout {tuple(dout.shape)} vs q {tuple(q.shape)}")
    if dout.dtype != q.dtype or dout.device != q.device or not dout.is_contiguous():
        raise ValueError(
            f"flash backward: dout must be contiguous {q.dtype} on {q.device}, got "
            f"{dout.dtype} on {dout.device}"
        )
    for name, x in (("lse", lse), ("di", di)):
        if (
            tuple(x.shape) != (b, nq, t)
            or x.dtype != torch.float32
            or x.device != q.device
            or not x.is_contiguous()
        ):
            raise ValueError(
                f"flash backward: {name} must be contiguous float32 {(b, nq, t)} on "
                f"{q.device}, got {x.dtype} {tuple(x.shape)} on {x.device}"
            )


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def attention_flash(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    sm_scale: float,
    *,
    with_lse: bool = False,
):
    """Causal segment-masked GQA attention -> [B, T, NQ * DH] in q's dtype,
    and with ``with_lse`` also lse [B, NQ, T] f32, the row log-sum-exp of
    the scaled masked scores in natural-log units (the backward's residual).

    CPU tensors take ``attention_flash_plain``. CUDA tensors launch the
    kernel, which takes q [B, T, NQ, DH] and k, v [B, T, NKV, DH] of one
    dtype, bf16 or float32, contiguous, with T a multiple of 64, NQ a
    multiple of NKV and DH 64 or 128, and the mask [B, T] (any integer or
    bool dtype: it is cast to int32 segment ids); anything else raises.
    Without ``with_lse`` the kernel runs its lse-free instantiation.
    ``attention_flash.launches`` counts launches.
    """
    if all(x.device.type == "cpu" for x in (q, k, v, mask)):
        return attention_flash_plain(q, k, v, mask, sm_scale, with_lse=with_lse)
    _check_inputs(q, k, v, mask)
    b, t, nq, dh = q.shape
    seg = mask.to(torch.int32).contiguous()
    out = torch.empty(b, t, nq * dh, dtype=q.dtype, device=q.device)
    lib = load_library("flash_attention")
    _configure(lib)
    pointers = [q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), out.data_ptr()]
    lse = None
    if with_lse:
        lse = torch.empty(b, nq, t, dtype=torch.float32, device=q.device)
        pointers.append(lse.data_ptr())
    entry = (LSE_ENTRIES if with_lse else KERNEL_ENTRIES)[q.dtype]
    with torch.cuda.device(q.device):
        status = getattr(lib, entry)(
            *pointers, b, t, nq, k.shape[2], dh, float(sm_scale), _stream(q.device)
        )
    attention_flash.launches += 1
    if status != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {status}")
    return (out, lse) if with_lse else out


attention_flash.launches = 0


def _launch_bwd(entries, name, q, k, v, mask, dout, lse, di, outputs, sm_scale) -> None:
    _check_inputs(q, k, v, mask)
    _check_residuals(q, dout, lse, di)
    b, t, nq, dh = q.shape
    seg = mask.to(torch.int32).contiguous()
    lib = load_library("flash_attention_bwd")
    _configure_bwd(lib)
    with torch.cuda.device(q.device):
        status = getattr(lib, entries[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), di.data_ptr(), *(x.data_ptr() for x in outputs),
            b, t, nq, k.shape[2], dh, float(sm_scale), _stream(q.device),
        )
    if status != 0:
        raise RuntimeError(f"flash_attention {name} kernel launch failed: cudaError {status}")


def attention_flash_bwd_dq(q, k, v, mask, dout, lse, di, sm_scale) -> torch.Tensor:
    """dq [B, T, NQ, DH] in q's dtype from the forward's inputs, dout
    [B, T, NQ * DH], lse and di [B, NQ, T] f32 (``row_dot``).

    CPU tensors take the plain twin. CUDA tensors launch the dq kernel of
    ``csrc/flash_attention_bwd.cu``, on what the forward kernel takes, with
    dout contiguous in q's dtype and lse, di contiguous float32; anything
    else raises. ``attention_flash_bwd_dq.launches`` counts launches.
    """
    if all(x.device.type == "cpu" for x in (q, k, v, mask, dout, lse, di)):
        return _bwd_plain(q, k, v, mask, lse, dout, di, sm_scale)[0]
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd(DQ_ENTRIES, "dq", q, k, v, mask, dout, lse, di, (dq,), sm_scale)
    attention_flash_bwd_dq.launches += 1
    return dq


attention_flash_bwd_dq.launches = 0


def attention_flash_bwd_dkv(q, k, v, mask, dout, lse, di, sm_scale):
    """(dk, dv) [B, T, NKV, DH] in k's dtype, each summed over its GQA
    group's q heads, on the inputs of ``attention_flash_bwd_dq``: CPU
    tensors take the plain twin, CUDA tensors launch the dk/dv kernel or
    raise. ``attention_flash_bwd_dkv.launches`` counts launches."""
    if all(x.device.type == "cpu" for x in (q, k, v, mask, dout, lse, di)):
        return _bwd_plain(q, k, v, mask, lse, dout, di, sm_scale)[1:]
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_bwd(DKV_ENTRIES, "dk/dv", q, k, v, mask, dout, lse, di, (dk, dv), sm_scale)
    attention_flash_bwd_dkv.launches += 1
    return dk, dv


attention_flash_bwd_dkv.launches = 0


class FlashAttention(torch.autograd.Function):
    """``attention_flash`` with a gradient: ``FlashAttention.apply(q, k, v,
    mask, sm_scale)`` -> [B, T, NQ * DH].

    The forward also keeps lse and saves q, k, v, mask, out and lse; the
    backward computes di = rowsum(dO * O) in torch and runs
    ``attention_flash_bwd_dq`` and ``attention_flash_bwd_dkv``: the kernels
    on CUDA tensors, their plain twin on CPU tensors. Callers that need no
    gradient call ``attention_flash`` itself, with no lse.
    """

    @staticmethod
    def forward(ctx, q, k, v, mask, sm_scale):
        ctx.sm_scale = sm_scale
        out, lse = attention_flash(q, k, v, mask, sm_scale, with_lse=True)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        di = row_dot(out, dout, q.shape[2])
        args = (q, k, v, mask, dout, lse, di, ctx.sm_scale)
        dq = attention_flash_bwd_dq(*args)
        dk, dv = attention_flash_bwd_dkv(*args)
        return dq, dk, dv, None, None
