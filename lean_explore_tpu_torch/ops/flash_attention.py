"""Causal GQA flash attention with segment ids (the Hopper port of the
Pallas TPU flash attention that the JAX trunk's ``_attention_flash`` calls).

Replaces the forward of ``jax.experimental.pallas.ops.tpu.flash_attention``
as ``_attention_flash`` (lean_explore_tpu/models/qwen3.py:201) uses it:
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
"""

import ctypes

import torch

from lean_explore_tpu_torch.ops.cuda_build import load_library

# The TPU kernel's mask value (DEFAULT_MASK_VALUE): finite, so that a row
# whose keys in some block are all masked gives no NaN.
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# Queries per kernel block and keys per key block (csrc/flash_attention.cu).
BLOCK = 64
HEAD_DIMS = (64, 128)
# The input dtypes the kernel takes, with the entry point of each.
KERNEL_ENTRIES = {torch.bfloat16: "flash_attention_fwd", torch.float32: "flash_attention_fwd_f32"}


def allowed_keys(mask: torch.Tensor) -> torch.Tensor:
    """[B, T, T] bool: query i sees key j iff j <= i and both have the same
    segment id (the mask value)."""
    seg = mask.to(torch.int32)
    t = seg.shape[1]
    causal = torch.tril(torch.ones(t, t, dtype=torch.bool, device=seg.device))
    return causal[None] & (seg[:, :, None] == seg[:, None, :])


def attention_flash_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    sm_scale: float,
) -> torch.Tensor:
    """[B, T, NQ * DH] in q's dtype, in torch ops: the kernel's plain twin.

    q [B, T, NQ, DH], k and v [B, T, NKV, DH], mask [B, T]. QK^T in f32
    from the inputs' values, the segment and causal mask, softmax in f32,
    the probabilities cast to v's dtype, PV accumulated in f32, the result
    cast to q's dtype. It builds the [B, NQ, T, T] scores, so it is for the
    tests, the chip check and the CPU path only.
    """
    b, t, nq, dh = q.shape
    group = nq // k.shape[2]
    qh = q.permute(0, 2, 1, 3).to(torch.float32)
    kh = k.permute(0, 2, 1, 3).to(torch.float32).repeat_interleave(group, dim=1)
    vh = v.permute(0, 2, 1, 3).repeat_interleave(group, dim=1)
    scores = (qh @ kh.transpose(-1, -2)) * sm_scale
    scores = scores.masked_fill(~allowed_keys(mask)[:, None], MASK_VALUE)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = probs.to(torch.float32) @ vh.to(torch.float32)
    return out.to(q.dtype).permute(0, 2, 1, 3).reshape(b, t, nq * dh)


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
    in other orders and exp2f against exp move p by under 1e-4 relative
    (scores of magnitude <= 16 at DH = 128), covered by another
    2^-8 * max|v|. So 2^-7 * (max|v| + max|out|), about two bf16 ulps of
    the output's magnitude.

    float32 (3xTF32 products, p kept in f32): each score s = scale <q, k>
    lies within eps = scale * (3 * 2^-22 + 7 * DH * 2^-24) * |q| |k| of the
    twin's (``ops.bin_topk.score_tolerance``'s terms, scaled by the rows'
    norms), which moves each softmax weight by a factor within
    exp(+-2 eps), so the output by at most 2 eps * max|v|; doubled to
    4 eps for exp2f against exp. PV is a 3xTF32 sum over up to T keys
    (truncating tensor-core sums, rescaled f32 accumulators), within
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
    for entry in KERNEL_ENTRIES.values():
        fn = getattr(lib, entry)
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int


def _check_inputs(q, k, v, mask) -> None:
    """Raise on what the kernel does not take."""
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


def attention_flash(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    sm_scale: float,
) -> torch.Tensor:
    """Causal segment-masked GQA attention -> [B, T, NQ * DH] in q's dtype.

    CPU tensors take ``attention_flash_plain``. CUDA tensors launch the
    kernel, which takes q [B, T, NQ, DH] and k, v [B, T, NKV, DH] of one
    dtype, bf16 or float32, contiguous, with T a multiple of 64, NQ a
    multiple of NKV and DH 64 or 128, and the mask [B, T] (any integer or
    bool dtype: it is cast to int32 segment ids); anything else raises.
    ``attention_flash.launches`` counts launches.
    """
    if all(x.device.type == "cpu" for x in (q, k, v, mask)):
        return attention_flash_plain(q, k, v, mask, sm_scale)
    _check_inputs(q, k, v, mask)
    b, t, nq, dh = q.shape
    seg = mask.to(torch.int32).contiguous()
    out = torch.empty(b, t, nq * dh, dtype=q.dtype, device=q.device)
    lib = load_library("flash_attention")
    _configure(lib)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = getattr(lib, KERNEL_ENTRIES[q.dtype])(
            q.data_ptr(),
            k.data_ptr(),
            v.data_ptr(),
            seg.data_ptr(),
            out.data_ptr(),
            b,
            t,
            nq,
            k.shape[2],
            dh,
            float(sm_scale),
            stream,
        )
    attention_flash.launches += 1
    if status != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {status}")
    return out


attention_flash.launches = 0
