"""The flash-attention backward of the port on the CPU: the plain twin of
the dq and dk/dv kernels (``attention_flash_bwd_plain``) and the autograd
Function ``FlashAttention``, against autograd of the plain forward and
against ``jax.vjp`` of the JAX trunk's ``_attention_flash``, whose Pallas
TPU backward kernels (``_flash_attention_bwd_dkv``, ``_flash_attention_bwd_dq``)
run here in Pallas's TPU interpret mode (``force_tpu_interpret_mode``), with
the JAX package unchanged.

Same seeded numpy inputs on both sides; the upstream gradient dO is zero on
pad rows, as a pooled loss gives it, so every gradient element is compared.

Tolerances:

- Twin vs autograd of the plain forward, and ``FlashAttention`` vs the
  same, float32: one computation written out against another of the same
  products, summed in other orders over at most T * group = 128 terms:
  within 128 * 2^-24 of the largest gradient, about 8e-6 relative.
- Twin vs JAX, float32: both in f32 on the CPU, JAX forming p as
  exp(s - m) / l and the twin as exp(s - lse), sums over up to
  T * group = 512 terms in other orders: 512 * 2^-24 * max|grad|.
- Twin vs JAX, bf16: both round p and dS to bf16 before their products,
  but p differs by a few f32 ulps, so a rounding may fall the other way,
  and each output is rounded; that is ``ops.flash_attention.
  bwd_kernel_tolerance`` (derived there for the kernel against the twin,
  whose differences are of the same kinds), plus 2^-8 * max|grad| for
  JAX's sum over each GQA group of bf16 gradients (the transpose of
  ``jnp.repeat``), which the twin takes in f32.

The kernels themselves run only on the card: tests/test_torch_cuda.py holds
them against the twin there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lean_explore_tpu.models import qwen3 as jq
from lean_explore_tpu_torch.ops import flash_attention as FA

DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16), "float32": (jnp.float32, torch.float32)}


def _inputs(b, t, nq, nkv, dh, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, nq, dh)).astype(np.float32)
    k = rng.standard_normal((b, t, nkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, t, nkv, dh)).astype(np.float32)
    dout = rng.standard_normal((b, t, nq * dh)).astype(np.float32)
    return q, k, v, dout


def _mask(kind, b, t):
    mask = np.ones((b, t), dtype=np.int32)
    if kind in ("right_padded", "mixed"):
        mask[0, 100:] = 0
        mask[-1, 1:] = 0  # one valid token
    if kind in ("left_padded", "mixed"):
        mask[1] = 0
        mask[1, 70:] = 1
    return mask


def _grads(q, k, v, mask, dout, dtype, sm_scale, forward):
    """(out, dq, dk, dv) of ``forward`` by autograd, in f32 numpy."""
    leaves = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    out = forward(*leaves, torch.from_numpy(mask), sm_scale)
    out.backward(torch.from_numpy(dout).to(dtype))
    return [out.detach().float().numpy()] + [x.grad.float().numpy() for x in leaves]


@pytest.mark.parametrize("mask_kind", ["full", "mixed"])
@pytest.mark.parametrize("nq,nkv", [(4, 2), (4, 4), (6, 1)])
def test_plain_backward_matches_autograd_of_the_plain_forward(nq, nkv, mask_kind):
    b, t, dh = 3, 64, 8
    q, k, v, dout = _inputs(b, t, nq, nkv, dh, seed=nq * 10 + nkv)
    mask = _mask(mask_kind, b, t)
    dout *= mask[..., None]
    _, *want = _grads(q, k, v, mask, dout, torch.float32, dh**-0.5, FA.attention_flash_plain)
    tq, tk, tv, tm, tdo = (torch.from_numpy(x) for x in (q, k, v, mask, dout))
    out, lse = FA.attention_flash_plain(tq, tk, tv, tm, dh**-0.5, with_lse=True)
    got = FA.attention_flash_bwd_plain(tq, tk, tv, tm, out, lse, tdo, dh**-0.5)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        tol = 128 * 2.0**-24 * float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, atol=tol, rtol=0)


@pytest.mark.parametrize("mask_kind", ["full", "mixed"])
def test_flash_function_gradients_match_autograd_of_the_plain_forward(mask_kind):
    """``FlashAttention.apply`` on CPU tensors: the twin's forward and
    backward, and no kernel launch counted."""
    b, t, nq, nkv, dh = 3, 64, 4, 2, 16
    q, k, v, dout = _inputs(b, t, nq, nkv, dh, seed=3)
    mask = _mask(mask_kind, b, t)
    dout *= mask[..., None]
    counters = (FA.attention_flash, FA.attention_flash_bwd_dq, FA.attention_flash_bwd_dkv)
    before = [c.launches for c in counters]
    got = _grads(q, k, v, mask, dout, torch.float32, dh**-0.5, FA.FlashAttention.apply)
    assert [c.launches for c in counters] == before
    want = _grads(q, k, v, mask, dout, torch.float32, dh**-0.5, FA.attention_flash_plain)
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=128 * 2.0**-24 * float(np.abs(w).max()), rtol=0)


@pytest.mark.parametrize("mask_kind", ["full", "right_padded"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_backward_matches_jax_pallas_backward(dtype, mask_kind):
    b, t, nq, nkv = 2, 256, 4, 2
    dh = 64 if dtype == "bfloat16" else 16
    q, k, v, dout = _inputs(b, t, nq, nkv, dh, seed=t + dh)
    mask = _mask(mask_kind, b, t)
    dout *= mask[..., None]
    jdt, tdt = DTYPES[dtype]
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(
            lambda q_, k_, v_: jq._attention_flash(q_, k_, v_, jnp.asarray(mask)),
            *(jnp.asarray(x, jdt) for x in (q, k, v)),
        )
        want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(dout, jdt))]
    _, *got = _grads(q, k, v, mask, dout, tdt, dh**-0.5, FA.FlashAttention.apply)

    if dtype == "float32":
        tols = [512 * 2.0**-24 * float(np.abs(w).max()) for w in want]
    else:
        tq, tk, tv, tdo = (torch.from_numpy(x).to(tdt) for x in (q, k, v, dout))
        tm = torch.from_numpy(mask)
        out, lse = FA.attention_flash(tq, tk, tv, tm, dh**-0.5, with_lse=True)
        di = FA.row_dot(out, tdo, nq)
        tols = [
            tol + 2.0**-8 * float(np.abs(w).max())
            for tol, w in zip(FA.bwd_kernel_tolerance(tq, tk, tv, tm, lse, tdo, di, dh**-0.5), want)
        ]
    for name, g, w, tol in zip(("dq", "dk", "dv"), got, want, tols):
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=name)


def test_lse_is_the_row_logsumexp_of_the_masked_scores():
    """attention_flash(with_lse=True) on the CPU: the twin's output, and
    lse [B, NQ, T] equal to logsumexp over each row's allowed keys; every
    row, pad rows too, has the diagonal, so every lse is finite."""
    b, t, nq, nkv, dh = 2, 64, 4, 2, 8
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(b, t, nq, nkv, dh, seed=9))
    mask = torch.from_numpy(_mask("mixed", b, t))
    out, lse = FA.attention_flash(q, k, v, mask, 0.5, with_lse=True)
    assert torch.equal(out, FA.attention_flash(q, k, v, mask, 0.5))
    assert lse.shape == (b, nq, t) and lse.dtype == torch.float32
    kh = k.repeat_interleave(nq // nkv, dim=2)
    scores = torch.einsum("bind,bjnd->bnij", q, kh) * 0.5
    allowed = FA.allowed_keys(mask)[:, None]
    want = torch.logsumexp(scores.masked_fill(~allowed, -torch.inf), dim=-1)
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=0)


def test_backward_wrappers_take_the_twin_on_cpu_tensors_and_count_nothing():
    b, t, nq, nkv, dh = 2, 64, 4, 2, 8
    q, k, v, dout = (torch.from_numpy(x) for x in _inputs(b, t, nq, nkv, dh, seed=4))
    mask = torch.from_numpy(_mask("mixed", b, t))
    out, lse = FA.attention_flash(q, k, v, mask, 0.25, with_lse=True)
    di = FA.row_dot(out, dout, nq)
    before = (FA.attention_flash_bwd_dq.launches, FA.attention_flash_bwd_dkv.launches)
    dq = FA.attention_flash_bwd_dq(q, k, v, mask, dout, lse, di, 0.25)
    dk, dv = FA.attention_flash_bwd_dkv(q, k, v, mask, dout, lse, di, 0.25)
    assert (FA.attention_flash_bwd_dq.launches, FA.attention_flash_bwd_dkv.launches) == before
    want = FA.attention_flash_bwd_plain(q, k, v, mask, out, lse, dout, 0.25)
    for got, ref in zip((dq, dk, dv), want):
        assert torch.equal(got, ref)


def test_trunk_attention_keeps_lse_only_when_a_gradient_is_taken(monkeypatch):
    """The trunk's flash attention (``qwen3._attention_flash``) serves
    without lse (grad mode off, or no input needing a gradient) and goes
    through ``FlashAttention``, with lse, when a gradient is taken."""
    from lean_explore_tpu_torch.models import qwen3 as tq

    calls = []
    real = FA.attention_flash

    def spy(*args, with_lse=False):
        calls.append(with_lse)
        return real(*args, with_lse=with_lse)

    monkeypatch.setattr(FA, "attention_flash", spy)
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 64, 2, 1, 8, seed=2))
    mask = torch.ones(1, 64, dtype=torch.int32)
    assert not tq._attention_flash(q, k, v, mask).requires_grad
    q.requires_grad_()
    with torch.no_grad():
        assert not tq._attention_flash(q, k, v, mask).requires_grad
    assert tq._attention_flash(q, k, v, mask).requires_grad
    assert calls == [False, False, True]
