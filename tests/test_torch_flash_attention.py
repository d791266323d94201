"""The plain flash attention (the CUDA kernel's twin) vs the JAX trunk's
``_attention_flash``, which calls the Pallas TPU flash attention; here it
runs in Pallas's TPU interpret mode on the CPU (``force_tpu_interpret_mode``),
with the JAX package unchanged.

Same seeded numpy inputs on both sides, compared on valid rows only (the
JAX docstring leaves pad rows unspecified). Tolerances:

- bf16: both take QK^T in f32 from the same bf16 values and the softmax in
  f32, but round the probabilities to bf16 at different places (JAX rounds
  exp(s - m) before PV, the twin the normalised probabilities), each within
  2^-9 of p, so the two PV sums differ by at most 2^-8 * max|v|; each output
  is then rounded to bf16, half an ulp each, 2^-7 * max|out| for the two:
  tol = 2^-8 * max|v| + 2^-7 * max|out|.
- float32: the same arithmetic in f32 summed in other orders, and exp
  against the TPU kernel's rescaled running sums: scores of magnitude
  <= 10 at these widths carry ~1e-6 of error, so outputs agree within 1e-5.

The kernel itself runs only on the card: tests/test_torch_cuda.py holds it
against the twin there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lean_explore_tpu.models import qwen3 as jq
from lean_explore_tpu_torch.models import qwen3 as tq
from lean_explore_tpu_torch.ops import flash_attention as FA

DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16), "float32": (jnp.float32, torch.float32)}


def _inputs(b, t, nq, nkv, dh, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, nq, dh)).astype(np.float32)
    k = rng.standard_normal((b, t, nkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, t, nkv, dh)).astype(np.float32)
    return q, k, v


def _masks(b, t):
    full = np.ones((b, t), dtype=np.int32)
    right = full.copy()
    right[0, 100:] = 0
    right[-1, 1:] = 0  # one valid token
    return {"full": full, "right_padded": right}


def _tol(dtype, v, out):
    if dtype == "float32":
        return 1e-5
    return 2.0**-8 * float(np.abs(v).max()) + 2.0**-7 * float(np.abs(out).max())


@pytest.mark.parametrize("mask_kind", ["full", "right_padded"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_plain_matches_jax_flash(dtype, mask_kind):
    b, t, nq, nkv, dh = 2, 256, 4, 2, 64 if dtype == "bfloat16" else 16
    q, k, v = _inputs(b, t, nq, nkv, dh, seed=t + dh)
    mask = _masks(b, t)[mask_kind]
    jdt, tdt = DTYPES[dtype]
    with pltpu.force_tpu_interpret_mode():
        want = jq._attention_flash(
            jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
            jnp.asarray(mask),
        )
    want = np.asarray(want.astype(jnp.float32))

    def t_(x):
        return torch.from_numpy(x).to(tdt)

    got = FA.attention_flash(t_(q), t_(k), t_(v), torch.from_numpy(mask), dh**-0.5)
    assert got.dtype == tdt and got.shape == (b, t, nq * dh)
    got = got.float().numpy()
    valid = mask.astype(bool)
    vq = t_(v).float().numpy()
    np.testing.assert_allclose(
        got[valid], want[valid], atol=_tol(dtype, vq, want[valid]), rtol=0
    )
    assert np.isfinite(got).all()


@pytest.mark.parametrize("nq,nkv", [(4, 2), (4, 4), (6, 1)])
def test_plain_matches_the_einsum_attention_on_valid_rows(nq, nkv):
    """Within the port, flash and the trunk's einsum attention (additive
    -1e9 bias) agree on valid rows, with right and left padding: a valid
    query sees the same keys either way. Both in f32; tolerance 1e-5."""
    b, t, dh = 3, 64, 8
    q, k, v = (torch.from_numpy(x) for x in _inputs(b, t, nq, nkv, dh, seed=nq + nkv))
    mask = torch.ones(b, t, dtype=torch.int32)
    mask[0, 40:] = 0
    mask[1, :20] = 0
    allowed = torch.tril(torch.ones(t, t, dtype=torch.bool))[None, None]
    bias = tq._additive_bias(allowed & mask.bool()[:, None, None, :])
    want = tq._attention(q, k, v, bias)
    got = FA.attention_flash(q, k, v, mask, dh**-0.5)
    valid = mask.bool()
    torch.testing.assert_close(got[valid], want[valid], atol=1e-5, rtol=0)


def test_segments_and_causality():
    """A query sees exactly the earlier-or-same keys of its own segment:
    changing a later key, or a key of another segment, leaves it alone."""
    b, t, nq, dh = 1, 16, 2, 4
    q, k, v = (torch.from_numpy(x) for x in _inputs(b, t, nq, 1, dh, seed=5))
    mask = torch.tensor([[1] * 10 + [0] * 6], dtype=torch.int32)
    base = FA.attention_flash_plain(q, k, v, mask, 0.5)
    v2 = v.clone()
    v2[0, 12] += 10.0  # a pad key: no valid query sees it
    v2[0, 7] += 10.0  # a valid key: queries >= 7 see it, pad queries do not
    moved = FA.attention_flash_plain(q, k, v2, mask, 0.5)
    changed = (moved - base).abs().amax(dim=-1)[0] > 0
    assert changed.tolist() == [False] * 7 + [True] * 3 + [False, False] + [True] * 4
    assert FA.allowed_keys(mask)[0].sum(dim=1).tolist() == list(range(1, 11)) + list(
        range(1, 7)
    )


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 64, 4, 2, 8, seed=1))
    mask = torch.ones(2, 64, dtype=torch.int32)
    before = FA.attention_flash.launches
    got = FA.attention_flash(q, k, v, mask, 0.25)
    assert FA.attention_flash.launches == before
    assert torch.equal(got, FA.attention_flash_plain(q, k, v, mask, 0.25))
