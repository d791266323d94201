"""The port's int8 quantization (ops/quant.py) vs the JAX package's.

Same seeded numpy inputs through both. Quantization is elementwise f32
arithmetic with round-half-to-even on both sides, so codes and scales are
bit-identical. ``quantized_topk`` takes exact integer products and the same
multiplication order, so ids are equal and scores agree within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lean_explore_tpu.ops.quant import _quantize_rows_device
from lean_explore_tpu.ops.quant import quantize_rows as jax_quantize_rows
from lean_explore_tpu.ops.quant import quantized_topk as jax_quantized_topk
from lean_explore_tpu_torch.ops.quant import (
    quantize_rows,
    quantize_rows_device,
    quantized_topk,
)
from tests.conftest import random_unit_rows


def _matrix(seed: int) -> np.ndarray:
    m = random_unit_rows(40, 48, seed=seed)
    m[3] = 0.0  # zero row: scale 1, zero codes
    m[5, :4] = [0.5, -0.5, 1.5 / 127, 2.5 / 127]  # values near .5 steps
    return m


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_rows_bit_identical(seed):
    m = _matrix(seed)
    codes, scales = quantize_rows(m)
    want_codes, want_scales = jax_quantize_rows(m)
    assert codes.dtype == np.int8 and scales.dtype == np.float32
    np.testing.assert_array_equal(codes, want_codes)
    np.testing.assert_array_equal(scales, want_scales)
    assert scales[3] == 1.0 and not codes[3].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_rows_device_bit_identical(seed):
    m = _matrix(seed) * 3.0
    codes, scales = quantize_rows_device(torch.from_numpy(m))
    want_codes, want_scales = _quantize_rows_device(jnp.asarray(m))
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(want_scales))
    # The host and device versions agree with each other too.
    host_codes, host_scales = quantize_rows(m)
    np.testing.assert_array_equal(codes.numpy(), host_codes)
    np.testing.assert_array_equal(scales.numpy(), host_scales)


def test_round_half_to_even():
    m = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5]], dtype=np.float32)
    codes, _ = quantize_rows_device(torch.from_numpy(m))
    assert codes.tolist() == [[127, 0, 2, 2, 0, -2]]


@pytest.mark.parametrize("n,n_valid,b,k", [(512, 512, 4, 16), (1024, 900, 3, 50), (64, 40, 1, 40)])
def test_quantized_topk_matches_jax(n, n_valid, b, k):
    corpus = random_unit_rows(n, 64, seed=n)
    queries = random_unit_rows(b, 64, seed=n + 7)
    codes, scales = quantize_rows(corpus)
    got_s, got_i = quantized_topk(
        torch.from_numpy(queries), torch.from_numpy(codes), torch.from_numpy(scales),
        n_valid, k=k,
    )
    want_s, want_i = jax_quantized_topk(
        jnp.asarray(queries), jnp.asarray(codes), jnp.asarray(scales),
        jnp.int32(n_valid), k=k, exact=True,
    )
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-6, rtol=0)
    assert int(got_i.max()) < n_valid
