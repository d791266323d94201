"""The plain fused scores + window maxima (the CUDA kernel's twin) and the
exact windowed top-k vs the JAX package.

Same seeded numpy inputs through ``fused_scores_wmax`` /
``pallas_windowed_topk`` (interpret mode) and ``dense_topk(method=
"windowed")`` of the JAX package, and the port's ``ops.windowed`` on CPU
tensors. Tolerances: a float32 corpus gives f32 products on both sides,
summed in other orders, so scores agree within 1e-6 (unit rows of depth
<= 128). A bf16 corpus has bf16 inputs (the same values on both sides,
exact in f32) and f32 sums, so scores agree within twice the f32
dot-product error bound of unit rows of depth D, 2 * D * 2^-24. Ids are
equal wherever the score is not tied.

The kernel itself runs only on the card: tests/test_torch_cuda.py holds it
against the plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lean_explore_tpu.ops import dense_topk as jax_dense_topk
from lean_explore_tpu.ops.pallas_retrieval import (
    fused_scores_wmax as jax_fused_scores_wmax,
)
from lean_explore_tpu.ops.pallas_retrieval import pallas_windowed_topk
from lean_explore_tpu_torch.ops import windowed as W
from lean_explore_tpu_torch.ops.dense import dense_topk
from tests.conftest import random_unit_rows

DIM = 128


def _inputs(n, b, dtype, seed):
    corpus = random_unit_rows(n, DIM, seed=seed)
    queries = random_unit_rows(b, DIM, seed=seed + 1)
    if dtype == "bfloat16":
        return (
            jnp.asarray(corpus).astype(jnp.bfloat16),
            jnp.asarray(queries),
            torch.from_numpy(corpus).to(torch.bfloat16),
            torch.from_numpy(queries),
        )
    return jnp.asarray(corpus), jnp.asarray(queries), torch.from_numpy(corpus), torch.from_numpy(queries)


def _tol(dtype):
    return 1e-6 if dtype == "float32" else 2.0 * DIM * 2.0**-24


def _assert_topk(got, want, tol):
    got_s, got_i = (t.numpy() for t in got)
    want_s, want_i = (np.asarray(a) for a in want)
    np.testing.assert_allclose(got_s, want_s, atol=tol, rtol=0)
    for row_s, row_want, row_got in zip(want_s, want_i, got_i):
        values, counts = np.unique(row_s, return_counts=True)
        untied = np.isin(row_s, values[counts == 1])
        np.testing.assert_array_equal(row_got[untied], row_want[untied])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,n_valid,b,window", [(512, 512, 3, 8), (1024, 1000, 9, 16)])
def test_fused_scores_wmax_matches_jax(dtype, n, n_valid, b, window):
    jc, jq, tc, tq = _inputs(n, b, dtype, seed=n + b)
    want_s, want_w = jax_fused_scores_wmax(
        jq, jc, jnp.int32(n_valid), window=window, tile_rows=256, interpret=True
    )
    got_s, got_w = W.fused_scores_wmax(tq, tc, n_valid, window)
    assert got_s.shape == (n, b) and got_w.shape == (n // window, b)
    want_s, want_w = np.asarray(want_s)[:, :b], np.asarray(want_w)[:, :b]
    np.testing.assert_array_equal(np.isneginf(got_s.numpy()), np.isneginf(want_s))
    finite = np.isfinite(want_s)
    np.testing.assert_allclose(got_s.numpy()[finite], want_s[finite], atol=_tol(dtype), rtol=0)
    np.testing.assert_array_equal(np.isneginf(got_w.numpy()), np.isneginf(want_w))
    finite = np.isfinite(want_w)
    np.testing.assert_allclose(got_w.numpy()[finite], want_w[finite], atol=_tol(dtype), rtol=0)


def test_pad_rows_and_windows_are_masked():
    corpus = np.zeros((256, DIM), dtype=np.float32)
    corpus[:100] = random_unit_rows(100, DIM, seed=9)
    queries = torch.from_numpy(random_unit_rows(2, DIM, seed=10))
    scores_t, wmax_t = W.fused_scores_wmax(queries, torch.from_numpy(corpus), 100, 8)
    assert bool(torch.isneginf(scores_t[100:]).all())
    assert bool(torch.isfinite(scores_t[:100]).all())
    assert bool(torch.isneginf(wmax_t[13:]).all())  # windows past ceil(100/8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,n_valid,b,k,window", [(512, 512, 8, 16, 8), (2048, 2000, 4, 64, 16), (1024, 1024, 1, 10, 8)])
def test_windowed_topk_matches_pallas_windowed_topk(dtype, n, n_valid, b, k, window):
    jc, jq, tc, tq = _inputs(n, b, dtype, seed=n + k)
    want = pallas_windowed_topk(
        jq, jc, jnp.int32(n_valid), k=k, window=window, tile_rows=256, interpret=True
    )
    got = W.windowed_topk(tq, tc, n_valid, k=k, window=window)
    _assert_topk(got, want, _tol(dtype))
    assert int(got[1].max()) < n_valid


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,b,k", [(3000, 16, 100), (700, 3, 12), (257, 2, 40)])
def test_dense_topk_windowed_matches_jax(dtype, n, b, k):
    """The dispatch: padding to the window, and the full scan when k
    windows would cover the corpus (JAX ops/dense.py:451-455)."""
    jc, jq, tc, tq = _inputs(n, b, dtype, seed=n)
    want = jax_dense_topk(jq, jc, k, method="windowed")
    got = dense_topk(tq, tc, k, method="windowed")
    _assert_topk(got, want, _tol(dtype))


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    corpus = torch.from_numpy(random_unit_rows(512, 64, seed=3))
    queries = torch.from_numpy(random_unit_rows(3, 64, seed=4))
    before = W.fused_scores_wmax.launches
    got = W.fused_scores_wmax(queries, corpus, 500, 8)
    assert W.fused_scores_wmax.launches == before
    want = W.fused_scores_wmax_plain(queries, corpus, 500, 8)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("n,n_valid,b,k,window", [(512, 500, 3, 16, 8), (1024, 1024, 1, 10, 16)])
def test_f32_corpus_at_the_f32_stage_depth(n, n_valid, b, k, window):
    """Depth 96: a multiple of the f32 kernel's 32 values per stage and not
    of the bf16 kernel's 64. The f32 plain scores and the windowed top-k vs
    the JAX kernels (interpret mode, HIGHEST precision) on the same f32
    corpus, within 1e-6."""
    dim = 96
    corpus = random_unit_rows(n, dim, seed=n + 3)
    queries = random_unit_rows(b, dim, seed=n + 4)
    want_s, want_w = jax_fused_scores_wmax(
        jnp.asarray(queries), jnp.asarray(corpus), jnp.int32(n_valid),
        window=window, tile_rows=256, interpret=True,
    )
    got_s, got_w = W.fused_scores_wmax(
        torch.from_numpy(queries), torch.from_numpy(corpus), n_valid, window
    )
    for got, want in ((got_s, want_s), (got_w, want_w)):
        want = np.asarray(want)[:, :b]
        np.testing.assert_array_equal(np.isneginf(got.numpy()), np.isneginf(want))
        finite = np.isfinite(want)
        np.testing.assert_allclose(got.numpy()[finite], want[finite], atol=1e-6, rtol=0)
    want = pallas_windowed_topk(
        jnp.asarray(queries), jnp.asarray(corpus), jnp.int32(n_valid), k=k,
        window=window, tile_rows=256, interpret=True,
    )
    got = W.windowed_topk(
        torch.from_numpy(queries), torch.from_numpy(corpus), n_valid, k=k, window=window
    )
    _assert_topk(got, want, 1e-6)
    assert W.KERNEL_ENTRIES[torch.float32] == "windowed_scores_f32"
