"""Port dense_topk / DenseIndex vs the JAX package on the same numpy inputs.

Float32 on the CPU: the full scan is exact on both sides, so ids must be
equal away from exact ties and scores agree to 1e-5 (two f32 sum orders
over 64-dim unit rows). The plain bin-max scan (``fused``) makes the same
bin-survivorship choices as the JAX scan on the same scores. Every method
name of the JAX package is accepted: ``approx`` and ``chunked`` are exact
off a TPU, ``fused_pallas`` packs scores (a quantum of at most 2^-21, far
inside 1e-5) and ``windowed`` is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lean_explore_tpu.index.dense import DenseIndex as JaxDenseIndex
from lean_explore_tpu.ops import dense_topk as jax_dense_topk
from lean_explore_tpu_torch.index.dense import ROW_ALIGN, DenseIndex
from lean_explore_tpu_torch.ops.dense import dense_topk, l2_normalize, pad_rows
from tests.conftest import random_unit_rows


def _compare(got, want, atol=1e-5):
    got_s, got_i = (t.numpy() for t in got)
    want_s, want_i = (np.asarray(a) for a in want)
    np.testing.assert_allclose(got_s, want_s, atol=atol, rtol=0)
    np.testing.assert_array_equal(got_i, want_i)


@pytest.mark.parametrize(
    "method", ["full", "fused", "approx", "chunked", "fused_pallas", "windowed"]
)
@pytest.mark.parametrize("n,b,k", [(500, 4, 10), (3000, 16, 100), (257, 1, 7)])
def test_dense_topk_matches_jax(method, n, b, k):
    corpus = random_unit_rows(n, 64, seed=n)
    queries = random_unit_rows(b, 64, seed=n + 1)
    got = dense_topk(torch.from_numpy(queries), torch.from_numpy(corpus), k, method=method)
    want = jax_dense_topk(jnp.asarray(queries), jnp.asarray(corpus), k, method=method)
    _compare(got, want)


@pytest.mark.parametrize("method", ["full", "fused", "auto"])
def test_padding_never_selected(method):
    rng = np.random.default_rng(3)
    corpus = -np.abs(rng.standard_normal((100, 32))).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    queries = np.abs(rng.standard_normal((2, 32))).astype(np.float32)
    padded, n_valid = pad_rows(torch.from_numpy(corpus), 128)
    scores, idx = dense_topk(
        torch.from_numpy(queries), padded, 10, n_valid=n_valid, method=method
    )
    assert int(idx.max()) < 100
    assert bool((scores < 0).all())


def test_auto_on_cpu_is_the_exact_scan():
    """Off the card, auto takes the exact full scan at any size."""
    corpus = torch.from_numpy(random_unit_rows(20_000, 16, seed=1))
    queries = torch.from_numpy(random_unit_rows(3, 16, seed=2))
    got = dense_topk(queries, corpus, 5)
    want = torch.topk(queries @ corpus.T, 5, dim=1)
    np.testing.assert_array_equal(got[1].numpy(), want.indices.numpy())


def test_k_exceeds_corpus():
    with pytest.raises(ValueError, match="exceeds"):
        dense_topk(torch.zeros(1, 4), torch.zeros(3, 4), 5)


def test_l2_normalize_and_pad_rows():
    x = torch.tensor([[3.0, 4.0], [0.0, 0.0]])
    np.testing.assert_allclose(l2_normalize(x).numpy(), [[0.6, 0.8], [0.0, 0.0]])
    padded, n = pad_rows(torch.ones(5, 2), 4)
    assert n == 5 and padded.shape == (8, 2) and float(padded[5:].abs().sum()) == 0


@pytest.mark.parametrize("batch", [1, 3, 16])
def test_dense_index_search_matches_jax(tmp_path, batch):
    n, dim, k = 700, 64, 12
    rng = np.random.default_rng(batch)
    emb = rng.standard_normal((n, dim)).astype(np.float32)
    ids = np.arange(100, 100 + n, dtype=np.int64)
    jax_index = JaxDenseIndex.build(emb, ids, dtype="float32")
    jax_index.save(tmp_path)
    index = DenseIndex.load(tmp_path, dtype="float32", device="cpu")
    assert index.embeddings.shape[0] % ROW_ALIGN == 0 and index.n == n
    queries = rng.standard_normal((batch, dim)).astype(np.float32)
    got_s, got_ids = index.search(torch.from_numpy(queries), k)
    want_s, want_ids = jax_index.search(queries, k)
    np.testing.assert_allclose(got_s, want_s, atol=1e-5)
    np.testing.assert_array_equal(got_ids, want_ids)


def test_dense_index_build_bfloat16():
    emb = random_unit_rows(40, 16, seed=7)
    index = DenseIndex.build(emb, np.arange(40), dtype="bfloat16", device="cpu")
    assert index.embeddings.dtype == torch.bfloat16
    scores, ids = index.search(emb[:2], 1)
    np.testing.assert_array_equal(ids[:, 0], [0, 1])
    with pytest.raises(ValueError, match="float16"):
        DenseIndex.build(emb, np.arange(40), dtype="float16", device="cpu")


@pytest.mark.parametrize("batch,method", [(1, "auto"), (3, "full"), (16, "fused_pallas")])
def test_dense_index_int8_matches_jax(tmp_path, batch, method):
    """An int8 index built from the same artifacts: the same codes and
    scales, and (the exact quantized scan on both sides off the card) the
    same ids, scores within 1e-6."""
    n, dim, k = 700, 64, 12
    rng = np.random.default_rng(batch + 40)
    emb = rng.standard_normal((n, dim)).astype(np.float32)
    ids = np.arange(100, 100 + n, dtype=np.int64)
    JaxDenseIndex.build(emb, ids, dtype="float32").save(tmp_path)
    jax_index = JaxDenseIndex.load(tmp_path, dtype="int8")
    index = DenseIndex.load(tmp_path, dtype="int8", device="cpu")
    assert index.embeddings.dtype == torch.int8 and index.n == n
    np.testing.assert_array_equal(index.embeddings.numpy(), np.asarray(jax_index.embeddings))
    np.testing.assert_array_equal(index.scales.numpy(), np.asarray(jax_index.scales))
    np.testing.assert_allclose(
        index.row_embeddings(), jax_index.row_embeddings(), atol=0, rtol=0
    )
    queries = rng.standard_normal((batch, dim)).astype(np.float32)
    got_s, got_ids = index.search(torch.from_numpy(queries), k, method=method)
    want_s, want_ids = jax_index.search(queries, k, method=method)
    np.testing.assert_allclose(got_s, want_s, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got_ids, want_ids)


def test_unknown_method_raises():
    index = DenseIndex.build(random_unit_rows(40, 16, seed=8), np.arange(40), dtype="int8", device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        index.search(np.ones((1, 16), dtype=np.float32), 3, method="nope")
    with pytest.raises(ValueError, match="unknown method"):
        dense_topk(torch.ones(1, 16), torch.ones(40, 16), 3, method="nope")
