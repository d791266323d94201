"""The plain bin_topk (the CUDA kernel's twin) vs the JAX Pallas kernel.

Same numpy inputs (seeded) through ``pallas_bin_topk(..., interpret=True,
exact_epilogue=True)`` and the port's ``bin_topk`` on CPU tensors, with the
cases of tests/ops/test_dense.py. Tolerance: both pack the same f32 scores,
so they differ only where the two f32 sum orders put a score on different
sides of a packing-quantum edge: scores agree within two quanta
(2^steal_bits ulps of [2, 4)) plus 1e-6, and ids are equal wherever the
score is not tied (the two top-k routines order exact ties differently).

The kernel itself runs only on the card: tests/test_torch_cuda.py holds it
against the plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lean_explore_tpu.ops.pallas_retrieval import pallas_bin_topk
from lean_explore_tpu_torch.ops import bin_topk as K
from lean_explore_tpu_torch.ops.dense import dense_topk
from tests.conftest import random_unit_rows


def _both(corpus, queries, n_valid, k, bins, tile_rows):
    want_s, want_i = pallas_bin_topk(
        jnp.asarray(queries), jnp.asarray(corpus), jnp.int32(n_valid),
        k=k, bins=bins, tile_rows=tile_rows, interpret=True, exact_epilogue=True,
    )
    got_s, got_i = K.bin_topk(
        torch.from_numpy(queries), torch.from_numpy(corpus), n_valid, k=k, bins=bins
    )
    steal = K.steal_bits_for(corpus.shape[0], bins)
    atol = 2.0 * 2.0 ** (steal - 22) + 1e-6
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=atol, rtol=0)
    want_s, want_i = np.asarray(want_s), np.asarray(want_i)
    for row_s, row_want, row_got in zip(want_s, want_i, got_i.numpy()):
        values, counts = np.unique(row_s, return_counts=True)
        untied = np.isin(row_s, values[counts == 1])
        np.testing.assert_array_equal(row_got[untied], row_want[untied])
    return got_s.numpy(), got_i.numpy()


@pytest.mark.parametrize("n,b,k", [(512, 8, 16), (1024, 4, 64)])
def test_exact_when_bins_cover_corpus(n, b, k):
    corpus = random_unit_rows(n, 128, seed=n)
    queries = random_unit_rows(b, 128, seed=n + 1)
    scores, idx = _both(corpus, queries, n, k, bins=1024, tile_rows=256)
    exact = queries.astype(np.float64) @ corpus.astype(np.float64).T
    want = np.argsort(-exact, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(idx, want)


def test_provenance_invariant():
    n, b, k = 2048, 4, 32
    corpus = random_unit_rows(n, 64, seed=1)
    queries = random_unit_rows(b, 64, seed=2)
    scores, idx = _both(corpus, queries, n, k, bins=512, tile_rows=256)
    assert idx.min() >= 0 and idx.max() < n
    for q in range(b):
        np.testing.assert_allclose(scores[q], queries[q] @ corpus[idx[q]].T, atol=5e-4)
    assert np.all(np.diff(scores, axis=1) <= 1e-6)


def test_scores_below_minus3_degrade_safely():
    n, dim, k = 512, 32, 8
    corpus = np.zeros((n, dim), dtype=np.float32)
    q = np.zeros((4, dim), dtype=np.float32)
    q[:, 0] = 1.0
    corpus[:, 0] = -5.0
    winners = [7, 130, 300]
    for rank, row in enumerate(winners):
        corpus[row, 0] = 0.9 - 0.1 * rank
    scores, idx = _both(corpus, q, n, k, bins=256, tile_rows=128)
    assert idx[0, :3].tolist() == winners
    np.testing.assert_allclose(scores[0, :3], [0.9, 0.8, 0.7], atol=5e-4)
    assert np.all(scores[0, 3:] <= -2.99)
    assert np.all((idx >= 0) & (idx < n))


def test_partial_final_supertile():
    n, b, k, bins = 2560, 4, 32, 1024
    corpus = random_unit_rows(n, 64, seed=40)
    queries = random_unit_rows(b, 64, seed=41)
    corpus[2300] = queries[0]
    scores, idx = _both(corpus, queries, n, k, bins=bins, tile_rows=512)
    assert idx[0, 0] == 2300
    np.testing.assert_allclose(scores[0, 0], 1.0, atol=5e-4)


def test_padding_never_selected():
    corpus = np.zeros((512, 64), dtype=np.float32)
    corpus[:300] = -np.abs(random_unit_rows(300, 64, seed=5))
    queries = np.abs(random_unit_rows(2, 64, seed=6))
    scores, idx = _both(corpus, queries, 300, 16, bins=512, tile_rows=256)
    assert idx.max() < 300
    assert np.all(scores < 0)


def test_single_query():
    corpus = random_unit_rows(1024, 64, seed=12)
    queries = random_unit_rows(1, 64, seed=13)
    _both(corpus, queries, 1000, 24, bins=512, tile_rows=256)


def test_k_exceeding_bins():
    corpus = torch.from_numpy(random_unit_rows(300, 64, seed=9))
    queries = torch.from_numpy(random_unit_rows(2, 64, seed=10))
    with pytest.raises(ValueError, match="exceeds bins"):
        K.bin_topk(queries, corpus, 300, k=600, bins=512)
    # The dispatch falls back to the exact full scan, as the JAX one does.
    scores, idx = dense_topk(queries, corpus, 280, method="bin_topk")
    want = torch.topk(queries @ corpus.T, 280, dim=1)
    np.testing.assert_array_equal(idx.numpy(), want.indices.numpy())


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    corpus = torch.from_numpy(random_unit_rows(512, 64, seed=3))
    queries = torch.from_numpy(random_unit_rows(3, 64, seed=4))
    before = K.bin_topk_carry.launches
    packed = K.bin_topk_carry(queries, corpus, 500, 256)
    assert K.bin_topk_carry.launches == before
    want = K.bin_topk_carry_plain(queries, corpus, 500, 256, K.steal_bits_for(512, 256))
    assert torch.equal(packed, want)
    assert packed.shape == (256, 3)



# ----------------------------------------------------------------------
# A float32 corpus: the kernel takes it as 3xTF32 at 32 values per stage
# ----------------------------------------------------------------------


@pytest.mark.parametrize(
    "case,dim", [("planted", 32), ("single query", 96), ("partial super-tile", 32),
                 ("padding", 96)],
)
def test_f32_corpus_at_the_f32_stage_depth(case, dim):
    """The four cases of the card's check at depths the f32 kernel takes
    (multiples of 32) and the bf16 one does not: the f32 plain carry vs the
    JAX kernel on the same f32 corpus, at HIGHEST precision."""
    n, b, k, bins = 2560, 4, 24, 1024
    corpus = random_unit_rows(n, dim, seed=dim + 1)
    queries = random_unit_rows(b, dim, seed=dim + 2)
    n_valid = n
    if case == "planted":
        corpus[2300] = queries[0]
    if case == "single query":
        queries = queries[:1]
    if case == "partial super-tile":
        n_valid = 2100
    if case == "padding":
        corpus[:n_valid] = -np.abs(corpus[:n_valid])
        queries = np.abs(queries)
        corpus[2000:] = 0.0
        n_valid = 2000
    scores, idx = _both(corpus, queries, n_valid, k, bins=bins, tile_rows=512)
    assert idx.max() < n_valid
    if case == "planted":
        assert idx[0, 0] == 2300
    if case == "padding":
        assert np.all(scores < 0)
    assert K.depth_multiple(torch.float32) == 32 and dim % 32 == 0


def _tf32_rna(x: np.ndarray) -> np.ndarray:
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away from
    zero: cvt.rna.tf32.f32."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def test_3xtf32_products_within_the_split_bound():
    """The f32 kernel's product, emulated exactly: hi = tf32(x),
    lo = tf32(x - hi), x*y taken as lo*hi + hi*lo + hi*hi (lo*lo dropped).
    Summed in f64, every inner product of unit rows lies within
    3 * 2^-22 * sum|x y| of the exact one: the split term of the f32
    tolerance that ops.bin_topk.score_tolerance derives."""
    x = random_unit_rows(64, 1024, seed=21)
    y = random_unit_rows(32, 1024, seed=22)
    x[0] = y[0]  # a self match

    def split(a):
        hi = _tf32_rna(a)
        return hi.astype(np.float64), _tf32_rna(a - hi).astype(np.float64)

    xh, xl = split(x)
    yh, yl = split(y)
    approx = xl @ yh.T + xh @ yl.T + xh @ yh.T
    exact = x.astype(np.float64) @ y.astype(np.float64).T
    bound = 3 * 2.0**-22 * (np.abs(x).astype(np.float64) @ np.abs(y).astype(np.float64).T)
    assert np.all(np.abs(approx - exact) <= bound)
    assert np.abs(approx - exact).max() > 0  # the split is not exact
    # Summed in f32 (as the tensor cores sum, in another order), within the
    # whole f32 tolerance of the exact products.
    f32_sum = sum(
        (a.astype(np.float32) @ b.astype(np.float32).T).astype(np.float64)
        for a, b in ((xl, yh), (xh, yl), (xh, yh))
    )
    assert np.abs(f32_sum - exact).max() <= K.score_tolerance(torch.float32, 1024)
    assert K.score_tolerance(torch.bfloat16, 1024) == 2 * 1024 * 2.0**-24


def test_kernel_entries_and_stage_depths():
    assert set(K.KERNEL_ENTRIES) == {torch.bfloat16, torch.float32}
    assert K.depth_multiple(torch.bfloat16) == 64
    assert K.depth_multiple(torch.float32) == 32
    assert K.depth_multiple(torch.int8) == 128
