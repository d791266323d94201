"""The plain int8 bin_topk (the CUDA kernel's twin) vs the JAX Pallas kernel.

Same seeded numpy inputs through ``pallas_bin_topk_int8(...,
exact_epilogue=True, interpret=True)`` and the port's ``bin_topk_int8`` on
CPU tensors, with the cases of tests/ops/test_dense.py
(``TestPallasBinTopKInt8``). The int8 products are exact integers on both
sides and are scaled in the same order, but XLA's CPU backend contracts the
JAX kernel's ``(raw * row_scale) * query_scale + 3`` into one FMA, where the
port rounds the multiply and the add apart (as its CUDA kernel does, so that
kernel and twin agree bit for bit). Before the +3 the two differ by at most
half an ulp of a score in [-1, 1] (2^-24), less than the 2^-22 spacing of
[2, 4), so after rounding into [2, 4) they differ by at most one step and
after packing by at most one packing quantum (2^steal_bits steps of 2^-22).
Scores agree within that quantum; an id may differ only where the two rows'
calibrated scores lie within it (a near tie in one bin or at the cut).

The kernel itself runs only on the card: tests/test_torch_cuda.py holds it
against the plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lean_explore_tpu.ops.pallas_retrieval import pallas_bin_topk_int8
from lean_explore_tpu.ops.quant import quantize_rows
from lean_explore_tpu_torch.index.dense import DenseIndex
from lean_explore_tpu_torch.ops import bin_topk_int8 as K
from lean_explore_tpu_torch.ops.quant import quantized_topk
from tests.conftest import random_unit_rows


def _both(corpus, queries, n_valid, k, bins, tile_rows):
    codes, scales = quantize_rows(corpus)
    want_s, want_i = pallas_bin_topk_int8(
        jnp.asarray(queries), jnp.asarray(codes), jnp.asarray(scales),
        jnp.int32(n_valid), k=k, bins=bins, tile_rows=tile_rows,
        exact_epilogue=True, interpret=True,
    )
    got_s, got_i = K.bin_topk_int8(
        torch.from_numpy(queries), torch.from_numpy(codes), torch.from_numpy(scales),
        n_valid, k=k, bins=bins,
    )
    got_s, got_i = got_s.numpy(), got_i.numpy()
    want_s, want_i = np.asarray(want_s), np.asarray(want_i)
    quantum = 2.0 ** (K.steal_bits_for(corpus.shape[0], bins) - 22)
    np.testing.assert_allclose(got_s, want_s, atol=quantum, rtol=0)
    for q in range(queries.shape[0]):
        differ = got_i[q] != want_i[q]
        gap = _calibrated(queries, codes, scales, q, got_i[q][differ]) - _calibrated(
            queries, codes, scales, q, want_i[q][differ]
        )
        assert np.all(np.abs(gap) <= quantum + 1e-6), (q, gap)
    return got_s, got_i, codes, scales


def _calibrated(queries, codes, scales, q, rows):
    """Calibrated int8 inner products of query q with the given rows."""
    deq = codes.astype(np.float32) * scales[:, None]
    q_abs = np.abs(queries).max(axis=1)
    q_scales = np.where(q_abs > 0, q_abs / 127.0, 1.0)
    q_codes = np.clip(np.rint(queries / q_scales[:, None]), -127, 127)
    return (q_codes[q] * q_scales[q]) @ deq[rows].T


def test_matches_quantized_exact_when_bins_cover_corpus():
    n, b, k = 1024, 4, 32
    corpus = random_unit_rows(n, 64, seed=20)
    queries = random_unit_rows(b, 64, seed=21)
    scores, idx, codes, scales = _both(corpus, queries, n, k, bins=1024, tile_rows=256)
    want_s, want_i = quantized_topk(
        torch.from_numpy(queries), torch.from_numpy(codes), torch.from_numpy(scales),
        n, k=k,
    )
    # bins >= n: no bin collisions, so only the packing quantum separates them.
    quantum = 2.0 ** (K.steal_bits_for(n, 1024) - 22)
    np.testing.assert_allclose(scores, want_s.numpy(), atol=2 * quantum, rtol=0)
    overlap = np.mean([len(set(idx[q]) & set(want_i.numpy()[q])) / k for q in range(b)])
    assert overlap >= 0.95  # packing may swap near-exact ties


@pytest.mark.parametrize(
    "n,n_valid,batch,bins",
    [
        # bins % 128 == 64: the CUDA kernel's last block has a warpgroup
        # past the bins; N % 128 == 64: its last super-tile ends inside a block
        (192 * 10 + 64, 192 * 10, 1, 192),
        (64 * 33, 64 * 33 - 17, 37, 64),
        (64 * 17, 1000, 200, 192),
        # B = 129: a second query block of one; bins = 4160, a half slice of
        # 128, and a partial final super-tile
        (4160 * 2 + 64, 4160 + 100, 129, 4160),
    ],
)
def test_kernel_edge_shapes(n, n_valid, batch, bins):
    """The shapes at the edges of the CUDA kernel's blocks (tests/test_torch_cuda.py
    holds the kernel to the twin there bit for bit), the twin against the
    JAX kernel within the packing quantum; every returned row real."""
    corpus = random_unit_rows(n, 128, seed=n)
    queries = random_unit_rows(batch, 128, seed=n + batch)
    corpus[n_valid:] = 0.0
    scores, idx, _, _ = _both(corpus, queries, n_valid, 16, bins=bins, tile_rows=64)
    assert scores.shape == (batch, 16)
    assert idx.min() >= 0 and idx.max() < n_valid


def test_partial_final_supertile():
    n, b, k = 2560, 3, 16
    corpus = random_unit_rows(n, 64, seed=42)
    queries = random_unit_rows(b, 64, seed=43)
    corpus[2300] = queries[0]
    scores, idx, codes, scales = _both(corpus, queries, n, k, bins=1024, tile_rows=512)
    assert idx[0, 0] == 2300
    assert idx.min() >= 0 and idx.max() < n
    for q in range(b):
        np.testing.assert_allclose(
            scores[q], _calibrated(queries, codes, scales, q, idx[q]), atol=5e-4
        )


def test_provenance_invariant():
    n, b, k = 2048, 3, 16
    corpus = random_unit_rows(n, 64, seed=22)
    queries = random_unit_rows(b, 64, seed=23)
    scores, idx, codes, scales = _both(corpus, queries, n, k, bins=512, tile_rows=256)
    assert idx.min() >= 0 and idx.max() < n
    for q in range(b):
        np.testing.assert_allclose(
            scores[q], _calibrated(queries, codes, scales, q, idx[q]), atol=5e-4
        )


def test_single_query():
    corpus = random_unit_rows(512, 64, seed=32)
    queries = random_unit_rows(1, 64, seed=33)
    scores, idx, _, _ = _both(corpus, queries, 512, 5, bins=512, tile_rows=256)
    assert scores.shape == (1, 5) and idx.max() < 512


def test_padding_never_selected():
    corpus = np.zeros((1024, 64), dtype=np.float32)
    corpus[:700] = -np.abs(random_unit_rows(700, 64, seed=5))
    queries = np.abs(random_unit_rows(2, 64, seed=6))
    scores, idx, _, _ = _both(corpus, queries, 700, 16, bins=512, tile_rows=256)
    assert idx.max() < 700
    assert np.all(scores < 0)


def test_k_exceeding_bins():
    codes, scales = quantize_rows(random_unit_rows(512, 64, seed=9))
    queries = torch.from_numpy(random_unit_rows(2, 64, seed=10))
    with pytest.raises(ValueError, match="exceeds bins"):
        K.bin_topk_int8(
            queries, torch.from_numpy(codes), torch.from_numpy(scales), 512,
            k=600, bins=512,
        )


def test_index_k_exceeding_bins_takes_the_exact_scan():
    """k > bins: the int8 index answers with the exact quantized scan, as
    the JAX index does (lean_explore_tpu/index/dense.py:193)."""
    emb = random_unit_rows(3000, 64, seed=11)
    index = DenseIndex.build(emb, np.arange(3000), dtype="int8", device="cpu")
    queries = torch.from_numpy(random_unit_rows(2, 64, seed=12))
    _, ids = index.search(queries, 2000, method="fused_pallas")
    want_s, want_i = quantized_topk(
        queries, index.embeddings, index.scales, index.n, k=2000
    )
    np.testing.assert_array_equal(ids, want_i.numpy())


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    codes, scales = quantize_rows(random_unit_rows(512, 64, seed=3))
    q_codes, q_scales = quantize_rows(random_unit_rows(3, 64, seed=4))
    args = [torch.from_numpy(a) for a in (q_codes, q_scales, codes, scales)]
    before = K.bin_topk_int8_carry.launches
    packed = K.bin_topk_int8_carry(*args, 500, 256)
    assert K.bin_topk_int8_carry.launches == before
    want = K.bin_topk_int8_carry_plain(*args, 500, 256, K.steal_bits_for(512, 256))
    assert torch.equal(packed, want)
    assert packed.shape == (256, 3)


def test_plain_carry_rounds_each_step_apart():
    """The twin's packed carry equals a numpy carry built with each f32
    step rounded apart: raw * row_scale, * query_scale, + 3, floor, pack."""
    n, bins, n_valid = 1536, 512, 1400
    codes, scales = quantize_rows(random_unit_rows(n, 64, seed=14))
    q_codes, q_scales = quantize_rows(random_unit_rows(5, 64, seed=15))
    steal = K.steal_bits_for(n, bins)
    raw = codes.astype(np.int64) @ q_codes.astype(np.int64).T
    s = raw.astype(np.float32) * scales[:, None] * q_scales[None, :]
    shifted = np.maximum(s + np.float32(3.0), np.float32(1e-30))
    shifted[n_valid:] = 0.0
    low = (1 << steal) - 1
    supertile = (np.arange(n, dtype=np.int32) // bins)[:, None]
    bits = (shifted.view(np.int32) & ~low) | supertile
    want = bits.view(np.float32).reshape(n // bins, bins, 5).max(axis=0)
    got = K.bin_topk_int8_carry(
        *(torch.from_numpy(a) for a in (q_codes, q_scales, codes, scales)),
        n_valid, bins,
    )
    np.testing.assert_array_equal(got.numpy(), want)
