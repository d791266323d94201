"""The port's ``ShardedDenseIndex`` (``lean_explore_tpu_torch.parallel``)
against the JAX package's on the same numpy inputs.

JAX runs on the 8 virtual host devices of tests/conftest.py; the port on
8 virtual CPU devices (the same ``XLA_FLAGS`` count), through the plain
twins of K1 and K2 on the CPU. ``fused`` is JAX's ``pallas_bin_topk`` in
interpret mode against the port's plain carry, ``fused_int8`` its int8
twin against K2's.

Tolerance: scores within 1e-5, the JAX tests' own. Both sides take f32
products of the same values (two sum orders over at most 32 terms of unit
rows, within 32 * 2^-24 = 1.9e-6); the kernel methods also truncate each
score to its packing quantum, 2^(steal_bits - 22) with one stolen bit
here (4.8e-7), and K2 may land one quantum apart from JAX's interpret mode
(XLA fuses an FMA; ROADMAP C). Ids are compared as sets per query: ties
may order differently, and the merge is torch's exact top-k where JAX's
is ``approx_max_k`` (exact off a TPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lean_explore_tpu.parallel import ShardedDenseIndex as JaxShardedDenseIndex
from lean_explore_tpu.parallel import make_mesh as jax_make_mesh
from lean_explore_tpu.parallel.sharded import _local_topk_fused as jax_local_topk_fused
from lean_explore_tpu_torch.index.dense import DenseIndex
from lean_explore_tpu_torch.parallel import SERVE_AXES, ShardedDenseIndex, make_mesh
from lean_explore_tpu_torch.parallel.sharded import _local_topk_fused, _shard_bins
from tests.conftest import random_unit_rows
from tests.ops.test_dense import numpy_topk

ATOL = 1e-5


def _pair(corpus, mesh_shape, ids=None, **kw):
    """(port index, JAX index) over the same corpus and mesh shape."""
    ids = np.arange(len(corpus)) if ids is None else ids
    port = ShardedDenseIndex(corpus, ids, make_mesh(mesh_shape), **kw)
    jax_index = JaxShardedDenseIndex(corpus, ids, jax_make_mesh(mesh_shape), **kw)
    return port, jax_index


def _assert_same(got, want, atol=ATOL):
    (got_s, got_i), (want_s, want_i) = got, want
    assert got_s.shape == np.shape(want_s) and got_i.dtype == np.int64
    np.testing.assert_allclose(got_s, np.asarray(want_s), atol=atol, rtol=0)
    for g, w in zip(got_i, np.asarray(want_i)):
        assert set(g.tolist()) == set(w.tolist())


@pytest.mark.parametrize("method", ["chunked", "approx", "fused", "fused_int8"])
@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4), (1, 4)])
def test_matches_jax(mesh_shape, method):
    corpus = random_unit_rows(1000, 32, seed=10)
    queries = random_unit_rows(8, 32, seed=11)
    kw = {"dtype": "int8"} if method == "fused_int8" else {"method": method}
    port, jax_index = _pair(corpus, mesh_shape, ids=np.arange(1000) + 5, **kw)
    assert port.method == jax_index.method == method
    got = port.search(queries, k=20)
    _assert_same(got, jax_index.search(queries, k=20))
    if method in ("chunked", "approx"):  # exact: the numpy oracle too
        ref_scores, ref_rows = numpy_topk(queries, corpus, 20)
        np.testing.assert_allclose(got[0], ref_scores, atol=ATOL)
        for b in range(8):
            assert set(got[1][b]) == set(ref_rows[b] + 5)


def test_uneven_corpus_padding():
    """Rows that do not divide the shard count are padded; padding never
    appears in results."""
    corpus = random_unit_rows(103, 16, seed=12)
    port, jax_index = _pair(corpus, (1, 8))
    queries = random_unit_rows(3, 16, seed=13)
    got = port.search(queries, k=50)
    assert got[1].max() < 103 and np.all(np.isfinite(got[0]))
    _assert_same(got, jax_index.search(queries, k=50))


def test_chunked_shard_rows_not_divisible_by_chunk():
    """625 rows a shard in chunks of 400: the last chunk is short, and no
    row past a shard's end or the corpus's enters a result."""
    corpus = random_unit_rows(1250, 16, seed=40)
    queries = random_unit_rows(4, 16, seed=41)
    port, jax_index = _pair(corpus, (1, 2), chunk=400, method="chunked")
    got = port.search(queries, k=10)
    _assert_same(got, jax_index.search(queries, k=10))
    ref_scores, _ = numpy_topk(queries, corpus, 10)
    np.testing.assert_allclose(got[0], ref_scores, atol=ATOL)


@pytest.mark.parametrize("method", ["fused", "int8"])
def test_k_above_bins_falls_back_to_exact(method):
    """A local k above the shard's bins takes the exact scan (over the
    dequantized shard for int8); k at the bins takes the kernel."""
    corpus = random_unit_rows(2048, 16, seed=42)
    queries = random_unit_rows(2, 16, seed=43)
    kw = {"dtype": "int8"} if method == "int8" else {"method": "fused"}
    port, jax_index = _pair(corpus, (1, 2), **kw)
    assert _shard_bins(port.shard_rows, 2) == 1024
    for k in (1024, 1100):
        _assert_same(port.search(queries, k=k), jax_index.search(queries, k=k))
    port, jax_index = _pair(corpus, (1, 1), **kw)  # 2048 rows > 1024 bins
    _assert_same(port.search(queries, k=1100), jax_index.search(queries, k=1100))


def test_query_batch_not_divisible_by_data_axis():
    corpus = random_unit_rows(64, 16, seed=14)
    port, jax_index = _pair(corpus, (2, 4))
    queries = random_unit_rows(3, 16, seed=15)  # 3 % 2 != 0
    got = port.search(queries, k=5)
    assert got[0].shape == (3, 5)
    _assert_same(got, jax_index.search(queries, k=5))


@pytest.mark.parametrize("method", ["chunked", "approx", "fused"])
def test_k_larger_than_shard(method):
    """k above the rows of a shard (10 here) still gives the exact global
    top-k."""
    corpus = random_unit_rows(80, 16, seed=16)
    port, jax_index = _pair(corpus, (1, 8), method=method)
    queries = random_unit_rows(2, 16, seed=17)
    got = port.search(queries, k=40)
    _assert_same(got, jax_index.search(queries, k=40))
    ref_scores, _ = numpy_topk(queries, corpus, 40)
    np.testing.assert_allclose(got[0], ref_scores, atol=ATOL)


def test_fused_at_the_jax_test_s_size():
    """8,192 rows over (2, 4): each shard's 2,048 rows in one bin pass."""
    corpus = random_unit_rows(8 * 1024, 32, seed=0)
    queries = random_unit_rows(8, 32, seed=1)
    port, jax_index = _pair(corpus, (2, 4), method="fused")
    assert port.shard_rows * 4 % (4 * 512) == 0
    _assert_same(port.search(queries, k=50), jax_index.search(queries, k=50))


@pytest.mark.parametrize("kw", [{"method": "fused"}, {"dtype": "int8"}], ids=["fused", "int8"])
def test_fused_handles_uneven_padding(kw):
    corpus = random_unit_rows(3000, 32, seed=2)  # pads to 4096 over (1, 2)
    queries = random_unit_rows(4, 32, seed=3)
    port, jax_index = _pair(corpus, (1, 2), **kw)
    got = port.search(queries, k=20)
    assert got[1].max() < 3000 and np.all(np.isfinite(got[0]))
    _assert_same(got, jax_index.search(queries, k=20))


def test_fused_masks_partial_shard_sentinels():
    """A shard with fewer valid rows than local k: its packed-zero pad rows
    come back as -inf with global index 0, exactly where JAX's do."""
    dim, k, rows, valid, row_offset = 32, 100, 512, 38, 1536
    shard = np.zeros((rows, dim), dtype=np.float32)
    shard[:valid] = random_unit_rows(valid, dim, seed=44)
    q = random_unit_rows(8, dim, seed=45)
    s, gi = _local_topk_fused(
        torch.from_numpy(q), torch.from_numpy(shard), row_offset, row_offset + valid, k=k
    )
    s, gi = s.numpy(), gi.numpy()
    finite = np.isfinite(s)
    assert finite.sum(axis=1).tolist() == [valid] * 8
    assert np.all(s[finite] >= -1.0 - 1e-3)
    assert np.all(gi[~finite] == 0) and np.all(gi[finite] < row_offset + valid)
    want_s, want_i = jax_local_topk_fused(
        jnp.asarray(q), jnp.asarray(shard), row_offset, jnp.int32(row_offset + valid),
        k=k, recall_target=0.95,
    )
    want_s, want_i = np.asarray(want_s), np.asarray(want_i)
    np.testing.assert_array_equal(np.isfinite(want_s), finite)
    np.testing.assert_allclose(s[finite], want_s[finite], atol=ATOL)
    np.testing.assert_array_equal(gi[~finite], want_i[~finite])
    for g, w, f in zip(gi, want_i, finite):
        assert set(g[f].tolist()) == set(w[f].tolist())


def test_mesh_too_small_raises():
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        make_mesh((4, 4))
    mesh = make_mesh((2, 4), devices=[torch.device("cpu")] * 8)
    assert mesh.shape == {"data": 2, "corpus": 4} and mesh.axis_names == SERVE_AXES


def test_int8_matches_the_single_device_index_and_dequantizes():
    """An int8 index sharded over (2, 4) returns the single-device int8
    index's ids (the same row quantization; the sharded kernel path packs
    scores, the single-device exact scan on the CPU does not) and its
    dequantized rows."""
    corpus = random_unit_rows(300, 16, seed=7)
    sharded = ShardedDenseIndex(corpus, np.arange(300) + 1, make_mesh((2, 4)), dtype="int8")
    single = DenseIndex.build(corpus, np.arange(300) + 1, dtype="int8", device="cpu")
    q = np.random.default_rng(3).standard_normal((5, 16)).astype(np.float32)
    got_s, got_ids = sharded.search(q, k=10)
    want_s, want_ids = single.search(q, k=10)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got_s, want_s, atol=2e-4)
    np.testing.assert_allclose(sharded.row_embeddings(), single.row_embeddings(), atol=1e-7)
    jax_index = JaxShardedDenseIndex(
        corpus, np.arange(300) + 1, jax_make_mesh((2, 4)), dtype="int8"
    )
    np.testing.assert_allclose(sharded.row_embeddings(), jax_index.row_embeddings(), atol=1e-7)


def test_repeated_devices_hold_one_copy_of_each_shard():
    """A mesh that repeats one device places each shard once on it."""
    corpus = random_unit_rows(64, 16, seed=5)
    index = ShardedDenseIndex(corpus, np.arange(64), make_mesh((2, 4)), dtype="bfloat16")
    for c in range(4):
        assert index.shards[0, c] is index.shards[1, c]
        assert index.shards[0, c].dtype == torch.bfloat16
    assert len({id(s) for s in index.shards.flat}) == 4
