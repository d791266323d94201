"""The port's bin_topk_pipelined (K4) on the CPU vs the JAX Pallas kernels.

JAX's ``pallas_bin_topk_pipelined`` has no interpret mode (on the CPU it
stops with "Only interpret mode is supported on CPU backend"); its own test
(tests/ops/test_dense.py, TPU only) holds it bit for bit against
``pallas_bin_topk(..., exact_epilogue=True)``. So the port's function runs
on CPU tensors (K1's plain twin) against ``pallas_bin_topk(...,
interpret=True, exact_epilogue=True)`` on the same seeded numpy inputs,
bf16 and float32, at that test's case and at a partial final super-tile.

Tolerance, as tests/test_torch_bin_topk.py: both pack the same f32 scores,
so they differ only where the two f32 sum orders put a score on different
sides of a packing-quantum edge: scores agree within two quanta
(2^steal_bits ulps of [2, 4)) plus 1e-6, and ids are equal wherever the
score is not tied (the two top-k routines order exact ties differently).

Both functions raise ValueError on the same three inputs. The kernel runs
only on the card: tests/test_torch_cuda.py holds its carry bit for bit
against K1's kernel there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lean_explore_tpu.ops.pallas_retrieval import (
    pallas_bin_topk,
    pallas_bin_topk_pipelined,
)
from lean_explore_tpu_torch.ops import bin_topk as K
from lean_explore_tpu_torch.ops import bin_topk_pipelined as K4
from tests.conftest import random_unit_rows

DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}


def _both(corpus, queries, n_valid, k, bins, tile_rows, dtype):
    """JAX's K1 in interpret mode and the port's K4 on the CPU, on the same
    f32 numpy inputs with the corpus cast to ``dtype`` on both sides."""
    jax_dtype, torch_dtype = DTYPES[dtype]
    want_s, want_i = pallas_bin_topk(
        jnp.asarray(queries), jnp.asarray(corpus).astype(jax_dtype), jnp.int32(n_valid),
        k=k, bins=bins, tile_rows=tile_rows, interpret=True, exact_epilogue=True,
    )
    got_s, got_i = K4.bin_topk_pipelined(
        torch.from_numpy(queries), torch.from_numpy(corpus).to(torch_dtype), n_valid,
        k=k, bins=bins, tile_rows=tile_rows,
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


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_the_tpu_tests_case(dtype):
    """tests/ops/test_dense.py's hardware case: 8192 x 256, B = 16,
    n_valid = 8000, k = 64, bins = 2048, tile_rows 512."""
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((8192, 256)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    queries = rng.standard_normal((16, 256)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    scores, idx = _both(corpus, queries, 8000, 64, bins=2048, tile_rows=512, dtype=dtype)
    assert scores.shape == (16, 64) and idx.shape == (16, 64)
    assert idx.min() >= 0 and idx.max() < 8000
    assert np.all(np.diff(scores, axis=1) <= 0)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_partial_final_supertile(dtype):
    n, b, k, bins = 2560, 4, 32, 1024
    corpus = random_unit_rows(n, 64, seed=50)
    queries = random_unit_rows(b, 64, seed=51)
    corpus[2300] = queries[0]
    scores, idx = _both(corpus, queries, 2400, k, bins=bins, tile_rows=512, dtype=dtype)
    assert idx[0, 0] == 2300
    np.testing.assert_allclose(scores[0, 0], 1.0, atol=5e-3)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_single_query_and_padding_never_selected(dtype):
    corpus = np.zeros((1024, 64), dtype=np.float32)
    corpus[:700] = -np.abs(random_unit_rows(700, 64, seed=52))
    queries = np.abs(random_unit_rows(1, 64, seed=53))
    scores, idx = _both(corpus, queries, 700, 24, bins=512, tile_rows=256, dtype=dtype)
    assert idx.max() < 700
    assert np.all(scores < 0)


BAD_INPUTS = {
    "rows not a multiple of tile_rows": (
        dict(n=1000, bins=512, k=8), "not a multiple of tile_rows"
    ),
    "bins not a multiple of tile_rows": (
        dict(n=1024, bins=384, k=8), "bins 384 not a multiple"
    ),
    "k exceeds bins": (dict(n=1024, bins=512, k=600), "exceeds bins"),
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_raises_where_the_jax_function_raises(case):
    shape, message = BAD_INPUTS[case]
    corpus = random_unit_rows(shape["n"], 64, seed=7)
    queries = random_unit_rows(2, 64, seed=8)
    with pytest.raises(ValueError, match=message):
        pallas_bin_topk_pipelined(
            jnp.asarray(queries), jnp.asarray(corpus), jnp.int32(shape["n"]),
            k=shape["k"], bins=shape["bins"], tile_rows=256, exact_epilogue=True,
        )
    with pytest.raises(ValueError, match=message):
        K4.bin_topk_pipelined(
            torch.from_numpy(queries), torch.from_numpy(corpus), shape["n"],
            k=shape["k"], bins=shape["bins"], tile_rows=256,
        )


def test_cpu_tensors_take_k1s_plain_twin_and_count_nothing():
    corpus = torch.from_numpy(random_unit_rows(512, 64, seed=3))
    queries = torch.from_numpy(random_unit_rows(3, 64, seed=4))
    before = K4.bin_topk_pipelined_carry.launches
    packed = K4.bin_topk_pipelined_carry(queries, corpus, 500, 256, n_buffers=4)
    assert K4.bin_topk_pipelined_carry.launches == before
    want = K.bin_topk_carry_plain(queries, corpus, 500, 256, K.steal_bits_for(512, 256))
    assert torch.equal(packed, want)
    scores, rows = K4.bin_topk_pipelined(queries, corpus, 500, k=16, bins=256, tile_rows=256)
    want_s, want_r = K.bin_topk(queries, corpus, 500, k=16, bins=256)
    assert torch.equal(scores, want_s) and torch.equal(rows, want_r)
    assert K4.bin_topk_pipelined_carry.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ring_fits_a_blocks_shared_memory(dtype):
    """K1's carry block at each depth (csrc/bin_topk_pipelined.cu): per
    stage the corpus box and one query box (bf16) or the tf32 hi and lo
    boxes (float32), 16 KB each, and 16 bytes of mbarriers; the 64 KB
    carry; 1,024 bytes of alignment slack. The deepest ring that fits in
    227 KB is MAX_BUFFERS[dtype] (bf16 5: 230,480 bytes; float32 3:
    214,064), one stage more does not, and the kernel's static_asserts
    state the same limits."""
    import re

    from lean_explore_tpu_torch.ops.cuda_build import CSRC_DIR

    boxes = {torch.bfloat16: 2, torch.float32: 3}[dtype]
    limit = K4.MAX_BUFFERS[dtype]
    assert K4.ring_smem_bytes(limit, dtype) == (
        limit * (boxes * 128 * 128 + 16) + 2 * 64 * 128 * 4 + 1024
    )
    assert K4.ring_smem_bytes(limit, dtype) <= K4.BLOCK_SMEM_LIMIT
    assert K4.ring_smem_bytes(limit + 1, dtype) > K4.BLOCK_SMEM_LIMIT
    assert K4.MIN_BUFFERS == 2 <= limit
    stage = {torch.bfloat16: "Bf16Stage", torch.float32: r"Tf32Stage<false>"}[dtype]
    source = (CSRC_DIR / "bin_topk_pipelined.cu").read_text()
    stated = re.findall(rf"static_assert\(max_buffers<{re.escape(stage)}>\(\) == (\d+)", source)
    assert stated == [str(limit)]
    assert re.search(r"constexpr int BLOCK_SMEM = (\d+);", source).group(1) == str(
        K4.BLOCK_SMEM_LIMIT)
    assert set(K4.KERNEL_ENTRIES) == set(K.KERNEL_ENTRIES) == set(K4.MAX_BUFFERS)
