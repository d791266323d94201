"""Card-only tests of the port's CUDA kernels (marker ``cuda``).

Each test skips without a CUDA device: a CUDA kernel has no CPU mode. The
file imports only torch and the port, so it runs on a GPU machine that has
no JAX, without the repository's JAX conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerance for the kernel vs its plain twin: two packing quanta
(2^steal_bits ulps of [2, 4), 2^-22 each) plus twice the f32 dot-product
error bound of unit rows of depth D (2 * D * 2^-24): the two differ only in
the order of the f32 sums (derivation in chip_smoke.py).
"""

import pytest
import torch

from lean_explore_tpu_torch.ops import bin_topk as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _unit_rows(n, d, gen, device):
    x = torch.randn(n, d, generator=gen, device=device)
    return (x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16)


@pytest.mark.parametrize(
    "n,n_valid,batch,bins",
    [
        (8192 + 4096, 8192 + 4000, 37, 4096),  # ragged batch, partial super-tile
        (4096 * 5, 4096 * 5, 1, 4096),  # one query, whole super-tiles
        (2048, 1500, 128, 1024),  # fewer super-tiles than groups
        (64 * 9, 64 * 9, 200, 64),  # two query blocks and a partial one
    ],
)
def test_carry_matches_plain(cuda, n, n_valid, batch, bins):
    gen = torch.Generator(device=cuda).manual_seed(n + batch)
    dim = 256
    corpus = _unit_rows(n, dim, gen, cuda)
    queries = _unit_rows(batch, dim, gen, cuda)
    steal = K.steal_bits_for(n, bins)
    before = K.bin_topk_carry.launches
    got = K.bin_topk_carry(queries, corpus, n_valid, bins)
    assert K.bin_topk_carry.launches == before + 1
    want = K.bin_topk_carry_plain(queries, corpus, n_valid, bins, steal)
    torch.cuda.synchronize()
    tol = 2.0 * 2.0 ** (steal - 22) + 2.0 * dim * 2.0**-24
    assert got.shape == (bins, batch)
    assert float((got - want).abs().max()) <= tol


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    corpus = torch.zeros(512, 64, dtype=torch.bfloat16, device=cuda)
    q = torch.zeros(2, 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError):
        K.bin_topk_carry(q.float(), corpus, 512, 256)
    with pytest.raises(ValueError, match="multiples"):
        K.bin_topk_carry(q, corpus[:500], 500, 256)
    with pytest.raises(ValueError, match="contiguous"):
        K.bin_topk_carry(q, corpus.T.contiguous().T, 512, 256)
    with pytest.raises(ValueError, match="CUDA device"):
        K.bin_topk_carry(q.cpu(), corpus, 512, 256)


def test_dense_index_search_takes_the_kernel(cuda):
    import numpy as np

    from lean_explore_tpu_torch.index.dense import DenseIndex

    gen = torch.Generator(device=cuda).manual_seed(3)
    corpus = _unit_rows(20_000, 128, gen, cuda)
    index = DenseIndex(corpus, np.arange(20_000), normalized=True)
    before = K.bin_topk_carry.launches
    _, ids = index.search(corpus[:5].float(), 10)
    assert K.bin_topk_carry.launches == before + 1
    assert ids[:, 0].tolist() == [0, 1, 2, 3, 4]
