"""Card-only tests of the port's CUDA kernels (marker ``cuda``).

Each test skips without a CUDA device: a CUDA kernel has no CPU mode. The
file imports only torch and the port, so it runs on a GPU machine that has
no JAX, without the repository's JAX conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerance for the bf16 kernels vs their plain twins: the two differ only
in the order of the f32 sums, within twice the f32 dot-product error bound
of unit rows of depth D (2 * D * 2^-24), plus, for the packed carry, two
packing quanta (2^steal_bits ulps of [2, 4), 2^-22 each) (derivation in
chip_smoke.py). The int8 kernel's products are exact integers and its f32
steps are rounded as its twin's, so its carry equals the twin's bit for bit.
The ring-fed carry kernel (K4) is K1's kernel with the ring's depth set
by n_buffers, which changes when a stage is copied but not the order of
any sum, so its carry equals K1's kernel carry bit for bit at every depth.
The float32 kernels (3xTF32) are held to 3 * 2^-22 + 7 * D * 2^-24 (the
split's error and truncating tensor-core sums; ops.bin_topk.score_tolerance),
and flash attention on valid rows to ops.flash_attention.kernel_tolerance:
2^-7 * (max|v| + max|out|) in bf16 (where the two round the probabilities
to bf16, and the bf16 output), the 3xTF32 bound in float32.
"""

import numpy as np
import pytest
import torch

from lean_explore_tpu_torch.ops import bin_topk as K
from lean_explore_tpu_torch.ops import bin_topk_int8 as K8
from lean_explore_tpu_torch.ops import bin_topk_pipelined as K4
from lean_explore_tpu_torch.ops import flash_attention as FA
from lean_explore_tpu_torch.ops import windowed as W
from lean_explore_tpu_torch.ops.quant import quantize_rows_device

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _unit_rows(n, d, gen, device, dtype=torch.bfloat16):
    x = torch.randn(n, d, generator=gen, device=device)
    return (x / x.norm(dim=1, keepdim=True)).to(dtype)


@pytest.mark.parametrize(
    "n,n_valid,batch,bins",
    [
        (8192 + 4096, 8192 + 4000, 37, 4096),  # ragged batch, partial super-tile
        (4096 * 5, 4096 * 5, 1, 4096),  # one query, whole super-tiles
        (2048, 1500, 128, 1024),  # fewer super-tiles than groups
        (64 * 9, 64 * 9, 200, 64),  # two query blocks and a partial one
        # bins % 128 == 64: the last block's second warpgroup lies past the
        # bins; N % 128 == 64: the last super-tile ends inside a block
        (192 * 10 + 64, 192 * 10, 1, 192),
        (64 * 33, 64 * 33 - 17, 37, 64),
        (64 * 17, 1000, 200, 192),
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
    with pytest.raises(TypeError, match="bf16 or float32"):
        K.bin_topk_carry(q.half(), corpus.half(), 512, 256)
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


def _int8_rows(n, d, gen, device):
    return quantize_rows_device(_unit_rows(n, d, gen, device).float())


@pytest.mark.parametrize(
    "n,n_valid,batch,bins",
    [
        (8192 + 4096, 8192 + 4000, 37, 4096),  # ragged batch, partial super-tile
        (4096 * 5, 4096 * 5, 1, 4096),  # one query, whole super-tiles
        (2048, 1500, 128, 1024),  # fewer super-tiles than groups
        (64 * 9, 64 * 9, 200, 64),  # two query blocks and a partial one
        # bins % 128 == 64: the last block's second warpgroup lies past the
        # bins; N % 128 == 64: the last super-tile ends inside a block
        (192 * 10 + 64, 192 * 10, 1, 192),
        (64 * 33, 64 * 33 - 17, 37, 64),
        (64 * 17, 1000, 200, 192),
        # B = 129: a second query block of one; bins = 4160, a half slice,
        # and a partial final super-tile
        (4160 * 3 + 64, 4160 * 2 + 100, 129, 4160),
    ],
)
def test_int8_carry_equals_plain(cuda, n, n_valid, batch, bins):
    gen = torch.Generator(device=cuda).manual_seed(n + batch + 1)
    codes, scales = _int8_rows(n, 256, gen, cuda)
    q_codes, q_scales = _int8_rows(batch, 256, gen, cuda)
    before = K8.bin_topk_int8_carry.launches
    got = K8.bin_topk_int8_carry(q_codes, q_scales, codes, scales, n_valid, bins)
    assert K8.bin_topk_int8_carry.launches == before + 1
    want = K8.bin_topk_int8_carry_plain(
        q_codes, q_scales, codes, scales, n_valid, bins, K.steal_bits_for(n, bins)
    )
    torch.cuda.synchronize()
    assert got.shape == (bins, batch)
    assert torch.equal(got, want)


def _patched_libraries(tmp_path, names, stages, constants):
    """{name: library} of csrc/<name>.cu for each of `names`, built from a
    copy of csrc/ under tmp_path in which each (file, constant) of
    `constants` is set to `stages` (as they are when stages is None)."""
    import ctypes
    import re
    import shutil
    import subprocess

    from lean_explore_tpu_torch.ops.cuda_build import CSRC_DIR, NVCC_FLAGS, nvcc_path

    tree = tmp_path / "csrc"
    shutil.copytree(CSRC_DIR, tree)
    if stages is not None:
        for name, constant in constants:
            source, found = re.subn(rf"constexpr int {constant} = \d+;",
                                    f"constexpr int {constant} = {stages};",
                                    (tree / name).read_text())
            assert found == 1
            (tree / name).write_text(source)
    libs = {}
    for name in names:
        lib = tmp_path / f"lib{name}.so"
        subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(lib), str(tree / f"{name}.cu")],
                       check=True, capture_output=True)
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def _int8_build(tmp_path, stages):
    """bin_topk_int8.cu's entry, built with its ring cut to `stages` stages."""
    import ctypes

    lib = _patched_libraries(tmp_path, ["bin_topk_int8"], stages,
                             [("bin_topk_int8.cu", "INT8_CARRY_STAGES")])["bin_topk_int8"]
    entry = lib.bin_topk_int8_carry
    entry.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    entry.restype = ctypes.c_int
    return entry


@pytest.mark.parametrize("stages", [None, 2])
def test_int8_carry_is_the_same_in_every_repeated_launch(cuda, tmp_path, stages):
    """A fault of the int8 kernel's TMA ring changes a carry in only some
    launches: 200 launches over one super-tile of 16,384 rows (every
    product reaches the carry), through the wrapper as built and from a
    copy whose ring has 2 stages, must each give the first launch's bits,
    and the first must equal the plain twin's."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    n, dim, batch = 16384, 1024, 128
    codes, scales = _int8_rows(n, dim, gen, cuda)
    q_codes, q_scales = _int8_rows(batch, dim, gen, cuda)
    if stages is None:
        def carry():
            return K8.bin_topk_int8_carry(q_codes, q_scales, codes, scales, n, n)
    else:
        entry = _int8_build(tmp_path, stages)
        steal = K.steal_bits_for(n, n)

        def carry():
            out, partial, groups = K.carry_buffers(
                codes, batch, n, K.ring_supertile_groups(cuda, n, batch, n))
            assert entry(q_codes.data_ptr(), q_scales.data_ptr(), codes.data_ptr(),
                         scales.data_ptr(), out.data_ptr(),
                         partial.data_ptr() if partial is not None else None, batch, n, dim,
                         n, n, steal, groups, torch.cuda.current_stream().cuda_stream) == 0
            return out

    first = carry().view(torch.int32)
    want = K8.bin_topk_int8_carry_plain(
        q_codes, q_scales, codes, scales, n, n, K.steal_bits_for(n, n))
    torch.cuda.synchronize()
    assert torch.equal(first, want.view(torch.int32))
    differing = sum(int(not torch.equal(carry().view(torch.int32), first)) for _ in range(200))
    assert differing == 0


def test_int8_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    codes = torch.zeros(512, 128, dtype=torch.int8, device=cuda)
    scales = torch.ones(512, device=cuda)
    q = torch.zeros(2, 128, dtype=torch.int8, device=cuda)
    qs = torch.ones(2, device=cuda)
    with pytest.raises(TypeError):
        K8.bin_topk_int8_carry(q.float(), qs, codes, scales, 512, 256)
    with pytest.raises(TypeError):
        K8.bin_topk_int8_carry(q, qs, codes, scales.double(), 512, 256)
    with pytest.raises(ValueError, match="multiple of 128"):
        K8.bin_topk_int8_carry(
            q[:, :64].contiguous(), qs, codes[:, :64].contiguous(), scales, 512, 256
        )
    with pytest.raises(ValueError, match="CUDA device"):
        K8.bin_topk_int8_carry(q.cpu(), qs, codes, scales, 512, 256)


def test_int8_dense_index_search_takes_the_kernel(cuda):
    from lean_explore_tpu_torch.index.dense import DenseIndex

    rng = np.random.default_rng(4)
    emb = rng.standard_normal((20_000, 128)).astype(np.float32)
    index = DenseIndex.build(emb, np.arange(20_000), dtype="int8", device=cuda)
    before = K8.bin_topk_int8_carry.launches
    before_bf16 = K.bin_topk_carry.launches
    _, ids = index.search(emb[:5], 10)
    assert K8.bin_topk_int8_carry.launches == before + 1
    assert K.bin_topk_carry.launches == before_bf16
    assert ids[:, 0].tolist() == [0, 1, 2, 3, 4]


@pytest.mark.parametrize(
    "n,n_valid,batch,window",
    [
        (4096, 4000, 37, 8),
        (640, 640, 1, 16),
        (64 * 9, 500, 200, 64),  # N / 64 odd: a half tile of 128 rows
        (64 * 7, 64 * 7 - 9, 130, 64),  # a half tile, B % 4 != 0: thread stores
        (64 * 3, 64 * 3 - 1, 8, 8),  # 16-byte stores of rows narrower than a query block
    ],
)
def test_windowed_scores_match_plain(cuda, n, n_valid, batch, window):
    gen = torch.Generator(device=cuda).manual_seed(n + batch + 2)
    dim = 256
    corpus = _unit_rows(n, dim, gen, cuda)
    queries = _unit_rows(batch, dim, gen, cuda).float()
    before = W.fused_scores_wmax.launches
    got_s, got_w = W.fused_scores_wmax(queries, corpus, n_valid, window)
    assert W.fused_scores_wmax.launches == before + 1
    want_s, want_w = W.fused_scores_wmax_plain(queries, corpus, n_valid, window)
    torch.cuda.synchronize()
    tol = 2.0 * dim * 2.0**-24
    assert got_s.shape == (n, batch) and got_w.shape == (n // window, batch)
    for got, want in ((got_s, want_s), (got_w, want_w)):
        assert torch.equal(torch.isneginf(got), torch.isneginf(want))
        finite = torch.isfinite(want)
        assert float((got[finite] - want[finite]).abs().max()) <= tol


def test_windowed_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    corpus = torch.zeros(512, 64, dtype=torch.bfloat16, device=cuda)
    q = torch.zeros(2, 64, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        W.fused_scores_wmax(q, corpus.half(), 512)
    with pytest.raises(ValueError, match="multiple of 32"):
        W.fused_scores_wmax(q[:, :48], corpus[:, :48].float().contiguous(), 512)
    with pytest.raises(ValueError, match="window"):
        W.fused_scores_wmax(q, corpus, 512, window=24)
    with pytest.raises(ValueError, match="CUDA device"):
        W.fused_scores_wmax(q.cpu(), corpus, 512)


def test_dense_index_windowed_search_takes_the_kernel(cuda):
    from lean_explore_tpu_torch.index.dense import DenseIndex

    gen = torch.Generator(device=cuda).manual_seed(6)
    corpus = _unit_rows(20_000, 128, gen, cuda)
    index = DenseIndex(corpus, np.arange(20_000), normalized=True)
    before = W.fused_scores_wmax.launches
    _, ids = index.search(corpus[:5].float(), 10, method="windowed")
    assert W.fused_scores_wmax.launches == before + 1
    assert ids[:, 0].tolist() == [0, 1, 2, 3, 4]


@pytest.mark.parametrize(
    "n,n_valid,batch,bins,dim",
    [
        (8192 + 4096, 8192 + 4000, 37, 4096, 256),  # ragged batch, partial super-tile
        (4096 * 5, 4096 * 5, 1, 4096, 96),  # one query, a depth of 3 f32 stages
        (2048, 1500, 128, 1024, 256),  # fewer super-tiles than groups
        (64 * 9, 64 * 9, 200, 64, 32),  # two query blocks and a partial one
        (64 * 33, 64 * 33 - 17, 100, 64, 1024),  # one 64-bin slice, the full depth
        # 192 bins: the second block's second warpgroup lies past the bins,
        # and the last super-tile's 64 rows end inside the first block
        (192 * 10 + 64, 192 * 10, 1, 192, 96),
        (4096 * 2 + 2048 + 64, 4096 * 2 + 2000, 200, 4096, 32),
        # the quality eval's shape: the 200k chain's float32 corpus of width
        # 384 padded to 512 rows, evaluate_engine's batch of 64 queries
        (200_192, 200_000, 64, 4096, 384),
    ],
)
def test_f32_carry_matches_plain(cuda, n, n_valid, batch, bins, dim):
    gen = torch.Generator(device=cuda).manual_seed(n + batch + 3)
    corpus = _unit_rows(n, dim, gen, cuda, torch.float32)
    queries = _unit_rows(batch, dim, gen, cuda, torch.float32)
    steal = K.steal_bits_for(n, bins)
    before = K.bin_topk_carry.launches
    got = K.bin_topk_carry(queries, corpus, n_valid, bins)
    assert K.bin_topk_carry.launches == before + 1
    want = K.bin_topk_carry_plain(queries, corpus, n_valid, bins, steal)
    torch.cuda.synchronize()
    tol = 2.0 * 2.0 ** (steal - 22) + K.score_tolerance(torch.float32, dim)
    assert got.shape == (bins, batch)
    assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize(
    "n,n_valid,batch,window,dim",
    [
        (4096, 4000, 37, 8, 256),
        (640, 640, 1, 16, 96),
        (64 * 9, 500, 200, 64, 32),  # N / 64 odd: a half tile of 128 rows
        (64 * 15, 64 * 15 - 3, 100, 1, 1024),  # window 1, the full depth
        (64 * 7, 64 * 7, 130, 8, 96),  # a second query block of 2, B % 4 != 0
        (64 * 3, 64 * 3 - 2, 8, 8, 64),  # 16-byte stores of rows narrower than a query block
    ],
)
def test_f32_windowed_scores_match_plain(cuda, n, n_valid, batch, window, dim):
    gen = torch.Generator(device=cuda).manual_seed(n + batch + 4)
    corpus = _unit_rows(n, dim, gen, cuda, torch.float32)
    queries = _unit_rows(batch, dim, gen, cuda, torch.float32)
    before = W.fused_scores_wmax.launches
    got_s, got_w = W.fused_scores_wmax(queries, corpus, n_valid, window)
    assert W.fused_scores_wmax.launches == before + 1
    want_s, want_w = W.fused_scores_wmax_plain(queries, corpus, n_valid, window)
    torch.cuda.synchronize()
    for got, want in ((got_s, want_s), (got_w, want_w)):
        assert torch.equal(torch.isneginf(got), torch.isneginf(want))
        finite = torch.isfinite(want)
        assert float((got[finite] - want[finite]).abs().max()) <= K.score_tolerance(torch.float32, dim)


def test_f32_dense_index_search_takes_the_kernel(cuda):
    from lean_explore_tpu_torch.index.dense import DenseIndex

    gen = torch.Generator(device=cuda).manual_seed(7)
    corpus = _unit_rows(20_000, 128, gen, cuda, torch.float32)
    index = DenseIndex(corpus, np.arange(20_000), normalized=True)
    before = K.bin_topk_carry.launches
    before_w = W.fused_scores_wmax.launches
    _, ids = index.search(corpus[:5], 10)
    _, ids_w = index.search(corpus[:5], 10, method="windowed")
    assert K.bin_topk_carry.launches == before + 1
    assert W.fused_scores_wmax.launches == before_w + 1
    assert ids[:, 0].tolist() == [0, 1, 2, 3, 4] == ids_w[:, 0].tolist()


def _ring_build(tmp_path, stages, dtype):
    """bin_topk.cu and windowed_scores.cu built as they are (stages None) or
    with their four rings (bf16 and float32) cut to `stages` stages, each
    from a copy of csrc/ under tmp_path; (carry entry, windowed entry) of
    `dtype`."""
    import ctypes

    libs = _patched_libraries(
        tmp_path, ["bin_topk", "windowed_scores"], stages,
        [("bin_topk.cu", "CARRY_STAGES"), ("windowed_scores.cu", "WINDOW_STAGES"),
         ("bin_topk.cu", "BF16_CARRY_STAGES"), ("windowed_scores.cu", "BF16_WINDOW_STAGES")])
    suffix = "_f32" if dtype == torch.float32 else ""
    split = 1 if dtype == torch.float32 else 0  # the f32 entries take q_split
    carry = getattr(libs["bin_topk"], "bin_topk_carry" + suffix)
    carry.argtypes = [ctypes.c_void_p] * (4 + split) + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    windowed = getattr(libs["windowed_scores"], "windowed_scores" + suffix)
    windowed.argtypes = [ctypes.c_void_p] * (4 + split) + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    carry.restype = windowed.restype = ctypes.c_int
    return carry, windowed


def _check_repeated_launches(cuda, tmp_path, stages, dtype):
    """200 launches of the carry and windowed kernels of `dtype`, built as
    they are or at `stages` ring stages, over one super-tile of 16,384 rows
    (every product reaches the carry) and the same rows' scores, each equal
    to the first launch's bits; the first held to the plain twins."""
    carry_fn, windowed_fn = _ring_build(tmp_path, stages, dtype)
    gen = torch.Generator(device=cuda).manual_seed(12)
    n, dim, batch, window = 16384, 1024, 128, 8
    corpus = _unit_rows(n, dim, gen, cuda, dtype)
    queries = _unit_rows(batch, dim, gen, cuda, dtype)
    split = [K.split_scratch(queries).data_ptr()] if dtype == torch.float32 else []
    steal = K.steal_bits_for(n, n)
    stream = torch.cuda.current_stream().cuda_stream

    def carry():
        out, partial, groups = K.carry_buffers(
            corpus, batch, n, K.ring_supertile_groups(cuda, n, batch, n))
        assert carry_fn(queries.data_ptr(), *split, corpus.data_ptr(), out.data_ptr(),
                        partial.data_ptr() if partial is not None else None, batch, n, dim, n,
                        n, steal, groups, stream) == 0
        return out.view(torch.int32)

    def windowed():
        scores = torch.empty(n, batch, device=cuda)
        wmax = torch.empty(n // window, batch, device=cuda)
        assert windowed_fn(queries.data_ptr(), *split, corpus.data_ptr(),
                           scores.data_ptr(), wmax.data_ptr(), batch, n, dim, n - 5, window,
                           stream) == 0
        return torch.cat([scores.flatten(), wmax.flatten()]).view(torch.int32)

    first_carry, first_scores = carry(), windowed()
    want = K.bin_topk_carry_plain(queries, corpus, n, n, steal)
    want_s, want_w = W.fused_scores_wmax_plain(queries, corpus, n - 5, window)
    torch.cuda.synchronize()
    tol = K.score_tolerance(dtype, dim)
    assert float((first_carry.view(torch.float32) - want).abs().max()) <= (
        2.0 * 2.0 ** (steal - 22) + tol)
    got_s = first_scores.view(torch.float32)[: n * batch].view(n, batch)
    assert torch.equal(torch.isneginf(got_s), torch.isneginf(want_s))
    finite = torch.isfinite(want_s)
    assert float((got_s[finite] - want_s[finite]).abs().max()) <= tol
    differing = {"carry": 0, "windowed": 0}
    for _ in range(200):
        differing["carry"] += int(not torch.equal(carry(), first_carry))
        differing["windowed"] += int(not torch.equal(windowed(), first_scores))
    assert differing == {"carry": 0, "windowed": 0}


@pytest.mark.parametrize("stages", [None, 2])
def test_f32_kernels_are_the_same_in_every_repeated_launch(cuda, tmp_path, stages):
    """A fault of the float32 kernels' TMA ring (a refill overtaking the
    consumers' reads) changes an output in only some launches: 200 launches
    of each, as built and at a 2-stage ring, must each give the first
    launch's bits; the first must match the plain twins."""
    _check_repeated_launches(cuda, tmp_path, stages, torch.float32)


@pytest.mark.parametrize("stages", [None, 2])
def test_bf16_kernels_are_the_same_in_every_repeated_launch(cuda, tmp_path, stages):
    """The same for the bf16 kernels' ring (and K3's staged scores, which
    a warpgroup must not overwrite before all its threads have stored
    them): 200 launches as built and at a 2-stage ring."""
    _check_repeated_launches(cuda, tmp_path, stages, torch.bfloat16)


CARRY_CASES = [
    (8192 + 4096, 8192 + 4000, 37, 4096),  # ragged batch, partial super-tile
    (4096 * 5, 4096 * 5, 1, 4096),  # one query, whole super-tiles
    (2048, 1500, 128, 1024),  # fewer super-tiles than groups
    (64 * 9, 64 * 9, 200, 64),  # two query blocks and a partial one
]


# (dtype, n_buffers): every depth each dtype's ring takes, 2 to MAX_BUFFERS.
PIPELINE_DEPTHS = [(dtype, n) for dtype, limit in K4.MAX_BUFFERS.items()
                   for n in range(K4.MIN_BUFFERS, limit + 1)]


@pytest.mark.parametrize("dtype,n_buffers", PIPELINE_DEPTHS)
@pytest.mark.parametrize("n,n_valid,batch,bins", CARRY_CASES)
def test_pipelined_carry_equals_k1(cuda, n, n_valid, batch, bins, dtype, n_buffers):
    """K4's carry is K1's kernel carry, bit for bit, at test_carry_matches_plain's
    cases, bf16 and f32, at every ring depth from 2 to MAX_BUFFERS[dtype]."""
    gen = torch.Generator(device=cuda).manual_seed(n + batch + 5)
    corpus = _unit_rows(n, 256, gen, cuda, dtype)
    queries = _unit_rows(batch, 256, gen, cuda, dtype)
    before = K4.bin_topk_pipelined_carry.launches
    got = K4.bin_topk_pipelined_carry(queries, corpus, n_valid, bins, n_buffers)
    assert K4.bin_topk_pipelined_carry.launches == before + 1
    want = K.bin_topk_carry(queries, corpus, n_valid, bins)
    torch.cuda.synchronize()
    assert got.shape == (bins, batch)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("end", ["shortest", "deepest"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pipelined_carry_equals_k1_in_every_repeated_launch(cuda, dtype, end):
    """A fault of the ring's protocol (the refill overtaking the consumers'
    reads) changes a carry in only some launches: 200 launches at the
    shortest and at the deepest ring over one super-tile (bins = rows, so
    every product reaches the carry) must each equal K1's kernel carry."""
    n_buffers = K4.MIN_BUFFERS if end == "shortest" else K4.MAX_BUFFERS[dtype]
    gen = torch.Generator(device=cuda).manual_seed(9)
    corpus = _unit_rows(16384, 1024, gen, cuda, dtype)
    queries = _unit_rows(128, 1024, gen, cuda, dtype)
    want = K.bin_topk_carry(queries, corpus, 16384, 16384).view(torch.int32)
    differing = 0
    for _ in range(200):
        got = K4.bin_topk_pipelined_carry(queries, corpus, 16384, 16384, n_buffers)
        differing += int(not torch.equal(got.view(torch.int32), want))
    assert differing == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pipelined_top_k_equals_k1_at_the_tpu_tests_case(cuda, dtype):
    """tests/ops/test_dense.py's hardware case (8192 x 256, B = 16,
    n_valid = 8000, k = 64, bins = 2048): scores and rows equal K1's."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    corpus = _unit_rows(8192, 256, gen, cuda, dtype)
    queries = _unit_rows(16, 256, gen, cuda, torch.float32)
    before = K4.bin_topk_pipelined_carry.launches
    got_s, got_i = K4.bin_topk_pipelined(queries, corpus, 8000, k=64, bins=2048, tile_rows=512)
    assert K4.bin_topk_pipelined_carry.launches == before + 1
    want_s, want_i = K.bin_topk(queries, corpus, 8000, k=64, bins=2048)
    torch.cuda.synchronize()
    assert torch.equal(got_s, want_s) and torch.equal(got_i, want_i)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pipelined_wrapper_rejects_what_the_kernel_does_not_take(cuda, dtype):
    corpus = torch.zeros(512, 64, dtype=dtype, device=cuda)
    q = torch.zeros(2, 64, dtype=dtype, device=cuda)
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    before = K4.bin_topk_pipelined_carry.launches
    with pytest.raises(TypeError):
        K4.bin_topk_pipelined_carry(q.to(other), corpus, 512, 256)
    with pytest.raises(TypeError, match="bf16 or float32"):
        K4.bin_topk_pipelined_carry(q.half(), corpus.half(), 512, 256)
    with pytest.raises(ValueError, match="multiples"):
        K4.bin_topk_pipelined_carry(q, corpus[:500], 500, 256)
    with pytest.raises(ValueError, match="contiguous"):
        K4.bin_topk_pipelined_carry(q, corpus.T.contiguous().T, 512, 256)
    with pytest.raises(ValueError, match="CUDA device"):
        K4.bin_topk_pipelined_carry(q.cpu(), corpus, 512, 256)
    limit = K4.MAX_BUFFERS[dtype]
    for n_buffers in (1, limit + 1):
        with pytest.raises(ValueError, match=rf"n_buffers in \[2, {limit}\] for a {dtype}"):
            K4.bin_topk_pipelined_carry(q, corpus, 512, 256, n_buffers)
    assert K4.bin_topk_pipelined_carry.launches == before
    # The most stages that fit still launch and give K1's carry.
    got = K4.bin_topk_pipelined_carry(q, corpus, 512, 256, limit)
    assert K4.bin_topk_pipelined_carry.launches == before + 1
    assert torch.equal(got, K.bin_topk_carry(q, corpus, 512, 256))


def _flash_inputs(cuda, b, t, nq, nkv, dh, lengths, seed, dtype=torch.bfloat16):
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def draw(heads):
        return torch.randn(b, t, heads, dh, generator=gen, device=cuda).to(dtype)

    lens = torch.tensor(lengths, device=cuda)
    mask = (torch.arange(t, device=cuda)[None, :] < lens[:, None]).to(torch.int32)
    return draw(nq), draw(nkv), draw(nkv), mask


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "b,t,nq,nkv,dh,lengths",
    [
        (5, 256, 4, 2, 128, [1, 63, 64, 65, 256]),
        (3, 128, 4, 4, 64, [128, 100, 1]),
        (2, 512, 16, 8, 128, [512, 257]),
    ],
)
def test_flash_attention_matches_plain(cuda, b, t, nq, nkv, dh, lengths, dtype):
    q, k, v, mask = _flash_inputs(cuda, b, t, nq, nkv, dh, lengths, seed=t + dh, dtype=dtype)
    before = FA.attention_flash.launches
    got = FA.attention_flash(q, k, v, mask, dh**-0.5)
    assert FA.attention_flash.launches == before + 1
    want = FA.attention_flash_plain(q, k, v, mask, dh**-0.5)
    torch.cuda.synchronize()
    assert got.shape == (b, t, nq * dh) and got.dtype == dtype
    assert bool(torch.isfinite(got).all())
    valid = mask.bool()
    got_v, want_v = got[valid].float(), want[valid].float()
    assert float((got_v - want_v).abs().max()) <= FA.kernel_tolerance(q, k, v, want_v)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v, mask = _flash_inputs(cuda, 1, 128, 4, 2, 64, [128], seed=1)
    with pytest.raises(TypeError, match="bf16 or float32"):
        FA.attention_flash(q.half(), k.half(), v.half(), mask, 0.125)
    with pytest.raises(TypeError, match="one dtype"):
        FA.attention_flash(q.float(), k, v, mask, 0.125)
    with pytest.raises(ValueError, match="multiple of 64"):
        FA.attention_flash(q[:, :96], k[:, :96], v[:, :96], mask[:, :96], 0.125)
    with pytest.raises(ValueError, match="head dim"):
        FA.attention_flash(q[..., :32].contiguous(), k[..., :32].contiguous(),
                           v[..., :32].contiguous(), mask, 0.125)
    with pytest.raises(ValueError, match="one CUDA device"):
        FA.attention_flash(q, k, v, mask.cpu(), 0.125)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_forward_hidden_takes_flash_once_per_layer(cuda, monkeypatch, dtype):
    """With LEAN_EXPLORE_FLASH_ATTENTION=1 a forward at T = 256 on the card
    (bf16, or the f32 parity trunk) launches the kernel once per layer, and
    its valid rows stay close to the einsum path's (cosine >= 0.999 per
    row)."""
    from lean_explore_tpu_torch.models import qwen3

    config = qwen3.Qwen3Config(
        vocab_size=64, hidden_size=256, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=64, intermediate_size=512,
    )
    gen = torch.Generator(device=cuda).manual_seed(9)
    params = qwen3.init_params(config, gen, dtype=dtype, device=cuda)
    ids = torch.randint(3, 64, (3, 256), generator=gen, device=cuda)
    mask = torch.ones(3, 256, dtype=torch.int32, device=cuda)
    mask[1, 90:] = 0
    monkeypatch.setenv("LEAN_EXPLORE_FLASH_ATTENTION", "1")
    before = FA.attention_flash.launches
    flash = qwen3.forward_hidden(params, config, ids, mask)
    assert FA.attention_flash.launches == before + 2
    einsum = qwen3.forward_hidden(params, config, ids, mask, flash=False)
    assert FA.attention_flash.launches == before + 2
    valid = mask.bool()
    cos = torch.nn.functional.cosine_similarity(
        flash[valid].float(), einsum[valid].float(), dim=-1
    )
    assert float(cos.min()) >= 0.999


def _left_pad(mask, row, start):
    mask[row] = 0
    mask[row, start:] = 1
    return mask


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "b,t,nq,nkv,dh,lengths",
    [
        (4, 256, 4, 2, 128, [1, 63, 200, 256]),
        (3, 128, 4, 4, 64, [128, 100, 1]),
        (2, 192, 6, 2, 64, [192, 130]),
    ],
)
def test_flash_lse_matches_plain_and_keeps_out(cuda, b, t, nq, nkv, dh, lengths, dtype):
    """The forward with lse gives the same output, bit for bit, as without,
    and an lse within the score tolerance of the twin's on every row (pad
    rows have their own segment and the diagonal, so a finite lse): the
    kernel's log2-domain max and sum and the twin's logsumexp differ by the
    score error eps_s of ``bwd_kernel_tolerance`` plus the exp2/log2
    roundings, 2^-21 (max|lse| + 1)."""
    q, k, v, mask = _flash_inputs(cuda, b, t, nq, nkv, dh, lengths, seed=7 + dh, dtype=dtype)
    mask = _left_pad(mask, 0, 70)
    out = FA.attention_flash(q, k, v, mask, dh**-0.5)
    got, lse = FA.attention_flash(q, k, v, mask, dh**-0.5, with_lse=True)
    _, want = FA.attention_flash_plain(q, k, v, mask, dh**-0.5, with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(got, out)
    assert lse.shape == (b, nq, t) and lse.dtype == torch.float32
    assert bool(torch.isfinite(lse).all())
    norms = float(q.float().norm(dim=-1).max()) * float(k.float().norm(dim=-1).max())
    split = 3 * 2.0**-22 if dtype == torch.float32 else 0.0
    tol = dh**-0.5 * (split + 7 * dh * 2.0**-24) * norms + 2.0**-21 * (
        float(want.abs().max()) + 1
    )
    assert float((lse - want).abs().max()) <= 2 * tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "b,t,nq,nkv,dh,lengths,left_pad",
    [
        (3, 192, 4, 4, 128, [192, 1, 100], 70),  # group 1, a half 128-query block
        (4, 320, 6, 2, 64, [320, 1, 1, 257], 130),  # group 3, DH 64, half block
        (3, 320, 8, 2, 128, [1, 320, 200], 66),  # group 4, half block
        (2, 256, 12, 4, 64, [1, 256], 129),  # group 3, DH 64, whole blocks
        (2, 192, 4, 1, 128, [1, 192], 64),  # group 4, one kv head
    ],
)
def test_flash_forward_matches_plain_on_half_blocks_groups_and_padding(
    cuda, b, t, nq, nkv, dh, lengths, left_pad, dtype
):
    """The forward kernels' 128-query blocks and their tile skips: T % 128
    == 64 (the last block's warps 4-7 without rows), GQA groups 1, 3 and 4,
    DH 64, rows of length 1 and a left-padded last row (its first key tiles
    wholly in the other segment, skipped by its warps), valid rows within
    ``kernel_tolerance`` of the twin, every output finite, with and without
    lse the same bits."""
    q, k, v, mask = _flash_inputs(cuda, b, t, nq, nkv, dh, lengths, seed=17 + t + dh,
                                  dtype=dtype)
    mask = _left_pad(mask, b - 1, left_pad)
    before = FA.attention_flash.launches
    got = FA.attention_flash(q, k, v, mask, dh**-0.5)
    got_lse, _ = FA.attention_flash(q, k, v, mask, dh**-0.5, with_lse=True)
    assert FA.attention_flash.launches == before + 2
    want = FA.attention_flash_plain(q, k, v, mask, dh**-0.5)
    torch.cuda.synchronize()
    assert got.shape == (b, t, nq * dh) and got.dtype == dtype
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, got_lse)
    valid = mask.bool()
    got_v, want_v = got[valid].float(), want[valid].float()
    assert float((got_v - want_v).abs().max()) <= FA.kernel_tolerance(q, k, v, want_v)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_forward_is_the_same_in_every_repeated_launch(cuda, dtype):
    """The forward kernels sum in a fixed order (no atomics; the bf16 ring
    and the f32 split tiles are refilled only behind barriers), so 50
    launches on the same inputs give the first launch's output and lse,
    each of them: a fault of a ring may show in 1 launch of 30."""
    b, t, nq, nkv, dh = 4, 320, 16, 8, 128
    q, k, v, mask = _flash_inputs(cuda, b, t, nq, nkv, dh, [320, 1, 130, 200], seed=19,
                                  dtype=dtype)
    mask = _left_pad(mask, b - 1, 66)
    first = FA.attention_flash(q, k, v, mask, dh**-0.5, with_lse=True)
    differing = 0
    for _ in range(50):
        again = FA.attention_flash(q, k, v, mask, dh**-0.5, with_lse=True)
        differing += not all(torch.equal(x, y) for x, y in zip(first, again))
    torch.cuda.synchronize()
    assert differing == 0


def test_flash_forward_f32_keeps_the_lo_terms_of_its_products(cuda):
    """The float32 forward's products are 3xTF32, not 1xTF32. q is 8 in
    every entry (exact in tf32) and kv row j of head h is 1 + x in every
    entry, x = ((j + h) % 4) 2^-12: not a tf32 value unless x = 0, but its
    hi/lo split is exact, so the three-term products and their f32 sums
    (multiples of 2^-9 below 2^11) are exact in the kernel, as the twin's
    f32 products and sums are. Only the scaling rounds, within 2^-24 for
    the scale and for each product on each side: each score within
    eps = 2^-22 max|s| (max|s| <= scale max|q| max|k|) of the twin's, in
    place of ``kernel_tolerance``'s product term, whose other terms stay
    (4 eps for the weights and exp2 against exp, the 3xTF32 PV sum over T
    keys, the division). 1xTF32 products round x away or up to 2^-10,
    moving the scores by up to 0.066 against each other, and the output by
    about 0.08 (about 1e-3 if only PV were 1xTF32), against a bound of
    about 8e-4."""
    b, t, nq, nkv, dh = 2, 256, 4, 2, 128
    scale = dh**-0.5
    q = torch.full((b, t, nq, dh), 8.0, device=cuda)
    x = (torch.arange(t, device=cuda)[:, None] + torch.arange(nkv, device=cuda)) % 4
    k = (1 + x.float() * 2.0**-12)[None, :, :, None].expand(b, t, nkv, dh).contiguous()
    gen = torch.Generator(device=cuda).manual_seed(23)
    v = torch.randn(b, t, nkv, dh, generator=gen, device=cuda)
    mask = (torch.arange(t, device=cuda)[None] < torch.tensor([t, 170], device=cuda)[:, None])
    mask = mask.to(torch.int32)
    got = FA.attention_flash(q, k, v, mask, scale)
    want = FA.attention_flash_plain(q, k, v, mask, scale)
    torch.cuda.synchronize()
    valid = mask.bool()
    s_max = scale * float(q.norm(dim=-1).max()) * float(k.norm(dim=-1).max())
    eps = 2.0**-22 * s_max
    bound = (float(v.abs().max()) * (4 * eps + 3 * 2.0**-22 + 7 * t * 2.0**-24)
             + 2.0**-22 * float(want.abs().max()))
    assert bool(torch.isfinite(got).all())
    assert float((got[valid] - want[valid]).abs().max()) <= bound


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "b,t,nq,nkv,dh,lengths,left_pad",
    [
        (4, 256, 4, 2, 128, [1, 63, 200, 256], 66),
        (3, 128, 4, 4, 64, [128, 100, 1], 66),
        (2, 192, 6, 2, 64, [192, 130], 66),
        (2, 192, 4, 4, 128, [1, 192], 66),
        (2, 384, 8, 2, 128, [250, 384], 66),
        (2, 384, 4, 1, 64, [1, 300], 66),
        (2, 256, 16, 8, 128, [256, 256], None),  # full rows: nothing skipped by segment
        (4, 256, 16, 8, 128, [201, 250, 224, 237], None),  # 5b's documents: 201-250 of 256
        (3, 256, 8, 4, 128, [100, 171, 40], None),  # valid parts end inside 64-row groups
        (2, 320, 8, 2, 128, [320, 290], 66),  # T % 128 == 64: the last block half empty
    ],
)
def test_flash_backward_matches_plain(cuda, b, t, nq, nkv, dh, lengths, left_pad, dtype):
    """dq and dk/dv kernels against ``attention_flash_bwd_plain`` on the same
    residuals, within ``bwd_kernel_tolerance`` (derived there), with
    right-padded, left-padded (``left_pad``: the last row's first valid
    token) and one-token rows and dO zero on pad rows: every gradient
    finite, one launch each. The bf16 kernels work in groups of 64 fixed
    rows (a warpgroup, which skips streamed tiles as one; dq two to a
    block of 128), the float32 ones in blocks of 128 rows: T = 192 and
    T = 320 end in a half block (its upper half without rows), T = 384 has
    three blocks; valid parts end inside a group and on its edges; full
    rows and 5b's documents (201-250 valid tokens of 256) are the masks the
    training paths give; the cases hold DH 64 and 128 and GQA groups of 1
    to 4."""
    q, k, v, mask = _flash_inputs(cuda, b, t, nq, nkv, dh, lengths, seed=11 + dh, dtype=dtype)
    if left_pad is not None:
        mask = _left_pad(mask, b - 1, left_pad)
    scale = dh**-0.5
    out, lse = FA.attention_flash(q, k, v, mask, scale, with_lse=True)
    gen = torch.Generator(device=cuda).manual_seed(3)
    dout = torch.randn(out.shape, generator=gen, device=cuda).to(dtype)
    dout = (dout * mask[..., None]).contiguous()
    di = FA.row_dot(out, dout, nq)
    before = (FA.attention_flash_bwd_dq.launches, FA.attention_flash_bwd_dkv.launches)
    dq = FA.attention_flash_bwd_dq(q, k, v, mask, dout, lse, di, scale)
    dk, dv = FA.attention_flash_bwd_dkv(q, k, v, mask, dout, lse, di, scale)
    assert (FA.attention_flash_bwd_dq.launches, FA.attention_flash_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1,
    )
    want = FA.attention_flash_bwd_plain(q, k, v, mask, out, lse, dout, scale)
    tols = FA.bwd_kernel_tolerance(q, k, v, mask, lse, dout, di, scale)
    torch.cuda.synchronize()
    for name, got, ref, tol in zip(("dq", "dk", "dv"), (dq, dk, dv), want, tols):
        assert got.shape == ref.shape and got.dtype == dtype, name
        assert bool(torch.isfinite(got).all()), name
        err = float((got.float() - ref.float()).abs().max())
        assert err <= tol, (name, err, tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_backward_f32_is_the_same_in_every_repeated_launch(cuda, dtype):
    """The dq and dk/dv kernels, bf16 and float32, sum in a fixed order (no
    atomics; the streamed tiles are refilled only behind barriers), so 50
    launches on the same inputs give the first launch's bits, each of them:
    a check of one launch could miss a fault of a ring that shows in 1
    launch of 30."""
    b, t, nq, nkv, dh = 4, 256, 16, 8, 128
    q, k, v, mask = _flash_inputs(cuda, b, t, nq, nkv, dh, [256, 1, 130, 200], seed=13,
                                  dtype=dtype)
    mask = _left_pad(mask, b - 1, 66)
    scale = dh**-0.5
    out, lse = FA.attention_flash(q, k, v, mask, scale, with_lse=True)
    gen = torch.Generator(device=cuda).manual_seed(4)
    dout = torch.randn(out.shape, generator=gen, device=cuda) * mask[..., None]
    dout = dout.to(dtype).contiguous()
    di = FA.row_dot(out, dout, nq)
    args = (q, k, v, mask, dout, lse, di, scale)
    first = (FA.attention_flash_bwd_dq(*args), *FA.attention_flash_bwd_dkv(*args))
    differing = 0
    for _ in range(50):
        again = (FA.attention_flash_bwd_dq(*args), *FA.attention_flash_bwd_dkv(*args))
        differing += not all(torch.equal(x, y) for x, y in zip(first, again))
    torch.cuda.synchronize()
    assert differing == 0


def test_flash_backward_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q, k, v, mask = _flash_inputs(cuda, 1, 128, 4, 2, 64, [128], seed=1)
    out, lse = FA.attention_flash(q, k, v, mask, 0.125, with_lse=True)
    di = FA.row_dot(out, out, 4)
    for fn in (FA.attention_flash_bwd_dq, FA.attention_flash_bwd_dkv):
        with pytest.raises(TypeError, match="bf16 or float32"):
            fn(q.half(), k.half(), v.half(), mask, out.half(), lse, di, 0.125)
        with pytest.raises(ValueError, match="dout"):
            fn(q, k, v, mask, out.float(), lse, di, 0.125)
        with pytest.raises(ValueError, match="lse"):
            fn(q, k, v, mask, out, lse.to(torch.bfloat16), di, 0.125)
        with pytest.raises(ValueError, match="di"):
            fn(q, k, v, mask, out, lse, di[:, :2].contiguous(), 0.125)
        with pytest.raises(ValueError, match="multiple of 64"):
            fn(q[:, :96], k[:, :96], v[:, :96], mask[:, :96], out[:, :96],
               lse[..., :96].contiguous(), di[..., :96].contiguous(), 0.125)


def test_training_step_takes_each_flash_kernel_once_per_layer(cuda, monkeypatch):
    """One f32 InfoNCE step of make_train_step with the variable set, the
    documents at T = 256 and the queries at T = 64: the documents' forward
    launches K5 once per layer and the backward dq and dk/dv once per layer
    each; the queries take the einsum path. The loss is finite."""
    from lean_explore_tpu_torch.models import qwen3
    from lean_explore_tpu_torch.train import contrastive as C

    config = qwen3.Qwen3Config(
        vocab_size=64, hidden_size=256, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=64, intermediate_size=512,
    )
    optimizer_factory = C.make_optimizer(learning_rate=1e-5)
    params, opt_state = C.init_train_state(config, optimizer_factory, seed=0, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    mask_d = torch.ones(4, 256, dtype=torch.int32, device=cuda)
    mask_d[1, 120:] = 0
    batch = C.ContrastiveBatch(
        torch.randint(3, 64, (4, 64), generator=gen, device=cuda),
        torch.ones(4, 64, dtype=torch.int32, device=cuda),
        torch.randint(3, 64, (4, 256), generator=gen, device=cuda),
        mask_d,
        torch.zeros(4, 4, dtype=torch.bool, device=cuda),
    )
    monkeypatch.setenv("LEAN_EXPLORE_FLASH_ATTENTION", "1")
    step = C.make_train_step(config)
    counters = (FA.attention_flash, FA.attention_flash_bwd_dq, FA.attention_flash_bwd_dkv)
    before = [c.launches for c in counters]
    params, opt_state, metrics = step(params, opt_state, batch)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [2, 2, 2]
    assert np.isfinite(float(metrics["loss"]))
