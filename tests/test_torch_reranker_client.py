"""The port's reranker chooses its trunk dtype as the JAX client does
(lean_explore_tpu/util/reranker_client.py:113-125) and serves the W8A8
int8 trunk on each route that asks for it.

``dtype=None`` means bf16 unless LEAN_EXPLORE_RERANKER_INT8=1, which means
int8; an explicit dtype wins. Int8, chosen by the variable, by
``dtype="int8"`` / ``torch.int8`` or by ``from_components(int8=True)``,
serves JAX's quantized params (``w8`` and ``scale`` equal bit for bit) and
JAX's int8 scores. The clients that load a checkpoint quantize its bf16
params, as JAX's do, so their trunks run in bf16 on both sides: scores agree
within BF16_TOL, one bf16 ulp of a probability in [0.5, 1). Quantized f32
params (``from_components``) agree within 1e-5, the f32 trunk tolerance of
tests/test_torch_qwen3.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lean_explore_tpu.models import qwen3 as jax_qwen3
from lean_explore_tpu.models.hf_loader import load_params as jax_load_params
from lean_explore_tpu.models.tokenizer import load_tokenizer as jax_load_tokenizer
from lean_explore_tpu.util.reranker_client import RerankerClient as JaxReranker
from lean_explore_tpu_torch.models import qwen3
from lean_explore_tpu_torch.models.hf_loader import load_params
from lean_explore_tpu_torch.models.tokenizer import load_tokenizer
from lean_explore_tpu_torch.util.reranker_client import (
    RerankerClient,
    resolve_param_dtype,
)
from tests.helpers import make_tiny_model_dir

BF16_TOL = 2.0**-8
QUERY = "nat add comm"
DOCS = [
    "the sum of two natural numbers", "continuous function map",
    "prime numbers of a b", "addition of natural numbers",
]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return make_tiny_model_dir(tmp_path_factory.mktemp("tiny_reranker"), seed=4)


def _client(model_dir, **kw):
    return RerankerClient(str(model_dir), model_dir=model_dir, device="cpu", **kw)


def _expect_jax_int8(port, jax_client, tol):
    """The port client's params and scores are the JAX int8 client's."""
    assert port.int8 and jax_client.int8
    for name, leaf in port.params["layers"].items():
        if name in qwen3._INT8_PROJS:
            want = jax_client.params["layers"][name]
            assert leaf["w8"].dtype == torch.int8
            np.testing.assert_array_equal(leaf["w8"].numpy(), np.asarray(want["w8"]))
            np.testing.assert_array_equal(leaf["scale"].numpy(), np.asarray(want["scale"]))
    got = port.rerank_sync(QUERY, DOCS).scores
    want = jax_client.rerank_sync(QUERY, DOCS).scores
    np.testing.assert_allclose(got, want, atol=tol)


def test_int8_variable_serves_int8(model_dir, monkeypatch):
    monkeypatch.setenv("LEAN_EXPLORE_RERANKER_INT8", "1")
    port = _client(model_dir, max_length=64)
    assert port.params["embed"].dtype == torch.bfloat16
    _expect_jax_int8(
        port, JaxReranker(str(model_dir), model_dir=model_dir, max_length=64), BF16_TOL
    )


@pytest.mark.parametrize("dtype", ["int8", torch.int8])
def test_int8_dtype_serves_int8(model_dir, monkeypatch, dtype):
    monkeypatch.delenv("LEAN_EXPLORE_RERANKER_INT8", raising=False)
    port = _client(model_dir, dtype=dtype, max_length=64)
    jax_client = JaxReranker(
        str(model_dir), model_dir=model_dir, dtype="int8", max_length=64
    )
    _expect_jax_int8(port, jax_client, BF16_TOL)


def test_from_components_int8_serves_quantized_params(model_dir):
    params, config = load_params(model_dir, dtype=torch.float32, device="cpu")
    port = RerankerClient.from_components(
        qwen3.quantize_params_int8(params), config, load_tokenizer(model_dir),
        max_length=64, int8=True,
    )
    jax_params, jax_config = jax_load_params(model_dir, dtype=jnp.float32)
    jax_client = JaxReranker.from_components(
        jax_qwen3.quantize_params_int8(jax_params), jax_config,
        jax_load_tokenizer(model_dir), max_length=64, int8=True,
    )
    _expect_jax_int8(port, jax_client, 1e-5)


@pytest.mark.parametrize(
    "env,dtype,want",
    [
        (None, None, torch.bfloat16),
        ("0", None, torch.bfloat16),
        ("1", torch.bfloat16, torch.bfloat16),  # an explicit dtype wins, as in JAX
        ("1", "float32", torch.float32),
        (None, "bfloat16", torch.bfloat16),
    ],
)
def test_dtype_choice(monkeypatch, env, dtype, want):
    if env is None:
        monkeypatch.delenv("LEAN_EXPLORE_RERANKER_INT8", raising=False)
    else:
        monkeypatch.setenv("LEAN_EXPLORE_RERANKER_INT8", env)
    assert resolve_param_dtype(dtype) == want


def test_explicit_bf16_serves_with_the_variable_set(model_dir, monkeypatch):
    monkeypatch.setenv("LEAN_EXPLORE_RERANKER_INT8", "1")
    client = _client(model_dir, dtype=torch.bfloat16, max_length=64)
    assert client.params["embed"].dtype == torch.bfloat16
    scores = client.rerank_pairs_sync(["nat add"], ["Nat.add_comm: adds"])
    assert len(scores) == 1 and 0.0 <= scores[0] <= 1.0


def test_unknown_dtype_raises():
    with pytest.raises(ValueError, match="float16"):
        resolve_param_dtype("float16")
