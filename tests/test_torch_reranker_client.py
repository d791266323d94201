"""The port's reranker chooses its trunk dtype as the JAX client does
(lean_explore_tpu/util/reranker_client.py:113-119), and raises on int8.

``dtype=None`` means bf16 unless LEAN_EXPLORE_RERANKER_INT8=1, which means
int8. The W8A8 int8 trunk is not ported yet, so int8, chosen either way or
passed as ``dtype="int8"`` / ``torch.int8`` or ``from_components(int8=True)``,
raises NotImplementedError rather than silently serving bf16 scores.
"""

import pytest
import torch

from lean_explore_tpu_torch.models.hf_loader import load_params
from lean_explore_tpu_torch.models.tokenizer import load_tokenizer
from lean_explore_tpu_torch.util.reranker_client import (
    RerankerClient,
    resolve_param_dtype,
)
from tests.helpers import make_tiny_model_dir


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return make_tiny_model_dir(tmp_path_factory.mktemp("tiny_reranker"), seed=4)


def _client(model_dir, **kw):
    return RerankerClient(str(model_dir), model_dir=model_dir, device="cpu", **kw)


def test_int8_variable_raises(model_dir, monkeypatch):
    monkeypatch.setenv("LEAN_EXPLORE_RERANKER_INT8", "1")
    with pytest.raises(NotImplementedError, match="W8A8"):
        _client(model_dir)


@pytest.mark.parametrize("dtype", ["int8", torch.int8])
def test_int8_dtype_raises(model_dir, monkeypatch, dtype):
    monkeypatch.delenv("LEAN_EXPLORE_RERANKER_INT8", raising=False)
    with pytest.raises(NotImplementedError, match="W8A8"):
        _client(model_dir, dtype=dtype)


def test_from_components_int8_raises(model_dir):
    params, config = load_params(model_dir, dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match="W8A8"):
        RerankerClient.from_components(
            params, config, load_tokenizer(model_dir), int8=True
        )


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
