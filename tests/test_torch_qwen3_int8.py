"""The port's serving layouts of the Qwen3 trunk against the JAX trunk's, on
the CPU: the W8A8 int8 projections (``quantize_params_int8``,
``_linear_q8``), the fused q/k/v and gate/up layout
(``fuse_params_for_serving``) and ``rerank_scores_chained``.

Both packages load the same checkpoints (a tiny random one from
``tests.helpers.make_tiny_model_dir`` and the committed
``runs/reranker/checkpoint``) in float32 and score the same numpy-seeded
ids. Tolerances:
- quantized weights and scales: bit for bit (the same f32 arithmetic);
- ``_linear_q8``: 1e-6 relative, f32 rounding of the rescale (the int8
  codes and the int32 sums are exact);
- reranker probabilities: dense and fused 1e-5, the f32 trunk tolerance
  of tests/test_torch_qwen3.py; fused against unfused and against JAX's
  fused layout 1e-6 (each output column is the same dot product); int8
  INT8_TOL. An activation's code is rounded half to even from f32 values
  whose last bits differ between the two packages' sum orders, so a value
  at a rounding tie may take the next code in one package: one such flip
  moved P(true) by 3.9e-4 on these inputs (the committed checkpoint; every
  other score agreed within 1e-5). INT8_TOL, 1e-3, is a hundredth of the
  int8 trunk's own drift bound against the dense trunk (0.1,
  tests/models_nn/test_qwen3_int8.py);
- ``rerank_scores_chained``: bit for bit against separate calls.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lean_explore_tpu.models import qwen3 as jq
from lean_explore_tpu.models.hf_loader import load_params as jax_load_params
from lean_explore_tpu_torch.models import qwen3 as tq
from lean_explore_tpu_torch.models.hf_loader import load_params as torch_load_params
from tests.helpers import make_tiny_model_dir

REPO = Path(__file__).resolve().parent.parent
TOKENS = dict(token_true=3, token_false=4)
INT8_TOL = 1e-3


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module", params=["tiny", "committed"])
def checkpoint(request, tmp_path_factory):
    if request.param == "tiny":
        path = make_tiny_model_dir(tmp_path_factory.mktemp("tiny_int8"), seed=7)
    else:
        path = REPO / "runs" / "reranker" / "checkpoint"
    jparams, jconfig = jax_load_params(path, dtype=jnp.float32)
    tparams, tconfig = torch_load_params(path, dtype=torch.float32, device="cpu")
    return jparams, jconfig, tparams, tconfig


def _batch(vocab: int, rows: int = 4, seq: int = 12):
    rng = np.random.default_rng(2)
    ids = rng.integers(5, vocab, size=(rows, seq)).astype(np.int32)
    mask = np.ones((rows, seq), dtype=np.int32)
    mask[1, 8:] = 0
    mask[2, 3:] = 0
    return ids, mask


def _scores(module, params, config, ids, mask, wrap):
    return np.asarray(module.rerank_scores(params, config, wrap(ids), wrap(mask), **TOKENS))


def _expect_same_quant(tparams, jparams):
    names = [n for n in tq._INT8_PROJS if n in tparams["layers"]]
    assert names == [n for n in jq._INT8_PROJS if n in jparams["layers"]]
    for name in names:
        got, want = tparams["layers"][name], jparams["layers"][name]
        assert got["w8"].dtype == torch.int8 and got["scale"].dtype == torch.float32
        np.testing.assert_array_equal(got["w8"].numpy(), np.asarray(want["w8"]))
        np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))


@pytest.mark.parametrize("fused", [False, True], ids=["per_projection", "fused"])
def test_quantize_params_int8_is_jax_s_bit_for_bit(checkpoint, fused):
    jparams, _, tparams, _ = checkpoint
    if fused:
        jparams, tparams = jq.fuse_params_for_serving(jparams), tq.fuse_params_for_serving(tparams)
    quantized = tq.quantize_params_int8(tparams)
    _expect_same_quant(quantized, jq.quantize_params_int8(jparams))
    assert quantized["embed"] is tparams["embed"]
    for name in ("input_norm", "q_norm", "k_norm", "post_norm"):
        assert quantized["layers"][name] is tparams["layers"][name]


@pytest.mark.parametrize("lead", [(5,), (40,), (2, 3, 7)], ids=["5_rows_padded", "40_rows", "3d"])
def test_linear_q8_matches_jax(lead):
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((1, 64, 48)) * 0.05).astype(np.float32)
    h = rng.standard_normal((*lead, 64)).astype(np.float32)
    h[0] *= 0.0  # an all-zero row takes the 1e-12 scale floor
    jquant = jq.quantize_params_int8({"layers": {"q_proj": jnp.asarray(w)}})["layers"]["q_proj"]
    tquant = tq.quantize_params_int8({"layers": {"q_proj": _t(w)}})["layers"]["q_proj"]
    want = np.asarray(jq._linear_q8(jnp.asarray(h), {k: v[0] for k, v in jquant.items()}))
    got = tq._linear_q8(_t(h), {k: v[0] for k, v in tquant.items()})
    assert got.shape == (*lead, 48) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape", [(12, 16), (16, 20)], ids=["inner_12", "outer_20"])
def test_int_mm_raises_on_a_size_it_cannot_take(shape):
    k, n = shape
    w8 = torch.ones(k, n, dtype=torch.int8)
    with pytest.raises(ValueError, match="multiples of 8"):
        tq._proj(torch.ones(20, k), {"w8": w8, "scale": torch.ones(1, n)})


def test_rerank_scores_int8_match_jax(checkpoint):
    jparams, jconfig, tparams, tconfig = checkpoint
    ids, mask = _batch(tconfig.vocab_size)
    want = _scores(jq, jq.quantize_params_int8(jparams), jconfig, ids, mask, jnp.asarray)
    got = _scores(tq, tq.quantize_params_int8(tparams), tconfig, ids, mask, _t)
    np.testing.assert_allclose(got, want, atol=INT8_TOL)
    dense = _scores(tq, tparams, tconfig, ids, mask, _t)
    assert 0 < np.abs(got - dense).max() < 0.1


def _grouped(module, params, config, wrap):
    rng = np.random.default_rng(4)
    g, d, p_len, s_len = 4, 3, 6, 5
    prefix = rng.integers(5, config.vocab_size, size=(g, p_len)).astype(np.int32)
    prefix_mask = np.ones((g, p_len), dtype=np.int32)
    prefix_mask[3, 4:] = 0
    suffix = rng.integers(5, config.vocab_size, size=(g, d, s_len)).astype(np.int32)
    suffix_mask = np.ones((g, d, s_len), dtype=np.int32)
    suffix_mask[1, 2, 3:] = 0
    offsets = prefix_mask.sum(axis=1).astype(np.int32)
    pk, pv = module.prefix_kv(params, config, wrap(prefix), wrap(prefix_mask))
    return np.asarray(module.rerank_scores_grouped(
        params, config, pk, pv, wrap(prefix_mask), wrap(suffix), wrap(suffix_mask),
        wrap(offsets), group_chunk=2, **TOKENS,
    ))


def test_grouped_scores_int8_match_jax(checkpoint):
    jparams, jconfig, tparams, tconfig = checkpoint
    want = _grouped(jq, jq.quantize_params_int8(jparams), jconfig, jnp.asarray)
    got = _grouped(tq, tq.quantize_params_int8(tparams), tconfig, _t)
    np.testing.assert_allclose(got, want, atol=INT8_TOL)


def test_fused_layout_matches_unfused_and_jax(checkpoint):
    jparams, jconfig, tparams, tconfig = checkpoint
    fused = tq.fuse_params_for_serving(tparams)
    layers = fused["layers"]
    nq, nkv, dh = tconfig.num_attention_heads, tconfig.num_key_value_heads, tconfig.head_dim
    assert "q_proj" not in layers and "gate_proj" not in layers
    assert layers["qkv_proj"].shape == (
        tconfig.num_hidden_layers, tconfig.hidden_size, (nq + 2 * nkv) * dh
    )
    assert layers["gate_up_proj"].shape[-1] == 2 * tconfig.intermediate_size
    ids, mask = _batch(tconfig.vocab_size)
    plain = _scores(tq, tparams, tconfig, ids, mask, _t)
    got = _scores(tq, fused, tconfig, ids, mask, _t)
    want = _scores(jq, jq.fuse_params_for_serving(jparams), jconfig, ids, mask, jnp.asarray)
    np.testing.assert_allclose(got, plain, atol=1e-6)
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(
        _grouped(tq, fused, tconfig, _t), _grouped(tq, tparams, tconfig, _t), atol=1e-6
    )
    emb = tq.embed_pool(fused, tconfig, _t(ids), _t(mask)).numpy()
    np.testing.assert_allclose(emb, tq.embed_pool(tparams, tconfig, _t(ids), _t(mask)).numpy(), atol=1e-6)


def test_fuse_then_quantize_matches_jax(checkpoint):
    jparams, jconfig, tparams, tconfig = checkpoint
    tq8 = tq.quantize_params_int8(tq.fuse_params_for_serving(tparams))
    jq8 = jq.quantize_params_int8(jq.fuse_params_for_serving(jparams))
    _expect_same_quant(tq8, jq8)
    ids, mask = _batch(tconfig.vocab_size)
    np.testing.assert_allclose(
        _scores(tq, tq8, tconfig, ids, mask, _t),
        _scores(jq, jq8, jconfig, ids, mask, jnp.asarray),
        atol=INT8_TOL,
    )


@pytest.mark.parametrize("which", ["already_fused", "quantized"])
def test_fuse_rejects_what_jax_rejects(checkpoint, which):
    jparams, _, tparams, _ = checkpoint
    if which == "already_fused":
        tin, jin, match = (tq.fuse_params_for_serving(tparams),
                           jq.fuse_params_for_serving(jparams), "already fused")
    else:
        tin, jin, match = tq.quantize_params_int8(tparams), jq.quantize_params_int8(jparams), "dense weights"
    with pytest.raises(ValueError, match=match):
        tq.fuse_params_for_serving(tin)
    with pytest.raises(ValueError, match=match):
        jq.fuse_params_for_serving(jin)


@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
def test_rerank_scores_chained_equals_separate_calls(checkpoint, int8):
    _, _, tparams, tconfig = checkpoint
    params = tq.quantize_params_int8(tparams) if int8 else tparams
    rng = np.random.default_rng(5)
    ids = rng.integers(5, tconfig.vocab_size, size=(3, 4, 10)).astype(np.int32)
    mask = np.ones((3, 4, 10), dtype=np.int32)
    mask[1, 2, 6:] = 0
    chained = tq.rerank_scores_chained(params, tconfig, _t(ids), _t(mask), **TOKENS)
    assert chained.shape == (3, 4)
    for g in range(3):
        single = tq.rerank_scores(params, tconfig, _t(ids[g]), _t(mask[g]), **TOKENS)
        assert torch.equal(chained[g], single)
