"""Port Qwen3 trunk vs the JAX trunk, in float32 on the CPU.

Both packages load the same checkpoints: tiny random ones written by
``tests.helpers.make_tiny_model_dir`` and the committed
``runs/scale200k/{embedder,reranker}/checkpoint``. The JAX weights also
carry across through ``params_from_jax``. Tolerances are those of
tests/models_nn/test_qwen3_parity.py (the JAX trunk against transformers):
hidden states 2e-4, reranker probabilities 1e-5 and unit-norm embeddings
1e-5; both sides sum in f32 in different orders.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lean_explore_tpu.models import qwen3 as jq
from lean_explore_tpu.models.hf_loader import load_params as jax_load_params
from lean_explore_tpu_torch.models import qwen3 as tq
from lean_explore_tpu_torch.models.hf_loader import (
    load_params as torch_load_params,
    params_from_jax,
    read_safetensors,
)
from tests.helpers import make_tiny_model_dir

REPO = Path(__file__).resolve().parent.parent
COMMITTED = REPO / "runs" / "scale200k"


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = make_tiny_model_dir(tmp_path_factory.mktemp("tiny_qwen3"), seed=3)
    jparams, jconfig = jax_load_params(path, dtype=jnp.float32)
    tparams, tconfig = torch_load_params(path, dtype=torch.float32, device="cpu")
    return path, jparams, jconfig, tparams, tconfig


def _masks(vocab: int):
    rng = np.random.default_rng(1)
    ids = rng.integers(3, vocab, size=(3, 12)).astype(np.int32)
    full = np.ones((3, 12), dtype=np.int32)
    right = full.copy()
    right[0, 8:] = 0
    right[1, 5:] = 0
    left = full.copy()
    left[0, :4] = 0
    left[2, :7] = 0
    return ids, {"full": full, "right": right, "left": left}


def test_safetensors_reader_matches_package(tiny):
    from safetensors.numpy import load_file

    path = tiny[0] / "model.safetensors"
    want = load_file(str(path))
    got = read_safetensors(path)
    assert set(got) == set(want)
    for name, array in want.items():
        np.testing.assert_array_equal(got[name], array)


def test_loaders_agree(tiny):
    _, jparams, jconfig, tparams, tconfig = tiny
    assert tconfig == tq.Qwen3Config(**jconfig.__dict__)
    carried = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    for name in ("embed", "final_norm"):
        assert torch.equal(carried[name], tparams[name])
    for name, w in tparams["layers"].items():
        assert torch.equal(carried["layers"][name], w)
        assert w.dtype == torch.float32


def test_default_device_needs_cuda(tiny, monkeypatch):
    """The loaders put weights on CUDA unless asked for the CPU, and raise
    rather than fall back quietly when CUDA is missing."""
    path, jparams, jconfig = tiny[:3]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_load_params(path, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax(jax.tree.map(np.asarray, jparams))
    config = tq.Qwen3Config(**jconfig.__dict__)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tq.init_params(config, torch.Generator(), device="cuda")
    cpu = tq.init_params(config, torch.Generator().manual_seed(0))
    assert cpu["embed"].device.type == "cpu"


@pytest.mark.parametrize("mask_kind", ["full", "right", "left"])
def test_forward_hidden(tiny, mask_kind):
    _, jparams, jconfig, tparams, tconfig = tiny
    ids, masks = _masks(jconfig.vocab_size)
    mask = masks[mask_kind]
    want = np.asarray(jq.forward_hidden(jparams, jconfig, ids, mask))
    got = tq.forward_hidden(tparams, tconfig, _t(ids), _t(mask)).numpy()
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], atol=2e-4, rtol=2e-4)


def test_embed_pool_from_ids(tiny):
    _, jparams, jconfig, tparams, tconfig = tiny
    ids, masks = _masks(jconfig.vocab_size)
    lengths = masks["right"].sum(axis=1).astype(np.int32)
    want = np.asarray(jq.embed_pool_from_ids(jparams, jconfig, ids, lengths))
    got = tq.embed_pool_from_ids(tparams, tconfig, _t(ids), _t(lengths)).numpy()
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


def test_rerank_scores(tiny):
    _, jparams, jconfig, tparams, tconfig = tiny
    ids, masks = _masks(jconfig.vocab_size)
    kw = dict(token_true=3, token_false=4)
    want = np.asarray(jq.rerank_scores(jparams, jconfig, ids, masks["left"], **kw))
    got = tq.rerank_scores(tparams, tconfig, _t(ids), _t(masks["left"]), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def _grouped_inputs(vocab: int, seed: int = 7):
    """Two query groups of three documents: prefixes of 6 and 4 valid tokens
    (padded to 8), suffixes of varied lengths (padded to 5)."""
    rng = np.random.default_rng(seed)
    g, d, p, s = 2, 3, 8, 5
    prefix_ids = rng.integers(3, vocab, size=(g, p)).astype(np.int32)
    prefix_mask = np.zeros((g, p), dtype=np.int32)
    prefix_mask[0, :6] = 1
    prefix_mask[1, :4] = 1
    suffix_ids = rng.integers(3, vocab, size=(g, d, s)).astype(np.int32)
    suffix_mask = np.zeros((g, d, s), dtype=np.int32)
    for gi, lens in enumerate([(5, 3, 1), (2, 4, 5)]):
        for di, n in enumerate(lens):
            suffix_mask[gi, di, :n] = 1
    pos_offset = prefix_mask.sum(axis=1).astype(np.int32)
    return prefix_ids, prefix_mask, suffix_ids, suffix_mask, pos_offset


def _grouped_both(jparams, jconfig, tparams, tconfig, inputs, kw):
    prefix_ids, prefix_mask, suffix_ids, suffix_mask, pos_offset = inputs
    jpk, jpv = jq.prefix_kv(jparams, jconfig, prefix_ids, prefix_mask)
    want = np.asarray(
        jq.rerank_scores_grouped(
            jparams, jconfig, jpk, jpv, prefix_mask, suffix_ids, suffix_mask,
            pos_offset, group_chunk=1, **kw,
        )
    )
    tpk, tpv = tq.prefix_kv(tparams, tconfig, _t(prefix_ids), _t(prefix_mask))
    np.testing.assert_allclose(tpk.numpy(), np.asarray(jpk), atol=2e-4, rtol=2e-4)
    got = tq.rerank_scores_grouped(
        tparams, tconfig, tpk, tpv, _t(prefix_mask), _t(suffix_ids),
        _t(suffix_mask), _t(pos_offset), group_chunk=1, **kw,
    ).numpy()
    return got, want


def test_rerank_grouped_matches_jax_and_flat(tiny):
    _, jparams, jconfig, tparams, tconfig = tiny
    inputs = _grouped_inputs(jconfig.vocab_size)
    kw = dict(token_true=3, token_false=4)
    got, want = _grouped_both(jparams, jconfig, tparams, tconfig, inputs, kw)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)

    # Inside the port, the grouped scores are the flat forward's scores on
    # the unsplit pairs (prefix valid tokens + suffix valid tokens).
    prefix_ids, prefix_mask, suffix_ids, suffix_mask, _ = inputs
    for gi in range(2):
        head = prefix_ids[gi, prefix_mask[gi] == 1]
        for di in range(3):
            tail = suffix_ids[gi, di, suffix_mask[gi, di] == 1]
            pair = np.concatenate([head, tail])[None]
            flat = tq.rerank_scores(
                tparams, tconfig, _t(pair), torch.ones(pair.shape, dtype=torch.int32),
                **kw,
            )
            np.testing.assert_allclose(float(flat[0]), got[gi, di], atol=1e-5)


@pytest.mark.parametrize("model", ["embedder", "reranker"])
def test_committed_checkpoint(model):
    path = COMMITTED / model / "checkpoint"
    jparams, jconfig = jax_load_params(path, dtype=jnp.float32)
    tparams, tconfig = torch_load_params(path, dtype=torch.float32, device="cpu")
    ids, masks = _masks(jconfig.vocab_size)
    if model == "embedder":
        lengths = masks["right"].sum(axis=1).astype(np.int32)
        want = np.asarray(jq.embed_pool_from_ids(jparams, jconfig, ids, lengths))
        got = tq.embed_pool_from_ids(tparams, tconfig, _t(ids), _t(lengths))
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)
    else:
        inputs = _grouped_inputs(jconfig.vocab_size)
        kw = dict(token_true=10357, token_false=2503)  # "true", "false"
        got, want = _grouped_both(jparams, jconfig, tparams, tconfig, inputs, kw)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# ----------------------------------------------------------------------
# Flash attention through the trunk (LEAN_EXPLORE_FLASH_ATTENTION)
# ----------------------------------------------------------------------

FLASH_T = 256


def _flash_inputs(vocab: int):
    """Two rows at the flash threshold T = 256: one right-padded to 150
    valid tokens, one full."""
    rng = np.random.default_rng(11)
    ids = rng.integers(3, vocab, size=(2, FLASH_T)).astype(np.int32)
    mask = np.ones((2, FLASH_T), dtype=np.int32)
    mask[0, 150:] = 0
    return ids, mask


@pytest.fixture(scope="module")
def jax_flash_hidden(tiny):
    """The JAX trunk's forward_hidden(flash=True), its Pallas TPU flash
    kernel run in interpret mode on the CPU."""
    from jax.experimental.pallas import tpu as pltpu

    _, jparams, jconfig = tiny[:3]
    ids, mask = _flash_inputs(jconfig.vocab_size)
    with pltpu.force_tpu_interpret_mode():
        hidden = jq.forward_hidden(jparams, jconfig, ids, mask, flash=True)
    return ids, mask, np.asarray(hidden)


def test_forward_hidden_flash_matches_jax(tiny, jax_flash_hidden):
    """f32 trunk, both sides on flash attention: hidden states within the
    trunk tolerance 2e-4 on valid rows."""
    _, _, _, tparams, tconfig = tiny
    ids, mask, want = jax_flash_hidden
    before = tq.flash_ops.attention_flash.launches
    got = tq.forward_hidden(tparams, tconfig, _t(ids), _t(mask), flash=True).numpy()
    assert tq.flash_ops.attention_flash.launches == before  # CPU: the twin
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], atol=2e-4, rtol=2e-4)
    # Flash and the einsum attention agree on valid rows inside the port.
    einsum = tq.forward_hidden(tparams, tconfig, _t(ids), _t(mask), flash=False).numpy()
    np.testing.assert_allclose(got[valid], einsum[valid], atol=2e-4, rtol=2e-4)


def test_embed_pool_flash_matches_jax(tiny, jax_flash_hidden, monkeypatch):
    """embed_pool and embed_pool_from_ids reach flash through
    forward_hidden's deferral to _use_flash (forced on here: on the CPU it
    is off): unit-norm embeddings of the JAX flash forward's last valid
    rows within 2e-4."""
    _, _, _, tparams, tconfig = tiny
    ids, mask, hidden = jax_flash_hidden
    last = mask.shape[1] - 1 - np.argmax(mask[:, ::-1], axis=1)
    pooled = hidden[np.arange(len(ids)), last]
    want = pooled / np.linalg.norm(pooled, axis=1, keepdims=True)
    calls = []
    monkeypatch.setattr(
        tq, "_use_flash", lambda seq_len, device: calls.append(seq_len) or True
    )
    got = tq.embed_pool(tparams, tconfig, _t(ids), _t(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    lengths = torch.from_numpy(mask.sum(axis=1).astype(np.int32))
    got = tq.embed_pool_from_ids(tparams, tconfig, _t(ids), lengths).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    assert calls == [FLASH_T, FLASH_T]


def test_rerank_scores_and_logits_with_flash(tiny, monkeypatch):
    """rerank_scores and last_token_logits on flash (forced on) against the
    JAX trunk's einsum forward: f32, reranker probabilities within 1e-5,
    logits within 2e-4."""
    _, jparams, jconfig, tparams, tconfig = tiny
    ids, mask = _flash_inputs(jconfig.vocab_size)
    kw = dict(token_true=3, token_false=4)
    want = np.asarray(jq.rerank_scores(jparams, jconfig, ids, mask, **kw))
    want_logits = np.asarray(jq.last_token_logits(jparams, jconfig, ids, mask))
    monkeypatch.setattr(tq, "_use_flash", lambda seq_len, device: True)
    got = tq.rerank_scores(tparams, tconfig, _t(ids), _t(mask), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    logits = tq.last_token_logits(tparams, tconfig, _t(ids), _t(mask)).numpy()
    np.testing.assert_allclose(logits, want_logits, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("mask_kind", ["full", "right", "left"])
def test_last_token_logits(tiny, mask_kind):
    """The head on the last valid position only, [B, V] f32, against the
    JAX trunk: logits within 2e-4."""
    _, jparams, jconfig, tparams, tconfig = tiny
    ids, masks = _masks(jconfig.vocab_size)
    mask = masks[mask_kind]
    want = np.asarray(jq.last_token_logits(jparams, jconfig, ids, mask))
    got = tq.last_token_logits(tparams, tconfig, _t(ids), _t(mask))
    assert got.dtype == torch.float32 and got.shape == (3, jconfig.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize(
    "env,seq,device,want",
    [
        (None, 512, "cuda", False),  # opt-in only
        ("1", 512, "cpu", False),  # a CUDA device only
        ("1", 256, "cuda", True),
        ("1", 512, "cuda", True),
        ("1", 384, "cuda", True),
        ("1", 128, "cuda", False),  # below FLASH_MIN_SEQ
        ("1", 320, "cuda", False),  # not a multiple of 128
    ],
)
def test_use_flash(monkeypatch, env, seq, device, want):
    if env is None:
        monkeypatch.delenv("LEAN_EXPLORE_FLASH_ATTENTION", raising=False)
    else:
        monkeypatch.setenv("LEAN_EXPLORE_FLASH_ATTENTION", env)
    assert tq._use_flash(seq, torch.device(device)) is want


def test_flash_variable_is_read_per_call_and_off_on_the_cpu(tiny, monkeypatch):
    """With the variable set, a CPU forward still takes the einsum path
    (_use_flash is False off CUDA), so it equals flash=False exactly."""
    _, _, jconfig, tparams, tconfig = tiny
    ids, mask = _flash_inputs(jconfig.vocab_size)
    monkeypatch.setenv("LEAN_EXPLORE_FLASH_ATTENTION", "1")
    got = tq.forward_hidden(tparams, tconfig, _t(ids), _t(mask))
    want = tq.forward_hidden(tparams, tconfig, _t(ids), _t(mask), flash=False)
    assert torch.equal(got, want)
