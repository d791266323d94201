"""The port's training subsystem (``lean_explore_tpu_torch.train``) against
the JAX package's (``lean_explore_tpu.train``) on the CPU, at the tiny
config, with the same seeded numpy inputs and the same params carried
across (``hf_loader.params_from_jax``).

Tolerances, all float32:

- Losses: both sides compute the same f32 graph, summed in other orders;
  f32 roundoff (2^-24) over sums of at most 128 terms through two layers
  and a [B, B] cross-entropy moves a loss of about 2-7 by well under 1e-5
  relative, the bound used.
- Gradients: the same arithmetic backwards, so each parameter tensor's
  gradient within a relative L2 error of 1e-5 (2^-24 * 128 terms ~ 8e-6
  per dot product, compounded over the two layers; observed ~1e-6).
- Params after n AdamW steps: Adam's update of one entry is
  u = mu_hat / (sqrt(nu_hat) + eps), at most U_t = sqrt(sum_i w_i^2 / v_i)
  in size (Cauchy-Schwarz over the bias-corrected weights w_i, v_i of the
  t gradients so far: 1 at t = 1, 1.0013 at t = 2), whatever the
  gradients. Where the two frameworks' gradients of an entry are tiny and
  differ in sign, the updates differ by up to 2 lr U_t, so params agree
  within 2 lr sum_t U_t (plus 2^-23 |p| for the rounding of p itself).
  Where gradients are not tiny, the moments pin the update: mu and nu
  after a step agree within the gradient tolerance. A later step's loss
  differs from JAX's by at most the first-order change sum |g| |dp| over
  the params' difference dp, doubled for the second-order term, plus the
  loss tolerance.
- The optimizer alone (the same gradients fed to both): the same formula,
  but optax forms the bias corrections 1 - b^t in f32 (b^t within
  t 2^-24 of its value, so 1 - b2^t within 2^-24 / (1 - b2) relative, and
  the update, through its square root, within half of that plus
  2^-24 / (1 - b1)), where torch takes them in double: each step's update
  within lr U_t (2^-25 / (1 - b2) + 2^-24 / (1 - b1)), plus one rounding of
  p, 2^-23 |p|, a step.
- A scheduled rate (warmup then cosine): the same bounds with each step's
  lr_t = schedule(t - 1) in place of lr, 2 sum_t lr_t U_t; the rate each
  step used equals optax's at the same count within 1e-6 relative (both
  round the schedule to float32; their cosines may differ in the last bit).
"""

import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from transformers import AutoTokenizer

from lean_explore_tpu.models import Declaration, DeclarationStore
from lean_explore_tpu.models import qwen3 as jq
from lean_explore_tpu.parallel import TRAIN_AXES, make_mesh
from lean_explore_tpu.train import contrastive as JC
from lean_explore_tpu.train import cross_encoder as JX
from lean_explore_tpu.train import data as JD
from lean_explore_tpu.train import export as JE
from lean_explore_tpu_torch.models import hf_loader
from lean_explore_tpu_torch.models import qwen3 as tq
from lean_explore_tpu_torch.models.store import DeclarationStore as TorchStore
from lean_explore_tpu_torch.models.tokenizer import load_tokenizer
from lean_explore_tpu_torch.train import __main__ as cli
from lean_explore_tpu_torch.train import checkpoint as TK
from lean_explore_tpu_torch.train import contrastive as TC
from lean_explore_tpu_torch.train import cross_encoder as TX
from lean_explore_tpu_torch.train import data as TD
from lean_explore_tpu_torch.train import export as TE
from tests.helpers import make_tiny_model_dir

LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-5
TOKEN_TRUE, TOKEN_FALSE = 3, 4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_params(jax_params):
    return TC.trainable(hf_loader.params_from_jax(_np_tree(jax_params), device="cpu"))


def _assert_grads(got: list[torch.Tensor], want: list[np.ndarray]) -> None:
    for g, w in zip(got, want):
        err = np.linalg.norm(g.detach().numpy() - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= GRAD_REL_L2, err


def _flash_docs(monkeypatch, on: bool) -> None:
    """The port's trunk takes its flash attention (the kernels' plain
    twins on the CPU) at T >= 256 when ``on``: the documents, not the
    64-token queries."""
    monkeypatch.setattr(tq, "_use_flash", lambda seq_len, device: on and seq_len >= 256)


@pytest.fixture(scope="module")
def tiny():
    config = jq.Qwen3Config.tiny()
    params = jq.init_params(config, jax.random.PRNGKey(0))
    return config, params, tq.Qwen3Config.tiny()


def _contrastive_arrays(seed=0, b=4):
    rng = np.random.default_rng(seed)
    q_ids = rng.integers(5, 512, (b, 64)).astype(np.int32)
    q_mask = np.ones((b, 64), np.int32)
    q_mask[1, 30:] = 0
    d_ids = rng.integers(5, 512, (b, 256)).astype(np.int32)
    d_mask = np.ones((b, 256), np.int32)
    d_mask[0, 100:] = 0
    d_mask[2, 200:] = 0
    dup = np.zeros((b, b), bool)
    dup[0, 3] = dup[3, 0] = True
    return q_ids, q_mask, d_ids, d_mask, dup


def _jax_batch(arrays):
    return JC.ContrastiveBatch(*(jnp.asarray(x) for x in arrays))


def _torch_batch(arrays):
    return TC.ContrastiveBatch(*(torch.from_numpy(x) for x in arrays))


@pytest.fixture(scope="module")
def jax_infonce(tiny):
    config, params, _ = tiny
    arrays = _contrastive_arrays()
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: JC.infonce_loss(p, config, _jax_batch(arrays)), has_aux=True
    )(params)
    return arrays, float(loss), float(metrics["accuracy"]), TC.param_leaves(_np_tree(grads))


@pytest.mark.parametrize("flash", [False, True])
def test_infonce_loss_and_gradients_match_jax(tiny, jax_infonce, monkeypatch, flash):
    """The JAX loss runs its einsum attention on the CPU; the port's
    documents take flash attention when ``flash`` (forward and backward
    twins), the einsum otherwise: the same loss and gradients either way."""
    _, jparams, tconfig = tiny
    arrays, want_loss, want_acc, want_grads = jax_infonce
    _flash_docs(monkeypatch, flash)
    params = _torch_params(jparams)
    loss, metrics = TC.infonce_loss(params, tconfig, _torch_batch(arrays))
    loss.backward()
    assert math.isclose(float(metrics["loss"]), want_loss, rel_tol=LOSS_RTOL)
    assert float(metrics["accuracy"]) == want_acc
    _assert_grads([p.grad for p in TC.param_leaves(params)], want_grads)


def _ce_arrays(seed=1, b=4):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 512, (b, 256)).astype(np.int32)
    mask = np.ones((b, 256), np.int32)
    mask[1, 150:] = 0
    mask[3, 40:] = 0
    labels = np.array([1, 0, 1, 0], np.int32)
    return ids, mask, labels


@pytest.mark.parametrize("flash", [False, True])
def test_cross_encoder_loss_and_gradients_match_jax(tiny, monkeypatch, flash):
    config, jparams, tconfig = tiny
    ids, mask, labels = _ce_arrays()
    kw = dict(token_true=TOKEN_TRUE, token_false=TOKEN_FALSE)
    (want, _), grads = jax.value_and_grad(
        lambda p: JX.cross_encoder_loss(
            p, config, JX.CrossEncoderBatch(*(jnp.asarray(x) for x in (ids, mask, labels))), **kw
        ),
        has_aux=True,
    )(jparams)
    _flash_docs(monkeypatch, flash)
    params = _torch_params(jparams)
    batch = TX.CrossEncoderBatch(*(torch.from_numpy(x) for x in (ids, mask, labels)))
    loss, metrics = TX.cross_encoder_loss(params, tconfig, batch, **kw)
    loss.backward()
    assert math.isclose(float(metrics["loss"]), float(want), rel_tol=LOSS_RTOL)
    _assert_grads([p.grad for p in TC.param_leaves(params)], TC.param_leaves(_np_tree(grads)))


def _adam_update_bound(steps: int, b1=0.9, b2=0.999) -> float:
    """sum over t <= steps of U_t, the largest |update| of Adam at step t
    (module docstring)."""
    total = 0.0
    for t in range(1, steps + 1):
        w = [(1 - b1) * b1 ** (t - i) / (1 - b1**t) for i in range(1, t + 1)]
        v = [(1 - b2) * b2 ** (t - i) / (1 - b2**t) for i in range(1, t + 1)]
        total += math.sqrt(sum(wi * wi / vi for wi, vi in zip(w, v)))
    return total


def _scheduled_update_bound(lrs: list[float]) -> float:
    """sum over t of lr_t U_t (module docstring): the largest total move
    of one entry over len(lrs) steps at those rates."""
    return sum(
        lr * (_adam_update_bound(t) - _adam_update_bound(t - 1))
        for t, lr in enumerate(lrs, start=1)
    )


LR = 1e-3
SCHEDULE = dict(init_value=0.0, peak_value=LR, warmup_steps=2, decay_steps=4, end_value=0.05 * LR)


def _learning_rates(learning_rate: str):
    """(JAX's, the port's) learning rate: ``LR``, or optax's warmup-cosine
    schedule at SCHEDULE and the port's counterpart."""
    if learning_rate == "float":
        return LR, LR
    return optax.warmup_cosine_decay_schedule(**SCHEDULE), TC.warmup_cosine_decay_schedule(**SCHEDULE)


def _rate_at(learning_rate, count: int) -> float:
    return float(learning_rate(count)) if callable(learning_rate) else learning_rate


def test_adamw_matches_optax_on_the_same_gradients():
    rng = np.random.default_rng(5)
    shapes = {"embed": (7, 3), "final_norm": (3,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    layers = {"q_proj": rng.standard_normal((2, 3, 4)).astype(np.float32)}
    tree = {**params, "layers": layers, "lm_head": None}
    grads = [
        jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32) * 0.1, tree)
        for _ in range(3)
    ]
    opt = optax.adamw(1e-2, weight_decay=0.01)
    jp = jax.tree.map(jnp.asarray, tree)
    state = opt.init(jp)
    tparams = TC.trainable(jax.tree.map(lambda x: torch.from_numpy(x.copy()), tree))
    topt = TC.make_optimizer(1e-2, 0.01)(tparams)
    for g in grads:
        updates, state = opt.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        for leaf, gl in zip(TC.param_leaves(tparams), TC.param_leaves(g)):
            leaf.grad = torch.from_numpy(gl.copy())
        topt.step()
    steps = len(grads)
    rel = 2.0**-25 / (1 - 0.999) + 2.0**-24 / (1 - 0.9)
    for got, want in zip(TC.param_leaves(tparams), TC.param_leaves(_np_tree(jp))):
        tol = 1e-2 * _adam_update_bound(steps) * rel + steps * 2.0**-23 * np.abs(want)
        assert np.all(np.abs(got.detach().numpy() - want) <= tol)
    # The first moments are f32 averages of the same gradients, torch's by
    # lerp, optax's as b1 mu + (1 - b1) g: a few roundings of terms no
    # larger than the largest gradient, 4 * steps * 2^-24 * max|g|.
    leaves = zip(TC.param_leaves(tparams), TC.param_leaves(_np_tree(state[0].mu)),
                 zip(*(TC.param_leaves(g) for g in grads)))
    for got, want, gs in leaves:
        atol = 4 * steps * 2.0**-24 * max(float(np.abs(g).max()) for g in gs)
        np.testing.assert_allclose(topt.state[got]["exp_avg"].numpy(), want, atol=atol, rtol=0)


def _jax_steps(step, config, params, optimizer, batches):
    """``step`` (JAX's make_train_step or make_ce_train_step, taking the
    mesh and optimizer) from ``params`` on a one-device CPU mesh: the loss
    of each step, the params before each step and after the last, and the
    optimizer state."""
    mesh = make_mesh((1, 1), axis_names=TRAIN_AXES, devices=jax.devices()[:1])
    params = JC.shard_params(params, mesh, config)
    opt_state = JC.commit_to_mesh(jax.jit(optimizer.init)(params), mesh)
    step = step(config, mesh, optimizer)
    losses, trees = [], []
    for batch in batches:
        trees.append(_np_tree(params))
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
    return losses, trees + [_np_tree(params)], opt_state


def _objective(kind):
    """(JAX step factory, port step factory, JAX batches, port batches) of
    four seeded batches for the contrastive or the cross-encoder step."""
    kw = dict(token_true=TOKEN_TRUE, token_false=TOKEN_FALSE)
    if kind == "contrastive":
        arrays = [_contrastive_arrays(seed=s) for s in range(4)]
        return (
            JC.make_train_step, TC.make_train_step,
            [_jax_batch(a) for a in arrays], [_torch_batch(a) for a in arrays],
        )
    arrays = [_ce_arrays(seed=s) for s in range(4)]
    return (
        lambda config, mesh, optimizer: JX.make_ce_train_step(config, mesh, optimizer, **kw),
        lambda config: TX.make_ce_train_step(config, **kw),
        [JX.CrossEncoderBatch(*(jnp.asarray(x) for x in a)) for a in arrays],
        [TX.CrossEncoderBatch(*(torch.from_numpy(x) for x in a)) for a in arrays],
    )


@pytest.mark.parametrize(
    "steps,learning_rate", [(1, "float"), (3, "float"), (4, "schedule")],
    ids=["1", "3", "4-schedule"],
)
@pytest.mark.parametrize("kind", ["contrastive", "cross_encoder"])
def test_train_steps_match_jax(tiny, kind, steps, learning_rate):
    """``make_train_step`` and ``make_ce_train_step`` against JAX's on a
    one-device CPU mesh, from the same params, at lr 1e-3 so that the
    updates dwarf f32 rounding, or on optax's warmup-cosine schedule to
    that peak (warmup 2 of 4 steps, the first update at rate 0) and the
    port's: each step at the rate optax reads at the same count."""
    config, jparams, tconfig = tiny
    jax_lr, torch_lr = _learning_rates(learning_rate)
    jax_step, torch_step, jax_batches, torch_batches = _objective(kind)
    want_losses, want_params, jstate = _jax_steps(
        jax_step, config, jparams, JC.make_optimizer(learning_rate=jax_lr), jax_batches[:steps]
    )
    params = _torch_params(jparams)
    opt_state = TC.make_optimizer(learning_rate=torch_lr)(params)
    step = torch_step(tconfig)
    for t, batch in enumerate(torch_batches[:steps]):
        before = [p.detach().clone() for p in TC.param_leaves(params)]
        diff = [b.numpy() - w for b, w in zip(before, TC.param_leaves(want_params[t]))]
        params, opt_state, metrics = step(params, opt_state, batch)
        assert math.isclose(opt_state.param_groups[0]["lr"], _rate_at(jax_lr, t), rel_tol=1e-6)
        first_order = sum(
            float(np.abs(p.grad.numpy() * d).sum()) for p, d in zip(TC.param_leaves(params), diff)
        )
        tol = 2 * first_order + LOSS_RTOL * abs(want_losses[t])
        assert abs(float(metrics["loss"]) - want_losses[t]) <= tol
    bound = 2 * _scheduled_update_bound([_rate_at(jax_lr, t) for t in range(steps)])
    for got, want in zip(TC.param_leaves(params), TC.param_leaves(want_params[-1])):
        got = got.detach().numpy()
        assert np.all(np.abs(got - want) <= bound + 2.0**-23 * np.abs(want))
    if steps == 1:  # the moments are the first gradients, scaled
        mu = TC.param_leaves(_np_tree(jstate[0].mu))
        _assert_grads([opt_state.state[p]["exp_avg"] for p in TC.param_leaves(params)], mu)


@pytest.mark.parametrize("learning_rate", ["float", "schedule"])
def test_state_carried_from_optax_continues_like_jax(tiny, learning_rate):
    """One JAX step, then its params and optax state (mu, nu, count)
    carried across (``opt_state_from_optax``) and one more step on each
    side: the same loss (same params) and params within 2 lr U_2. With the
    schedule the carried step runs at the rate of the carried count 1
    (half the peak), not at the rate 0 of a fresh count."""
    config, jparams, tconfig = tiny
    jax_lr, torch_lr = _learning_rates(learning_rate)
    a1, a2 = _contrastive_arrays(seed=0), _contrastive_arrays(seed=1)
    joptimizer = JC.make_optimizer(learning_rate=jax_lr)
    mesh = make_mesh((1, 1), axis_names=TRAIN_AXES, devices=jax.devices()[:1])
    params = JC.shard_params(jparams, mesh, config)
    jstate = JC.commit_to_mesh(jax.jit(joptimizer.init)(params), mesh)
    jstep = JC.make_train_step(config, mesh, joptimizer)
    params, jstate, _ = jstep(params, jstate, _jax_batch(a1))
    mid = _np_tree(params)
    adam = jstate[0]
    tparams = _torch_params(mid)
    opt_state = TC.opt_state_from_optax(
        TC.make_optimizer(learning_rate=torch_lr), tparams, _np_tree(adam.mu), _np_tree(adam.nu),
        int(adam.count),
    )
    params, jstate, jmetrics = jstep(params, jstate, _jax_batch(a2))
    step = TC.make_train_step(tconfig)
    tparams, opt_state, metrics = step(tparams, opt_state, _torch_batch(a2))
    assert math.isclose(float(metrics["loss"]), float(jmetrics["loss"]), rel_tol=LOSS_RTOL)
    lr = _rate_at(jax_lr, int(adam.count))
    assert lr > 0 and math.isclose(opt_state.param_groups[0]["lr"], lr, rel_tol=1e-6)
    u2 = _adam_update_bound(2) - _adam_update_bound(1)
    for got, want in zip(TC.param_leaves(tparams), TC.param_leaves(_np_tree(params))):
        diff = np.abs(got.detach().numpy() - want)
        assert np.all(diff <= 2 * lr * u2 + 2.0**-23 * np.abs(want))


WORDS = ["nat", "add", "comm", "list", "map", "zero", "succ", "le", "lt", "mul"]


def _store_rows(n=30):
    rows = []
    for i in range(n):
        a, b = WORDS[i % 10], WORDS[(i * 3) % 10]
        informal = f"**{a} {b} lemma.** {a} {b} {WORDS[(i * 7) % 10]} " * (1 + i % 4)
        if i % 5 == 0:
            informal = f"{a} {b} without a title"
        rows.append(dict(
            name=f"Nat.{a}_{b}{i}", module="M", source_text=f"theorem x{i}",
            source_link=f"l{i}", informalization=None if i % 7 == 3 else informal,
        ))
    # Two declarations with the same informalization: duplicate positives.
    rows[1]["informalization"] = rows[2]["informalization"]
    return rows


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_data")
    model = make_tiny_model_dir(root / "model", seed=0)
    store = DeclarationStore(root / "declarations.db", create=True)
    store.insert_many([Declaration(**row) for row in _store_rows()])
    for name in ("tokenizer.json", "tokenizer_config.json"):
        (root / name).write_bytes((model / name).read_bytes())
    return root


def test_loader_batches_identical_to_jax(data_dir):
    want_pairs = JD.pairs_from_store(DeclarationStore(data_dir / "declarations.db"))
    pairs = TD.pairs_from_store(TorchStore(data_dir / "declarations.db"))
    assert pairs == want_pairs
    hf = AutoTokenizer.from_pretrained(str(data_dir), local_files_only=True)
    kw = dict(batch_size=8, query_max_length=16, doc_max_length=32, seed=3)
    want = iter(JD.ContrastiveDataLoader(hf, want_pairs, **kw))
    got = iter(TD.ContrastiveDataLoader(load_tokenizer(data_dir), pairs, **kw))
    n_dup = 0
    for _ in range(10):  # more than one epoch
        batch = next(got)
        for g, w in zip(batch, next(want)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        n_dup += int(batch.doc_dup_mask.sum())
    assert n_dup > 0  # the duplicate-positive mask was exercised
    examples = [(q, d, i % 2) for i, (q, d) in enumerate(pairs)]
    ce_kw = dict(batch_size=4, max_length=48, seed=1, truncation_augment=0.5)
    want = iter(JX.CrossEncoderDataLoader(hf, examples, **ce_kw))
    got = iter(TX.CrossEncoderDataLoader(load_tokenizer(data_dir), examples, **ce_kw))
    for _ in range(12):
        for g, w in zip(next(got), next(want)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture
def deterministic():
    """torch's deterministic algorithms (the CPU embedding-gradient
    accumulation is otherwise free to sum in another order per run)."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


def test_checkpoint_round_trip_resume_and_unfinished_saves(tmp_path, deterministic):
    """A checkpoint restores params and optimizer state exactly into a
    fresh state; two steps, a save and two resumed steps equal four steps
    straight, bit for bit (deterministic algorithms on the CPU); a save cut
    off under its temporary name is never picked."""
    config = tq.Qwen3Config.tiny()
    optimizer = TC.make_optimizer(learning_rate=1e-3)
    batches = [_torch_batch(_contrastive_arrays(seed=s)) for s in range(4)]

    params, opt_state = TC.init_train_state(config, optimizer, seed=1, device="cpu")
    step = TC.make_train_step(config)
    for b in batches:
        params, opt_state, _ = step(params, opt_state, b)
    straight = [p.detach().clone() for p in TC.param_leaves(params)]

    params, opt_state = TC.init_train_state(config, optimizer, seed=1, device="cpu")
    for b in batches[:2]:
        params, opt_state, _ = step(params, opt_state, b)
    path = TK.save_checkpoint(tmp_path, 2, params, opt_state)
    (tmp_path / "step_00000009.tmp.123").write_bytes(b"cut off")
    (tmp_path / "step_00000010.orbax-checkpoint-tmp").mkdir()
    assert TK.latest_checkpoint(tmp_path) == (2, path)
    assert TK.latest_checkpoint(tmp_path / "missing") is None

    fresh, fresh_opt = TC.init_train_state(config, optimizer, seed=7, device="cpu")
    restored = TK.restore_checkpoint(path, {"params": fresh, "opt_state": fresh_opt})
    assert restored["step"] == 2 and restored["params"] is fresh
    for got, want in zip(TC.param_leaves(fresh), TC.param_leaves(params)):
        assert torch.equal(got, want) and got.requires_grad
    for got, want in zip(TC.param_leaves(fresh), TC.param_leaves(params)):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(fresh_opt.state[got][key], opt_state.state[want][key])
    for b in batches[2:]:
        fresh, fresh_opt, _ = step(fresh, fresh_opt, b)
    for got, want in zip(TC.param_leaves(fresh), straight):
        assert torch.equal(got.detach(), want)


def test_export_matches_jax_export(tiny, tmp_path):
    """The same params exported by both packages: identical config.json
    and model.safetensors bytes, read back by the port's loader as the
    params themselves."""
    config, jparams, tconfig = tiny
    JE.export_hf_checkpoint(jparams, config, tmp_path / "jax", query_prompt="q: ")
    TE.export_hf_checkpoint(_torch_params(jparams), tconfig, tmp_path / "port", query_prompt="q: ")
    for name in ("model.safetensors", "config.json", "config_sentence_transformers.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    loaded, loaded_config = hf_loader.load_params(
        tmp_path / "port", dtype=torch.float32, device="cpu"
    )
    assert loaded_config == tconfig
    for got, want in zip(TC.param_leaves(loaded), TC.param_leaves(_np_tree(jparams))):
        np.testing.assert_array_equal(got.numpy(), want)


def test_cli_trains_on_the_cpu_and_resumes(data_dir, tmp_path, monkeypatch):
    """``main`` with the tiny config (no --model-dir) on the CPU (the
    environment asks for it through JAX_PLATFORMS, as the JAX CLI reads
    it): finite losses, checkpoints at the interval and the end, and a
    rerun with more steps resumes after the last one."""
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    ckpt = tmp_path / "ckpt"
    argv = [
        "--data-dir", str(data_dir), "--batch-size", "4", "--query-max-length", "16",
        "--doc-max-length", "32", "--checkpoint-dir", str(ckpt), "--checkpoint-every", "2",
        "--log-every", "1",
    ]
    records = cli.main(argv + ["--steps", "3"])
    assert [r["step"] for r in records] == [1, 2, 3]
    assert all(math.isfinite(r["loss"]) for r in records)
    assert sorted(p.name for p in ckpt.iterdir()) == ["step_00000002", "step_00000003"]
    records = cli.main(argv + ["--steps", "4"])
    assert [r["step"] for r in records] == [4]
    assert TK.latest_checkpoint(ckpt)[0] == 4
    # One process is a (1, 1) mesh: a mesh of more positions needs as many
    # ranks (tests/test_torch_parallel_train.py starts them).
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        cli.main(argv + ["--steps", "1", "--mesh", "2,1"])
    assert cli.parse_mesh("1,1") == cli.parse_mesh(None) == (1, 1)
    assert cli.parse_mesh("2", 2) == cli.parse_mesh(None, 2) == (2, 1)


def test_serving_builds_no_graph_and_training_does(tiny, monkeypatch):
    """The trunk's entry points are differentiable, but the clients serve
    without a graph even over params that require gradients."""
    from lean_explore_tpu_torch.models.tokenizer import WordLevelTokenizer
    from lean_explore_tpu_torch.util import reranker_client
    from lean_explore_tpu_torch.util.embedding_client import EmbeddingClient

    _, jparams, tconfig = tiny
    params = _torch_params(jparams)
    ids = torch.randint(5, 512, (2, 16), generator=torch.Generator().manual_seed(0))
    mask = torch.ones(2, 16, dtype=torch.int32)
    assert tq.embed_pool(params, tconfig, ids, mask).requires_grad
    assert tq.forward_hidden(params, tconfig, ids, mask).requires_grad
    vocab = {"<pad>": 0, "<unk>": 1, "<eos>": 2, "true": 3, "false": 4, "nat": 5, ":": 6}
    tokenizer = WordLevelTokenizer(
        {"model": {"type": "WordLevel", "vocab": vocab, "unk_token": "<unk>"},
         "pre_tokenizer": {"type": "Whitespace"}},
        pad_token="<pad>", eos_token="<eos>", unk_token="<unk>",
    )
    embedder = EmbeddingClient.from_components(params, tconfig, tokenizer)
    out = embedder.embed_device(["nat nat", "nat"])
    assert not out.requires_grad and out.grad_fn is None
    seen = []
    real = reranker_client.qwen3_mod.rerank_scores

    def spy(*args, **kwargs):
        scores = real(*args, **kwargs)
        seen.append(scores.requires_grad)
        return scores

    monkeypatch.setattr(reranker_client.qwen3_mod, "rerank_scores", spy)
    reranker = reranker_client.RerankerClient.from_components(
        params, tconfig, tokenizer, max_length=32
    )
    assert len(reranker.rerank_pairs_sync(["nat"], ["nat nat"])) == 1
    assert seen == [False]


def test_decode_matches_hf_on_the_reranker_tokenizer():
    """``WordLevelTokenizer.decode`` (the cross-encoder loader's truncation
    augmentation) against HuggingFace's decode of the committed reranker
    tokenizer, on truncated encodings of vocabulary words, unknown words,
    punctuation, underscores and a special token: the same ids, then the
    same text."""
    path = Path(__file__).resolve().parent.parent / "runs" / "reranker" / "tokenizer"
    hf = AutoTokenizer.from_pretrained(str(path), local_files_only=True)
    ours = load_tokenizer(path)
    vocab = list(json.loads((path / "tokenizer.json").read_text())["model"]["vocab"])
    rng = np.random.default_rng(0)
    for n in range(5):
        words = [vocab[i] for i in rng.integers(0, len(vocab), 40)]
        text = " ".join(words) + f" unknownword{n} <eos> x_y. (a, b)!"
        want = hf(text, truncation=True, max_length=30 + n, add_special_tokens=False)
        got = ours(text, truncation=True, max_length=30 + n, add_special_tokens=False)
        assert got["input_ids"] == want["input_ids"]
        assert ours.decode(got["input_ids"]) == hf.decode(want["input_ids"])


@pytest.mark.parametrize(
    "platforms,xla_flags,want",
    [
        ("cpu", "", "cpu"),
        ("CPU,cuda", "", "cpu"),
        ("", "--xla_force_host_platform_device_count=8", "cpu"),
        ("cuda,cpu", "", "cuda"),  # the CPU only as a fallback
        ("", "", "cuda"),
    ],
)
def test_requested_device(monkeypatch, platforms, xla_flags, want):
    """The CLI's device: the CPU when the JAX variables ask for it, else
    CUDA, which raises here (no card) rather than falling back."""
    from lean_explore_tpu_torch.util.platform import requested_device

    monkeypatch.setenv("JAX_PLATFORMS", platforms)
    monkeypatch.setenv("XLA_FLAGS", xla_flags)
    if want == "cpu":
        assert requested_device() == torch.device("cpu")
    elif torch.cuda.is_available():
        assert requested_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            requested_device()


def test_cross_encoder_loader_equals_jax_at_the_committed_arguments(tmp_path):
    """The port's CrossEncoderDataLoader gives the JAX loader's first 200
    batches at scripts/train_reranker_e2e.py's committed arguments (the 20k
    chain, name variants on, batch 64, max length 96), through
    scripts/compare_torch_reranker_trajectory.py's check."""
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
    import compare_torch_reranker_trajectory as trajectory

    args = trajectory.parse_args([])
    task = trajectory.Task(args, tmp_path, name_variants=True)
    assert len(task.examples) == 119628
    batches = trajectory.jax_batches(task, args, 200)
    shapes = {tuple(x.shape for x in arrays) for _, arrays in zip(range(200), batches)}
    assert shapes == {((64, 96), (64, 96), (64,))}
