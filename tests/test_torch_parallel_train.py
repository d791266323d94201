"""Training on a (data, model) mesh of processes through the port against
JAX's GSPMD step on the host mesh, on the CPU.

Each mesh is one gloo process per position (tests/torch_mesh_worker.py,
one thread each, rendezvous through a ``file://`` under the test's tmp
dir). Every rank is given the same global batches and params carried from
JAX (the tiny config: 4 heads, 2 KV heads). JAX runs ``make_train_step``
and ``make_ce_train_step`` on a host-device mesh of the same shape
(tests/conftest.py's 8 devices). The port's three AdamW steps must match
JAX's step by step, and the port's one-device step, within
``test_train_steps_match_jax``'s tolerance (tests/test_torch_train.py's
module docstring): the first step's gradients, from the same params on
both sides, within GRAD_REL_L2 (relative L2 a leaf; JAX's from its first
AdamW moment, 0.1 g); each step's loss within twice the first-order change
sum |g| |dp| over the two sides' parameter difference dp before the step,
plus 1e-5 relative; the params after the last step within 2 sum_t lr U_t
plus 2^-23 |p|. The gradients are what hold the mesh's reductions (a
missed, doubled or data-times summed one moves them by half or more); the
later steps' bounds scale with the gap they check. The (2, 2) contrastive run takes the documents' attention
through flash attention's plain twins on each rank's heads; one
cross-encoder run has an untied lm_head whose pair columns lie on
different model ranks.

The training CLI runs with ``--mesh 2,2`` to a checkpoint at step 2, which
resumes on one device to step 3, and a one-device checkpoint at step 2
resumes on (2, 2): both held the same way to a one-device run cut at step
2 and resumed (a resumed CLI draws from its loader's start, as JAX's does,
so that run's step 3 sees the batch of step 1), and each mesh step taken
from the one-device run's params (step 1 from the init, the resumed step 3
on (2, 2)) leaves AdamW first moments within GRAD_REL_L2 of its.
"""

import functools
import math
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lean_explore_tpu.models import qwen3 as jq
from lean_explore_tpu.parallel import TRAIN_AXES
from lean_explore_tpu.parallel import make_mesh as jax_make_mesh
from lean_explore_tpu.train import contrastive as JC
from lean_explore_tpu.train import cross_encoder as JX
from lean_explore_tpu_torch.models import qwen3 as tq
from lean_explore_tpu_torch.models.store import DeclarationStore as TorchStore
from lean_explore_tpu_torch.models.tokenizer import load_tokenizer
from lean_explore_tpu_torch.train import __main__ as cli
from lean_explore_tpu_torch.train import checkpoint as TK
from lean_explore_tpu_torch.train import contrastive as TC
from lean_explore_tpu_torch.train import cross_encoder as TX
from lean_explore_tpu_torch.train import data as TD
from tests.test_torch_train import (  # noqa: F401  (data_dir is a fixture)
    LOSS_RTOL,
    _assert_grads,
    _ce_arrays,
    _contrastive_arrays,
    _np_tree,
    _scheduled_update_bound,
    _torch_params,
    data_dir,
)

WORKER = Path(__file__).with_name("torch_mesh_worker.py")
LR = 1e-3
STEPS = 3
CLI_LR = 1e-5  # the CLI's default rate
ADAM_B1 = 0.9  # optax's and the port's AdamW default
MESHES = [(2, 2), (2, 1), (1, 2)]
TIMEOUT_S = 240


def _config(tied: bool) -> dict:
    return dict(
        vocab_size=512, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=16, intermediate_size=128,
        tie_word_embeddings=tied,
    )


def _runs(shape) -> list[dict]:
    """The runs of a mesh: contrastive (on flash's twins at (2, 2)), the
    cross-encoder, and at (1, 2) the cross-encoder with an untied head
    whose "true" column (300) lies on model rank 1 and "false" (4) on 0."""
    runs = [
        dict(name="contrastive", kind="contrastive", tied=True, flash=shape == (2, 2),
             batches=[_contrastive_arrays(seed=s) for s in range(STEPS)]),
        dict(name="cross_encoder", kind="cross_encoder", tied=True, token_true=3,
             token_false=4, batches=[_ce_arrays(seed=s) for s in range(STEPS)]),
    ]
    if shape == (1, 2):
        runs.append(dict(
            name="cross_encoder_untied", kind="cross_encoder", tied=False,
            token_true=300, token_false=4, batches=[_ce_arrays(seed=s) for s in range(STEPS)],
        ))
    for run in runs:
        tied = run.pop("tied")
        run["config"] = _config(tied)
        run["params"] = _init_params(tied)
        run["lr"] = LR
    return runs


@functools.cache
def _init_params(tied: bool) -> dict:
    """JAX's init of the tiny config at key 0, as numpy."""
    return _np_tree(jq.init_params(jq.Qwen3Config(**_config(tied)), jax.random.PRNGKey(0)))


def _start(job: dict, tmp: Path) -> list:
    """Write the job and start its ranks; returns (process, log path)s."""
    tmp.mkdir(parents=True, exist_ok=True)
    job = {**job, "init": f"file://{tmp / 'rendezvous'}", "out": str(tmp / "out.pt")}
    torch.save(job, tmp / "job.pt")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = []
    for rank in range(job["world"]):
        log = tmp / f"rank{rank}.log"
        with open(log, "w") as f:
            procs.append((subprocess.Popen(
                [sys.executable, str(WORKER), str(tmp / "job.pt"), str(rank)],
                stdout=f, stderr=subprocess.STDOUT, env=env,
            ), log))
    return procs


def _finish(procs, tmp: Path) -> dict:
    """Wait for every rank (killing all of them on a timeout); returns rank
    0's output."""
    try:
        for proc, log in procs:
            proc.wait(timeout=TIMEOUT_S)
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, log in procs:
        assert proc.returncode == 0, log.read_text()[-3000:]
    return torch.load(tmp / "out.pt", weights_only=False)


def _jax_run(run: dict, shape) -> dict:
    """JAX's step on a host mesh of ``shape``: losses, the params (in
    param_leaves order) before each step and after the last, and the first
    step's gradients (its AdamW first moment over 1 - b1)."""
    config = jq.Qwen3Config(**run["config"])
    n = shape[0] * shape[1]
    mesh = jax_make_mesh(shape, axis_names=TRAIN_AXES, devices=jax.devices()[:n])
    optimizer = JC.make_optimizer(learning_rate=run["lr"])
    params = JC.shard_params(jax.tree.map(jnp.asarray, run["params"]), mesh, config)
    opt_state = JC.commit_to_mesh(jax.jit(optimizer.init)(params), mesh)
    if run["kind"] == "contrastive":
        step, batch_type = JC.make_train_step(config, mesh, optimizer), JC.ContrastiveBatch
    else:
        step = JX.make_ce_train_step(
            config, mesh, optimizer, token_true=run["token_true"],
            token_false=run["token_false"],
        )
        batch_type = JX.CrossEncoderBatch
    record = {"losses": [], "params": []}
    for arrays in run["batches"]:
        record["params"].append(TC.param_leaves(_np_tree(params)))
        params, opt_state, metrics = step(
            params, opt_state, batch_type(*(jnp.asarray(a) for a in arrays))
        )
        record["losses"].append(float(metrics["loss"]))
        if "grads" not in record:
            mu = TC.param_leaves(_np_tree(opt_state[0].mu))
            record["grads"] = [[m / (1 - ADAM_B1) for m in mu]]
    record["params"].append(TC.param_leaves(_np_tree(params)))
    return record


def _one_device_run(run: dict) -> dict:
    """The port's one-device step from the same params and batches, with
    each step's gradients."""
    config = tq.Qwen3Config(**run["config"])
    params = _torch_params(run["params"])
    opt_state = TC.make_optimizer(learning_rate=run["lr"])(params)
    if run["kind"] == "contrastive":
        step, batch_type = TC.make_train_step(config), TC.ContrastiveBatch
    else:
        step = TX.make_ce_train_step(
            config, token_true=run["token_true"], token_false=run["token_false"]
        )
        batch_type = TX.CrossEncoderBatch
    record = {"losses": [], "params": [], "grads": []}
    for arrays in run["batches"]:
        record["params"].append([p.detach().numpy().copy() for p in TC.param_leaves(params)])
        params, opt_state, metrics = step(
            params, opt_state, batch_type(*(torch.from_numpy(a) for a in arrays))
        )
        record["losses"].append(float(metrics["loss"]))
        record["grads"].append([p.grad.numpy().copy() for p in TC.param_leaves(params)])
    record["params"].append([p.detach().numpy().copy() for p in TC.param_leaves(params)])
    return record


def _assert_steps_match(got: dict, want: dict, lrs: list[float]) -> None:
    """``got`` (losses, params before each step and after the last, and
    each step's gradients) against ``want`` within the module docstring's
    tolerance. Both start from the same params, so the first step's
    gradients must agree at GRAD_REL_L2."""
    for g, w in zip(got["params"][0], want["params"][0]):
        np.testing.assert_array_equal(g, w)
    _assert_grads([torch.from_numpy(g) for g in got["grads"][0]], want["grads"][0])
    for t, (loss, want_loss) in enumerate(zip(got["losses"], want["losses"])):
        first_order = sum(
            float(np.abs(g * (p - w)).sum())
            for g, p, w in zip(got["grads"][t], got["params"][t], want["params"][t])
        )
        tol = 2 * first_order + LOSS_RTOL * abs(want_loss)
        assert abs(loss - want_loss) <= tol, (t, loss, want_loss, tol)
    bound = 2 * _scheduled_update_bound(lrs)
    for g, w in zip(got["params"][-1], want["params"][-1]):
        assert g.shape == w.shape
        assert np.all(np.abs(g - w) <= bound + 2.0**-23 * np.abs(w))


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Every mesh's ranks started together; JAX's and the one-device runs
    computed while they train."""
    root = tmp_path_factory.mktemp("mesh_train")
    jobs = {shape: _runs(shape) for shape in MESHES}
    started = {
        shape: _start(
            {"shape": shape, "world": shape[0] * shape[1], "runs": runs},
            root / f"{shape[0]}x{shape[1]}",
        )
        for shape, runs in jobs.items()
    }
    # XLA compiles (most of JAX's time here) in threads, without the GIL.
    with ThreadPoolExecutor(4) as pool:
        futures = {
            (shape, run["name"]): (pool.submit(_jax_run, run, shape),
                                   pool.submit(_one_device_run, run))
            for shape, runs in jobs.items() for run in runs
        }
        want = {shape: {} for shape in jobs}
        for (shape, name), (jax_run, one_device) in futures.items():
            want[shape][name] = (jax_run.result(), one_device.result())
    got = {
        shape: _finish(procs, root / f"{shape[0]}x{shape[1]}")
        for shape, procs in started.items()
    }
    return got, want


@pytest.mark.parametrize(
    "shape,name",
    [(s, n) for s in MESHES for n in ("contrastive", "cross_encoder")]
    + [((1, 2), "cross_encoder_untied")],
    ids=lambda x: "x".join(map(str, x)) if isinstance(x, tuple) else x,
)
def test_mesh_steps_match_jax_and_one_device(mesh_runs, shape, name):
    got, want = mesh_runs
    jax_run, one_device = want[shape][name]
    port = got[shape][name]
    assert all(math.isfinite(x) for x in port["losses"])
    _assert_steps_match(port, jax_run, [LR] * STEPS)
    _assert_steps_match(port, one_device, [LR] * STEPS)


def _cli_argv(data_dir, ckpt: Path, steps: int, mesh: str) -> list[str]:
    return [
        "--data-dir", str(data_dir), "--batch-size", "4", "--query-max-length", "16",
        "--doc-max-length", "32", "--checkpoint-dir", str(ckpt), "--checkpoint-every", "1",
        "--log-every", "1", "--steps", str(steps), "--mesh", mesh,
    ]


def _cli_grads(params: dict, batch) -> list[np.ndarray]:
    """The one-device InfoNCE gradients at ``params`` on ``batch``."""
    params = TC.trainable(TC._with_leaves(
        params, [p.detach().clone() for p in TC.param_leaves(params)]
    ))
    loss, _ = TC.infonce_loss(params, tq.Qwen3Config.tiny(), batch)
    loss.backward()
    return [p.grad.numpy() for p in TC.param_leaves(params)]


def _saved(ckpt: Path, step: int) -> dict:
    return torch.load(ckpt / f"step_{step:08d}", weights_only=True)


def test_cli_mesh_checkpoints_resume_across_meshes(data_dir, tmp_path, monkeypatch):
    """--mesh 2,2 to step 2, resumed on (1, 1) to step 3; a (1, 1) step-2
    checkpoint resumed on (2, 2) to step 3; both against the one-device run
    cut and resumed at the same step: every step's loss and the step-3
    params."""
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    whole = tmp_path / "whole"
    want = cli.main(_cli_argv(data_dir, whole, 2, "1,1"))
    want += cli.main(_cli_argv(data_dir, whole, STEPS, "1,1"))
    assert [r["step"] for r in want] == [1, 2, 3]
    to_mesh = tmp_path / "to_mesh" / "ckpt"
    to_mesh.mkdir(parents=True)
    shutil.copy(whole / "step_00000002", to_mesh)
    jobs = {
        "from_mesh": _start(
            {"shape": (2, 2), "world": 4,
             "argv": _cli_argv(data_dir, tmp_path / "from_mesh" / "ckpt", 2, "2,2")},
            tmp_path / "from_mesh",
        ),
        "to_mesh": _start(
            {"shape": (2, 2), "world": 4, "argv": _cli_argv(data_dir, to_mesh, STEPS, "2,2")},
            tmp_path / "to_mesh",
        ),
    }
    first = _finish(jobs["from_mesh"], tmp_path / "from_mesh")["records"]
    resumed_on_mesh = _finish(jobs["to_mesh"], tmp_path / "to_mesh")["records"]
    assert [r["step"] for r in first] == [1, 2] and [r["step"] for r in resumed_on_mesh] == [3]
    from_mesh = tmp_path / "from_mesh" / "ckpt"
    resumed = cli.main(_cli_argv(data_dir, from_mesh, STEPS, "1,1"))
    assert [r["step"] for r in resumed] == [3]

    # The batches the CLI drew (its loader at its seed) and the params
    # before each step, from the checkpoints, give each step's tolerance.
    pairs = TD.pairs_from_store(TorchStore(data_dir / "declarations.db"))
    loader = iter(TD.ContrastiveDataLoader(
        load_tokenizer(data_dir), pairs, batch_size=4, query_max_length=16,
        doc_max_length=32, seed=0,
    ))
    batches = [next(loader) for _ in range(2)]
    for records, ckpt in ((first + resumed, from_mesh), (resumed_on_mesh, to_mesh)):
        for record in records:
            t = record["step"]
            before = _saved(ckpt, t - 1)["params"] if t > 1 else None
            want_before = _saved(whole, t - 1)["params"] if t > 1 else None
            first_order = 0.0
            if before is not None:
                # Steps 1 and 2 draw batches 1 and 2; the resumed step 3
                # draws batch 1 again.
                grads = _cli_grads(want_before, batches[t - 1 if t <= 2 else 0])
                first_order = sum(
                    float(np.abs(g * (p.detach().numpy() - w.detach().numpy())).sum())
                    for g, p, w in zip(
                        grads, TC.param_leaves(before), TC.param_leaves(want_before)
                    )
                )
            want_loss = want[t - 1]["loss"]
            tol = 2 * first_order + LOSS_RTOL * abs(want_loss)
            assert abs(record["loss"] - want_loss) <= tol, (t, record["loss"], want_loss, tol)
        bound = 2 * _scheduled_update_bound([CLI_LR] * STEPS)
        for got_p, want_p in zip(
            TC.param_leaves(_saved(ckpt, STEPS)["params"]),
            TC.param_leaves(_saved(whole, STEPS)["params"]),
        ):
            got_p, want_p = got_p.detach().numpy(), want_p.detach().numpy()
            assert np.all(np.abs(got_p - want_p) <= bound + 2.0**-23 * np.abs(want_p))
    # The mesh steps taken from the one-device run's params: from_mesh's
    # step 1 (from the init) and to_mesh's step 3 (from whole's step 2),
    # each on the batch of the one-device step: the same first moments.
    for ckpt, step in ((from_mesh, 1), (to_mesh, STEPS)):
        got_state = _saved(ckpt, step)["opt_state"]["state"]
        want_state = _saved(whole, step)["opt_state"]["state"]
        assert sorted(got_state) == sorted(want_state)
        _assert_grads(
            [got_state[i]["exp_avg"] for i in sorted(want_state)],
            [want_state[i]["exp_avg"].numpy() for i in sorted(want_state)],
        )
    # One file whatever the mesh: the (2, 2) checkpoint holds whole leaves.
    assert TK.latest_checkpoint(from_mesh)[0] == STEPS
    saved = _saved(from_mesh, 2)
    for got_p, want_p in zip(
        TC.param_leaves(saved["params"]), TC.param_leaves(_saved(whole, 2)["params"])
    ):
        assert got_p.shape == want_p.shape
    # Leaf 1 is down_proj, split by rows on the mesh: its moments whole too.
    assert saved["opt_state"]["state"][1]["exp_avg"].shape == (2, 128, 64)


@pytest.mark.parametrize("tied", [True, False])
def test_partition_specs_are_jax_s(tied):
    """The port's tensor-parallel layout is JAX's PartitionSpecs, entry by
    entry."""
    want = JC.param_partition_specs(jq.Qwen3Config(**_config(tied)))
    got = TC.param_partition_specs(tq.Qwen3Config(**_config(tied)))
    assert got["lm_head"] == (None if want["lm_head"] is None else tuple(want["lm_head"]))
    assert got["embed"] == tuple(want["embed"]) and got["final_norm"] == tuple(want["final_norm"])
    assert got["layers"] == {k: tuple(v) for k, v in want["layers"].items()}


def test_mesh_shapes_the_model_and_batch_cannot_take_raise():
    """A model axis that does not divide the KV heads (each rank holds
    whole GQA groups) and a batch the data axis does not divide."""
    from lean_explore_tpu_torch.parallel import TRAIN_AXES as TORCH_TRAIN_AXES
    from lean_explore_tpu_torch.parallel import Mesh

    config = tq.Qwen3Config.tiny()  # 2 KV heads
    params = _torch_params(_init_params(True))
    three = Mesh(np.array([[torch.device("cpu")] * 3], dtype=object), TORCH_TRAIN_AXES,
                 coords=(0, 1))
    with pytest.raises(ValueError, match="does not divide num_key_value_heads=2"):
        TC.shard_params(params, three, config)
    two = Mesh(np.array([[torch.device("cpu")], [torch.device("cpu")]], dtype=object),
               TORCH_TRAIN_AXES, coords=(1, 0))
    batch = TC.ContrastiveBatch(
        *(torch.from_numpy(a[:3, :3] if a.ndim == 2 and a.dtype == bool else a[:3])
          for a in _contrastive_arrays(b=4))
    )
    with pytest.raises(ValueError, match="batch size 3 is not a multiple of the data axis 2"):
        TC.local_rows(batch, two, keep_last=True)
    local = TC.local_rows(
        TC.ContrastiveBatch(*(torch.from_numpy(a) for a in _contrastive_arrays(b=4))),
        two, keep_last=True,
    )
    assert local.query_ids.shape[0] == 2 and local.doc_dup_mask.shape == (4, 4)
