"""One rank of a training mesh of the port on the CPU, started by
tests/test_torch_parallel_train.py (not a test module itself):

    python tests/torch_mesh_worker.py JOB RANK

JOB is a file the test wrote with ``torch.save``: the mesh shape, the
world size, a ``file://`` rendezvous, and either ``argv`` for the training
CLI or ``runs`` of train steps (tiny params carried from JAX as numpy, the
global batches, the rate). The rank joins the gloo group and runs them;
rank 0 writes what it saw (each step's loss, and the whole params before
each step, after the last and the gradients of each step, gathered over
the model group) to the job's ``out``. It imports nothing of JAX.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from lean_explore_tpu_torch.models import hf_loader, qwen3  # noqa: E402
from lean_explore_tpu_torch.parallel.mesh import init_distributed  # noqa: E402
from lean_explore_tpu_torch.train import contrastive as TC  # noqa: E402
from lean_explore_tpu_torch.train import cross_encoder as TX  # noqa: E402


def _whole(tensors, params, mesh) -> list[np.ndarray]:
    """Copies: on a model axis of one the leaves are the live tensors,
    which the next step updates in place."""
    return [t.numpy().copy() for t in TC.gather_leaves(tensors, params, mesh)]


def run_steps(mesh, run: dict) -> dict:
    config = qwen3.Qwen3Config(**run["config"])
    params = TC.shard_params(
        hf_loader.params_from_jax(run["params"], device="cpu"), mesh, config
    )
    opt_state = TC.make_optimizer(learning_rate=run["lr"])(params)
    real_use_flash = qwen3._use_flash
    if run.get("flash"):  # the documents (T = 256) on flash attention's twins
        qwen3._use_flash = lambda seq_len, device: seq_len >= 256
    if run["kind"] == "contrastive":
        step, batch_type = TC.make_train_step(config, mesh=mesh), TC.ContrastiveBatch
    else:
        step = TX.make_ce_train_step(
            config, token_true=run["token_true"], token_false=run["token_false"], mesh=mesh
        )
        batch_type = TX.CrossEncoderBatch
    record = {"losses": [], "params": [], "grads": []}
    try:
        for arrays in run["batches"]:
            record["params"].append(_whole(TC.param_leaves(params), params, mesh))
            batch = batch_type(*(torch.from_numpy(a) for a in arrays))
            params, opt_state, metrics = step(params, opt_state, batch)
            record["losses"].append(float(metrics["loss"]))
            grads = [p.grad for p in TC.param_leaves(params)]
            record["grads"].append(_whole(grads, params, mesh))
        record["params"].append(_whole(TC.param_leaves(params), params, mesh))
    finally:
        qwen3._use_flash = real_use_flash
    return record


def main() -> None:
    job = torch.load(sys.argv[1], weights_only=False)  # written by the test
    rank = int(sys.argv[2])
    torch.set_num_threads(1)
    mesh = init_distributed(
        job["shape"], init_method=job["init"], world_size=job["world"], rank=rank,
        device="cpu",
    )
    out = {}
    if "argv" in job:
        from lean_explore_tpu_torch.train import __main__ as cli

        out["records"] = cli.main(job["argv"])
    for run in job.get("runs", []):
        out[run["name"]] = run_steps(mesh, run)
    if rank == 0:
        torch.save(out, job["out"])
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
