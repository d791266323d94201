"""Training checkpoint and resume, the counterpart of
lean_explore_tpu/train/checkpoint.py.

The layout is the JAX package's: one ``step_<8 digits>`` entry per saved
step under the checkpoint directory, and resume picks the newest finished
one. The format is the port's own (orbax needs JAX): ``step_<N>`` is one
``torch.save`` file of {"step", "params", "opt_state"} (params as a dict of
tensors, the optimizer's ``state_dict()``), written under a temporary name
and renamed, so an unfinished save is never a ``step_<N>`` and never picked.

On a (data, model) mesh of processes the file is the same: ``save``
gathers every shard of the params and of AdamW's moments over the model
group and rank 0 writes them whole; ``restore`` gives each rank its slice
(``train.contrastive.shard_params``'s layout). So a checkpoint written on
one mesh resumes on any other, one device included, as orbax's does.
"""

import logging
import os
import re
from pathlib import Path

import torch
import torch.distributed as dist

from lean_explore_tpu_torch.parallel.collectives import gather_dim
from lean_explore_tpu_torch.train.contrastive import (
    _model_coord,
    _with_leaves,
    gather_leaves,
    param_leaves,
    split_dims,
)

logger = logging.getLogger(__name__)

_STEP_FILE = re.compile(r"^step_(\d+)$")


def _process_mesh(mesh) -> bool:
    return mesh is not None and mesh.coords is not None and dist.is_initialized()


def save_checkpoint(
    directory: str | Path, step: int, params: dict, opt_state, *, mesh=None
) -> Path:
    """Write directory/step_<N> (overwrites): params, optimizer state, step.
    On a process ``mesh`` every rank calls it: the shards are gathered
    whole, rank 0 writes, and every rank returns once the file is there."""
    directory = Path(directory).resolve()
    path = directory / f"step_{step:08d}"
    state = opt_state.state_dict()
    if _process_mesh(mesh):
        model, _ = _model_coord(mesh)
        # The packed state's per-leaf dicts are the optimizer's own: copied
        # before their moments are replaced by the gathered wholes.
        state["state"] = {i: dict(v) for i, v in state["state"].items()}
        for i, dim in enumerate(split_dims(params)):
            for name in ("exp_avg", "exp_avg_sq"):
                if dim is not None and model > 1 and name in state["state"].get(i, {}):
                    state["state"][i][name] = gather_dim(
                        state["state"][i][name], dim, mesh.groups["model"]
                    )
        params = _with_leaves(params, gather_leaves(param_leaves(params), params, mesh))
        if dist.get_rank() != 0:
            dist.barrier()
            return path
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f"step_{step:08d}.tmp.{os.getpid()}"
    torch.save({"step": step, "params": params, "opt_state": state}, tmp)
    os.replace(tmp, path)
    logger.info("checkpoint saved: %s", path)
    if _process_mesh(mesh):
        dist.barrier()
    return path


def latest_checkpoint(directory: str | Path) -> tuple[int, Path] | None:
    """(step, path) of the newest finished checkpoint, or None: names match
    ``step_<digits>`` exactly, so a save cut off under its temporary name
    is never selected."""
    directory = Path(directory)
    if not directory.exists():
        return None
    candidates = [
        (int(m.group(1)), p)
        for p in directory.glob("step_*")
        if (m := _STEP_FILE.match(p.name))
    ]
    return max(candidates) if candidates else None


def restore_checkpoint(path: str | Path, template: dict, *, mesh=None) -> dict:
    """Restore {params, opt_state} into ``template`` (e.g. fresh
    ``init_train_state`` output): each param tensor is overwritten in place
    (keeping its device, dtype and the optimizer's binding to it) and the
    optimizer loads its saved state. On a ``mesh`` each param and moment
    is this rank's slice of the saved whole. Returns the template with
    "step"."""
    saved = torch.load(Path(path), map_location="cpu", weights_only=True)
    params = template["params"]
    model, m = _model_coord(mesh)

    def local(tensor, dim):
        if dim is None or model == 1:
            return tensor
        n = tensor.shape[dim] // model
        return tensor.narrow(dim, m * n, n)

    dims = split_dims(params)
    with torch.no_grad():
        for leaf, whole, dim in zip(
            param_leaves(params), param_leaves(saved["params"]), dims
        ):
            leaf.copy_(local(whole, dim))
    state = saved["opt_state"]
    for i, dim in enumerate(dims):
        for name in ("exp_avg", "exp_avg_sq"):
            if name in state["state"].get(i, {}):
                state["state"][i][name] = local(state["state"][i][name], dim)
    template["opt_state"].load_state_dict(state)
    logger.info("checkpoint restored: %s", path)
    return {**template, "step": saved["step"]}
