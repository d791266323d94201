"""Training checkpoint and resume, the counterpart of
lean_explore_tpu/train/checkpoint.py.

The layout is the JAX package's: one ``step_<8 digits>`` entry per saved
step under the checkpoint directory, and resume picks the newest finished
one. The format is the port's own (orbax needs JAX): ``step_<N>`` is one
``torch.save`` file of {"step", "params", "opt_state"} (params as a dict of
tensors, the optimizer's ``state_dict()``), written under a temporary name
and renamed, so an unfinished save is never a ``step_<N>`` and never picked.
"""

import logging
import os
import re
from pathlib import Path

import torch

logger = logging.getLogger(__name__)

_STEP_FILE = re.compile(r"^step_(\d+)$")


def save_checkpoint(directory: str | Path, step: int, params: dict, opt_state) -> Path:
    """Write directory/step_<N> (overwrites): params, optimizer state, step."""
    directory = Path(directory).resolve()
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp.{os.getpid()}"
    torch.save(
        {"step": step, "params": params, "opt_state": opt_state.state_dict()}, tmp
    )
    os.replace(tmp, path)
    logger.info("checkpoint saved: %s", path)
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


def restore_checkpoint(path: str | Path, template: dict) -> dict:
    """Restore {params, opt_state} into ``template`` (e.g. fresh
    ``init_train_state`` output): each param tensor is overwritten in place
    (keeping its device, dtype and the optimizer's binding to it) and the
    optimizer loads its saved state. Returns the template with "step"."""
    saved = torch.load(Path(path), map_location="cpu", weights_only=True)
    params = template["params"]
    with torch.no_grad():
        for key in ("embed", "final_norm", "lm_head"):
            if params.get(key) is not None:
                params[key].copy_(saved["params"][key])
        for name, w in params["layers"].items():
            w.copy_(saved["params"]["layers"][name])
    template["opt_state"].load_state_dict(saved["opt_state"])
    logger.info("checkpoint restored: %s", path)
    return {**template, "step": saved["step"]}
