"""Device meshes for sharded serving and training
(lean_explore_tpu/parallel/mesh.py).

Axes, the JAX package's:

- ``data``: the query batch (serving) or the training batch;
- ``corpus``: corpus embedding rows (serving);
- ``model``: tensor parallelism of the trunk (training).

Serving runs in one process, as in JAX: a ``Mesh`` there is a grid of
devices, and ``parallel.sharded`` and ``parallel.rerank`` place each
shard or replica on its device. A list that repeats one device is a mesh
of virtual devices on it, as the JAX tests' host devices are. Training
runs one process per mesh position (PyTorch has no GSPMD):
``init_distributed`` starts ``torch.distributed`` and returns the
``TRAIN_AXES`` mesh of the ranks, with this rank's coordinates and the
process group of each axis.
"""

import logging
import os

import numpy as np
import torch

from lean_explore_tpu_torch.util.platform import mesh_devices, resolve_device

logger = logging.getLogger(__name__)

SERVE_AXES = ("data", "corpus")
TRAIN_AXES = ("data", "model")


class Mesh:
    """An object array of ``torch.device`` with named axes, as
    ``jax.sharding.Mesh``: ``mesh.shape["data"]`` is the size of the data
    axis and ``mesh.devices[d, c]`` the device at that position.

    A process mesh (``init_distributed``) also carries this process's
    position (``coords``) and each axis's process group (``groups``).
    """

    def __init__(self, devices, axis_names, *, coords=None, groups=None):
        grid = np.empty(np.shape(devices), dtype=object)
        for index, device in np.ndenumerate(np.asarray(devices, dtype=object)):
            grid[index] = torch.device(device)
        if grid.ndim != len(axis_names):
            raise ValueError(f"{grid.ndim}-D devices for axes {axis_names}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.coords = dict(zip(self.axis_names, coords)) if coords is not None else None
        self.groups = dict(groups or {})

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device(self) -> torch.device:
        """This process's device on a process mesh, else the first one."""
        if self.coords is None:
            return self.devices.flat[0]
        return self.devices[tuple(self.coords[a] for a in self.axis_names)]

    def distinct_devices(self) -> list[torch.device]:
        """Each device of the mesh once, in mesh order."""
        return list(dict.fromkeys(self.devices.flat))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.distinct_devices()})"


def make_mesh(
    shape: tuple[int, int] | None = None,
    *,
    axis_names: tuple[str, str] = SERVE_AXES,
    devices=None,
) -> Mesh:
    """Build a 2D mesh over the available devices.

    Args:
        shape: (axis0, axis1) sizes; default (1, n_devices).
        axis_names: Mesh axis names.
        devices: Device list; defaults to every CUDA card, or the virtual
            CPU devices when the CPU is asked for (``util.platform.
            mesh_devices``). A list may repeat a device.
    """
    devices = list(devices if devices is not None else mesh_devices())
    if shape is None:
        shape = (1, len(devices))
    total = shape[0] * shape[1]
    if total > len(devices):
        raise ValueError(f"mesh shape {shape} needs {total} devices, have {len(devices)}")
    grid = np.empty(total, dtype=object)
    grid[:] = devices[:total]
    logger.info("Mesh %s over %d devices (%s)", shape, total, axis_names)
    return Mesh(grid.reshape(shape), axis_names)


def serve_mesh_from_config(device: str | torch.device | None = None) -> Mesh | None:
    """The serving mesh of ``Config.MESH_SHAPE`` (``LEAN_EXPLORE_MESH_SHAPE=
    data,corpus``, e.g. ``2,4``), or None when it is unset. It spans the
    devices of ``device``'s kind (default: CUDA unless the CPU is asked
    for); a shape larger than they are raises."""
    from lean_explore_tpu_torch.config import Config

    shape = Config.mesh_shape()
    if shape is None:
        return None
    return make_mesh(shape, axis_names=SERVE_AXES, devices=mesh_devices(device))


def _env_int(name: str) -> int | None:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def init_distributed(
    shape: tuple[int, int] | None = None,
    *,
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    device: str | torch.device | None = None,
) -> Mesh:
    """Start ``torch.distributed`` and return this rank's ``TRAIN_AXES``
    mesh of shape (data, model), default (world size, 1).

    The arguments default to torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` through ``env://``);
    a group already started is used as it is. Ranks take JAX's device
    order: rank = d * model + m. Each rank runs on the CPU when the CPU is
    asked for (``device``, else the environment), else on card
    ``LOCAL_RANK % cards``. The backend follows from the count of ranks
    and cards: NCCL when every rank on the host has a card of its own,
    gloo when ranks share a card (NCCL refuses two ranks on one GPU:
    "Duplicate GPU detected", scripts/probe_torch_collectives.py) or run
    on the CPU. The port's mesh uses ``all_reduce``,
    ``all_gather_into_tensor`` and ``barrier`` only.
    """
    import torch.distributed as dist

    kind = (
        torch.device("cpu")
        if mesh_devices(device)[0].type == "cpu"
        else resolve_device("cuda")
    )
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    if dist.is_initialized():
        world_size, rank = dist.get_world_size(), dist.get_rank()
    if world_size is None or rank is None:
        raise ValueError(
            "init_distributed needs world_size and rank, or torchrun's "
            "WORLD_SIZE and RANK"
        )
    local_rank = _env_int("LOCAL_RANK")
    local_rank = rank if local_rank is None else local_rank
    local_ranks = _env_int("LOCAL_WORLD_SIZE") or world_size
    if kind.type == "cpu":
        backend, local = "gloo", torch.device("cpu")
    else:
        cards = torch.cuda.device_count()
        backend = "nccl" if local_ranks <= cards else "gloo"
        local = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(local)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method or "env://",
            world_size=world_size, rank=rank,
        )
        logger.info(
            "torch.distributed: rank %d of %d on %s, backend %s (%d ranks on "
            "this host, %s)", rank, world_size, local, backend, local_ranks,
            "cpu" if kind.type == "cpu" else f"{torch.cuda.device_count()} cards",
        )
    data, model = shape if shape is not None else (world_size, 1)
    if data * model != world_size:
        raise ValueError(
            f"mesh shape {(data, model)} needs {data * model} ranks, have {world_size}"
        )
    # Every rank creates every group, in one order.
    model_groups = [
        dist.new_group([d * model + m for m in range(model)]) for d in range(data)
    ]
    data_groups = [
        dist.new_group([d * model + m for d in range(data)]) for m in range(model)
    ]
    d, m = divmod(rank, model)
    devices = np.empty((data, model), dtype=object)
    for r in range(world_size):
        devices[divmod(r, model)] = (
            local if kind.type == "cpu"
            else torch.device("cuda", r % torch.cuda.device_count())
        )
    devices[d, m] = local
    return Mesh(
        devices, TRAIN_AXES, coords=(d, m),
        groups={"data": data_groups[m], "model": model_groups[d]},
    )
