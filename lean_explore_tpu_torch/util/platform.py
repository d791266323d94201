"""Device selection: the port runs on CUDA unless the caller asks for the CPU."""

import os
import re

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the current CUDA device. An explicit device is taken
    as given. Raises when CUDA was asked for (or left to the default) and is
    missing: there is no quiet fallback to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device


def requested_device() -> torch.device:
    """The device an entry point runs on: the CPU when the environment asks
    for it through the variables the JAX package's entry points read
    (``honor_cpu_platform_request``): ``JAX_PLATFORMS`` whose first, that
    is preferred, platform is ``cpu``, or ``XLA_FLAGS`` holding
    ``xla_force_host_platform_device_count`` (a virtual host mesh). Else
    the current CUDA device (``resolve_device``, which raises without
    CUDA). Unlike the JAX helper, a list that only falls back to the CPU
    (``cuda,cpu``) does not ask for it."""
    platforms = os.environ.get("JAX_PLATFORMS", "").lower().split(",")
    wants_cpu = platforms[0].strip() == "cpu" or (
        "xla_force_host_platform_device_count" in os.environ.get("XLA_FLAGS", "")
    )
    return resolve_device("cpu" if wants_cpu else None)


def host_device_count() -> int:
    """The number of virtual CPU devices: ``XLA_FLAGS``'s
    ``--xla_force_host_platform_device_count=N``, as JAX reads it, else 1."""
    match = re.search(
        r"--xla_force_host_platform_device_count=(\d+)", os.environ.get("XLA_FLAGS", "")
    )
    return int(match.group(1)) if match else 1


def mesh_devices(device: str | torch.device | None = None) -> list[torch.device]:
    """The devices a mesh spans by default: every CUDA card, or the
    virtual CPU devices (``host_device_count``, each the one CPU) when the
    CPU is asked for, by ``device`` or else by the environment
    (``requested_device``)."""
    device = requested_device() if device is None else resolve_device(device)
    if device.type == "cpu":
        return [torch.device("cpu")] * host_device_count()
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
