"""Device selection: the port runs on CUDA unless the caller asks for the CPU."""

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
