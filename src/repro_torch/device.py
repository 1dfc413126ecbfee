"""Device selection shared by the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the GPU.  A CUDA request without a GPU raises:
    the port never falls back to the CPU unless the caller asked for it
    (``device="cpu"``, as the tests do)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' (or --device cpu) to run on "
            "the CPU")
    return dev


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for queued device work (a no-op on the CPU)."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
