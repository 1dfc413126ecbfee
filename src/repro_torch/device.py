"""Device selection shared by the port's entry points."""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

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


@contextlib.contextmanager
def full_fp32() -> Iterator[None]:
    """Run convolutions and matmuls in full float32, as the reference does.

    cuDNN runs float32 convolutions in TF32 by default
    (``torch.backends.cudnn.allow_tf32`` is True), which keeps about
    three decimal digits; matmuls default to full float32 but are pinned
    here too.  The flags are process-wide, so they are set for the
    duration of the block (forward and backward) and restored after.
    """
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
