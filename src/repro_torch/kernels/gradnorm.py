"""Per-sample gradient-norm scoring kernel (the sigma_{k,j} producer).

Counterpart of ``repro/kernels/gradnorm.py``.  For a linear head
logits = h W + b with cross-entropy loss the exact per-sample
gradient-norm^2 of the head is

    sigma_j = ||p_j - y_j||^2 * (||h_j||^2 + 1),

two row-wise squared norms.  ``rownorm2`` and the fused
``gradnorm_sigma`` launch the hand-written CUDA kernels of
``csrc/gradnorm.cu`` (built for sm_90a with nvcc at first use and
loaded with ctypes) on a CUDA tensor, and use the plain PyTorch
versions beside them only for a tensor on the CPU.  Any other device,
dtype, rank or layout raises: there is no silent fallback.

Each kernel is a custom op (``repro_torch::rownorm2``,
``repro_torch::gradnorm_sigma``) with a shape-only implementation for
fake tensors and a FLOP formula (``cost``) that
``torch.utils.flop_counter`` reads.  On DTensors the wrappers run the
op on each shard's rows (``local.py``): the rows are split over every
mesh dimension they divide, and the columns gathered.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from . import local, nvcc
from .nvcc import BuildInfo

SOURCE = Path(__file__).resolve().parent / "csrc" / "gradnorm.cu"
#: where the shared library is built (listed in .gitignore).
BUILD_DIR = nvcc.BUILD_DIR
NVCC_FLAGS = nvcc.BASE_FLAGS

#: kernel launches per entry point; bumped only where a kernel launches.
LAUNCHES = {"rownorm2": 0, "gradnorm_sigma": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def cost(n: int, f: int, c: int = 0) -> tuple[float, float]:
    """(FLOPs, bytes) of one launch on n rows: ``rownorm2`` of (n, f)
    for ``c == 0``, else ``gradnorm_sigma`` of h (n, f) and dlogits
    (n, c).  FLOPs: a multiply and an add per element read, and for the
    fused kernel the + 1 and the product per row; bytes: each float32
    input read once and the (n,) output written once."""
    flops = 2.0 * n * (f + c) + (2.0 * n if c else 0.0)
    return flops, 4.0 * (n * (f + c) + n)


# ---------------------------------------------------------------- plain

def rownorm2_plain(x: torch.Tensor) -> torch.Tensor:
    """sum(x^2, axis=-1) in float32: the kernel's plain version."""
    return (x.float() ** 2).sum(-1)


def gradnorm_sigma_plain(h: torch.Tensor, dlogits: torch.Tensor) -> torch.Tensor:
    """(||h||^2 + 1) * ||dlogits||^2 per row: the fused kernel's plain
    version."""
    return (rownorm2_plain(h) + 1.0) * rownorm2_plain(dlogits)


# ---------------------------------------------------------------- build

_LIB: Optional[ctypes.CDLL] = None
_BUILD: Optional[BuildInfo] = None


def build() -> BuildInfo:
    """Compile ``csrc/gradnorm.cu`` into ``BUILD_DIR`` unless a library
    built from the same source and flags is already there."""
    global _BUILD
    if _BUILD is None:
        _BUILD = nvcc.build(SOURCE, NVCC_FLAGS, BUILD_DIR)
    return _BUILD


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build().path))
        p = ctypes.c_void_p
        lib.repro_rownorm2_f32.argtypes = [p, p, ctypes.c_int, ctypes.c_int, p]
        lib.repro_rownorm2_f32.restype = ctypes.c_int
        lib.repro_gradnorm_sigma_f32.argtypes = [
            p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
        lib.repro_gradnorm_sigma_f32.restype = ctypes.c_int
        _LIB = lib
    return _LIB


# ------------------------------------------------------------- wrappers

def _check(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the gradnorm kernel takes CUDA tensors "
                         f"(plain version: CPU tensors), got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: the gradnorm kernel takes float32, "
                        f"got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"{name}: expected a 2-D (rows, features) tensor, "
                         f"got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: the gradnorm kernel takes a contiguous "
                         "tensor")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"{name}: too large for the kernel's int sizes")


@torch.library.custom_op("repro_torch::rownorm2", mutates_args=())
def rownorm2_op(x: torch.Tensor) -> torch.Tensor:
    """sum(x^2, axis=-1) for x: (N, F) -> (N,) float32; CPU tensors take
    the plain version, CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return rownorm2_plain(x)
    _check(x, "x")
    n, f = x.shape
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    if n:
        lib = _lib()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            nvcc.raise_on(lib.repro_rownorm2_f32(x.data_ptr(), out.data_ptr(),
                                             n, f, stream), "rownorm2")
        LAUNCHES["rownorm2"] += 1
    return out


@rownorm2_op.register_fake
def _rownorm2_fake(x):
    local.check_fake("gradnorm", x)
    return x.new_empty(x.shape[:1], dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.rownorm2)
def _rownorm2_flops(x_shape, *args, out_shape=None, **kwargs) -> int:
    return int(cost(*x_shape)[0])


@torch.library.custom_op("repro_torch::gradnorm_sigma", mutates_args=())
def gradnorm_sigma_op(h: torch.Tensor, dlogits: torch.Tensor
                      ) -> torch.Tensor:
    """(||h||^2 + 1) * ||dlogits||^2 per row -> (N,) float32; CPU tensors
    take the plain version, CUDA tensors launch the fused kernel."""
    if h.device.type == "cpu" and dlogits.device.type == "cpu":
        return gradnorm_sigma_plain(h, dlogits)
    _check(h, "h")
    _check(dlogits, "dlogits")
    if h.device != dlogits.device or h.shape[0] != dlogits.shape[0]:
        raise ValueError("h and dlogits must share a device and a row "
                         f"count, got {h.device}{tuple(h.shape)} and "
                         f"{dlogits.device}{tuple(dlogits.shape)}")
    n, fh = h.shape
    fd = dlogits.shape[1]
    out = torch.empty(n, dtype=torch.float32, device=h.device)
    if n:
        lib = _lib()
        with torch.cuda.device(h.device):
            stream = torch.cuda.current_stream(h.device).cuda_stream
            nvcc.raise_on(lib.repro_gradnorm_sigma_f32(
                h.data_ptr(), dlogits.data_ptr(), out.data_ptr(), n, fh, fd,
                stream), "gradnorm_sigma")
        LAUNCHES["gradnorm_sigma"] += 1
    return out


@gradnorm_sigma_op.register_fake
def _gradnorm_sigma_fake(h, dlogits):
    local.check_fake("gradnorm", h, dlogits)
    if h.shape[0] != dlogits.shape[0]:
        raise ValueError("h and dlogits must share a row count, got "
                         f"{tuple(h.shape)} and {tuple(dlogits.shape)}")
    return h.new_empty(h.shape[:1], dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.gradnorm_sigma)
def _gradnorm_sigma_flops(h_shape, d_shape, *args, out_shape=None,
                          **kwargs) -> int:
    return int(cost(h_shape[0], h_shape[1], d_shape[1])[0])


def _by_rows(op, *xs: torch.Tensor) -> torch.Tensor:
    """``op`` on each shard's rows of the DTensors ``xs``."""
    pl = local.rows_over_mesh(xs[0], xs[0].shape[0])
    return local.call_local(op, xs, (pl,) * len(xs), pl, xs[0].device_mesh)


def rownorm2(x: torch.Tensor) -> torch.Tensor:
    """sum(x^2, axis=-1) for x: (N, F) -> (N,) float32."""
    if local.is_dtensor(x):
        return _by_rows(rownorm2_op, x)
    return rownorm2_op(x)


def gradnorm_sigma(h: torch.Tensor, dlogits: torch.Tensor) -> torch.Tensor:
    """sigma = (||h||^2 + 1) * ||dlogits||^2 per row, in one pass that
    reads each row of h and of dlogits once."""
    if local.is_dtensor(h):
        return _by_rows(gradnorm_sigma_op, h, dlogits)
    return gradnorm_sigma_op(h, dlogits)
