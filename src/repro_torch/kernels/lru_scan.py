"""Linear-recurrence scan: the hand-written CUDA kernel and its plain version.

Counterpart of ``repro/kernels/lru_scan.py``: h_t = a_t * h_{t-1} + b_t
over (B, S, C) tensors from h_{-1} = 0, with an fp32 carry and fp32
output.  The Mamba-1 mixer (``models/ssm.py``) runs its prefill
recurrence through it, with the (d_inner, n_state) plane flattened into
channels, and the RG-LRU mixer (``models/rglru.py``) with its lru_width
channels.  ``lru_scan`` launches the CUDA C++ kernel of
``csrc/lru_scan.cu`` (built for sm_90a with nvcc at first use and loaded
with ctypes) on CUDA tensors, and uses ``lru_scan_plain`` only for CPU
tensors.  The kernel splits the sequence inside each block of ``TILE``
channels of one batch row (chunks of ``WARPS * STEPS`` steps, ``STEPS``
a warp), reads a and b once and writes h once; its grid folds batch and
channel tiles into one dimension, so it takes any batch, any S and C,
and a contiguous view at any offset.  Any other device, a dtype other
than float32 or bfloat16, a rank other than 3, a non-contiguous tensor,
or mismatched shapes, dtypes or devices raise: there is no silent
fallback.

The kernel is the custom op ``repro_torch::lru_scan`` (``lru_scan_op``),
with a shape-only implementation for fake tensors, a FLOP formula (a
multiply and an add per element) that ``torch.utils.flop_counter``
reads, and its gradient registered as the op's autograd, for the
mixers' train mode.  On
DTensors ``lru_scan`` runs it on each shard's channels (``local.py``):
a batch or channel sharding is kept, a sequence one gathered first.
The gradient is the adjoint recurrence
g_t = gbar_t + a_{t+1} g_{t+1} (a_S = 0), itself a linear recurrence run
backwards in time: the backward pass launches the same kernel on
time-reversed contiguous copies of gbar and of a shifted by one step,
then grad_b = g and grad_a_t = g_t h_{t-1} (h_{-1} = 0).  That is the
gradient JAX's autodiff takes of the reference's associative scan.  A
train step with remat launches the kernel three times a scan layer: the
forward, its recompute and the backward.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from . import local, nvcc
from .nvcc import BuildInfo

SOURCE = Path(__file__).resolve().parent / "csrc" / "lru_scan.cu"
#: where the shared library is built (listed in .gitignore).
BUILD_DIR = nvcc.BUILD_DIR
NVCC_FLAGS = nvcc.BASE_FLAGS
#: the kernel's schedule (``kTile``, ``kWarps``, ``kSteps`` in
#: ``csrc/lru_scan.cu``): a block owns TILE channels of one batch row and
#: walks S in chunks of WARPS * STEPS steps, STEPS consecutive ones a warp.
#: The tests and ``chip_smoke.py`` take the chunk's seams from here, and
#: ``tests/test_torch_scan_split.py`` holds these to the source.
TILE, WARPS, STEPS = 32, 16, 16

#: kernel launches; bumped only where the kernel launches.
LAUNCHES = {"lru_scan": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------- plain

def lru_scan_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The sequential definition in fp32 (``ref.lru_scan_ref`` of the
    reference): a loop over S of h = a_t * h + b_t, stacked.
    a, b: (B, S, C) -> (B, S, C) float32."""
    a, b = a.float(), b.float()
    if a.shape[1] == 0:
        return torch.zeros_like(a)
    h = torch.zeros_like(a[:, 0])
    out = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------- build

_LIB: Optional[ctypes.CDLL] = None
_BUILD: Optional[BuildInfo] = None


def build() -> BuildInfo:
    """Compile ``csrc/lru_scan.cu`` into ``BUILD_DIR`` unless a library
    built from the same source and flags is already there."""
    global _BUILD
    if _BUILD is None:
        _BUILD = nvcc.build(SOURCE, NVCC_FLAGS, BUILD_DIR)
    return _BUILD


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build().path))
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        for fn in (lib.repro_lru_scan_f32, lib.repro_lru_scan_bf16):
            fn.argtypes = [p, p, p, i64, i64, i64, p]
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


# -------------------------------------------------------------- wrapper

def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    for name, x in (("a", a), ("b", b)):
        if x.device.type != "cuda":
            raise ValueError(f"{name}: the scan kernel takes CUDA tensors "
                             f"(plain version: CPU tensors), got {x.device}")
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name}: the scan kernel takes float32 or "
                            f"bfloat16, got {x.dtype}")
        if x.dim() != 3:
            raise ValueError(f"{name}: expected a 3-D (B, S, C) tensor, "
                             f"got shape {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: the scan kernel takes a contiguous "
                             "tensor")
    if a.shape != b.shape:
        raise ValueError(f"a and b must have one (B, S, C) shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise TypeError(f"a and b must share a dtype, got {a.dtype} and "
                        f"{b.dtype}")
    if a.device != b.device:
        raise ValueError("a and b must be on one device")


@torch.library.custom_op("repro_torch::lru_scan", mutates_args=())
def lru_scan_op(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, C) -> a new h: (B, S, C) float32 with
    h_t = a_t h_{t-1} + b_t; CPU tensors take the plain version, CUDA
    tensors launch the kernel."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return lru_scan_plain(a, b)
    _check(a, b)
    B, S, C = a.shape
    out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    if a.numel():
        lib = _lib()
        fn = (lib.repro_lru_scan_f32 if a.dtype == torch.float32
              else lib.repro_lru_scan_bf16)
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            nvcc.raise_on(fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                             B, S, C, stream), "lru_scan")
        LAUNCHES["lru_scan"] += 1
    return out


@lru_scan_op.register_fake
def _lru_scan_fake(a, b):
    local.check_fake("scan", a, b)
    if a.shape != b.shape:
        raise ValueError(f"a and b must have one (B, S, C) shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    return a.new_empty(a.shape, dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.lru_scan)
def _lru_scan_flops(a_shape, b_shape, *args, out_shape=None,
                    **kwargs) -> int:
    """A multiply and an add per step and channel."""
    B, S, C = a_shape
    return 2 * B * S * C


def lru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, C) -> h: (B, S, C) float32 with
    h_t = a_t h_{t-1} + b_t, differentiable (the op's autograd)."""
    if local.is_dtensor(a):
        B, C = a.shape[0], a.shape[2]
        pl = local.keep_shards(
            a, (0, 2), lambda dim, n: (B if dim == 0 else C) % n == 0)
        return local.call_local(lru_scan_op, (a, b), (pl, pl), pl,
                                a.device_mesh)
    return lru_scan_op(a, b)


# ------------------------------------------------------------- gradient

def lru_scan_backward(a: torch.Tensor, h: torch.Tensor, gbar: torch.Tensor
                      ) -> tuple:
    """(dL/da, dL/db) in fp32 of h = lru_scan(a, b), given h and the
    incoming gradient gbar = dL/dh: the adjoint g_t = gbar_t + a_{t+1}
    g_{t+1} (a_S = 0) is ``lru_scan`` on time-reversed contiguous copies
    of gbar and of a shifted by one step (one kernel launch on CUDA
    tensors), then dL/db = g and dL/da_t = g_t h_{t-1} (h_{-1} = 0)."""
    S = a.shape[1]
    # reversed step i is step S-1-i: its gate is a_{S-i} (none at i = 0)
    a_rev = torch.zeros(a.shape, dtype=torch.float32, device=a.device)
    a_rev[:, 1:] = a[:, 1:].flip(1)
    g = lru_scan(a_rev, gbar.float().flip(1)).flip(1)
    del a_rev
    grad_a = torch.zeros_like(g)
    grad_a[:, 1:] = g[:, 1:] * h[:, :S - 1]
    return grad_a, g


def _save_for_backward(ctx, inputs, output) -> None:
    a, b = inputs
    ctx.save_for_backward(a, output)
    ctx.dtypes = (a.dtype, b.dtype)


def _backward(ctx, gbar: torch.Tensor):
    a, h = ctx.saved_tensors
    grad_a, grad_b = lru_scan_backward(a, h, gbar)
    return grad_a.to(ctx.dtypes[0]), grad_b.to(ctx.dtypes[1])


lru_scan_op.register_autograd(_backward, setup_context=_save_for_backward)
