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
backwards in time, with grad_b = g and grad_a_t = g_t h_{t-1}
(h_{-1} = 0): the gradient JAX's autodiff takes of the reference's
associative scan.  It is a second custom op,
``repro_torch::lru_scan_backward`` (``lru_scan_backward_op``): on CUDA
tensors one launch of the backward kernel of ``csrc/lru_scan.cu``, the
forward's schedule walked from t = S - 1, which reads a, h and gbar
once and writes both gradients once (20 B an element with fp32 a); on
CPU tensors ``lru_scan_backward_plain``, the sequential loop.  The
kernel's g is the forward kernel's on time-reversed copies bit for bit.
A train step with remat launches ``lru_scan`` twice a scan layer (the
forward and its recompute) and ``lru_scan_backward`` once.
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
LAUNCHES = {"lru_scan": 0, "lru_scan_backward": 0}


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


def lru_scan_backward_plain(a: torch.Tensor, h: torch.Tensor,
                            gbar: torch.Tensor) -> tuple:
    """(dL/da, dL/db) of h = lru_scan(a, b) in fp32, by the sequential
    adjoint loop: g = a_{t+1} * g + gbar_t from t = S - 1 down (a_S = 0),
    dL/db = g, dL/da_t = g_t h_{t-1} (h_{-1} = 0).  a, h, gbar: (B, S, C)
    -> two new (B, S, C) float32 tensors."""
    a, h, gbar = a.float(), h.float(), gbar.float()
    S = a.shape[1]
    if S == 0:
        return torch.zeros_like(a), torch.zeros_like(a)
    g = gbar[:, S - 1]
    out = [g]
    for t in range(S - 2, -1, -1):
        g = a[:, t + 1] * g + gbar[:, t]
        out.append(g)
    grad_b = torch.stack(out[::-1], dim=1)
    grad_a = torch.zeros_like(grad_b)
    grad_a[:, 1:] = grad_b[:, 1:] * h[:, :S - 1]
    return grad_a, grad_b


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
        for fn in (lib.repro_lru_scan_backward_f32,
                   lib.repro_lru_scan_backward_bf16):
            fn.argtypes = [p, p, p, p, p, i64, i64, i64, p]
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


# -------------------------------------------------------------- wrapper

_GATES = (torch.float32, torch.bfloat16)  # the dtypes of a (and of b)


def _same_shape(**xs: torch.Tensor) -> None:
    shapes = [tuple(x.shape) for x in xs.values()]
    if any(shape != shapes[0] for shape in shapes[1:]):  # (SymInts too)
        raise ValueError(f"{', '.join(xs)} must have one (B, S, C) shape, "
                         f"got {shapes}")


def _check_each(kernel: str, **xs: tuple) -> None:
    """Each ``name=(tensor, dtypes it may have)`` as ``kernel`` takes it:
    a contiguous 3-D CUDA tensor, all of one shape and device."""
    for name, (x, dtypes) in xs.items():
        if x.device.type != "cuda":
            raise ValueError(f"{name}: the {kernel} takes CUDA tensors "
                             f"(plain version: CPU tensors), got {x.device}")
        if x.dtype not in dtypes:
            raise TypeError(f"{name}: the {kernel} takes "
                            f"{' or '.join(map(str, dtypes))}, got {x.dtype}")
        if x.dim() != 3:
            raise ValueError(f"{name}: expected a 3-D (B, S, C) tensor, "
                             f"got shape {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: the {kernel} takes a contiguous "
                             "tensor")
    _same_shape(**{name: x for name, (x, _) in xs.items()})
    if len({x.device for x, _ in xs.values()}) > 1:
        raise ValueError(f"{', '.join(xs)} must be on one device")


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    _check_each("scan kernel", a=(a, _GATES), b=(b, _GATES))
    if a.dtype != b.dtype:
        raise TypeError(f"a and b must share a dtype, got {a.dtype} and "
                        f"{b.dtype}")


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
    _same_shape(a=a, b=b)
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

@torch.library.custom_op("repro_torch::lru_scan_backward", mutates_args=())
def lru_scan_backward_op(a: torch.Tensor, h: torch.Tensor,
                         gbar: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dL/da, dL/db), both new (B, S, C) float32, of h = lru_scan(a, b)
    given a, h and gbar = dL/dh; CPU tensors take the plain version, CUDA
    tensors launch the backward kernel."""
    if all(x.device.type == "cpu" for x in (a, h, gbar)):
        return lru_scan_backward_plain(a, h, gbar)
    f32 = (torch.float32,)
    _check_each("scan's backward kernel", a=(a, _GATES), h=(h, f32),
                gbar=(gbar, f32))
    B, S, C = a.shape
    grad_a = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    grad_b = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    if a.numel():
        lib = _lib()
        fn = (lib.repro_lru_scan_backward_f32 if a.dtype == torch.float32
              else lib.repro_lru_scan_backward_bf16)
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            nvcc.raise_on(fn(a.data_ptr(), h.data_ptr(), gbar.data_ptr(),
                             grad_a.data_ptr(), grad_b.data_ptr(), B, S, C,
                             stream), "lru_scan_backward")
        LAUNCHES["lru_scan_backward"] += 1
    return grad_a, grad_b


@lru_scan_backward_op.register_fake
def _lru_scan_backward_fake(a, h, gbar):
    local.check_fake("scan's backward", a, h, gbar)
    _same_shape(a=a, h=h, gbar=gbar)
    return (a.new_empty(a.shape, dtype=torch.float32),
            a.new_empty(a.shape, dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.lru_scan_backward)
def _lru_scan_backward_flops(a_shape, h_shape, gbar_shape, *args,
                             out_shape=None, **kwargs) -> int:
    """The adjoint's multiply and add, and dL/da's multiply, per step and
    channel."""
    B, S, C = a_shape
    return 3 * B * S * C


def _save_for_backward(ctx, inputs, output) -> None:
    a, b = inputs
    ctx.save_for_backward(a, output)
    ctx.dtypes = (a.dtype, b.dtype)


def _backward(ctx, gbar: torch.Tensor):
    a, h = ctx.saved_tensors
    # autograd may hand gbar over expanded or strided (the gradient of
    # h.sum() is an expanded scalar); the kernel reads a contiguous one
    grad_a, grad_b = lru_scan_backward_op(a, h, gbar.contiguous())
    return grad_a.to(ctx.dtypes[0]), grad_b.to(ctx.dtypes[1])


lru_scan_op.register_autograd(_backward, setup_context=_save_for_backward)
