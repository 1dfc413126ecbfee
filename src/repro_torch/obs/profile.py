"""Kernel roofline profiling: FLOPs/bytes per profiled function.

Counterpart of ``repro/obs/profile.py``.  XLA's ``cost_analysis`` has
no PyTorch counterpart, so ``cost_of`` runs the function once, for real,
and counts what that call does:

* FLOPs from ``torch.utils.flop_counter.FlopCounterMode`` (matmuls and
  convolutions, forward and backward; elementwise ops count no FLOPs);
* bytes as the sum, over every aten op the call dispatches, of the
  sizes of its tensor inputs and outputs (view ops, which move
  nothing, are skipped).  That is the traffic of the eager program,
  every op unfused: XLA's "bytes accessed" summed per op, not the
  least the work needs;
* the hand-written kernels are custom ops (``kernels/``), which both
  modes see as one op each: FLOPs by the formula each registers (the
  row-norm kernel's is ``gradnorm.cost``), bytes its inputs and output.

``profile_fn`` wraps that into a ``ProfileEvent`` (schema v2) recorded
once per (function, input shapes), stamped with the device's estimated
peak FLOP/s so achieved-vs-peak utilization can be computed later, on
any machine, from the trace alone:

    utilization(stage) = flops / (stage seconds per call) / peak_flops

``repro_torch.obs.summary`` joins profile events against stage timings
to surface exactly that (``telemetry.roofline.<stage>`` rows).

Peak FLOP/s is calibrated once per process and device by timing a dense
float32 matmul with TF32 off (override with ``REPRO_PEAK_FLOPS=<float>``
for a known part or to pin CI numbers).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..device import full_fp32, synchronize
from . import events as ev
from . import metrics as metrics_mod
from . import trace as trace_mod

_PEAK_CACHE: Dict[str, float] = {}


def peak_flops(device: Optional[torch.device] = None) -> float:
    """Estimated peak FLOP/s of ``device`` (default: the CPU; cached).

    Honors ``REPRO_PEAK_FLOPS``; otherwise times a 1024^3 float32
    matmul with TF32 off (best of three, after one warm-up) — a
    *practical* peak, which is the right denominator for "how much of
    what this machine can do did we use".
    """
    env = os.environ.get("REPRO_PEAK_FLOPS")
    if env:
        return float(env)
    dev = torch.device("cpu" if device is None else device)
    key = str(dev)
    if key in _PEAK_CACHE:
        return _PEAK_CACHE[key]
    n = 1024
    a = torch.ones((n, n), dtype=torch.float32, device=dev)
    best = float("inf")
    with full_fp32():
        a @ a  # warm-up (library load, allocator)
        synchronize(dev)
        for _ in range(3):
            t0 = time.perf_counter()
            a @ a
            synchronize(dev)
            best = min(best, time.perf_counter() - t0)
    _PEAK_CACHE[key] = 2.0 * n ** 3 / max(best, 1e-9)
    return _PEAK_CACHE[key]


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, dict):
        return sum(_tensor_bytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(v) for v in x)
    return 0


class _BytesMode(TorchDispatchMode):
    """Sums the bytes of every non-view aten op's tensor inputs and
    outputs."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not getattr(func, "is_view", False):
            self.bytes += (_tensor_bytes(args) + _tensor_bytes(kwargs)
                           + _tensor_bytes(out))
        return out


def cost_of(fn, *args) -> Dict[str, float]:
    """Run ``fn(*args)`` once under the counting modes and return
    ``{"flops", "bytes_accessed", "compile_s"}``; ``compile_s`` is the
    wall time of that counted call (eager code compiles nothing, and
    this call is the one-off price of the profile).  ``fn`` must not
    change its arguments or draw random numbers: it really runs."""
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as flops, _BytesMode() as nbytes:
        out = fn(*args)
    for dev in trace_mod.cuda_devices((args, out), set()):
        torch.cuda.synchronize(dev)
    compile_s = time.perf_counter() - t0
    return {"flops": float(flops.get_total_flops()),
            "bytes_accessed": float(nbytes.bytes),
            "compile_s": compile_s}


@dataclasses.dataclass
class KernelProfile:
    """One profiled function (the in-memory face of ``ProfileEvent``)."""

    name: str
    stage: Optional[str]
    flops: float
    bytes_accessed: float
    peak_flops: float
    compile_s: float

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.bytes_accessed, 1.0)

    def utilization(self, wall_s_per_call: float) -> float:
        """Achieved / peak FLOP/s for one execution of this function."""
        if wall_s_per_call <= 0.0 or self.peak_flops <= 0.0:
            return 0.0
        return self.flops / wall_s_per_call / self.peak_flops


def profile_fn(fn, args: Tuple[Any, ...], name: str,
               stage: Optional[str] = None, telemetry=None, registry=None,
               round: Optional[int] = None,
               device: Optional[torch.device] = None) -> KernelProfile:
    """Profile one function on ``args``, emit the ``ProfileEvent`` and
    the ``feel_kernel_*`` gauges, and return the ``KernelProfile``;
    ``device`` is the one whose peak FLOP/s is recorded."""
    cost = cost_of(fn, *args)
    prof = KernelProfile(name=name, stage=stage, flops=cost["flops"],
                         bytes_accessed=cost["bytes_accessed"],
                         peak_flops=peak_flops(device),
                         compile_s=cost["compile_s"])
    tele = trace_mod.resolve(telemetry)
    tele.emit(ev.ProfileEvent(name=name, stage=stage, flops=prof.flops,
                              bytes_accessed=prof.bytes_accessed,
                              peak_flops=prof.peak_flops,
                              compile_s=prof.compile_s, round=round))
    reg = metrics_mod.resolve(registry)
    if reg.enabled:
        reg.gauge("feel_kernel_flops",
                  "FLOPs per call of each profiled function").set(
                      prof.flops, kernel=name)
        reg.gauge("feel_kernel_bytes",
                  "bytes accessed per call of each profiled function").set(
                      prof.bytes_accessed, kernel=name)
    return prof
