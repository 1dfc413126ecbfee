"""Causal flash attention: the hand-written CUDA kernel and its plain version.

Counterpart of ``repro/kernels/flash_attention.py``: forward softmax
attention over (BH, S, d) tensors with batch and heads merged, causal or
not, scale d^-0.5 by default, fp32 or bf16 in and the same type out.
``flash_attention`` launches the CUDA C++ kernel of
``csrc/flash_attention.cu`` (built for sm_90a with nvcc at first use and
loaded with ctypes) on CUDA tensors, and uses ``flash_attention_plain``
only for CPU tensors.  Any other device, a dtype other than float32 or
bfloat16, a rank other than 3, a non-contiguous tensor, mismatched
shapes or d > 256 raises: there is no silent fallback.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from . import nvcc
from .nvcc import BuildInfo

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
#: where the shared library is built (listed in .gitignore).
BUILD_DIR = nvcc.BUILD_DIR
NVCC_FLAGS = nvcc.BASE_FLAGS
MAX_HEAD_DIM = 256
_NEG_INF = -1e30

#: kernel launches; bumped only where the kernel launches.
LAUNCHES = {"flash_attention": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------- plain

def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Full fp32 logits, a -1e30 causal mask, softmax, P V, cast to the
    input dtype: the kernel's plain version (``ref.flash_attention_ref``
    of the reference).  q, k, v: (BH, S, d)."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        s = q.shape[1]
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bqk,bkd->bqd", probs, v.float()).to(q.dtype)


# ---------------------------------------------------------------- build

_LIB: Optional[ctypes.CDLL] = None
_BUILD: Optional[BuildInfo] = None


def build() -> BuildInfo:
    """Compile ``csrc/flash_attention.cu`` into ``BUILD_DIR`` unless a
    library built from the same source and flags is already there."""
    global _BUILD
    if _BUILD is None:
        _BUILD = nvcc.build(SOURCE, NVCC_FLAGS, BUILD_DIR)
    return _BUILD


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build().path))
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.repro_flash_attention_f32,
                   lib.repro_flash_attention_bf16):
            fn.argtypes = [p, p, p, p, i, i, i, i, ctypes.c_float, p]
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


# -------------------------------------------------------------- wrapper

def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda":
            raise ValueError(f"{name}: the flash kernel takes CUDA tensors "
                             f"(plain version: CPU tensors), got {x.device}")
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name}: the flash kernel takes float32 or "
                            f"bfloat16, got {x.dtype}")
        if x.dim() != 3:
            raise ValueError(f"{name}: expected a 3-D (BH, S, d) tensor, "
                             f"got shape {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: the flash kernel takes a contiguous "
                             "tensor")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k and v must have one (BH, S, d) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"the flash kernel takes d <= {MAX_HEAD_DIM}, "
                         f"got d={q.shape[-1]}")
    if q.numel() >= 2 ** 31:
        raise ValueError("too large for the kernel's int sizes")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v: (BH, S, d), batch and heads merged (MHA layout) ->
    (BH, S, d) in the input dtype."""
    if all(x.device.type == "cpu" for x in (q, k, v)):
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    _check(q, k, v)
    bh, s, d = q.shape
    scale = d ** -0.5 if scale is None else float(scale)
    out = torch.empty_like(q)
    if q.numel():
        lib = _lib()
        fn = (lib.repro_flash_attention_f32 if q.dtype == torch.float32
              else lib.repro_flash_attention_bf16)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            nvcc.raise_on(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(), bh, s, d, int(causal), scale,
                             stream), "flash_attention")
        LAUNCHES["flash_attention"] += 1
    return out
