"""Flash attention: the hand-written CUDA kernels and their plain versions.

Counterpart of ``repro/kernels/flash_attention.py``: forward softmax
attention, causal or not, scale d^-0.5 by default, fp32 or bf16 in and
the same type out.  Two entries:

- ``flash_attention(q, k, v)`` keeps the reference's (BH, S, d)
  signature, batch and heads merged;
- ``flash_attention_bhsd(q, k, v)``, the reference's MHA entry widened
  to GQA, reads the serving layout in place: q (B, S, H, d), k (B, S,
  Hk, d) and v (B, S, Hk, dv) with Hk dividing H and dv <= d, any
  strides with a unit stride over d; query head h reads kv head
  h // (H / Hk), as ``models.layers._gqa_split`` groups them.  It makes
  no fold copy of q, k or v and no per-head copy of the kv heads, and
  writes a contiguous (B, S, H, dv) output.  A v narrower than q and k
  (multi-head latent attention's prefill: d = 192, dv = 128) is copied
  with its columns zero-padded to d before the launch, since the
  kernels take one head width, and the output is cut back to dv.

On CUDA tensors, bf16 launches the TMA + wgmma tensor-core kernel of
``csrc/flash_attention_sm90.cu`` and fp32 the CUDA-core kernel of
``csrc/flash_attention.cu``; both are built for sm_90a with nvcc at
first use and loaded with ctypes.  TMA reads a bf16 operand in place
when d % 8 == 0 and its pointer and strides are 16-byte aligned, as on
the serving path; any other bf16 operand is first copied into an
aligned buffer with d zero-padded to a multiple of 8 (``_tma_operand``).
CPU tensors take the plain version.
Any other device, a dtype other than float32 or bfloat16, a wrong rank,
a non-unit stride over d, mismatched shapes, dv > d or d > 256 raises:
there is no silent fallback.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from . import nvcc
from .nvcc import BuildInfo

_CSRC = Path(__file__).resolve().parent / "csrc"
#: the fp32 CUDA-core kernel
SOURCE = _CSRC / "flash_attention.cu"
#: the bf16 tensor-core kernel
SOURCE_SM90 = _CSRC / "flash_attention_sm90.cu"
#: where the shared libraries are built (listed in .gitignore).
BUILD_DIR = nvcc.BUILD_DIR
NVCC_FLAGS = nvcc.BASE_FLAGS
MAX_HEAD_DIM = 256
_NEG_INF = -1e30

#: kernel launches; bumped only where a kernel launches.
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


def flash_attention_bhsd_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, causal: bool = True,
                               scale: Optional[float] = None) -> torch.Tensor:
    """The plain version in the serving layout: the kv heads are
    broadcast to the query heads, then ``flash_attention_plain``.
    q: (B, S, H, d); k: (B, S, Hk, d); v: (B, S, Hk, dv) -> contiguous
    (B, S, H, dv)."""
    B, S, H, d = q.shape

    def fold(x):
        if x.shape[2] != H:
            x = x.repeat_interleave(H // x.shape[2], dim=2)
        return x.movedim(2, 1).reshape(B * H, S, x.shape[-1])

    out = flash_attention_plain(fold(q), fold(k), fold(v), causal=causal,
                                scale=scale)
    return out.reshape(B, H, S, -1).movedim(1, 2).contiguous()


# ---------------------------------------------------------------- build

_FNS: dict = {}
_BUILD: Optional[BuildInfo] = None
_BUILD_SM90: Optional[BuildInfo] = None


def build() -> BuildInfo:
    """Compile ``csrc/flash_attention.cu`` (fp32) into ``BUILD_DIR``
    unless a library built from the same source and flags is there."""
    global _BUILD
    if _BUILD is None:
        _BUILD = nvcc.build(SOURCE, NVCC_FLAGS, BUILD_DIR)
    return _BUILD


def build_sm90() -> BuildInfo:
    """Compile ``csrc/flash_attention_sm90.cu`` (bf16) likewise."""
    global _BUILD_SM90
    if _BUILD_SM90 is None:
        _BUILD_SM90 = nvcc.build(SOURCE_SM90, NVCC_FLAGS, BUILD_DIR)
    return _BUILD_SM90


def _fn(dtype: torch.dtype):
    """The C entry point for ``dtype``, its library loaded at first use."""
    if dtype not in _FNS:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # q, k, v, o; B, S, H, Hk, d; strides; causal, scale
        args = [p, p, p, p, i, i, i, i, i, p, i, f]
        if dtype == torch.float32:
            fn = ctypes.CDLL(str(build().path)).repro_flash_attention_f32
        else:
            fn = ctypes.CDLL(
                str(build_sm90().path)).repro_flash_attention_bf16
        fn.argtypes = args + [p]  # stream
        fn.restype = ctypes.c_int
        _FNS[dtype] = fn
    return _FNS[dtype]


# -------------------------------------------------------------- wrapper

def _on_cpu(**tensors: torch.Tensor) -> bool:
    """True if every tensor lies on the CPU (the plain version's case),
    False if every one is a CUDA tensor (the kernel's); anything else
    raises."""
    if all(x.device.type == "cpu" for x in tensors.values()):
        return True
    for name, x in tensors.items():
        if x.device.type != "cuda":
            raise ValueError(f"{name}: the flash kernel takes CUDA tensors "
                             f"(plain version: CPU tensors), got {x.device}")
    return False


def _check_tensor(name: str, x: torch.Tensor, rank: int) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: the flash kernel takes float32 or "
                        f"bfloat16, got {x.dtype}")
    if x.dim() != rank:
        layout = "(BH, S, d)" if rank == 3 else "(B, S, H, d)"
        raise ValueError(f"{name}: expected a {rank}-D {layout} tensor, "
                         f"got shape {tuple(x.shape)}")
    if x.stride(-1) != 1 and x.shape[-1] > 1:
        raise ValueError(f"{name}: the flash kernel takes tensors whose "
                         "last dimension (d) is contiguous")


def _check_pair(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"the flash kernel takes d <= {MAX_HEAD_DIM}, "
                         f"got d={q.shape[-1]}")


def _check_bhsd_shapes(q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor) -> None:
    """q (B, S, H, d), k (B, S, Hk, d) and v (B, S, Hk, dv) with Hk
    dividing H and dv <= d, on either device."""
    ok = q.dim() == k.dim() == v.dim() == 4
    if ok:
        B, S, H, d = q.shape
        Hk = k.shape[2]
        ok = (k.shape[:2] == (B, S) and k.shape[3] == d
              and v.shape[:3] == k.shape[:3] and v.shape[3] <= d
              and Hk > 0 and H % Hk == 0)
    if not ok:
        raise ValueError("expected q (B, S, H, d), k (B, S, Hk, d) and v "
                         "(B, S, Hk, dv) with Hk dividing H and dv <= d, got "
                         f"shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")


def kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                o: torch.Tensor) -> tuple:
    """Sizes (B, S, H, Hk, d) and the 12 element strides (batch, seq,
    head of q, k, v, o) that the C entry points take, for (B, S, H, d)
    q and o and (B, S, Hk, d) k and v."""
    B, S, H, d = q.shape
    strides = tuple(s for x in (q, k, v, o) for s in x.stride()[:3])
    return (B, S, H, k.shape[2], d), strides


def _tma_readable(x: torch.Tensor) -> bool:
    """Whether TMA reads the bf16 (B, S, H, d) view ``x`` in place: its
    base is 16-byte aligned, and d and every stride it steps (over a
    dimension longer than 1) are positive multiples of 8 elements."""
    return (x.shape[-1] % 8 == 0 and x.data_ptr() % 16 == 0
            and all(n == 1 or (st > 0 and st % 8 == 0)
                    for n, st in zip(x.shape[:3], x.stride()[:3])))


def _tma_operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself where TMA reads it in place, else a fresh contiguous
    copy with d zero-padded to a multiple of 8: zero columns add nothing
    to q k^T, and the output's padded columns are dropped."""
    if _tma_readable(x):
        return x
    d = x.shape[-1]
    buf = x.new_empty(x.shape[:-1] + (-(-d // 8) * 8,))
    buf[..., :d] = x
    buf[..., d:] = 0
    return buf


def _value_operand(v: torch.Tensor, d: int) -> torch.Tensor:
    """v (B, S, Hk, dv) as a fresh contiguous copy with its columns
    zero-padded to d: zero columns of V add nothing to P V, and the
    output's padded columns are dropped."""
    buf = v.new_zeros(v.shape[:-1] + (d,))
    buf[..., :v.shape[-1]] = v
    return buf


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            scale: Optional[float]) -> torch.Tensor:
    """One kernel launch on (B, S, H, d) q and (B, S, Hk, d) k, v;
    returns a contiguous (B, S, H, d) output."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else float(scale)
    if q.dtype == torch.bfloat16:
        q, k, v = (_tma_operand(x) for x in (q, k, v))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if not out.numel():
        return out[..., :d]
    sizes, strides = kernel_args(q, k, v, out)
    fn = _fn(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        nvcc.raise_on(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), *sizes,
                         (ctypes.c_longlong * 12)(*strides), int(causal),
                         scale, stream), "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out if out.shape[-1] == d else out[..., :d].contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v: (BH, S, d), batch and heads merged (MHA layout) ->
    (BH, S, d) in the input dtype."""
    if _on_cpu(q=q, k=k, v=v):
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_tensor(name, x, 3)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k and v must have one (BH, S, d) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    _check_pair(q, k, v)
    return _launch(q[:, :, None], k[:, :, None], v[:, :, None], causal,
                   scale)[:, :, 0]


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, S, H, d); k: (B, S, Hk, d); v: (B, S, Hk, dv) with Hk
    dividing H and dv <= d, read in place (GQA: query head h reads kv
    head h // (H / Hk)) -> contiguous (B, S, H, dv) in the input dtype.
    With Hk == H and dv == d it is the reference's
    ``ops.flash_attention_bhsd``; with dv < d, the reference's
    ``causal_attend`` (to which MLA's prefill hands a narrower v)."""
    if _on_cpu(q=q, k=k, v=v):
        _check_bhsd_shapes(q, k, v)
        return flash_attention_bhsd_plain(q, k, v, causal=causal,
                                          scale=scale)
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_tensor(name, x, 4)
    _check_bhsd_shapes(q, k, v)
    _check_pair(q, k, v)
    d, dv = q.shape[3], v.shape[3]
    if dv == d:
        return _launch(q, k, v, causal, scale)
    return _launch(q, k, _value_operand(v, d), causal,
                   scale)[..., :dv].contiguous()
