"""Flash attention: the hand-written CUDA kernels and their plain versions.

Counterpart of ``repro/kernels/flash_attention.py``: forward softmax
attention, causal or not, scale d^-0.5 by default, fp32 or bf16 in and
the same type out, widened to what the JAX zoo's ``causal_attend``
computes around it: logit softcapping (``softcap > 0``: a logit s =
scale q.k becomes softcap * tanh(s / softcap) before the mask, as
``repro/models/layers.py::_softmax_attend`` does) and a query offset
(query row i sits at position ``q_offset + i``, keys at 0 .. Sk - 1, so
k and v may be longer than q: a chunk of a prefill against the keys so
far).  A negative ``q_offset`` raises ``ValueError`` on every device:
it leaves rows that see no key, where the reference's softmax gives the
mean of v and the kernels 0.  Two entries:

- ``flash_attention(q, k, v)`` keeps the reference's (BH, S, d)
  signature, batch and heads merged;
- ``flash_attention_bhsd(q, k, v)``, the reference's MHA entry widened
  to GQA, reads the serving layout in place: q (B, Sq, H, d), k (B, Sk,
  Hk, d) and v (B, Sk, Hk, dv) with Hk dividing H and dv <= d, any
  strides with a unit stride over d; query head h reads kv head
  h // (H / Hk), as ``models.layers._gqa_split`` groups them.  It makes
  no fold copy of q, k or v and no per-head copy of the kv heads, and
  writes a contiguous (B, Sq, H, dv) output.  A v narrower than q and k
  (multi-head latent attention's prefill: d = 192, dv = 128) is read in
  place by both kernels, each with a value width of its own: the bf16
  kernel's V tiles are as wide as its instance's (``bf16_instance``),
  TMA zero-filling the columns past dv, so every pair dv <= d <= 256
  has an instance and no zero-padded copy of v is made.

The kernel is the custom op ``repro_torch::flash_attention``
(``flash_attention_op``) on the serving layout, with a shape-only
implementation for fake tensors and a FLOP formula (q k^T and p v over
the (query, key) pairs the mask keeps) that ``torch.utils.flop_counter``
reads.  On DTensors
``flash_attention_bhsd`` runs it on each shard's heads (``local.py``):
a batch or head sharding is kept, any other is redistributed first.

On CUDA tensors, bf16 launches the TMA + wgmma tensor-core kernel of
``csrc/flash_attention_sm90.cu`` (the instance ``bf16_instance(d, dv)``,
softcapped when ``softcap > 0``) and fp32 the CUDA-core kernel of
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
from torch.utils.flop_counter import register_flop_formula

from . import local, nvcc
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

def check_offset(q_offset: int) -> None:
    """A negative query offset leaves rows that see no key: refused."""
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}: rows "
                         "that see no key are not computed")


def causal_pairs(sq: int, sk: int, q_offset: int = 0) -> int:
    """The (query, key) pairs a causal mask keeps: query i (position
    q_offset + i) sees min(sk, q_offset + i + 1) keys; summed over i."""
    a = max(0, min(sq, sk - q_offset))  # rows that see fewer than sk keys
    return a * q_offset + a * (a + 1) // 2 + (sq - a) * sk


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, scale: Optional[float] = None,
                          softcap: float = 0.0,
                          q_offset: int = 0) -> torch.Tensor:
    """Full fp32 logits, the softcap, a -1e30 causal mask, softmax, P V,
    cast to the input dtype: the kernel's plain version
    (``ref.flash_attention_ref`` of the reference, with the zoo's
    softcap and offset).  q: (BH, Sq, d); k, v: (BH, Sk, d)."""
    check_offset(q_offset)
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = torch.arange(k.shape[1], device=q.device)
        logits = logits.masked_fill(kpos[None, :] > qpos[:, None], _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bqk,bkd->bqd", probs, v.float()).to(q.dtype)


def flash_attention_bhsd_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, causal: bool = True,
                               scale: Optional[float] = None,
                               softcap: float = 0.0,
                               q_offset: int = 0) -> torch.Tensor:
    """The plain version in the serving layout: the kv heads are
    broadcast to the query heads, then ``flash_attention_plain``.
    q: (B, Sq, H, d); k: (B, Sk, Hk, d); v: (B, Sk, Hk, dv) ->
    contiguous (B, Sq, H, dv)."""
    B, S, H, d = q.shape

    def fold(x):
        if x.shape[2] != H:
            x = x.repeat_interleave(H // x.shape[2], dim=2)
        return x.movedim(2, 1).reshape(B * H, x.shape[1], x.shape[-1])

    out = flash_attention_plain(fold(q), fold(k), fold(v), causal=causal,
                                scale=scale, softcap=softcap,
                                q_offset=q_offset)
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
        # q, k, v, o; B, Sq, Sk, H, Hk, d, dv[, the bf16 instance's DC,
        # DVC, BK]; strides; causal, scale, softcap, q_offset; stream
        tail = [p, i, f, f, i, p]
        if dtype == torch.float32:
            fn = ctypes.CDLL(str(build().path)).repro_flash_attention_f32
            fn.argtypes = [p] * 4 + [i] * 7 + tail
        else:
            fn = ctypes.CDLL(
                str(build_sm90().path)).repro_flash_attention_bf16
            fn.argtypes = [p] * 4 + [i] * 10 + tail
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
    """q (B, Sq, H, d), k (B, Sk, Hk, d) and v (B, Sk, Hk, dv) with Hk
    dividing H, dv <= d and Sk >= 1, on either device."""
    ok = q.dim() == k.dim() == v.dim() == 4
    if ok:
        B, _, H, d = q.shape
        Hk = k.shape[2]
        ok = (k.shape[0] == B and k.shape[1] > 0 and k.shape[3] == d
              and v.shape[:3] == k.shape[:3] and v.shape[3] <= d
              and Hk > 0 and H % Hk == 0)
    if not ok:
        raise ValueError("expected q (B, Sq, H, d), k (B, Sk, Hk, d) and v "
                         "(B, Sk, Hk, dv) with Hk dividing H, dv <= d and "
                         f"Sk >= 1, got shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")


def kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                o: torch.Tensor) -> tuple:
    """Sizes (B, Sq, Sk, H, Hk, d) and the 12 element strides (batch,
    seq, head of q, k, v, o) that the C entry points take, for (B, Sq,
    H, d) q, (B, Sk, Hk, d) k and v and o of q's first three sizes (v
    and o may be narrower than d)."""
    B, Sq, H, d = q.shape
    strides = tuple(s for x in (q, k, v, o) for s in x.stride()[:3])
    return (B, Sq, k.shape[1], H, k.shape[2], d), strides


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


def bf16_instance(d: int, dv: int) -> tuple[int, int, int]:
    """The bf16 kernel's instance for head width d and value width dv <=
    d (after ``_tma_operand``: multiples of 8 up to 256), which
    ``_launch`` hands the C entry: ``flash_wgmma_kernel<DC, DVC, BK,
    ...>``'s 64-column chunks of d (q, K) and of the V tile, and keys
    per K/V stage.  At 128 < d <= 192 a dv <= 128 (latent attention's
    192 / 128) takes a V tile of 128 columns, which leaves shared memory
    for 128 keys a stage, and a wider one (stablelm's 160) 96 keys a
    stage; everywhere else the V tile is as wide as q's."""
    if d <= 64:
        return 1, 1, 128
    if d <= 128:
        return 2, 2, 128
    if d <= 192:
        return (3, 2, 128) if dv <= 128 else (3, 3, 96)
    return 4, 4, 64


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            scale: Optional[float], softcap: float,
            q_offset: int) -> torch.Tensor:
    """One kernel launch on (B, Sq, H, d) q, (B, Sk, Hk, d) k and (B, Sk,
    Hk, dv) v, dv <= d, each read in place (in bf16 unless TMA cannot
    read it: ``_tma_operand``); returns a contiguous (B, Sq, H, dv)
    output."""
    dv = v.shape[-1]
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    instance = ()
    if q.dtype == torch.bfloat16:
        q, k, v = (_tma_operand(x) for x in (q, k, v))
        instance = bf16_instance(q.shape[-1], v.shape[-1])
    out = torch.empty(q.shape[:3] + v.shape[3:], dtype=q.dtype,
                      device=q.device)
    if not out.numel():
        return out[..., :dv]
    sizes, strides = kernel_args(q, k, v, out)
    fn = _fn(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        nvcc.raise_on(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), *sizes, out.shape[-1], *instance,
                         (ctypes.c_longlong * 12)(*strides), int(causal),
                         scale, float(softcap), int(q_offset), stream),
                     "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out if out.shape[-1] == dv else out[..., :dv].contiguous()


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, scale: Optional[float],
                       softcap: float = 0.0,
                       q_offset: int = 0) -> torch.Tensor:
    """The kernel as an op on the serving layout: q (B, Sq, H, d), k (B,
    Sk, Hk, d), v (B, Sk, Hk, dv) -> a new contiguous (B, Sq, H, dv),
    query row i at position ``q_offset + i``; ``softcap > 0`` caps the
    logits.  A negative ``q_offset`` raises ``ValueError`` on every
    device.  CPU tensors take the plain version; CUDA tensors launch the
    kernel after the checks above."""
    check_offset(q_offset)
    if _on_cpu(q=q, k=k, v=v):
        _check_bhsd_shapes(q, k, v)
        return flash_attention_bhsd_plain(q, k, v, causal=causal,
                                          scale=scale, softcap=softcap,
                                          q_offset=q_offset)
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_tensor(name, x, 4)
    _check_bhsd_shapes(q, k, v)
    _check_pair(q, k, v)
    return _launch(q, k, v, causal, scale, softcap, q_offset)


@flash_attention_op.register_fake
def _flash_fake(q, k, v, causal, scale, softcap=0.0, q_offset=0):
    local.check_fake("flash", q, k, v)
    check_offset(q_offset)
    _check_bhsd_shapes(q, k, v)
    return q.new_empty(q.shape[:3] + (v.shape[3],))


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def flash_flops(q_shape, k_shape, v_shape, causal, scale, softcap=0.0,
                q_offset=0, *args, out_shape=None, **kwargs) -> int:
    """2 flops per multiply-add of q k^T (width d) and of p v (width dv)
    over the (query, key) pairs the kernel visits: when causal, query i
    (position q_offset + i) against min(Sk, q_offset + i + 1) keys
    (``causal_pairs``; Sq (Sq + 1) / 2 for a prefill from 0), else
    Sq Sk."""
    B, Sq, H, d = q_shape
    Sk = k_shape[1]
    pairs = causal_pairs(Sq, Sk, q_offset) if causal else Sq * Sk
    return 2 * B * H * (d + v_shape[3]) * pairs


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    softcap: float = 0.0, q_offset: int = 0) -> torch.Tensor:
    """q: (BH, Sq, d); k, v: (BH, Sk, d), batch and heads merged (MHA
    layout) -> (BH, Sq, d) in the input dtype."""
    if not _on_cpu(q=q, k=k, v=v):
        for name, x in (("q", q), ("k", k), ("v", v)):
            _check_tensor(name, x, 3)
        if (k.shape != v.shape or k.shape[0] != q.shape[0]
                or k.shape[2] != q.shape[2]):
            raise ValueError("expected q (BH, Sq, d) and k, v (BH, Sk, d), "
                             f"got shapes {tuple(q.shape)}, "
                             f"{tuple(k.shape)}, {tuple(v.shape)}")
    return flash_attention_op(q[:, :, None], k[:, :, None], v[:, :, None],
                              causal, scale, softcap, q_offset)[:, :, 0]


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, scale: Optional[float] = None,
                         softcap: float = 0.0,
                         q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, d); k: (B, Sk, Hk, d); v: (B, Sk, Hk, dv) with Hk
    dividing H and dv <= d, read in place (GQA: query head h reads kv
    head h // (H / Hk)) -> contiguous (B, Sq, H, dv) in the input dtype;
    query row i at position ``q_offset`` + i, logits softcapped where
    ``softcap > 0``.  With Hk == H, dv == d, Sk == Sq and no softcap or
    offset it is the reference's ``ops.flash_attention_bhsd``; else the
    reference's ``causal_attend`` (to which MLA's prefill hands a
    narrower v).  DTensors run shard by shard: the batch split as q's
    is, the heads where both H and Hk divide over the mesh dimension,
    the rest gathered."""
    if local.is_dtensor(q):
        B, H, Hk = q.shape[0], q.shape[2], k.shape[2]
        pl = local.keep_shards(
            q, (0, 2), lambda dim, n: (B % n == 0 if dim == 0 else
                                       H % n == 0 and Hk % n == 0))
        return local.call_local(flash_attention_op,
                                (q, k, v, causal, scale, softcap, q_offset),
                                (pl, pl, pl, None, None, None, None), pl,
                                q.device_mesh)
    return flash_attention_op(q, k, v, causal, scale, softcap, q_offset)
