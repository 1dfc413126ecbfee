"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the ``cuda`` marker and skips without a GPU:
a CUDA kernel has no CPU mode.  The file imports only torch and
``repro_torch`` (no JAX), so it also runs on a GPU machine without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

Tolerances: the row-norm kernels at rtol 1e-5 (float32 sums taken in
another order); flash attention at atol/rtol 2e-5 in fp32 and 2e-2 in
bf16, the reference's kernel tolerances (tests/test_kernels.py); the
linear-recurrence scan at atol/rtol 1e-5 (the kernel's fused
multiply-add against the plain version's multiply, then add), the
reference's scan tolerance, and so the RG-LRU mixer through it against
the same mixer on the CPU; the scan's gradient (its backward kernel,
walked backwards in time) at atol/rtol 1e-5 against autograd through
the plain loop on the card, and bit for bit against the route it
replaced (the forward kernel on time-reversed copies, then the
product); whole FEEL train steps of the llama, mamba, qwen2-vl
and musicgen smoke decoders in fp32 against the same steps on the CPU
by the replay rule (``repro_torch/launch/replay.py``); the vlm and
audio smoke decoders' prefill and decode in fp32 against the CPU at the
replays' rtol 1e-4; serves on a one-rank ``DeviceMesh`` bit-identical to
the plain serves.
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention, gradnorm, lru_scan, nvcc, ops  # noqa: E402

SHAPES = [(10, 50), (300, 700), (8, 4096), (1000, 130)]
MAIN_PATH = [(2000, 84), (2000, 10)]  # K*D̂ rows of h and of p - y


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _normal(seed, shape, device):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n,f", SHAPES + MAIN_PATH)
def test_cuda_kernel_matches_plain(cuda, n, f):
    x = _normal(n * f, (n, f), cuda)
    d = _normal(n + 1, (n, 10), cuda)
    gradnorm.reset_launch_counts()
    got = gradnorm.rownorm2(x)
    sig = gradnorm.gradnorm_sigma(x, d)
    torch.cuda.synchronize()
    assert gradnorm.LAUNCHES == {"rownorm2": 1, "gradnorm_sigma": 1}
    torch.testing.assert_close(got, gradnorm.rownorm2_plain(x),
                               rtol=1e-5, atol=0)
    torch.testing.assert_close(sig, gradnorm.gradnorm_sigma_plain(x, d),
                               rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernel_does_not_take(cuda):
    x = _normal(0, (64, 32), cuda)
    d = _normal(1, (64, 10), cuda)
    gradnorm.reset_launch_counts()
    with pytest.raises(TypeError):
        gradnorm.rownorm2(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        gradnorm.rownorm2(x.t())
    with pytest.raises(ValueError, match="2-D"):
        gradnorm.rownorm2(x[0])
    with pytest.raises(ValueError, match="row count"):
        gradnorm.gradnorm_sigma(x, d[:10])
    with pytest.raises(ValueError, match="CUDA"):
        gradnorm.gradnorm_sigma(x, d.cpu())
    assert gradnorm.LAUNCHES == {"rownorm2": 0, "gradnorm_sigma": 0}
    empty = gradnorm.rownorm2(torch.empty((0, 8), device=cuda))
    assert empty.shape == (0,) and gradnorm.LAUNCHES["rownorm2"] == 0


# ------------------------------------------------------- flash attention

FLASH_SHAPES = [(4, 128, 64), (2, 200, 32), (3, 513, 128), (1, 64, 256)]
FLASH_SLICE = (96, 2048, 128)  # llama3.2-3b prefill: B*H=4*24, S, Dh
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# d = 24 (16-byte rows, padded to a 64-column TMA box), d = 20 (rows
# TMA cannot read: copied with d zero-padded to 24), S = 1, one key past
# a 128-row tile at d = 256
FLASH_EDGES = [(2, 96, 64), (1, 130, 24), (2, 77, 20), (3, 1, 64),
               (1, 129, 256)]


def _qkv(seed, shape, dtype, device):
    return [_normal(seed + i, shape, device).to(dtype) for i in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s,d", FLASH_SHAPES + FLASH_EDGES)
def test_cuda_flash_matches_plain(cuda, bh, s, d, dtype, causal):
    q, k, v = _qkv(s + d, (bh, s, d), dtype, cuda)
    flash_attention.reset_launch_counts()
    got = flash_attention.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == {"flash_attention": 1}
    assert got.dtype == dtype and got.shape == q.shape
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(
        got.float(),
        flash_attention.flash_attention_plain(q, k, v, causal=causal).float(),
        atol=tol, rtol=tol)


@pytest.mark.cuda
def test_cuda_flash_matches_plain_at_the_serving_shape(cuda):
    q, k, v = _qkv(0, FLASH_SLICE, torch.bfloat16, cuda)
    got = flash_attention.flash_attention(q, k, v, causal=True)
    want = flash_attention.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def _offset(x, offset):
    """The values of ``x`` as a view starting ``offset`` elements past a
    fresh (aligned) allocation."""
    flat = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    flat[offset:] = x.flatten()
    return flat[offset:].view(x.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_flash_gqa_at_the_serving_shape(cuda, offset):
    """llama3.2-3b's prefill: q (4, 2048, 24, 128) and k, v (4, 2048, 8,
    128), each kv head serving 3 query heads; read in place, and as
    views one element past alignment, which TMA cannot read and the
    wrapper copies into aligned buffers (the same kernel on the same
    values: the same output, bit for bit)."""
    q = _normal(0, (4, 2048, 24, 128), cuda).bfloat16()
    k, v = (_normal(i, (4, 2048, 8, 128), cuda).bfloat16() for i in (1, 2))
    qo, ko, vo = (_offset(x, offset) for x in (q, k, v))
    flash_attention.reset_launch_counts()
    got = ops.flash_attention_bhsd(qo, ko, vo)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == {"flash_attention": 1}
    assert got.is_contiguous() and got.shape == q.shape
    want = flash_attention.flash_attention_bhsd_plain(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(ops.flash_attention_bhsd(q, k, v), got,
                               atol=0, rtol=0)


@pytest.mark.cuda
def test_cuda_flash_gqa_at_the_gemma3_global_shape(cuda):
    """gemma3-12b's global layers at the serving request: q (4, 2048, 16,
    256) and k, v (4, 2048, 8, 256) read in place, d = 256 at a serving
    shape."""
    q = _normal(5, (4, 2048, 16, 256), cuda).bfloat16()
    k, v = (_normal(i, (4, 2048, 8, 256), cuda).bfloat16() for i in (6, 7))
    flash_attention.reset_launch_counts()
    got = ops.flash_attention_bhsd(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == {"flash_attention": 1}
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = flash_attention.flash_attention_bhsd_plain(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


# (B, S, H, Hk, d, dv): stablelm-12b's head width d = 160 with GQA, and
# multi-head latent attention's q, k at d = 192 with v at dv = 128 (v
# read in place by both kernels), each at its fp32 replay's shape (256
# tokens) and at a small one past a tile edge; dv < d with GQA and d %
# 8 != 0 besides
FLASH_WIDTHS = [(1, 256, 32, 8, 160, 160), (2, 129, 4, 2, 160, 160),
                (1, 256, 128, 128, 192, 128), (2, 130, 4, 4, 192, 128),
                (1, 77, 6, 2, 40, 24), (1, 65, 3, 3, 20, 12)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hk,d,dv", FLASH_WIDTHS)
def test_cuda_flash_head_widths_and_narrower_v(cuda, b, s, h, hk, d, dv,
                                               dtype):
    q = _normal(d, (b, s, h, d), cuda).to(dtype)
    k = _normal(d + 1, (b, s, hk, d), cuda).to(dtype)
    v = _normal(d + 2, (b, s, hk, dv), cuda).to(dtype)
    scale = 192 ** -0.5 if dv < d else None  # MLA scales by nope + rope
    flash_attention.reset_launch_counts()
    got = ops.flash_attention_bhsd(q, k, v, scale=scale)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == {"flash_attention": 1}
    assert got.dtype == dtype and got.shape == (b, s, h, dv)
    assert got.is_contiguous()
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(
        got.float(),
        flash_attention.flash_attention_bhsd_plain(q, k, v,
                                                   scale=scale).float(),
        atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [((4, 2048, 32, 160), (4, 2048, 8, 160),
                                    (4, 2048, 8, 160)),
                                   ((4, 2048, 128, 192), (4, 2048, 128, 192),
                                    (4, 2048, 128, 128))])
def test_cuda_flash_at_the_stablelm_and_mla_serving_shapes(cuda, shape):
    """bf16 at the serving requests' prefill shapes: stablelm-12b's GQA
    at d = 160, and deepseek's latent attention (128 heads, q and k at d
    = 192, v at 128)."""
    q, k, v = (_normal(i, s, cuda).bfloat16() for i, s in enumerate(shape))
    flash_attention.reset_launch_counts()
    got = ops.flash_attention_bhsd(q, k, v, scale=shape[0][3] ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == {"flash_attention": 1}
    assert got.shape == shape[0][:3] + shape[2][3:]
    want = flash_attention.flash_attention_bhsd_plain(
        q, k, v, scale=shape[0][3] ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [((4, 2048, 12, 128), (4, 2048, 2, 128)),
                                   ((4, 2048, 24, 64), (4, 2048, 24, 64))])
def test_cuda_flash_at_the_qwen2vl_and_musicgen_serving_shapes(cuda, shape):
    """bf16 at the vlm and audio requests' prefill shapes: qwen2-vl-2b's
    12:2 GQA (a group of 6) at d = 128, and musicgen-medium's 24:24 MHA
    at d = 64, the kernel's d <= 64 instance."""
    q = _normal(0, shape[0], cuda).bfloat16()
    k, v = (_normal(i, shape[1], cuda).bfloat16() for i in (1, 2))
    flash_attention.reset_launch_counts()
    got = ops.flash_attention_bhsd(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == {"flash_attention": 1}
    want = flash_attention.flash_attention_bhsd_plain(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


# softcap and query offset: (Sq, Sk, q_offset, softcap); S not a multiple
# of 64 and Sk - q_offset unequal to Sq (short of it, equal, past it)
FLASH_CAPPED = [(77, 77, 0, 30.0), (70, 201, 100, 0.0), (70, 201, 131, 5.0),
                (130, 90, 20, 5.0), (1, 65, 64, 50.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 160, 256])
@pytest.mark.parametrize("sq,sk,q_offset,softcap", FLASH_CAPPED)
def test_cuda_flash_softcap_and_offset_match_plain(cuda, sq, sk, q_offset,
                                                   softcap, d, dtype):
    """Both kernels' softcapped and offset instances against the plain
    version, GQA 4:2; logits at scale ~3, so that a cap of 5 bites."""
    q = (3 * _normal(sq + d, (2, sq, 4, d), cuda)).to(dtype)
    k = _normal(sk + d, (2, sk, 2, d), cuda).to(dtype)
    v = _normal(sk + d + 1, (2, sk, 2, d), cuda).to(dtype)
    flash_attention.reset_launch_counts()
    got = ops.flash_attention_bhsd(q, k, v, softcap=softcap,
                                   q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == {"flash_attention": 1}
    assert got.shape == q.shape and got.dtype == dtype
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(
        got.float(),
        flash_attention.flash_attention_bhsd_plain(
            q, k, v, softcap=softcap, q_offset=q_offset).float(),
        atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_softcap_and_offset_are_deterministic(cuda, dtype):
    """Repeated calls of the softcapped and offset instances give the same
    bits; the last 1024 queries of llama's prefill at offset 1024 are
    the one-shot prefill's rows 1024.. bit for bit (the same q tiles
    meet the same key tiles in the same order)."""
    q = _normal(20, (2, 300, 4, 128), cuda).to(dtype)
    k, v = (_normal(i, (2, 420, 2, 128), cuda).to(dtype) for i in (21, 22))
    runs = [ops.flash_attention_bhsd(q, k, v, softcap=20.0, q_offset=120)
            for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    if dtype == torch.bfloat16:
        q = _normal(0, (4, 2048, 24, 128), cuda).bfloat16()
        k, v = (_normal(i, (4, 2048, 8, 128), cuda).bfloat16()
                for i in (1, 2))
        for cap in (0.0, 50.0):
            whole = ops.flash_attention_bhsd(q, k, v, softcap=cap)
            tail = ops.flash_attention_bhsd(q[:, 1024:], k, v, softcap=cap,
                                            q_offset=1024)
            assert torch.equal(tail, whole[:, 1024:])


# the fp32 kernel's instances: every head-width bucket that the zoo's
# shapes do not already reach (d = 20 zero-filled into the 32 bucket, 96,
# stablelm's 160, 192, 224, 256), at S = 1, one past a 64-key tile and
# past the 16-, 32- and 64-row q tiles, GQA 4:2
F32_WIDTHS = [20, 96, 160, 192, 224, 256]


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 65, 150])
@pytest.mark.parametrize("d", F32_WIDTHS)
def test_cuda_flash_f32_head_width_instances(cuda, d, s):
    q = _normal(d + s, (2, s, 4, d), cuda)
    k, v = (_normal(d + s + i, (2, s, 2, d), cuda) for i in (1, 2))
    flash_attention.reset_launch_counts()
    got = ops.flash_attention_bhsd(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == {"flash_attention": 1}
    torch.testing.assert_close(
        got, flash_attention.flash_attention_bhsd_plain(q, k, v),
        atol=2e-5, rtol=2e-5)


def _spy_value_pointers(monkeypatch):
    """The v pointers the C entry points receive, one per launch."""
    seen = []
    entry = flash_attention._fn

    def spied(dtype):
        fn = entry(dtype)

        def call(*args):
            seen.append(args[2])
            return fn(*args)
        return call

    monkeypatch.setattr(flash_attention, "_fn", spied)
    return seen


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hk,d,dv", [(2, 130, 4, 4, 192, 128),
                                           (1, 77, 6, 2, 40, 24)])
def test_cuda_flash_f32_reads_a_narrower_v_in_place(cuda, monkeypatch, b, s,
                                                    h, hk, d, dv):
    """The fp32 kernel takes v at its own width dv < d (latent
    attention's 128 at 192, and 24 at 40), as a strided view of a wider
    tensor: no copy (the kernel gets v's own pointer)."""
    seen = _spy_value_pointers(monkeypatch)
    q = _normal(d, (b, s, h, d), cuda)
    k = _normal(d + 1, (b, s, hk, d), cuda)
    v = _normal(d + 2, (b, s, hk, dv + 8), cuda)[..., 4:dv + 4]
    flash_attention.reset_launch_counts()
    got = ops.flash_attention_bhsd(q, k, v, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == {"flash_attention": 1}
    assert seen == [v.data_ptr()]
    assert got.shape == (b, s, h, dv) and got.is_contiguous()
    torch.testing.assert_close(
        got, flash_attention.flash_attention_bhsd_plain(q, k, v,
                                                        scale=d ** -0.5),
        atol=2e-5, rtol=2e-5)


# (B, H, Hk): few heads take the kernel's 16-64-row q tiles, many the
# 128-row one (a grid of at least one block per SM either way)
F32_HEADS = [(1, 4, 2), (2, 96, 48)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hk", F32_HEADS)
@pytest.mark.parametrize("d,dv", [(128, 128), (192, 128)])
@pytest.mark.parametrize("sq,sk,q_offset,softcap", [(100, 300, 200, 50.0),
                                                    (100, 300, 150, 0.0),
                                                    (64, 200, 10, 50.0)])
def test_cuda_flash_f32_offset_and_softcap_at_4x(cuda, sq, sk, q_offset,
                                                 softcap, d, dv, b, h, hk):
    """Keys longer than the queries at a query offset, and the softcap
    with q at 4x scale (where the cap bites), with GQA."""
    q = 4.0 * _normal(sq + d, (b, sq, h, d), cuda)
    k = _normal(sk + d, (b, sk, hk, d), cuda)
    v = _normal(sk + dv, (b, sk, hk, dv), cuda)
    got = ops.flash_attention_bhsd(q, k, v, softcap=softcap,
                                   q_offset=q_offset)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, flash_attention.flash_attention_bhsd_plain(
            q, k, v, softcap=softcap, q_offset=q_offset),
        atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hk", F32_HEADS)
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_f32_unaligned_views_take_the_4_byte_copies(cuda, causal,
                                                              b, h, hk):
    """Views one element past an aligned base, which the kernel copies 4
    bytes at a time, give the output of the aligned tensors (16-byte
    copies) bit for bit, causal or not."""
    q = _normal(30, (b, 200, h, 128), cuda)
    k, v = (_normal(i, (b, 200, hk, 128), cuda) for i in (31, 32))
    got = ops.flash_attention_bhsd(*(_offset(x, 1) for x in (q, k, v)),
                                   causal=causal)
    aligned = ops.flash_attention_bhsd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, flash_attention.flash_attention_bhsd_plain(q, k, v,
                                                        causal=causal),
        atol=2e-5, rtol=2e-5)
    assert torch.equal(got, aligned)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hk,d,dv", [(8, 300, 32, 8, 128, 128),
                                           (1, 256, 128, 128, 192, 128),
                                           (4, 200, 64, 16, 64, 64),
                                           (2, 150, 96, 32, 20, 20)])
def test_cuda_flash_f32_many_waves_and_two_calls_bit_identical(cuda, b, s, h,
                                                               hk, d, dv):
    """B H large enough for several waves of 128-row blocks (8 x 32 heads
    x 3 q tiles), deepseek's replay shape, and the 128-row tile at d =
    64 and 20: each held against the plain version, and two calls give
    the same bits."""
    q = _normal(40, (b, s, h, d), cuda)
    k = _normal(41, (b, s, hk, d), cuda)
    v = _normal(42, (b, s, hk, dv), cuda)
    first, second = (ops.flash_attention_bhsd(q, k, v) for _ in range(2))
    torch.cuda.synchronize()
    torch.testing.assert_close(
        first, flash_attention.flash_attention_bhsd_plain(q, k, v),
        atol=2e-5, rtol=2e-5)
    assert torch.equal(first, second)


#: sha256 of the bf16 kernel's output at llama's prefill shape on the
#: inputs below, taken from the kernel before it had a softcap or an
#: offset (NVIDIA H100 80GB HBM3, CUDA 12.8)
PARENT_LLAMA_SHA256 = ("b0721e0928cbe6564499531b7684a7152ef4cbfff2936b45cc1ff6dde"
                       "d807063")


@pytest.mark.cuda
def test_cuda_unsoftcapped_flash_is_bit_identical_to_the_parent(cuda):
    """The instance without softcap computes what the kernel computed
    before softcap and offsets existed, bit for bit, at llama's shape."""
    import hashlib
    q = _normal(0, (4, 2048, 24, 128), cuda).bfloat16()
    k, v = (_normal(i, (4, 2048, 8, 128), cuda).bfloat16() for i in (1, 2))
    out = ops.flash_attention_bhsd(q, k, v)
    digest = hashlib.sha256(
        out.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
    assert digest == PARENT_LLAMA_SHA256


#: sha256 of the bf16 kernel's output at gemma3's global shape (d = 256)
#: and musicgen's (d = 64) on the inputs of ``_parent_case``, taken from
#: the kernel before it had a value width of its own (NVIDIA H100 80GB
#: HBM3, CUDA 12.8)
PARENT_SHA256 = {
    "gemma3": ("5eb6196345b83c8d355cf70df347cfcbe9d6db5f64b394c69f9260e12"
               "366e788"),
    "musicgen": ("e9dda5cb2021a88f3cf78434763deead931f8028fe1916933ddce610"
                 "62369773"),
}


def _parent_case(name, device):
    """q, k, v of the parent hashes: gemma3-12b's global layers (as in
    ``test_cuda_flash_gqa_at_the_gemma3_global_shape``) and
    musicgen-medium's MHA at d = 64."""
    if name == "gemma3":
        q = _normal(5, (4, 2048, 16, 256), device).bfloat16()
        kv = [_normal(i, (4, 2048, 8, 256), device).bfloat16() for i in (6, 7)]
    else:
        q = _normal(0, (4, 2048, 24, 64), device).bfloat16()
        kv = [_normal(i, (4, 2048, 24, 64), device).bfloat16() for i in (1, 2)]
    return q, *kv


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PARENT_SHA256))
def test_cuda_old_bf16_instances_are_bit_identical_to_the_parent(cuda, name):
    """The d <= 64 and d = 256 instances (dv = d) compute what they
    computed before the kernel had a value width of its own, bit for
    bit (the d <= 128 one: ``PARENT_LLAMA_SHA256`` above)."""
    import hashlib
    out = ops.flash_attention_bhsd(*_parent_case(name, cuda))
    digest = hashlib.sha256(
        out.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
    assert digest == PARENT_SHA256[name]


# (d, dv) pairs of every bf16 instance <DC, DVC, BK>: the new 192-column
# ones at stablelm's 160, latent attention's 192 / 128 and 192; a v
# narrower than its instance's V tile at d = 40 and 256
BF16_PAIRS = [(64, 64), (128, 128), (160, 160), (192, 128), (192, 192),
              (176, 64), (256, 256), (256, 128), (40, 24)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,dv", BF16_PAIRS)
def test_cuda_flash_bf16_launches_the_instance_of_bf16_instance(cuda, d, dv):
    """The profiled launch is ``flash_wgmma_kernel<DC, DVC, BK, ...>`` of
    ``bf16_instance(d, dv)``, v read in place at its own width, and the
    output matches the plain version (GQA 4:2, 200 tokens)."""
    import re
    from torch.profiler import ProfilerActivity, profile
    q = _normal(d, (2, 200, 4, d), cuda).bfloat16()
    k = _normal(d + 1, (2, 200, 2, d), cuda).bfloat16()
    v = _normal(d + 2, (2, 200, 2, dv), cuda).bfloat16()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = ops.flash_attention_bhsd(q, k, v)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if "flash_wgmma_kernel" in e.name]
    assert len(names) == 1, names
    # demangled or mangled template arguments <DC, DVC, BK, ...>
    args = re.search(r"flash_wgmma_kernel(?:<(\d+), (\d+), (\d+),|"
                     r"ILi(\d+)ELi(\d+)ELi(\d+)E)", names[0])
    assert tuple(int(x) for x in args.groups() if x) == \
        flash_attention.bf16_instance(d, dv)
    assert got.shape == (2, 200, 4, dv)
    torch.testing.assert_close(
        got.float(), flash_attention.flash_attention_bhsd_plain(
            q, k, v).float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("d,dv", [(160, 160), (192, 128), (192, 192)])
@pytest.mark.parametrize("sq,sk,q_offset,softcap", FLASH_CAPPED)
def test_cuda_flash_bf16_dc3_softcap_and_offset_match_plain(
        cuda, sq, sk, q_offset, softcap, d, dv):
    """The 192-column instances' softcapped and offset forms against the
    plain version, GQA 4:2, logits at scale ~3 so that a cap of 5
    bites."""
    q = (3 * _normal(sq + d, (2, sq, 4, d), cuda)).bfloat16()
    k = _normal(sk + d, (2, sk, 2, d), cuda).bfloat16()
    v = _normal(sk + d + 1, (2, sk, 2, dv), cuda).bfloat16()
    flash_attention.reset_launch_counts()
    got = ops.flash_attention_bhsd(q, k, v, softcap=softcap,
                                   q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == {"flash_attention": 1}
    assert got.shape == (2, sq, 4, dv)
    torch.testing.assert_close(
        got.float(), flash_attention.flash_attention_bhsd_plain(
            q, k, v, softcap=softcap, q_offset=q_offset).float(),
        atol=2e-2, rtol=2e-2)


# stablelm-12b's and latent attention's prefill shapes: (q, k, v)
DC3_SERVING = [((4, 2048, 32, 160), (4, 2048, 8, 160), (4, 2048, 8, 160)),
               ((4, 2048, 128, 192), (4, 2048, 128, 192),
                (4, 2048, 128, 128))]


@pytest.mark.cuda
@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("shape", DC3_SERVING)
def test_cuda_flash_bf16_dc3_two_calls_bit_identical(cuda, shape, softcap):
    """Two calls of a 192-column instance give the same bits at the
    serving shapes, capped or not; the last 1024 queries at offset 1024
    are rows 1024.. of the one-shot output bit for bit."""
    q, k, v = (_normal(10 + i, x, cuda).bfloat16()
               for i, x in enumerate(shape))
    first, second = (ops.flash_attention_bhsd(q, k, v, softcap=softcap)
                     for _ in range(2))
    tail = ops.flash_attention_bhsd(q[:, 1024:], k, v, softcap=softcap,
                                    q_offset=1024)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(tail, first[:, 1024:])


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hk,d,dv", [(1, 256, 128, 128, 192, 128),
                                           (2, 130, 4, 4, 192, 128),
                                           (1, 77, 6, 2, 40, 24)])
def test_cuda_flash_bf16_reads_a_narrower_v_in_place(cuda, monkeypatch, b, s,
                                                     h, hk, d, dv):
    """The bf16 kernel takes v at its own width dv < d (latent
    attention's 128 at 192, and 24 at 40) as a strided view of a wider
    tensor, 16-byte aligned: the kernel gets v's own pointer (no
    zero-padded copy), and the output is (B, S, H, dv)."""
    seen = _spy_value_pointers(monkeypatch)
    q = _normal(d, (b, s, h, d), cuda).bfloat16()
    k = _normal(d + 1, (b, s, hk, d), cuda).bfloat16()
    v = _normal(d + 2, (b, s, hk, dv + 16), cuda).bfloat16()[..., 8:dv + 8]
    flash_attention.reset_launch_counts()
    got = ops.flash_attention_bhsd(q, k, v, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == {"flash_attention": 1}
    assert seen == [v.data_ptr()]
    assert got.shape == (b, s, h, dv) and got.is_contiguous()
    torch.testing.assert_close(
        got.float(), flash_attention.flash_attention_bhsd_plain(
            q, k, v, scale=d ** -0.5).float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("d,dv,instance", [(64, 72, (2, 2, 128)),
                                           (64, 60, (1, 1, 128)),
                                           (160, 160, (2, 2, 128)),
                                           (192, 192, (3, 2, 128)),
                                           (64, 64, (1, 1, 64))])
def test_cuda_bf16_entry_refuses_a_bad_v_or_instance(cuda, d, dv, instance):
    """The bf16 C entry refuses, without a launch, dv > d, a dv that is
    not a multiple of 8, an instance too narrow for d or dv, and one
    that is not built."""
    fn = flash_attention._fn(torch.bfloat16)
    q = _normal(0, (1, 64, 2, d), cuda).bfloat16()
    v = _normal(1, (1, 64, 2, dv + 8), cuda).bfloat16()[..., :dv]
    o = torch.empty((1, 64, 2, dv), dtype=torch.bfloat16, device=cuda)
    sizes, strides = flash_attention.kernel_args(q, q, v, o)
    flash_attention.reset_launch_counts()
    err = fn(q.data_ptr(), q.data_ptr(), v.data_ptr(), o.data_ptr(), *sizes,
             dv, *instance, (ctypes.c_longlong * 12)(*strides), 1, 1.0, 0.0,
             0, torch.cuda.current_stream().cuda_stream)
    assert err != 0


# command-r-35b's 64:8 GQA at d = 128 and musicgen-medium's 24:24 MHA at
# d = 64, the prefill shapes that trailed SDPA the most before the bf16
# kernel had a producer warpgroup: (q, k and v)
PRODUCER_SERVING = [((4, 2048, 64, 128), (4, 2048, 8, 128)),
                    ((4, 2048, 24, 64), (4, 2048, 24, 64))]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PRODUCER_SERVING)
def test_cuda_flash_bf16_command_r_and_musicgen_two_calls_bit_identical(
        cuda, shape):
    """At command-r's and musicgen's serving shapes the bf16 kernel
    matches the plain version, and two calls give the same bits (the
    consumers' turns change when they issue, not what a row
    computes)."""
    q = _normal(20, shape[0], cuda).bfloat16()
    k, v = (_normal(21 + i, shape[1], cuda).bfloat16() for i in range(2))
    flash_attention.reset_launch_counts()
    first, second = (ops.flash_attention_bhsd(q, k, v) for _ in range(2))
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == {"flash_attention": 2}
    assert torch.equal(first, second)
    tol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(
        first.float(),
        flash_attention.flash_attention_bhsd_plain(q, k, v).float(),
        atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 160, 256])
@pytest.mark.parametrize("s", [130, 200])
def test_cuda_flash_bf16_partial_last_stage_under_gqa_8(cuda, s, d):
    """Causal, 16:2 GQA (a group of 8), S not a multiple of 128: the
    producer's last K/V stage is partly past the keys (TMA zero-fills
    it), and at S = 130 warpgroup 1 of the last q tile has no row to
    store but still takes its turns and releases every stage."""
    q = _normal(s + d, (2, s, 16, d), cuda).bfloat16()
    k, v = (_normal(s + d + i, (2, s, 2, d), cuda).bfloat16()
            for i in (1, 2))
    flash_attention.reset_launch_counts()
    got = ops.flash_attention_bhsd(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == {"flash_attention": 1}
    assert got.shape == q.shape
    tol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(
        got.float(),
        flash_attention.flash_attention_bhsd_plain(q, k, v).float(),
        atol=tol, rtol=tol)


@pytest.mark.cuda
def test_cuda_bf16_build_has_no_spill_or_serialised_wgmma(cuda):
    """ptxas's report of the bf16 build (``nvcc.BuildInfo.log``, kept
    beside the library): every ``flash_wgmma_kernel`` instance (5
    instances, each plain, with an offset and softcapped) without a
    spilled byte, and no warning that it serialised the wgmmas or
    ignored ``setmaxnreg``."""
    log = flash_attention.build_sm90().log
    entries = [e for e in nvcc.ptxas_report(log)
               if "flash_wgmma_kernel" in e.name]
    assert len(entries) == 15, entries
    for e in entries:
        assert e.spill_stores == 0 and e.spill_loads == 0, e
    warned = [w for w in nvcc.ptxas_warnings(log)
              if "wgmma" in w or "setmaxnreg" in w]
    assert not warned, warned


@pytest.mark.cuda
def test_cuda_scan_build_has_no_spill(cuda):
    """ptxas's report of the scan build: the forward and backward
    kernels, fp32 and bf16 each, without a spilled byte (the backward's
    5P live values fill the 128 registers that 512 threads leave)."""
    entries = nvcc.ptxas_report(lru_scan.build().log)
    assert sorted("backward" in e.name for e in entries) == [False, False,
                                                             True, True]
    for e in entries:
        assert e.spill_stores == 0 and e.spill_loads == 0, e


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "musicgen-medium"])
def test_cuda_modality_smoke_decoders_match_the_cpu(cuda, arch):
    """The vlm (M-RoPE positions whose three rows differ) and audio (a
    grid of codebook tokens) smoke decoders in fp32 with TF32 off on the
    card, prefill through the fp32 flash kernel, against the same
    weights on the CPU: prefill logits and 4 decode steps at rtol 1e-4
    with an atol of 1e-4 of the largest (the replays' tolerance,
    chip_smoke.py), and the greedy tokens equal."""
    from repro_torch.configs import smoke_config
    from repro_torch.device import full_fp32
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import model as tm
    cfg = smoke_config(arch).scaled(dtype="float32")
    model = tm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    S = 40
    if arch == "qwen2-vl-2b":  # 4 text tokens, a (2, 3, 4) grid, text
        grid = torch.stack(torch.meshgrid(
            torch.arange(2), torch.arange(3), torch.arange(4),
            indexing="ij")).reshape(3, -1)
        pos = torch.cat([torch.arange(4).expand(3, -1), 4 + grid,
                         (8 + torch.arange(S - 28)).expand(3, -1)], dim=1)
        prompt = {"embeds": torch.randn(2, S, cfg.d_model, generator=gen),
                  "positions": pos[None].expand(2, 3, S)}
        nxt = 8 + S - 28
    else:
        prompt = {"tokens": torch.randint(0, cfg.vocab,
                                          (2, cfg.n_codebooks, S),
                                          generator=gen)}
        nxt = S
    out = {}
    for dev in ("cpu", cuda):
        model.to(dev)
        flash_attention.reset_launch_counts()
        with full_fp32():
            cache = tm.make_cache(cfg, 2, S + 4, device=dev)
            logits, cache = tm.make_prefill_step(cfg)(
                model, {k: v.to(dev) for k, v in prompt.items()}, cache)
            steps, toks = [logits.cpu()], []
            decode = tm.make_decode_step(cfg)
            for i in range(4):
                tok = torch.argmax(logits[:, -1], -1)
                toks.append(tok.cpu())
                logits, cache = decode(model, cache, serve_mod.decode_batch(
                    cfg, tok, S + i, nxt + i))
                steps.append(logits.cpu())
        out[str(dev)] = (steps, toks, dict(flash_attention.LAUNCHES))
    assert out["cpu"][2] == {"flash_attention": 0}
    assert out["cuda"][2] == {"flash_attention": cfg.n_layers}
    for got, want in zip(out["cuda"][0], out["cpu"][0]):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))
    for got, want in zip(out["cuda"][1], out["cpu"][1]):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_flash_refuses_a_wider_v(cuda):
    q = _normal(0, (1, 64, 2, 32), cuda)
    flash_attention.reset_launch_counts()
    with pytest.raises(ValueError, match="dv <= d"):
        ops.flash_attention_bhsd(q, q, _normal(1, (1, 64, 2, 40), cuda))
    assert flash_attention.LAUNCHES == {"flash_attention": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hk,d", [(1, 6, 2, 64), (2, 4, 1, 128),
                                      (1, 3, 3, 20)])
def test_cuda_flash_strided_gqa_views(cuda, dtype, b, h, hk, d):
    """q, k and v as strided views of one (B, S, H + 2 Hk, d) tensor (the
    shape of a fused projection), at batch 1 too, in both dtypes: the
    fp32 CUDA-core kernel and the bf16 tensor-core kernels take the
    same strided interface."""
    base = _normal(b * h + d, (b, 200, h + 2 * hk, d), cuda).to(dtype)
    q, k, v = base[:, :, :h], base[:, :, h:h + hk], base[:, :, h + hk:]
    got = ops.flash_attention_bhsd(q, k, v)
    torch.cuda.synchronize()
    assert got.is_contiguous() and got.shape == (b, 200, h, d)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(
        got.float(),
        flash_attention.flash_attention_bhsd_plain(q, k, v).float(),
        atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2])
def test_cuda_flash_bhsd_and_scale(cuda, b):
    q, k, v = _qkv(1, (b, 130, 3, 32), torch.float32, cuda)
    got = ops.flash_attention_bhsd(q, k, v)
    fold = lambda x: x.movedim(2, 1).reshape(b * 3, 130, 32)  # noqa: E731
    want = flash_attention.flash_attention_plain(fold(q), fold(k), fold(v))
    torch.testing.assert_close(got, want.reshape(b, 3, 130, 32).movedim(1, 2),
                               atol=2e-5, rtol=2e-5)
    q, k, v = (x[:, :, 0].contiguous() for x in (q, k, v))
    torch.testing.assert_close(
        flash_attention.flash_attention(q, k, v, scale=0.3),
        flash_attention.flash_attention_plain(q, k, v, scale=0.3),
        atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
def test_cuda_flash_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv(2, (2, 64, 32), torch.float32, cuda)
    flash_attention.reset_launch_counts()
    with pytest.raises(TypeError):
        flash_attention.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        flash_attention.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="d <= 256"):
        big = _normal(3, (1, 8, 288), cuda)
        flash_attention.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention.flash_attention(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="3-D"):
        flash_attention.flash_attention(q[0], k[0], v[0])
    with pytest.raises(ValueError, match="shape"):
        flash_attention.flash_attention(q, k[:, :32].contiguous(), v)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention(q, k.cpu(), v)
    q4 = q.view(2, 64, 1, 32).expand(2, 64, 3, 32)
    k4 = k.view(2, 64, 1, 32).expand(2, 64, 2, 32)
    with pytest.raises(ValueError, match="Hk dividing H"):
        ops.flash_attention_bhsd(q4, k4, k4)
    with pytest.raises(ValueError, match="4-D"):
        ops.flash_attention_bhsd(q, k, v)
    assert flash_attention.LAUNCHES == {"flash_attention": 0}
    # the bf16 C entry refuses, without a launch, a layout TMA cannot read
    # (the wrapper pads such operands first): d % 8 != 0, an unaligned base
    fn = flash_attention._fn(torch.bfloat16)
    for d, off in ((20, 0), (32, 1)):
        x = _offset(_normal(4, (1, 64, 1, d), cuda).bfloat16(), off)
        o = torch.empty_like(x)
        sizes, strides = flash_attention.kernel_args(x, x, x, o)
        err = fn(x.data_ptr(), x.data_ptr(), x.data_ptr(), o.data_ptr(),
                 *sizes, d, *flash_attention.bf16_instance(d, d),
                 (ctypes.c_longlong * 12)(*strides), 1, 1.0, 0.0, 0,
                 torch.cuda.current_stream().cuda_stream)
        assert err != 0
    empty = torch.empty((0, 8, 32), device=cuda)
    out = flash_attention.flash_attention(empty, empty, empty)
    assert out.shape == (0, 8, 32)
    assert flash_attention.LAUNCHES == {"flash_attention": 0}


# ------------------------------------------------------ linear-recurrence scan

SCAN_SHAPES = [(1, 17, 8), (2, 300, 130), (3, 256, 256), (2, 512, 64)]


def _ab(seed, shape, device, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.3, 0.999, shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    return (torch.from_numpy(a).to(device, dtype),
            torch.from_numpy(b).to(device, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,c", SCAN_SHAPES)
def test_cuda_lru_scan_matches_plain(cuda, b, s, c, dtype):
    a, bb = _ab(b * s + c, (b, s, c), cuda, dtype)
    lru_scan.reset_launch_counts()
    got = ops.lru_scan(a, bb)
    torch.cuda.synchronize()
    assert lru_scan.LAUNCHES == {"lru_scan": 1, "lru_scan_backward": 0}
    assert got.dtype == torch.float32 and got.shape == (b, s, c)
    torch.testing.assert_close(got, lru_scan.lru_scan_plain(a, bb),
                               atol=1e-5, rtol=1e-5)
    zero = lru_scan.lru_scan(torch.zeros_like(a), bb)  # the identity on b
    torch.testing.assert_close(zero, bb.float(), atol=0, rtol=0)


@pytest.mark.cuda
def test_cuda_lru_scan_at_the_recurrentgemma_shape(cuda):
    """recurrentgemma-9b's prefill recurrence: (4, 2048, 4096) fp32, a
    width that fills 64 blocks of the grid."""
    a, bb = _ab(9, (4, 2048, 4096), cuda)
    lru_scan.reset_launch_counts()
    got = ops.lru_scan(a, bb)
    want = lru_scan.lru_scan_plain(a, bb)
    torch.cuda.synchronize()
    assert lru_scan.LAUNCHES == {"lru_scan": 1, "lru_scan_backward": 0}
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_cuda_rglru_mixer_prefill_matches_the_cpu(cuda):
    """The RG-LRU mixer's prefill on the card, through the scan kernel,
    against the same mixer on the CPU (plain scan), fp32 with TF32 off,
    at 1e-5; and its decode step."""
    from repro_torch.configs import smoke_config
    from repro_torch.device import full_fp32
    from repro_torch.models import rglru
    cfg = smoke_config("recurrentgemma-9b").scaled(dtype="float32")
    p = rglru.init_rglru(torch.Generator().manual_seed(0), cfg,
                         torch.float32)
    x = _normal(11, (2, 300, cfg.d_model), "cpu")
    w, k = cfg.lru_width_, cfg.ssm_conv
    out = {}
    for dev in ("cpu", cuda):
        p.to(dev)
        cache = {"conv": torch.zeros(2, k - 1, w, device=dev),
                 "h": torch.zeros(2, w, device=dev)}
        lru_scan.reset_launch_counts()
        with full_fp32():
            y = rglru.rglru_mixer(cfg, p, x.to(dev), "prefill", cache)
            y1 = rglru.rglru_mixer(cfg, p, x[:, :1].to(dev), "decode", cache)
        out[str(dev)] = (y.cpu(), y1.cpu(), cache["h"].cpu(),
                         dict(lru_scan.LAUNCHES))
    assert out["cpu"][3] == {"lru_scan": 0, "lru_scan_backward": 0}
    assert out["cuda"][3] == {"lru_scan": 1, "lru_scan_backward": 0}
    for got, want in zip(out["cuda"][:3], out["cpu"][:3]):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("absorbed", [False, True])
def test_cuda_deepseek_smoke_decoder_matches_the_cpu(cuda, absorbed):
    """deepseek-v2-236b's smoke decoder (latent attention, a dense head
    layer and an MoE layer) in fp32 with TF32 off on the card, its
    prefill through the fp32 flash kernel (v narrower than q, k), against
    the same weights on the CPU: prefill logits, the latent caches and 4
    decode steps at rtol 1e-4 (the replays' tolerance, chip_smoke.py),
    and the MoE routing equal."""
    from repro_torch.configs import smoke_config
    from repro_torch.device import full_fp32
    from repro_torch.models import model as tm
    from repro_torch.models.moe import MoE
    cfg = smoke_config("deepseek-v2-236b").scaled(dtype="float32")
    model = tm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cpu", cuda):
        model.to(dev)
        moe = [m for m in model.modules() if isinstance(m, MoE)]
        for m in moe:
            m.routing_log = []
        flash_attention.reset_launch_counts()
        with full_fp32():
            cache = tm.make_cache(cfg, 2, 44, device=dev)
            logits, cache = tm.make_prefill_step(cfg)(
                model, {"tokens": toks.to(dev)}, cache)
            steps = [logits.cpu()]
            decode = tm.make_decode_step(cfg, mla_absorbed=absorbed)
            for i in range(4):
                tok = torch.argmax(logits[:, -1], -1)
                logits, cache = decode(model, cache, {
                    "tokens": tok[:, None], "cache_index": 40 + i})
                steps.append(logits.cpu())
        out[str(dev)] = (steps, {n: c.cpu() for n, c in
                                 cache["body"]["pos0"].items()},
                         moe[0].routing_log[0]["top_idx"].cpu(),
                         dict(flash_attention.LAUNCHES))
    assert out["cpu"][3] == {"flash_attention": 0}
    assert out["cuda"][3] == {"flash_attention": cfg.n_layers}
    for got, want in zip(out["cuda"][0] + list(out["cuda"][1].values()),
                         out["cpu"][0] + list(out["cpu"][1].values())):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))
    assert torch.equal(out["cuda"][2], out["cpu"][2])


@pytest.mark.cuda
def test_cuda_lru_scan_past_2_31_bytes(cuda):
    """One fp32 operand of 2,147,500,032 bytes: offsets past 2^31 bytes
    (the Mamba serving shape is 4.3e9 bytes per operand)."""
    a, bb = _ab(7, (1, 4096, 131073), cuda)
    assert a.numel() * a.element_size() > 2 ** 31
    got = lru_scan.lru_scan(a, bb)
    want = lru_scan.lru_scan_plain(a, bb)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


_L = lru_scan.WARPS * lru_scan.STEPS  # the kernel's chunk of steps
# (shape, offset): S at the chunk's seams, C of 1 and 130, a view 4 bytes
# past a 16-byte boundary, a batch past 65535 (the old grid's y limit)
SCAN_SEAMS = [((2, s, 8), 0) for s in (1, _L - 1, _L, _L + 1)] + [
    ((3, _L + 1, 1), 0), ((2, 300, 130), 0), ((2, 300, 130), 4),
    ((70000, 3, 5), 0)]


def _ab_view(seed, shape, offset_bytes, device, dtype, gates=(0.3, 0.999)):
    """a in ``gates`` and b normal, as contiguous views ``offset_bytes``
    into their buffers."""
    off = offset_bytes // (4 if dtype == torch.float32 else 2)
    n = int(np.prod(shape)) + off
    rng = np.random.default_rng(seed)
    a = rng.uniform(*gates, n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    return tuple(torch.from_numpy(x).to(device, dtype)[off:].view(shape)
                 for x in (a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,offset", SCAN_SEAMS)
def test_cuda_lru_scan_at_the_seams(cuda, shape, offset, dtype):
    """Every layout the kernel takes, with no padded copy: S around the
    chunk, ragged C, an unaligned view and a batch past 65535."""
    a, bb = _ab_view(sum(shape) + offset, shape, offset, cuda, dtype)
    if offset:
        assert a.is_contiguous() and a.data_ptr() % 16 == offset
    lru_scan.reset_launch_counts()
    got = lru_scan.lru_scan(a, bb)
    torch.cuda.synchronize()
    assert lru_scan.LAUNCHES == {"lru_scan": 1, "lru_scan_backward": 0}
    torch.testing.assert_close(got, lru_scan.lru_scan_plain(a, bb),
                               atol=1e-5, rtol=1e-5)
    zero = lru_scan.lru_scan(torch.zeros_like(a), bb)
    torch.testing.assert_close(zero, bb.float(), atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 300, 130), (4, 2048, 4096),
                                   (1, 2048, 4096)])
def test_cuda_lru_scan_is_deterministic(cuda, shape):
    """The order of operations depends on the shape alone: two calls
    give the same bits."""
    a, bb = _ab(sum(shape), shape, cuda)
    first = lru_scan.lru_scan(a, bb)
    second = lru_scan.lru_scan(a, bb)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_lru_scan_with_gates_near_1(cuda, dtype):
    """a in (0.999, 1) over S = 2048, as mamba's exp(dt A) at small dt and
    the RG-LRU's a give: held at rtol 1e-5 with an atol of 1e-5 times
    the largest |h|, since two sequential fp32 loops (the reference's
    and the plain version) already differ above 1e-5 there
    (tests/test_torch_scan_split.py)."""
    a, bb = _ab_view(5, (2, 2048, 256), 0, cuda, dtype, (0.999, 1.0))
    got = lru_scan.lru_scan(a, bb)
    want = lru_scan.lru_scan_plain(a, bb)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.cuda
def test_cuda_lru_scan_rejects_what_the_kernel_does_not_take(cuda):
    a, bb = _ab(8, (2, 64, 32), cuda)
    lru_scan.reset_launch_counts()
    with pytest.raises(TypeError):
        lru_scan.lru_scan(a.int(), bb.int())
    with pytest.raises(TypeError):
        lru_scan.lru_scan(a, bb.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        lru_scan.lru_scan(a.transpose(1, 2), bb.transpose(1, 2))
    with pytest.raises(ValueError, match="3-D"):
        lru_scan.lru_scan(a[0], bb[0])
    with pytest.raises(ValueError, match="shape"):
        lru_scan.lru_scan(a, bb[:, :32].contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        lru_scan.lru_scan(a, bb.cpu())
    assert lru_scan.LAUNCHES == {"lru_scan": 0, "lru_scan_backward": 0}
    empty = torch.empty((2, 0, 32), device=cuda)
    assert lru_scan.lru_scan(empty, empty).shape == (2, 0, 32)
    assert lru_scan.LAUNCHES == {"lru_scan": 0, "lru_scan_backward": 0}


# ------------------------------------------------------------ training

@pytest.mark.cuda
@pytest.mark.parametrize("shape,gates", [((2, 1, 5), "uniform"),
                                         ((2, 37, 6), "uniform"),
                                         ((3, 300, 130), "uniform"),
                                         ((2, 2048, 256), "near1")])
def test_cuda_scan_gradient_matches_plain(cuda, shape, gates):
    """``ops.lru_scan`` on the card (the forward kernel and the backward
    kernel, one launch each) against autograd through the plain loop
    on the card; gates in (0.999, 1) held as the forward is."""
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    lo = 0.999 if gates == "near1" else 0.0
    a = (lo + (1 - lo) * torch.rand(shape, generator=gen, device=cuda))
    b = torch.randn(shape, generator=gen, device=cuda)
    w = torch.randn(shape, generator=gen, device=cuda)
    a1, b1 = a.clone().requires_grad_(), b.clone().requires_grad_()
    lru_scan.reset_launch_counts()
    h = ops.lru_scan(a1, b1)
    ga, gb = torch.autograd.grad((h * w).sum(), (a1, b1))
    torch.cuda.synchronize()
    assert lru_scan.LAUNCHES == {"lru_scan": 1, "lru_scan_backward": 1}
    a2, b2 = a.clone().requires_grad_(), b.clone().requires_grad_()
    want = torch.autograd.grad((lru_scan.lru_scan_plain(a2, b2) * w).sum(),
                               (a2, b2))
    for got, ref in ((ga, want[0]), (gb, want[1])):
        atol = 1e-5 * (float(ref.abs().max()) if gates == "near1" else 1.0)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=atol)


def _scan_backward_parent(a, h, gbar):
    """The route the backward kernel replaced: the forward kernel on
    time-reversed contiguous copies of gbar and of a shifted by one step,
    flipped back, then dL/da = g h_{t-1} (h_{-1} = 0)."""
    S = a.shape[1]
    a_rev = torch.zeros(a.shape, dtype=torch.float32, device=a.device)
    a_rev[:, 1:] = a[:, 1:].flip(1)
    g = lru_scan.lru_scan(a_rev, gbar.float().flip(1)).flip(1)
    grad_a = torch.zeros_like(g)
    grad_a[:, 1:] = g[:, 1:] * h[:, :S - 1]
    return grad_a, g


def _backward_inputs(seed, shape, offset_bytes, device, dtype,
                     gates=(0.3, 0.999)):
    """a (a view ``offset_bytes`` into its buffer), h = lru_scan(a, b) and
    gbar, an fp32 view as far off 16 bytes where that is whole elements."""
    a, b = _ab_view(seed, shape, offset_bytes, device, dtype, gates)
    h = lru_scan.lru_scan(a, b)
    off = offset_bytes // 4
    gbar = _normal(seed + 1, (int(np.prod(shape)) + off,), device)[off:]
    return a, h, gbar.view(shape)


# the seams, C of 1 and 130 and a batch past 65535 in both dtypes, and a
# views 4 (fp32 and bf16) and 2 (bf16) bytes past a 16-byte boundary
SCAN_BACKWARD_CASES = [(shape, off, dt) for shape, off in SCAN_SEAMS
                       for dt in (torch.float32, torch.bfloat16)] + [
    ((2, 300, 130), 2, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,offset,dtype", SCAN_BACKWARD_CASES)
def test_cuda_scan_backward_is_the_parent_route_bit_for_bit(cuda, shape,
                                                            offset, dtype):
    """The backward kernel's (dL/da, dL/db) equal the route it replaced
    bit for bit: the same fused multiply-adds at the same seams, bf16 a
    widened exactly; one launch; and within 1e-5 of the plain version."""
    a, h, gbar = _backward_inputs(sum(shape) + offset, shape, offset, cuda,
                                  dtype)
    if offset:
        assert a.is_contiguous() and a.data_ptr() % 16 == offset
    lru_scan.reset_launch_counts()
    got = lru_scan.lru_scan_backward_op(a, h, gbar)
    torch.cuda.synchronize()
    assert lru_scan.LAUNCHES == {"lru_scan": 0, "lru_scan_backward": 1}
    want = _scan_backward_parent(a, h, gbar)
    plain = lru_scan.lru_scan_backward_plain(a, h, gbar)
    for g, w, p in zip(got, want, plain):
        assert g.dtype == torch.float32 and g.shape == shape
        assert torch.equal(g, w)
        torch.testing.assert_close(g, p, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_scan_backward_with_gates_near_1(cuda, dtype):
    """a in (0.999, 1) over S = 2048: the parent route's bits, and the
    plain loop at rtol 1e-5 with an atol of 1e-5 times the largest |g|
    (the forward's argument, tests/test_torch_scan_split.py)."""
    a, h, gbar = _backward_inputs(6, (2, 2048, 256), 0, cuda, dtype,
                                  (0.999, 1.0))
    got = lru_scan.lru_scan_backward_op(a, h, gbar)
    want = _scan_backward_parent(a, h, gbar)
    plain = lru_scan.lru_scan_backward_plain(a, h, gbar)
    torch.cuda.synchronize()
    for g, w, p in zip(got, want, plain):
        assert torch.equal(g, w)
        torch.testing.assert_close(g, p, rtol=1e-5,
                                   atol=1e-5 * float(p.abs().max()))


@pytest.mark.cuda
def test_cuda_scan_backward_past_2_31_bytes(cuda):
    """Operands of 2,147,500,032 bytes each: 64-bit offsets in the
    reversed walk, the parent route's bits."""
    a, h, gbar = _backward_inputs(8, (1, 4096, 131073), 0, cuda,
                                  torch.float32)
    assert gbar.numel() * gbar.element_size() > 2 ** 31
    got = lru_scan.lru_scan_backward_op(a, h, gbar)
    want = _scan_backward_parent(a, h, gbar)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 300, 130), (8, 512, 4096)])
def test_cuda_scan_backward_is_deterministic(cuda, shape):
    """Two calls give the same bits."""
    a, h, gbar = _backward_inputs(sum(shape), shape, 0, cuda, torch.float32)
    first = lru_scan.lru_scan_backward_op(a, h, gbar)
    second = lru_scan.lru_scan_backward_op(a, h, gbar)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("loss", ["sum", "permuted"])
def test_cuda_scan_gradient_with_a_strided_gbar(cuda, loss):
    """autograd hands the backward a gbar that is not contiguous (the
    gradient of h.sum() is expanded; of (h * w).sum() with a permuted w,
    strided like w): the wrapper makes it contiguous, one backward
    launch, the plain loop's gradients at 1e-5."""
    shape = (3, 300, 130)
    a, b = _ab(12, shape, cuda)
    w = _normal(13, shape[::-1], cuda).permute(2, 1, 0)
    assert not w.is_contiguous()

    def run(scan):
        a1, b1 = a.clone().requires_grad_(), b.clone().requires_grad_()
        h = scan(a1, b1)
        out = h.sum() if loss == "sum" else (h * w).sum()
        return torch.autograd.grad(out, (a1, b1))

    lru_scan.reset_launch_counts()
    got = run(ops.lru_scan)
    torch.cuda.synchronize()
    assert lru_scan.LAUNCHES == {"lru_scan": 1, "lru_scan_backward": 1}
    want = run(lru_scan.lru_scan_plain)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_cuda_scan_backward_rejects_what_the_kernel_does_not_take(cuda):
    a, h, gbar = _backward_inputs(9, (2, 64, 32), 0, cuda, torch.float32)
    lru_scan.reset_launch_counts()
    op = lru_scan.lru_scan_backward_op
    with pytest.raises(ValueError, match="CUDA"):
        op(a, h.cpu(), gbar)
    with pytest.raises(TypeError):
        op(a, h, gbar.int())
    with pytest.raises(TypeError):
        op(a, h, gbar.bfloat16())
    with pytest.raises(ValueError, match="shape"):
        op(a, h, gbar[:, :32].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        op(a, h, gbar.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="3-D"):
        op(a[0], h[0], gbar[0])
    assert lru_scan.LAUNCHES == {"lru_scan": 0, "lru_scan_backward": 0}
    empty = torch.empty((2, 0, 32), device=cuda)
    ga, gb = op(empty, empty, empty)
    assert ga.shape == gb.shape == (2, 0, 32)
    assert lru_scan.LAUNCHES == {"lru_scan": 0, "lru_scan_backward": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-3b", "falcon-mamba-7b",
                                  "qwen2-vl-2b", "musicgen-medium"])
def test_cuda_feel_train_steps_match_the_cpu(cuda, arch):
    """3 FEEL train steps of the smoke decoder in fp32 on the card, each
    replayed on the CPU from the card's params, AdamW state and batch
    (``replay.replay_step``): loss, per-example loss and sigma at rtol
    1e-4, the selection equal or, within 10x the sigma error of a tie,
    taken from the card, gradients and params by the replay rule.  Each
    card step launches the sigma kernel once, the scan twice a mamba
    layer (forward, its recompute under remat) and the scan's backward
    kernel once."""
    from repro_torch.configs import smoke_config
    from repro_torch.device import full_fp32
    from repro_torch.launch import replay, train
    from repro_torch.models import model as tm
    cfg = smoke_config(arch).scaled(dtype="float32")
    feel = tm.FeelIntegration(n_clients=4)
    with full_fp32():
        model, opt, state, _ = train.setup(cfg, 0, cuda, True, 4)
        for i in range(3):
            b = train.synth_batch(cfg, torch.Generator(cuda).manual_seed(i),
                                  8, 24, 4, True, device=cuda)
            gradnorm.reset_launch_counts()
            lru_scan.reset_launch_counts()
            state, rep = replay.replay_step(cfg, opt, feel, model, state, b,
                                            "adamw", 0.01)
            assert gradnorm.LAUNCHES["gradnorm_sigma"] == 1
            n_scan = cfg.n_layers if arch == "falcon-mamba-7b" else 0
            assert lru_scan.LAUNCHES == {"lru_scan": 2 * n_scan,
                                         "lru_scan_backward": n_scan}
            assert rep["selection_equal"] or rep["given"]


HOST_MESH_SERVES = [(arch, True) for arch in (
    "llama3.2-3b", "falcon-mamba-7b", "recurrentgemma-9b", "gemma3-12b",
    "stablelm-12b", "command-r-35b", "deepseek-v2-236b", "deepseek-v3-671b",
    "qwen2-vl-2b", "musicgen-medium")] + [("falcon-mamba-7b", False)]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,smoke", HOST_MESH_SERVES,
                         ids=[f"{a}-{'smoke' if s else 'full'}"
                              for a, s in HOST_MESH_SERVES])
def test_cuda_host_mesh_serve_equals_the_plain_serve(cuda, arch, smoke):
    """A decoder (the smoke one, and falcon-mamba-7b's full one) served
    on ``make_host_mesh(1, 1)`` (weights and cache DTensors, each step
    under ``sharding.sharded_step``) on the card: tokens and prefill
    logits bit-identical to the plain serve (one rank holds every shard,
    so the same ops run on the same tensors)."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import serve
    kw = dict(batch=2, prompt_len=16, new_tokens=3, device=cuda, smoke=smoke)
    plain = serve.serve(arch, **kw)
    try:
        meshed = serve.serve(arch, mesh=tmesh.make_host_mesh(1, 1), **kw)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert torch.equal(meshed.tokens, plain.tokens)
    assert torch.equal(meshed.prefill_logits, plain.prefill_logits)
