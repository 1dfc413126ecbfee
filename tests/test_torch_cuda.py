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
the same mixer on the CPU.
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention, gradnorm, lru_scan, ops  # noqa: E402

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
# zero-padded to d by the wrapper), each at its fp32 replay's shape (256
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
                 *sizes, (ctypes.c_longlong * 12)(*strides), 1, 1.0,
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
    assert lru_scan.LAUNCHES == {"lru_scan": 1}
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
    assert lru_scan.LAUNCHES == {"lru_scan": 1}
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
    assert out["cpu"][3] == {"lru_scan": 0}
    assert out["cuda"][3] == {"lru_scan": 1}
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
    assert lru_scan.LAUNCHES == {"lru_scan": 1}
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
    assert lru_scan.LAUNCHES == {"lru_scan": 0}
    empty = torch.empty((2, 0, 32), device=cuda)
    assert lru_scan.lru_scan(empty, empty).shape == (2, 0, 32)
    assert lru_scan.LAUNCHES == {"lru_scan": 0}
