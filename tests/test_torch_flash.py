"""Parity of the port's flash-attention module with the Pallas one.

On the CPU the port's wrappers run the plain PyTorch version; it is
held against ``repro.kernels.ref.flash_attention_ref`` and against the
Pallas kernel in interpret mode (as tests/test_kernels.py runs it), at
the shapes of tests/test_kernels.py, with its tolerances: 2e-5 in fp32
(float32 sums in another order) and 2e-2 in bf16 (one bf16 rounding of
the output).  Inputs are drawn with numpy; bf16 inputs are the same
float32 draws rounded to bf16 by each framework (round to nearest even
in both).  The CUDA kernel itself runs only on the card: its tests are
in tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import flash_attention, gradnorm, nvcc, ops, ref  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

torch.set_num_threads(2)

SHAPES = [(4, 128, 64), (2, 200, 32), (3, 513, 128), (1, 64, 256)]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _both(arrays, dtype):
    jd, td, _ = DTYPES[dtype]
    return ([jnp.asarray(a, jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("bh,s,d", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_matches_pallas_and_ref(bh, s, d, dtype):
    (qj, kj, vj), (q, k, v) = _both(_qkv(s + d, (bh, s, d)), dtype)
    tol = DTYPES[dtype][2]
    got = flash_attention.flash_attention(q, k, v, causal=True)
    assert got.dtype == q.dtype and got.shape == q.shape
    for want in (j_flash(qj, kj, vj, causal=True, interpret=True),
                 jref.flash_attention_ref(qj, kj, vj, causal=True)):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


def test_noncausal_matches_pallas_and_ref():
    (qj, kj, vj), (q, k, v) = _both(_qkv(0, (2, 96, 64)), "float32")
    got = flash_attention.flash_attention(q, k, v, causal=False)
    for want in (j_flash(qj, kj, vj, causal=False, interpret=True),
                 jref.flash_attention_ref(qj, kj, vj, causal=False)):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5)


def test_explicit_scale_matches_ref():
    (qj, kj, vj), (q, k, v) = _both(_qkv(1, (2, 40, 16)), "float32")
    got = flash_attention.flash_attention(q, k, v, causal=True, scale=0.3)
    want = jref.flash_attention_ref(qj, kj, vj, causal=True, scale=0.3)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5)


def test_flash_attention_bhsd_matches_reference():
    (qj, kj, vj), (q, k, v) = _both(_qkv(2, (2, 130, 3, 32)), "float32")
    got = ops.flash_attention_bhsd(q, k, v)
    assert got.shape == (2, 130, 3, 32)
    np.testing.assert_allclose(
        _f32(got), _f32(jops.flash_attention_bhsd(qj, kj, vj, interpret=True)),
        atol=2e-5)


GQA = [(1, 3, 3), (2, 6, 2), (1, 4, 1), (2, 8, 2)]  # (B, H, Hk)


@pytest.mark.parametrize("b,h,hk", GQA)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_bhsd_gqa_matches_reference(b, h, hk, dtype):
    """The strided GQA entry against the Pallas kernel (interpret mode)
    on kv heads repeated per query head, and against the JAX zoo's
    ``causal_attend``, which reads the kv heads grouped."""
    rng = np.random.default_rng(10 * h + hk + b)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, 37, h, 16), (b, 37, hk, 16), (b, 37, hk, 16))]
    (qj, kj, vj), (q, k, v) = _both(arrays, dtype)
    tol = DTYPES[dtype][2]
    got = ops.flash_attention_bhsd(q, k, v)
    assert got.shape == (b, 37, h, 16) and got.dtype == q.dtype
    assert got.is_contiguous()
    rep = [jnp.repeat(x, h // hk, axis=2) for x in (kj, vj)]
    for want in (jops.flash_attention_bhsd(qj, *rep, interpret=True),
                 jlayers.causal_attend(qj, kj, vj)):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(tlayers.causal_attend(q, k, v)),
                               _f32(got), atol=0, rtol=0)


@pytest.mark.parametrize("b,h,hk", GQA)
def test_flash_attention_bhsd_hands_the_kernel_the_strided_tensors_in_place(
        monkeypatch, b, h, hk):
    """``ops.flash_attention_bhsd`` and ``layers.causal_attend`` hand the
    kernel entry the caller's tensors themselves: no fold copy of q, k
    or v and no per-head copy of the kv heads, at every batch size (at
    B == 1 too, where the old fold had to copy)."""
    base = torch.from_numpy(_qkv(6, (b, 20, h + 2 * hk, 8))[0])
    q, k, v = base[:, :, :h], base[:, :, h:h + hk], base[:, :, h + hk:]
    assert not q.is_contiguous()  # strided views of one (B, S, ., d)
    seen = []

    def kernel(q_, k_, v_, causal, scale, softcap, q_offset):
        seen.append(all(x is y for x, y in ((q_, q), (k_, k), (v_, v))))
        return torch.zeros(q_.shape)

    def no_copy(*args, **kwargs):
        raise AssertionError("a copy of q, k or v")

    # take the kernel's branch with CPU tensors: the launch is replaced
    monkeypatch.setattr(flash_attention, "_on_cpu", lambda **_: False)
    monkeypatch.setattr(flash_attention, "_launch", kernel)
    monkeypatch.setattr(torch.Tensor, "repeat_interleave", no_copy)
    monkeypatch.setattr(torch.Tensor, "contiguous", no_copy)
    assert ops.flash_attention_bhsd(q, k, v).shape == (b, 20, h, 8)
    assert tlayers.causal_attend(q, k, v).shape == (b, 20, h, 8)
    assert seen == [True, True]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,dv", [(24, 16), (192, 128)])
def test_only_bf16_zero_pads_a_narrower_v(monkeypatch, dtype, d, dv):
    """With the launch replaced: both kernels have a value width of
    their own (the bf16 one reads v into its instance's V tile,
    ``bf16_instance``), so ``flash_attention_op`` hands the launch v
    itself, in either dtype: no zero-padded copy, and the output is
    (..., dv)."""
    q, k = (torch.from_numpy(x).to(dtype) for x in _qkv(7, (1, 12, 4, d))[:2])
    k = k[:, :, :2]
    v = torch.from_numpy(_qkv(8, (1, 12, 2, dv))[0]).to(dtype)
    seen = []

    def kernel(q_, k_, v_, causal, scale, softcap, q_offset):
        seen.append(v_)
        return torch.zeros(q_.shape[:3] + v_.shape[3:], dtype=q_.dtype)

    def no_copy(*args, **kwargs):
        raise AssertionError("a zero-padded copy of v")

    monkeypatch.setattr(flash_attention, "_on_cpu", lambda **_: False)
    monkeypatch.setattr(flash_attention, "_launch", kernel)
    monkeypatch.setattr(torch.Tensor, "new_zeros", no_copy)
    got = ops.flash_attention_bhsd(q, k, v)
    assert got.shape == (1, 12, 4, dv) and got.dtype == dtype
    assert len(seen) == 1 and seen[0] is v


# (d, dv) -> the bf16 instance <DC, DVC, BK> the C entry dispatches to
BF16_INSTANCES = [(8, 8, (1, 1, 128)), (64, 24, (1, 1, 128)),
                  (64, 64, (1, 1, 128)), (72, 72, (2, 2, 128)),
                  (128, 128, (2, 2, 128)), (136, 136, (3, 3, 96)),
                  (160, 160, (3, 3, 96)), (176, 64, (3, 2, 128)),
                  (192, 128, (3, 2, 128)), (192, 136, (3, 3, 96)),
                  (192, 192, (3, 3, 96)), (200, 200, (4, 4, 64)),
                  (256, 128, (4, 4, 64)), (256, 256, (4, 4, 64))]


@pytest.mark.parametrize("d,dv,want", BF16_INSTANCES)
def test_bf16_instance(d, dv, want):
    """stablelm's d = 160 and latent attention's 192 / 128 take the
    192-column instances, the other widths the instances they had."""
    assert flash_attention.bf16_instance(d, dv) == want


def test_bf16_instances_cover_every_pair_and_fit_the_card():
    """Every d <= 256 and dv <= d (multiples of 8, as ``_tma_operand``
    leaves them) has an instance whose q/K tile holds d and V tile holds
    dv with no more than 64 columns to spare over q's, and each
    instance's q tile and K/V stages (the ``WgSmem`` layout: 128 q rows,
    BK keys, 128 bytes a 64-column chunk row, 3 stages where they fit,
    else 2, and 32 bytes of mbarriers a stage) fit in 227 KB."""
    seen = set()
    for d in range(8, 257, 8):
        for dv in range(8, d + 1, 8):
            dc, dvc, bk = flash_attention.bf16_instance(d, dv)
            assert (dc - 1) * 64 < d <= dc * 64 and dv <= dvc * 64 <= dc * 64
            seen.add((dc, dvc, bk))
    assert seen == {(1, 1, 128), (2, 2, 128), (3, 2, 128), (3, 3, 96),
                    (4, 4, 64)}
    stages = {}
    for dc, dvc, bk in seen:
        fixed, stage = 128 * 128 * dc + 8 + 1024, bk * 128 * (dc + dvc) + 32
        stages[dc, dvc, bk] = 3 if fixed + 3 * stage <= 232448 else 2
        assert fixed + stages[dc, dvc, bk] * stage <= 232448
    assert stages == {(1, 1, 128): 3, (2, 2, 128): 3, (3, 2, 128): 2,
                      (3, 3, 96): 2, (4, 4, 64): 2}


def _bf16_views(b, h, hk, d, offset=0):
    """q, k, v as (B, 20, H|Hk, d) bf16 views of one fused projection,
    its data starting ``offset`` elements past an aligned base."""
    n = b * 20 * (h + 2 * hk) * d
    flat = torch.arange(n + offset, dtype=torch.float32).bfloat16()
    base = flat[offset:].view(b, 20, h + 2 * hk, d)
    return base[:, :, :h], base[:, :, h:h + hk], base[:, :, h + hk:]


@pytest.mark.parametrize("b,h,hk,d", [(1, 4, 2, 8), (2, 6, 2, 64),
                                      (4, 24, 8, 128), (1, 1, 1, 256)])
def test_tma_reads_aligned_bf16_views_in_place(b, h, hk, d):
    """The serving path's views (d % 8 == 0, 16-byte aligned base and
    strides) reach the bf16 kernel as they are: no copy."""
    for x in _bf16_views(b, h, hk, d):
        assert flash_attention._tma_readable(x)
        assert flash_attention._tma_operand(x) is x


@pytest.mark.parametrize("b,h,hk,d,offset", [(1, 3, 3, 20, 0), (2, 6, 2, 64, 1),
                                             (4, 24, 8, 128, 1), (1, 4, 1, 12, 1)])
def test_tma_operand_pads_what_tma_cannot_read(b, h, hk, d, offset):
    """A bf16 view TMA cannot read in place (d % 8 != 0, or a base one
    element past alignment) becomes an aligned contiguous copy with d
    zero-padded to a multiple of 8."""
    for x in _bf16_views(b, h, hk, d, offset):
        assert not flash_attention._tma_readable(x)
        y = flash_attention._tma_operand(x)
        dp = -(-d // 8) * 8
        assert y.shape == x.shape[:3] + (dp,) and y.is_contiguous()
        assert y.data_ptr() % 16 == 0 and flash_attention._tma_readable(y)
        assert torch.equal(y[..., :d], x)
        assert not y[..., d:].any()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,hk,d", [(1, 3, 3, 20), (2, 4, 2, 13)])
def test_zero_padded_d_leaves_attention_unchanged(b, h, hk, d, causal):
    """What the bf16 route relies on for d % 8 != 0: attention over the
    zero-padded operands, scaled by the real d, equals attention over
    the originals in its first d columns, and is 0 in the rest."""
    rng = np.random.default_rng(d + h)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, 29, n, d))
                                .astype(np.float32))
               for n in (h, hk, hk))
    pad = [flash_attention._tma_operand(x) for x in (q, k, v)]
    got = flash_attention.flash_attention_bhsd_plain(*pad, causal=causal,
                                                     scale=d ** -0.5)
    want = flash_attention.flash_attention_bhsd_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got[..., :d], want, atol=2e-5, rtol=2e-5)
    assert not got[..., d:].any()


@pytest.mark.parametrize("b", [1, 3])
def test_kernel_args_are_the_views_own_strides(b):
    """The sizes and strides the C entry points receive are those of the
    strided views, kv heads not repeated; the output is contiguous."""
    base = torch.zeros((b, 12, 7, 16))
    q, k, v = base[:, :, :4], base[:, :, 4:6], base[:, :, 6:]
    o = torch.empty((b, 12, 4, 16))
    sizes, strides = flash_attention.kernel_args(q, k, v, o)
    assert sizes == (b, 12, 12, 4, 2, 16)  # B, Sq, Sk, H, Hk, d
    assert strides == (12 * 7 * 16, 7 * 16, 16) * 3 + (12 * 4 * 16, 4 * 16,
                                                      16)


def test_ref_name_is_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, (2, 17, 8)))
    torch.testing.assert_close(ref.flash_attention_ref(q, k, v),
                               flash_attention.flash_attention_plain(q, k, v))


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    flash_attention.reset_launch_counts()
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, (2, 33, 300)))
    # the plain version takes any d; the kernel's d <= 256 applies on CUDA
    torch.testing.assert_close(flash_attention.flash_attention(q, k, v),
                               flash_attention.flash_attention_plain(q, k, v))
    assert flash_attention.LAUNCHES == {"flash_attention": 0}


def test_non_cpu_non_cuda_tensors_raise_instead_of_falling_back():
    flash_attention.reset_launch_counts()
    meta = torch.empty((2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention(meta, meta, meta)
    # a CPU tensor beside a non-CPU one is no plain-version case
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention(torch.zeros(2, 8, 16), meta, meta)
    assert flash_attention.LAUNCHES == {"flash_attention": 0}


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """The kernel is built from source; with no nvcc there is no
    library and no silent fallback to the plain version."""
    monkeypatch.setattr(flash_attention, "_BUILD", None)
    monkeypatch.setattr(flash_attention, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        flash_attention.build()
    assert flash_attention._BUILD is None
    assert not any((tmp_path / "build").glob("*.so"))


def test_sm90_build_without_nvcc_raises(monkeypatch, tmp_path):
    """The bf16 tensor-core kernels build from their own source, with the
    same refusal when nvcc is missing."""
    monkeypatch.setattr(flash_attention, "_BUILD_SM90", None)
    monkeypatch.setattr(flash_attention, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        flash_attention.build_sm90()
    assert flash_attention._BUILD_SM90 is None
    assert not any((tmp_path / "build").glob("*.so"))


def test_flash_sources_build_into_distinct_libraries():
    """fp32 (CUDA cores) and bf16 (tensor cores) are two sources and two
    libraries, beside the other kernels'."""
    names = {nvcc.library_path(src, flash_attention.NVCC_FLAGS).name
             .rsplit("-", 1)[0]
             for src in (flash_attention.SOURCE, flash_attention.SOURCE_SM90,
                         gradnorm.SOURCE)}
    assert names == {"flash_attention", "flash_attention_sm90", "gradnorm"}
    assert flash_attention.SOURCE_SM90.exists()


def _fake_nvcc(monkeypatch, returncode, output):
    """nvcc stood in for by a function that writes the library it is
    asked for and prints ``output``; returns the commands it ran."""
    import subprocess
    from pathlib import Path
    calls = []

    def run(cmd, **kwargs):
        calls.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"\0")
        return subprocess.CompletedProcess(cmd, returncode, output, "")

    monkeypatch.setattr(nvcc, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(nvcc.subprocess, "run", run)
    return calls


PTXAS_LOG = (
    "ptxas info    : 0 bytes gmem\n"
    "ptxas info    : Compiling entry function '_Z18flash_wgmma_kernelv' "
    "for 'sm_90a'\n"
    "ptxas info    : Function properties for _Z18flash_wgmma_kernelv\n"
    "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
    "ptxas info    : Used 168 registers, used 3 barriers, 392 bytes "
    "cmem[0]\n"
    "ptxas warning : (C7508) setmaxnreg ignored; unable to determine "
    "register count at entry\n"
    "ptxas info    : Compiling entry function '_Z4scanv' for 'sm_90a'\n"
    "    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads\n"
    "ptxas info    : Used 32 registers\n")


def test_build_keeps_the_log_beside_the_library(monkeypatch, tmp_path):
    """A reused library returns the compiler output of the build that
    made it (the ptxas report the card's tests read), and a failed
    build leaves neither the library nor its log."""
    src = tmp_path / "k.cu"
    src.write_text("// k\n")
    out = tmp_path / "build"
    calls = _fake_nvcc(monkeypatch, 0, PTXAS_LOG)
    first = nvcc.build(src, nvcc.BASE_FLAGS, out)
    again = nvcc.build(src, nvcc.BASE_FLAGS, out)
    assert len(calls) == 1 and again.seconds == 0.0
    assert first.log == again.log == PTXAS_LOG
    assert sorted(p.name for p in out.iterdir()) == [
        first.path.with_suffix(".log").name, first.path.name]
    src.write_text("// broken\n")
    _fake_nvcc(monkeypatch, 1, "error")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        nvcc.build(src, nvcc.BASE_FLAGS, out)
    assert len(list(out.iterdir())) == 2


def test_ptxas_report_reads_each_entry():
    """Registers, barriers and spill bytes per entry function, in
    ptxas's order, and its warnings line by line."""
    entries = nvcc.ptxas_report(PTXAS_LOG)
    assert [(e.name, e.registers, e.barriers, e.spill_stores,
             e.spill_loads) for e in entries] == [
        ("_Z18flash_wgmma_kernelv", 168, 3, 0, 0),
        ("_Z4scanv", 32, 0, 4, 8)]
    assert nvcc.ptxas_warnings(PTXAS_LOG) == [
        "ptxas warning : (C7508) setmaxnreg ignored; unable to determine "
        "register count at entry"]
    assert nvcc.ptxas_report("") == [] and nvcc.ptxas_warnings("") == []


def test_build_key_hashes_source_and_flags(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    a = nvcc.library_path(src, nvcc.BASE_FLAGS, tmp_path)
    assert a == nvcc.library_path(src, nvcc.BASE_FLAGS, tmp_path)
    assert a.parent == tmp_path and a.name.startswith("k-")
    assert a != nvcc.library_path(src, nvcc.BASE_FLAGS + ("-lineinfo",),
                                  tmp_path)
    src.write_text("// two\n")
    assert a != nvcc.library_path(src, nvcc.BASE_FLAGS, tmp_path)
    # the two kernels of the port build into distinct libraries
    names = {nvcc.library_path(m.SOURCE, m.NVCC_FLAGS).name.split("-")[0]
             for m in (flash_attention, gradnorm)}
    assert names == {"flash_attention", "gradnorm"}
