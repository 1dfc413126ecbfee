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
from repro_torch.kernels import flash_attention, gradnorm, nvcc, ops, ref  # noqa: E402

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


@pytest.mark.parametrize("b", [1, 2])
def test_flash_attention_bhsd_hands_the_kernel_contiguous_tensors(
        monkeypatch, b):
    """The kernel takes contiguous (B*H, S, d) tensors; the fold must
    copy for every batch size (at B == 1 a reshape alone is a view)."""
    seen = []

    def kernel(q, k, v, causal, scale):
        seen.append(all(x.is_contiguous() for x in (q, k, v)))
        return flash_attention.flash_attention_plain(q, k, v, causal, scale)

    monkeypatch.setattr(ops, "flash_attention", kernel)
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, (b, 20, 3, 8)))
    got = ops.flash_attention_bhsd(q, k, v)
    assert seen == [True] and got.shape == (b, 20, 3, 8)


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
