"""The scan's gradient on the CPU: the plain version, the kernel's
reversed split of the sequence, and the op under autograd.

``repro_torch::lru_scan_backward`` takes a, h = lru_scan(a, b) and
gbar = dL/dh and returns (dL/da, dL/db): the adjoint g_t = gbar_t +
a_{t+1} g_{t+1} (a_S = 0), dL/db = g and dL/da_t = g_t h_{t-1}
(h_{-1} = 0).  The reference trains through ``jax.lax.associative_scan``
and its Pallas scan has no custom_vjp, so the yardstick is ``jax.vjp``
of the reference's scans (``repro.kernels.ref.lru_scan_ref``, the
sequential loop, and ``repro.models.ssm._scan_assoc``), held at
atol/rtol 1e-5.  Gates in (0.999, 1) keep rtol 1e-5 with an atol of
1e-5 times the largest |g|, the forward's argument
(tests/test_torch_scan_split.py): over 2048 such steps two sequential
fp32 loops already disagree above 1e-5 where g crosses 0.

``csrc/lru_scan.cu``'s backward kernel walks the sequence from t = S - 1
in the forward's chunks of L = W * P steps.  ``split_scan_backward``
below computes that decomposition with the kernel's index arithmetic (a
read at t + 1, h at t - 1, the seams at multiples of L in reversed
index) and its fused multiply-adds, and is held bit for bit to the route
the kernel replaced: the forward's split (``split_scan``) on
time-reversed copies of gbar and of a shifted by one step, then the
product with h.  On the card, ``chip_smoke.py`` phase 3 and
tests/test_torch_cuda.py hold the kernel itself to that route.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels import lru_scan, ops  # noqa: E402
from tests.test_torch_scan_split import _fma, split_scan  # noqa: E402

B = 2
W, P = lru_scan.WARPS, lru_scan.STEPS
L = W * P
SEAMS = [1, L - 1, L, L + 1, 2048]
GATES = {"mid": (0.3, 0.999), "near1": (0.999, 1.0), "zero": None}
TOL = 1e-5


def _inputs(seed, shape, gate):
    """a in ``GATES[gate]`` (a == 0 for "zero"), b and gbar normal."""
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(shape).astype(np.float32)
    gbar = rng.standard_normal(shape).astype(np.float32)
    if GATES[gate] is None:
        a = np.zeros(shape, np.float32)
    else:
        a = rng.uniform(*GATES[gate], shape).astype(np.float32)
    return a, b, gbar


def _assoc(a, b):
    return jssm._scan_assoc(a[..., None], b[..., None])[..., 0]


JAX_SCANS = {"lru_scan_ref": jref.lru_scan_ref, "scan_assoc": _assoc}


def _vjp_of(scan):
    return jax.jit(lambda a, b, gbar: jax.vjp(scan, a, b)[1](gbar))


_VJPS = {scan: _vjp_of(scan) for scan in JAX_SCANS.values()}


def _jax_grads(scan, a, b, gbar):
    """(dL/da, dL/db) of <scan(a, b), gbar> by ``jax.vjp`` (jitted)."""
    grads = _VJPS[scan](jnp.asarray(a), jnp.asarray(b), jnp.asarray(gbar))
    return tuple(np.asarray(g) for g in grads)


def _hold(got, want, gate, what):
    """``got`` against ``want`` at TOL; at gates near 1 with an atol of
    TOL times the largest |want|."""
    scale = float(np.abs(want).max()) if gate == "near1" else 1.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=TOL,
                               atol=TOL * scale, err_msg=what)


def _parent_route(a, h, gbar, scan):
    """The gradient as the port took it before the backward kernel: the
    forward ``scan`` on time-reversed contiguous copies of gbar and of a
    shifted by one step, flipped back, then dL/da = g h_{t-1}."""
    S = a.shape[1]
    a_rev = torch.zeros(a.shape, dtype=torch.float32)
    a_rev[:, 1:] = a[:, 1:].flip(1)
    g = scan(a_rev, gbar.float().flip(1)).flip(1)
    grad_a = torch.zeros_like(g)
    grad_a[:, 1:] = g[:, 1:] * h[:, :S - 1]
    return grad_a, g


def split_scan_backward(a: torch.Tensor, h: torch.Tensor, gbar: torch.Tensor,
                        warps: int, steps: int) -> tuple:
    """The backward kernel's decomposition, (dL/da, dL/db) of (B, S, C)
    float32 a, h, gbar: reversed step i is time step t = S - 1 - i, with
    the gate a_{t+1} (0 at i = 0), the input gbar_t and h_{t-1} (0 at
    t = 0); chunks of warps * steps reversed steps, each warp's segment
    scanned from 0 into (prod a, g_end), the aggregates folded in order
    from the carry, then each segment once more from its carry."""
    batch, seq, ch = a.shape
    chunk = warps * steps
    grad_a = torch.zeros_like(gbar)
    grad_b = torch.zeros_like(gbar)
    carry = a.new_zeros(batch, ch)
    for k in range(-(-seq // chunk)):
        av, gv, hv = [], [], []  # [warp][step] -> (B, C)
        for w in range(warps):
            i0 = k * chunk + w * steps
            t0 = seq - 1 - i0
            seg = ([], [], [])
            for p in range(steps):
                i, t = i0 + p, t0 - p
                if i >= seq:  # past the start: the identity (1, 0)
                    seg[0].append(a.new_ones(batch, ch))
                    seg[1].append(a.new_zeros(batch, ch))
                    seg[2].append(a.new_zeros(batch, ch))
                    continue
                zero = a.new_zeros(batch, ch)
                seg[0].append(a[:, t + 1] if i > 0 else zero)
                seg[1].append(gbar[:, t])
                seg[2].append(h[:, t - 1] if t > 0 else zero)
            av.append(seg[0])
            gv.append(seg[1])
            hv.append(seg[2])
        aggs = []
        for w in range(warps):
            gend = a.new_zeros(batch, ch)
            prod = a.new_ones(batch, ch)
            for p in range(steps):
                gend = _fma(av[w][p], gend, gv[w][p])
                prod = prod * av[w][p]
            aggs.append((prod, gend))
        into = []
        for prod, gend in aggs:
            into.append(carry)
            carry = _fma(prod, carry, gend)
        for w in range(warps):
            x = into[w]
            for p in range(steps):
                x = _fma(av[w][p], x, gv[w][p])
                i = k * chunk + w * steps + p
                if i < seq:
                    t = seq - 1 - i
                    grad_b[:, t] = x
                    if t > 0:
                        grad_a[:, t] = x * hv[w][p]
    return grad_a, grad_b


# ------------------------------------------------------ the plain version

@pytest.mark.parametrize("gate", sorted(GATES))
@pytest.mark.parametrize("c", [1, 8, 130])
@pytest.mark.parametrize("s", SEAMS)
def test_plain_backward_matches_jax_vjp(s, c, gate):
    """``lru_scan_backward_plain`` against ``jax.vjp`` of the reference's
    sequential and associative scans; a == 0 gives dL/db = gbar
    exactly."""
    a, b, gbar = _inputs(s * 131 + c * 7 + len(gate), (B, s, c), gate)
    h = lru_scan.lru_scan_plain(torch.from_numpy(a), torch.from_numpy(b))
    ga, gb = lru_scan.lru_scan_backward_plain(torch.from_numpy(a), h,
                                              torch.from_numpy(gbar))
    assert ga.dtype == gb.dtype == torch.float32
    assert ga.shape == gb.shape == (B, s, c)
    for name, scan in JAX_SCANS.items():
        want = _jax_grads(scan, a, b, gbar)
        _hold(ga, want[0], gate, f"dL/da against {name}")
        _hold(gb, want[1], gate, f"dL/db against {name}")
    if GATES[gate] is None:
        np.testing.assert_array_equal(gb.numpy(), gbar)
    assert not ga[:, 0].any()  # h_{-1} = 0


@pytest.mark.parametrize("gate", sorted(GATES))
@pytest.mark.parametrize("s", [1, 37, L + 1])
def test_plain_backward_is_the_parent_cpu_route(s, gate):
    """The sequential loop gives the bits that the reversed plain scan
    gave CPU tensors before (the same multiply, then add, in the same
    order)."""
    a, b, gbar = (torch.from_numpy(x) for x in _inputs(s + 3, (B, s, 5),
                                                       gate))
    h = lru_scan.lru_scan_plain(a, b)
    got = lru_scan.lru_scan_backward_plain(a, h, gbar)
    want = _parent_route(a, h, gbar, lru_scan.lru_scan_plain)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ------------------------------------------ the kernel's reversed split

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gate", sorted(GATES))
@pytest.mark.parametrize("s", SEAMS)
def test_split_scan_backward_is_the_parent_route_bit_for_bit(s, gate, dtype):
    """The backward kernel's decomposition equals the forward kernel's
    (``split_scan``) on the reversed copies, then the product, bit for
    bit (bf16 a widened to fp32 exactly, as the kernel reads it), and
    holds 1e-5 against ``jax.vjp`` of the reference's scan."""
    a, b, gbar = _inputs(s * 17 + len(gate), (B, s, 8), gate)
    at = torch.from_numpy(a).to(getattr(torch, dtype)).float()
    h = lru_scan.lru_scan_plain(at, torch.from_numpy(b))
    gt = torch.from_numpy(gbar)
    got = split_scan_backward(at, h, gt, W, P)
    want = _parent_route(at, h, gt, lambda x, y: split_scan(x, y, W, P))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    jax_want = _jax_grads(jref.lru_scan_ref, at.numpy(), b, gbar)
    _hold(got[0], jax_want[0], gate, "dL/da")
    _hold(got[1], jax_want[1], gate, "dL/db")


def test_backward_entry_points_are_in_the_kernel_source():
    """The C entry points the wrapper binds, named after a's dtype, are
    defined in the source, with the forward's schedule."""
    src = lru_scan.SOURCE.read_text()
    for dt in ("f32", "bf16"):
        assert re.search(rf'extern "C" int repro_lru_scan_backward_{dt}\(',
                         src)
    assert "lru_scan_backward_kernel<T, kWarps, kSteps>" in src


# ----------------------------------------------- the op under autograd

def _loss_cases():
    """(name, loss of h): a weighted sum, and h.sum(), whose gradient
    autograd hands over as an expanded (stride-0) tensor."""
    return {"weighted": lambda h, w: (h * w).sum(),
            "sum": lambda h, w: h.sum()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("loss", sorted(_loss_cases()))
@pytest.mark.parametrize("shape", [(2, 1, 5), (2, 37, 6), (3, L + 1, 130)])
def test_op_gradient_through_ops_lru_scan(shape, loss, dtype):
    """``ops.lru_scan``'s autograd on CPU tensors: the backward op's plain
    version, no launch counted, the gradients in the input dtypes and
    within 1e-5 of ``jax.vjp`` of the reference's scan (bf16: the
    gradient rounded to bf16 at the end, held at bf16's rounding)."""
    a, b, w = _inputs(sum(shape) + len(loss), shape, "mid")
    td = getattr(torch, dtype)
    at = torch.from_numpy(a).to(td).requires_grad_()
    bt = torch.from_numpy(b).to(td).requires_grad_()
    lru_scan.reset_launch_counts()
    h = ops.lru_scan(at, bt)
    _loss_cases()[loss](h, torch.from_numpy(w)).backward()
    assert lru_scan.LAUNCHES == {"lru_scan": 0, "lru_scan_backward": 0}
    assert at.grad.dtype == bt.grad.dtype == td
    gbar = w if loss == "weighted" else np.ones(shape, np.float32)
    want = _jax_grads(jref.lru_scan_ref, at.detach().float().numpy(),
                      bt.detach().float().numpy(), gbar)
    tol = TOL if dtype == "float32" else 2 ** -8
    for got, ref in zip((at.grad, bt.grad), want):
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=tol,
                                   atol=tol * max(1.0, float(np.abs(ref)
                                                             .max())))


def test_op_rejects_what_the_plain_version_cannot_take():
    """A real ``meta`` tensor is no device: the op raises and counts no
    launch; mismatched shapes raise under fake tensors too."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    m = torch.zeros((1, 4, 8), device="meta")
    lru_scan.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        lru_scan.lru_scan_backward_op(m, m, m)
    with pytest.raises(ValueError, match="CUDA"):
        lru_scan.lru_scan_backward_op(torch.zeros((1, 4, 8)), m, m)
    assert lru_scan.LAUNCHES == {"lru_scan": 0, "lru_scan_backward": 0}
    with FakeTensorMode():
        x = torch.empty(2, 5, 3)
        with pytest.raises(ValueError, match="shape"):
            lru_scan.lru_scan_backward_op(x, x, torch.empty(2, 4, 3))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_op_fake_shapes(dtype):
    """The fake implementation (the dry run's fake tensors): two fp32
    (B, S, C) gradients, whatever a's dtype."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        a = torch.empty(3, 9, 4, dtype=getattr(torch, dtype))
        h, gbar = torch.empty(3, 9, 4), torch.empty(3, 9, 4)
        ga, gb = lru_scan.lru_scan_backward_op(a, h, gbar)
    for g in (ga, gb):
        assert g.shape == (3, 9, 4) and g.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_op_passes_opcheck(dtype):
    gen = torch.Generator().manual_seed(3)
    a = torch.rand(2, 9, 3, generator=gen).to(getattr(torch, dtype))
    h, gbar = torch.randn(2, 9, 3, generator=gen), torch.randn(
        2, 9, 3, generator=gen)
    torch.library.opcheck(lru_scan.lru_scan_backward_op, (a, h, gbar))


@pytest.mark.parametrize("shape", [(2, 9, 3), (1, L + 1, 130)])
def test_flop_count_is_three_per_element(shape):
    """Under ``FlopCounterMode`` the backward op counts 3 B S C (the
    adjoint's multiply and add, dL/da's multiply), the whole of a
    backward pass of ``ops.lru_scan``; the forward keeps its 2 B S C."""
    from torch.utils.flop_counter import FlopCounterMode
    gen = torch.Generator().manual_seed(4)
    a = torch.rand(*shape, generator=gen).requires_grad_()
    b = torch.randn(*shape, generator=gen).requires_grad_()
    n = int(np.prod(shape))
    with FlopCounterMode(display=False) as fwd:
        h = ops.lru_scan(a, b)
    with FlopCounterMode(display=False) as bwd:
        h.sum().backward()
    with FlopCounterMode(display=False) as op:
        lru_scan.lru_scan_backward_op(a.detach(), h.detach(),
                                      torch.ones(shape))
    assert fwd.get_total_flops() == 2 * n
    assert bwd.get_total_flops() == op.get_total_flops() == 3 * n
