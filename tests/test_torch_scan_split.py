"""The scan kernel's split of the sequence, in plain torch on the CPU.

``csrc/lru_scan.cu`` does not run the recurrence h_t = a_t h_{t-1} + b_t
step after step over the whole sequence: a block walks it in chunks of
L = W * P steps, each of its W warps scans P consecutive steps from 0
(keeping the product of its a beside its last h), the W aggregates are
folded in order from the previous chunk's carry, and each warp then runs
its steps once more from the carry into its segment.  ``split_scan``
below computes exactly that decomposition, with the kernel's fused
multiply-adds (a float64 product and sum rounded once to float32) and
its float32 products, at the kernel's schedule (``kernels.lru_scan``'s
``WARPS`` and ``STEPS``, checked against the source's constants).  It is held against the Pallas kernel in interpret
mode and ``repro.kernels.ref.lru_scan_ref`` at atol/rtol 1e-5, the
reference's scan tolerance, at S around the chunk's seams and at 2048,
with gates in (0.3, 0.999), and a == 0 must give b exactly.  Gates in
(0.999, 1) (mamba's exp(dt A) at small dt, the RG-LRU's a near 1) keep
rtol 1e-5 with an atol of 1e-5 times the largest |h|: over 2048 such
steps two sequential fp32 loops already disagree above 1e-5 where h
crosses 0 (the reference's jnp loop and the port's plain version, the
CPU path since the scan was first ported; the last test below), so no
evaluation order can meet 1e-5 elementwise against either.  So the
reassociation keeps the tolerance
without a card; on the card, ``chip_smoke.py`` phase 3 and
tests/test_torch_cuda.py hold the kernel itself to the plain version.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.lru_scan import lru_scan as j_lru_scan  # noqa: E402
from repro_torch.kernels import lru_scan  # noqa: E402

B, C = 2, 8
W, P = lru_scan.WARPS, lru_scan.STEPS
L = W * P
GATES = {"mid": (0.3, 0.999), "near1": (0.999, 1.0), "zero": None}


def _fma(a, x, b):
    """fmaf: a * x exact in float64, + b, one rounding to float32."""
    return (a.double() * x.double() + b.double()).float()


def split_scan(a: torch.Tensor, b: torch.Tensor, warps: int,
               steps: int) -> torch.Tensor:
    """The kernel's decomposition of the scan of (B, S, C) float32 a, b."""
    batch, seq, ch = a.shape
    chunk = warps * steps
    n = -(-seq // chunk)
    pad = n * chunk - seq  # past the end: the identity (a, b) = (1, 0)
    a = torch.cat([a, a.new_ones(batch, pad, ch)], 1)
    b = torch.cat([b, b.new_zeros(batch, pad, ch)], 1)
    a = a.reshape(batch, n, warps, steps, ch)
    b = b.reshape(batch, n, warps, steps, ch)
    out = torch.empty_like(a)
    carry = a.new_zeros(batch, ch)
    for k in range(n):
        ak, bk = a[:, k], b[:, k]  # (B, W, P, C)
        # segment scans from 0, and segment products
        hend = a.new_zeros(batch, warps, ch)
        prod = a.new_ones(batch, warps, ch)
        for p in range(steps):
            hend = _fma(ak[:, :, p], hend, bk[:, :, p])
            prod = prod * ak[:, :, p]
        # the in-order combine from the chunk's carry
        into = []
        for j in range(warps):
            into.append(carry)
            carry = _fma(prod[:, j], carry, hend[:, j])
        # the fix-up: each segment once more from its carry
        x = torch.stack(into, 1)
        for p in range(steps):
            x = _fma(ak[:, :, p], x, bk[:, :, p])
            out[:, k, :, p] = x
    return out.reshape(batch, n * chunk, ch)[:, :seq]


@pytest.mark.parametrize("gate", sorted(GATES))
@pytest.mark.parametrize("s", [1, L - 1, L, L + 1, 2048])
def test_split_scan_matches_pallas_and_ref(s, gate):
    rng = np.random.default_rng(s * 7 + len(gate))
    bb = rng.standard_normal((B, s, C)).astype(np.float32)
    if GATES[gate] is None:
        a = np.zeros_like(bb)
    else:
        a = rng.uniform(*GATES[gate], (B, s, C)).astype(np.float32)
    got = split_scan(torch.from_numpy(a), torch.from_numpy(bb), W, P)
    assert got.dtype == torch.float32 and got.shape == (B, s, C)
    for want in (j_lru_scan(a, bb, interpret=True), jref.lru_scan_ref(a, bb)):
        want = np.asarray(want)
        scale = float(np.abs(want).max()) if gate == "near1" else 1.0
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * scale,
                                   rtol=1e-5)
    if GATES[gate] is None:  # a == 0 is exactly the identity on b
        np.testing.assert_array_equal(got.numpy(), bb)


def test_schedule_matches_the_kernel_source():
    """The wrapper's TILE, WARPS and STEPS (which this file's split and
    the card's seam checks use) are the constants the kernel compiles."""
    src = lru_scan.SOURCE.read_text()
    got = {name: int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
           for name in ("kTile", "kWarps", "kSteps")}
    assert got == {"kTile": lru_scan.TILE, "kWarps": W, "kSteps": P}


def test_sequential_loops_differ_above_1e_5_at_gates_near_1():
    """Why gates in (0.999, 1) are held at 1e-5 times max |h|: the
    reference's sequential loop and the port's plain one, the same
    recurrence in the same order, miss 1e-5 elementwise against each
    other at (2, 2048, 256), and agree within 1e-5 of max |h|."""
    rng = np.random.default_rng(0)
    a = rng.uniform(0.999, 1.0, (2, 2048, 256)).astype(np.float32)
    bb = rng.standard_normal((2, 2048, 256)).astype(np.float32)
    want = np.asarray(jref.lru_scan_ref(a, bb))
    plain = lru_scan.lru_scan_plain(torch.from_numpy(a),
                                    torch.from_numpy(bb)).numpy()
    assert not np.allclose(plain, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(plain, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
