#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU
and the CUDA toolkit.  Phases, each of which fails the run (non-zero
exit) if anything in it fails; no failure is caught:

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: ``kernels/csrc/gradnorm.cu`` compiled with nvcc for sm_90a;
3. kernels: each CUDA entry point against its plain PyTorch version on
   the card, at the test shapes and at the main path's shapes, with
   device times (CUDA events over a CUDA graph of back-to-back calls),
   the plain version's time, a one-call PyTorch equivalent where one
   exists, and the least time the card could take (bytes or flops);
4. main path: 3 rounds of the paper's §VI-A setup (K=10, N=5, Q=2,
   D̂=200, 28x28 images, faithful selection with 400 GP steps) through
   ``FEELTrainer.run_round``, which scores sigma through the kernel;
   launch counts are zeroed just before and read just after;
5. replay: round 0 again with the port on the CPU, held against the
   card's round 0;
6. where the time goes: the decision stage split into matching and
   selection, and one more round under ``torch.profiler``.

It prints one ``{"kernels": [...]}`` line and, last, the ``{"ok": true,
"device": ...}`` line.  Without a GPU, or without the repository's
``src/repro_torch`` beside it, it exits non-zero before printing either.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# card peaks used for the bounds (H100 SXM data sheet, 700 W): HBM rate and
# float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

KERNEL_RTOL = 1e-5       # kernel vs plain, float32 sums in another order
TEST_SHAPES = [(10, 50), (300, 700), (8, 4096), (1000, 130)]
K, N, Q, D_HAT, SIDE, ROUNDS, GP_STEPS, LR = 10, 5, 2, 200, 28, 3, 400, 1e-3
SELECTION_BAND = 1e-3    # |delta† - 1/2| below this: a tie for Alg. 5
SIGMA_RTOL = 1e-4        # card vs CPU sigma (other conv algorithms)
NET_COST_RTOL = 1e-5
NOISE = 1e-6             # Adam first moment at float32 noise (see tests)


def die(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        die(msg)


# ------------------------------------------------------------- timing

def device_ms(torch, fn, calls: int = 100, replays: int = 10) -> float:
    """Device time of one ``fn()`` in ms: ``calls`` back-to-back calls are
    captured in a CUDA graph and replayed, so host launch overhead does
    not show (inputs stay in L2, as when the forward pass just wrote
    them)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def call_ms(torch, fn, reps: int = 200) -> float:
    """Wall time of one eager ``fn()`` in ms, host overhead included."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_rel(got, want) -> float:
    return float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())


# ------------------------------------------------------------- phases

def phase_kernels(torch, gradnorm):
    """Both entry points against their plain versions; returns the
    gradnorm_sigma record at the main path's shapes."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    rows = K * D_HAT
    main_sigma = None
    for n, f in TEST_SHAPES + [(rows, 84), (rows, 10)]:
        x = randn(n, f)
        got, want = gradnorm.rownorm2(x), gradnorm.rownorm2_plain(x)
        torch.cuda.synchronize()
        rel = max_rel(got, want)
        check(rel <= KERNEL_RTOL, f"rownorm2 {(n, f)}: rel err {rel:.3g}")
        b_ms, b_by = bound(4.0 * (n * f + n), 2.0 * n * f)
        print(f"rownorm2 ({n}, {f}): max_abs_err "
              f"{float((got - want).abs().max()):.3g} max_rel_err {rel:.3g} | "
              f"device ms: kernel "
              f"{device_ms(torch, lambda: gradnorm.rownorm2(x)):.6f} plain "
              f"{device_ms(torch, lambda: gradnorm.rownorm2_plain(x)):.6f} "
              f"vector_norm^2 {device_ms(torch, lambda: torch.linalg.vector_norm(x, dim=-1).square()):.6f} "
              f"vecdot {device_ms(torch, lambda: torch.linalg.vecdot(x, x)):.6f} "
              f"bound {b_ms:.6f} ({b_by}) | eager call ms: kernel "
              f"{call_ms(torch, lambda: gradnorm.rownorm2(x)):.6f}")

    for n, f in TEST_SHAPES + [(rows, 84)]:
        h, d = randn(n, f), randn(n, 10)
        got = gradnorm.gradnorm_sigma(h, d)
        want = gradnorm.gradnorm_sigma_plain(h, d)
        torch.cuda.synchronize()
        rel = max_rel(got, want)
        check(rel <= KERNEL_RTOL, f"gradnorm_sigma {(n, f)}: rel err {rel:.3g}")
        b_ms, b_by = bound(4.0 * (n * (f + 10) + n), 2.0 * n * (f + 10) + 2 * n)
        rec = {"max_abs_err": float((got - want).abs().max()),
               "ms": device_ms(torch, lambda: gradnorm.gradnorm_sigma(h, d)),
               "plain_ms": device_ms(
                   torch, lambda: gradnorm.gradnorm_sigma_plain(h, d)),
               "bound_ms": b_ms, "bound_by": b_by}
        print(f"gradnorm_sigma ({n}, {f})+({n}, 10): max_abs_err "
              f"{rec['max_abs_err']:.3g} max_rel_err {rel:.3g} | device ms: "
              f"kernel {rec['ms']:.6f} plain {rec['plain_ms']:.6f} bound "
              f"{b_ms:.6f} ({b_by}) | eager call ms: kernel "
              f"{call_ms(torch, lambda: gradnorm.gradnorm_sigma(h, d)):.6f} "
              f"plain {call_ms(torch, lambda: gradnorm.gradnorm_sigma_plain(h, d)):.6f}")
        if n == rows:
            main_sigma = rec
    return main_sigma


def make_data(rt):
    train = rt.data.SyntheticImages.make(6000, side=SIDE, seed=0)
    test = rt.data.SyntheticImages.make(1500, side=SIDE, seed=1)
    return rt.data.non_iid_split(train, test, K=K, per_device=600,
                                 mislabel_prop=0.1, seed=0)


def make_trainer(rt, torch, data, state_dict, device):
    cfg = rt.fed.FEELConfig(d_hat=D_HAT, gp_steps=GP_STEPS, lr=LR)
    model = rt.models.cnn.CNN(rt.models.cnn.CNNConfig(side=SIDE))
    model.load_state_dict(state_dict)
    sys_ = rt.core.default_system(K=K, N=N, Q=Q, D_hat=D_HAT, device=device)
    return rt.fed.FEELTrainer(sys_, data, model, cfg)


def host(tensors):
    return {n: t.detach().cpu().clone() for n, t in tensors.items()}


def phase_replay(rt, torch, data, init_sd, gpu0):
    """Round 0 on the CPU against the card's round 0."""
    cpu = make_trainer(rt, torch, data, init_sd, "cpu")
    t0 = time.perf_counter()
    cpu.run_round(0)
    wall = time.perf_counter() - t0
    dec = cpu.last_decision
    check(bool((dec.rho == gpu0["rho"]).all()), "replay: RB assignment differs")
    sig_rel = max_rel(gpu0["sigma"], cpu.last_state.sigma)
    check(sig_rel <= SIGMA_RTOL, f"replay: sigma rel err {sig_rel:.3g}")
    cont_g, cont_c = gpu0["delta_cont"], dec.delta_cont
    in_band = ((cont_g - 0.5).abs() < SELECTION_BAND) | (
        (cont_c - 0.5).abs() < SELECTION_BAND)
    differ = gpu0["delta"] != dec.delta
    check(not bool((differ & ~in_band).any()),
          "replay: selection differs outside the band around 1/2")
    nc_rel = abs(dec.net_cost - gpu0["net_cost"]) / abs(gpu0["net_cost"])
    check(nc_rel <= NET_COST_RTOL, f"replay: net cost rel err {nc_rel:.3g}")
    worst, n_noise, n_total = 0.0, 0, 0
    same_selection = not bool(differ.any())
    for name, p in cpu.params.items():
        p_g, m_abs = gpu0["params"][name], gpu0["mu"][name].abs()
        noise = (m_abs > 0) & (m_abs <= NOISE * m_abs.max())
        diff = (p.detach() - p_g).abs()
        n_noise += int(noise.sum())
        n_total += p.numel()
        if same_selection:
            tight = 1e-6 + 1e-5 * p_g.abs()
            check(bool(torch.all(diff[~noise] <= tight[~noise])),
                  f"replay: params {name} differ")
        check(bool(torch.all(diff <= 2 * LR)), f"replay: params {name} differ")
        worst = max(worst, float(diff.max()))
    print(f"replay round 0 on cpu ({wall:.2f} s): rho equal, selection equal "
          f"outside |delta-1/2|<{SELECTION_BAND} ({int(in_band.sum())} entries "
          f"in the band, {int(differ.sum())} differ), sigma max rel err "
          f"{sig_rel:.3g}, net_cost gpu {gpu0['net_cost']:.6f} cpu "
          f"{dec.net_cost:.6f}, params max abs err {worst:.3g} "
          f"({n_noise}/{n_total} entries with a first moment at float32 "
          f"noise held at 2*lr)")


def profile_round(torch, tr, i):
    """One round under torch.profiler: device operations and busy time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m = tr.run_round(i)
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    kernels = sorted({e.name for e in dev if "gradnorm" in e.name})
    print(f"round {i} under the profiler: {len(dev)} device operations, "
          f"device busy {busy_ms:.3f} ms of wall {wall * 1e3:.3f} ms, device "
          f"idle share {1 - busy_ms / (wall * 1e3):.4f}; stages "
          + " ".join(f"{k}={v * 1e3:.3f}ms" for k, v in m.stage_s.items())
          + f"; gradnorm kernels seen: {kernels}")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        die("no CUDA device: this smoke test needs an NVIDIA GPU")
    if not (ROOT / "src" / "repro_torch").is_dir():
        die(f"{ROOT / 'src' / 'repro_torch'} not found: run from a checkout "
            "of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch as rt
    import repro_torch.core  # noqa: F401
    import repro_torch.data  # noqa: F401
    import repro_torch.fed  # noqa: F401
    import repro_torch.models  # noqa: F401
    from repro_torch.core import matching, selection
    from repro_torch.kernels import gradnorm

    # -- 1. environment -------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmuls must run in full float32")

    # -- 2. build -------------------------------------------------------
    info = gradnorm.build()
    print(f"build: {info.path.name} in {info.seconds:.2f} s")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # -- 3. kernels against their plain versions ------------------------
    sigma_rec = phase_kernels(torch, gradnorm)

    # -- 4. the main path -----------------------------------------------
    t0 = time.perf_counter()
    data = make_data(rt)
    init_sd = rt.models.cnn.CNN(
        rt.models.cnn.CNNConfig(side=SIDE),
        generator=torch.Generator().manual_seed(0)).state_dict()
    tr = make_trainer(rt, torch, data, init_sd, "cuda")
    print(f"main path: K={K} N={N} Q={Q} d_hat={D_HAT} side={SIDE} "
          f"gp_steps={GP_STEPS}, setup "
          f"{time.perf_counter() - t0:.2f} s")
    gradnorm.reset_launch_counts()
    gpu0 = None
    for i in range(ROUNDS):
        m = tr.run_round(i, eval_now=i == ROUNDS - 1)
        st, dec = tr.last_state, tr.last_decision
        check(tuple(st.sigma.shape) == (K, D_HAT), "sigma shape")
        check(bool(torch.isfinite(st.sigma).all()), "sigma not finite")
        check(all(bool(torch.isfinite(p).all()) for p in tr.params.values()),
              "params not finite")
        check(m.n_selected > 0 and abs(m.net_cost) < float("inf"),
              "empty selection or non-finite net cost")
        check(gradnorm.LAUNCHES["gradnorm_sigma"] == i + 1,
              f"gradnorm_sigma launches {gradnorm.LAUNCHES} after round {i}")
        print(f"round {i}: wall {m.wall_s * 1e3:.3f} ms net_cost "
              f"{m.net_cost:.6f} n_selected {m.n_selected} swaps {m.swaps} "
              f"uploaded {m.n_uploaded} launches {dict(gradnorm.LAUNCHES)} "
              "stages " + " ".join(f"{k}={v * 1e3:.3f}ms"
                                   for k, v in m.stage_s.items())
              + ("" if m.test_acc is None else f" test_acc {m.test_acc:.4f}"))
        if i == 0:
            gpu0 = {"rho": dec.rho.copy(), "delta": dec.delta.cpu(),
                    "delta_cont": dec.delta_cont.cpu(),
                    "sigma": st.sigma.cpu(), "net_cost": dec.net_cost,
                    "params": host(tr.params),
                    "mu": host(tr.opt_state.mu), "state": st}
    launches = dict(gradnorm.LAUNCHES)
    check(launches["gradnorm_sigma"] == ROUNDS,
          f"gradnorm_sigma launched {launches} in {ROUNDS} rounds")

    # -- 5. replay round 0 on the CPU -----------------------------------
    phase_replay(rt, torch, data, init_sd, gpu0)

    # -- 6. where the time goes -----------------------------------------
    st0 = gpu0["state"]
    for name, fn in (
            ("matching (host, float64)",
             lambda: matching.swap_matching(tr.sys, st0.h, st0.alpha)),
            (f"selection ({GP_STEPS} GP steps)",
             lambda: selection.solve_selection(tr.sys, st0.sigma,
                                               st0.sigma_mask,
                                               steps=GP_STEPS))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        print(f"decision stage, round 0 inputs: {name} "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
    profile_round(torch, tr, ROUNDS)

    # -- 7. results -----------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "gradnorm_sigma", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gradnorm.cu",
        "replaces": "src/repro/kernels/gradnorm.py:62",
        "launches": launches["gradnorm_sigma"],
        "max_abs_err": sigma_rec["max_abs_err"], "ms": sigma_rec["ms"],
        "plain_ms": sigma_rec["plain_ms"], "bound_ms": sigma_rec["bound_ms"],
        "bound_by": sigma_rec["bound_by"], "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
