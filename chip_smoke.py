#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU
and the CUDA toolkit.  Phases, each of which fails the run (non-zero
exit) if anything in it fails; no failure is caught:

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: ``kernels/csrc/gradnorm.cu``, ``kernels/csrc/flash_attention.cu``
   (fp32), ``kernels/csrc/flash_attention_sm90.cu`` (bf16, tensor cores)
   and ``kernels/csrc/lru_scan.cu`` compiled with nvcc for sm_90a, one
   nvcc each, started together; ptxas's register and spill lines;
3. kernels: each CUDA entry point against its plain PyTorch version on
   the card, at the test shapes and at the main paths' shapes, with
   device times (CUDA events over a CUDA graph of back-to-back calls),
   the plain version's time, a one-call PyTorch equivalent where one
   exists (for flash attention ``scaled_dot_product_attention``, with
   ``enable_gqa`` at the GQA serving shape; nothing in the port calls
   it), and the least time the card could take (bytes or operations);
   bf16 flash also on views offset by one element (d = 20 and the GQA
   serving shape), which TMA cannot read in place and the wrapper pads
   into an aligned copy; bf16 flash at gemma3-12b's global shape (d =
   256); bf16 flash at the zoo's newer prefill shapes, stablelm-12b's
   (d = 160, 32:8 GQA), command-r-35b's (d = 128, 64:8 GQA) and
   deepseek's latent attention (128 heads, q and k at d = 192, v at dv
   = 128, which the wrapper zero-pads to d; the padding copy timed
   alone, and the same heads at d = dv = 128 beside them), and fp32
   flash at the zoo replays' shapes (d = 160; d = 192 with dv = 128),
   every flash case with % of bound; the scan, fp32 and bf16, also at the seams of its
   chunk of L
   steps (S of 1, L - 1, L, L + 1; C of 1 and 130; a view 4 bytes past
   a 16-byte boundary; a batch of 70000; gates in (0.999, 1) at S =
   2048), every case called twice and bit-identical, and timed at
   mamba's (4, 2048, 131072), recurrentgemma-9b's (4, 2048, 4096) and
   the same at batch 1, with % of bound and GB/s;
4. FEEL path: 3 untraced rounds of the paper's §VI-A setup (K=10, N=5,
   Q=2, D̂=200, 28x28 images, faithful selection with 400 GP steps)
   through ``FEELTrainer.run_round``, which scores sigma through the
   kernel;
5. replay: round 0 again with the port on the CPU, held against the
   card's round 0;
6. where the time goes: the decision's matching and selection timed
   alone, and one more round under ``torch.profiler``;
7. serving path: ``repro_torch.launch.serve.serve`` on llama3.2-3b at
   full width and depth (28 layers, random weights from a seed), batch
   4, prompt length 2048, 32 greedy tokens; prefill attention goes
   through the bf16 flash kernel, reading the (B, S, H, d) q and
   (B, S, Hk, d) K/V in place, 28 launches per prefill and none in
   decode; then one prefill and one decode step under ``torch.profiler``;
8. LLM replay: llama3.2-3b at full width cut to 2 layers, in fp32 with
   TF32 off, the same weights on the card and on the CPU: prefill
   logits of a 256-token prompt and 8 greedy steps; the card's prefill
   runs the fp32 flash kernel, one launch per layer;
9. mamba serving path: ``serve`` on falcon-mamba-7b at full width and
   depth (64 mamba layers, 7,272,665,088 parameters), batch 4, prompt
   length 2048, 32 greedy tokens; each layer's prefill recurrence goes
   through the scan kernel, 64 launches per prefill and none in decode;
   then one prefill and one decode step under ``torch.profiler``;
10. mamba replay: falcon-mamba-7b at full width cut to 2 layers, fp32,
   TF32 off, the same weights on the card and on the CPU: prefill
   logits and each layer's SSM state after a 256-token prompt, and 8
   greedy steps;
11. schemes: 3 rounds of each of baselines 1-4 at phase 4's setup
   through ``FEELTrainer.run_round`` (sigma through the kernel, one
   launch a round; random half or all samples; greedy min- or max-gain
   RBs; closed-form powers), then baseline 1's round 0 replayed on the
   CPU;
12. CCP power (Algorithm 3): (a) paper Fig. 3 on phase 4's round-0
   channel: 5 random feasible starts on its closed-form matching, each
   trajectory, the spread of the finals, their gap to the closed form,
   ms per ``ccp_power`` call, and the Newton step's derivatives in
   closed form against ``torch.func``; (b) one proposed round with the
   CCP evaluator in the matching, and its replay on the CPU;
13. traced rounds: 3 proposed rounds and 1 baseline-4 round of phase 4's
   setup with everything on (a ``repro_torch.obs`` file sink with
   profiling and ``torch.profiler`` annotation, a metrics registry, a
   convergence monitor).  Checks: every required stage in each round;
   the span tree whole, each child inside its parent's time; the stages
   between 0.5x (the round's profiling calls aside) and 1.01x the round
   wall; ``gradnorm_sigma`` once a round plus once per profiling call;
   the ``sigma_all`` profile's FLOPs are the flop counter's plus the
   kernel's own count (``gradnorm.cost``); round 0 decides as phase 4's
   untraced round 0 under phase 5's replay rule; the trace file
   round-trips through ``load_trace`` and ``summarize``.  Prints the
   per-stage medians, the top span self-times, each profile's FLOPs,
   bytes and FLOP/s against ``peak_flops()``, and each traced round's
   wall beside an untraced trainer's same round (run in turns with it,
   checked to call ``torch.cuda.synchronize`` not once) and phase 4's.  Phase 4's untraced rounds call
   ``torch.cuda.synchronize`` not once (checked); phases 11-12 read
   their stage times from an in-memory sink;
14. resilience: phase 4's setup under ``CHAOS_SPEC`` with seed 2 (the
   plan draws dropouts and NaN uploads in every round and fails the
   matching in rounds 1 and 2 and the power in round 1; on the CPU only
   round 1's NaN devices upload, and all three are quarantined) and ``ResilienceConfig(quarantine_threshold=1,
   checkpoint_every=2)``, with cuDNN set to deterministic algorithms
   (``torch.backends.cudnn.deterministic = True``, ``benchmark =
   False``) for its trainers: (a) 4 fault rounds on the card, each
   one's wall, drops, retries, quarantined devices and fallbacks, the
   checkpoint writes' ms; finite params, ``matching->greedy`` taken, a
   quarantine, ``gradnorm_sigma`` once a round; (b) a fresh trainer on
   the card resumes the round-2 checkpoint and runs rounds 2-3, its
   params, Adam moments and count bit-identical to (a)'s; (c) a CPU
   trainer resumes the same checkpoint, which the card wrote, and runs
   round 2, held against the card's round 2 under phase 5's replay rule
   with the same drops, retries, quarantine, fallbacks and fault
   records; (b') the same card resume once more with cuDNN's default
   (non-deterministic) algorithms, reporting whether it stays
   bit-identical;
15. recurrentgemma-9b serving path: ``serve`` at full width and depth
   (26 rglru and 12 sliding-window layers, 10,444,771,328 parameters),
   phase 7's request; each rglru layer's prefill recurrence goes through
   the scan kernel at (4, 2048, 4096), 26 launches per prefill and none
   in decode; local attention is plain torch, and decode from position
   2048 on wraps the 2048-slot rolling buffers; the same request at
   batch 1, 26 scan launches per prefill at (1, 2048, 4096); then one
   prefill and one decode step under ``torch.profiler``;
16. gemma3-12b serving path: ``serve`` at full width and depth (40
   local and 8 global layers, qk-norm, 12,772,052,736 parameters),
   phase 7's request; each global layer's prefill attention goes through
   the bf16 flash kernel at d = 256, 8 launches per prefill and none in
   decode; the 2048-token prompt crosses the 1024 window; then one
   prefill and one decode step under ``torch.profiler``;
17. hybrid replays: recurrentgemma-9b cut to one pattern (3 layers) and
   gemma3-12b cut to one pattern (6 layers), each at full width with the
   window cut to 128 so that the 256-token prompt crosses it and decode
   wraps the rolling buffers, fp32 with TF32 off, the same weights on
   the card and on the CPU: prefill logits, each rglru layer's state and
   8 greedy steps;
18. stablelm-12b serving path: ``serve`` at full width and depth (40
   layers, 12,142,924,800 parameters), phase 7's request; each layer's
   prefill attention goes through the bf16 flash kernel at d = 160, 40
   launches per prefill and none in decode; then one prefill and one
   decode step under ``torch.profiler``;
19. command-r-35b serving path: the same at full width and depth (40
   layers, 32,380,690,432 parameters, ~60 GiB of bf16 weights), 40 flash
   launches per prefill at 64:8 GQA, with its peak memory; profiled;
20. deepseek-v2-236b serving path at full width cut to 8 layers (its
   dense layer and 7 MoE layers of 160 experts, 29,556,294,656
   parameters), phase 7's request: each layer's prefill latent attention
   goes through the bf16 flash kernel (q, k at d = 192, v at 128), 8
   launches per prefill and none in decode; the MoE dispatch's C and the
   dropped (token, expert) pairs per layer; decode once naive and once
   absorbed (``mla_absorbed``), from the same prefill (same seed, the
   same first token checked), both token rows and ms per step;
   profiled;
21. deepseek-v3-671b serving path at full width cut to 4 layers (its 3
   dense layers and 1 MoE layer of 256 experts, 15,111,101,440
   parameters), 4 flash launches per prefill; profiled;
22. zoo replays: stablelm-12b and deepseek-v2-236b at full width cut to
   2 layers (deepseek: the dense layer and one MoE layer, ~22 GB of fp32
   weights), fp32 with TF32 off: prefill logits through the fp32 flash kernel (d = 160; d = 192
   with dv = 128), deepseek's latent caches (``ckv``, ``kr``) of both
   layers, the MoE layer's routing equal (each token's top-k experts,
   each expert's tokens where the gate is > 0, with the smallest gap
   between the k-th and (k+1)-th router probability printed), and 8
   greedy steps, deepseek's on the naive and the absorbed path.

Every replay (8, 10, 17, 22) draws its weights on the card from a
seed, runs there, moves them to the host and runs again.  Launch counts
are zeroed just before each path (4, 7, 9, 11, 12b, 13,
14, both requests of 15, 16, 18, 19, both requests of 20, 21, and the
card's runs in 8, 10, 17 and 22) and read just after.  It prints one
``{"kernels": [...]}`` line, with one entry per kernel and serving shape
(the bf16 flash kernel at llama's, gemma3's, stablelm's, command-r's,
deepseek-v2's and deepseek-v3's, the last two at the one latent
attention shape, each with the launches of its own path: phase 20's
naive request and phase 21's; the scan at mamba's and at
recurrentgemma's at batch 4 and 1), and, last, the ``{"ok": true,
"device": ...}`` line.  Without a GPU, or without the repository's
``src/repro_torch`` beside it, it exits non-zero before printing
either.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# card peaks used for the bounds (H100 SXM data sheet, 700 W): HBM rate,
# float32 rate outside the tensor cores, dense bf16 tensor-core rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12

KERNEL_RTOL = 1e-5       # kernel vs plain, float32 sums in another order
TEST_SHAPES = [(10, 50), (300, 700), (8, 4096), (1000, 130)]
K, N, Q, D_HAT, SIDE, ROUNDS, GP_STEPS, LR = 10, 5, 2, 200, 28, 3, 400, 1e-3
SELECTION_BAND = 1e-3    # |delta† - 1/2| below this: a tie for Alg. 5
SIGMA_RTOL = 1e-4        # card vs CPU sigma (other conv algorithms)
NET_COST_RTOL = 1e-5
NOISE = 1e-6             # Adam first moment at float32 noise (see tests)
CCP_GAP = 5e-3           # CCP vs closed-form cost (the reference's bound)

# flash attention: the reference's kernel tests' shapes and tolerances
# (tests/test_kernels.py), and the serving path's shape
FLASH_TEST_SHAPES = [(4, 128, 64), (2, 200, 32), (3, 513, 128), (1, 64, 256)]
FLASH_EDGE_SHAPES = [(1, 130, 24), (2, 77, 20), (3, 1, 64), (1, 129, 256)]
# llama3.2-3b prefill as (B, S, H, Hk, Dh): heads folded into one (BH, S,
# d) batch as the reference's kernel takes them, and the serving path's
# GQA layout read in place; and the fp32 replay's layers (phase 8)
FLASH_SLICE = (96, 2048, 1, 1, 128)
FLASH_GQA = (4, 2048, 24, 8, 128)
FLASH_F32_REPLAY = (1, 256, 24, 8, 128)
FLASH_GEMMA = (4, 2048, 16, 8, 256)  # gemma3-12b's global layers
# the zoo's dense and latent-attention decoders (phases 18-22), as (B,
# S, H, Hk, d[, dv]): stablelm-12b (d = 160), command-r-35b (64:8 GQA),
# deepseek's multi-head latent attention (q, k at nope + rope = 192, v
# at 128, 128 heads) and their fp32 replays' shapes
FLASH_STABLELM = (4, 2048, 32, 8, 160)
FLASH_COMMAND_R = (4, 2048, 64, 8, 128)
FLASH_MLA = (4, 2048, 128, 128, 192, 128)
# the same heads at d = dv = 128: the columns a kernel with a value
# width of its own would still read for q k^T at MLA's shape, less 64
FLASH_MLA_D128 = (4, 2048, 128, 128, 128)
FLASH_F32_ZOO = [(1, 256, 32, 8, 160), (1, 256, 128, 128, 192, 128)]
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
ARCH, SERVE_BATCH, PROMPT, NEW_TOKENS = "llama3.2-3b", 4, 2048, 32
REPLAY_LAYERS, REPLAY_PROMPT, REPLAY_STEPS = 2, 256, 8
LOGITS_RTOL = 1e-4       # card vs CPU prefill logits, fp32 with TF32 off

# the linear-recurrence scan: the reference's kernel tests' shapes and
# tolerance (tests/test_kernels.py), and the mamba serving path's shape
SCAN_TEST_SHAPES = [(1, 17, 8), (2, 300, 130), (3, 256, 256), (2, 512, 64)]
SCAN_SLICE = (4, 2048, 8192 * 16)  # falcon-mamba-7b prefill: B, S, di*n
SCAN_RG = (4, 2048, 4096)          # recurrentgemma-9b prefill: B, S, w
SCAN_RG1 = (1, 2048, 4096)         # the same at batch 1
SCAN_TIMED = (SCAN_SLICE, SCAN_RG, SCAN_RG1)
SCAN_NEAR1 = (2, 2048, 256)        # gates in (0.999, 1)
SCAN_BIG_BATCH = (70000, 3, 5)     # a batch past 65535
SCAN_TOL = 1e-5
MAMBA, MAMBA_LAYERS, MAMBA_PARAMS = "falcon-mamba-7b", 64, 7_272_665_088
FAULT_ROUNDS, RESUME_AT = 4, 2  # phase 14: fault rounds, checkpoint round
RGEMMA, RGEMMA_PARAMS, RGEMMA_RGLRU = "recurrentgemma-9b", 10_444_771_328, 26
GEMMA, GEMMA_PARAMS, GEMMA_GLOBAL = "gemma3-12b", 12_772_052_736, 8
# phase 17: one pattern of each hybrid, the window cut below the prompt
HYBRID_WINDOW = 128
# phases 18-22: the dense configs at full depth; the DeepSeek configs at
# full width cut in depth (v2: its dense layer and 7 MoE layers; v3: its
# 3 dense layers and 1 MoE layer of 256 experts)
STABLELM, STABLELM_PARAMS, STABLELM_LAYERS = ("stablelm-12b", 12_142_924_800,
                                              40)
COMMAND_R, COMMAND_R_PARAMS, COMMAND_R_LAYERS = ("command-r-35b",
                                                 32_380_690_432, 40)
DSV2, DSV2_LAYERS, DSV2_PARAMS = "deepseek-v2-236b", 8, 29_556_294_656
DSV3, DSV3_LAYERS, DSV3_PARAMS = "deepseek-v3-671b", 4, 15_111_101_440


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


def bound(n_bytes: float, flops: float,
          peak_flops: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
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
    main_sigma = main_norm = None
    for n, f in TEST_SHAPES + [(rows, 84), (rows, 10)]:
        x = randn(n, f)
        got, want = gradnorm.rownorm2(x), gradnorm.rownorm2_plain(x)
        torch.cuda.synchronize()
        rel = max_rel(got, want)
        check(rel <= KERNEL_RTOL, f"rownorm2 {(n, f)}: rel err {rel:.3g}")
        flops, n_bytes = gradnorm.cost(n, f)
        b_ms, b_by = bound(n_bytes, flops)
        rec = {"max_abs_err": float((got - want).abs().max()),
               "ms": device_ms(torch, lambda: gradnorm.rownorm2(x)),
               "plain_ms": device_ms(torch,
                                     lambda: gradnorm.rownorm2_plain(x)),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": device_ms(torch,
                                       lambda: torch.linalg.vecdot(x, x))}
        print(f"rownorm2 ({n}, {f}): max_abs_err "
              f"{rec['max_abs_err']:.3g} max_rel_err {rel:.3g} | "
              f"device ms: kernel {rec['ms']:.6f} plain "
              f"{rec['plain_ms']:.6f} "
              f"vector_norm^2 {device_ms(torch, lambda: torch.linalg.vector_norm(x, dim=-1).square()):.6f} "
              f"vecdot {rec['library_ms']:.6f} "
              f"bound {b_ms:.6f} ({b_by}) | eager call ms: kernel "
              f"{call_ms(torch, lambda: gradnorm.rownorm2(x)):.6f}")
        if (n, f) == (rows, 84):
            main_norm = rec

    for n, f in TEST_SHAPES + [(rows, 84)]:
        h, d = randn(n, f), randn(n, 10)
        got = gradnorm.gradnorm_sigma(h, d)
        want = gradnorm.gradnorm_sigma_plain(h, d)
        torch.cuda.synchronize()
        rel = max_rel(got, want)
        check(rel <= KERNEL_RTOL, f"gradnorm_sigma {(n, f)}: rel err {rel:.3g}")
        flops, n_bytes = gradnorm.cost(n, f, 10)
        b_ms, b_by = bound(n_bytes, flops)
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
    return main_norm, main_sigma


def flash_bound(b: int, s: int, h: int, hk: int, d: int, causal: bool,
                itemsize: int, dv: int | None = None) -> tuple[float, str]:
    """Operations: 2 flops per multiply-add of q k^T (width d) and of p v
    (width dv, d by default) over the (query, key) pairs the mask keeps;
    bytes: q and k (width d), v (width dv; k and v with Hk heads) read
    and o (width dv) written once.  The peak is that of the input type:
    the dense bf16 tensor cores for bf16, the CUDA cores' float32 rate
    for float32."""
    dv = d if dv is None else dv
    pairs = s * (s + 1) / 2 if causal else s * s
    flops = 2.0 * b * h * (d + dv) * pairs
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_FP32_FLOPS
    n_bytes = b * s * (h * d + hk * d + hk * dv + h * dv) * itemsize
    return bound(n_bytes, flops, peak)


def phase_flash(torch, fa, ops):
    """The flash kernels against their plain versions at the test shapes,
    the edge shapes and the main paths' shapes; returns the records by
    (shape, dtype, layout).  Each case: (B, S, H, Hk, d[, dv]), dtype,
    causal, and whether it goes through the (BH, S, d) entry (H = Hk,
    folded) or the strided (B, S, H, d) one, there also as views one
    element past an aligned base ("bshd+1": q, k and v copied into
    aligned buffers).  A dv < d (latent attention) is a v of its own
    width, which the wrapper zero-pads to d."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    F = torch.nn.functional
    cases = [((bh, s, 1, 1, d), dt, True, "bhsd") for bh, s, d in
             FLASH_TEST_SHAPES for dt in ("float32", "bfloat16")]
    cases += [((2, 96, 1, 1, 64), dt, False, "bhsd")      # non-causal
              for dt in ("float32", "bfloat16")]
    cases += [((bh, s, 1, 1, d), "bfloat16", True, "bhsd")
              for bh, s, d in FLASH_EDGE_SHAPES]
    cases += [((2, 130, 3, 3, 32), "float32", True, "bshd"),
              (FLASH_SLICE, "bfloat16", True, "bhsd"),
              ((1, 77, 6, 2, 20), "bfloat16", True, "bshd+1"),
              (FLASH_GQA, "bfloat16", True, "bshd"),
              (FLASH_GQA, "bfloat16", True, "bshd+1"),
              (FLASH_GEMMA, "bfloat16", True, "bshd"),
              (FLASH_F32_REPLAY, "float32", True, "bshd"),
              (FLASH_STABLELM, "bfloat16", True, "bshd"),
              (FLASH_COMMAND_R, "bfloat16", True, "bshd"),
              (FLASH_MLA, "bfloat16", True, "bshd"),
              (FLASH_MLA_D128, "bfloat16", True, "bshd")]
    cases += [(shape, "float32", True, "bshd") for shape in FLASH_F32_ZOO]
    recs = {}
    for shape, dt, causal, layout in cases:
        dtype = getattr(torch, dt)
        b, s, h, hk, d = shape[:5]
        dv = shape[5] if len(shape) > 5 else d

        def randn(heads, width=d):
            off = int(layout == "bshd+1")
            x = torch.randn(b * s * heads * width + off, generator=gen,
                            device="cuda").to(dtype)
            return x[off:].view(b, s, heads, width)

        q4, k4, v4 = randn(h), randn(hk), randn(hk, dv)
        if layout == "bhsd":          # (B*H, S, d): b is B*H, h == 1
            q, k, v = (x[:, :, 0] for x in (q4, k4, v4))
            run = partial(fa.flash_attention, q, k, v, causal=causal)
            plain = partial(fa.flash_attention_plain, q, k, v, causal=causal)
            qs, ks, vs = (x[None] for x in (q, k, v))
        else:                         # (B, S, H, d), k/v with Hk heads
            q, k, v = q4, k4, v4
            run = partial(ops.flash_attention_bhsd, q, k, v, causal=causal)
            plain = partial(fa.flash_attention_bhsd_plain, q, k, v,
                            causal=causal)
            qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = FLASH_TOL[dt]
        check(bool(torch.allclose(got.float(), want.float(), atol=tol,
                                  rtol=tol)),
              f"flash_attention {layout} {shape} {dt} causal={causal}: max "
              f"abs err {err:.3g} above {tol}")
        del got, want
        big = s >= 1024
        calls, replays = (5, 3) if big else (50, 5)
        b_ms, b_by = flash_bound(b, s, h, hk, d, causal, q.element_size(),
                                 dv)
        rec = {"max_abs_err": err,
               "ms": device_ms(torch, run, calls, replays),
               "plain_ms": device_ms(torch, plain, *((2, 2) if big else
                                                     (calls, replays))),
               "library_ms": device_ms(
                   torch, lambda: F.scaled_dot_product_attention(
                       qs, ks, vs, is_causal=causal, enable_gqa=hk != h),
                   calls, replays),
               "bound_ms": b_ms, "bound_by": b_by}
        print(f"flash_attention {layout} {shape} {dt} causal={causal}: "
              f"max_abs_err {err:.3g} (tol {tol}) | device ms: kernel "
              f"{rec['ms']:.6f} plain {rec['plain_ms']:.6f} sdpa "
              f"{rec['library_ms']:.6f} bound {b_ms:.6f} ({b_by}) | "
              f"kernel/bound {rec['ms'] / b_ms:.2f}x ({100 * b_ms / rec['ms']:.1f} "
              f"% of bound) kernel/sdpa {rec['ms'] / rec['library_ms']:.2f}x")
        if dv < d:
            pad_ms = device_ms(torch, lambda: fa._value_operand(v, d),
                               calls, replays)
            print(f"  of which v zero-padded from {dv} to {d} columns "
                  f"before the launch: {pad_ms:.6f} ms")
        recs[(shape, dt, layout)] = rec
        del q, k, v, q4, k4, v4, qs, ks, vs
        torch.cuda.empty_cache()
    return recs


def scan_cases(lru):
    """Phase 3's scan checks as (shape, dtype, gates, offset): the
    reference's test shapes, S at the chunk's seams (1, L - 1, L, L + 1
    for the schedule's L = W * P) at a narrow C, C of 1 and 130, a
    contiguous view ``offset`` elements (4 bytes) past a 16-byte
    boundary, a batch past the old grid's 65535, gates in (0.999, 1) at
    S = 2048, in fp32 and bf16; then the three serving shapes in fp32."""
    chunk = lru.WARPS * lru.STEPS
    shapes = SCAN_TEST_SHAPES + [(2, s, 8) for s in (1, chunk - 1, chunk,
                                                     chunk + 1)] + [
        (3, chunk + 1, 1), SCAN_BIG_BATCH]
    cases = []
    for dt in ("float32", "bfloat16"):
        cases += [(shape, dt, "uniform", 0) for shape in shapes]
        cases += [((2, 300, 130), dt, "uniform", 1 if dt == "float32" else 2),
                  (SCAN_NEAR1, dt, "near1", 0)]
    return cases + [(shape, "float32", "uniform", 0) for shape in SCAN_TIMED]


def scan_inputs(torch, gen, shape, dt, gates, offset):
    """a in (0, 1) (``gates="near1"``: in (0.999, 1)) and b normal, as
    contiguous views ``offset`` elements into their buffers."""
    n = math.prod(shape)
    lo = 0.999 if gates == "near1" else 0.0
    a = lo + (1.0 - lo) * torch.rand(n + offset, generator=gen,
                                     device="cuda")
    b = torch.randn(n + offset, generator=gen, device="cuda")
    dtype = getattr(torch, dt)
    return (a.to(dtype)[offset:].view(shape),
            b.to(dtype)[offset:].view(shape))


def scan_bound(shape, itemsize):
    """a and b read once and h (fp32) written once (bytes); 2 flops per
    element on the fp32 CUDA cores.  Returns (ms, bound_by, bytes)."""
    n = math.prod(shape)
    n_bytes = n * (2 * itemsize + 4)
    return (*bound(n_bytes, 2.0 * n), n_bytes)


def phase_scan(torch, lru, ops):
    """The scan kernel against its plain version (``scan_cases``): each
    within SCAN_TOL, the a == 0 identity exact, two calls bit-identical;
    and the three serving shapes timed.  Gates in (0.999, 1) over 2048
    steps are held at rtol SCAN_TOL with an atol of SCAN_TOL times the
    largest |h|: there two sequential fp32 loops (the reference's jnp
    scan and the plain version) already differ above 1e-5 where h
    crosses 0, within 1e-5 of max |h| (tests/test_torch_scan_split.py).
    Returns the serving shapes' records, by shape.  No one PyTorch call
    computes the recurrence, so there is no library time."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    recs = {}
    for shape, dt, gates, offset in scan_cases(lru):
        a, b = scan_inputs(torch, gen, shape, dt, gates, offset)
        got = ops.lru_scan(a, b)
        again = ops.lru_scan(a, b)
        want = lru.lru_scan_plain(a, b)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        atol = SCAN_TOL * (float(want.abs().max()) if gates == "near1"
                           else 1.0)
        label = (f"lru_scan {shape} {dt}"
                 + (" a in (0.999, 1)" if gates == "near1" else "")
                 + (f" view {offset * a.element_size()} bytes off 16"
                    if offset else ""))
        check(bool(torch.allclose(got, want, atol=atol, rtol=SCAN_TOL)),
              f"{label}: max abs err {err:.3g} above atol {atol:.3g}, "
              f"rtol {SCAN_TOL}")
        check(bool(torch.equal(got, again)),
              f"{label}: two calls are not bit-identical")
        del got, again, want
        ident = lru.lru_scan(torch.zeros_like(a), b)
        check(bool(torch.equal(ident, b.float())),
              f"{label}: a == 0 is not the identity on b")
        del ident
        msg = (f"{label}: max_abs_err {err:.3g} (atol {atol:.3g}, rtol "
               f"{SCAN_TOL}), bit-identical, a == 0 identity exact")
        if shape in SCAN_TIMED:
            b_ms, b_by, n_bytes = scan_bound(shape, a.element_size())
            big = shape == SCAN_SLICE
            rec = {"max_abs_err": err,
                   "ms": device_ms(torch, lambda: lru.lru_scan(a, b),
                                   *((5, 3) if big else (50, 5))),
                   "plain_ms": device_ms(
                       torch, lambda: lru.lru_scan_plain(a, b),
                       *((1, 2) if big else (5, 3))),
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
            msg += (f" | device ms: kernel {rec['ms']:.6f} plain "
                    f"{rec['plain_ms']:.6f} bound {b_ms:.6f} ({b_by}) | "
                    f"{100 * b_ms / rec['ms']:.1f} % of bound, "
                    f"{n_bytes / rec['ms'] / 1e6:.1f} GB/s")
            recs[shape] = rec
        print(msg)
        del a, b
    torch.cuda.empty_cache()
    return recs


def make_data(rt):
    train = rt.data.SyntheticImages.make(6000, side=SIDE, seed=0)
    test = rt.data.SyntheticImages.make(1500, side=SIDE, seed=1)
    return rt.data.non_iid_split(train, test, K=K, per_device=600,
                                 mislabel_prop=0.1, seed=0)


def make_trainer(rt, torch, data, state_dict, device, telemetry=None,
                 monitor=False, faults=None, resilience=None, **options):
    """A trainer at the §VI-A setup; ``telemetry``: an ``obs`` sink;
    ``monitor``: attach a ``ConvergenceMonitor`` writing to that sink
    and to the process-default metrics registry; ``faults`` and
    ``resilience``: the trainer's fault plan and resilience policies."""
    cfg = rt.fed.FEELConfig(d_hat=D_HAT, gp_steps=GP_STEPS, lr=LR, **options)
    model = rt.models.cnn.CNN(rt.models.cnn.CNNConfig(side=SIDE))
    model.load_state_dict(state_dict)
    sys_ = rt.core.default_system(K=K, N=N, Q=Q, D_hat=D_HAT, device=device)
    mon = (rt.obs.ConvergenceMonitor(sys_, telemetry=telemetry,
                                     registry=rt.obs.metrics.get_default())
           if monitor else None)
    return rt.fed.FEELTrainer(sys_, data, model, cfg, telemetry=telemetry,
                              monitor=mon, faults=faults,
                              resilience=resilience)


def host(tensors):
    return {n: t.detach().cpu().clone() for n, t in tensors.items()}


def round_record(tr):
    """What a replay holds the card's round against."""
    st, dec = tr.last_state, tr.last_decision
    return {"rho": dec.rho.copy(), "delta": dec.delta.cpu(),
            "delta_cont": (None if dec.delta_cont is None
                           else dec.delta_cont.cpu()),
            "sigma": st.sigma.cpu(), "net_cost": dec.net_cost,
            "params": host(tr.params), "mu": host(tr.opt_state.mu),
            "state": st}


def check_same_decision(torch, want, dec, label):
    """The replay rule: the same RB assignment; a faithful selection may
    differ only where one side's continuous GP point lies within
    SELECTION_BAND of 1/2, any other selection must be equal; net cost
    at NET_COST_RTOL.  ``want``: a ``round_record``; ``dec``: a
    ``RoundDecision``.  Returns (entries that differ, entries in the
    band)."""
    check(bool((dec.rho == want["rho"]).all()),
          f"{label}: RB assignment differs")
    cont_w = want["delta_cont"]
    differ = want["delta"] != dec.delta.cpu()
    if cont_w is None:
        in_band = torch.zeros_like(differ)
    else:
        in_band = ((cont_w - 0.5).abs() < SELECTION_BAND) | (
            (dec.delta_cont.cpu() - 0.5).abs() < SELECTION_BAND)
    check(not bool((differ & ~in_band).any()),
          f"{label}: selection differs outside the band around 1/2")
    nc_rel = abs(dec.net_cost - want["net_cost"]) / abs(want["net_cost"])
    check(nc_rel <= NET_COST_RTOL, f"{label}: net cost rel err {nc_rel:.3g}")
    return differ, in_band


def phase_replay(rt, torch, data, init_sd, gpu0, label="", **options):
    """Round 0 on the CPU against the card's round 0 (same trainer
    ``options``), under ``check_same_decision``'s rule; sigma and params
    are held too."""
    cpu = make_trainer(rt, torch, data, init_sd, "cpu", **options)
    t0 = time.perf_counter()
    cpu.run_round(0)
    wall = time.perf_counter() - t0
    dec = cpu.last_decision
    differ, in_band = check_same_decision(torch, gpu0, dec,
                                          f"replay{label}")
    sig_rel = max_rel(gpu0["sigma"], cpu.last_state.sigma)
    check(sig_rel <= SIGMA_RTOL, f"replay{label}: sigma rel err {sig_rel:.3g}")
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
                  f"replay{label}: params {name} differ")
        check(bool(torch.all(diff <= 2 * LR)),
              f"replay{label}: params {name} differ")
        worst = max(worst, float(diff.max()))
    print(f"replay{label} round 0 on cpu ({wall:.2f} s): rho equal, "
          f"selection equal "
          f"outside |delta-1/2|<{SELECTION_BAND} ({int(in_band.sum())} entries "
          f"in the band, {int(differ.sum())} differ), sigma max rel err "
          f"{sig_rel:.3g}, net_cost gpu {gpu0['net_cost']:.6f} cpu "
          f"{dec.net_cost:.6f}, params max abs err {worst:.3g} "
          f"({n_noise}/{n_total} entries with a first moment at float32 "
          f"noise held at 2*lr)")


def stage_ms(obs, tele, i):
    """{stage: ms} of round ``i`` in the sink's events."""
    return {e.stage: e.dur_s * 1e3 for e in tele.events
            if isinstance(e, obs.StageEvent) and e.round == i}


def print_round(label, i, m, obs=None, tele=None):
    stages = "" if tele is None else " stages " + " ".join(
        f"{k}={v:.3f}ms" for k, v in stage_ms(obs, tele, i).items())
    print(f"{label} round {i}: wall {m.wall_s * 1e3:.3f} ms net_cost "
          f"{m.net_cost:.6f} n_selected {m.n_selected} swaps {m.swaps} "
          f"uploaded {m.n_uploaded}" + stages)


def check_assignment(rho, alpha, label):
    """Definition 1 / constraints (12)-(14): each available device at
    most one RB, each RB at most Q devices, no RB for an unavailable
    device."""
    per_dev, per_rb = rho.sum(axis=1), rho.sum(axis=0)
    avail = alpha > 0
    check(bool((per_dev[avail] <= 1).all()) and bool((per_dev[~avail] == 0)
                                                     .all()),
          f"{label}: a device holds more than one RB or is unavailable")
    check(bool((per_rb <= Q).all()), f"{label}: an RB holds more than {Q}")


def phase_schemes(rt, torch, data, init_sd, kernels, gradnorm):
    """Baselines 1-4 on the card, 3 rounds each; returns the launches of
    the 12 rounds and baseline 1's round-0 record."""
    for m in kernels:
        m.reset_launch_counts()
    base1 = None
    for b in (1, 2, 3, 4):
        scheme = f"baseline{b}"
        tele = rt.obs.Telemetry()  # in memory: the stage times
        tr = make_trainer(rt, torch, data, init_sd, "cuda", telemetry=tele,
                          scheme=scheme)
        want_sel = K * (D_HAT // 2 if b in (1, 2) else D_HAT)
        start = gradnorm.LAUNCHES["gradnorm_sigma"]
        walls = []
        for i in range(ROUNDS):
            m = tr.run_round(i)
            walls.append(m.wall_s)
            st, dec = tr.last_state, tr.last_decision
            check(all(bool(torch.isfinite(p).all())
                      for p in tr.params.values()),
                  f"{scheme}: params not finite")
            check(m.n_selected == want_sel, f"{scheme}: n_selected "
                  f"{m.n_selected}, expected {want_sel}")
            check(gradnorm.LAUNCHES["gradnorm_sigma"] == start + i + 1,
                  f"{scheme}: gradnorm_sigma launches "
                  f"{gradnorm.LAUNCHES['gradnorm_sigma'] - start} after "
                  f"round {i}")
            check_assignment(dec.rho, st.alpha.cpu().numpy(), scheme)
            print_round(scheme, i, m, rt.obs, tele)
            if b == 1 and i == 0:
                base1 = round_record(tr)
        print(f"{scheme}: {ROUNDS} rounds, gradnorm_sigma launches "
              f"{gradnorm.LAUNCHES['gradnorm_sigma'] - start}, wall ms per "
              f"round {[round(w * 1e3, 3) for w in walls]}")
        del tr
    launches = {k: v for m in kernels for k, v in m.LAUNCHES.items()}
    check(launches == {"rownorm2": 0, "gradnorm_sigma": 4 * ROUNDS,
                       "flash_attention": 0, "lru_scan": 0},
          f"launches on the schemes' path {launches}")
    print(f"schemes path launches: {launches}")
    return launches, base1


def phase_ccp_fig3(rt, torch, sys_, st0):
    """Paper Fig. 3 on the card's setup: 5 random feasible starts on the
    closed-form matching of phase 4's round-0 channel."""
    import numpy as np
    power, matching = rt.core.power, rt.core.matching
    res = matching.swap_matching(sys_, st0.h, st0.alpha)
    rho = torch.as_tensor(res.rho, device="cuda")
    p_cf, _ = power.closed_form_power(sys_, rho, st0.h, st0.alpha)
    cost_cf = float(power.upload_cost(sys_, p_cf, rho))
    rng = np.random.default_rng(7)
    finals, ms = [], []
    for i in range(5):
        scale = float(rng.uniform(1.2, 4.0))
        p0 = torch.minimum(p_cf * scale,
                           sys_.p_max[:, None] * rho * (1 - 1e-4))
        t0 = time.perf_counter()
        out = power.ccp_power(sys_, rho, st0.h, st0.alpha, p0=p0)
        ms.append((time.perf_counter() - t0) * 1e3)
        check(out.feasible and out.p.device.type == "cuda",
              "ccp_power: infeasible or powers off the card")
        gap = abs(out.trajectory[-1] - cost_cf) / cost_cf
        check(gap <= CCP_GAP, f"ccp start {i}: final {out.trajectory[-1]} "
              f"is {gap:.3g} from the closed form {cost_cf}")
        finals.append(out.trajectory[-1])
        print(f"ccp start {i} (scale {scale:.4f}): iterations "
              f"{out.iterations} trajectory {[float(x) for x in out.trajectory]}"
              f" gap to closed form {gap:.3g} | {ms[-1]:.3f} ms")
    spread = (max(finals) - min(finals)) / max(finals)
    check(spread <= CCP_GAP, f"ccp finals spread {spread:.3g}")
    print(f"ccp Fig. 3: {int(rho.sum())} active devices, closed form "
          f"{cost_cf:.9g}, finals spread {spread:.3g}, ms per ccp_power call "
          f"{[round(x, 3) for x in ms]} (mean {sum(ms) / len(ms):.3f})")

    # the Newton step's derivatives: closed form against torch.func
    s64 = power.system64(sys_)
    rho64, h64, alpha64, p_cf64 = (power.host64(a)
                                   for a in (rho, st0.h, st0.alpha, p_cf))
    sub = power.subproblem(s64, rho64, h64, alpha64).linearize(p_cf64 * 1.5)
    x = p_cf64[sub.ki, sub.ni] * 1.2
    t = 10.0 / float(np.sum(sub.cost_grad * x))

    def phi(z):
        return sub.phi(z, t)

    def by_func():
        xt = torch.from_numpy(x)
        return torch.func.grad(phi)(xt), torch.func.hessian(phi)(xt)

    (g, hs), (g2, h2) = sub.derivatives(x, t), by_func()
    err = max(float(np.abs(g - g2.numpy()).max() / np.abs(g).max()),
              float(np.abs(hs - h2.numpy()).max() / np.abs(hs).max()))
    check(err <= 1e-9, f"ccp derivatives differ from torch.func: {err:.3g}")
    us = {}
    for name, fn in (("closed form", lambda: sub.derivatives(x, t)),
                     ("torch.func", by_func)):  # one warm call each
        t0 = time.perf_counter()
        fn()
        us[name] = (time.perf_counter() - t0) * 1e6
    print(f"ccp Newton derivatives at {x.size} unknowns (host, float64, "
          "one warm call each): "
          + ", ".join(f"{k} {v:.1f} us" for k, v in us.items())
          + f"; max rel diff {err:.3g}")


def phase_ccp_round(rt, torch, data, init_sd, kernels, gradnorm):
    """One proposed round with the CCP evaluator on the card; returns its
    launches and round-0 record."""
    tele = rt.obs.Telemetry()  # in memory: the stage times
    tr = make_trainer(rt, torch, data, init_sd, "cuda", telemetry=tele,
                      power_evaluator="ccp")
    for m in kernels:
        m.reset_launch_counts()
    m = tr.run_round(0)
    launches = {k: v for mod in kernels for k, v in mod.LAUNCHES.items()}
    check(launches == {"rownorm2": 0, "gradnorm_sigma": 1,
                       "flash_attention": 0, "lru_scan": 0},
          f"launches on the CCP round {launches}")
    st, dec = tr.last_state, tr.last_decision
    check(all(bool(torch.isfinite(p).all()) for p in tr.params.values()),
          "ccp round: params not finite")
    check_assignment(dec.rho, st.alpha.cpu().numpy(), "ccp round")
    print_round("proposed+ccp", 0, m, rt.obs, tele)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = rt.core.matching.swap_matching(tr.sys, st.h, st.alpha,
                                         evaluator="ccp")
    wall = (time.perf_counter() - t0) * 1e3
    check(bool((res.rho == dec.rho).all()), "ccp matching not reproducible")
    print(f"ccp matching on round 0's inputs: {wall:.3f} ms, "
          f"{res.rb_evals} per-RB evaluations, {res.ccp_solves} CCP solves, "
          f"{res.swaps} swaps in {res.sweeps} sweeps, feasible "
          f"{res.feasible}; launches {launches}")
    return launches, round_record(tr)


class SyncCounter:
    """Counts ``torch.cuda.synchronize`` calls inside a ``with`` block."""

    def __init__(self, torch):
        self.cuda, self.n = torch.cuda, 0

    def __enter__(self):
        self.real = self.cuda.synchronize

        def counted(*args, **kwargs):
            self.n += 1
            return self.real(*args, **kwargs)

        self.cuda.synchronize = counted
        return self

    def __exit__(self, *exc):
        self.cuda.synchronize = self.real
        return False


def emit_us(obs, path, n=2000):
    """Host cost of one trace record: ``n`` stage records written (a JSON
    line and a flush each) to a scratch sink, in µs per record."""
    tele = obs.Telemetry(path=path)
    event = obs.StageEvent(stage="sigma", t0_s=1.25, dur_s=0.001, round=1,
                           span_id=7, parent_id=1)
    t0 = time.perf_counter()
    for _ in range(n):
        tele.emit(event)
    us = (time.perf_counter() - t0) * 1e6 / n
    tele.close()
    return us


def phase_traced(rt, torch, data, init_sd, kernels, gradnorm, gpu0,
                 untraced_walls):
    """3 proposed rounds and 1 baseline-4 round of phase 4's setup on the
    card with everything on: a file sink with profiling and annotation,
    a metrics registry and a convergence monitor; an untraced trainer's
    3 proposed rounds run in turns with them.  Returns the launches of
    all 7 rounds."""
    import statistics
    import tempfile

    obs = rt.obs
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    path = str(Path(tmp.name) / "trace.jsonl")
    tele = obs.Telemetry(path=path, profile=True, annotate=True,
                         meta={"source": "chip_smoke phase 13"})
    reg = obs.Registry()
    obs.metrics.set_default(reg)
    proposed = make_trainer(rt, torch, data, init_sd, "cuda",
                            telemetry=tele, monitor=True)
    base4 = make_trainer(rt, torch, data, init_sd, "cuda", telemetry=tele,
                         monitor=True, scheme="baseline4")
    # (trainer, round index): the baseline's round is numbered 3, so
    # every round of the trace has its own index
    runs = [(proposed, i) for i in range(ROUNDS)] + [(base4, ROUNDS)]
    # an untraced trainer's rounds interleaved with the traced ones (in
    # turns, which runs first), so the two walls share the host's load
    plain, plain_m = make_trainer(rt, torch, data, init_sd, "cuda"), []

    def run_plain(i):
        obs.metrics.set_default(None)
        with SyncCounter(torch) as sc:
            plain_m.append(plain.run_round(i, eval_now=i == ROUNDS - 1))
        obs.metrics.set_default(reg)
        check(sc.n == 0, f"untraced round {i} called "
              f"torch.cuda.synchronize {sc.n} times")

    for m in kernels:
        m.reset_launch_counts()
    work0 = dict(gradnorm.WORK)
    per_round, syncs, metrics = [], [], []
    for tr, i in runs:
        if tr is proposed and i % 2:
            run_plain(i)
        start = gradnorm.LAUNCHES["gradnorm_sigma"]
        with SyncCounter(torch) as sc:
            metrics.append(tr.run_round(i, eval_now=i == ROUNDS - 1))
        syncs.append(sc.n)
        per_round.append(gradnorm.LAUNCHES["gradnorm_sigma"] - start)
        if tr is proposed and i == 0:
            check_same_decision(torch, gpu0, tr.last_decision,
                                "traced round 0 against phase 4's")
        if tr is proposed and not i % 2:
            run_plain(i)
    launches = {k: v for m in kernels for k, v in m.LAUNCHES.items()}
    tele.close()
    obs.metrics.set_default(None)

    # -- checks ---------------------------------------------------------
    events = tele.events
    profiles = [e for e in events if isinstance(e, obs.ProfileEvent)]
    for (tr, i), n in zip(runs, per_round):
        n_prof = sum(p.name == "sigma_all" and p.round == i
                     for p in profiles)
        check(n == 1 + n_prof, f"traced round {i}: gradnorm_sigma "
              f"launched {n} times, {n_prof} of them profiling")
    check(launches == {"rownorm2": 0,
                       "gradnorm_sigma": sum(per_round) + ROUNDS,
                       "flash_attention": 0, "lru_scan": 0},
          f"launches on the traced and untraced rounds {launches}")
    kernel_flops, kernel_bytes = gradnorm.cost(K * D_HAT, 84, 10)
    check(gradnorm.WORK["flops"] - work0["flops"]
          == (sum(per_round) + ROUNDS) * kernel_flops, "gradnorm.WORK flops")
    rounds = [e for e in events if isinstance(e, obs.RoundEvent)]
    check([r.round for r in rounds] == [i for _, i in runs],
          f"round events {[r.round for r in rounds]}")
    for r in rounds:
        names = stage_ms(obs, tele, r.round)
        missing = set(obs.REQUIRED_STAGES) - set(names)
        check(not missing, f"traced round {r.round}: stages {missing} "
              "missing")
        total = sum(names.values()) / 1e3
        # a round that profiles a function pays for the counted call
        # outside its stages (the profile records that time)
        prof_s = sum(p.compile_s for p in profiles if p.round == r.round)
        check(0.5 * (r.wall_s - prof_s) <= total <= 1.01 * r.wall_s,
              f"traced round {r.round}: stages {total:.6f} s against a "
              f"round wall of {r.wall_s:.6f} s ({prof_s:.6f} s profiling)")
        print(f"traced round {r.round}: stages {total * 1e3:.3f} ms of the "
              f"round wall {r.wall_s * 1e3:.3f} ms, of which profiling "
              f"{prof_s * 1e3:.3f} ms")
    roots, orphans = obs.build_tree(events, strict=True)
    check(not orphans and [n.name for n in roots] == ["round"] * len(runs),
          f"span roots {[n.name for n in roots]}")
    n_spans = 0
    for root in roots:
        for node in root.walk():
            n_spans += 1
            for c in node.children:
                check(node.t0_s - 1e-6 <= c.t0_s
                      and c.end_s <= node.end_s + 1e-6,
                      f"span {c.path()} outside its parent's time")
    check(all(n >= len(obs.REQUIRED_STAGES) for n in syncs),
          f"traced rounds called torch.cuda.synchronize {syncs} times")
    sig_prof = [p for p in profiles if p.name == "sigma_all"]
    check(len(sig_prof) == 2, f"{len(sig_prof)} sigma_all profiles, "
          "expected one per trainer")
    # the profile's FLOPs: the forward's convolutions and matmuls as the
    # flop counter sees them, plus the kernel's own count
    from torch.utils.flop_counter import FlopCounterMode
    gen = torch.Generator(device="cuda").manual_seed(3)
    images = torch.rand((K, D_HAT, SIDE, SIDE), generator=gen,
                        device="cuda")
    labels = torch.randint(0, 10, (K, D_HAT), generator=gen, device="cuda")
    with FlopCounterMode(display=False) as fc:
        rt.fed.client.batched_sigma(proposed.model, images, labels)
    visible = fc.get_total_flops()
    for p in sig_prof:
        check(p.flops > 0 and p.flops == visible + kernel_flops,
              f"sigma_all profile: {p.flops} FLOPs, expected {visible} "
              f"+ the kernel's {kernel_flops}")
    records = obs.load_trace(path)
    check(records[0]["ev"] == "header"
          and records[1:] == [e.to_record() for e in events],
          "the trace file does not round-trip")
    summary = obs.summarize(records)
    check(summary.n_rounds == len(runs)
          and set(obs.REQUIRED_STAGES) <= set(summary.stages),
          "the trace's summary")
    for tr, _ in runs:
        check(all(bool(torch.isfinite(p).all()) for p in tr.params.values()),
              "traced rounds: params not finite")

    # -- report ---------------------------------------------------------
    stage_names = list(dict.fromkeys(
        e.stage for e in events if isinstance(e, obs.StageEvent)))
    for label, ids in (("proposed, rounds 1-2", range(1, ROUNDS)),
                       (f"baseline4, round {ROUNDS}", [ROUNDS])):
        med = {n: statistics.median(stage_ms(obs, tele, i).get(n, 0.0)
                                    for i in ids) for n in stage_names}
        print(f"traced {label}: per-stage median ms "
              + " ".join(f"{n}={v:.3f}" for n, v in med.items()))
    top = sorted(obs.self_seconds_by_path(events).items(),
                 key=lambda kv: -kv[1])[:10]
    print("traced span self time, top 10: " + "; ".join(
        f"{p} {v * 1e3:.3f} ms" for p, v in top))
    for p in profiles:
        per_call = statistics.median(stage_ms(obs, tele, i)[p.stage]
                                     for i in range(1, ROUNDS)) / 1e3
        rate = p.flops / per_call
        print(f"profile {p.name} (round {p.round}, stage {p.stage}): "
              f"{p.flops:.6g} FLOPs {p.bytes_accessed:.6g} bytes "
              f"({p.flops / max(p.bytes_accessed, 1.0):.3f} FLOP/byte), "
              f"counted call {p.compile_s * 1e3:.3f} ms; per call at the "
              f"median stage time of proposed rounds 1-2 "
              f"{per_call * 1e3:.3f} ms: {rate:.6g} "
              f"FLOP/s = {rate / p.peak_flops:.6f} of peak_flops() "
              f"{p.peak_flops:.6g}")
    n_rec = [sum(1 for e in events if getattr(e, "round", None) == i)
             for _, i in runs]
    us = emit_us(obs, str(Path(tmp.name) / "emit.jsonl"))
    for (tr, i), m, n, sc in zip(runs, metrics, n_rec, syncs):
        untraced = (f"untraced beside it {plain_m[i].wall_s * 1e3:.3f} ms "
                    f"(net_cost {plain_m[i].net_cost:.6f}), phase 4's "
                    f"{untraced_walls[i] * 1e3:.3f} ms"
                    if i < ROUNDS else "baseline4")
        print(f"traced round {i}: wall {m.wall_s * 1e3:.3f} ms ({untraced})"
              f"; {n} trace records ({n * us / 1e3:.3f} ms at {us:.2f} µs "
              f"each), {sc} torch.cuda.synchronize calls, net_cost "
              f"{m.net_cost:.6f}")
    mon = proposed.monitor.summary()
    print(f"traced: {n_spans} spans in {len(runs)} rounds, monitor "
          f"{mon['rounds']} rounds, bound_gap_ratio "
          f"{mon['bound_gap_ratio']}, violations {mon['violations']}, "
          f"{len(reg.snapshot())} metric families; launches {launches}")
    tmp.cleanup()
    return launches


def fault_records(obs, tele, i):
    """(kind, device) of round ``i``'s fault records, in order."""
    return [(e.kind, e.device) for e in tele.events
            if isinstance(e, obs.FaultEvent) and e.round == i]


def outside_stages_ms(obs, tele, i, wall_s):
    """Round ``i``'s wall less its top-level stages, in ms: the host
    work between them (the channel draw, the resilience bookkeeping,
    the checkpoint write)."""
    root = [e.span_id for e in tele.events if isinstance(e, obs.SpanEvent)
            and e.name == "round" and e.round == i]
    top = sum(e.dur_s for e in tele.events if isinstance(e, obs.StageEvent)
              and e.round == i and e.parent_id in root)
    return (wall_s - top) * 1e3


RESILIENCE_FIELDS = ("n_uploaded", "n_dropped", "n_retries", "n_quarantined",
                     "skipped_update", "fallbacks")


def phase_resilience(rt, torch, data, init_sd, kernels, gradnorm):
    """Phase 14: fault rounds, a checkpoint written on the card, resumed
    on the card (bit-identical), again under cuDNN's default algorithms
    (reported), and on the CPU (replay rule).  Returns the launches of
    the card's 8 rounds."""
    import dataclasses
    import shutil
    import tempfile

    obs, fed = rt.obs, rt.fed
    spec = dataclasses.replace(fed.CHAOS_SPEC, seed=2)
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    print(f"resilience: {FAULT_ROUNDS} rounds under {spec}; "
          "torch.backends.cudnn.deterministic=True benchmark=False for "
          "this phase's trainers")
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    res = fed.ResilienceConfig(quarantine_threshold=1, checkpoint_every=2,
                               checkpoint_dir=str(Path(tmp.name) / "run"))
    at2 = str(Path(tmp.name) / "at2")

    # (a) fault rounds on the card, a checkpoint every two rounds
    tele = obs.Telemetry()  # in memory: the fault records
    tr = make_trainer(rt, torch, data, init_sd, "cuda", telemetry=tele,
                      faults=spec, resilience=res)
    save_ms, real_save = [], tr.save_checkpoint

    def timed_save(*args, **kwargs):
        t0 = time.perf_counter()
        out = real_save(*args, **kwargs)
        save_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    tr.save_checkpoint = timed_save
    for m in kernels:
        m.reset_launch_counts()
    ms = []
    for i in range(FAULT_ROUNDS):
        m = tr.run_round(i, eval_now=i == FAULT_ROUNDS - 1)
        ms.append(m)
        check(all(bool(torch.isfinite(p).all()) for p in tr.params.values()),
              f"resilience round {i}: params not finite")
        check(gradnorm.LAUNCHES["gradnorm_sigma"] == i + 1,
              f"resilience: gradnorm_sigma launches {dict(gradnorm.LAUNCHES)}"
              f" after round {i}")
        print(f"resilience round {i}: wall {m.wall_s * 1e3:.3f} ms "
              f"(outside its stages "
              f"{outside_stages_ms(obs, tele, i, m.wall_s):.3f} ms) net_cost "
              f"{m.net_cost:.6f} uploaded {m.n_uploaded} dropped "
              f"{m.n_dropped} retries {m.n_retries} quarantined "
              f"{m.n_quarantined} fallbacks {list(m.fallbacks)} skipped "
              f"{m.skipped_update} faults {fault_records(obs, tele, i)} "
              "stages " + " ".join(f"{k}={v:.3f}ms" for k, v in
                                   stage_ms(obs, tele, i).items()))
        if i == RESUME_AT - 1:
            shutil.copytree(res.checkpoint_dir, at2)
        if i == RESUME_AT:
            card2 = round_record(tr)
            card2["m"] = m
            card2["faults"] = fault_records(obs, tele, i)
    kinds = [e.kind for e in tele.events if isinstance(e, obs.FaultEvent)]
    check(any("matching->greedy" in m.fallbacks for m in ms),
          "resilience: the matching->greedy fallback was never taken")
    check(kinds.count("quarantine") >= 1, "resilience: no quarantine")
    check(len(save_ms) == FAULT_ROUNDS // 2,
          f"resilience: {len(save_ms)} checkpoints written")
    print(f"resilience: {kinds.count('quarantine')} quarantines, "
          f"{kinds.count('nan_upload')} NaN uploads screened, "
          f"{kinds.count('dropout')} dropouts, {kinds.count('retry')} "
          f"retries; checkpoint writes {[round(x, 3) for x in save_ms]} ms "
          f"({sum(os.path.getsize(Path(at2) / f) for f in os.listdir(at2))}"
          " bytes)")

    # (b) a fresh trainer on the card resumes the round-2 checkpoint
    resumed = make_trainer(rt, torch, data, init_sd, "cuda", faults=spec,
                           resilience=res)
    check(resumed.resume(at2) == RESUME_AT, "resilience: resumed round")
    ms_b = resumed.run(FAULT_ROUNDS)
    launches = {k: v for mod in kernels for k, v in mod.LAUNCHES.items()}
    check(launches == {"rownorm2": 0,
                       "gradnorm_sigma": 2 * FAULT_ROUNDS - RESUME_AT,
                       "flash_attention": 0, "lru_scan": 0},
          f"launches on the resilience path {launches}")
    for a, b in zip(ms[RESUME_AT:], ms_b):
        check(all(getattr(a, f) == getattr(b, f) for f in RESILIENCE_FIELDS)
              and a.net_cost == b.net_cost,
              f"resilience: resumed round {b.round} differs: {b} vs {a}")
    same = all(torch.equal(tr.params[n], resumed.params[n])
               and torch.equal(tr.opt_state.mu[n], resumed.opt_state.mu[n])
               and torch.equal(tr.opt_state.nu[n], resumed.opt_state.nu[n])
               for n in tr.params)
    check(same and tr.opt_state.count == resumed.opt_state.count,
          "resilience: params or Adam state after the card's resume are not "
          "bit-identical to the uninterrupted run's")
    print(f"resilience resume on the card from round {RESUME_AT}: rounds "
          f"{[m.round for m in ms_b]} walls "
          f"{[round(m.wall_s * 1e3, 3) for m in ms_b]} ms; params, Adam "
          f"moments and count (={resumed.opt_state.count}) bit-identical; "
          f"launches {launches}")
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved

    # (b') the same resume under cuDNN's default algorithms: reported
    free = make_trainer(rt, torch, data, init_sd, "cuda", faults=spec,
                        resilience=res)
    check(free.resume(at2) == RESUME_AT, "resilience: resumed round")
    ms_f = free.run(FAULT_ROUNDS)
    launches = {k: v for mod in kernels for k, v in mod.LAUNCHES.items()}
    check(launches == {"rownorm2": 0,
                       "gradnorm_sigma": 3 * FAULT_ROUNDS - 2 * RESUME_AT,
                       "flash_attention": 0, "lru_scan": 0},
          f"launches on the resilience path {launches}")
    worst = max(float((tr.params[n] - free.params[n]).detach().abs().max())
                for n in tr.params)
    same_free = all(torch.equal(tr.params[n], free.params[n])
                    and torch.equal(tr.opt_state.mu[n], free.opt_state.mu[n])
                    and torch.equal(tr.opt_state.nu[n], free.opt_state.nu[n])
                    for n in tr.params)
    same_cost = all(a.net_cost == b.net_cost
                    for a, b in zip(ms[RESUME_AT:], ms_f))
    print(f"resilience resume on the card without cudnn.deterministic "
          f"(deterministic={torch.backends.cudnn.deterministic} benchmark="
          f"{torch.backends.cudnn.benchmark}): rounds "
          f"{[m.round for m in ms_f]} net_cost equal {same_cost}; params, "
          f"Adam moments bit-identical to the uninterrupted run's: "
          f"{same_free} (params max abs diff {worst:.3g})")

    # (c) the CPU resumes the checkpoint the card wrote
    tele_c = obs.Telemetry()
    cpu = make_trainer(rt, torch, data, init_sd, "cpu", telemetry=tele_c,
                       faults=spec, resilience=fed.ResilienceConfig(
                           quarantine_threshold=1))
    check(cpu.resume(at2) == RESUME_AT, "resilience: CPU resumed round")
    m_c = cpu.run_round(RESUME_AT)
    differ, in_band = check_same_decision(torch, card2, cpu.last_decision,
                                          "resilience replay")
    m_g = card2["m"]
    check(all(getattr(m_c, f) == getattr(m_g, f) for f in RESILIENCE_FIELDS),
          f"resilience replay: {m_c} against the card's {m_g}")
    check(fault_records(obs, tele_c, RESUME_AT) == card2["faults"],
          "resilience replay: fault records differ")
    print(f"resilience replay of round {RESUME_AT} on cpu from the card's "
          f"checkpoint ({m_c.wall_s:.2f} s): rho equal, selection equal "
          f"outside |delta-1/2|<{SELECTION_BAND} ({int(in_band.sum())} in "
          f"the band, {int(differ.sum())} differ), net_cost gpu "
          f"{m_g.net_cost:.6f} cpu {m_c.net_cost:.6f}, uploaded, drops, "
          f"retries, quarantine, fallbacks {list(m_c.fallbacks)} and "
          f"{len(card2['faults'])} fault records equal")
    tmp.cleanup()
    return launches


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
          f"idle share {1 - busy_ms / (wall * 1e3):.4f}, round wall "
          f"{m.wall_s * 1e3:.3f} ms; gradnorm kernels seen: {kernels}")


def phase_serve(torch, serve_mod, kernels, arch, expected, vocab,
                batch=SERVE_BATCH, **options):
    """A serving path at full width: one warm-up request (cuBLAS and
    kernel-module loading happen at first use), then the measured one
    with every launch count zeroed just before and read just after.
    ``arch``: a name (its full config) or an ``ArchConfig`` (a config
    cut in depth); ``expected``: the launches per phase and kernel the
    path must make; ``options``: more of ``serve``'s arguments.  Returns
    the measured run's launches and its ``ServeResult``."""
    name = arch if isinstance(arch, str) else arch.name
    warm = serve_mod.serve(arch, batch=batch, prompt_len=PROMPT,
                           new_tokens=2, smoke=False, seed=0, device="cuda",
                           **options)
    print(f"serve {name} warm-up: prefill {warm.prefill_s:.6f} s, decode "
          f"steps {[round(t * 1e3, 3) for t in warm.decode_s]} ms")
    del warm
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    for m in kernels:
        m.reset_launch_counts()
    res = serve_mod.serve(arch, batch=batch, prompt_len=PROMPT,
                          new_tokens=NEW_TOKENS, smoke=False, seed=0,
                          device="cuda", **options)
    launches = {k: v for m in kernels for k, v in m.LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated()
    check(res.launches == expected,
          f"{name}: launches per phase {res.launches}, expected {expected}")
    total = {k: 0 for k in launches}
    for phase in expected.values():
        for k, v in phase.items():
            total[k] += v
    check(launches == total, f"launches on the {name} path {launches}, "
          f"expected {total}")
    check(tuple(res.tokens.shape) == (batch, NEW_TOKENS + 1),
          f"tokens shape {tuple(res.tokens.shape)}")
    check(bool(((res.tokens >= 0) & (res.tokens < vocab)).all()),
          "tokens out of the vocabulary")
    steps = sorted(res.decode_s)
    print(f"serve {name} full width"
          f"{''.join(f', {k}={v}' for k, v in options.items())}: params "
          f"{res.n_params:,}, batch "
          f"{batch}, prompt {PROMPT}, {NEW_TOKENS} new tokens | "
          f"prefill {res.prefill_s:.6f} s "
          f"({batch * PROMPT / res.prefill_s:.1f} tok/s) | decode "
          f"ms/step mean {1e3 * sum(steps) / len(steps):.3f} median "
          f"{1e3 * steps[len(steps) // 2]:.3f} min {1e3 * steps[0]:.3f} "
          f"max {1e3 * steps[-1]:.3f} first {1e3 * res.decode_s[0]:.3f} | "
          f"peak memory {peak / 2**30:.3f} GiB ({before / 2**30:.3f} "
          f"allocated before the request) | launches {launches} "
          f"per phase {res.launches}"
          + (f" | MoE prefill dispatch (C, dropped) per layer "
             f"{res.moe_dispatch}" if res.moe_dispatch else ""))
    print(f"serve {name} tokens of sequence 0: {res.tokens[0].tolist()}")
    return launches, res


def phase_serve_profile(torch, tm, get_config, arch):
    """Where the serving time goes: one prefill and one decode step of
    a serving configuration (a name or an ``ArchConfig``) under
    ``torch.profiler`` (after a warm-up of each): device operations,
    device busy time against wall time, the kernels that take the most
    device time, and the scan and flash kernels' device time where the
    step runs them."""
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config(arch) if isinstance(arch, str) else arch
    arch = cfg.name
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = tm.init_model(cfg, gen, "cuda")
    prompts = torch.randint(0, cfg.vocab, (SERVE_BATCH, PROMPT),
                            generator=gen, device="cuda")
    prefill, decode = tm.make_prefill_step(cfg), tm.make_decode_step(cfg)
    cache = tm.make_cache(cfg, SERVE_BATCH, PROMPT + 2, device="cuda")

    def step(name, fn):
        fn()  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
        by_name = {}
        for e in dev:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        scans = [e.time_range.elapsed_us() / 1e3 for e in dev
                 if "lru_scan_kernel" in e.name]
        flash = [e.time_range.elapsed_us() / 1e3 for e in dev
                 if "flash" in e.name]
        print(f"{arch} {name} under the profiler: {len(dev)} device "
              f"operations, device busy {busy:.3f} ms of wall {wall:.3f} "
              f"ms, device idle share {1 - busy / wall:.4f}; top device "
              "time: "
              + "; ".join(f"{n[:60]} {ms:.3f} ms" for n, ms in top)
              + (f"; the scan kernel {sum(scans):.3f} ms in {len(scans)} "
                 "launches" if scans else "")
              + (f"; the flash kernel {sum(flash):.3f} ms in {len(flash)} "
                 "launches" if flash else ""))

    step("prefill", lambda: prefill(model, {"tokens": prompts}, cache))
    tok = torch.zeros((SERVE_BATCH, 1), dtype=torch.long, device="cuda")
    step("decode step", lambda: decode(model, cache, {
        "tokens": tok, "cache_index": PROMPT}))
    del model, cache
    torch.cuda.empty_cache()


def phase_llm_replay(torch, tm, get_config, full_fp32, arch, kernels,
                     states=(), caches=(), absorbed=False, **cut):
    """``arch`` at full width, cut by ``cut`` (default: depth cut to 2
    layers), fp32 with TF32 off: the same weights and prompt on the card
    and on the CPU, drawn on the card and then moved to the host (the
    host would take minutes to draw deepseek's 22 GB).  Held after the
    prefill: the logits, the recurrent state of
    the pattern positions ``states`` (each repeat of each) and the cache
    entries ``caches`` of every layer; then the greedy tokens of
    ``REPLAY_STEPS`` decode steps, and with ``absorbed`` those of the
    absorbed latent-attention decode from the same prefill too.  An MoE
    decoder's prefill routing must be equal: each token's top-k experts
    and each expert's dispatched tokens where the gate is > 0; the
    smallest gap between a token's k-th and (k+1)-th router probability
    is printed, so that a near-tie can be told from a fault.  Returns the
    kernel launches of the card's run (counts zeroed just before it): the
    fp32 kernels' own path."""
    from repro_torch.models.moe import MoE, dropped, topk_gap
    cut = cut or {"n_layers": REPLAY_LAYERS}
    cfg = get_config(arch).scaled(dtype="float32", **cut)
    model = tm.init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                          "cuda")
    moes = [m for m in model.modules() if isinstance(m, MoE)]
    prompt = torch.randint(0, cfg.vocab, (1, REPLAY_PROMPT),
                           generator=torch.Generator().manual_seed(1))
    prefill = tm.make_prefill_step(cfg)
    decodes = {"naive": tm.make_decode_step(cfg)}
    if absorbed:
        decodes["absorbed"] = tm.make_decode_step(cfg, mla_absorbed=True)

    def held(cache):
        out = [(f"state {pos}[{r}]", layer) for pos in states
               for r, layer in enumerate(cache["body"][pos]["h"])]
        for name in caches:
            out += [(f"head[{i}] {name}", c[name])
                    for i, c in enumerate(cache["head"])]
            out += [(f"body[{r}] {name}", layer)
                    for pos in cache["body"]
                    for r, layer in enumerate(cache["body"][pos][name])]
        return [(label, t.cpu().clone()) for label, t in out]

    def greedy(decode, cache, logits):
        tok = torch.argmax(logits[:, -1], -1)
        toks, steps = [int(tok)], []
        for i in range(REPLAY_STEPS):
            logits, cache = decode(model, cache, {
                "tokens": tok[:, None], "cache_index": REPLAY_PROMPT + i})
            steps.append(logits.cpu())
            tok = torch.argmax(logits[:, -1], -1)
            toks.append(int(tok))
        return toks, steps

    def run(device):
        t0 = time.perf_counter()
        with full_fp32():
            cache = tm.make_cache(cfg, 1, REPLAY_PROMPT + REPLAY_STEPS,
                                  device=device)
            for m in moes:
                m.routing_log = []
            logits, cache = prefill(model, {"tokens": prompt.to(device)},
                                    cache)
            routing = [{"top_idx": r["top_idx"].cpu(),
                        "w_ec": r["w_ec"].cpu(), "idx_ec": r["idx_ec"].cpu(),
                        "C": r["w_ec"].shape[1], "dropped": int(dropped(r)),
                        "gap": float(topk_gap(r))}
                       for r in (m.routing_log[0] for m in moes)]
            for m in moes:
                m.routing_log = None
            out = {"first": logits.cpu(), "held": held(cache),
                   "routing": routing}
            # every path after the first starts from a copy of the
            # prefill's cache, taken before any step writes into it
            starts = {path: cache if path == "naive" else
                      _clone_cache(torch, cache) for path in decodes}
            for path, decode in decodes.items():
                out[path] = greedy(decode, starts[path], logits)
        out["s"] = time.perf_counter() - t0
        return out

    for m in kernels:
        m.reset_launch_counts()
    gpu = run("cuda")
    launches = {k: v for m in kernels for k, v in m.LAUNCHES.items()}
    model.to("cpu")
    torch.cuda.empty_cache()
    cpu = run("cpu")
    ref = cpu["first"]
    atol = LOGITS_RTOL * float(ref.abs().max())
    err = float((gpu["first"] - ref).abs().max())
    check(bool(torch.allclose(gpu["first"], ref, rtol=LOGITS_RTOL,
                              atol=atol)),
          f"{arch} replay: prefill logits differ by {err:.3g} (rtol "
          f"{LOGITS_RTOL}, atol {atol:.3g})")
    held_msg = ""
    for (label, g), (_, c) in zip(gpu["held"], cpu["held"]):
        h_atol = LOGITS_RTOL * float(c.abs().max())
        h_err = float((g - c).abs().max())
        check(bool(torch.allclose(g, c, rtol=LOGITS_RTOL, atol=h_atol)),
              f"{arch} replay: {label} differs by {h_err:.3g} (rtol "
              f"{LOGITS_RTOL}, atol {h_atol:.3g})")
        held_msg += (f", {label} max abs err {h_err:.3g} (max "
                     f"{float(c.abs().max()):.3g})")
    for layer, (g, c) in enumerate(zip(gpu["routing"], cpu["routing"])):
        same = torch.equal(g["top_idx"], c["top_idx"]) and all(
            torch.equal(g["idx_ec"][e][g["w_ec"][e] > 0].sort().values,
                        c["idx_ec"][e][c["w_ec"][e] > 0].sort().values)
            for e in range(cfg.n_experts))
        held_msg += (f", MoE layer {layer} routing equal {same} (C "
                     f"{c['C']}, dropped {c['dropped']}; smallest "
                     f"top-k gap card {g['gap']:.3g} cpu {c['gap']:.3g})")
        check(same, f"{arch} replay: MoE layer {layer} routes differently "
              f"on the card (smallest top-k gap card {g['gap']:.3g}, "
              f"cpu {c['gap']:.3g})")
    paths_msg = ""
    for path in decodes:
        check(gpu[path][0] == cpu[path][0], f"{arch} replay: {path} greedy "
              f"tokens differ: card {gpu[path][0]} cpu {cpu[path][0]}")
        step_err = max(float((g - c).abs().max())
                       for g, c in zip(gpu[path][1], cpu[path][1]))
        paths_msg += (f", {path} decode logits max abs err {step_err:.3g}, "
                      f"tokens equal {gpu[path][0]}")
    print(f"{arch} replay (full width, {cfg.n_layers} layers "
          f"{list(cfg.layer_pattern)}, window {cfg.window}, fp32, TF32 "
          f"off, prompt {REPLAY_PROMPT}, {REPLAY_STEPS} greedy steps): "
          f"prefill logits max abs err {err:.3g} (max |logit| "
          f"{float(ref.abs().max()):.3g}){held_msg}{paths_msg}; cpu "
          f"{cpu['s']:.2f} s, card {gpu['s']:.2f} s; card launches "
          f"{launches}")
    return launches


def _clone_cache(torch, cache):
    """A copy of a decoder cache (nested dicts and lists of tensors)."""
    if torch.is_tensor(cache):
        return cache.clone()
    if isinstance(cache, dict):
        return {k: _clone_cache(torch, v) for k, v in cache.items()}
    return [_clone_cache(torch, v) for v in cache]


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
    import repro_torch.obs  # noqa: F401
    from repro_torch.configs import get_config
    from repro_torch.core import matching, selection
    from repro_torch.device import full_fp32
    from repro_torch.kernels import flash_attention, gradnorm, lru_scan, ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import model as tm

    t_start = time.perf_counter()
    t_phase = [t_start]

    def done(name):
        now = time.perf_counter()
        print(f"phase {name}: {now - t_phase[0]:.2f} s")
        t_phase[0] = now

    # -- 1. environment -------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmuls must run in full float32")
    done("1 environment")

    # -- 2. build: one nvcc per source, started together -----------------
    kernels = (gradnorm, flash_attention, lru_scan)
    builds = (gradnorm.build, flash_attention.build,
              flash_attention.build_sm90, lru_scan.build)
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        futures = [pool.submit(fn) for fn in builds]
        infos = [f.result() for f in futures]
    for info in infos:
        print(f"build: {info.path.name} in {info.seconds:.2f} s")
        for line in info.log.splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line or "smem" in line:
                print(f"  ptxas: {line.strip()}")
    done("2 build")

    # -- 3. kernels against their plain versions ------------------------
    norm_rec, sigma_rec = phase_kernels(torch, gradnorm)
    flash_recs = phase_flash(torch, flash_attention, ops)
    flash_rec = flash_recs[(FLASH_GQA, "bfloat16", "bshd")]
    flash_gemma_rec = flash_recs[(FLASH_GEMMA, "bfloat16", "bshd")]
    flash_f32_rec = flash_recs[(FLASH_F32_REPLAY, "float32", "bshd")]
    scan_recs = phase_scan(torch, lru_scan, ops)
    scan_rec = scan_recs[SCAN_SLICE]
    done("3 kernels")

    # -- 4. the FEEL path -----------------------------------------------
    data = make_data(rt)
    init_sd = rt.models.cnn.CNN(
        rt.models.cnn.CNNConfig(side=SIDE),
        generator=torch.Generator().manual_seed(0)).state_dict()
    tr = make_trainer(rt, torch, data, init_sd, "cuda")
    print(f"FEEL path: K={K} N={N} Q={Q} d_hat={D_HAT} side={SIDE} "
          f"gp_steps={GP_STEPS}")
    for m in kernels:
        m.reset_launch_counts()
    gpu0 = None
    feel_walls = []
    for i in range(ROUNDS):
        with SyncCounter(torch) as syncs:
            m = tr.run_round(i, eval_now=i == ROUNDS - 1)
        check(syncs.n == 0, f"untraced round {i} called "
              f"torch.cuda.synchronize {syncs.n} times")
        feel_walls.append(m.wall_s)
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
              "torch.cuda.synchronize calls 0"
              + ("" if m.test_acc is None else f" test_acc {m.test_acc:.4f}"))
        if i == 0:
            gpu0 = round_record(tr)
    feel_launches = {k: v for m in kernels for k, v in m.LAUNCHES.items()}
    check(feel_launches == {"rownorm2": 0, "gradnorm_sigma": ROUNDS,
                            "flash_attention": 0, "lru_scan": 0},
          f"launches on the FEEL path {feel_launches} in {ROUNDS} rounds")
    print(f"FEEL path launches: {feel_launches}")
    done("4 FEEL path")

    # -- 5. replay round 0 on the CPU -----------------------------------
    phase_replay(rt, torch, data, init_sd, gpu0)
    done("5 FEEL replay")

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
    st0_host = {f: getattr(st0, f).cpu() for f in
                ("h", "alpha", "sigma", "sigma_mask")}
    del tr, st0, data
    done("6 FEEL profile")

    # -- 7. the serving path --------------------------------------------
    serve_launches, _ = phase_serve(
        torch, serve_mod, kernels, ARCH,
        {"prefill": {"flash_attention": 28, "lru_scan": 0},
         "decode": {"flash_attention": 0, "lru_scan": 0}}, 128256)
    print(f"flash_attention device time of one prefill's 28 launches: "
          f"{28 * flash_rec['ms']:.3f} ms (28 x the {FLASH_GQA} time)")
    phase_serve_profile(torch, tm, get_config, ARCH)
    done("7 serve")

    # -- 8. LLM replay on the CPU ----------------------------------------
    replay_launches = phase_llm_replay(torch, tm, get_config, full_fp32,
                                       ARCH, kernels)
    check(replay_launches["flash_attention"] == REPLAY_LAYERS,
          f"fp32 replay: flash launches {replay_launches}, expected "
          f"{REPLAY_LAYERS} (one per layer's prefill)")
    done("8 LLM replay")

    # -- 9. the mamba serving path --------------------------------------
    torch.cuda.empty_cache()
    mamba_launches, served = phase_serve(
        torch, serve_mod, kernels, MAMBA,
        {"prefill": {"flash_attention": 0, "lru_scan": MAMBA_LAYERS},
         "decode": {"flash_attention": 0, "lru_scan": 0}}, 65024)
    check(served.n_params == MAMBA_PARAMS,
          f"{MAMBA}: {served.n_params:,} parameters, expected {MAMBA_PARAMS:,}")
    print(f"lru_scan device time of one prefill's {MAMBA_LAYERS} launches: "
          f"{MAMBA_LAYERS * scan_rec['ms']:.3f} ms ({MAMBA_LAYERS} x the "
          f"{SCAN_SLICE} time)")
    torch.cuda.empty_cache()
    phase_serve_profile(torch, tm, get_config, MAMBA)
    done("9 mamba serve")

    # -- 10. mamba replay on the CPU ------------------------------------
    torch.cuda.empty_cache()
    phase_llm_replay(torch, tm, get_config, full_fp32, MAMBA, kernels,
                     states=("pos0",))
    done("10 mamba replay")

    # -- 11. the baseline schemes ---------------------------------------
    torch.cuda.empty_cache()
    data = make_data(rt)
    schemes_launches, base1 = phase_schemes(rt, torch, data, init_sd,
                                            kernels, gradnorm)
    phase_replay(rt, torch, data, init_sd, base1, label=" baseline1",
                 scheme="baseline1")
    done("11 schemes")

    # -- 12. CCP power (Algorithm 3) ------------------------------------
    sys_ = rt.core.default_system(K=K, N=N, Q=Q, D_hat=D_HAT, device="cuda")
    st0 = rt.core.RoundState(**{k: v.cuda() for k, v in st0_host.items()})
    phase_ccp_fig3(rt, torch, sys_, st0)
    ccp_launches, ccp0 = phase_ccp_round(rt, torch, data, init_sd, kernels,
                                         gradnorm)
    phase_replay(rt, torch, data, init_sd, ccp0, label=" proposed+ccp",
                 power_evaluator="ccp")
    done("12 ccp")

    # -- 13. traced rounds ----------------------------------------------
    traced_launches = phase_traced(rt, torch, data, init_sd, kernels,
                                   gradnorm, gpu0, feel_walls)
    done("13 traced rounds")

    # -- 14. resilience and checkpoints -----------------------------------
    resilience_launches = phase_resilience(rt, torch, data, init_sd, kernels,
                                           gradnorm)
    del data
    done("14 resilience")

    # -- 15. the recurrentgemma-9b serving path -------------------------
    torch.cuda.empty_cache()
    rg_launches, served = phase_serve(
        torch, serve_mod, kernels, RGEMMA,
        {"prefill": {"flash_attention": 0, "lru_scan": RGEMMA_RGLRU},
         "decode": {"flash_attention": 0, "lru_scan": 0}}, 256000)
    check(served.n_params == RGEMMA_PARAMS,
          f"{RGEMMA}: {served.n_params:,} parameters, expected {RGEMMA_PARAMS:,}")
    rg_rec, rg1_rec = scan_recs[SCAN_RG], scan_recs[SCAN_RG1]
    print(f"lru_scan device time of one prefill's {RGEMMA_RGLRU} launches: "
          f"{RGEMMA_RGLRU * rg_rec['ms']:.3f} ms ({RGEMMA_RGLRU} x the "
          f"{SCAN_RG} time)")
    torch.cuda.empty_cache()
    rg1_launches, _ = phase_serve(
        torch, serve_mod, kernels, RGEMMA,
        {"prefill": {"flash_attention": 0, "lru_scan": RGEMMA_RGLRU},
         "decode": {"flash_attention": 0, "lru_scan": 0}}, 256000, batch=1)
    print(f"lru_scan device time of one batch-1 prefill's {RGEMMA_RGLRU} "
          f"launches: {RGEMMA_RGLRU * rg1_rec['ms']:.3f} ms "
          f"({RGEMMA_RGLRU} x the {SCAN_RG1} time)")
    torch.cuda.empty_cache()
    phase_serve_profile(torch, tm, get_config, RGEMMA)
    done("15 recurrentgemma serve")

    # -- 16. the gemma3-12b serving path --------------------------------
    torch.cuda.empty_cache()
    gemma_launches, served = phase_serve(
        torch, serve_mod, kernels, GEMMA,
        {"prefill": {"flash_attention": GEMMA_GLOBAL, "lru_scan": 0},
         "decode": {"flash_attention": 0, "lru_scan": 0}}, 262144)
    check(served.n_params == GEMMA_PARAMS,
          f"{GEMMA}: {served.n_params:,} parameters, expected {GEMMA_PARAMS:,}")
    print(f"flash_attention device time of one prefill's {GEMMA_GLOBAL} "
          f"launches: {GEMMA_GLOBAL * flash_gemma_rec['ms']:.3f} ms "
          f"({GEMMA_GLOBAL} x the {FLASH_GEMMA} time)")
    torch.cuda.empty_cache()
    phase_serve_profile(torch, tm, get_config, GEMMA)
    done("16 gemma3 serve")

    # -- 17. hybrid replays on the CPU -----------------------------------
    torch.cuda.empty_cache()
    for arch, want in ((RGEMMA, {"flash_attention": 0, "lru_scan": 2}),
                       (GEMMA, {"flash_attention": 1, "lru_scan": 0})):
        pattern = get_config(arch).layer_pattern
        got = phase_llm_replay(
            torch, tm, get_config, full_fp32, arch, kernels,
            states=tuple(f"pos{i}" for i, kind in enumerate(pattern)
                         if kind == "rglru"),
            n_layers=len(pattern), window=HYBRID_WINDOW)
        check({k: got[k] for k in want} == want,
              f"{arch} replay: launches {got}, expected {want}")
        torch.cuda.empty_cache()
    done("17 hybrid replays")

    # -- 18. the stablelm-12b serving path ------------------------------
    none = {"flash_attention": 0, "lru_scan": 0}

    def prefill_flash(n):
        return {"prefill": {"flash_attention": n, "lru_scan": 0},
                "decode": none}

    def flash_time(arch, n, shape):
        rec = flash_recs[(shape, "bfloat16", "bshd")]
        print(f"flash_attention device time of one {arch} prefill's {n} "
              f"launches: {n * rec['ms']:.3f} ms ({n} x the {shape} time)")
        return rec

    torch.cuda.empty_cache()
    stablelm_launches, served = phase_serve(
        torch, serve_mod, kernels, STABLELM, prefill_flash(STABLELM_LAYERS),
        100352)
    check(served.n_params == STABLELM_PARAMS, f"{STABLELM}: "
          f"{served.n_params:,} parameters, expected {STABLELM_PARAMS:,}")
    flash_stablelm_rec = flash_time(STABLELM, STABLELM_LAYERS, FLASH_STABLELM)
    phase_serve_profile(torch, tm, get_config, STABLELM)
    done("18 stablelm serve")

    # -- 19. the command-r-35b serving path -----------------------------
    torch.cuda.empty_cache()
    command_r_launches, served = phase_serve(
        torch, serve_mod, kernels, COMMAND_R,
        prefill_flash(COMMAND_R_LAYERS), 256000)
    check(served.n_params == COMMAND_R_PARAMS, f"{COMMAND_R}: "
          f"{served.n_params:,} parameters, expected {COMMAND_R_PARAMS:,}")
    flash_command_r_rec = flash_time(COMMAND_R, COMMAND_R_LAYERS,
                                     FLASH_COMMAND_R)
    phase_serve_profile(torch, tm, get_config, COMMAND_R)
    done("19 command-r serve")

    # -- 20. the deepseek-v2-236b serving path, cut to 8 layers ---------
    torch.cuda.empty_cache()
    dsv2 = get_config(DSV2).scaled(n_layers=DSV2_LAYERS)
    dsv2_launches, naive = phase_serve(
        torch, serve_mod, kernels, dsv2, prefill_flash(DSV2_LAYERS), 102400)
    check(naive.n_params == DSV2_PARAMS, f"{DSV2} cut to {DSV2_LAYERS} "
          f"layers: {naive.n_params:,} parameters, expected {DSV2_PARAMS:,}")
    torch.cuda.empty_cache()
    dsv2_abs_launches, absorbed = phase_serve(
        torch, serve_mod, kernels, dsv2, prefill_flash(DSV2_LAYERS), 102400,
        mla_absorbed=True)
    check(torch.equal(absorbed.tokens[:, 0], naive.tokens[:, 0]),
          f"{DSV2}: the absorbed serve's prefill token "
          f"{absorbed.tokens[:, 0].tolist()} is not the naive one's "
          f"{naive.tokens[:, 0].tolist()}")
    for label, res in (("naive", naive), ("absorbed", absorbed)):
        print(f"{DSV2} {label} decode: ms/step "
              f"{[round(t * 1e3, 3) for t in res.decode_s]}; tokens "
              f"{res.tokens.tolist()}")
    print(f"{DSV2}: naive and absorbed tokens equal "
          f"{torch.equal(naive.tokens, absorbed.tokens)}")
    flash_mla_rec = flash_time(DSV2, DSV2_LAYERS, FLASH_MLA)
    phase_serve_profile(torch, tm, get_config, dsv2)
    done("20 deepseek-v2 serve")

    # -- 21. the deepseek-v3-671b serving path, cut to 4 layers ---------
    torch.cuda.empty_cache()
    dsv3 = get_config(DSV3).scaled(n_layers=DSV3_LAYERS)
    dsv3_launches, served = phase_serve(
        torch, serve_mod, kernels, dsv3, prefill_flash(DSV3_LAYERS), 129280)
    check(served.n_params == DSV3_PARAMS, f"{DSV3} cut to {DSV3_LAYERS} "
          f"layers: {served.n_params:,} parameters, expected {DSV3_PARAMS:,}")
    flash_dsv3_rec = flash_time(DSV3, DSV3_LAYERS, FLASH_MLA)
    phase_serve_profile(torch, tm, get_config, dsv3)
    done("21 deepseek-v3 serve")

    # -- 22. zoo replays on the CPU -------------------------------------
    torch.cuda.empty_cache()
    for arch, options in ((STABLELM, {}),
                          (DSV2, {"caches": ("ckv", "kr"),
                                  "absorbed": True})):
        got = phase_llm_replay(torch, tm, get_config, full_fp32, arch,
                               kernels, **options)
        want = {"flash_attention": REPLAY_LAYERS, "lru_scan": 0}
        check({k: got[k] for k in want} == want,
              f"{arch} replay: launches {got}, expected {want}")
        torch.cuda.empty_cache()
    done("22 zoo replays")

    # -- results --------------------------------------------------------
    def entry(name, source, replaces, launches, rec):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"],
                "library_ms": rec.get("library_ms")}

    gn_src = "src/repro_torch/kernels/csrc/gradnorm.cu"
    sm90_src = "src/repro_torch/kernels/csrc/flash_attention_sm90.cu"
    flash_src = "src/repro/kernels/flash_attention.py:112"
    print(f"total wall {time.perf_counter() - t_start:.2f} s")
    print(json.dumps({"kernels": [
        entry("rownorm2", gn_src, "src/repro/kernels/gradnorm.py:62",
              feel_launches["rownorm2"] + serve_launches["rownorm2"]
              + mamba_launches["rownorm2"] + traced_launches["rownorm2"]
              + resilience_launches["rownorm2"], norm_rec),
        entry("gradnorm_sigma", gn_src, "src/repro/kernels/gradnorm.py:62",
              feel_launches["gradnorm_sigma"]
              + schemes_launches["gradnorm_sigma"]
              + ccp_launches["gradnorm_sigma"]
              + traced_launches["gradnorm_sigma"]
              + resilience_launches["gradnorm_sigma"], sigma_rec),
        entry("flash_attention",
              "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
              "src/repro/kernels/flash_attention.py:112",
              serve_launches["flash_attention"], flash_rec),
        entry("flash_attention_f32",
              "src/repro_torch/kernels/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:112",
              replay_launches["flash_attention"], flash_f32_rec),
        entry("lru_scan", "src/repro_torch/kernels/csrc/lru_scan.cu",
              "src/repro/kernels/lru_scan.py:70",
              mamba_launches["lru_scan"], scan_rec),
        entry(f"flash_attention@{GEMMA}",
              "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
              "src/repro/kernels/flash_attention.py:112",
              gemma_launches["flash_attention"], flash_gemma_rec),
        entry(f"lru_scan@{RGEMMA}", "src/repro_torch/kernels/csrc/lru_scan.cu",
              "src/repro/kernels/lru_scan.py:70",
              rg_launches["lru_scan"], rg_rec),
        entry(f"lru_scan@{RGEMMA}-batch1",
              "src/repro_torch/kernels/csrc/lru_scan.cu",
              "src/repro/kernels/lru_scan.py:70",
              rg1_launches["lru_scan"], rg1_rec),
        entry(f"flash_attention@{STABLELM}", sm90_src, flash_src,
              stablelm_launches["flash_attention"], flash_stablelm_rec),
        entry(f"flash_attention@{COMMAND_R}", sm90_src, flash_src,
              command_r_launches["flash_attention"], flash_command_r_rec),
        entry(f"flash_attention@{DSV2}", sm90_src, flash_src,
              dsv2_launches["flash_attention"], flash_mla_rec),
        entry(f"flash_attention@{DSV3}", sm90_src, flash_src,
              dsv3_launches["flash_attention"], flash_dsv3_rec)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
