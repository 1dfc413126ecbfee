#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU
and the CUDA toolkit.  Phases, each of which fails the run (non-zero
exit) if anything in it fails; no failure is caught:

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: ``kernels/csrc/gradnorm.cu``, ``kernels/csrc/flash_attention.cu``
   (fp32), ``kernels/csrc/flash_attention_sm90.cu`` (bf16, tensor cores)
   and ``kernels/csrc/lru_scan.cu`` (the scan and its backward kernel)
   compiled with nvcc for sm_90a, one
   nvcc each, started together; ptxas's register, spill and warning
   lines, and a check that no instance of the bf16 kernel
   (``flash_wgmma_kernel``) spills or has its wgmmas serialised, that
   ptxas honoured its ``setmaxnreg``, and that none of the scan's four
   instances (forward and backward, fp32 and bf16) spills;
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
   (d = 160, 32:8 GQA, the instance <3, 3, 96>), command-r-35b's (d =
   128, 64:8 GQA) and deepseek's latent attention (128 heads, q and k
   at d = 192, v at dv = 128 read in place by the instance <3, 2, 128>;
   the same heads at d = dv = 128 beside them), each bf16 case's
   instance printed, and fp32
   flash at the zoo replays' shapes (d = 160; d = 192 with dv = 128,
   v read in place) and at two full-size prefill shapes, llama's GQA
   and deepseek's latent attention, each fp32 case's SDPA output held
   against the plain version at the kernel's tolerance (printed),
   every flash case with % of bound; ``gradnorm_sigma`` also at the
   256-device round's (51200, 84) + (51200, 10); the scan, fp32 and
   bf16, also at the seams of its
   chunk of L
   steps (S of 1, L - 1, L, L + 1; C of 1 and 130; a view 4 bytes past
   a 16-byte boundary, in bf16 also 2; a batch of 70000; gates in
   (0.999, 1) at S = 2048), every case called twice and bit-identical,
   the backward kernel at every case the bits of the route it replaced
   (the forward kernel on time-reversed copies, flips and the product,
   rebuilt inline) and within 1e-5 of the plain loop, and timed at
   mamba's (4, 2048, 131072), recurrentgemma-9b's (4, 2048, 4096) and
   the same at batch 1, with % of bound and GB/s; the train shapes:
   ``gradnorm_sigma`` at llama's train step, (8192, 3072) + (8192,
   128256), beside ``vector_norm`` of both operands, and the scan at
   mamba's and recurrentgemma's train steps, (8, 512, 131072) and (8,
   512, 4096), with its gradient through the kernels
   (``ops.lru_scan``: one forward and one backward launch) held
   against autograd through the plain loop on the card, and the
   backward kernel the replaced route's bits, timed in turns with that
   route beside the plain loop and its own bound (20 B an element);
   ``gradnorm_sigma`` also at qwen2-vl-2b's and musicgen-medium's
   train steps, (8192, 1536) + (8192, 151936) and (8192, 1536) +
   (8192, 8192), each operand's ``einsum("nd,nd->n")`` timed beside it;
   bf16 flash at qwen2-vl-2b's (12:2 GQA, d = 128) and
   musicgen-medium's (24:24 MHA, d = 64) prefill shapes, and fp32 flash
   at their replays'; the softcapped instances (softcap 50.0, q at 4x
   scale so that the cap bites) of bf16 flash at llama's and gemma3's
   prefill shapes and of fp32 flash at the llama replay's, each beside
   compiled ``flex_attention`` with the cap as a score_mod (its library
   call) and SDPA without the cap; bf16 flash with a query offset:
   llama's last 1024 queries at offset 1024 against all 2048 keys, held
   against the plain version and bit for bit against rows 1024.. of the
   one-shot kernel output, SDPA with the offset's explicit mask (its
   library call) and ``flex_attention`` with the offset's block mask
   beside it; each flex output held against the plain version;
4. FEEL path: 3 untraced rounds of the paper's §VI-A setup (K=10, N=5,
   Q=2, D̂=200, 28x28 images, faithful selection with 400 GP steps)
   through ``FEELTrainer.run_round``, which scores sigma through the
   kernel;
5. replay: round 0 again with the port on the CPU, held against the
   card's round 0;
6. where the time goes: the decision's matching and selection timed
   alone, and one more round under ``torch.profiler`` (device activity
   only);
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
   the ``sigma_all`` profile's FLOPs are the flop counter's, which
   counts the kernel's custom op by its own count (``gradnorm.cost``,
   checked); round 0 decides as phase 4's
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
   launches per prefill at 64:8 GQA, with its peak memory; profiled,
   its prefill's flash launches checked to be 40 of ``bf16_instance``'s
   instance and their device ms printed beside the prefill's wall time;
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
   greedy steps, deepseek's on the naive and the absorbed path;
23. the trainer's options at phase 4's setup, 2 rounds each on the
   card, each replayed on the CPU from the same initial state and
   channel draws, round 1 from the card's state after round 0 (phase
   5's rule; params by the optimizer's own noise rule): (a)
   ``local_steps=3`` with sgd (FedAvg pseudo-gradients), (b) momentum
   with one warmup round (every sample selected, the selection stage
   present) and ``gp_step0=5.0``, (c) adafactor with
   ``sigma_method="full"``, whose round-2 checkpoint is written on the
   card and resumed on the CPU (params and factored moments
   bit-identical, round 2 held under the rule), (d)
   ``sigma_method="last_layer"``; the kernel launches once a round in
   (a) and (b) and never in (c) and (d);
24. a 256-device round: ``default_system(K=256, N=32, Q=8, D_hat=200)``
   at 28x28, ``selection_chunk=64`` and the batched matching sweep, 3
   rounds with sigma through the kernel at (51200, 84) + (51200, 10),
   the per-stage ms of rounds 1 and up, round 0 replayed on the CPU;
25. llama3.2-3b trained at full width and depth through
   ``repro_torch.launch.train.run``: FEEL on, K = 4 clients, batch 16 x
   512, bf16, the config's AdamW, 10 steps; each step's ms (the first
   apart; median, min, max of the rest), tok/s, peak memory, loss,
   per-example loss, ``selected_frac`` and ``sigma_mean``; each step
   launches ``gradnorm_sigma`` once and neither flash nor the scan
   (checked); then one step with a CUDA event at the end of each
   stage (forward, per-example loss, sigma, selection, backward with
   the remat recompute, optimizer) and one under ``torch.profiler``;
26. the other block kinds trained at full width, cut in depth, 3 FEEL
   steps each at batch 8 x 512: falcon-mamba-7b cut to 4 layers,
   recurrentgemma-9b to one pattern (rglru, rglru, attn_local) and
   deepseek-v2-236b to 2 layers (its dense layer and one MoE layer of
   160 experts, with the config's adafactor); step ms, peak memory, the
   summed MoE aux loss, and the scan's launches a step, 2 of
   ``lru_scan`` a recurrent layer (the forward, its recompute under
   remat) and 1 of ``lru_scan_backward`` (checked); each timed by stage
   and profiled as in 25; for mamba and recurrentgemma the backward
   stage's ms and the peak printed on a line of their own;
27. train replays: llama3.2-3b and falcon-mamba-7b at full width cut to
   2 layers, fp32 with TF32 off, K = 4, batch 8 x 64: 3 FEEL steps on
   the card, then 1 more, replayed on the CPU from the card's
   params, AdamW state and batch (``launch/replay.py``'s rule: loss,
   per-example loss and sigma at rtol 1e-4; each client's smallest
   sigma gap printed, the selections equal where it clears 10x the
   sigma error, else the card's taken as given and said so; gradients
   per leaf at rtol 1e-4 with an atol of 1e-4 of the leaf's largest;
   params at 1e-6 + 1e-5 |w|, or, on AdamW's entries at gradient
   noise, at the card's own update + lr (1 + wd |w|)); each side's
   sigma against a float64 recompute; the mamba replay runs the scan's
   backward kernel on the card (2 scan and 1 backward launch a layer,
   checked);
28. qwen2-vl-2b served at full width and depth (28 layers,
   1,543,656,960 parameters; embeddings in, M-RoPE), the reference's
   request: 4 x 2048 random embeddings with their (4, 3, 2048)
   positions after a warm-up request, then 32 greedy steps from zero
   embeddings at text positions; each layer's prefill attention
   through the bf16 flash kernel at its 12:2 GQA (a group of 6), 28
   launches per prefill and none in decode; profiled, the prefill's
   flash launches checked and timed as in phase 19;
29. musicgen-medium served at full width and depth (48 layers,
   1,837,254,144 parameters), 4 x 4 codebooks x 2048 tokens, greedy
   per codebook; prefill attention through the bf16 flash kernel at
   24:24 MHA and d = 64 (its d <= 64 instance), 48 launches per
   prefill and none in decode; profiled, its 48 flash launches checked
   and timed as in phase 19;
30. modality replays: both archs at full width cut to 2 layers, fp32
   with TF32 off, card against CPU as phase 8 (prefill logits, the KV
   caches, 8 greedy steps); the vlm prompt's three M-RoPE rows differ
   (a (t, h, w) image grid between two runs of text), its decode at
   the text positions after it; the audio prompt a (1, 4, 256) grid,
   its greedy tokens per codebook;
31. both archs trained at full width and depth through
   ``repro_torch.launch.train.run``: FEEL on, K = 4, batch 16 x 512,
   the configs' AdamW, 10 steps, each step's ms, tok/s and peak memory
   as phase 25; one sigma launch a step (qwen2-vl's p - y (8192,
   151936), musicgen's codebooks folded into (8192, 4 x 2048) rows),
   none of flash or the scan (checked); each timed by stage and
   profiled;
32. train replays by phase 27's rule: 1 FEEL step of each arch at full
   width cut to 2 layers, fp32, after 3 warm-up steps; and 1 adafactor
   step of deepseek-v2's smoke decoder cut to 3 layers (a dense head
   layer and two body repeats: adafactor steps each stacked body group
   at once, as the reference's on its stacked tree);
33. llama3.2-3b at full width and depth on a 1x1 ``DeviceMesh``
   (``launch.mesh.make_host_mesh``: a one-rank nccl group): the params
   DTensors placed by the reference's sharding rules
   (``launch.sharding.param_shardings``), each step under the
   activation constrainer; phase 7's serve request (tokens equal to
   phase 7's, prefill logits held at LOGITS_RTOL and checked
   bit-identical or not; 28 flash launches a prefill through
   ``local_map``) and 3 of phase 25's FEEL train steps, held against 3
   plain steps of the same seeds, both under deterministic algorithms
   (losses at the replay rule's rtol, params at its 1e-6 + 1e-5 |w|,
   each checked bit-identical or not; one sigma launch a step through
   ``local_map``); the prefill s, decode ms/step, step ms and peak GiB
   printed beside phases 7 and 25;
34. the multi-pod dry run on the host's CPU (``launch.dryrun.run_one``,
   a fake process group of 256 or 512 ranks, fake tensors, every layer
   run, every op partitioned): llama3.2-3b x train_4k and x decode_32k
   and deepseek-v2-236b x decode_32k on 16x16, deepseek-v3-671b x
   decode_32k on 2x16x16 (the cache writes and the MoE among them), each
   record, its wall time, collective bytes and peak printed; each must
   be ``ok`` with no gathered op, the reference's parameter counts,
   ``argument_bytes`` equal to the sharding rules' arithmetic on a
   ``MeshShape``, ``peak_bytes >= argument_bytes``, and FLOPs a device
   within 1 % of the count pinned beside ``DRY_RUNS`` (torch 2.13 on a
   CPU), so the count is the same under this host's release.  The
   records are estimates at H100 datasheet rates, not measurements;
35. softcapped attention: gemma3-12b with ``attn_logit_softcap = 50.0``
   (Gemma 2's published cap) through the entry points: (a) served at
   full width and depth (48 layers, 12,772,052,736 parameters), phase
   7's request, 8 flash launches a prefill and none a decode step, and
   in a profiled prefill the 8 flash launches the softcapped instance;
   prefill s, decode ms/step and peak printed beside phase 16's
   uncapped serve; (b) one pattern (6 layers, window 128) replayed in
   fp32 on the CPU as phase 17 (the fp32 kernel's softcapped instance
   on the card); (c) FEEL train steps at full width cut to one pattern
   (6 layers), the config's AdamW, one sigma launch a step, step ms,
   tok/s and peak; (d) 1 train step of a 2-layer fp32 cut, its
   vocabulary cut to 32768, replayed on the CPU by phase 27's rule.

Every replay (8, 10, 17, 22, 30, 35) draws its weights on the card from a
seed, runs there, moves them to the host and runs again.  Launch counts
are zeroed just before each path (4, 7, 9, 11, 12b, 13,
14, both requests of 15, 16, 18, 19, both requests of 20, 21, the
card's runs in 8, 10, 17 and 22, each run of 23, 24, 25, each run of
26, each replayed step of 27, 28, 29, the card's runs in 30, each run
of 31, each replayed step of 32, and 35's serve, replay, train run and
replayed steps) and read just after.  It prints one
``{"kernels": [...]}`` line, with one entry per kernel and serving shape
(``gradnorm_sigma`` at the §VI-A shape once for each FEEL path with
that path's own launches: phase 4's (the main path), 11's
(``@schemes``), 12b's (``@ccp``), 13's (``@traced``), 14's
(``@resilience``) and 23's runs (a) and (b) (``@options``); at the
256-device shape with phase 24's own (``@K256``); ``rownorm2`` with
phase 4's; the
bf16 flash kernel at llama's, gemma3's, stablelm's, command-r's,
deepseek-v2's and deepseek-v3's, the last two at the one latent
attention shape, each with the launches of its own path: phase 20's
naive request and phase 21's; the scan at mamba's and at
recurrentgemma's at batch 4 and 1; the train paths with their own
runs' launches: ``gradnorm_sigma@train-llama3.2-3b`` (phase 25, at its
train shape), ``lru_scan@train-falcon-mamba-7b`` and
``lru_scan@train-recurrentgemma-9b`` (phase 26, at their train
shapes), ``lru_scan_backward@train-falcon-mamba-7b`` and
``lru_scan_backward@train-recurrentgemma-9b`` (the backward kernel,
phase 26's launches, at the same shapes, its ms the median of its
turns); the vlm and audio paths with their own runs' launches:
``flash_attention@serve-qwen2-vl-2b`` (phase 28),
``flash_attention@serve-musicgen-medium`` (29),
``gradnorm_sigma@train-qwen2-vl-2b`` and
``gradnorm_sigma@train-musicgen-medium`` (31), each at its own shape;
the host mesh's ``flash_attention@hostmesh-llama3.2-3b`` and
``gradnorm_sigma@hostmesh-train-llama3.2-3b`` (33), each with phase
33's own launches; the softcapped path's
``flash_attention@softcap-gemma3-12b`` (35a's launches, at gemma3's
shape), ``flash_attention_f32@softcap`` (35b's) and
``gradnorm_sigma@train-softcap-gemma3-12b`` (35c's), and, with no launch
on any path, ``flash_attention@softcap-llama3.2-3b`` and
``flash_attention@q_offset``),
and, last, the ``{"ok": true,
"device": ...}`` line.  Without a GPU, or without the repository's
``src/repro_torch`` beside it, it exits non-zero before printing
either.
"""
from __future__ import annotations

import json
import math
import os
import re
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
FLASH_QWEN = (4, 2048, 12, 2, 128)       # qwen2-vl-2b: a GQA group of 6
FLASH_MUSICGEN = (4, 2048, 24, 24, 64)   # musicgen-medium: d = 64, MHA
FLASH_F32_ZOO = [(1, 256, 32, 8, 160), (1, 256, 128, 128, 192, 128),
                 (1, 256, 12, 2, 128), (1, 256, 24, 24, 64)]
# fp32 flash at two full-size prefill shapes (llama's GQA and deepseek's
# latent attention), where the kernel's time is not hidden under launch
# latency
FLASH_F32_FULL = [FLASH_GQA, FLASH_MLA]
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# softcapped attention (phase 3's capped cases and phase 35): Gemma 2's
# published cap, the q scale of the capped kernel checks, and the
# offset case's queries (llama's last 1024 of 2048)
SOFTCAP, CAP_Q_SCALE, FLASH_OFFSET = 50.0, 4.0, 1024
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
# phase 23: the trainer's options at the §VI-A setup, 2 rounds each, each
# replayed on the CPU: (label, FEELConfig options, sigma kernel launches
# a round)
OPTION_ROUNDS = 2
OPTION_RUNS = (
    ("a", dict(local_steps=3, optimizer="sgd"), 1),
    ("b", dict(optimizer="momentum", warmup_rounds=1, gp_step0=5.0), 1),
    ("c", dict(optimizer="adafactor", sigma_method="full"), 0),
    ("d", dict(sigma_method="last_layer"), 0),
)
# phase 24: a 256-device round at benchmarks/scale.py's geometry (N = 32,
# Q = 8: capacity K), the chunked GP and the batched matching sweep
K256, N256, Q256, CHUNK256, ROUNDS256 = 256, 32, 8, 64, 3
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
# phases 25-27: the zoo trained with FEEL selection.  llama3.2-3b at full
# width and depth (K clients of the batch, the config's AdamW); the
# other block kinds at full width cut in depth, (arch, layers, scan
# layers); the fp32 card-vs-CPU replays at PR 25's shape
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_CLIENTS = 16, 512, 10, 4
SIGMA_TRAIN = (TRAIN_BATCH * TRAIN_SEQ, 3072, 128256)  # llama's h, p - y
SCAN_TRAIN = ((8, 512, 8192 * 16), (8, 512, 4096))   # mamba, recurrentgemma
CUT_TRAIN = ((MAMBA, 4, 4), (RGEMMA, 3, 2), (DSV2, 2, 0))
CUT_BATCH, CUT_SEQ, CUT_STEPS = 8, 512, 3
REPLAY_TRAIN_ARCHS = (ARCH, MAMBA)
REPLAY_TRAIN_BATCH, REPLAY_TRAIN_SEQ = 8, 64
REPLAY_TRAIN_WARM, REPLAY_TRAIN_STEPS = 3, 1
# phases 28-32: the vlm and audio modalities at full width and depth,
# (arch, parameters, layers, vocab); their train steps' sigma shapes
# (h, p - y), musicgen's codebooks folded into one row; the vlm
# replay's image grid (t, h, w) after REPLAY_GRID_AT text tokens; the
# adafactor replay's cut (deepseek-v2's smoke decoder, 3 layers)
QWEN = ("qwen2-vl-2b", 1_543_656_960, 28, 151936)
MUSICGEN = ("musicgen-medium", 1_837_254_144, 48, 2048)
SIGMA_TRAIN_QWEN = (TRAIN_BATCH * TRAIN_SEQ, 1536, 151936)
SIGMA_TRAIN_MUSICGEN = (TRAIN_BATCH * TRAIN_SEQ, 1536, 4 * 2048)
REPLAY_GRID, REPLAY_GRID_AT = (2, 8, 8), 16
ADAFACTOR_REPLAY_LAYERS = 3
# phase 33: train steps on the host mesh; phase 34: the dry runs, (arch,
# shape, multi-pod) with the reference's parameter counts (params_total,
# params_active)
MESH_TRAIN_STEPS = 3
# phase 35: the softcapped gemma3-12b's train cut (one pattern), the
# sigma shape of its steps (h, p - y), and the vocabulary of its replayed
# steps' cut (the CPU side's time goes with the parameters, 2.0e9 of its
# 2.46e9 in the two 262144-row tables at full vocabulary; the cap acts in
# attention, and (b) and (c) run the full vocabulary)
SOFTCAP_TRAIN_LAYERS = 6
SOFTCAP_REPLAY_VOCAB = 32768
SIGMA_TRAIN_GEMMA = (CUT_BATCH * CUT_SEQ, 3840, 262144)
LLAMA_TRAIN_FLOPS = 119_360_364_486_656.0
DSV3_DECODE_FLOPS = 16_836_506_648_576.0
LLAMA_DECODE_FLOPS = 8_849_719_296.0
DSV2_DECODE_FLOPS = 33_094_028_328_960.0
# phase 34: (arch, shape, multi_pod, the reference's total and active
# parameters, FLOPs a device counted by ``python -m
# repro_torch.launch.dryrun`` under torch 2.13 on a CPU)
DRY_RUNS = (("llama3.2-3b", "train_4k", False, 3_606_752_256,
             3_606_752_256, LLAMA_TRAIN_FLOPS),
            ("deepseek-v3-671b", "decode_32k", True, 671_026_404_352,
             37_552_282_624, DSV3_DECODE_FLOPS),
            ("llama3.2-3b", "decode_32k", False, 3_606_752_256,
             3_606_752_256, LLAMA_DECODE_FLOPS),
            ("deepseek-v2-236b", "decode_32k", False, 238_478_310_400,
             24_112_675_840, DSV2_DECODE_FLOPS))
DRY_RUN_RTOL = 0.01


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


def kernel_launches(kernels):
    """{kernel name: launches since its module's last reset}."""
    return {k: v for m in kernels for k, v in m.LAUNCHES.items()}


def max_rel(got, want) -> float:
    return float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())


# ------------------------------------------------------------- phases

def phase_kernels(torch, gradnorm):
    """Both entry points against their plain versions; returns the
    gradnorm_sigma record at the main path's shapes."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    rows, rows256 = K * D_HAT, K256 * D_HAT
    main_sigma = main_norm = big_sigma = None
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

    for n, f in TEST_SHAPES + [(rows, 84), (rows256, 84)]:
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
        es_ms = [device_ms(torch, lambda x=x: torch.einsum("nd,nd->n", x, x))
                 for x in (h, d)]
        print(f"gradnorm_sigma ({n}, {f})+({n}, 10): max_abs_err "
              f"{rec['max_abs_err']:.3g} max_rel_err {rel:.3g} | device ms: "
              f"kernel {rec['ms']:.6f} plain {rec['plain_ms']:.6f} "
              f"einsum('nd,nd->n') of h {es_ms[0]:.6f} of p - y "
              f"{es_ms[1]:.6f} (both {sum(es_ms):.6f}) bound "
              f"{b_ms:.6f} ({b_by}) | eager call ms: kernel "
              f"{call_ms(torch, lambda: gradnorm.gradnorm_sigma(h, d)):.6f} "
              f"plain {call_ms(torch, lambda: gradnorm.gradnorm_sigma_plain(h, d)):.6f}")
        if n == rows:
            main_sigma = rec
        if n == rows256:
            big_sigma = rec
    return main_norm, main_sigma, big_sigma


def wgmma_instance(name: str) -> tuple[int, ...] | None:
    """The template arguments (DC, DVC, BK) of a profiled launch of the
    bf16 flash kernel, demangled or mangled, or None for another
    kernel."""
    m = re.search(r"flash_wgmma_kernel(?:<(\d+), (\d+), (\d+),|"
                  r"ILi(\d+)ELi(\d+)ELi(\d+)E)", name)
    return tuple(int(x) for x in m.groups() if x) if m else None


def flash_bound(b: int, s: int, h: int, hk: int, d: int, causal: bool,
                itemsize: int, dv: int | None = None, sk: int | None = None,
                q_offset: int = 0) -> tuple[float, str]:
    """Operations: 2 flops per multiply-add of q k^T (width d) and of p v
    (width dv, d by default) over the (query, key) pairs the mask keeps
    (query i, at position q_offset + i, sees min(sk, q_offset + i + 1)
    keys; sk is s by default); bytes: q (s rows) and k (sk rows, width
    d), v (width dv; k and v with Hk heads) read and o (s rows, width
    dv) written once.  The softcap's tanh is not counted (no tensor-core
    work).  The peak is that of the input type: the dense bf16 tensor
    cores for bf16, the CUDA cores' float32 rate for float32."""
    dv = d if dv is None else dv
    sk = s if sk is None else sk
    pairs = (sum(min(sk, q_offset + i + 1) for i in range(s)) if causal
             else s * sk)
    flops = 2.0 * b * h * (d + dv) * pairs
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_FP32_FLOPS
    n_bytes = b * (s * (h * d + h * dv) + sk * (hk * d + hk * dv)) * itemsize
    return bound(n_bytes, flops, peak)


def phase_flash(torch, fa, ops):
    """The flash kernels against their plain versions at the test shapes,
    the edge shapes and the main paths' shapes; returns the records by
    (shape, dtype, layout).  Each case: (B, S, H, Hk, d[, dv]), dtype,
    causal, and whether it goes through the (BH, S, d) entry (H = Hk,
    folded) or the strided (B, S, H, d) one, there also as views one
    element past an aligned base ("bshd+1": in bf16 q, k and v copied
    into aligned buffers).  A dv < d (latent attention) is a v of its own
    width, which both kernels read in place; each bf16 case prints the
    instance ``bf16_instance`` names for it.  fp32 runs
    at the replays' shapes and at two full-size ones
    (``FLASH_F32_FULL``); there SDPA's output, the library call, is held
    against the plain version at the kernel's tolerance too, and whether
    it is within it printed (a TF32 yardstick would not be)."""
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
              (FLASH_MLA_D128, "bfloat16", True, "bshd"),
              (FLASH_QWEN, "bfloat16", True, "bshd"),
              (FLASH_MUSICGEN, "bfloat16", True, "bshd")]
    cases += [(shape, "float32", True, "bshd")
              for shape in FLASH_F32_ZOO + FLASH_F32_FULL]
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
        sdpa = partial(F.scaled_dot_product_attention, qs, ks, vs,
                       is_causal=causal, enable_gqa=hk != h)
        sdpa_note = ""
        if dt == "float32":
            want = plain()
            lib_out = sdpa()
            if layout == "bshd":
                lib_out = lib_out.transpose(1, 2)
            lib_out = lib_out.reshape(want.shape)
            torch.cuda.synchronize()
            lib_err = float((lib_out - want).abs().max())
            lib_ok = bool(torch.allclose(lib_out, want, atol=tol, rtol=tol))
            sdpa_note = (f" | sdpa max_abs_err {lib_err:.3g}, within the "
                         f"kernel's tol {tol}: {lib_ok}")
            del want, lib_out
        rec = {"max_abs_err": err,
               "ms": device_ms(torch, run, calls, replays),
               "plain_ms": device_ms(torch, plain, *((2, 2) if big else
                                                     (calls, replays))),
               "library_ms": device_ms(torch, sdpa, calls, replays),
               "bound_ms": b_ms, "bound_by": b_by}
        print(f"flash_attention {layout} {shape} {dt} causal={causal}: "
              f"max_abs_err {err:.3g} (tol {tol}) | device ms: kernel "
              f"{rec['ms']:.6f} plain {rec['plain_ms']:.6f} sdpa "
              f"{rec['library_ms']:.6f} bound {b_ms:.6f} ({b_by}) | "
              f"kernel/bound {rec['ms'] / b_ms:.2f}x ({100 * b_ms / rec['ms']:.1f} "
              f"% of bound) kernel/sdpa {rec['ms'] / rec['library_ms']:.2f}x"
              + sdpa_note)
        if dt == "bfloat16":
            print(f"  instance flash_wgmma_kernel<DC, DVC, BK> = "
                  f"{fa.bf16_instance(-(-d // 8) * 8, -(-dv // 8) * 8)}")
        recs[(shape, dt, layout)] = rec
        del q, k, v, q4, k4, v4, qs, ks, vs, run, plain, sdpa
        torch.cuda.empty_cache()
    return recs


def flex_call(torch, qs, ks, vs, softcap: float, q_offset: int):
    """One call of ``torch.nn.attention.flex_attention``, compiled as its
    documentation asks, that computes the capped or offset kernel's
    function on the (B, H, S, d) inputs: the softcap as a ``score_mod``
    (applied to the scaled logits, before the mask), the causal mask with
    the query offset as a ``block_mask``.  A yardstick only: the port
    never calls it."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    def causal(b, h, q_idx, kv_idx):
        return kv_idx <= q_idx + q_offset

    def capped(score, b, h, q_idx, kv_idx):
        return softcap * torch.tanh(score / softcap)

    block = create_block_mask(causal, None, None, qs.shape[2], ks.shape[2],
                              device=qs.device)
    return partial(torch.compile(flex_attention, dynamic=False), qs, ks, vs,
                   score_mod=capped if softcap else None, block_mask=block,
                   enable_gqa=ks.shape[1] != qs.shape[1])


def phase_flash_capped(torch, fa, ops):
    """The softcapped and offset instances against their plain versions at
    the main paths' shapes (phase 3): bf16 flash with softcap at llama's
    and gemma3's prefill shapes, fp32 at the llama replay's (q at
    ``CAP_Q_SCALE`` so that logits reach the cap), each beside
    ``flex_attention`` with the cap as a score_mod (``flex_call``, its
    ``library_ms``) and SDPA without the cap; bf16 at llama's shape with
    the last ``FLASH_OFFSET`` queries at that offset, held bit for bit
    against rows FLASH_OFFSET.. of the one-shot kernel output too, SDPA
    with the offset's explicit mask as its library call and
    ``flex_attention`` with the offset's block mask beside it.  Each
    flex output is held against the plain version at the kernel's
    tolerance.  Returns the records by label."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    F = torch.nn.functional
    recs = {}
    for label, shape, dt, kw in (
            ("softcap-llama", FLASH_GQA, "bfloat16", {"softcap": SOFTCAP}),
            ("softcap-gemma", FLASH_GEMMA, "bfloat16", {"softcap": SOFTCAP}),
            ("softcap-f32", FLASH_F32_REPLAY, "float32",
             {"softcap": SOFTCAP}),
            ("q_offset", FLASH_GQA, "bfloat16", {"q_offset": FLASH_OFFSET})):
        dtype = getattr(torch, dt)
        b, s, h, hk, d = shape
        q_scale = CAP_Q_SCALE if "softcap" in kw else 1.0

        def randn(heads):
            return (torch.randn(b, s, heads, d, generator=gen, device="cuda")
                    .to(dtype))

        q_full, k, v = randn(h) * q_scale, randn(hk), randn(hk)
        off = kw.get("q_offset", 0)
        q = q_full[:, off:]  # a view: the last s - off queries
        run = partial(ops.flash_attention_bhsd, q, k, v, **kw)
        plain = partial(fa.flash_attention_bhsd_plain, q, k, v, **kw)
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = FLASH_TOL[dt]
        check(bool(torch.allclose(got.float(), want.float(), atol=tol,
                                  rtol=tol)),
              f"flash_attention {label} {shape} {dt} {kw}: max abs err "
              f"{err:.3g} above {tol}")
        note = ""
        if off:
            one_shot = ops.flash_attention_bhsd(q_full, k, v)
            torch.cuda.synchronize()
            same = torch.equal(one_shot[:, off:], got)
            check(same, f"flash_attention q_offset={off}: rows {off}.. of "
                  "the one-shot kernel output differ from the offset call")
            note = (f"; bit-identical to rows {off}.. of the one-shot "
                    f"kernel output: {same}")
            del one_shot
        qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        t0 = time.perf_counter()
        flex = flex_call(torch, qs, ks, vs, kw.get("softcap", 0.0), off)
        flex_out = flex().transpose(1, 2)
        torch.cuda.synchronize()
        flex_s = time.perf_counter() - t0
        flex_err = float((flex_out.float() - want.float()).abs().max())
        check(bool(torch.allclose(flex_out.float(), want.float(), atol=tol,
                                  rtol=tol)),
              f"flex_attention {label} {shape} {dt} {kw}: max abs err "
              f"{flex_err:.3g} above {tol}: not the kernel's function")
        flex_ms = device_ms(torch, flex, 5, 3)
        if off:
            qpos = off + torch.arange(s - off, device="cuda")
            mask = torch.arange(s, device="cuda")[None, :] <= qpos[:, None]
            library_ms = device_ms(
                torch, partial(F.scaled_dot_product_attention, qs, ks, vs,
                               attn_mask=mask, enable_gqa=hk != h), 5, 3)
            nocap_ms = None
        else:
            library_ms = flex_ms
            nocap_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True, enable_gqa=hk != h), 5, 3)
        b_ms, b_by = flash_bound(b, s - off, h, hk, d, True,
                                 q.element_size(), sk=s, q_offset=off)
        rec = {"max_abs_err": err, "ms": device_ms(torch, run, 5, 3),
               "plain_ms": device_ms(torch, plain, 2, 2),
               "library_ms": library_ms, "flex_ms": flex_ms,
               "flex_max_abs_err": flex_err,
               "sdpa_uncapped_ms": nocap_ms,
               "bound_ms": b_ms, "bound_by": b_by}
        print(f"flash_attention {label} {shape} {dt} {kw}"
              + (f" (q at {q_scale}x)" if q_scale != 1 else "")
              + f": max_abs_err {err:.3g} (tol {tol}) | device ms: kernel "
              f"{rec['ms']:.6f} plain {rec['plain_ms']:.6f} "
              + (f"sdpa with the offset mask {library_ms:.6f} "
                 if off else f"sdpa without the cap {nocap_ms:.6f} ")
              + f"flex_attention {flex_ms:.6f} (max_abs_err {flex_err:.3g}; "
              f"compiled and first run in {flex_s:.2f} s) bound {b_ms:.6f} "
              f"({b_by}) | {100 * b_ms / rec['ms']:.1f} % of bound; "
              f"kernel/library {rec['ms'] / library_ms:.2f}x{note}")
        recs[label] = rec
        del q, q_full, k, v, qs, ks, vs, got, want, flex, flex_out
        torch.cuda.empty_cache()
    return recs


def scan_cases(lru):
    """Phase 3's scan checks as (shape, dtype, gates, offset): the
    reference's test shapes, S at the chunk's seams (1, L - 1, L, L + 1
    for the schedule's L = W * P) at a narrow C, C of 1 and 130, a
    contiguous view ``offset`` elements (4 bytes; in bf16 also 2) past
    a 16-byte boundary, a batch past the old grid's 65535, gates in
    (0.999, 1) at S = 2048, in fp32 and bf16; then the three serving
    shapes in fp32 (mamba's operands past 2^31 bytes)."""
    chunk = lru.WARPS * lru.STEPS
    shapes = SCAN_TEST_SHAPES + [(2, s, 8) for s in (1, chunk - 1, chunk,
                                                     chunk + 1)] + [
        (3, chunk + 1, 1), SCAN_BIG_BATCH]
    cases = []
    for dt in ("float32", "bfloat16"):
        cases += [(shape, dt, "uniform", 0) for shape in shapes]
        cases += [((2, 300, 130), dt, "uniform", 1 if dt == "float32" else 2),
                  (SCAN_NEAR1, dt, "near1", 0)]
    cases.append(((2, 300, 130), "bfloat16", "uniform", 1))
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


def scan_backward_bound(shape, itemsize):
    """The gradient's a (``itemsize``), h and gbar (fp32) read once and
    dL/da and dL/db (fp32) written once: 20 B an element with fp32 a, 18
    with bf16; 3 flops per element (the adjoint's multiply and add,
    dL/da's multiply) on the fp32 CUDA cores.  Returns (ms, bound_by,
    bytes)."""
    n = math.prod(shape)
    n_bytes = n * (itemsize + 4 * 4)
    return (*bound(n_bytes, 3.0 * n), n_bytes)


def scan_backward_parent(torch, lru, a, h, gbar):
    """The route the backward kernel replaced, rebuilt as the yardstick:
    the forward kernel on time-reversed contiguous copies of gbar and of
    a shifted by one step, flipped back, then dL/da = g h_{t-1}."""
    S = a.shape[1]
    a_rev = torch.zeros(a.shape, dtype=torch.float32, device=a.device)
    a_rev[:, 1:] = a[:, 1:].flip(1)
    g = lru.lru_scan(a_rev, gbar.float().flip(1)).flip(1)
    del a_rev
    grad_a = torch.zeros_like(g)
    grad_a[:, 1:] = g[:, 1:] * h[:, :S - 1]
    return grad_a, g


def check_scan_backward(torch, lru, a, h, gbar, label, scaled):
    """The backward kernel at (a, h, gbar): the parent route's bits
    (``torch.equal``) and within SCAN_TOL of the plain loop (with an
    atol of SCAN_TOL times max |g| where ``scaled``: gates near 1).
    Returns the max abs err against the plain version."""
    got = lru.lru_scan_backward_op(a, h, gbar)
    want = scan_backward_parent(torch, lru, a, h, gbar)
    torch.cuda.synchronize()
    for name, g, w in zip(("da", "db"), got, want):
        check(bool(torch.equal(g, w)), f"{label}: the backward kernel's "
              f"dL/{name} is not the parent route's bit for bit (max abs "
              f"diff {float((g - w).abs().max()):.3g})")
    del want
    plain = lru.lru_scan_backward_plain(a, h, gbar)
    err = 0.0
    for name, g, w in zip(("da", "db"), got, plain):
        e = float((g - w).abs().max())
        atol = SCAN_TOL * (float(w.abs().max()) if scaled else 1.0)
        check(bool(torch.allclose(g, w, atol=atol, rtol=SCAN_TOL)),
              f"{label}: backward dL/{name} max abs err {e:.3g} against the "
              f"plain loop, above atol {atol:.3g}, rtol {SCAN_TOL}")
        err = max(err, e)
    return err


def phase_scan(torch, lru, ops):
    """The scan kernel against its plain version (``scan_cases``): each
    within SCAN_TOL, the a == 0 identity exact, two calls bit-identical;
    the backward kernel at each case against the route it replaced, bit
    for bit, and the plain loop (``check_scan_backward``); and the
    three serving shapes timed.  Gates in (0.999, 1) over 2048
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
        # after the timing, which the backward check's large temporaries
        # would otherwise precede
        h = lru.lru_scan(a, b)
        gbar = torch.randn(math.prod(shape) + offset, generator=gen,
                           device="cuda")[offset:].view(shape)
        bwd_err = check_scan_backward(torch, lru, a, h, gbar, label,
                                      gates == "near1")
        del h, gbar
        print(f"{msg}; the backward kernel the parent route's bits, "
              f"max_abs_err {bwd_err:.3g} against the plain loop")
        del a, b
    torch.cuda.empty_cache()
    return recs


def make_data(rt, k=K):
    train = rt.data.SyntheticImages.make(6000, side=SIDE, seed=0)
    test = rt.data.SyntheticImages.make(1500, side=SIDE, seed=1)
    return rt.data.non_iid_split(train, test, K=k, per_device=600,
                                 mislabel_prop=0.1, seed=0)


def make_trainer(rt, torch, data, state_dict, device, telemetry=None,
                 monitor=False, faults=None, resilience=None,
                 geometry=(K, N, Q), **options):
    """A trainer at the §VI-A setup (``geometry``: its K, N, Q);
    ``telemetry``: an ``obs`` sink; ``monitor``: attach a
    ``ConvergenceMonitor`` writing to that sink and to the
    process-default metrics registry; ``faults`` and ``resilience``: the
    trainer's fault plan and resilience policies; ``options``: further
    ``FEELConfig`` fields."""
    cfg = rt.fed.FEELConfig(d_hat=D_HAT, gp_steps=GP_STEPS, lr=LR, **options)
    model = rt.models.cnn.CNN(rt.models.cnn.CNNConfig(side=SIDE))
    model.load_state_dict(state_dict)
    k, n, q = geometry
    sys_ = rt.core.default_system(K=k, N=n, Q=q, D_hat=D_HAT, device=device)
    mon = (rt.obs.ConvergenceMonitor(sys_, telemetry=telemetry,
                                     registry=rt.obs.metrics.get_default())
           if monitor else None)
    return rt.fed.FEELTrainer(sys_, data, model, cfg, telemetry=telemetry,
                              monitor=mon, faults=faults,
                              resilience=resilience)


def host(tensors):
    return {n: t.detach().cpu().clone() for n, t in tensors.items()}


def moved(state, device):
    """A copy of an optimizer state (NamedTuples, dicts and tuples of
    tensors and step counts) on ``device``."""
    if isinstance(state, dict):
        return {n: moved(v, device) for n, v in state.items()}
    if isinstance(state, tuple):
        items = [moved(v, device) for v in state]
        return type(state)(*items) if hasattr(state, "_fields") else \
            tuple(items)
    if hasattr(state, "detach"):
        return state.detach().to(device, copy=True)
    return state


def round_record(tr, before=None):
    """What a replay holds the card's round against.  ``signal``: per
    parameter the tensor whose entries at float32 noise mark where the
    optimizer's step direction is noise (Adam's first moment,
    adafactor's gradient; none for sgd and momentum, whose steps are
    linear in the gradient), and ``loose`` the most such an entry may
    differ by after the round: 2 * lr (Adam's step is at most about
    lr), and for adafactor, whose clipped step of an entry is not
    bounded by lr, |u| + max|u| with u the card's own step of the round
    (the params after it less ``before``, the params before it, which
    an adafactor record needs) and max|u| its tensor's largest: a
    flipped sign moves the entry by its own step on one side and at
    most its tensor's largest step on the other."""
    st, dec = tr.last_state, tr.last_decision
    opt = tr.cfg.optimizer
    params = host(tr.params)
    signal = (host(tr.opt_state.mu) if opt == "adam" else
              host(tr.last_g_hat) if opt == "adafactor" else {})
    if opt == "adafactor":
        check(before is not None,
              "an adafactor round record needs the params before the round")
        loose = {}
        for n, p in params.items():
            u = (p - before[n]).abs()
            loose[n] = u + u.max()
    else:
        loose = {n: p.new_full(p.shape, 2 * LR) for n, p in params.items()}
    return {"rho": dec.rho.copy(), "delta": dec.delta.cpu(),
            "delta_cont": (None if dec.delta_cont is None
                           else dec.delta_cont.cpu()),
            "sigma": st.sigma.cpu(), "net_cost": dec.net_cost,
            "params": params, "signal": signal,
            "opt_state": moved(tr.opt_state, "cpu"), "loose": loose,
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


def check_replayed_round(torch, want, cpu, label):
    """The replay rule for one round run from the same params and
    optimizer state: ``check_same_decision``, sigma at SIGMA_RTOL, and
    params: an entry whose ``signal`` is at float32 noise may differ by
    up to its ``loose`` bound, every entry by that much; the others,
    while the selections are equal, at atol 1e-6 + rtol 1e-5."""
    dec = cpu.last_decision
    differ, in_band = check_same_decision(torch, want, dec, label)
    sig_rel = max_rel(want["sigma"], cpu.last_state.sigma)
    check(sig_rel <= SIGMA_RTOL, f"{label}: sigma rel err {sig_rel:.3g}")
    worst, n_noise, n_total, widest = 0.0, 0, 0, 0.0
    same_selection = not bool(differ.any())
    for name, p in cpu.params.items():
        p_g = want["params"][name]
        noise = torch.zeros_like(p_g, dtype=torch.bool)
        if name in want["signal"]:
            s_abs = want["signal"][name].abs()
            noise = (s_abs > 0) & (s_abs <= NOISE * s_abs.max())
        diff = (p.detach() - p_g).abs()
        n_noise += int(noise.sum())
        n_total += p.numel()
        if same_selection:
            tight = 1e-6 + 1e-5 * p_g.abs()
            check(bool(torch.all(diff[~noise] <= tight[~noise])),
                  f"{label}: params {name} differ")
        loose = want["loose"][name]
        check(bool(torch.all(diff <= loose)),
              f"{label}: params {name} differ")
        worst = max(worst, float(diff.max()))
        widest = max(widest, float(loose.max()))
    return (f"rho equal, selection equal outside |delta-1/2|<"
            f"{SELECTION_BAND} ({int(in_band.sum())} entries in the band, "
            f"{int(differ.sum())} differ), sigma max rel err {sig_rel:.3g}, "
            f"net_cost gpu {want['net_cost']:.6f} cpu {dec.net_cost:.6f}, "
            f"params max abs err {worst:.3g} ({n_noise}/{n_total} entries "
            f"whose step direction is at float32 noise held at the loose "
            f"bound, at most {widest:.3g})")


def phase_replay(rt, torch, data, init_sd, gpu_recs, label="",
                 geometry=(K, N, Q), **options):
    """The card's first rounds again on the CPU (same trainer
    ``options``, the same initial state and channel draws), each held
    against the card's under ``check_replayed_round``.  ``gpu_recs``:
    one ``round_record`` or a list, one a round from round 0.  Round
    i > 0 starts from the card's params and optimizer state after round
    i - 1, so each round is held to one round's divergence: an entry
    that Adam or adafactor moved by a noise-level step would otherwise
    carry its up to 2 * lr into every later round."""
    if isinstance(gpu_recs, dict):
        gpu_recs = [gpu_recs]
    cpu = make_trainer(rt, torch, data, init_sd, "cpu", geometry=geometry,
                       **options)
    for i, want in enumerate(gpu_recs):
        if i:
            prev = gpu_recs[i - 1]
            with torch.no_grad():
                for name, p in cpu.params.items():
                    p.copy_(prev["params"][name])
            cpu.opt_state = moved(prev["opt_state"], "cpu")
        t0 = time.perf_counter()
        cpu.run_round(i)
        wall = time.perf_counter() - t0
        line = check_replayed_round(torch, want, cpu, f"replay{label}")
        print(f"replay{label} round {i} on cpu ({wall:.2f} s): {line}")


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


def check_assignment(rho, alpha, label, q=Q):
    """Definition 1 / constraints (12)-(14): each available device at
    most one RB, each RB at most q devices, no RB for an unavailable
    device."""
    per_dev, per_rb = rho.sum(axis=1), rho.sum(axis=0)
    avail = alpha > 0
    check(bool((per_dev[avail] <= 1).all()) and bool((per_dev[~avail] == 0)
                                                     .all()),
          f"{label}: a device holds more than one RB or is unavailable")
    check(bool((per_rb <= q).all()), f"{label}: an RB holds more than {q}")


def check_round(torch, tr, label, i, k=K):
    """Finite sigma of shape (k, D̂), finite params, a valid assignment."""
    st, dec = tr.last_state, tr.last_decision
    check(tuple(st.sigma.shape) == (k, D_HAT), f"{label}: sigma shape")
    check(bool(torch.isfinite(st.sigma).all()), f"{label}: sigma not finite")
    check(all(bool(torch.isfinite(p).all()) for p in tr.params.values()),
          f"{label} round {i}: params not finite")
    check_assignment(dec.rho, st.alpha.cpu().numpy(), label, tr.sys.Q)


def phase_options(rt, torch, data, init_sd, kernels, gradnorm):
    """Phase 23: each of ``OPTION_RUNS`` for ``OPTION_ROUNDS`` rounds on
    the card, each replayed on the CPU; run (c)'s checkpoint written on
    the card and resumed on the CPU.  Returns the launches of the
    card's rounds, summed over the runs."""
    import shutil
    import tempfile

    total = {}
    for label, options, per_round in OPTION_RUNS:
        name = f"options ({label}) " + " ".join(
            f"{k}={v}" for k, v in options.items())
        tele = rt.obs.Telemetry()  # in memory: the stage times
        tr = make_trainer(rt, torch, data, init_sd, "cuda", telemetry=tele,
                          **options)
        for m in kernels:
            m.reset_launch_counts()
        recs, ms = [], []
        for i in range(OPTION_ROUNDS):
            before = host(tr.params)
            m = tr.run_round(i)
            check_round(torch, tr, name, i)
            check(gradnorm.LAUNCHES["gradnorm_sigma"] == per_round * (i + 1),
                  f"{name}: gradnorm_sigma launches {dict(gradnorm.LAUNCHES)}"
                  f" after round {i}")
            print_round(name, i, m, rt.obs, tele)
            recs.append(round_record(tr, before))
            ms.append(m)
        if tr.cfg.warmup_rounds:
            check(ms[0].n_selected == K * D_HAT and recs[0]["delta_cont"]
                  is None, f"{name}: the warmup round did not select all")
            check("selection" in stage_ms(rt.obs, tele, 0),
                  f"{name}: the warmup round has no selection stage")
        if label == "c":
            # a checkpoint written on the card, resumed on the CPU; both
            # then run round OPTION_ROUNDS
            tmp = tempfile.mkdtemp(prefix="chip_smoke_")
            path = tr.save_checkpoint(str(Path(tmp) / "ck"),
                                      next_round=OPTION_ROUNDS)
            saved = {"params": host(tr.params), "vr": host(tr.opt_state.vr),
                     "vc": host(tr.opt_state.vc),
                     "count": tr.opt_state.count}
            tr.run_round(OPTION_ROUNDS)
            card = round_record(tr, saved["params"])
            cpu = make_trainer(rt, torch, data, init_sd, "cpu", **options)
            check(cpu.resume(path) == OPTION_ROUNDS, f"{name}: resumed round")
            same = (cpu.opt_state.count == saved["count"]
                    and all(torch.equal(cpu.params[n], saved["params"][n])
                            for n in saved["params"])
                    and all(torch.equal(getattr(cpu.opt_state, f)[n],
                                        saved[f][n])
                            for f in ("vr", "vc") for n in saved[f]))
            check(same, f"{name}: the CPU's resumed params or adafactor "
                  "state differ from the card's")
            t0 = time.perf_counter()
            cpu.run_round(OPTION_ROUNDS)
            line = check_replayed_round(torch, card, cpu,
                                        f"{name} resumed on cpu")
            n_bytes = sum(os.path.getsize(Path(tmp) / f)
                          for f in os.listdir(tmp))
            print(f"{name}: checkpoint of round {OPTION_ROUNDS} written on "
                  f"the card ({n_bytes} bytes), resumed on the cpu with "
                  f"params, vr, vc and count (={saved['count']}) "
                  f"bit-identical; round {OPTION_ROUNDS} on cpu "
                  f"({time.perf_counter() - t0:.2f} s): {line}")
            shutil.rmtree(tmp)
        launches = kernel_launches(kernels)
        want = per_round * (OPTION_ROUNDS + (label == "c"))
        check(launches == {"rownorm2": 0, "gradnorm_sigma": want,
                           "flash_attention": 0, "lru_scan": 0,
                           "lru_scan_backward": 0},
              f"{name}: launches {launches}")
        print(f"{name}: launches {launches}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        del tr
        phase_replay(rt, torch, data, init_sd, recs, label=f" {name}",
                     **options)
    return total


def phase_k256(rt, torch, init_sd, kernels, gradnorm):
    """Phase 24: ``ROUNDS256`` rounds of ``K256`` devices on the card
    with the chunked GP and the batched matching sweep, sigma through
    the kernel at (K256 * D̂, 84) + (K256 * D̂, 10); round 0 replayed
    on the CPU.  Returns the launches of the card's rounds."""
    data = make_data(rt, K256)
    geometry = (K256, N256, Q256)
    options = dict(selection_chunk=CHUNK256, matching_mode="batched")
    tele = rt.obs.Telemetry()  # in memory: the stage times
    tr = make_trainer(rt, torch, data, init_sd, "cuda", telemetry=tele,
                      geometry=geometry, **options)
    print(f"K={K256} path: N={N256} Q={Q256} d_hat={D_HAT} side={SIDE} "
          f"gp_steps={GP_STEPS} {options}; sigma through the kernel at "
          f"({K256 * D_HAT}, 84) + ({K256 * D_HAT}, 10)")
    for m in kernels:
        m.reset_launch_counts()
    rec0, walls = None, []
    for i in range(ROUNDS256):
        m = tr.run_round(i)
        check_round(torch, tr, f"K={K256}", i, K256)
        check(gradnorm.LAUNCHES["gradnorm_sigma"] == i + 1,
              f"K={K256}: gradnorm_sigma launches {dict(gradnorm.LAUNCHES)} "
              f"after round {i}")
        check(m.n_selected > 0 and abs(m.net_cost) < float("inf"),
              f"K={K256}: empty selection or non-finite net cost")
        print_round(f"K={K256}", i, m, rt.obs, tele)
        walls.append(m.wall_s)
        if i == 0:
            rec0 = round_record(tr)
    launches = kernel_launches(kernels)
    check(launches == {"rownorm2": 0, "gradnorm_sigma": ROUNDS256,
                       "flash_attention": 0, "lru_scan": 0,
                       "lru_scan_backward": 0},
          f"K={K256}: launches {launches}")
    later = [stage_ms(rt.obs, tele, i) for i in range(1, ROUNDS256)]
    print(f"K={K256}: launches {launches}; rounds 1-{ROUNDS256 - 1} wall ms "
          f"{[round(w * 1e3, 3) for w in walls[1:]]}, stage ms "
          + "; ".join(" ".join(f"{k}={v:.3f}" for k, v in st.items())
                      for st in later))
    del tr
    phase_replay(rt, torch, data, init_sd, rec0, label=f" K={K256}",
                 geometry=geometry, **options)
    return launches


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
    launches = kernel_launches(kernels)
    check(launches == {"rownorm2": 0, "gradnorm_sigma": 4 * ROUNDS,
                       "flash_attention": 0, "lru_scan": 0,
                       "lru_scan_backward": 0},
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
    launches = kernel_launches(kernels)
    check(launches == {"rownorm2": 0, "gradnorm_sigma": 1,
                       "flash_attention": 0, "lru_scan": 0,
                       "lru_scan_backward": 0},
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
    launches = kernel_launches(kernels)
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
                       "flash_attention": 0, "lru_scan": 0,
                       "lru_scan_backward": 0},
          f"launches on the traced and untraced rounds {launches}")
    kernel_flops, kernel_bytes = gradnorm.cost(K * D_HAT, 84, 10)
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
    # the profile's FLOPs: the forward's convolutions and matmuls and the
    # kernel, a custom op the flop counter counts by its own formula
    # (``gradnorm.cost``)
    from torch.utils.flop_counter import FlopCounterMode
    gen = torch.Generator(device="cuda").manual_seed(3)
    images = torch.rand((K, D_HAT, SIDE, SIDE), generator=gen,
                        device="cuda")
    labels = torch.randint(0, 10, (K, D_HAT), generator=gen, device="cuda")
    with FlopCounterMode(display=False) as fc:
        rt.fed.client.batched_sigma(proposed.model, images, labels)
    visible = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        gradnorm.gradnorm_sigma(images.new_zeros(K * D_HAT, 84),
                                images.new_zeros(K * D_HAT, 10))
    check(fc.get_total_flops() == kernel_flops,
          f"the kernel's op counts {fc.get_total_flops()} FLOPs, its own "
          f"count is {kernel_flops}")
    for p in sig_prof:
        check(p.flops > kernel_flops and p.flops == visible,
              f"sigma_all profile: {p.flops} FLOPs, expected {visible} "
              f"(with the kernel's {kernel_flops})")
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
    launches = kernel_launches(kernels)
    check(launches == {"rownorm2": 0,
                       "gradnorm_sigma": 2 * FAULT_ROUNDS - RESUME_AT,
                       "flash_attention": 0, "lru_scan": 0,
                       "lru_scan_backward": 0},
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
    launches = kernel_launches(kernels)
    check(launches == {"rownorm2": 0,
                       "gradnorm_sigma": 3 * FAULT_ROUNDS - 2 * RESUME_AT,
                       "flash_attention": 0, "lru_scan": 0,
                       "lru_scan_backward": 0},
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
    """One round under torch.profiler: device operations and busy time.
    Device activity only: nothing here reads the host's events, and
    recording the round's ~216k host operations as well roughly doubles
    its wall under the profiler, which overstates the idle share."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    launches = kernel_launches(kernels)
    peak = torch.cuda.max_memory_allocated()
    check(res.launches == expected,
          f"{name}: launches per phase {res.launches}, expected {expected}")
    total = {k: 0 for k in launches}
    for phase in expected.values():
        for k, v in phase.items():
            total[k] += v
    check(launches == total, f"launches on the {name} path {launches}, "
          f"expected {total}")
    check(tuple(res.tokens.shape[:2]) == (batch, NEW_TOKENS + 1)
          and res.tokens.dim() in (2, 3),  # audio: a token per codebook
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
    step runs them.  Returns (name, device ms) of the prefill's flash
    kernel launches."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve as serve_mod
    cfg = get_config(arch) if isinstance(arch, str) else arch
    arch = cfg.name
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = tm.init_model(cfg, gen, "cuda")
    request = serve_mod.prefill_batch(cfg, SERVE_BATCH, PROMPT, gen, "cuda")
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
        return [(e.name, e.time_range.elapsed_us() / 1e3) for e in dev
                if "flash" in e.name]

    flash_names = step("prefill", lambda: prefill(model, request, cache))
    tok = torch.zeros((SERVE_BATCH,) + ((cfg.n_codebooks,) if
                                        cfg.modality == "audio" else ()),
                      dtype=torch.long, device="cuda")
    step("decode step", lambda: decode(
        model, cache, serve_mod.decode_batch(cfg, tok, PROMPT)))
    del model, cache
    torch.cuda.empty_cache()
    return flash_names


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
    prompt, step_batch = replay_request(torch, cfg)
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
        toks, steps = [tok.tolist()], []
        for i in range(REPLAY_STEPS):
            logits, cache = decode(model, cache, step_batch(tok, i))
            steps.append(logits.cpu())
            tok = torch.argmax(logits[:, -1], -1)
            toks.append(tok.tolist())
        return toks, steps

    def run(device):
        t0 = time.perf_counter()
        with full_fp32():
            cache = tm.make_cache(cfg, 1, REPLAY_PROMPT + REPLAY_STEPS,
                                  device=device)
            for m in moes:
                m.routing_log = []
            logits, cache = prefill(
                model, {k: v.to(device) for k, v in prompt.items()}, cache)
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
    launches = kernel_launches(kernels)
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
          f"off, {cfg.modality} prompt {REPLAY_PROMPT}, {REPLAY_STEPS} "
          f"greedy steps): "
          f"prefill logits max abs err {err:.3g} (max |logit| "
          f"{float(ref.abs().max()):.3g}){held_msg}{paths_msg}; cpu "
          f"{cpu['s']:.2f} s, card {gpu['s']:.2f} s; card launches "
          f"{launches}")
    return launches


def replay_request(torch, cfg):
    """The replays' prompt (batch 1, ``REPLAY_PROMPT`` long, on the CPU)
    for ``cfg``'s modality and decode step i's batch, ``step(tok, i)``:
    text tokens, or an audio (1, C, S) grid, from a generator seeded with
    1; vlm standard-normal embeds with M-RoPE positions whose three rows
    differ (``REPLAY_GRID_AT`` text tokens, a ``REPLAY_GRID`` (t, h, w)
    image grid at their end + (t, h, w), then text from there + max(t,
    h, w)), decoded from zero embeds at the text positions after it."""
    from repro_torch.launch import serve as serve_mod
    gen = torch.Generator().manual_seed(1)
    if cfg.modality != "vlm":
        shape = ((1, cfg.n_codebooks, REPLAY_PROMPT)
                 if cfg.modality == "audio" else (1, REPLAY_PROMPT))
        return ({"tokens": torch.randint(0, cfg.vocab, shape,
                                         generator=gen)},
                lambda tok, i: serve_mod.decode_batch(cfg, tok,
                                                      REPLAY_PROMPT + i))
    t, h, w = REPLAY_GRID
    grid = torch.stack(torch.meshgrid(torch.arange(t), torch.arange(h),
                                      torch.arange(w), indexing="ij")
                       ).reshape(3, -1)
    start = REPLAY_GRID_AT + max(REPLAY_GRID)
    n_text = REPLAY_PROMPT - REPLAY_GRID_AT - grid.shape[1]
    pos = torch.cat([torch.arange(REPLAY_GRID_AT).expand(3, -1),
                     REPLAY_GRID_AT + grid,
                     (start + torch.arange(n_text)).expand(3, -1)], dim=1)
    check(bool((pos[0] != pos[1]).any() and (pos[1] != pos[2]).any()),
          "the vlm replay's M-RoPE rows must differ")
    nxt = start + n_text
    return ({"embeds": torch.randn(1, REPLAY_PROMPT, cfg.d_model,
                                   generator=gen),
             "positions": pos[None].contiguous()},
            lambda tok, i: serve_mod.decode_batch(cfg, tok,
                                                  REPLAY_PROMPT + i, nxt + i))


# ------------------------------------------------------------ training

def phase_train_kernels(torch, gradnorm, lru, ops, device="cuda"):
    """Phase 3's train shapes: ``gradnorm_sigma`` at the train steps'
    (``SIGMA_TRAIN``: llama's; ``SIGMA_TRAIN_QWEN``, ``_MUSICGEN``,
    ``_GEMMA``)
    against its plain version, timed beside its bound,
    ``torch.linalg.vector_norm`` of both operands and each operand's
    ``einsum("nd,nd->n")`` (``rownorm2``'s function in one call); the
    scan at the train shapes (``SCAN_TRAIN``) timed, and its gradient
    through the kernels (``ops.lru_scan``) against autograd
    through the plain loop on the card; the backward kernel against the
    route it replaced (bit for bit) and the plain loop, then timed in
    turns with that route (route, kernel, kernel, route, twice) beside
    the plain loop and its own bound (``scan_backward_bound``: 20 B an
    element).  Returns (the sigma records by shape, the scan records by
    shape, the backward kernel's records by shape)."""
    gen = torch.Generator(device=device).manual_seed(7)
    sigma_recs = {}
    for shape, label in ((SIGMA_TRAIN, "llama3.2-3b"),
                         (SIGMA_TRAIN_QWEN, "qwen2-vl-2b"),
                         (SIGMA_TRAIN_MUSICGEN, "musicgen-medium, 4 "
                                                "codebooks folded"),
                         (SIGMA_TRAIN_GEMMA, "softcapped gemma3-12b cut")):
        n, fh, fd = shape
        h = torch.randn(n, fh, generator=gen, device=device)
        d = torch.randn(n, fd, generator=gen, device=device)
        got = gradnorm.gradnorm_sigma(h, d)
        want = gradnorm.gradnorm_sigma_plain(h, d)
        rel = max_rel(got, want)
        check(rel <= KERNEL_RTOL, f"gradnorm_sigma {shape}: rel err "
              f"{rel:.3g}")
        flops, n_bytes = gradnorm.cost(n, fh, fd)
        b_ms, b_by = bound(n_bytes, flops)
        rec = {"max_abs_err": float((got - want).abs().max()),
               "ms": device_ms(torch, lambda: gradnorm.gradnorm_sigma(h, d),
                               10, 3),
               "plain_ms": device_ms(
                   torch, lambda: gradnorm.gradnorm_sigma_plain(h, d), 2, 2),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        del got, want
        vn_ms = device_ms(torch, lambda: (torch.linalg.vector_norm(h, dim=-1),
                                          torch.linalg.vector_norm(d, dim=-1)),
                          10, 3)
        es_ms = [device_ms(torch, lambda x=x: torch.einsum("nd,nd->n", x, x),
                           10, 3) for x in (h, d)]
        print(f"gradnorm_sigma ({n}, {fh})+({n}, {fd}) ({label}'s train "
              f"step): max_abs_err {rec['max_abs_err']:.3g} max_rel_err "
              f"{rel:.3g} | device ms: kernel {rec['ms']:.6f} plain "
              f"{rec['plain_ms']:.6f} vector_norm of both operands "
              f"{vn_ms:.6f} einsum('nd,nd->n') of h {es_ms[0]:.6f} of p - y "
              f"{es_ms[1]:.6f} (both {sum(es_ms):.6f}) bound {b_ms:.6f} "
              f"({b_by}, {n_bytes:,.0f} B) | "
              f"{100 * b_ms / rec['ms']:.1f} % of bound, "
              f"{n_bytes / rec['ms'] / 1e6:.1f} GB/s")
        sigma_recs[shape] = rec
        del h, d
        torch.cuda.empty_cache()

    scan_recs, bwd_recs = {}, {}
    for shape in SCAN_TRAIN:
        big = shape[2] > 8192
        a = torch.rand(shape, generator=gen, device=device)
        b = torch.randn(shape, generator=gen, device=device)
        w = torch.randn(shape, generator=gen, device=device)
        # the forward timed first, before the checks' large temporaries
        b_ms, b_by, n_bytes = scan_bound(shape, 4)
        rec = {"ms": device_ms(torch, lambda: lru.lru_scan(a, b),
                               *((5, 3) if big else (50, 5))),
               "plain_ms": device_ms(torch, lambda: lru.lru_scan_plain(a, b),
                                     *((1, 2) if big else (5, 3))),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        a1, b1 = a.clone().requires_grad_(), b.clone().requires_grad_()
        lru.reset_launch_counts()
        h = ops.lru_scan(a1, b1)
        got = torch.autograd.grad((h * w).sum(), (a1, b1))
        torch.cuda.synchronize()
        check(lru.LAUNCHES == {"lru_scan": 1, "lru_scan_backward": 1},
              f"lru_scan gradient {shape}: launches {lru.LAUNCHES}")
        del a1, b1, h
        a2, b2 = a.clone().requires_grad_(), b.clone().requires_grad_()
        want = torch.autograd.grad((lru.lru_scan_plain(a2, b2) * w).sum(),
                                   (a2, b2))
        del a2, b2
        errs = []
        for name, g, ref in zip(("a", "b"), got, want):
            errs.append(float((g - ref).abs().max()))
            check(bool(torch.allclose(g, ref, rtol=SCAN_TOL, atol=SCAN_TOL)),
                  f"lru_scan gradient {shape} d/d{name}: max abs err "
                  f"{errs[-1]:.3g}")
        del got, want
        rec["max_abs_err"] = max(errs)
        fwd = lru.lru_scan(a, b)
        label = f"lru_scan_backward {shape} fp32 (a train step's)"
        bwd_err = check_scan_backward(torch, lru, a, fwd, w, label, False)
        reps = (2, 2) if big else (20, 3)

        def kernel():
            return lru.lru_scan_backward_op(a, fwd, w)

        def route():
            return scan_backward_parent(torch, lru, a, fwd, w)

        turns = []  # route, kernel, kernel, route, twice
        for fn in (route, kernel, kernel, route) * 2:
            turns.append(device_ms(torch, fn, *reps))
            torch.cuda.empty_cache()
        k_ms = sorted(turns[1:3] + turns[5:7])
        r_ms = sorted(turns[0:1] + turns[3:5] + turns[7:8])
        bb_ms, bb_by, bb_bytes = scan_backward_bound(shape, 4)
        bwd = {"max_abs_err": bwd_err, "ms": (k_ms[1] + k_ms[2]) / 2,
               "parent_ms": (r_ms[1] + r_ms[2]) / 2,
               "plain_ms": device_ms(
                   torch, lambda: lru.lru_scan_backward_plain(a, fwd, w),
                   *((1, 2) if big else (5, 3))),
               "bound_ms": bb_ms, "bound_by": bb_by, "library_ms": None}
        print(f"lru_scan {shape} fp32 (a train step's): gradient through "
              f"the kernels against autograd through the plain loop, max abs "
              f"err d/da {errs[0]:.3g} d/db {errs[1]:.3g} | device ms: "
              f"kernel {rec['ms']:.6f} plain {rec['plain_ms']:.6f} bound "
              f"{b_ms:.6f} ({b_by}), {100 * b_ms / rec['ms']:.1f} % of bound")
        print(f"{label}: the parent route's bits, max_abs_err "
              f"{bwd_err:.3g} against the plain loop | device ms in turns "
              "(route / kernel / kernel / route, twice): "
              + " / ".join(f"{t:.6f}" for t in turns)
              + f" | kernel (median) {bwd['ms']:.6f} route (median) "
              f"{bwd['parent_ms']:.6f} ({bwd['parent_ms'] / bwd['ms']:.2f}x) "
              f"plain {bwd['plain_ms']:.6f} bound {bb_ms:.6f} ({bb_by}, "
              f"{bb_bytes:,} B) | {100 * bb_ms / bwd['ms']:.1f} % of bound, "
              f"{bb_bytes / bwd['ms'] / 1e6:.1f} GB/s; the route "
              f"{100 * bb_ms / bwd['parent_ms']:.1f} %")
        scan_recs[shape], bwd_recs[shape] = rec, bwd
        del a, b, w, fwd
        torch.cuda.empty_cache()
    return sigma_recs, scan_recs, bwd_recs


def profile_train_step(torch, train_mod, cfg, label, batch, seq):
    """Where a train step's time goes, on a fresh model of ``cfg`` after
    a warm-up step: one step with a CUDA event at the end of each stage
    (the train step's ``mark``: forward, per-example loss, sigma,
    selection, backward with the remat recompute inside it, optimizer),
    then one step under ``torch.profiler``: device operations, busy time
    against wall time, GEMMs' share, the kernels that take most device
    time, and the sigma and scan kernels' time (the scan's forward and
    backward kernels apart).  Returns the stages' ms by name."""
    from torch.profiler import ProfilerActivity, profile
    model, _, state, step = train_mod.setup(cfg, 0, "cuda", True,
                                            TRAIN_CLIENTS)
    b = train_mod.synth_batch(cfg, torch.Generator(device="cuda")
                              .manual_seed(0), batch, seq, TRAIN_CLIENTS,
                              True, device="cuda")
    held = [model, state]

    def one(mark=None):
        held[0], held[1], _ = step(held[0], held[1], b,
                                   **({"mark": mark} if mark else {}))

    one()
    torch.cuda.synchronize()
    events = [("start", torch.cuda.Event(enable_timing=True))]

    def mark(name):
        events.append((name, torch.cuda.Event(enable_timing=True)))
        events[-1][1].record()

    events[0][1].record()
    t0 = time.perf_counter()
    one(mark)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    stages = [(n, events[i][1].elapsed_time(e))
              for i, (n, e) in enumerate(events[1:])]
    print(f"{label} train step by stage (CUDA events, ms): "
          + ", ".join(f"{n} {ms:.3f}" for n, ms in stages)
          + f"; total {sum(ms for _, ms in stages):.3f} of wall {wall:.3f}"
          " (backward holds the remat recompute of every pattern repeat)")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gemm = sum(ms for n, ms in by_name.items()
               if any(k in n for k in ("gemm", "nvjet", "xmma", "cutlass")))
    mine = {k: [e.time_range.elapsed_us() / 1e3 for e in dev if k in e.name]
            for k in ("gradnorm_sigma_kernel", "lru_scan_kernel",
                      "lru_scan_backward_kernel")}
    print(f"{label} train step under the profiler: {len(dev)} device "
          f"operations, device busy {busy:.3f} ms of wall {wall:.3f} ms, "
          f"device idle share {1 - busy / wall:.4f}; GEMMs {gemm:.3f} ms "
          f"({100 * gemm / busy:.1f} % of busy); top device time: "
          + "; ".join(f"{n[:60]} {ms:.3f} ms" for n, ms in top)
          + "".join(f"; {k} {sum(v):.3f} ms in {len(v)} launches"
                    for k, v in mine.items() if v))
    del model, state, held, b
    torch.cuda.empty_cache()
    return dict(stages)


def phase_train(torch, train_mod, kernels, cfg, batch, seq, steps,
                per_step, label, device="cuda"):
    """``steps`` FEEL train steps of ``cfg`` through
    ``train_mod.run`` (the entry point), every launch count zeroed just
    before and read just after; each step must make ``per_step``
    launches and a finite loss.  Prints each step and the run's wall,
    throughput and peak memory; returns (launches, the result)."""
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() if device == "cuda" else 0
    for m in kernels:
        m.reset_launch_counts()
    res = train_mod.run(cfg, steps=steps, batch=batch, seq=seq,
                        n_clients=TRAIN_CLIENTS, log_every=steps,
                        device=device)
    launches = kernel_launches(kernels)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    for i, got in enumerate(res.launches):
        check(got == per_step, f"{label} step {i}: launches {got}, "
              f"expected {per_step}")
    check(all(math.isfinite(x) for x in res.losses + res.ex_loss),
          f"{label}: a loss is not finite: {res.losses}")
    for i in range(steps):
        print(f"train {label} step {i}: wall {res.step_s[i] * 1e3:.3f} ms | "
              f"loss {res.losses[i]:.6f} (eq. 19) per-example mean "
              f"{res.ex_loss[i]:.6f} aux {res.aux_loss[i]:.6g} "
              f"selected_frac {res.selected_frac[i]:.4f} sigma_mean "
              f"{res.sigma_mean[i]:.6g}")
    ms = [t * 1e3 for t in res.step_s]
    rest = sorted(ms[1:]) or ms
    tok = batch * seq / (rest[len(rest) // 2] / 1e3)
    where = torch.cuda.get_device_name(0) if device == "cuda" else device
    print(f"train {label} ({where}): "
          f"params {res.n_params:,}, K={TRAIN_CLIENTS}, batch {batch} x seq "
          f"{seq}, {steps} steps, FEEL on | step ms first {ms[0]:.3f}, "
          f"steps 1-{steps - 1} median {rest[len(rest) // 2]:.3f} min "
          f"{rest[0]:.3f} max {rest[-1]:.3f} ({tok:.1f} tok/s) | peak "
          f"memory {peak / 2**30:.3f} GiB ({before / 2**30:.3f} allocated "
          f"before the run) | per-example loss {res.ex_loss[0]:.6f} -> "
          f"{res.ex_loss[-1]:.6f} | summed MoE aux loss per step "
          f"{[round(a, 6) for a in res.aux_loss]} | launches {launches}, "
          f"per step {res.launches[0]}")
    return launches, res


def phase_train_replay(torch, train_mod, replay, tm, full_fp32, get_config,
                       kernels, arch, scan_layers, device="cuda", cfg=None):
    """``arch`` at full width cut to 2 layers (or ``cfg``), fp32 with TF32
    off: a few FEEL steps on the card, then ``REPLAY_TRAIN_STEPS`` more,
    each replayed on the CPU from the card's params, optimizer state and
    batch by
    ``replay.replay_step`` (the rule of ``launch/replay.py``).  Prints
    each client's smallest sigma gap, each side's sigma error against a
    float64 recompute, and whether the card's selection was taken as
    given.  Returns the card's launches over the replayed steps."""
    cfg = cfg or get_config(arch).scaled(dtype="float32",
                                         n_layers=REPLAY_LAYERS)
    feel = tm.FeelIntegration(n_clients=TRAIN_CLIENTS)
    t0 = time.perf_counter()
    launches = {}
    with full_fp32():
        model, opt, state, step = train_mod.setup(cfg, 0, device, True,
                                                  TRAIN_CLIENTS)

        def batch(i):
            return train_mod.synth_batch(
                cfg, torch.Generator(device=device).manual_seed(100 + i),
                REPLAY_TRAIN_BATCH, REPLAY_TRAIN_SEQ, TRAIN_CLIENTS, True,
                device=device)

        for i in range(REPLAY_TRAIN_WARM):
            model, state, _ = step(model, state, batch(i))
        for i in range(REPLAY_TRAIN_STEPS):
            for m in kernels:
                m.reset_launch_counts()
            state, rep = replay.replay_step(cfg, opt, feel, model, state,
                                            batch(REPLAY_TRAIN_WARM + i),
                                            cfg.optimizer, 0.01)
            got = kernel_launches(kernels)
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
            check(got["gradnorm_sigma"] == 1
                  and got["lru_scan"] == 2 * scan_layers
                  and got["lru_scan_backward"] == scan_layers
                  and got["flash_attention"] == 0,
                  f"{arch} replay step {i}: card launches {got}")
            p, gaps = rep["params"], rep["gaps"]
            print(f"{arch} train replay step {i} (d_model "
                  f"{cfg.d_model}, {cfg.n_layers} layers, fp32, TF32 off, "
                  f"{cfg.optimizer}, K="
                  f"{TRAIN_CLIENTS}, batch {REPLAY_TRAIN_BATCH} x seq "
                  f"{REPLAY_TRAIN_SEQ}, after {REPLAY_TRAIN_WARM + i} card "
                  f"steps): loss card {rep['loss_card']:.7f} cpu "
                  f"{rep['loss_cpu']:.7f} (rel {rep['loss_rel']:.3g}), "
                  f"per-example loss rel {rep['ex_loss_rel']:.3g}, sigma rel "
                  f"{rep['sigma_rel']:.3g} (against float64: card "
                  f"{rep['sigma64_card']:.3g}, cpu {rep['sigma64_cpu']:.3g}; "
                  f"sigma {rep['sigma_range'][0]:.6g} to "
                  f"{rep['sigma_range'][1]:.6g}), smallest relative sigma "
                  f"gap per client {[float(f'{g:.3g}') for g in gaps]}, "
                  + ("the card's selection TAKEN AS GIVEN (a client's gap "
                     f"within {replay.GAP_FACTOR:g} x the sigma error)"
                     if rep["given"] else "selection equal")
                  + f" ({rep['selected']} of {rep['examples']} kept), "
                  f"gradients within the rule (worst {rep['grad_ratio']:.3g} "
                  f"of its bound, {rep['grad_leaf']}), params max abs err "
                  f"{p['max_abs_err']:.3g} ({p['decided_max_abs_err']:.3g} "
                  f"on entries with a gradient above the atol; "
                  f"{p['noise']:,} of {p['entries']:,} entries at gradient "
                  f"noise), aux card {rep['aux_card']:.6g} cpu "
                  f"{rep['aux_cpu']:.6g}; cpu {rep['cpu_s']:.2f} s; card "
                  f"launches {got}")
    del model, state
    if device == "cuda":
        torch.cuda.empty_cache()
    print(f"{arch} train replay: {time.perf_counter() - t0:.2f} s")
    return launches


def phase_softcap(torch, serve_mod, train_mod, replay, tm, full_fp32,
                  get_config, kernels, served16):
    """Phase 35: gemma3-12b with ``attn_logit_softcap = SOFTCAP`` through
    the entry points.  (a) served at full width and depth, the flash
    launches of a profiled prefill checked to be the softcapped
    instance, printed beside phase 16's uncapped serve (``served16``:
    prefill s, decode steps, peak bytes); (b) one pattern replayed in
    fp32 on the CPU as phase 17; (c) FEEL train steps cut to one pattern;
    (d) 2 train steps of a 2-layer fp32 cut, its vocabulary cut to
    ``SOFTCAP_REPLAY_VOCAB``, replayed on the CPU.  Returns each part's
    launches."""
    def capped(arch):
        return get_config(arch).scaled(attn_logit_softcap=SOFTCAP)

    out = {}
    cfg = capped(GEMMA)
    torch.cuda.empty_cache()
    out["serve"], res = phase_serve(
        torch, serve_mod, kernels, cfg,
        {"prefill": {"flash_attention": GEMMA_GLOBAL, "lru_scan": 0},
         "decode": {"flash_attention": 0, "lru_scan": 0}}, 262144)
    peak = torch.cuda.max_memory_allocated()
    check(res.n_params == GEMMA_PARAMS, f"softcapped {GEMMA}: "
          f"{res.n_params:,} parameters, expected {GEMMA_PARAMS:,}")
    prefill16, decode16, peak16 = served16

    def median(xs):
        return sorted(xs)[len(xs) // 2] * 1e3

    print(f"softcapped {GEMMA} (attn_logit_softcap {SOFTCAP}) served: "
          f"prefill {res.prefill_s:.6f} s (phase 16, uncapped: "
          f"{prefill16:.6f} s; the cap {res.prefill_s - prefill16:+.6f} s) "
          f"| decode ms/step median {median(res.decode_s):.3f} (phase 16: "
          f"{median(decode16):.3f}) | peak {peak / 2**30:.3f} GiB (phase "
          f"16: {peak16 / 2**30:.3f}) | flash launches per phase "
          f"{ {k: v['flash_attention'] for k, v in res.launches.items()} }")
    del res
    torch.cuda.empty_cache()
    names = [n for n, _ in phase_serve_profile(torch, tm, get_config, cfg)]
    instance = [n for n in names if ("true, true" in n or "Lb1ELb1E" in n)]
    check(len(names) == GEMMA_GLOBAL and len(instance) == len(names),
          f"softcapped {GEMMA}: the profiled prefill's flash launches "
          f"{names} are not {GEMMA_GLOBAL} of the softcapped instance")
    print(f"softcapped {GEMMA}: the profiled prefill's {len(names)} flash "
          f"launches are the softcapped instance ({names[0][:90]})")
    torch.cuda.empty_cache()
    out["replay"] = phase_llm_replay(
        torch, tm, capped, full_fp32, GEMMA, kernels, n_layers=6,
        window=HYBRID_WINDOW)
    want = {"flash_attention": 1, "lru_scan": 0}
    check({k: out["replay"][k] for k in want} == want,
          f"softcapped {GEMMA} replay: launches {out['replay']}, expected "
          f"{want}")
    print(f"the replay above: {GEMMA} with attn_logit_softcap {SOFTCAP}")
    cut = cfg.scaled(n_layers=SOFTCAP_TRAIN_LAYERS)
    # one pattern is 3,358,117,632 parameters, 16 bytes each with AdamW's
    # fp32 moments (54 GiB), and the eager update's fp32 temporaries of
    # the (262144, 3840) table take 3.75 GiB each: with the caching
    # allocator's fixed segments step 1 found 20 GiB reserved but free
    # and no room for one; growable segments hold it
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        out["train"], res = phase_train(
            torch, train_mod, kernels, cut, CUT_BATCH, CUT_SEQ, CUT_STEPS,
            {"gradnorm_sigma": 1, "flash_attention": 0, "lru_scan": 0,
             "lru_scan_backward": 0},
            f"{GEMMA} softcap {SOFTCAP} cut to {SOFTCAP_TRAIN_LAYERS} "
            f"layers {list(cut.layer_pattern)}")
        del res
    finally:
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings(
            "expandable_segments:False")
    out["train_replay"] = phase_train_replay(
        torch, train_mod, replay, tm, full_fp32, get_config, kernels, GEMMA,
        0, cfg=cfg.scaled(dtype="float32", n_layers=REPLAY_LAYERS,
                          vocab=SOFTCAP_REPLAY_VOCAB))
    return out


def phase_host_mesh(torch, serve_mod, train_mod, replay, kernels, mesh_mod,
                    sharding, get_config, served7, peak7, train25):
    """Phase 33: llama3.2-3b at full width and depth on a 1x1
    ``DeviceMesh``, the params DTensors placed by the reference's rules,
    each step under the activation constrainer: phase 7's request
    (``served7``, its peak ``peak7``) and 3 of phase 25's train steps
    (``train25``: its step times, losses and peak), the latter held
    against 3 plain steps of the same seeds.  Every launch count is
    zeroed just before each mesh run and read just after; so is a count
    of the ops that ran on gathered operands (the gathering mode of
    ``sharding.gather_unsharded_ops``), printed.  Returns the serve's and
    the train run's launches."""
    gathered: dict = {}
    gather = sharding._gathered

    def counted(func, args, kwargs):
        gathered[str(func)] = gathered.get(str(func), 0) + 1
        return gather(func, args, kwargs)

    sharding._gathered = counted
    mesh = mesh_mod.make_host_mesh(1, 1)
    print(f"host mesh: {mesh}")
    expected = {"prefill": {"flash_attention": 28, "lru_scan": 0},
                "decode": {"flash_attention": 0, "lru_scan": 0}}
    kw = dict(batch=SERVE_BATCH, prompt_len=PROMPT, smoke=False, seed=0,
              device="cuda", mesh=mesh)
    warm = serve_mod.serve(ARCH, new_tokens=2, **kw)
    print(f"serve {ARCH} on the host mesh, warm-up: prefill "
          f"{warm.prefill_s:.6f} s")
    del warm
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for m in kernels:
        m.reset_launch_counts()
    gathered.clear()
    res = serve_mod.serve(ARCH, new_tokens=NEW_TOKENS, **kw)
    serve_launches = kernel_launches(kernels)
    serve_gathered = dict(gathered)
    peak = torch.cuda.max_memory_allocated()
    check(res.launches == expected, f"host mesh serve: launches per phase "
          f"{res.launches}, expected {expected}")
    got, want = res.prefill_logits, served7.prefill_logits
    err = float((got - want).abs().max())
    atol = LOGITS_RTOL * float(want.abs().max())
    differ = [(b, int((res.tokens[b] != served7.tokens[b]).nonzero()[0]))
              for b in range(res.tokens.shape[0])
              if not torch.equal(res.tokens[b], served7.tokens[b])]
    check(not differ, f"host mesh serve: tokens differ from phase 7's at "
          f"(sequence, first step) {differ}; prefill logits max abs err "
          f"{err:.3g}, bit-identical {torch.equal(got, want)}")
    check(bool(torch.allclose(got, want, rtol=LOGITS_RTOL, atol=atol)),
          f"host mesh serve: prefill logits differ by {err:.3g} (rtol "
          f"{LOGITS_RTOL}, atol {atol:.3g})")

    def median_ms(ts):
        ts = sorted(ts)
        return 1e3 * ts[len(ts) // 2]

    print(f"serve {ARCH} on the host mesh: tokens equal to phase 7's; "
          f"prefill logits max abs err {err:.3g} (rtol {LOGITS_RTOL}, atol "
          f"{atol:.3g}), bit-identical {torch.equal(got, want)} | prefill "
          f"{res.prefill_s:.6f} s (phase 7: {served7.prefill_s:.6f}) | "
          f"decode ms/step median {median_ms(res.decode_s):.3f} mean "
          f"{1e3 * sum(res.decode_s) / len(res.decode_s):.3f} (phase 7: "
          f"{median_ms(served7.decode_s):.3f}, "
          f"{1e3 * sum(served7.decode_s) / len(served7.decode_s):.3f}) | "
          f"peak {peak / 2**30:.3f} GiB (phase 7: {peak7 / 2**30:.3f}) | "
          f"launches {serve_launches} per phase {res.launches} | ops on "
          f"gathered operands {serve_gathered}")
    del res
    torch.cuda.empty_cache()

    llama = get_config(ARCH)
    run = partial(train_mod.run, llama, steps=MESH_TRAIN_STEPS,
                  batch=TRAIN_BATCH, seq=TRAIN_SEQ, n_clients=TRAIN_CLIENTS,
                  log_every=MESH_TRAIN_STEPS, device="cuda",
                  keep_params=True)
    # a bf16 train step is not reproducible run to run under the default
    # algorithms (two plain runs of these steps on an H100 part at step 0
    # by ~1e-3 in the loss), so both runs take the deterministic ones
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        plain = run()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for m in kernels:
            m.reset_launch_counts()
        gathered.clear()
        meshed = run(mesh=mesh)
        train_launches = kernel_launches(kernels)
        peak = torch.cuda.max_memory_allocated()
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic = saved[2]
        sharding._gathered = gather
    per_step = {"gradnorm_sigma": 1, "flash_attention": 0, "lru_scan": 0,
                "lru_scan_backward": 0}
    for i, got in enumerate(meshed.launches):
        check(got == per_step, f"host mesh train step {i}: launches {got}, "
              f"expected {per_step}")
    loss_err = replay.check_rel("host mesh train losses",
                                torch.tensor(meshed.losses),
                                torch.tensor(plain.losses))
    equal, worst = True, 0.0
    for name, want in plain.params.items():
        got = meshed.params[name]
        if torch.equal(got, want):
            continue
        equal = False
        w, g = want.float(), got.float()
        diff = (g - w).abs()
        worst = max(worst, float(diff.max()))
        check(bool((diff <= replay.PARAM_ATOL
                    + replay.PARAM_RTOL * w.abs()).all()),
              f"host mesh train: param {name} differs by "
              f"{float(diff.max()):.3g}, beyond 1e-6 + 1e-5 |w|")
    step25, losses25, peak25 = train25
    print(f"train {ARCH} on the host mesh, {MESH_TRAIN_STEPS} FEEL steps of "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, both runs under deterministic "
          f"algorithms: losses {meshed.losses} (plain "
          f"{plain.losses}, rel err {loss_err:.3g}, bit-identical "
          f"{meshed.losses == plain.losses}; phase 25's first "
          f"{losses25[:MESH_TRAIN_STEPS]}) | params after the steps "
          f"bit-identical {equal} (max abs err {worst:.3g}) | step ms "
          f"{[round(t * 1e3, 3) for t in meshed.step_s]} (plain "
          f"{[round(t * 1e3, 3) for t in plain.step_s]}; phase 25's steps "
          f"1-{MESH_TRAIN_STEPS - 1} "
          f"{[round(t * 1e3, 3) for t in step25[1:MESH_TRAIN_STEPS]]}) | "
          f"peak {peak / 2**30:.3f} GiB (phase 25: {peak25 / 2**30:.3f}) | "
          f"launches {train_launches} | ops on gathered operands "
          f"{gathered}")
    del plain, meshed
    torch.cuda.empty_cache()
    return serve_launches, train_launches


def argument_bytes(torch, mesh_mod, sharding, shapes, tm, cfg, shape,
                   multi_pod):
    """A dry run's per-device argument bytes by the sharding rules on a
    ``MeshShape`` (no process group, no DTensor): params, optimizer
    state (train), batch and cache (decode), each leaf's shard shape
    times its item size."""
    ms = mesh_mod.production_shape(multi_pod=multi_pod)
    info = shapes.SHAPES[shape]
    kind, B, S = info["kind"], info["batch"], info["seq"]
    params = dict(tm.init_model(cfg, None, "meta").named_parameters())
    batch = shapes._abstract_batch(cfg, kind, B, S, mesh_mod.data_size(ms),
                                   True)
    trees = [(params, sharding.param_shardings(ms, params, cfg)),
             (batch, sharding.batch_shardings(ms, batch))]
    if kind == "train":
        state = shapes.make_optimizer(cfg).init(params)
        trees.append((state, sharding.opt_state_shardings(ms, state, cfg)))
    if kind == "decode":
        cache = tm.make_cache(cfg, B, S, dtype=cfg.act_dtype, device="meta")
        trees.append((cache, sharding.cache_shardings(ms, cache, B)))
    sizes = []
    for tree, shards in trees:
        sharding.map_sharded(tree, shards, lambda t, s: sizes.append(
            math.prod(s.shard_shape(t.shape)) * t.element_size()))
    return sum(sizes)


def phase_dry_runs(torch, dryrun, mesh_mod, sharding, shapes, tm,
                   get_config):
    """Phase 34: the multi-pod dry run on the host's CPU (a fake process
    group, fake tensors), one record per ``DRY_RUNS`` entry, printed
    with its wall time, collective bytes and peak; each must be ``ok``
    at full depth with no gathered op, with the reference's parameter
    counts, argument bytes equal to the rules' arithmetic, a peak that
    holds them, and FLOPs within ``DRY_RUN_RTOL`` of the pinned
    count."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    for arch, shape, multi_pod, total, active, flops in DRY_RUNS:
        t0 = time.perf_counter()
        rec = dryrun.run_one(arch, shape, multi_pod, out_path=None)
        wall = time.perf_counter() - t0
        print(json.dumps({k: v for k, v in rec.items() if k != "traceback"}))
        check(rec["ok"], f"dry run {arch} x {shape}: {rec.get('error')}\n"
              f"{rec.get('traceback')}")
        peak, args = (rec["memory"][k] for k in ("peak_bytes",
                                                 "argument_bytes"))
        print(f"dry run {arch} x {shape} on {rec['mesh']}: wall {wall:.2f} s, "
              f"{rec['flops_per_device']:.6e} FLOPs, "
              f"{rec['collective_bytes_per_device']:.6e} collective B, "
              f"peak {peak:.6e} B ({args:.6e} argument B) a device (counts "
              "and estimates at H100 datasheet rates, not measurements)")
        check(rec["full_depth"] and not rec["gathered_ops"],
              f"dry run {arch} x {shape}: full depth {rec['full_depth']}, "
              f"gathered {rec['gathered_ops']}")
        check(peak >= args, f"dry run {arch} x {shape}: peak {peak:.6e} B "
              f"under its {args:.6e} argument B")
        check(abs(rec["flops_per_device"] / flops - 1.0) <= DRY_RUN_RTOL,
              f"dry run {arch} x {shape}: {rec['flops_per_device']:.6e} "
              f"FLOPs a device, the pinned count {flops:.6e} (torch 2.13, "
              f"CPU); rtol {DRY_RUN_RTOL}")
        check((rec["params_total"], rec["params_active"]) == (total, active),
              f"dry run {arch}: params {rec['params_total']:,} total, "
              f"{rec['params_active']:,} active; the reference's {total:,}, "
              f"{active:,}")
        want = argument_bytes(torch, mesh_mod, sharding, shapes, tm,
                              get_config(arch), shape, multi_pod)
        check(rec["memory"]["argument_bytes"] == want,
              f"dry run {arch}: argument bytes "
              f"{rec['memory']['argument_bytes']:,}, the rules' {want:,}")
        print(f"dry run {arch} x {shape}: argument bytes "
              f"{want:,} a device, equal to the sharding rules' arithmetic")
    if dist.is_initialized():
        dist.destroy_process_group()


def _clone_cache(torch, cache):
    """A copy of a decoder cache (nested dicts and lists of tensors)."""
    if torch.is_tensor(cache):
        return cache.clone()
    if isinstance(cache, dict):
        return {k: _clone_cache(torch, v) for k, v in cache.items()}
    return [_clone_cache(torch, v) for v in cache]


def main() -> None:
    # phase 3's flex_attention yardsticks compile in this process: no
    # pool of compile workers outlives the script
    os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")
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
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core import matching, selection
    from repro_torch.device import full_fp32
    from repro_torch.kernels import (flash_attention, gradnorm, lru_scan,
                                     nvcc, ops)
    from repro_torch.launch import dryrun, replay, sharding, shapes
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
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
                    or "spill" in line or "smem" in line \
                    or "warning" in line.lower():
                print(f"  ptxas: {line.strip()}")
    sm90_log = infos[builds.index(flash_attention.build_sm90)].log
    wgmma = [e for e in nvcc.ptxas_report(sm90_log)
             if "flash_wgmma_kernel" in e.name]
    check(len(wgmma) == 15 and all(e.spill_stores == e.spill_loads == 0
                                   for e in wgmma),
          f"bf16 flash: 15 flash_wgmma_kernel instances without spills "
          f"expected, ptxas reports {wgmma}")
    warned = [w for w in nvcc.ptxas_warnings(sm90_log)
              if "wgmma" in w or "setmaxnreg" in w]
    check(not warned, f"bf16 flash: ptxas warns {warned}")
    scan = nvcc.ptxas_report(infos[builds.index(lru_scan.build)].log)
    check(len(scan) == 4 and all(e.spill_stores == e.spill_loads == 0
                                 for e in scan),
          f"lru_scan: the forward and backward kernels' fp32 and bf16 "
          f"instances without spills expected, ptxas reports {scan}")
    done("2 build")

    # -- 3. kernels against their plain versions ------------------------
    norm_rec, sigma_rec, sigma256_rec = phase_kernels(torch, gradnorm)
    flash_recs = phase_flash(torch, flash_attention, ops)
    flash_rec = flash_recs[(FLASH_GQA, "bfloat16", "bshd")]
    flash_gemma_rec = flash_recs[(FLASH_GEMMA, "bfloat16", "bshd")]
    flash_f32_rec = flash_recs[(FLASH_F32_REPLAY, "float32", "bshd")]
    capped_recs = phase_flash_capped(torch, flash_attention, ops)
    scan_recs = phase_scan(torch, lru_scan, ops)
    scan_rec = scan_recs[SCAN_SLICE]
    sigma_train_recs, scan_train_recs, scan_bwd_recs = phase_train_kernels(
        torch, gradnorm, lru_scan, ops)
    sigma_train_rec = sigma_train_recs[SIGMA_TRAIN]
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
    feel_launches = kernel_launches(kernels)
    check(feel_launches == {"rownorm2": 0, "gradnorm_sigma": ROUNDS,
                            "flash_attention": 0, "lru_scan": 0,
                            "lru_scan_backward": 0},
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
    serve_launches, served7 = phase_serve(
        torch, serve_mod, kernels, ARCH,
        {"prefill": {"flash_attention": 28, "lru_scan": 0},
         "decode": {"flash_attention": 0, "lru_scan": 0}}, 128256)
    peak7 = torch.cuda.max_memory_allocated()
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
    served16 = (served.prefill_s, served.decode_s,
                torch.cuda.max_memory_allocated())
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

    def prefill_flash_profile(cfg, n, shape, prefill_s):
        """Profiles a prefill (``phase_serve_profile``) and checks that its
        n flash launches are the bf16 instance of the shape's widths."""
        arch = cfg if isinstance(cfg, str) else cfg.name
        flash = phase_serve_profile(torch, tm, get_config, cfg)
        want = flash_attention.bf16_instance(shape[4], shape[-1])
        got = [wgmma_instance(name) for name, _ in flash]
        check(len(got) == n and set(got) == {want},
              f"{arch}: the profiled prefill's flash launches are {got}, "
              f"expected {n} of the instance {want}")
        print(f"{arch}: prefill {prefill_s:.6f} s; the profiled prefill's "
              f"flash kernel {sum(ms for _, ms in flash):.3f} ms in {n} "
              f"launches of flash_wgmma_kernel<{', '.join(map(str, want))}, "
              "...>")

    torch.cuda.empty_cache()
    stablelm_launches, served = phase_serve(
        torch, serve_mod, kernels, STABLELM, prefill_flash(STABLELM_LAYERS),
        100352)
    check(served.n_params == STABLELM_PARAMS, f"{STABLELM}: "
          f"{served.n_params:,} parameters, expected {STABLELM_PARAMS:,}")
    flash_stablelm_rec = flash_time(STABLELM, STABLELM_LAYERS, FLASH_STABLELM)
    prefill_flash_profile(STABLELM, STABLELM_LAYERS, FLASH_STABLELM,
                          served.prefill_s)
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
    prefill_flash_profile(COMMAND_R, COMMAND_R_LAYERS, FLASH_COMMAND_R,
                          served.prefill_s)
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
    prefill_flash_profile(dsv2, DSV2_LAYERS, FLASH_MLA, naive.prefill_s)
    done("20 deepseek-v2 serve")

    # -- 21. the deepseek-v3-671b serving path, cut to 4 layers ---------
    torch.cuda.empty_cache()
    dsv3 = get_config(DSV3).scaled(n_layers=DSV3_LAYERS)
    dsv3_launches, served = phase_serve(
        torch, serve_mod, kernels, dsv3, prefill_flash(DSV3_LAYERS), 129280)
    check(served.n_params == DSV3_PARAMS, f"{DSV3} cut to {DSV3_LAYERS} "
          f"layers: {served.n_params:,} parameters, expected {DSV3_PARAMS:,}")
    flash_dsv3_rec = flash_time(DSV3, DSV3_LAYERS, FLASH_MLA)
    prefill_flash_profile(dsv3, DSV3_LAYERS, FLASH_MLA, served.prefill_s)
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

    # -- 23. the trainer's options at the §VI-A setup ---------------------
    data = make_data(rt)
    options_launches = phase_options(rt, torch, data, init_sd, kernels,
                                     gradnorm)
    del data
    done("23 trainer options")

    # -- 24. a 256-device round -----------------------------------------
    k256_launches = phase_k256(rt, torch, init_sd, kernels, gradnorm)
    done("24 K=256 round")

    # -- 25. llama3.2-3b training at full width and depth ---------------
    llama = get_config(ARCH)
    llama_train_launches, res = phase_train(
        torch, train_mod, kernels, llama, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS,
        {"gradnorm_sigma": 1, "flash_attention": 0, "lru_scan": 0,
         "lru_scan_backward": 0}, ARCH)
    check(res.n_params == 3_606_752_256, f"{ARCH}: {res.n_params:,} params")
    print(f"gradnorm_sigma device time of one step's launch at "
          f"{SIGMA_TRAIN}: {sigma_train_rec['ms']:.6f} ms (phase 3)")
    train25 = (res.step_s, res.losses, torch.cuda.max_memory_allocated())
    del res
    profile_train_step(torch, train_mod, llama, ARCH, TRAIN_BATCH, TRAIN_SEQ)
    done("25 llama train")

    # -- 26. the other block kinds' training at full width, cut in depth
    cut_launches = {}
    for arch, layers, scans in CUT_TRAIN:
        cfg = get_config(arch).scaled(n_layers=layers)
        cut_launches[arch], res = phase_train(
            torch, train_mod, kernels, cfg, CUT_BATCH, CUT_SEQ, CUT_STEPS,
            {"gradnorm_sigma": 1, "flash_attention": 0,
             "lru_scan": 2 * scans, "lru_scan_backward": scans},
            f"{arch} cut to {layers} layers {list(cfg.layer_pattern)}")
        print(f"{arch} cut to {layers} layers: {2 * scans} scan and "
              f"{scans} scan-backward launches a step for {scans} recurrent "
              "layers (the forward and its recompute under remat, then the "
              f"backward kernel); optimizer {cfg.optimizer}")
        if cfg.n_experts:
            check(all(a > 0 for a in res.aux_loss),
                  f"{arch}: the summed MoE aux loss {res.aux_loss}")
        peak = torch.cuda.max_memory_allocated()
        ms = sorted(t * 1e3 for t in res.step_s[1:])
        del res
        stages = profile_train_step(torch, train_mod, cfg,
                                    f"{arch} cut to {layers}", CUT_BATCH,
                                    CUT_SEQ)
        if scans:
            bwd = scan_bwd_recs[SCAN_TRAIN[0] if arch == MAMBA
                                else SCAN_TRAIN[1]]
            print(f"{arch} cut to {layers} layers, train step: median "
                  f"{ms[len(ms) // 2]:.3f} ms, backward stage "
                  f"{stages['backward']:.3f} ms (with the remat recompute; "
                  f"{scans} lru_scan_backward launches, each "
                  f"{bwd['ms']:.6f} ms in phase 3), peak "
                  f"{peak / 2**30:.3f} GiB")
    done("26 cut-depth train")

    # -- 27. train steps replayed on the CPU ---------------------------
    for arch in REPLAY_TRAIN_ARCHS:
        phase_train_replay(torch, train_mod, replay, tm, full_fp32,
                           get_config, kernels, arch,
                           REPLAY_LAYERS if arch == MAMBA else 0)
    done("27 train replays")

    # -- 28-29. the vlm and audio serving paths at full width and depth --
    modality_serve = {}
    for (arch, n_params, layers, vocab), shape in ((QWEN, FLASH_QWEN),
                                                   (MUSICGEN,
                                                    FLASH_MUSICGEN)):
        torch.cuda.empty_cache()
        modality_serve[arch], served = phase_serve(
            torch, serve_mod, kernels, arch, prefill_flash(layers), vocab)
        check(served.n_params == n_params, f"{arch}: {served.n_params:,} "
              f"parameters, expected {n_params:,}")
        flash_time(arch, layers, shape)
        prefill_s = served.prefill_s
        del served
        torch.cuda.empty_cache()
        prefill_flash_profile(arch, layers, shape, prefill_s)
        done(f"{28 if arch == QWEN[0] else 29} {arch} serve")

    # -- 30. modality replays on the CPU ---------------------------------
    for arch, *_ in (QWEN, MUSICGEN):
        torch.cuda.empty_cache()
        got = phase_llm_replay(torch, tm, get_config, full_fp32, arch,
                               kernels, caches=("k", "v"))
        want = {"flash_attention": REPLAY_LAYERS, "lru_scan": 0}
        check({k: got[k] for k in want} == want,
              f"{arch} replay: launches {got}, expected {want}")
    done("30 modality replays")

    # -- 31. the vlm and audio archs trained at full width and depth ----
    modality_train = {}
    for arch, n_params, *_ in (QWEN, MUSICGEN):
        cfg = get_config(arch)
        torch.cuda.empty_cache()
        modality_train[arch], res = phase_train(
            torch, train_mod, kernels, cfg, TRAIN_BATCH, TRAIN_SEQ,
            TRAIN_STEPS, {"gradnorm_sigma": 1, "flash_attention": 0,
                          "lru_scan": 0, "lru_scan_backward": 0}, arch)
        check(res.n_params == n_params, f"{arch}: {res.n_params:,} params")
        del res
        profile_train_step(torch, train_mod, cfg, arch, TRAIN_BATCH,
                           TRAIN_SEQ)
    done("31 modality train")

    # -- 32. train replays: the modalities, and adafactor's stacked body
    for arch, *_ in (QWEN, MUSICGEN):
        phase_train_replay(torch, train_mod, replay, tm, full_fp32,
                           get_config, kernels, arch, 0)
    dsv2_cut = smoke_config(DSV2).scaled(dtype="float32",
                                         n_layers=ADAFACTOR_REPLAY_LAYERS)
    groups = train_mod.make_optimizer(dsv2_cut).groups
    check(dsv2_cut.optimizer == "adafactor" and groups
          and all(len(m) == 2 for m in groups.values()),
          f"{DSV2} cut to {ADAFACTOR_REPLAY_LAYERS} layers: adafactor "
          f"groups {groups}")
    print(f"{DSV2} smoke decoder cut to {ADAFACTOR_REPLAY_LAYERS} layers: "
          f"adafactor steps {len(groups)} stacked body groups of 2 repeats")
    phase_train_replay(torch, train_mod, replay, tm, full_fp32, get_config,
                       kernels, DSV2, 0, cfg=dsv2_cut)
    done("32 modality and adafactor train replays")

    # -- 33. llama3.2-3b on a 1x1 DeviceMesh -----------------------------
    torch.cuda.empty_cache()
    mesh_serve_launches, mesh_train_launches = phase_host_mesh(
        torch, serve_mod, train_mod, replay, kernels, mesh_mod, sharding,
        get_config, served7, peak7, train25)
    del served7
    done("33 host mesh")

    # -- 34. the multi-pod dry run on the host's CPU ---------------------
    phase_dry_runs(torch, dryrun, mesh_mod, sharding, shapes, tm,
                   get_config)
    done("34 dry runs")

    # -- 35. softcapped attention: gemma3-12b at attn_logit_softcap 50 ---
    softcap_launches = phase_softcap(torch, serve_mod, train_mod, replay, tm,
                                     full_fp32, get_config, kernels, served16)
    print(f"flash_attention device time of one softcapped prefill's "
          f"{GEMMA_GLOBAL} launches: "
          f"{GEMMA_GLOBAL * capped_recs['softcap-gemma']['ms']:.3f} ms "
          f"({GEMMA_GLOBAL} x the {FLASH_GEMMA} time with softcap "
          f"{SOFTCAP}; phase 16's uncapped "
          f"{GEMMA_GLOBAL * flash_gemma_rec['ms']:.3f} ms)")
    done("35 softcap")

    # -- results --------------------------------------------------------
    def entry(name, source, replaces, launches, rec):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"],
                "library_ms": rec.get("library_ms")}

    gn_src = "src/repro_torch/kernels/csrc/gradnorm.cu"
    gn_ref = "src/repro/kernels/gradnorm.py:62"
    sm90_src = "src/repro_torch/kernels/csrc/flash_attention_sm90.cu"
    flash_src = "src/repro/kernels/flash_attention.py:112"
    print(f"total wall {time.perf_counter() - t_start:.2f} s")
    print(json.dumps({"kernels": [
        entry("rownorm2", gn_src, gn_ref, feel_launches["rownorm2"],
              norm_rec),
        entry("gradnorm_sigma", gn_src, gn_ref,
              feel_launches["gradnorm_sigma"], sigma_rec),
        # the other FEEL paths at the §VI-A shape, each with its own run's
        # launches
        entry("gradnorm_sigma@schemes", gn_src, gn_ref,
              schemes_launches["gradnorm_sigma"], sigma_rec),
        entry("gradnorm_sigma@ccp", gn_src, gn_ref,
              ccp_launches["gradnorm_sigma"], sigma_rec),
        entry("gradnorm_sigma@traced", gn_src, gn_ref,
              traced_launches["gradnorm_sigma"], sigma_rec),
        entry("gradnorm_sigma@resilience", gn_src, gn_ref,
              resilience_launches["gradnorm_sigma"], sigma_rec),
        entry("gradnorm_sigma@options", gn_src, gn_ref,
              options_launches["gradnorm_sigma"], sigma_rec),
        entry(f"gradnorm_sigma@K{K256}", gn_src, gn_ref,
              k256_launches["gradnorm_sigma"], sigma256_rec),
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
              dsv3_launches["flash_attention"], flash_dsv3_rec),
        # the train paths, each with its own run's launches
        entry(f"gradnorm_sigma@train-{ARCH}", gn_src, gn_ref,
              llama_train_launches["gradnorm_sigma"], sigma_train_rec),
        entry(f"lru_scan@train-{MAMBA}",
              "src/repro_torch/kernels/csrc/lru_scan.cu",
              "src/repro/kernels/lru_scan.py:70",
              cut_launches[MAMBA]["lru_scan"], scan_train_recs[SCAN_TRAIN[0]]),
        entry(f"lru_scan@train-{RGEMMA}",
              "src/repro_torch/kernels/csrc/lru_scan.cu",
              "src/repro/kernels/lru_scan.py:70",
              cut_launches[RGEMMA]["lru_scan"],
              scan_train_recs[SCAN_TRAIN[1]]),
        # the scan's gradient: no Pallas kernel of its own (the reference
        # trains through jax.lax.associative_scan); the Pallas scan whose
        # op's gradient it is
        entry(f"lru_scan_backward@train-{MAMBA}",
              "src/repro_torch/kernels/csrc/lru_scan.cu",
              "src/repro/kernels/lru_scan.py:70",
              cut_launches[MAMBA]["lru_scan_backward"],
              scan_bwd_recs[SCAN_TRAIN[0]]),
        entry(f"lru_scan_backward@train-{RGEMMA}",
              "src/repro_torch/kernels/csrc/lru_scan.cu",
              "src/repro/kernels/lru_scan.py:70",
              cut_launches[RGEMMA]["lru_scan_backward"],
              scan_bwd_recs[SCAN_TRAIN[1]]),
        # the vlm and audio paths, each with its own run's launches
        entry(f"flash_attention@serve-{QWEN[0]}", sm90_src, flash_src,
              modality_serve[QWEN[0]]["flash_attention"],
              flash_recs[(FLASH_QWEN, "bfloat16", "bshd")]),
        entry(f"flash_attention@serve-{MUSICGEN[0]}", sm90_src, flash_src,
              modality_serve[MUSICGEN[0]]["flash_attention"],
              flash_recs[(FLASH_MUSICGEN, "bfloat16", "bshd")]),
        entry(f"gradnorm_sigma@train-{QWEN[0]}", gn_src, gn_ref,
              modality_train[QWEN[0]]["gradnorm_sigma"],
              sigma_train_recs[SIGMA_TRAIN_QWEN]),
        entry(f"gradnorm_sigma@train-{MUSICGEN[0]}", gn_src, gn_ref,
              modality_train[MUSICGEN[0]]["gradnorm_sigma"],
              sigma_train_recs[SIGMA_TRAIN_MUSICGEN]),
        # the host mesh's paths, each with its own run's launches
        entry(f"flash_attention@hostmesh-{ARCH}", sm90_src, flash_src,
              mesh_serve_launches["flash_attention"], flash_rec),
        entry(f"gradnorm_sigma@hostmesh-train-{ARCH}", gn_src, gn_ref,
              mesh_train_launches["gradnorm_sigma"], sigma_train_rec),
        # the softcapped path, each with its own run's launches; the
        # llama-shape softcap and the offset instance run on no path
        entry(f"flash_attention@softcap-{GEMMA}", sm90_src, flash_src,
              softcap_launches["serve"]["flash_attention"],
              capped_recs["softcap-gemma"]),
        entry("flash_attention_f32@softcap",
              "src/repro_torch/kernels/csrc/flash_attention.cu", flash_src,
              softcap_launches["replay"]["flash_attention"],
              capped_recs["softcap-f32"]),
        entry(f"gradnorm_sigma@train-softcap-{GEMMA}", gn_src, gn_ref,
              softcap_launches["train"]["gradnorm_sigma"],
              sigma_train_recs[SIGMA_TRAIN_GEMMA]),
        entry(f"flash_attention@softcap-{ARCH}", sm90_src, flash_src, 0,
              capped_recs["softcap-llama"]),
        entry("flash_attention@q_offset", sm90_src, flash_src, 0,
              capped_recs["q_offset"])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
