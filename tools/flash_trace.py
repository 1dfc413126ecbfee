#!/usr/bin/env python3
"""Where an iteration of the bf16 flash kernel goes, on the card.

    python3 tools/flash_trace.py

Run on a machine with an NVIDIA GPU, from a checkout of the repository.
It builds diagnostic copies of this checkout's
``kernels/csrc/flash_attention_sm90.cu`` (text edits of the source,
into the gitignored build directory; the port never loads them) and
runs them through ``ops.flash_attention_bhsd`` in place of the real
library, at musicgen-medium's, command-r-35b's and llama3.2-3b's
prefill shapes (``chip_smoke.FLASH_MUSICGEN``, ``FLASH_COMMAND_R``,
``FLASH_GQA``):

- ``trace``: the kernel with ``clock64()`` stamps around each phase of
  a consumer warpgroup's iteration past the first tile (the mbarrier
  tests for K_t and V_{t-1}, the wait for its turn, issuing the
  products, the wait for S_t, the softmax, the wait for P V, the
  rescale and packing), written by thread 0 of each consumer
  warpgroup of one block: the longest q tile of the fourth group of
  heads (16 key tiles at these shapes).  Its output is checked bit for
  bit against the real kernel's.
- ablations, each a different function (their outputs are not
  checked), timed in turns with the unmodified source (``base``: base,
  ablations, then the same in reverse order) with ``chip_smoke.py``'s
  timer: ``no_pingpong`` (the consumers do not take turns),
  ``no_exp`` (2^x replaced by x) and ``no_softmax`` (the probabilities
  are the raw scores and the accumulator is never rescaled).

Prints the card's name and power limit, each copy's ptxas summary, the
mean cycles of each phase for iterations 2-14 of each warpgroup and its
period, and last one JSON object: {copy: {shape: [ms of each turn]}}
and {shape: {warpgroup: {phase: mean cycles}}}.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as cs  # noqa: E402  (stdlib only at import)

SHAPES = {"musicgen": cs.FLASH_MUSICGEN, "command_r": cs.FLASH_COMMAND_R,
          "llama": cs.FLASH_GQA}
PHASES = ["data", "turn", "issue", "S", "softmax", "pv", "pack"]
#: the statements of ``REPRO_STEP`` a stamp goes before (0) or after
MARKS = {"mbar_wait(k_full + 8 * stage, ((t) / S) & 1);": (0, "before"),
         "mbar_wait(v_full + 8 * prev, (((t) - 1) / S) & 1);": (1, "after"),
         "bar_sync(turn);": (2, "after"), "REPRO_PASS_TURN(t);": (3, "after"),
         "fence_regs<NS>(s);": (4, "after"),
         "const float2 alpha = REPRO_SOFTMAX(t, kMasked);": (5, "after"),
         "fence_regs<NO>(acc);": (6, "after"),
         "pack_probs<BK>(p, s);": (7, "after")}
TRACE_DECL = '''#include <stdint.h>
__device__ long long g_trace[2][40][8];
__device__ int g_trace_block = -1;
extern "C" int repro_trace_setup(int block) {
  return (int)cudaMemcpyToSymbol(g_trace_block, &block, sizeof(int));
}
extern "C" int repro_trace_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace));
}
#define STAMP(t, k)                                                 \\
  do {                                                              \\
    if (tid == 0 && (int)blockIdx.x == g_trace_block && (t) < 40)   \\
      g_trace[wg][t][k] = clock64();                                \\
  } while (0)
'''


def _sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        cs.die(f"flash_trace: the source no longer has one {old[:60]!r}")
    return src.replace(old, new)


def traced(src: str) -> str:
    src = _sub(src, "#include <stdint.h>\n", TRACE_DECL)
    a = src.index("#define REPRO_STEP(t, kMasked)")
    b = src.index("} while (0)\n", a)
    out, seen = [], set()
    for line in src[a:b].split("\n"):
        key = re.sub(r"/\*.*\*/", "", line.split("\\")[0]).strip()
        mark = MARKS.get(key)
        stamp = f"    STAMP((t), {mark[0]}); \\" if mark else None
        if mark and mark[1] == "before":
            out.append(stamp)
        out.append(line)
        if mark and mark[1] == "after":
            out.append(stamp)
        if mark:
            seen.add(key)
    if seen != set(MARKS):
        cs.die(f"flash_trace: REPRO_STEP lacks {set(MARKS) - seen}")
    return src[:a] + "\n".join(out) + src[b:]


def no_pingpong(src: str) -> str:
    src = _sub(src, "    if (wg == 0) bar_arrive(turn);", "")
    src = _sub(src, "if (wg == 0 || (t) + 1 < n_kv) bar_arrive(next_turn);",
               "")
    return src.replace("bar_sync(turn);", "")


def no_exp(src: str) -> str:
    return _sub(src, 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : '
                '"f"(x));', "y = x;")


def no_softmax(src: str) -> str:
    return _sub(src, "  softmax_tile<NS, kSoftcap, kMasked>(",
                "  make_float2(1.0f, 1.0f); if (0) "
                "softmax_tile<NS, kSoftcap, kMasked>(")


def main() -> None:
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import nvcc, ops
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    base = fa.SOURCE_SM90.read_text()
    copies = {"base": base, "no_pingpong": no_pingpong(base),
              "no_exp": no_exp(base), "no_softmax": no_softmax(base),
              "trace": traced(base)}
    fa.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, src in copies.items():
        paths[name] = fa.BUILD_DIR / f"flash_attention_sm90_{name}.cu"
        paths[name].write_text(src)
    with ThreadPoolExecutor(len(paths)) as pool:
        infos = dict(zip(paths, pool.map(
            lambda p: nvcc.build(p, fa.NVCC_FLAGS), paths.values())))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs, fns = {}, {}
    for name, info in infos.items():
        rep = nvcc.ptxas_report(info.log)
        print(f"{name}: {len(rep)} instances, registers "
              f"{sorted({e.registers for e in rep})}, spilled bytes "
              f"{sum(e.spill_stores + e.spill_loads for e in rep)}, "
              f"warnings {nvcc.ptxas_warnings(info.log)}")
        libs[name] = ctypes.CDLL(str(info.path))
        fns[name] = libs[name].repro_flash_attention_bf16
        fns[name].argtypes = [p] * 4 + [i] * 10 + [p, i, f, f, i, p]
        fns[name].restype = ctypes.c_int

    gen = torch.Generator(device="cuda").manual_seed(3)
    inputs = {label: [torch.randn(b, s, n, d, generator=gen,
                                  device="cuda").bfloat16()
                      for n in (h, hk, hk)]
              for label, (b, s, h, hk, d) in SHAPES.items()}

    def run(name, label):
        fa._FNS[torch.bfloat16] = fns[name]
        return ops.flash_attention_bhsd(*inputs[label])

    def digest(x):
        return hashlib.sha256(x.view(torch.int16).cpu().numpy()
                              .tobytes()).hexdigest()
    for label in SHAPES:
        cs.check(digest(run("trace", label)) == digest(run("base", label)),
                 f"flash_trace: the traced copy changed the output at "
                 f"{label}'s shape")

    order = ["base", "no_pingpong", "no_exp", "no_softmax"]
    times = {name: {label: [] for label in SHAPES} for name in order}
    for name in order + order[::-1]:
        for label in SHAPES:
            times[name][label].append(cs.device_ms(
                torch, lambda: run(name, label), 5, 3))
        print(name, {k: v[-1] for k, v in times[name].items()})

    lib = libs["trace"]
    lib.repro_trace_setup.argtypes = [i]
    lib.repro_trace_read.argtypes = [p]
    phases = {}
    for label, (b, s, h, hk, d) in SHAPES.items():
        n_qt = -(-s // 128)
        block = 3 * max(1, min(132 // n_qt, b * h)) * n_qt
        cs.check(lib.repro_trace_setup(block) == 0, "trace setup failed")
        run("trace", label)
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * 640)()
        cs.check(lib.repro_trace_read(ctypes.addressof(buf)) == 0,
                 "trace read failed")
        phases[label] = {}
        for wg in range(2):
            rows = [[buf[wg * 320 + t * 8 + k] for k in range(8)]
                    for t in range(2, 16)]
            mean = {ph: sum(r[k + 1] - r[k] for r in rows[:-1])
                    / (len(rows) - 1) for k, ph in enumerate(PHASES)}
            mean["period"] = sum(rows[j + 1][0] - rows[j][0]
                                 for j in range(len(rows) - 1)) \
                / (len(rows) - 1)
            phases[label][f"wg{wg}"] = mean
            print(f"trace {label} block {block} warpgroup {wg}, cycles of "
                  "iterations 2-14: " + ", ".join(
                      f"{k} {v:.0f}" for k, v in mean.items()))
    print(json.dumps({"ms": times, "cycles": phases}))


if __name__ == "__main__":
    main()
