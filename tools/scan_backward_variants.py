#!/usr/bin/env python3
"""Why the scan's backward kernel checks its bounds as it does, on the card.

    python3 tools/scan_backward_variants.py

Run on a machine with an NVIDIA GPU, from a checkout of the repository.
It builds diagnostic copies of this checkout's ``kernels/csrc/lru_scan.cu``
(text edits of ``lru_scan_backward_kernel``'s helpers, into the
gitignored build directory; the port never loads them), each with the
same schedule, so each must give the same bits:

- ``base``: the source as it is (each step's bound check ``p < rem``,
  the steps left from the segment's first, once a segment);
- ``per_step``: the check written per step as ``live && i0 + p < seq``;
- ``clamp32``: the steps left clamped to P + 1 and held as a 32-bit
  int;
- ``smem``: h_{t-1} copied by ``cp.async`` into shared memory, where the
  fix-up reads it, instead of into registers.

Prints the card's name and power limit, each copy's ptxas line for both
backward instances (registers, spilled bytes), whether each copy gives
the bits of ``base`` at the chunk's seams and both train shapes, and
each copy's device ms (``chip_smoke.py``'s timer) in turns (the copies in
order, then in reverse) at falcon-mamba-7b's and recurrentgemma-9b's
train shapes (``chip_smoke.SCAN_TRAIN``) with fp32 and bf16 a; last one
JSON object {copy: {"shape dtype": [ms of each turn]}}.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as cs  # noqa: E402  (stdlib only at import)


def _sub(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        raise SystemExit(f"scan_backward_variants: {old[:60]!r} found "
                         f"{src.count(old)} times in lru_scan.cu, expected "
                         f"{count}")
    return src.replace(old, new)


def per_step(src: str) -> str:
    src = _sub(src, "  const int64_t rem = live ? seq - i0 : 0;\n", "", 2)
    src = _sub(src, "  const int64_t rem = live ? seq - 1 - i0 : 0;\n", "")
    src = _sub(src, "    const bool ok = p < rem;",
               "    const bool ok = live && i0 + p < seq;")
    src = _sub(src, "hv[p] = p < rem ? *h : 0.0f;",
               "hv[p] = live && i0 + p < seq - 1 ? *h : 0.0f;")
    src = _sub(src, "    if (p < rem) {", "    if (live && i0 + p < seq) {")
    return _sub(src, "*oa = p < rem - 1 ?", "*oa = i0 + p < seq - 1 ?")


def clamp32(src: str) -> str:
    # clamped to P + 1, so that p < rem - 1 keeps its meaning at p = P - 1
    clamp = "static_cast<int>({0} < 0 ? 0 : ({0} <= P ? {0} : P + 1))"
    for left in ("seq - i0", "seq - 1 - i0"):
        src = src.replace(f"const int64_t rem = live ? {left} : 0;",
                          f"const int64_t rem_ = live ? {left} : 0;\n"
                          f"  const int rem = {clamp.format('rem_')};")
    return src


def smem(src: str) -> str:
    src = _sub(src, "    float (&hv)[P]) {", "    float (*hs)[kTile], int lane) {")
    src = _sub(src, "    hv[p] = p < rem ? *h : 0.0f;", """    if (p < rem) {
      const unsigned dst =
          static_cast<unsigned>(__cvta_generic_to_shared(&hs[p][lane]));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\\n" ::"r"(dst),
                   "l"(h) : "memory");
    }""")
    src = _sub(src, "    float2 (*agg)[kTile]) {\n  constexpr int L = W * P;\n"
               "  const int64_t i0",
               "    float2 (*agg)[kTile], float (*hs)[kTile]) {\n"
               "  constexpr int L = W * P;\n  const int64_t i0")
    src = _sub(src, "  float hv[P];\n  load_h_rev<P>(h, i0, seq, channels, "
               "live, hv);", "  load_h_rev<P>(h, i0, seq, channels, live, "
               "hs, lane);")
    src = _sub(src, "  float* oa = grad_a + t0 * channels;\n",
               "  float* oa = grad_a + t0 * channels;\n"
               "  asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n")
    src = _sub(src, "__fmul_rn(x, hv[p])", "__fmul_rn(x, hs[p][lane])")
    src = _sub(src, "  gbar += base;\n",
               "  gbar += base;\n  __shared__ float hs[W][P][kTile];\n")
    src = _sub(src, "a1, g1,\n                           agg[0]);",
               "a1, g1,\n                           agg[0], hs[warp]);")
    return _sub(src, "g0, agg[1]);", "g0, agg[1], hs[warp]);")


VARIANTS = {"base": lambda s: s, "per_step": per_step, "clamp32": clamp32,
            "smem": smem}


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        cs.die("no CUDA device: this tool times kernels on an NVIDIA GPU")
    from repro_torch.kernels import lru_scan as lru
    from repro_torch.kernels import nvcc
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    src = lru.SOURCE.read_text()
    lru.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, edit in VARIANTS.items():
        paths[name] = lru.BUILD_DIR / f"lru_scan_{name}.cu"
        paths[name].write_text(edit(src))
    with ThreadPoolExecutor(len(paths)) as pool:
        infos = dict(zip(paths, pool.map(
            lambda p: nvcc.build(p, lru.NVCC_FLAGS), paths.values())))
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    fns = {}
    for name, info in infos.items():
        for e in nvcc.ptxas_report(info.log):
            if "lru_scan_backward_kernel" in e.name:
                dt = "bf16" if "bfloat16" in e.name else "f32"
                print(f"{name} {dt}: {e.registers} registers, spill stores "
                      f"{e.spill_stores} B, loads {e.spill_loads} B")
        lib = ctypes.CDLL(str(info.path))
        for dt, suffix in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            fn = getattr(lib, f"repro_lru_scan_backward_{suffix}")
            fn.argtypes = [vp] * 5 + [i64] * 3 + [vp]
            fn.restype = ctypes.c_int
            fns[name, dt] = fn

    def run(name, a, h, gbar):
        grad_a, grad_b = torch.empty_like(h), torch.empty_like(h)
        B, S, C = a.shape
        nvcc.raise_on(fns[name, a.dtype](
            a.data_ptr(), h.data_ptr(), gbar.data_ptr(), grad_a.data_ptr(),
            grad_b.data_ptr(), B, S, C,
            torch.cuda.current_stream().cuda_stream), name)
        return grad_a, grad_b

    gen = torch.Generator(device="cuda").manual_seed(0)
    chunk = lru.WARPS * lru.STEPS
    seams = [(2, s, 8) for s in (1, chunk - 1, chunk, chunk + 1)]
    times = {name: {} for name in VARIANTS}
    for shape in seams + list(cs.SCAN_TRAIN):
        for dt in (torch.float32, torch.bfloat16):
            a = torch.rand(shape, generator=gen, device="cuda").to(dt)
            h = lru.lru_scan(a, torch.randn(shape, generator=gen,
                                            device="cuda").to(dt))
            gbar = torch.randn(shape, generator=gen, device="cuda")
            want = run("base", a, h, gbar)
            same = {n: all(bool(torch.equal(x, y)) for x, y in
                           zip(run(n, a, h, gbar), want)) for n in VARIANTS}
            key = f"{shape} {str(dt)[6:]}"
            print(f"{key}: the bits of base: {same}")
            if shape in cs.SCAN_TRAIN:
                reps = (2, 2) if shape[2] > 8192 else (20, 3)
                for n in list(VARIANTS) + list(VARIANTS)[::-1]:
                    times[n].setdefault(key, []).append(cs.device_ms(
                        torch, lambda n=n: run(n, a, h, gbar), *reps))
                print(f"{key} ms in turns: " + "; ".join(
                    f"{n} " + " / ".join(f"{t:.6f}" for t in times[n][key])
                    for n in VARIANTS))
            del a, h, gbar, want
            torch.cuda.empty_cache()
    print(json.dumps(times))


if __name__ == "__main__":
    main()
