#!/usr/bin/env python3
"""Time the flash-attention kernels of two checkouts in turns.

    python3 tools/flash_turns.py OTHER_CHECKOUT [fp32|bf16]

Run on a machine with an NVIDIA GPU, from a checkout of the repository;
``OTHER_CHECKOUT`` is the root of another one (for an earlier commit:
``git archive <commit> | tar -x -C _archive``).  Each turn is a
subprocess that imports ``repro_torch`` from one checkout's ``src``,
builds that checkout's fp32 and bf16 kernels and times its
``ops.flash_attention_bhsd`` (the kernel with whatever its wrapper does
around it) with ``chip_smoke.py``'s timer (CUDA events over a CUDA graph
of back-to-back calls), on inputs drawn from one seed in every turn:
fp32 at the shapes of ``chip_smoke.py`` phase 3; bf16 at every serving
shape of phase 3 (llama3.2-3b, gemma3-12b's global layers,
stablelm-12b, command-r-35b, deepseek's latent attention, qwen2-vl-2b
and musicgen-medium, so every instance ``bf16_instance`` names), and
phase 3's softcapped llama and gemma3 cases (q at ``CAP_Q_SCALE``) and
its offset case (llama's last ``FLASH_OFFSET`` queries at that
offset).  Beside each it times ``scaled_dot_product_attention`` on the
same inputs (its library call; the same in every turn): without the
cap, and for the offset case with the offset's dense mask.  The turns
run other, this, this, other, on one card; a second argument keeps one
dtype's cases.  Each turn also hashes each case's output (sha256 of
its bytes), so a change that keeps the arithmetic shows as every turn's
output being the same bits.  Prints the card's name and power limit,
each turn's builds, ptxas lines and times, whether each case's outputs
are bit-identical across the turns, and last one JSON object: {case
label: [kernel ms of each turn]}, {case label: [SDPA ms of each turn]}
and {case label: bit-identical} with the turns' order.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (stdlib only at import)


#: bf16 cases: every serving shape of phase 3, so every instance of
#: ``bf16_instance``
BF16_SHAPES = [cs.FLASH_GQA, cs.FLASH_GEMMA, cs.FLASH_STABLELM,
               cs.FLASH_COMMAND_R, cs.FLASH_MLA, cs.FLASH_QWEN,
               cs.FLASH_MUSICGEN]


def cases(dtype: str = "all"):
    """(label, (B, S, H, Hk, d[, dv]), dtype, softcap, q scale,
    q_offset)."""
    shapes = [cs.FLASH_F32_REPLAY] + cs.FLASH_F32_ZOO + cs.FLASH_F32_FULL
    f32 = [(str(s), s, "float32", 0.0, 1.0, 0) for s in shapes]
    f32.append((f"{cs.FLASH_F32_REPLAY} softcap {cs.SOFTCAP}",
                cs.FLASH_F32_REPLAY, "float32", cs.SOFTCAP, cs.CAP_Q_SCALE,
                0))
    bf16 = [(f"{s} bf16", s, "bfloat16", 0.0, 1.0, 0) for s in BF16_SHAPES]
    bf16 += [(f"{s} bf16 softcap {cs.SOFTCAP}", s, "bfloat16", cs.SOFTCAP,
              cs.CAP_Q_SCALE, 0) for s in (cs.FLASH_GQA, cs.FLASH_GEMMA)]
    bf16.append((f"{cs.FLASH_GQA} bf16 q_offset {cs.FLASH_OFFSET}",
                 cs.FLASH_GQA, "bfloat16", 0.0, 1.0, cs.FLASH_OFFSET))
    return {"all": f32 + bf16, "fp32": f32, "bf16": bf16}[dtype]


def worker(dtype: str) -> None:
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    builds = {"fp32": (fa.build,), "bf16": (fa.build_sm90,),
              "all": (fa.build, fa.build_sm90)}[dtype]
    infos = [fn() for fn in builds]
    lines = [ln.strip() for info in infos for ln in info.log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(3)
    times = {}
    for label, shape, dt, softcap, q_scale, off in cases(dtype):
        b, s, h, hk, d = shape[:5]
        dv = shape[5] if len(shape) > 5 else d

        def randn(heads, width):
            return torch.randn(b, s, heads, width, generator=gen,
                               device="cuda").to(getattr(torch, dt))

        q, k, v = randn(h, d) * q_scale, randn(hk, d), randn(hk, dv)
        q = q[:, off:]  # a view: the last s - off queries
        kw = {"softcap": softcap} if softcap else {}
        if off:
            kw["q_offset"] = off
        run = lambda: ops.flash_attention_bhsd(q, k, v, **kw)  # noqa: E731
        out = run()
        got = out.float()
        want = fa.flash_attention_bhsd_plain(q, k, v, **kw).float()
        tol = cs.FLASH_TOL[dt]
        ok = bool(torch.allclose(got, want, atol=tol, rtol=tol))
        reps = (5, 3) if s >= 1024 else (50, 5)
        qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        causal = {"is_causal": True}
        if off:
            qpos = off + torch.arange(s - off, device="cuda")
            causal = {"attn_mask": torch.arange(s, device="cuda")[None, :]
                      <= qpos[:, None]}
        times[label] = {"ms": cs.device_ms(torch, run, *reps),
                        "sdpa_ms": cs.device_ms(
                            torch, lambda: sdpa(qs, ks, vs, **causal,
                                                enable_gqa=hk != h), *reps),
                        "max_abs_err": float((got - want).abs().max()),
                        "ok": ok,
                        "sha256": hashlib.sha256(
                            out.contiguous().view(torch.uint8).cpu()
                            .numpy().tobytes()).hexdigest()}
        del q, k, v, qs, ks, vs, out, got, want, causal
        torch.cuda.empty_cache()
    print(json.dumps({"build_s": sum(i.seconds for i in infos),
                      "ptxas": lines, "times": times}))


def turn(checkout: Path, dtype: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(checkout / "src"))
    proc = subprocess.run([sys.executable, __file__, "--worker", dtype],
                          env=env, capture_output=True, text=True,
                          check=False)
    if proc.returncode != 0:
        cs.die(f"turn in {checkout} failed:\n{proc.stdout}{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> None:
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2])
        return
    if len(sys.argv) not in (2, 3) or sys.argv[2:] not in ([], ["fp32"],
                                                           ["bf16"]):
        cs.die("usage: tools/flash_turns.py OTHER_CHECKOUT [fp32|bf16]")
    other = Path(sys.argv[1]).resolve()
    dtype = sys.argv[2] if len(sys.argv) == 3 else "all"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    order = [("other", other), ("this", ROOT), ("this", ROOT),
             ("other", other)]
    table = {label: [] for label, *_ in cases(dtype)}
    library = {label: [] for label, *_ in cases(dtype)}
    hashes = {label: set() for label, *_ in cases(dtype)}
    for name, checkout in order:
        res = turn(checkout, dtype)
        print(f"turn {name} ({checkout}): build {res['build_s']:.2f} s")
        for line in res["ptxas"]:
            print(f"  ptxas: {line}")
        for label, rec in res["times"].items():
            print(f"  {label}: {rec['ms']:.6f} ms, max_abs_err "
                  f"{rec['max_abs_err']:.3g}, within tol: {rec['ok']}; "
                  f"sdpa {rec['sdpa_ms']:.6f} ms")
            table[label].append(rec["ms"])
            library[label].append(rec["sdpa_ms"])
            hashes[label].add(rec["sha256"])
            cs.check(rec["ok"], f"{name} {label}: not within tolerance")
    same = {label: len(h) == 1 for label, h in hashes.items()}
    for label, equal in same.items():
        print(f"{label}: the outputs of all four turns bit-identical: "
              f"{equal}")
    print(json.dumps({"order": [n for n, _ in order], "ms": table,
                      "sdpa_ms": library, "same_bits": same}))


if __name__ == "__main__":
    main()
