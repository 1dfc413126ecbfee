#!/usr/bin/env python3
"""Time the recurrent archs' train steps of two checkouts in turns.

    python3 tools/train_turns.py OTHER_CHECKOUT

Run on a machine with an NVIDIA GPU, from a checkout of the repository;
``OTHER_CHECKOUT`` is the root of another one (for an earlier commit:
``git archive <commit> | tar -x -C _archive``).  Each turn is a
subprocess that imports ``repro_torch`` from one checkout's ``src`` and
trains the recurrent rows of ``chip_smoke.CUT_TRAIN`` (falcon-mamba-7b
cut to 4 layers, recurrentgemma-9b to one pattern; full width, random
weights from seed 0) through ``launch.train.run``: ``CUT_STEPS`` FEEL
steps of ``CUT_BATCH`` x ``CUT_SEQ`` with K = ``TRAIN_CLIENTS``, the
peak device memory over them, then ``chip_smoke.profile_train_step``
(one step timed by stage with CUDA events, one under the profiler).
The turns run other, this, this, other, on one card.  Prints the card's
name and power limit, each turn's lines, and last one JSON object:
{arch: {"step_ms": [median of steps 1.. each turn], "backward_ms":
[...], "peak_gib": [...], "launches": [a step's launches each turn]}}
with the turns' order.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (stdlib only at import)

ARCHS = [(arch, layers) for arch, layers, scans in cs.CUT_TRAIN if scans]


def turn(checkout: Path) -> None:
    """One turn: train each arch with ``checkout``'s port; one JSON line."""
    import torch
    if not torch.cuda.is_available():
        cs.die("no CUDA device: this tool times train steps on an NVIDIA GPU")
    sys.path.insert(0, str(checkout / "src"))
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_mod
    out = {}
    for arch, layers in ARCHS:
        cfg = get_config(arch).scaled(n_layers=layers)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res = train_mod.run(cfg, steps=cs.CUT_STEPS, batch=cs.CUT_BATCH,
                            seq=cs.CUT_SEQ, n_clients=cs.TRAIN_CLIENTS,
                            log_every=cs.CUT_STEPS, device="cuda")
        peak = torch.cuda.max_memory_allocated() / 2**30
        ms = sorted(t * 1e3 for t in res.step_s[1:])
        launches = res.launches[-1]
        del res
        stages = cs.profile_train_step(torch, train_mod, cfg,
                                       f"{arch} cut to {layers}",
                                       cs.CUT_BATCH, cs.CUT_SEQ)
        out[arch] = {"step_ms": ms[len(ms) // 2],
                     "backward_ms": stages["backward"], "peak_gib": peak,
                     "launches": launches}
        print(f"{checkout}: {arch} cut to {layers} layers: step ms "
              f"{out[arch]['step_ms']:.3f} (median of steps 1-"
              f"{cs.CUT_STEPS - 1}), backward stage "
              f"{stages['backward']:.3f} ms, peak {peak:.3f} GiB, launches "
              f"a step {launches}", flush=True)
    print(json.dumps(out))


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--turn":
        turn(Path(sys.argv[2]).resolve())
        return
    if len(sys.argv) != 2:
        cs.die("usage: python3 tools/train_turns.py OTHER_CHECKOUT")
    other = Path(sys.argv[1]).resolve()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    order = [("other", other), ("this", ROOT), ("this", ROOT),
             ("other", other)]
    got = {arch: {"order": [name for name, _ in order], "step_ms": [],
                  "backward_ms": [], "peak_gib": [], "launches": []}
           for arch, _ in ARCHS}
    for name, checkout in order:
        proc = subprocess.run([sys.executable, __file__, "--turn",
                               str(checkout)], capture_output=True,
                              text=True)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            cs.die(f"turn {name} ({checkout}) failed:\n{proc.stdout}"
                   f"{proc.stderr[-4000:]}")
        for line in lines[:-1]:
            print(f"[{name}] {line}")
        for arch, rec in json.loads(lines[-1]).items():
            for key, value in rec.items():
                got[arch][key].append(value)
    print(json.dumps(got))


if __name__ == "__main__":
    main()
