"""End-to-end FEEL training with the port (the paper's experiment, §VI).

Counterpart of ``examples/feel_e2e.py``'s core flags: the §VI-A CNN on
the synthetic MNIST-like set with mislabels, K=10 devices (one class
each), N=5 RBs, Q=2, the proposed scheme or a baseline (``--scheme``),
with sigma scored by the CUDA row-norm kernel (the reference's
``sigma_method="last_layer_kernel"``).

    PYTHONPATH=src python -m repro_torch --rounds 150            # GPU
    PYTHONPATH=src python -m repro_torch --scheme baseline4 --rounds 150
    PYTHONPATH=src python -m repro_torch --rounds 2 --d-hat 12 --side 10 --device cpu

Observability, as the reference example's flags: ``--trace PATH``
writes a schema-v4 JSONL trace and prints its summary after ``FINAL``
(``--dash PATH`` also renders it as an HTML dashboard), ``--monitor``
checks every round against Lemma 2 and prints the monitor's summary,
``--metrics PATH`` writes the Prometheus exposition of the run's
metrics registry:

    PYTHONPATH=src python -m repro_torch --rounds 4 --trace /tmp/t.jsonl --monitor --metrics /tmp/m.prom
    PYTHONPATH=src python -m repro_torch.obs summary /tmp/t.jsonl

Resilience, as the reference example's flags: ``--faults`` injects the
``chaos`` preset or a ``FaultSpec`` JSON object, ``--checkpoint-dir``
and ``--checkpoint-every`` write periodic checkpoints, ``--resume``
continues from the one in ``--checkpoint-dir``, and ``--check-resume``
runs a self-test: the run to its end, then its second half again from a
mid-run checkpoint in a fresh trainer, asserting bit-identical, finite
params (and a quarantine when the plan injects NaN uploads); it exits
with 1 on a mismatch.  On the GPU the self-test sets cuDNN to
deterministic algorithms (``torch.backends.cudnn.deterministic = True``,
``benchmark = False``) and, before CUDA starts, cuBLAS's workspace
(``CUBLAS_WORKSPACE_CONFIG=:4096:8`` unless set), and says so:

    PYTHONPATH=src python -m repro_torch --faults chaos --check-resume --rounds 4
    PYTHONPATH=src python -m repro_torch --faults chaos --check-resume --rounds 4 --d-hat 12 --side 10 --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import List, Optional

import torch

from . import obs
from .core import default_system
from .data import SyntheticImages, non_iid_split
from .device import resolve_device
from .fed import (CHAOS_SPEC, FEELConfig, FEELTrainer, FaultSpec,
                  ResilienceConfig, RoundMetrics)
from .fed.rounds import SCHEMES
from .models import cnn


def parse_faults(arg: Optional[str]) -> Optional[FaultSpec]:
    """--faults chaos | --faults '{"seed": 1, "dropout_prob": 0.2}'."""
    if arg is None:
        return None
    if arg == "chaos":
        return CHAOS_SPEC
    return FaultSpec.from_dict(json.loads(arg))


def main(argv: Optional[List[str]] = None) -> List[RoundMetrics]:
    ap = argparse.ArgumentParser(prog="python -m repro_torch")
    ap.add_argument("--rounds", type=int, default=150)
    ap.add_argument("--scheme", default="proposed", choices=SCHEMES)
    ap.add_argument("--mislabel", type=float, default=0.1)
    ap.add_argument("--d-hat", type=int, default=60)
    ap.add_argument("--side", type=int, default=20)
    ap.add_argument("--selection", default="faithful",
                    choices=["faithful", "exact"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu must be asked for)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a repro_torch.obs JSONL telemetry trace "
                         "(per-round stage timings, solver counters, "
                         "per-device energy) and print its summary")
    ap.add_argument("--dash", default=None, metavar="PATH",
                    help="with --trace: also render the trace as a "
                         "self-contained HTML round dashboard at PATH "
                         "(same as `python -m repro_torch.obs dash`)")
    ap.add_argument("--monitor", action="store_true",
                    help="attach a ConvergenceMonitor checking each round "
                         "against the paper's Lemma-2 bound; print its "
                         "summary (violations go to --trace if given)")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="install a process-wide metrics registry and "
                         "write its Prometheus exposition to PATH")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="inject faults: 'chaos' for the aggressive "
                         "preset, or a FaultSpec JSON object")
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="directory for periodic trainer checkpoints")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    metavar="N", help="checkpoint every N rounds")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the checkpoint in --checkpoint-dir "
                         "before running")
    ap.add_argument("--check-resume", action="store_true",
                    help="self-test: run to completion, then replay the "
                         "second half from a mid-run checkpoint with a "
                         "fresh trainer and assert bit-identical params "
                         "(exits non-zero on mismatch)")
    args = ap.parse_args(argv)
    faults = parse_faults(args.faults)
    if args.check_resume and torch.device(args.device or "cuda").type \
            == "cuda":
        # cuBLAS reads its workspace setting when CUDA starts
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    device = resolve_device(args.device)

    train = SyntheticImages.make(6000, side=args.side, seed=0)
    test = SyntheticImages.make(1500, side=args.side, seed=1)
    data = non_iid_split(train, test, K=10, per_device=600,
                         mislabel_prop=args.mislabel, seed=0)
    sys_ = default_system(K=10, N=5, Q=2, D_hat=args.d_hat, device=device)
    cfg = FEELConfig(scheme=args.scheme, d_hat=args.d_hat,
                     selection_method=args.selection)
    tele = None
    if args.trace:
        tele = obs.Telemetry(path=args.trace,
                             meta={"source": "repro_torch",
                                   "scheme": args.scheme,
                                   "rounds": args.rounds,
                                   "device": str(device)})
    reg = None
    if args.metrics:
        reg = obs.Registry()
        obs.metrics.set_default(reg)
    monitor = None
    if args.monitor:
        monitor = obs.ConvergenceMonitor(sys_, telemetry=tele, registry=reg)
    resilience = None
    if (faults is not None or args.checkpoint_every or args.checkpoint_dir
            or args.check_resume):
        resilience = ResilienceConfig(checkpoint_every=args.checkpoint_every,
                                      checkpoint_dir=args.checkpoint_dir)

    def make_trainer(res=resilience, quiet=False):
        m = cnn.CNN(cnn.CNNConfig(side=args.side),
                    generator=torch.Generator().manual_seed(cfg.seed))
        return FEELTrainer(sys_, data, m, cfg,
                           telemetry=None if quiet else tele,
                           monitor=None if quiet else monitor,
                           faults=faults, resilience=res)

    try:
        trainer = make_trainer()
        if args.resume:
            print(f"resumed from round {trainer.resume()}")
        metrics = trainer.run(args.rounds, verbose=True)
    finally:
        if reg is not None:
            obs.metrics.set_default(None)
        if tele is not None:
            tele.close()
    if args.check_resume:
        check_resume(args, faults, make_trainer, device)
    final = [m for m in metrics if m.test_acc is not None][-1]
    print(f"\nFINAL: acc={final.test_acc:.3f} "
          f"cum_net_cost={final.cum_net_cost:+.3f} device={device}")
    if tele is not None:
        print(f"\ntelemetry trace -> {args.trace}")
        print("name,us_per_call,derived")
        obs.emit_summary(obs.summarize(tele.events))
        if args.dash:
            obs.write_dashboard(args.trace, args.dash)
            print(f"round dashboard -> {args.dash}")
        print(f"inspect: python -m repro_torch.obs export {args.trace}  "
              f"(Perfetto), ... diff, ... dash")
    if monitor is not None:
        s = monitor.summary()
        ratio = s["bound_gap_ratio"]
        print(f"\nmonitor: rounds={s['rounds']} bound_gap_ratio="
              f"{'n/a' if ratio is None else f'{ratio:.3f}'} "
              f"violations={s['violations'] or '{}'}")
    if reg is not None:
        with open(args.metrics, "w") as f:
            f.write(reg.render())
        print(f"metrics exposition -> {args.metrics}")
    return metrics


def check_resume(args, faults, make_trainer, device) -> None:
    """Run ``args.rounds`` rounds, then the second half again from the
    mid-run checkpoint in a fresh trainer; exit 1 unless the params are
    bit-identical and finite (and, when the plan injects NaN uploads,
    some device was quarantined)."""
    if device.type == "cuda":
        # cuDNN may pick a weight-gradient algorithm with atomics; the
        # comparison needs the same bits from the same inputs
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        print("check-resume: torch.backends.cudnn.deterministic=True "
              "benchmark=False CUBLAS_WORKSPACE_CONFIG="
              f"{os.environ.get('CUBLAS_WORKSPACE_CONFIG')}")
    half = max(args.rounds // 2, 1)
    with tempfile.TemporaryDirectory() as tmp:
        # threshold 1: any surviving NaN upload quarantines, so the
        # chaos run exercises the quarantine path
        res = ResilienceConfig(checkpoint_every=half, checkpoint_dir=tmp,
                               quarantine_threshold=1)
        full = make_trainer(res=res, quiet=True)
        ms_full = full.run(args.rounds)
        partial = make_trainer(res=res, quiet=True)
        partial.run(half)  # writes the checkpoint at round `half`
        resumed = make_trainer(res=res, quiet=True)
        start = resumed.resume()
        resumed.run(args.rounds)
    same = all(torch.equal(full.params[n], resumed.params[n])
               for n in full.params)
    ok_finite = all(bool(torch.isfinite(p).all())
                    for p in full.params.values())
    n_quar = sum(m.n_quarantined for m in ms_full)
    print(f"\ncheck-resume: resumed_at={start} bit_identical={same} "
          f"finite={ok_finite} quarantined_device_rounds={n_quar}")
    if not (same and ok_finite):
        print("check-resume FAILED", file=sys.stderr)
        raise SystemExit(1)
    if faults is not None and faults.nan_prob > 0 and n_quar == 0:
        print("check-resume FAILED: the plan injected NaN uploads but "
              "quarantine never triggered", file=sys.stderr)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
