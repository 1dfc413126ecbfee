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
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from . import obs
from .core import default_system
from .data import SyntheticImages, non_iid_split
from .device import resolve_device
from .fed import FEELConfig, FEELTrainer, RoundMetrics
from .fed.rounds import SCHEMES
from .models import cnn


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
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    train = SyntheticImages.make(6000, side=args.side, seed=0)
    test = SyntheticImages.make(1500, side=args.side, seed=1)
    data = non_iid_split(train, test, K=10, per_device=600,
                         mislabel_prop=args.mislabel, seed=0)
    sys_ = default_system(K=10, N=5, Q=2, D_hat=args.d_hat, device=device)
    cfg = FEELConfig(scheme=args.scheme, d_hat=args.d_hat,
                     selection_method=args.selection)
    model = cnn.CNN(cnn.CNNConfig(side=args.side),
                    generator=torch.Generator().manual_seed(cfg.seed))
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
    try:
        metrics = FEELTrainer(sys_, data, model, cfg, telemetry=tele,
                              monitor=monitor).run(args.rounds, verbose=True)
    finally:
        if reg is not None:
            obs.metrics.set_default(None)
        if tele is not None:
            tele.close()
    final = metrics[-1]
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


if __name__ == "__main__":
    main()
