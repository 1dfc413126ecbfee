"""End-to-end FEEL training with the port (the paper's experiment, §VI).

Counterpart of ``examples/feel_e2e.py``'s core flags: the §VI-A CNN on
the synthetic MNIST-like set with mislabels, K=10 devices (one class
each), N=5 RBs, Q=2, the proposed scheme or a baseline (``--scheme``),
with sigma scored by the CUDA row-norm kernel (the reference's
``sigma_method="last_layer_kernel"``).

    PYTHONPATH=src python -m repro_torch --rounds 150            # GPU
    PYTHONPATH=src python -m repro_torch --scheme baseline4 --rounds 150
    PYTHONPATH=src python -m repro_torch --rounds 2 --d-hat 12 --side 10 --device cpu
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import torch

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
    metrics = FEELTrainer(sys_, data, model, cfg).run(args.rounds,
                                                      verbose=True)
    final = metrics[-1]
    print(f"\nFINAL: acc={final.test_acc:.3f} "
          f"cum_net_cost={final.cum_net_cost:+.3f} device={device}")
    return metrics


if __name__ == "__main__":
    main()
