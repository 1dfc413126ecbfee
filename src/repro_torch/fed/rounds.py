"""The FEEL communication-round loop (paper §II + Algorithm 1).

Counterpart of ``repro/fed/rounds.py``, plain path (the proposed scheme
or a baseline, FedSGD, Adam).  Each round:

  1. every device samples |D̂_k| local samples and scores them
     (sigma_{k,j} = per-sample gradient-norm^2 of the output layer, the
     reference's ``sigma_method="last_layer_kernel"``: one fused
     all-device pass through the CUDA row-norm kernel);
  2. channel gains h_{k,n} and availability alpha_k are drawn;
  3. the server runs Algorithm 1 (``cfg.scheme="proposed"``, with the
     closed-form or CCP power evaluator) or baseline 1-4 to fix
     (rho*, p*, delta*) and is billed the net cost (eq. 18);
  4. devices compute local gradients on their selected samples (eq. 4);
  5. the server aggregates with inverse-propensity weights (eq. 19) and
     takes an Adam step.

Randomness: data subsets come from a numpy ``Generator`` seeded with
``cfg.seed``, as in the reference, so they match it bit for bit; h and
alpha come from the trainer's own CPU ``torch.Generator`` (the reference
draws them with ``jax.random``), or from ``channel_source(i)``, which a
test uses to replay the reference's draws; baselines 1 and 2 then draw
their random half from the same generator.  Every draw is made on the
CPU, so a run on the GPU and a run on the CPU see the same inputs.

Not ported yet: warmup rounds, ``local_steps > 1`` (FedAvg), the
optimizers other than Adam, ``gp_step0``, the chunked GP, the "full"
and "last_layer" sigma methods, the resilience layer (faults, retries,
quarantine, checkpoints, the solver fallback chain) and the telemetry
sink; per-stage wall times are returned in ``RoundMetrics.stage_s``
instead.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import optim
from ..core import joint as joint_mod
from ..core.types import RoundState, SystemParams
from ..data.federated import FederatedDataset
from ..device import synchronize
from ..models import cnn as cnn_mod
from . import client as client_mod
from . import server as server_mod

#: per-round (h, alpha) source: round index -> ((K, N) gains, (K,) 0/1).
ChannelSource = Callable[[int], Tuple[np.ndarray, np.ndarray]]


#: the schemes of paper §VI-A: Algorithm 1 and baselines 1-4
SCHEMES = ("proposed", "baseline1", "baseline2", "baseline3", "baseline4")


@dataclasses.dataclass
class FEELConfig:
    scheme: str = "proposed"            # proposed | baseline1..baseline4
    selection_method: str = "faithful"  # faithful (Alg 4+5) | exact
    power_evaluator: str = "closed_form"  # closed_form | ccp (Alg. 3)
    lr: float = 1e-3
    d_hat: int = 200
    gp_steps: int = 400
    eval_every: int = 10
    seed: int = 0

    def __post_init__(self):
        if self.scheme not in SCHEMES:
            raise ValueError(f"unknown scheme {self.scheme!r}; one of "
                             f"{SCHEMES}")
        if self.power_evaluator not in ("closed_form", "ccp"):
            raise ValueError(
                f"unknown power evaluator {self.power_evaluator!r}")


@dataclasses.dataclass
class RoundMetrics:
    round: int
    net_cost: float
    cum_net_cost: float
    delta_obj: float
    n_selected: int
    n_uploaded: int
    frac_mislabeled_selected: float
    swaps: int
    wall_s: float
    #: wall seconds per stage, each ended by a device synchronize
    stage_s: Dict[str, float]
    test_acc: Optional[float] = None
    skipped_update: bool = False  # no usable upload -> no optimizer step


class FEELTrainer:
    """Drives FEEL rounds of the §VI-A CNN on ``sys.device``."""

    def __init__(self, sys: SystemParams, data: FederatedDataset,
                 model: cnn_mod.CNN, cfg: FEELConfig,
                 channel_source: Optional[ChannelSource] = None):
        self.sys = sys
        self.device = sys.device
        self.data = data
        self.model = model.to(self.device)
        self.cfg = cfg
        self.channel_source = channel_source
        self.rng = np.random.default_rng(cfg.seed)
        self.gen = torch.Generator().manual_seed(cfg.seed)
        self.params = dict(self.model.named_parameters())
        self.opt = optim.adam(cfg.lr)
        self.opt_state = self.opt.init(self.params)
        self.test_images = torch.as_tensor(data.test_images,
                                           device=self.device)
        self.test_labels = torch.as_tensor(data.test_labels,
                                           device=self.device)
        self._cum = 0.0
        #: the last round's inputs and outputs, for inspection
        self.last_state: Optional[RoundState] = None
        self.last_decision: Optional[joint_mod.RoundDecision] = None
        self.last_g_hat: Optional[Dict[str, torch.Tensor]] = None

    # ------------------------------------------------------------------
    def _gather_round_batches(self):
        idx = self.data.sample_subsets(self.rng, self.cfg.d_hat)
        K = self.sys.K
        imgs = np.stack([self.data.device_images[k][idx[k]] for k in range(K)])
        labels = np.stack([self.data.device_labels[k][idx[k]]
                           for k in range(K)])
        true = np.stack([self.data.device_true[k][idx[k]] for k in range(K)])
        return (torch.as_tensor(imgs, device=self.device),
                torch.as_tensor(labels, dtype=torch.int64, device=self.device),
                true)

    def _channel(self, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """h ~ Exp(mean 1e-5) per (device, RB); alpha_k ~ Bernoulli(eps_k)."""
        sys = self.sys
        if self.channel_source is not None:
            h, alpha = self.channel_source(i)
            h = torch.as_tensor(np.array(h, np.float32))
            alpha = torch.as_tensor(np.array(alpha, np.float32))
        else:
            h = torch.empty(sys.K, sys.N).exponential_(
                generator=self.gen) * 1e-5
            alpha = (torch.rand(sys.K, generator=self.gen)
                     < sys.eps.cpu()).to(torch.float32)
        return h.to(self.device), alpha.to(self.device)

    @contextlib.contextmanager
    def _stage(self, times: Dict[str, float], name: str):
        t0 = time.perf_counter()
        yield
        synchronize(self.device)
        times[name] = time.perf_counter() - t0

    def run_round(self, i: int, eval_now: bool = False) -> RoundMetrics:
        sys, cfg = self.sys, self.cfg
        t_round = time.perf_counter()
        st: Dict[str, float] = {}

        with self._stage(st, "data"):
            images, labels, true = self._gather_round_batches()
        with self._stage(st, "sigma"):
            sigma = client_mod.batched_sigma(self.model, images, labels)
        h, alpha = self._channel(i)
        state = RoundState(h=h, alpha=alpha, sigma=sigma,
                           sigma_mask=torch.ones_like(sigma))

        with self._stage(st, "decision"):
            if cfg.scheme == "proposed":
                dec = joint_mod.proposed_scheme(
                    sys, state, selection_method=cfg.selection_method,
                    power_evaluator=cfg.power_evaluator,
                    gp_steps=cfg.gp_steps)
            else:
                dec = joint_mod.baseline_scheme(
                    sys, state, int(cfg.scheme[-1]), generator=self.gen)
        delta = dec.delta
        matched = torch.as_tensor(dec.rho.sum(axis=1) > 0,
                                  dtype=torch.float32, device=self.device)
        uploaded = alpha * matched

        with self._stage(st, "local_grads"):
            grads = client_mod.local_gradients(self.model, images, labels,
                                               delta)
        with self._stage(st, "aggregate"):
            g_hat = server_mod.aggregate_gradients(sys, grads, uploaded)
            # no upload to aggregate: an Adam step on a zero gradient
            # would still move the moments, so the update is skipped
            skipped_update = server_mod.ipw_mass(sys, uploaded) <= 0.0
            if not skipped_update:
                updates, self.opt_state = self.opt.update(g_hat,
                                                          self.opt_state)
                optim.apply_updates(self.params, updates)

        sel = delta.cpu().numpy() > 0.5
        mislabeled = labels.cpu().numpy() != true
        frac_bad = float(np.sum(sel & mislabeled)) / max(int(np.sum(sel)), 1)
        acc = None
        if eval_now:
            with self._stage(st, "eval"):
                acc = cnn_mod.accuracy(self.model, self.test_images,
                                       self.test_labels)
        self._cum += dec.net_cost
        self.last_state, self.last_decision = state, dec
        self.last_g_hat = g_hat
        return RoundMetrics(round=i, net_cost=dec.net_cost,
                            cum_net_cost=self._cum, delta_obj=dec.delta_obj,
                            n_selected=int(np.sum(sel)),
                            n_uploaded=int(uploaded.sum()),
                            frac_mislabeled_selected=frac_bad,
                            swaps=dec.swaps,
                            wall_s=time.perf_counter() - t_round,
                            stage_s=st, test_acc=acc,
                            skipped_update=skipped_update)

    def run(self, rounds: int, verbose: bool = False) -> List[RoundMetrics]:
        out = []
        for i in range(rounds):
            eval_now = (i % self.cfg.eval_every == 0) or i == rounds - 1
            m = self.run_round(i, eval_now=eval_now)
            out.append(m)
            if verbose and eval_now:
                print(f"round {i:4d} acc={m.test_acc} "
                      f"cum_cost={m.cum_net_cost:.4f} sel={m.n_selected} "
                      f"bad_frac={m.frac_mislabeled_selected:.3f}")
        return out
