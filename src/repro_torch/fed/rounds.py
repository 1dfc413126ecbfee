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

Observability, as in the reference: with a ``repro_torch.obs`` sink
(``telemetry``) each round is a ``round`` span whose stages (``data``,
``sigma``, the decision's ``matching``/``power``/``selection``/
``objective``, ``local_grads``, ``aggregate``, ``eval``) each end with
``tele.block``, so device work lands in the stage that launched it; the
round emits ``devices`` and ``round`` events and, with a metrics
registry installed, the per-round metrics and a registry snapshot.  A
``monitor`` (``obs.ConvergenceMonitor``) is fed the Lemma-2 inputs
every round.  With neither (the default sink is a no-op) a round makes
no per-stage synchronize and its outputs are bit-for-bit those of a
traced one.

Not ported yet: warmup rounds, ``local_steps > 1`` (FedAvg), the
optimizers other than Adam, ``gp_step0``, the chunked GP, the "full"
and "last_layer" sigma methods and the resilience layer (faults,
retries, quarantine, checkpoints, the solver fallback chain, and their
``fault`` trace events).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs, optim
from ..core import cost as cost_mod
from ..core import joint as joint_mod
from ..core.types import RoundState, SystemParams
from ..data.federated import FederatedDataset
from ..device import full_fp32
from ..models import cnn as cnn_mod
from ..obs import metrics as metrics_mod
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
    test_acc: Optional[float] = None
    skipped_update: bool = False  # no usable upload -> no optimizer step


class FEELTrainer:
    """Drives FEEL rounds of the §VI-A CNN on ``sys.device``."""

    def __init__(self, sys: SystemParams, data: FederatedDataset,
                 model: cnn_mod.CNN, cfg: FEELConfig,
                 channel_source: Optional[ChannelSource] = None,
                 telemetry: Optional[obs.NullTelemetry] = None,
                 monitor: Optional[obs.ConvergenceMonitor] = None):
        """``telemetry``: an ``obs`` sink for the round-level trace; the
        default (``None``) resolves to the process-wide sink, a no-op
        unless one was installed with ``obs.set_default``.

        ``monitor``: an ``obs.ConvergenceMonitor`` fed one observation
        per round (training-loss gap proxy, ||g_hat||^2, step size, the
        decision's Delta term, wall and stage times).  ``None`` (the
        default) skips every monitor code path.  Metrics go to the
        process-default registry (``obs.metrics.set_default``).
        """
        self.sys = sys
        self.device = sys.device
        self.data = data
        self.model = model.to(self.device)
        self.cfg = cfg
        self.channel_source = channel_source
        self.rng = np.random.default_rng(cfg.seed)
        self.gen = torch.Generator().manual_seed(cfg.seed)
        self.obs = obs.resolve(telemetry)
        self.monitor = monitor
        self._profiled: set = set()
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
        self._sigma_all = client_mod.batched_sigma
        self._local_grads = client_mod.local_gradients
        if self.obs.annotate:
            # named ranges in a torch.profiler trace
            self._sigma_all = obs.annotate_fn(self._sigma_all,
                                              "repro.sigma_all")
            self._local_grads = obs.annotate_fn(self._local_grads,
                                                "repro.local_grads")

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

    def run_round(self, i: int, eval_now: bool = False) -> RoundMetrics:
        sys, cfg, tele = self.sys, self.cfg, self.obs
        t_round = time.perf_counter()
        tele.begin_round(i)
        ev0 = len(tele.events) if tele.enabled else 0
        # root of this round's span tree: every stage and span opened
        # below records it as parent; closed just before the return
        span_round = tele.span("round")
        span_round.__enter__()

        with tele.stage("data"):
            images, labels, true = self._gather_round_batches()
        if tele.profile:
            self._profile_once("sigma_all", "sigma", self._sigma_all,
                               (self.model, images, labels), tele, i)
        with tele.stage("sigma"):
            sigma = tele.block(self._sigma_all(self.model, images, labels))
        h, alpha = self._channel(i)
        state = RoundState(h=h, alpha=alpha, sigma=sigma,
                           sigma_mask=torch.ones_like(sigma))

        if cfg.scheme == "proposed":
            dec = joint_mod.proposed_scheme(
                sys, state, selection_method=cfg.selection_method,
                power_evaluator=cfg.power_evaluator, gp_steps=cfg.gp_steps,
                telemetry=tele)
        else:
            dec = joint_mod.baseline_scheme(
                sys, state, int(cfg.scheme[-1]), generator=self.gen,
                telemetry=tele)
        delta = dec.delta
        matched = torch.as_tensor(dec.rho.sum(axis=1) > 0,
                                  dtype=torch.float32, device=self.device)
        uploaded = alpha * matched

        gap_proxy = None
        if self.monitor is not None:
            # mean training loss on the round batch under the pre-update
            # params: the Lemma-2 gap proxy (the L* offset cancels, see
            # obs.monitor); read only, numerics untouched
            with torch.no_grad(), full_fp32():
                gap_proxy = float(cnn_mod.loss_fn(
                    self.model, images.reshape((-1,) + images.shape[2:]),
                    labels.reshape(-1)))

        if tele.profile:
            self._profile_once("local_grads", "local_grads",
                               self._local_grads,
                               (self.model, images, labels, delta), tele, i)
        with tele.stage("local_grads"):
            grads = tele.block(self._local_grads(self.model, images, labels,
                                                 delta))

        g_norm_sq = None
        with tele.stage("aggregate"):
            g_hat = server_mod.aggregate_gradients(sys, grads, uploaded)
            # no upload to aggregate: an Adam step on a zero gradient
            # would still move the moments, so the update is skipped
            skipped_update = server_mod.ipw_mass(sys, uploaded) <= 0.0
            if skipped_update:
                g_norm_sq = 0.0 if self.monitor is not None else None
                tele.fault("skip_update", injected=False,
                           reason="no_surviving_upload")
                reg0 = metrics_mod.get_default()
                if reg0.enabled:
                    reg0.counter("feel_rounds_skipped_total",
                                 "rounds whose optimizer update was "
                                 "skipped (no usable upload)").inc()
            else:
                if self.monitor is not None:
                    g_norm_sq = float(sum(torch.sum(x * x)
                                          for x in g_hat.values()))
                updates, self.opt_state = self.opt.update(g_hat,
                                                          self.opt_state)
                optim.apply_updates(self.params, updates)
                tele.block(self.params)

        sel = delta.cpu().numpy() > 0.5
        mislabeled = labels.cpu().numpy() != true
        frac_bad = float(np.sum(sel & mislabeled)) / max(int(np.sum(sel)), 1)
        acc = None
        if eval_now:
            with tele.stage("eval"):
                acc = cnn_mod.accuracy(self.model, self.test_images,
                                       self.test_labels)
        self._cum += dec.net_cost
        self.last_state, self.last_decision = state, dec
        self.last_g_hat = g_hat
        up = uploaded.cpu().numpy().astype(np.int64)
        n_selected, n_uploaded = int(np.sum(sel)), int(np.sum(up))
        reg = metrics_mod.get_default()
        wall_s = time.perf_counter() - t_round
        if tele.enabled or reg.enabled:
            e_cmp, e_com = self._energy_terms(dec)
            if tele.enabled:
                self._record_round(tele, dec, sel, mislabeled, up, acc,
                                   wall_s, e_cmp, e_com)
            if reg.enabled:
                self._record_metrics(reg, dec, e_cmp, e_com, n_selected,
                                     n_uploaded, wall_s)
            if tele.enabled and reg.enabled:
                tele.emit(reg.snapshot_event(round=i))
        if self.monitor is not None:
            stage_s = None
            if tele.enabled:
                stage_s = {e.stage: e.dur_s for e in tele.events[ev0:]
                           if isinstance(e, obs.StageEvent)}
            self.monitor.observe_round(
                i, gap=gap_proxy, g_norm_sq=g_norm_sq, eta=cfg.lr,
                delta_obj=float(dec.delta_obj), wall_s=wall_s,
                stage_s=stage_s)
        span_round.__exit__(None, None, None)
        return RoundMetrics(round=i, net_cost=dec.net_cost,
                            cum_net_cost=self._cum, delta_obj=dec.delta_obj,
                            n_selected=n_selected, n_uploaded=n_uploaded,
                            frac_mislabeled_selected=frac_bad,
                            swaps=dec.swaps, wall_s=wall_s, test_acc=acc,
                            skipped_update=skipped_update)

    def _profile_once(self, name: str, stage: str, fn, args, tele,
                      round_i: int) -> None:
        """Record one roofline ``ProfileEvent`` per (function, shapes),
        outside the timed stage."""
        shapes = tuple(tuple(a.shape) for a in args
                       if isinstance(a, torch.Tensor))
        key = (name, shapes)
        if key in self._profiled:
            return
        self._profiled.add(key)
        obs.profile_fn(fn, args, name=name, stage=stage, telemetry=tele,
                       round=round_i, device=self.device)

    def _energy_terms(self, dec) -> Tuple[np.ndarray, np.ndarray]:
        """Per-device E^cmp (eq. 9) and E^com (eq. 16) for the chosen
        decision, as float64 numpy arrays."""
        rho = torch.as_tensor(dec.rho, dtype=torch.float32,
                              device=self.device)
        e_cmp = cost_mod.energy_compute(self.sys).cpu().numpy()
        e_com = cost_mod.energy_upload(self.sys, rho, dec.p).cpu().numpy()
        return e_cmp.astype(np.float64), e_com.astype(np.float64)

    def _record_round(self, tele, dec, sel: np.ndarray,
                      mislabeled: np.ndarray, uploaded: np.ndarray,
                      acc, wall_s: float, e_cmp: np.ndarray,
                      e_com: np.ndarray) -> None:
        """Emit the per-device (eqs. 16-18 terms) and round roll-up
        events.  Only called when the sink is enabled."""
        sys = self.sys
        c = sys.c.cpu().numpy().astype(np.float64)
        q = sys.q.cpu().numpy().astype(np.float64)
        m_k = sel.sum(axis=1)
        bad_k = (sel & mislabeled).sum(axis=1) / np.maximum(m_k, 1)
        tele.devices(
            energy_cmp_j=e_cmp.tolist(),
            energy_com_j=e_com.tolist(),
            cost=(c * (e_cmp + e_com)).tolist(),
            reward=(q * m_k).tolist(),
            selected=[int(v) for v in m_k],
            uploaded=[int(v) for v in uploaded],
            mislabel_frac=bad_k.tolist())
        tele.round_end(wall_s=wall_s, net_cost=float(dec.net_cost),
                       delta_obj=float(dec.delta_obj),
                       n_selected=int(sel.sum()),
                       n_uploaded=int(uploaded.sum()),
                       feasible=bool(dec.feasible),
                       test_acc=None if acc is None else float(acc))

    def _record_metrics(self, reg, dec, e_cmp: np.ndarray,
                        e_com: np.ndarray, n_selected: int,
                        n_uploaded: int, wall_s: float) -> None:
        """Per-round budget/outcome metrics (eqs. 16-18).  Only called
        when a real registry is installed."""
        reg.counter("feel_rounds_total", "completed FEEL rounds").inc()
        if not dec.feasible:
            reg.counter("feel_rounds_infeasible_total",
                        "rounds whose decision was infeasible").inc()
        reg.histogram("feel_round_wall_seconds",
                      "wall-clock per FEEL round").observe(wall_s)
        reg.counter("feel_energy_compute_joules_total",
                    "E^cmp (eq. 9) summed over devices and rounds").inc(
                        float(e_cmp.sum()))
        reg.counter("feel_energy_upload_joules_total",
                    "E^com (eq. 16) summed over devices and rounds").inc(
                        float(e_com.sum()))
        reg.counter("feel_samples_selected_total",
                    "samples selected for training").inc(n_selected)
        reg.counter("feel_samples_uploaded_total",
                    "device uploads aggregated").inc(n_uploaded)
        reg.gauge("feel_cum_net_cost",
                  "cumulative net cost (eq. 18) so far").set(self._cum)
        reg.gauge("feel_time_budget_seconds",
                  "per-round upload latency budget T (eq. 16)").set(
                      float(self.sys.T))

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
