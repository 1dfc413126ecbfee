"""The FEEL communication-round loop (paper §II + Algorithm 1).

Counterpart of ``repro/fed/rounds.py``; ``FEELConfig`` has every field
of the reference's, each meaning what it means there.  Each round:

  1. every device samples |D̂_k| local samples and scores them
     (sigma_{k,j} = per-sample gradient-norm^2): by default of the
     output layer in one fused all-device pass through the CUDA row-norm
     kernel (``sigma_method="last_layer_kernel"``), or the same score in
     plain tensor ops (``"last_layer"``), or over every parameter
     (``"full"``);
  2. channel gains h_{k,n} and availability alpha_k are drawn;
  3. the server runs Algorithm 1 (``cfg.scheme="proposed"``, with the
     closed-form or CCP power evaluator, the scalar or batched matching
     sweep, the full-matrix or device-chunked gradient projection and
     its step constant ``gp_step0``) or baseline 1-4 to fix
     (rho*, p*, delta*) and is billed the net cost (eq. 18); in the
     first ``warmup_rounds`` rounds the proposed scheme allocates
     resources as usual and selects every sample;
  4. devices compute local gradients on their selected samples (eq. 4),
     FedSGD; with ``local_steps > 1`` the FedAvg variant of footnote 4
     runs that many local SGD steps and uploads (w - w') / lr;
  5. the server aggregates with inverse-propensity weights (eq. 19) and
     applies the optimizer update (eq. 20): adam (§VI-A), sgd, momentum
     or adafactor.

Randomness: data subsets come from a numpy ``Generator`` seeded with
``cfg.seed``, as in the reference, so they match it bit for bit; h and
alpha come from the trainer's own CPU ``torch.Generator`` (the reference
draws them with ``jax.random``), or from ``channel_source(i)``, which a
test uses to replay the reference's draws; baselines 1 and 2 then draw
their random half from the same generator.  Every draw is made on the
CPU, so a run on the GPU and a run on the CPU see the same inputs.

Resilience, as in the reference: a ``FaultPlan`` (``faults=``) injects
post-matching dropouts, straggler delays, NaN uploads and forced solver
failures, and a ``ResilienceConfig`` (``resilience=``) sets the
policies: an upload deadline with bounded retry and backoff, survivor
re-weighting (or a closed-form re-solve) of the aggregation, NaN
screening with per-device quarantine, the solver fallback chain
(``core/joint.py``), and periodic checkpoints that ``resume`` continues
from bit for bit: on the GPU only under cuDNN's deterministic algorithms
(``torch.backends.cudnn.deterministic = True``, which ``--check-resume``
sets); under its default algorithms the weight gradients of a resumed
run may differ at float32 noise.  Either argument turns the layer on;
with neither a round is the plain path.  Checkpoints are the
reference's npz + meta files: the params and the optimizer's state in
its layout and under its keys (``cnn.params_to_numpy``; adafactor's
factored moments are kept on the reference's axes), the numpy data
stream, the round, the cost and the quarantine state, plus the CPU
generator's state under a key of the port's own (``GEN_STATE_KEY``).

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
"""
from __future__ import annotations

import base64
import dataclasses
import functools
import os
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import checkpoint as ckpt_mod
from .. import obs, optim
from ..core import cost as cost_mod
from ..core import joint as joint_mod
from ..core.types import RoundState, SystemParams
from ..data.federated import FederatedDataset
from ..device import full_fp32
from ..models import cnn as cnn_mod
from ..obs import metrics as metrics_mod
from . import client as client_mod
from . import faults as faults_mod
from . import server as server_mod

#: per-round (h, alpha) source: round index -> ((K, N) gains, (K,) 0/1).
ChannelSource = Callable[[int], Tuple[np.ndarray, np.ndarray]]


#: the schemes of paper §VI-A: Algorithm 1 and baselines 1-4
SCHEMES = ("proposed", "baseline1", "baseline2", "baseline3", "baseline4")
#: the values of the other choice fields of ``FEELConfig``
SELECTION_METHODS = ("faithful", "exact")
SIGMA_METHODS = ("last_layer_kernel", "last_layer", "full")
POWER_EVALUATORS = ("closed_form", "ccp")
MATCHING_MODES = ("auto", "scalar", "batched")
OPTIMIZERS = ("adam", "sgd", "momentum", "adafactor")

#: checkpoint file prefix inside a checkpoint directory.
CKPT_NAME = "feel_ckpt"
#: the checkpoint ``meta`` key of the CPU generator's state (base64 of
#: ``torch.Generator.get_state()``); the reference's checkpoints hold a
#: JAX key instead, which no torch generator state can stand for.
GEN_STATE_KEY = "torch_generator_state"


@dataclasses.dataclass
class FEELConfig:
    scheme: str = "proposed"            # proposed | baseline1..baseline4
    selection_method: str = "faithful"  # faithful (Alg 4+5) | exact
    # last_layer_kernel (one fused all-device pass through the CUDA
    # row-norm kernel, kernels/gradnorm) | last_layer | full.  The
    # reference defaults to "last_layer"; the port's default stays on
    # the kernel, so that no default moves sigma off it (a comparison
    # with the reference sets the field on both sides)
    sigma_method: str = "last_layer_kernel"
    power_evaluator: str = "closed_form"  # closed_form | ccp (Alg. 3)
    # swap-matching sweep: auto (batched at >= AUTO_BATCH_MIN available
    # devices) | scalar | batched
    matching_mode: str = "auto"
    # 0 = full-matrix Alg. 4; >0 = device blocks of that size in the
    # reference (the port's iterates do not depend on it)
    selection_chunk: int = 0
    optimizer: str = "adam"           # adam | sgd | momentum | adafactor
    lr: float = 1e-3
    d_hat: int = 200
    local_steps: int = 1              # >1 => FedAvg variant
    gp_steps: int = 400
    gp_step0: float = 0.3
    warmup_rounds: int = 0    # select ALL samples first (beyond-paper fix:
                              # sigma is uninformative before the model fits)
    eval_every: int = 10
    seed: int = 0

    def __post_init__(self):
        for field, allowed in (("scheme", SCHEMES),
                               ("selection_method", SELECTION_METHODS),
                               ("sigma_method", SIGMA_METHODS),
                               ("power_evaluator", POWER_EVALUATORS),
                               ("matching_mode", MATCHING_MODES),
                               ("optimizer", OPTIMIZERS)):
            if getattr(self, field) not in allowed:
                raise ValueError(f"unknown {field} {getattr(self, field)!r};"
                                 f" one of {allowed}")
        for field, least in (("selection_chunk", 0), ("local_steps", 1),
                             ("warmup_rounds", 0)):
            if getattr(self, field) < least:
                raise ValueError(f"{field} must be >= {least}, got "
                                 f"{getattr(self, field)}")


@dataclasses.dataclass
class ResilienceConfig:
    """Knobs of the fault-tolerance layer (as the reference's).

    Passing one to ``FEELTrainer`` (or passing a fault plan) turns the
    resilience policies on; with the defaults and no materialized fault
    every round stays bit-for-bit a plain run's while the matching is
    feasible (the layer also repairs infeasible matchings).
    """

    #: upload deadline in seconds; None derives 1.5 x the slowest
    #: clean completion max_k(tau_k) + T (eqs. 8 + 16 latency model).
    deadline_s: Optional[float] = None
    #: bounded retries for a straggling upload before it is dropped.
    max_retries: int = 2
    #: exponential backoff: retry t waits until deadline * base**t.
    backoff_base: float = 2.0
    #: mid-round dropout handling: "reweight" renormalizes the IPW
    #: aggregation over survivors; "resolve" additionally re-solves the
    #: RB assignment for the survivor set (cost accounting follows).
    dropout_policy: str = "reweight"
    #: consecutive non-finite uploads before a device is quarantined.
    quarantine_threshold: int = 2
    #: rounds a quarantined device sits out; each clean upload
    #: afterwards decays one strike (skip-with-decay).
    quarantine_rounds: int = 3
    #: checkpoint every N rounds (0 = never) into checkpoint_dir.
    checkpoint_every: int = 0
    checkpoint_dir: Optional[str] = None


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
    n_dropped: int = 0          # scheduled uploads lost this round
    n_quarantined: int = 0      # devices sitting out this round
    n_retries: int = 0          # straggler retry attempts this round
    skipped_update: bool = False  # no usable upload -> no optimizer step
    fallbacks: tuple = ()       # solver degradations (RoundDecision)


class FEELTrainer:
    """Drives FEEL rounds of the §VI-A CNN on ``sys.device``."""

    def __init__(self, sys: SystemParams, data: FederatedDataset,
                 model: cnn_mod.CNN, cfg: FEELConfig,
                 channel_source: Optional[ChannelSource] = None,
                 telemetry: Optional[obs.NullTelemetry] = None,
                 monitor: Optional[obs.ConvergenceMonitor] = None,
                 faults: Optional[Union[faults_mod.FaultPlan,
                                        faults_mod.FaultSpec]] = None,
                 resilience: Optional[ResilienceConfig] = None):
        """``telemetry``: an ``obs`` sink for the round-level trace; the
        default (``None``) resolves to the process-wide sink, a no-op
        unless one was installed with ``obs.set_default``.

        ``monitor``: an ``obs.ConvergenceMonitor`` fed one observation
        per round (training-loss gap proxy, ||g_hat||^2, step size, the
        decision's Delta term, wall and stage times).  ``None`` (the
        default) skips every monitor code path.  Metrics go to the
        process-default registry (``obs.metrics.set_default``).

        ``faults``: a ``fed.faults.FaultPlan`` (or its spec) injecting
        post-matching dropouts, straggler delays, NaN uploads and forced
        solver failures, deterministic and replayable.  ``resilience``:
        a ``ResilienceConfig``.  Either turns the resilience layer on.
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
        if isinstance(faults, faults_mod.FaultSpec):
            faults = faults_mod.FaultPlan(faults)
        self.faults = faults
        self._resilient = faults is not None or resilience is not None
        self._res = resilience if resilience is not None \
            else ResilienceConfig()
        self._strikes = np.zeros(sys.K, np.int64)
        self._quarantined_until = np.zeros(sys.K, np.int64)
        self._start_round = 0
        self._profiled: set = set()
        self.params = dict(self.model.named_parameters())
        self.opt = _build_optimizer(cfg, self.params)
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
        if cfg.sigma_method == "last_layer_kernel":
            self._sigma_all = client_mod.batched_sigma
        else:
            self._sigma_all = functools.partial(client_mod.device_sigma,
                                                method=cfg.sigma_method)
        self._local_grads = client_mod.local_gradients
        self._local_deltas = client_mod.local_deltas
        if self.obs.annotate:
            # named ranges in a torch.profiler trace
            self._sigma_all = obs.annotate_fn(self._sigma_all,
                                              "repro.sigma_all")
            self._local_grads = obs.annotate_fn(self._local_grads,
                                                "repro.local_grads")
            self._local_deltas = obs.annotate_fn(self._local_deltas,
                                                 "repro.local_deltas")

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
        rf = (self.faults.for_round(i, sys.K)
              if self.faults is not None else None)

        with tele.stage("data"):
            images, labels, true = self._gather_round_batches()
        if tele.profile:
            self._profile_once("sigma_all", "sigma", self._sigma_all,
                               (self.model, images, labels), tele, i)
        with tele.stage("sigma"):
            sigma = tele.block(self._sigma_all(self.model, images, labels))
        h, alpha = self._channel(i)
        n_quarantined = 0
        if self._resilient:
            # quarantined devices sit the round out before the solve, so
            # no RB or power is allocated to them (skip-with-decay)
            quarantined = self._quarantined_until > i
            n_quarantined = int(np.sum(quarantined))
            if n_quarantined:
                alpha = alpha * torch.as_tensor(~quarantined,
                                                dtype=torch.float32,
                                                device=self.device)
        state = RoundState(h=h, alpha=alpha, sigma=sigma,
                           sigma_mask=torch.ones_like(sigma))

        if cfg.scheme == "proposed" and i < cfg.warmup_rounds:
            # warmup: resource allocation as proposed, selection = all
            match = joint_mod.matching_mod.swap_matching(
                sys, state.h, state.alpha, evaluator=cfg.power_evaluator,
                mode=(cfg.matching_mode
                      if cfg.power_evaluator == "closed_form" else "auto"),
                telemetry=tele)
            with tele.stage("selection"):
                pass  # warmup selects everything; keep the stage present
            dec = joint_mod._finish(sys, match.rho, match.p,
                                    state.sigma_mask, state,
                                    feasible=match.feasible,
                                    swaps=match.swaps,
                                    unmatched=match.unmatched,
                                    telemetry=tele)
        elif cfg.scheme == "proposed":
            dec = joint_mod.proposed_scheme(
                sys, state, selection_method=cfg.selection_method,
                power_evaluator=cfg.power_evaluator, gp_steps=cfg.gp_steps,
                gp_step0=cfg.gp_step0, matching_mode=cfg.matching_mode,
                selection_chunk=cfg.selection_chunk, faults=rf,
                repair_infeasible=self._resilient, telemetry=tele)
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

        if cfg.local_steps > 1:
            name, local_fn = "local_deltas", self._local_deltas
            local_args = (self.model, images, labels, delta, cfg.lr,
                          cfg.local_steps)
        else:
            name, local_fn = "local_grads", self._local_grads
            local_args = (self.model, images, labels, delta)
        if tele.profile:
            self._profile_once(name, "local_grads", local_fn, local_args,
                               tele, i)
        with tele.stage("local_grads"):
            grads = tele.block(local_fn(*local_args))

        # fault application and the resilience policies
        planned = uploaded.cpu().numpy() > 0
        surv = planned
        n_dropped = n_retries = 0
        if self._resilient:
            surv, n_dropped, n_retries = self._upload_outcomes(
                i, rf, planned, tele)
            grads = self._inject_nan_uploads(rf, surv, grads)
            surv, n_bad = self._screen_nonfinite(i, rf, surv, grads, tele)
            n_dropped += n_bad

        g_norm_sq = None
        with tele.stage("aggregate"):
            if self._resilient and not np.array_equal(surv, planned):
                surv_t = torch.as_tensor(surv, dtype=torch.float32,
                                         device=self.device)
                if self._res.dropout_policy == "resolve" and surv.any():
                    dec = self._resolve_for_survivors(state, surv_t, dec,
                                                      tele)
                # zero the lost uploads before the weighted sum: their
                # IPW weight is 0, but 0 * NaN would still poison it
                surv_b = torch.as_tensor(surv, device=self.device)
                grads = {name: torch.where(
                    surv_b.reshape((sys.K,) + (1,) * (leaf.ndim - 1)),
                    leaf, 0.0) for name, leaf in grads.items()}
                # IPW-consistent reweighting over the survivor set
                g_hat = server_mod.aggregate_gradients(sys, grads, surv_t,
                                                       renormalize=True)
                mass = server_mod.ipw_mass(sys, surv_t)
            else:
                g_hat = server_mod.aggregate_gradients(sys, grads, uploaded)
                mass = server_mod.ipw_mass(sys, uploaded)
            # no upload to aggregate: a step on a zero gradient would
            # still move the optimizer's state, so the update is skipped
            skipped_update = mass <= 0.0
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
                updates, self.opt_state = self.opt.update(
                    g_hat, self.opt_state, self.params)
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
        up = surv.astype(np.int64)
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
        if (self._res.checkpoint_every > 0 and self._res.checkpoint_dir
                and (i + 1) % self._res.checkpoint_every == 0):
            path = self.save_checkpoint(next_round=i + 1)
            tele.fault("checkpoint", injected=False, path=path,
                       next_round=i + 1)
            if reg.enabled:
                reg.counter("feel_checkpoints_total",
                            "periodic trainer checkpoints written").inc()
        span_round.__exit__(None, None, None)
        return RoundMetrics(round=i, net_cost=dec.net_cost,
                            cum_net_cost=self._cum, delta_obj=dec.delta_obj,
                            n_selected=n_selected, n_uploaded=n_uploaded,
                            frac_mislabeled_selected=frac_bad,
                            swaps=dec.swaps, wall_s=wall_s, test_acc=acc,
                            n_dropped=n_dropped, n_quarantined=n_quarantined,
                            n_retries=n_retries,
                            skipped_update=skipped_update,
                            fallbacks=dec.fallbacks)

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

    # ------------------------------------------------------------------
    # fault-tolerance layer
    # ------------------------------------------------------------------
    def _upload_outcomes(self, i: int, rf, planned: np.ndarray, tele):
        """Apply post-matching dropout and the straggler deadline with
        bounded retry + exponential backoff.  Returns the surviving
        upload mask plus (dropped, retry) counts."""
        res = self._res
        surv = planned.copy()
        n_dropped = n_retries = 0
        if rf is not None and rf.dropout.any():
            lost = planned & rf.dropout
            for k in np.flatnonzero(lost):
                tele.fault("dropout", injected=True, device=int(k))
            joint_mod._count_injected("dropout", int(lost.sum()))
            surv &= ~lost
            n_dropped += int(lost.sum())
        # upload completion per the eq. (8)+(16) latency model: compute
        # time tau_k plus the T-second upload slot, plus injected delay;
        # float64 on the host, as the reference
        tau = cost_mod.compute_time(self.sys).cpu().numpy().astype(
            np.float64)
        T = float(self.sys.T)
        deadline = (res.deadline_s if res.deadline_s is not None
                    else 1.5 * float(tau.max() + T))
        delays = rf.delay_s if rf is not None else np.zeros(self.sys.K)
        for k in np.flatnonzero(surv):
            # one span per attempted upload, on that device's track
            with tele.span("device.upload", device=int(k),
                           tau_s=float(tau[k])):
                if tau[k] + T + float(delays[k]) <= deadline:
                    continue
                injected = bool(rf is not None and rf.straggler[k])
                ok = False
                for t in range(1, res.max_retries + 1):
                    n_retries += 1
                    window = deadline * res.backoff_base ** t
                    d_t = (self.faults.retry_delay_s(i, int(k), t)
                           if self.faults is not None else 0.0)
                    tele.fault("retry", injected=injected, device=int(k),
                               attempt=t, delay_s=d_t, window_s=window)
                    if tau[k] + T + d_t <= window:
                        ok = True
                        break
                tele.fault("straggler", injected=injected, device=int(k),
                           delay_s=float(delays[k]), dropped=not ok,
                           retries=n_retries)
                if injected:
                    joint_mod._count_injected("straggler")
                if not ok:
                    surv[k] = False
                    n_dropped += 1
        reg = metrics_mod.get_default()
        if reg.enabled:
            if n_retries:
                reg.counter("feel_retries_total",
                            "straggler upload retry attempts").inc(
                                n_retries)
            if n_dropped:
                reg.counter("feel_dropouts_total",
                            "scheduled uploads lost mid-round").inc(
                                n_dropped)
        return surv, n_dropped, n_retries

    def _inject_nan_uploads(self, rf, surv: np.ndarray,
                            grads: Dict[str, torch.Tensor]
                            ) -> Dict[str, torch.Tensor]:
        """Corrupt the gradient upload of the plan's NaN devices (the
        screen then has to catch real NaNs)."""
        if rf is None or not bool((rf.nan_upload & surv).any()):
            return grads
        bad = rf.nan_upload & surv
        joint_mod._count_injected("nan_upload", int(bad.sum()))
        bad_t = torch.as_tensor(bad, device=self.device)
        return {name: torch.where(
            bad_t.reshape((self.sys.K,) + (1,) * (leaf.ndim - 1)),
            torch.nan, leaf) for name, leaf in grads.items()}

    def _screen_nonfinite(self, i: int, rf, surv: np.ndarray,
                          grads: Dict[str, torch.Tensor], tele):
        """Exclude non-finite uploads from aggregation and run the
        per-device quarantine (skip-with-decay) bookkeeping.  Every
        leaf's per-device finiteness comes to the host in one copy."""
        K = self.sys.K
        finite = torch.stack([torch.isfinite(leaf).reshape(K, -1).all(dim=1)
                              for leaf in grads.values()]).all(dim=0)
        finite = finite.cpu().numpy()
        bad = surv & ~finite
        clean = surv & finite
        res = self._res
        reg = metrics_mod.get_default()
        if bad.any() and reg.enabled:
            reg.counter("feel_nan_uploads_total",
                        "uploads excluded for non-finite values").inc(
                            int(bad.sum()))
        for k in np.flatnonzero(bad):
            self._strikes[k] += 1
            injected = bool(rf is not None and rf.nan_upload[k])
            tele.fault("nan_upload", injected=injected, device=int(k),
                       strikes=int(self._strikes[k]))
            if self._strikes[k] >= res.quarantine_threshold:
                until = i + 1 + res.quarantine_rounds
                self._quarantined_until[k] = until
                self._strikes[k] = 0
                tele.fault("quarantine", injected=False, device=int(k),
                           until_round=int(until))
                if reg.enabled:
                    reg.counter("feel_quarantines_total",
                                "devices quarantined for repeated "
                                "non-finite uploads").inc()
        # each clean upload decays one strike
        self._strikes[clean] = np.maximum(self._strikes[clean] - 1, 0)
        return surv & finite, int(bad.sum())

    def _resolve_for_survivors(self, state: RoundState, surv: torch.Tensor,
                               dec, tele):
        """Dropout policy "resolve": re-solve the RB assignment for the
        surviving devices with the closed-form evaluator, so energy and
        cost accounting match who uploaded.  Keeps the original decision
        (reweight only) if the re-solve itself fails."""
        sys = self.sys
        try:
            match2 = joint_mod.matching_mod.swap_matching(
                sys, state.h, surv, evaluator="closed_form",
                mode=self.cfg.matching_mode, telemetry=tele)
        except Exception as e:  # keep the round alive
            tele.fault("solver_fail", injected=False, solver="matching",
                       reason=type(e).__name__, context="resolve")
            return dec
        tele.fault("fallback", injected=False, solver="matching",
                   to="resolve_survivors")
        joint_mod._count_fallback("matching", "resolve_survivors")
        return joint_mod._finish(
            sys, match2.rho, match2.p, dec.delta, state,
            feasible=match2.feasible, swaps=dec.swaps,
            unmatched=match2.unmatched, delta_cont=dec.delta_cont,
            fallbacks=dec.fallbacks + ("resolve_survivors",),
            telemetry=tele)

    # ------------------------------------------------------------------
    # crash-safe checkpoint / resume, in the reference's format
    # ------------------------------------------------------------------
    def _checkpoint_tree(self) -> dict:
        """Params and optimizer state in the reference's pytree layout,
        under its keys (a NamedTuple field ``f`` flattens to ``.f``):
        sgd has no state leaf; momentum's is a params-shaped tree;
        adam's ``.count/.mu/.nu``; adafactor's ``.count/.vr/.vc``, the
        factored moments already on the reference's axes (a 0-d ``vc``
        for a leaf under 2-D)."""
        st, opt = self.opt_state, self.cfg.optimizer
        if opt == "sgd":
            state = {}
        elif opt == "momentum":
            state = cnn_mod.params_to_numpy(st)
        elif opt == "adam":
            state = {".count": np.asarray(st.count, np.int32),
                     ".mu": cnn_mod.params_to_numpy(st.mu),
                     ".nu": cnn_mod.params_to_numpy(st.nu)}
        else:
            def host(named):
                return cnn_mod.nest({n: t.cpu().numpy()
                                     for n, t in named.items()})

            state = {".count": np.asarray(st.count, np.int32),
                     ".vr": host(st.vr), ".vc": host(st.vc)}
        return {"params": cnn_mod.params_to_numpy(self.params),
                "opt_state": state}

    def _named(self, layers: dict) -> Dict[str, torch.Tensor]:
        """A loaded params-shaped tree in the reference's layout -> this
        trainer's named tensors on its device."""
        arrays = {layer: {k: v.numpy() for k, v in leaves.items()}
                  for layer, leaves in layers.items()}
        return {n: t.to(self.device)
                for n, t in cnn_mod.params_from_numpy(arrays).items()}

    def _opt_state_from(self, tree: dict):
        """The inverse of ``_checkpoint_tree``'s ``opt_state`` (a loaded
        tree of CPU tensors), on the trainer's device."""
        opt = self.cfg.optimizer
        if opt == "sgd":
            return ()
        if opt == "momentum":
            return self._named(tree)
        if opt == "adam":
            return optim.AdamState(count=int(tree[".count"]),
                                   mu=self._named(tree[".mu"]),
                                   nu=self._named(tree[".nu"]))
        # adafactor's moments are stored on the reference's axes, as held
        return optim.AdafactorState(
            count=int(tree[".count"]),
            **{f: {n: t.to(self.device)
                   for n, t in cnn_mod.unnest(tree[f".{f}"]).items()}
               for f in ("vr", "vc")})

    def _checkpoint_dir(self) -> str:
        if not self._res.checkpoint_dir:
            raise ValueError("no checkpoint path: pass one or set "
                             "ResilienceConfig.checkpoint_dir")
        return self._res.checkpoint_dir

    def save_checkpoint(self, path: Optional[str] = None,
                        next_round: int = 0) -> str:
        """Atomically persist everything ``resume`` needs to reproduce
        the uninterrupted trajectory bit for bit (on the GPU under
        ``torch.backends.cudnn.deterministic``): params, optimizer state,
        both random streams, the round index, cumulative cost and the
        quarantine bookkeeping.  The reference's ``meta`` keys mean what
        they mean there; ``jax_key`` is null (the port draws h and alpha
        from its generator, stored under ``GEN_STATE_KEY``)."""
        if path is None:
            path = os.path.join(self._checkpoint_dir(), CKPT_NAME)
        gen_state = self.gen.get_state().numpy().tobytes()
        meta = {
            "next_round": int(next_round),
            "cum_net_cost": float(self._cum),
            "rng_state": self.rng.bit_generator.state,
            "jax_key": None,
            "strikes": [int(v) for v in self._strikes],
            "quarantined_until": [int(v) for v in self._quarantined_until],
            "seed": int(self.cfg.seed),
            "fault_spec": (self.faults.to_dict()
                           if self.faults is not None else None),
            GEN_STATE_KEY: base64.b64encode(gen_state).decode("ascii"),
        }
        ckpt_mod.save_pytree(path, self._checkpoint_tree(), metadata=meta)
        return path

    def resume(self, path: Optional[str] = None) -> int:
        """Restore a checkpoint and return the round to continue from
        (``run`` picks it up).  Reads the port's checkpoints and the
        reference's (of the same optimizer): params, optimizer state,
        the numpy data stream, cost,
        quarantine state and round.  A reference checkpoint carries a
        JAX key, not this trainer's generator state, so it resumes only
        where the generator draws nothing: with a ``channel_source`` and
        a scheme other than baselines 1 and 2; otherwise this raises."""
        if path is None:
            path = self._checkpoint_dir()
        if os.path.isdir(path):
            path = os.path.join(path, CKPT_NAME)
        meta = ckpt_mod.load_metadata(path)
        if meta is None:
            raise FileNotFoundError(f"{path}.meta.json missing: cannot "
                                    "resume without trainer metadata")
        gen_state = meta.get(GEN_STATE_KEY)
        if gen_state is None and (self.channel_source is None or
                                  self.cfg.scheme in ("baseline1",
                                                      "baseline2")):
            raise ValueError(
                f"{path} holds no torch generator state (a JAX checkpoint "
                "holds a JAX key, which cannot become one): resume it with "
                "a channel_source and a scheme that draws nothing else")
        tree = ckpt_mod.load_pytree(path, self._checkpoint_tree())
        with torch.no_grad():
            for name, value in self._named(tree["params"]).items():
                self.params[name].copy_(value)
        self.opt_state = self._opt_state_from(tree["opt_state"])
        self._cum = float(meta["cum_net_cost"])
        rng = np.random.default_rng()
        rng.bit_generator.state = meta["rng_state"]
        self.rng = rng
        if gen_state is not None:
            self.gen.set_state(torch.from_numpy(np.frombuffer(
                base64.b64decode(gen_state), np.uint8).copy()))
        self._strikes = np.asarray(meta["strikes"], np.int64)
        self._quarantined_until = np.asarray(meta["quarantined_until"],
                                             np.int64)
        self._start_round = int(meta["next_round"])
        self.obs.fault("resume", injected=False, path=path,
                       next_round=self._start_round)
        return self._start_round

    def run(self, rounds: int, verbose: bool = False) -> List[RoundMetrics]:
        """Run rounds ``[start, rounds)``; ``start`` is 0 for a fresh
        trainer or the restored round after ``resume()``."""
        out = []
        for i in range(self._start_round, rounds):
            eval_now = (i % self.cfg.eval_every == 0) or i == rounds - 1
            m = self.run_round(i, eval_now=eval_now)
            out.append(m)
            if verbose and eval_now:
                print(f"round {i:4d} acc={m.test_acc} "
                      f"cum_cost={m.cum_net_cost:.4f} sel={m.n_selected} "
                      f"bad_frac={m.frac_mislabeled_selected:.3f}")
        return out


def _build_optimizer(cfg: FEELConfig, params: Dict[str, torch.Tensor]
                     ) -> optim.GradientTransformation:
    """``cfg.optimizer`` at ``cfg.lr`` with its defaults, as the
    reference builds it; adafactor factors each CNN weight on the
    reference's axes (``cnn.reference_layout``), so its moments and its
    update are the reference's."""
    if cfg.optimizer == "adafactor":
        return optim.adafactor(cfg.lr,
                               layout=cnn_mod.reference_layout(params))
    return {"adam": optim.adam, "sgd": optim.sgd,
            "momentum": optim.momentum}[cfg.optimizer](cfg.lr)
