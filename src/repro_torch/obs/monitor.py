"""Live convergence monitoring against the paper's analytical bounds.

The paper's contribution is an *analytical* handle on training
efficiency: Lemma 2 upper-bounds the next round's optimality gap from
this round's gap, gradient norm and data-selection Delta term; Lemma 3
chains those one-round bounds into a trajectory.  ``ConvergenceMonitor``
turns the bounds into runtime checks: feed it one observation per round
and it raises structured warnings — emitted as ``MonitorEvent``
telemetry records and ``feel_monitor_violations_total`` metrics — when

* ``bound_violation`` — the observed gap exceeds the Lemma-2 bound
  predicted from the *previous* round's observation (beyond a relative
  tolerance; the bound holds in expectation, so a single stochastic
  round may legitimately wiggle past it — tune ``bound_rtol``);
* ``gap_divergence`` — the gap increased monotonically over the last
  ``divergence_window`` rounds (training is going backwards);
* ``straggler`` — a round (or a stage, when stage timings are fed in)
  took more than ``straggler_factor`` x the running median.

The gap observation may be any consistent loss proxy: Lemma 2 is
invariant to the unknown L* offset (it appears identically on both
sides), so ``FEELTrainer`` feeds the mean training loss on the round's
batch.  ``eta`` should be the step size (exact for SGD; for Adam the
configured learning rate is a proxy and a larger ``bound_rtol`` is
appropriate).

Disabled is the default: ``FEELTrainer(..., monitor=None)`` skips every
monitor code path, keeping round outputs bit-for-bit identical.

Counterpart of ``repro/obs/monitor.py``, copied; the bounds come from
the port's ``core/convergence.py``.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Any, Dict, List, Optional

from ..core import convergence as conv_mod
from . import events as ev
from . import metrics as metrics_mod
from . import trace as trace_mod

#: MonitorEvent kinds, in the order the checks run.
VIOLATION_KINDS = ("bound_violation", "gap_divergence", "straggler")


@dataclasses.dataclass
class MonitorConfig:
    """Knobs for the three checks (see module docstring)."""

    beta: float = 1.0              # smoothness constant of Lemma 2
    mu: float = 0.0                # strong-convexity; >0 enables Lemma 3
    bound_rtol: float = 0.10       # slack on the one-round bound
    bound_atol: float = 1e-9
    divergence_window: int = 5     # consecutive increases => divergence
    straggler_factor: float = 3.0  # x median => straggler
    straggler_min_history: int = 5


@dataclasses.dataclass
class Violation:
    """One raised warning (also emitted as a ``MonitorEvent``)."""

    kind: str
    round: int
    value: float
    threshold: float
    detail: Dict[str, Any]


class ConvergenceMonitor:
    """Consumes per-round observations; raises structured warnings.

    Parameters
    ----------
    sys:
        the ``SystemParams`` whose ``D_hat_total`` scales the Lemma-2
        Delta term.
    config:
        a ``MonitorConfig``; ``None`` uses the defaults.
    telemetry:
        sink for ``MonitorEvent`` records; ``None`` resolves to the
        process default (no-op unless one is installed).
    registry:
        metrics registry for violation counters / bound-ratio gauges;
        ``None`` resolves to the process default.
    """

    def __init__(self, sys, config: Optional[MonitorConfig] = None,
                 telemetry=None, registry=None):
        self.sys = sys
        self.cfg = config or MonitorConfig()
        self._tele = trace_mod.resolve(telemetry)
        self._reg = metrics_mod.resolve(registry)
        self.violations: List[Violation] = []
        self.gaps: List[float] = []            # observed gap per round
        self.bounds: List[Optional[float]] = []  # Lemma-2 bound for that round
        self.multi_bounds: List[float] = []    # Lemma-3 trajectory (mu>0)
        self._next_bound: Optional[float] = None
        self._etas: List[float] = []
        self._deltas: List[float] = []
        self._walls: List[float] = []
        self._stage_hist: Dict[str, List[float]] = {}
        self._diverging = False

    # ------------------------------------------------------------------
    def observe_round(self, round: int, gap: float, g_norm_sq: float,
                      eta: float, delta_obj: float,
                      wall_s: Optional[float] = None,
                      stage_s: Optional[Dict[str, float]] = None
                      ) -> List[Violation]:
        """Feed one round's observations; returns new violations.

        ``gap``: loss proxy for L(w_i) - L* (offset-invariant);
        ``g_norm_sq``: ||g_hat_i||^2; ``eta``: step size;
        ``delta_obj``: the round decision's Delta term (eq. 26);
        ``wall_s``/``stage_s``: optional timings for straggler checks.
        """
        cfg = self.cfg
        out: List[Violation] = []

        # -- Lemma 2: gap vs the bound predicted last round -------------
        bound = self._next_bound
        self.gaps.append(float(gap))
        self.bounds.append(bound)
        if bound is not None:
            thr = bound + abs(bound) * cfg.bound_rtol + cfg.bound_atol
            if gap > thr:
                out.append(self._raise(
                    "bound_violation", round, float(gap), float(thr),
                    {"bound": float(bound), "rtol": cfg.bound_rtol}))
        self._next_bound = float(conv_mod.one_round_bound_from_delta(
            self.sys, gap, g_norm_sq, eta, cfg.beta, delta_obj))

        # -- Lemma 3 trajectory (optional) ------------------------------
        self._etas.append(float(eta))
        self._deltas.append(float(delta_obj))
        if cfg.mu > 0.0:
            self.multi_bounds.append(conv_mod.multi_round_bound(
                self.sys, self.gaps[0], cfg.mu, cfg.beta, self._etas,
                self._deltas))

        # -- divergence: monotone increase over the window --------------
        w = cfg.divergence_window
        if len(self.gaps) > w:
            tail = self.gaps[-(w + 1):]
            rising = all(b > a for a, b in zip(tail, tail[1:]))
            if rising and not self._diverging:
                out.append(self._raise(
                    "gap_divergence", round, float(gap), float(tail[0]),
                    {"window": w, "gap_start": float(tail[0])}))
            self._diverging = rising

        # -- stragglers -------------------------------------------------
        if wall_s is not None:
            v = self._straggler_check(round, "round", wall_s, self._walls)
            if v is not None:
                out.append(v)
            self._walls.append(float(wall_s))
        for stage, dur in (stage_s or {}).items():
            hist = self._stage_hist.setdefault(stage, [])
            v = self._straggler_check(round, stage, dur, hist)
            if v is not None:
                out.append(v)
            hist.append(float(dur))
        return out

    def _straggler_check(self, round: int, what: str, dur: float,
                         hist: List[float]) -> Optional[Violation]:
        cfg = self.cfg
        if len(hist) < cfg.straggler_min_history:
            return None
        med = statistics.median(hist)
        thr = cfg.straggler_factor * med
        if dur > thr:
            return self._raise("straggler", round, float(dur), float(thr),
                               {"what": what, "median_s": float(med),
                                "factor": cfg.straggler_factor})
        return None

    def _raise(self, kind: str, round: int, value: float, threshold: float,
               detail: Dict[str, Any]) -> Violation:
        v = Violation(kind=kind, round=round, value=value,
                      threshold=threshold, detail=detail)
        self.violations.append(v)
        self._tele.emit(ev.MonitorEvent(kind=kind, value=value,
                                        threshold=threshold, round=round,
                                        detail=detail))
        if self._reg.enabled:
            self._reg.counter(
                "feel_monitor_violations_total",
                "convergence-monitor warnings by kind").inc(1, kind=kind)
            if kind == "bound_violation":
                self._reg.gauge(
                    "feel_monitor_bound_gap_ratio",
                    "last observed gap / Lemma-2 bound").set(
                        value / threshold if threshold else float("inf"))
        return v

    # ------------------------------------------------------------------
    def bound_gap_ratio(self) -> Optional[float]:
        """max over rounds of observed gap / predicted Lemma-2 bound
        (<= 1 + rtol means the theory tracked reality); ``None`` until
        two rounds have been observed."""
        ratios = [g / b for g, b in zip(self.gaps, self.bounds)
                  if b is not None and b > 0.0]
        return max(ratios) if ratios else None

    def counts(self) -> Dict[str, int]:
        out = {k: 0 for k in VIOLATION_KINDS}
        for v in self.violations:
            out[v.kind] = out.get(v.kind, 0) + 1
        return out

    def summary(self) -> Dict[str, Any]:
        """JSON-safe roll-up."""
        return {"rounds": len(self.gaps),
                "violations": self.counts(),
                "bound_gap_ratio": self.bound_gap_ratio(),
                "final_gap": self.gaps[-1] if self.gaps else None,
                "final_bound": self._next_bound}
