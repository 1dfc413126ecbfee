"""Roll a telemetry trace up into the ``name,us_per_call,derived`` CSV
shape that ``benchmarks/common.emit`` already prints.

    PYTHONPATH=src python -m repro_torch.obs trace.jsonl

Aggregation rules
-----------------
* one ``telemetry.stage.<name>`` row per stage: mean us per call,
  ``derived`` carries call count, total seconds and the stage's share
  of total recorded round wall-clock;
* one ``telemetry.solver.<name>`` row per solver with summed/averaged
  counters (swaps, sweeps, CCP iterations, GP steps, infeasible calls);
* a ``telemetry.round`` row: mean round wall-clock, round count,
  infeasible-round count, and ``coverage`` = (sum of stage durations) /
  (sum of round wall-clock) — how much of each round the stages
  explain;
* a ``telemetry.device`` row: mean per-round totals of the eq. (16)-(18)
  energy/cost terms and selected/uploaded counts;
* one ``telemetry.roofline.<stage>`` row per profiled stage (schema v2
  ``profile`` events joined against that stage's mean wall-clock):
  FLOPs/bytes per call, achieved GFLOP/s and achieved/peak
  utilization;
* a ``telemetry.monitor`` row when the convergence monitor raised any
  warnings: violation counts by kind;
* a ``telemetry.faults`` row when the trace carries any schema-v3
  ``fault`` events: counts by kind plus the injected-fault total.

Counterpart of ``repro/obs/summary.py``, copied.
"""
from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Any, Dict, Iterable, List, Optional, Tuple

from . import events as ev


def load_trace(path: str, strict: bool = False) -> List[Dict[str, Any]]:
    """Read a JSONL trace into a list of record dicts (header included).

    A process that dies mid-``_write`` leaves a truncated final line;
    that is expected crash debris, so the default skips it with a
    warning (``strict=True`` restores the raise).  A malformed line
    anywhere *else* still raises — that is corruption, not truncation.
    """
    with open(path) as f:
        lines = f.readlines()
    out = []
    last = len(lines) - 1
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            if i == last and not strict:
                warnings.warn(f"{path}: skipping truncated final trace "
                              f"line ({line[:40]!r}...)")
                continue
            raise
    return out


def _records(trace: Iterable[Any]) -> List[Dict[str, Any]]:
    """Accept raw dicts (from JSONL) or event objects (from a live
    ``Telemetry.events`` list) interchangeably."""
    return [r.to_record() if hasattr(r, "to_record") else r for r in trace]


@dataclasses.dataclass
class StageStats:
    calls: int = 0
    total_s: float = 0.0

    @property
    def mean_us(self) -> float:
        return self.total_s / max(self.calls, 1) * 1e6


@dataclasses.dataclass
class TraceSummary:
    stages: Dict[str, StageStats]
    solvers: Dict[str, Dict[str, float]]   # solver -> aggregated counters
    n_rounds: int
    total_wall_s: float
    infeasible_rounds: int
    coverage: Optional[float]              # stage time / round wall time
    device_totals: Dict[str, float]        # mean per-round sums over k
    profiles: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)              # kernel name -> roofline record
    monitor_counts: Dict[str, int] = dataclasses.field(
        default_factory=dict)              # violation kind -> count
    fault_counts: Dict[str, int] = dataclasses.field(
        default_factory=dict)              # fault kind -> count (v3)
    faults_injected: int = 0               # of which FaultPlan-injected
    last_metrics: Optional[List[Dict[str, Any]]] = None  # last snapshot

    def stage_seconds(self) -> float:
        return sum(s.total_s for s in self.stages.values())

    def roofline(self) -> Dict[str, Dict[str, float]]:
        """Join profiles against stage timings: per profiled stage, the
        per-call FLOPs/bytes and achieved-vs-peak utilization."""
        out: Dict[str, Dict[str, float]] = {}
        for prof in self.profiles.values():
            stage = prof.get("stage")
            st = self.stages.get(stage) if stage else None
            if st is None or st.calls == 0 or st.total_s <= 0.0:
                continue
            per_call_s = st.total_s / st.calls
            achieved = prof["flops"] / per_call_s
            peak = prof.get("peak_flops") or 0.0
            out[stage] = {
                "kernel": prof["name"],
                "flops": prof["flops"],
                "bytes_accessed": prof["bytes_accessed"],
                "per_call_s": per_call_s,
                "achieved_flops_per_s": achieved,
                "peak_flops": peak,
                "utilization": achieved / peak if peak > 0 else 0.0,
            }
        return out


def summarize(trace: Iterable[Any]) -> TraceSummary:
    records = _records(trace)
    stages: Dict[str, StageStats] = {}
    solver_counts: Dict[str, Dict[str, float]] = {}
    solver_calls: Dict[str, int] = {}
    n_rounds = 0
    total_wall = 0.0
    infeasible = 0
    dev_totals: Dict[str, float] = {}
    dev_rounds = 0
    profiles: Dict[str, Dict[str, float]] = {}
    monitor_counts: Dict[str, int] = {}
    fault_counts: Dict[str, int] = {}
    faults_injected = 0
    last_metrics: Optional[List[Dict[str, Any]]] = None

    for r in records:
        e = ev.parse_record(r)
        if isinstance(e, ev.StageEvent):
            s = stages.setdefault(e.stage, StageStats())
            s.calls += 1
            s.total_s += e.dur_s
        elif isinstance(e, ev.SolverEvent):
            agg = solver_counts.setdefault(e.solver, {})
            solver_calls[e.solver] = solver_calls.get(e.solver, 0) + 1
            for k, v in e.counters.items():
                if k == "feasible":
                    # feasibility flags aggregate as a failure count
                    agg["infeasible"] = agg.get("infeasible", 0) + (not v)
                elif isinstance(v, (bool, int, float)):
                    agg[k] = agg.get(k, 0) + v
                else:
                    agg[k] = v  # strings (e.g. method=) keep last value
        elif isinstance(e, ev.RoundEvent):
            n_rounds += 1
            total_wall += e.wall_s
            if not e.feasible:
                infeasible += 1
        elif isinstance(e, ev.DeviceEvent):
            dev_rounds += 1
            for k in ("energy_cmp_j", "energy_com_j", "cost", "reward",
                      "selected", "uploaded"):
                dev_totals[k] = dev_totals.get(k, 0.0) + float(
                    sum(getattr(e, k)))
        elif isinstance(e, ev.ProfileEvent):
            profiles[e.name] = {"name": e.name, "stage": e.stage,
                                "flops": e.flops,
                                "bytes_accessed": e.bytes_accessed,
                                "peak_flops": e.peak_flops}
        elif isinstance(e, ev.MonitorEvent):
            monitor_counts[e.kind] = monitor_counts.get(e.kind, 0) + 1
        elif isinstance(e, ev.FaultEvent):
            fault_counts[e.kind] = fault_counts.get(e.kind, 0) + 1
            faults_injected += int(bool(e.injected))
        elif isinstance(e, ev.MetricsEvent):
            last_metrics = e.families  # counters are cumulative: last wins

    # normalize solver counters to per-call means where that reads better
    solvers: Dict[str, Dict[str, float]] = {}
    for name, agg in solver_counts.items():
        out = dict(agg)
        out["calls"] = solver_calls[name]
        solvers[name] = out

    coverage = None
    if total_wall > 0:
        stage_s = sum(s.total_s for s in stages.values())
        coverage = stage_s / total_wall

    if dev_rounds:
        dev_totals = {k: v / dev_rounds for k, v in dev_totals.items()}

    return TraceSummary(stages=stages, solvers=solvers, n_rounds=n_rounds,
                        total_wall_s=total_wall,
                        infeasible_rounds=infeasible, coverage=coverage,
                        device_totals=dev_totals, profiles=profiles,
                        monitor_counts=monitor_counts,
                        fault_counts=fault_counts,
                        faults_injected=faults_injected,
                        last_metrics=last_metrics)


def rows(summary: TraceSummary) -> List[Tuple[str, float, str]]:
    """CSV rows ``(name, us_per_call, derived)`` for ``common.emit``."""
    out: List[Tuple[str, float, str]] = []
    stage_s = summary.stage_seconds()
    for name in sorted(summary.stages,
                       key=lambda n: -summary.stages[n].total_s):
        s = summary.stages[name]
        share = s.total_s / stage_s if stage_s > 0 else 0.0
        out.append((f"telemetry.stage.{name}", s.mean_us,
                    f"calls={s.calls};total_s={s.total_s:.4f};"
                    f"share={share:.3f}"))
    for name in sorted(summary.solvers):
        agg = summary.solvers[name]
        calls = agg.get("calls", 0)
        parts = [f"{k}={agg[k]:g}" if isinstance(agg[k], (int, float))
                 else f"{k}={agg[k]}" for k in sorted(agg) if k != "calls"]
        out.append((f"telemetry.solver.{name}", 0.0,
                    f"calls={calls};" + ";".join(parts)))
    if summary.n_rounds:
        mean_us = summary.total_wall_s / summary.n_rounds * 1e6
        cov = ("" if summary.coverage is None
               else f";coverage={summary.coverage:.3f}")
        out.append(("telemetry.round", mean_us,
                    f"rounds={summary.n_rounds};"
                    f"infeasible={summary.infeasible_rounds}" + cov))
    if summary.device_totals:
        d = summary.device_totals
        out.append(("telemetry.device", 0.0,
                    f"energy_cmp_j={d.get('energy_cmp_j', 0):.3e};"
                    f"energy_com_j={d.get('energy_com_j', 0):.3e};"
                    f"cost={d.get('cost', 0):.4f};"
                    f"reward={d.get('reward', 0):.4f};"
                    f"selected={d.get('selected', 0):.1f};"
                    f"uploaded={d.get('uploaded', 0):.1f}"))
    for stage, r in sorted(summary.roofline().items()):
        out.append((f"telemetry.roofline.{stage}", r["per_call_s"] * 1e6,
                    f"kernel={r['kernel']};flops={r['flops']:.3e};"
                    f"bytes={r['bytes_accessed']:.3e};"
                    f"achieved_gflops={r['achieved_flops_per_s'] / 1e9:.2f};"
                    f"util={r['utilization']:.4f}"))
    if summary.monitor_counts:
        parts = ";".join(f"{k}={v}" for k, v in
                         sorted(summary.monitor_counts.items()))
        out.append(("telemetry.monitor", 0.0, parts))
    if summary.fault_counts:
        parts = ";".join(f"{k}={v}" for k, v in
                         sorted(summary.fault_counts.items()))
        out.append(("telemetry.faults", 0.0,
                    f"injected={summary.faults_injected};" + parts))
    return out


def emit(summary: TraceSummary, emit_fn=None) -> None:
    """Print the summary through ``benchmarks/common.emit`` (or any
    compatible ``(name, us, derived)`` printer)."""
    if emit_fn is None:
        def emit_fn(name, us, derived):
            print(f"{name},{us:.1f},{derived}")
    for name, us, derived in rows(summary):
        emit_fn(name, us, derived)


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="JSONL trace file")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    emit(summarize(load_trace(args.trace)))


if __name__ == "__main__":
    main()
