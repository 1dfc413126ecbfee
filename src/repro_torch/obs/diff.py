"""Explain why two traces differ.

    PYTHONPATH=src python -m repro_torch.obs diff base.jsonl head.jsonl

Two runs of the same workload rarely differ uniformly — a regression
lives in *one* solver, *one* stage, *one* device.  ``diff`` therefore
attributes deltas to the deepest responsible owner rather than to
aggregates:

* **wall-clock** — per span path (``round/power/power.ccp_iter``),
  using *self* time (span duration minus child durations) so a slow
  leaf is named instead of every ancestor that contains it;
* **energy** — the eq. 16-18 per-device terms, so one hot device shows
  up by index instead of disappearing into the fleet sum;
* **solver counters** — swaps, sweeps, CCP iterations, GP steps,
  infeasible calls (deterministic per seed: growth = more work);
* **faults** — per kind (and per ``solver->target`` for fallbacks);
  a fallback that fires in one trace but not the other is *the*
  explanation and outranks timing noise in the headline.

``benchmarks/regress.py`` points at this tool when its gate trips.

Counterpart of ``repro/obs/diff.py``, copied.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Tuple

from . import events as ev
from . import spans as spans_mod
from . import summary as summary_mod


def _records(trace: Iterable[Any]) -> List[Dict[str, Any]]:
    return [r.to_record() if hasattr(r, "to_record") else r for r in trace]


def _fault_key(e: ev.FaultEvent) -> str:
    d = e.detail or {}
    if "solver" in d and "to" in d:
        return f"{e.kind}[{d['solver']}->{d['to']}]"
    if "solver" in d:
        return f"{e.kind}[{d['solver']}]"
    return e.kind


def _fault_counts(records: List[Dict[str, Any]]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for r in records:
        e = ev.parse_record(r)
        if isinstance(e, ev.FaultEvent):
            k = _fault_key(e)
            out[k] = out.get(k, 0) + 1
    return out


def _device_energy(records: List[Dict[str, Any]]
                   ) -> Dict[int, Tuple[float, float]]:
    """Per-device (E^cmp, E^com) summed over rounds."""
    out: Dict[int, Tuple[float, float]] = {}
    for r in records:
        e = ev.parse_record(r)
        if isinstance(e, ev.DeviceEvent):
            for k, (cmp_j, com_j) in enumerate(zip(e.energy_cmp_j,
                                                   e.energy_com_j)):
                a, b = out.get(k, (0.0, 0.0))
                out[k] = (a + cmp_j, b + com_j)
    return out


@dataclasses.dataclass
class TraceDiff:
    """Structured base-vs-head comparison; ``render()`` prints it."""

    base_rounds: int
    head_rounds: int
    base_wall_s: float
    head_wall_s: float
    #: (path, base_s, head_s) sorted by |delta| descending.
    wall_by_path: List[Tuple[str, float, float]]
    #: (device, base_J, head_J) total energy, by |delta| descending.
    energy_by_device: List[Tuple[int, float, float]]
    #: (solver.counter, base, head) numeric counters that changed.
    counters: List[Tuple[str, float, float]]
    #: (fault key, base count, head count) where counts differ.
    faults: List[Tuple[str, int, int]]

    def headline(self) -> str:
        """The single most significant difference.  Structural changes
        (fault/fallback counts) outrank wall-clock, which is noisy."""
        if self.faults:
            key, b, h = self.faults[0]
            return (f"fault activity changed: {key} {b} -> {h} "
                    f"({h - b:+d})")
        if self.wall_by_path:
            path, b, h = self.wall_by_path[0]
            return f"largest wall-clock delta: {path} ({h - b:+.4f}s)"
        if self.counters:
            name, b, h = self.counters[0]
            return f"largest counter delta: {name} {b:g} -> {h:g}"
        return "traces are equivalent under every diff dimension"

    def render(self, top: int = 8) -> str:
        lines = []
        dw = self.head_wall_s - self.base_wall_s
        pct = (f" ({dw / self.base_wall_s:+.1%})"
               if self.base_wall_s > 0 else "")
        lines.append(f"rounds: {self.base_rounds} -> {self.head_rounds}; "
                     f"round wall-clock: {self.base_wall_s:.4f}s -> "
                     f"{self.head_wall_s:.4f}s ({dw:+.4f}s{pct})")
        if self.faults:
            lines.append("fault/fallback deltas:")
            for key, b, h in self.faults[:top]:
                lines.append(f"  {h - b:+4d}  {key}  ({b} -> {h})")
        if self.wall_by_path:
            lines.append("wall-clock contributors (self time by span "
                         "path, largest first):")
            for path, b, h in self.wall_by_path[:top]:
                lines.append(f"  {h - b:+.4f}s  {path}  "
                             f"({b:.4f}s -> {h:.4f}s)")
        if self.counters:
            lines.append("solver counter deltas:")
            for name, b, h in self.counters[:top]:
                lines.append(f"  {h - b:+g}  {name}  ({b:g} -> {h:g})")
        if self.energy_by_device:
            lines.append("energy contributors (per device, E^cmp+E^com):")
            for k, b, h in self.energy_by_device[:top]:
                lines.append(f"  {h - b:+.3e}J  device {k}  "
                             f"({b:.3e}J -> {h:.3e}J)")
        lines.append(f"headline: {self.headline()}")
        return "\n".join(lines)


def diff_traces(base: Iterable[Any], head: Iterable[Any],
                min_wall_delta_s: float = 1e-4) -> TraceDiff:
    """Compare two traces (raw records or live events)."""
    base_r, head_r = _records(base), _records(head)
    sb = summary_mod.summarize(base_r)
    sh = summary_mod.summarize(head_r)

    # wall-clock per deepest responsible span path
    wb = spans_mod.self_seconds_by_path(base_r)
    wh = spans_mod.self_seconds_by_path(head_r)
    wall = [(p, wb.get(p, 0.0), wh.get(p, 0.0))
            for p in sorted(set(wb) | set(wh))]
    wall = [(p, b, h) for p, b, h in wall
            if abs(h - b) >= min_wall_delta_s]
    wall.sort(key=lambda t: -abs(t[2] - t[1]))

    # per-device energy totals
    eb, eh = _device_energy(base_r), _device_energy(head_r)
    energy = []
    for k in sorted(set(eb) | set(eh)):
        b = sum(eb.get(k, (0.0, 0.0)))
        h = sum(eh.get(k, (0.0, 0.0)))
        if b != h:
            energy.append((k, b, h))
    energy.sort(key=lambda t: -abs(t[2] - t[1]))

    # solver counters (numeric only; strings like method= are skipped)
    counters = []
    for solver in sorted(set(sb.solvers) | set(sh.solvers)):
        cb = sb.solvers.get(solver, {})
        ch = sh.solvers.get(solver, {})
        for key in sorted(set(cb) | set(ch)):
            b, h = cb.get(key, 0), ch.get(key, 0)
            if not (isinstance(b, (int, float))
                    and isinstance(h, (int, float))):
                continue
            if float(b) != float(h):
                counters.append((f"{solver}.{key}", float(b), float(h)))
    counters.sort(key=lambda t: -abs(t[2] - t[1]))

    # faults by key
    fb, fh = _fault_counts(base_r), _fault_counts(head_r)
    faults = [(k, fb.get(k, 0), fh.get(k, 0))
              for k in sorted(set(fb) | set(fh))
              if fb.get(k, 0) != fh.get(k, 0)]
    faults.sort(key=lambda t: -abs(t[2] - t[1]))

    return TraceDiff(base_rounds=sb.n_rounds, head_rounds=sh.n_rounds,
                     base_wall_s=sb.total_wall_s,
                     head_wall_s=sh.total_wall_s,
                     wall_by_path=wall, energy_by_device=energy,
                     counters=counters, faults=faults)


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs diff",
        description="attribute wall-clock/energy/counter deltas between "
                    "two JSONL traces to the deepest responsible spans")
    ap.add_argument("base", help="baseline JSONL trace")
    ap.add_argument("head", help="candidate JSONL trace")
    ap.add_argument("--top", type=int, default=8,
                    help="rows per section (default 8)")
    args = ap.parse_args(argv)
    d = diff_traces(summary_mod.load_trace(args.base),
                    summary_mod.load_trace(args.head))
    print(f"trace diff: {args.base} -> {args.head}")
    print(d.render(top=args.top))


if __name__ == "__main__":
    main()
