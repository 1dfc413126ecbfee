"""Self-contained HTML dashboard for one telemetry trace.

    PYTHONPATH=src python -m repro_torch.obs dash trace.jsonl -o report.html

One file, zero dependencies, zero external resources: every chart is
inline SVG, the palette lives in a ``<style>`` block (light + dark via
``prefers-color-scheme``), and hover detail rides on native SVG
``<title>`` tooltips.  Sections, in order:

* stat tiles — rounds, wall-clock, final cumulative net cost (eq. 18),
  fault and fallback counts;
* **round timeline** — per-round stacked stage seconds (the eq. 8/16
  latency story: where each round's wall-clock went), with fault
  markers overlaid on the rounds they hit;
* **per-device energy** — E^cmp (eq. 9) + E^com (eq. 16) stacked per
  device, summed over the trace (the eq. 17/18 cost attribution);
* **convergence-bound gap** — the ``feel_monitor_bound_gap_ratio``
  gauge per round from the trace's metrics snapshots (≈1 means the run
  tracks Lemma 2), when a monitor was attached;
* **fault table** — counts by kind, injected vs observed.

Charts follow the repro dataviz conventions: categorical stage hues in
fixed slot order (extra stages fold into "other"), red reserved for
fault status, text in ink tokens rather than series colors.

Counterpart of ``repro/obs/dash.py``, copied.
"""
from __future__ import annotations

import html
from typing import Any, Dict, Iterable, List, Optional, Tuple

from . import events as ev

# validated categorical palette (repro dataviz reference instance);
# slot order is the CVD-safety mechanism — never cycle past the list.
_SERIES_LIGHT = ("#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4",
                 "#008300", "#4a3aa7")
_SERIES_DARK = ("#3987e5", "#d95926", "#199e70", "#c98500", "#d55181",
                "#008300", "#9085e9")
_OTHER = "var(--muted)"
#: status red, reserved for fault markers — never a stage series.
_FAULT = "var(--status-critical)"

_CSS = """
:root { color-scheme: light dark; }
body {
  margin: 0; padding: 24px; font: 14px/1.45 system-ui, sans-serif;
  background: var(--surface-1); color: var(--text-primary);
  --surface-1: #fcfcfb; --surface-2: #f0efec;
  --text-primary: #0b0b0b; --text-secondary: #52514e;
  --muted: #a8a69e; --grid: #e3e2dd; --status-critical: #e34948;
}
@media (prefers-color-scheme: dark) {
  body {
    --surface-1: #1a1a19; --surface-2: #262625;
    --text-primary: #ffffff; --text-secondary: #c3c2b7;
    --muted: #6e6d66; --grid: #33332f; --status-critical: #e66767;
  }
  .light-only { display: none; }
}
@media (prefers-color-scheme: light) { .dark-only { display: none; } }
h1 { font-size: 20px; margin: 0 0 4px; }
h2 { font-size: 15px; margin: 28px 0 8px; }
.sub { color: var(--text-secondary); margin: 0 0 18px; }
.tiles { display: flex; gap: 12px; flex-wrap: wrap; margin: 18px 0; }
.tile {
  background: var(--surface-2); border-radius: 8px;
  padding: 10px 16px; min-width: 110px;
}
.tile .v { font-size: 22px; font-weight: 600; }
.tile .l { color: var(--text-secondary); font-size: 12px; }
.legend { display: flex; gap: 14px; flex-wrap: wrap;
          color: var(--text-secondary); font-size: 12px;
          margin: 6px 0 2px; }
.legend span { display: inline-flex; align-items: center; gap: 5px; }
.sw { width: 10px; height: 10px; border-radius: 3px;
      display: inline-block; }
table { border-collapse: collapse; font-size: 13px; }
td, th { padding: 4px 12px 4px 0; text-align: left;
         border-bottom: 1px solid var(--grid); }
th { color: var(--text-secondary); font-weight: 500; }
svg text { fill: var(--text-secondary); font: 11px system-ui; }
.note { color: var(--text-secondary); font-size: 12px; }
"""


def _fmt(v: float) -> str:
    if v == 0:
        return "0"
    if abs(v) >= 1000 or abs(v) < 0.01:
        return f"{v:.2e}"
    return f"{v:.3g}"


def _series_css(i: int) -> str:
    return f"var(--series-{i + 1})"


def _series_vars() -> str:
    light = "".join(f"--series-{i + 1}: {c}; "
                    for i, c in enumerate(_SERIES_LIGHT))
    dark = "".join(f"--series-{i + 1}: {c}; "
                   for i, c in enumerate(_SERIES_DARK))
    return (f"body {{ {light}}}\n"
            f"@media (prefers-color-scheme: dark) {{ body {{ {dark}}} }}\n")


# ---------------------------------------------------------------------
# data extraction
# ---------------------------------------------------------------------

def _records(trace: Iterable[Any]) -> List[Dict[str, Any]]:
    return [r.to_record() if hasattr(r, "to_record") else r for r in trace]


def _collect(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    stages: Dict[int, Dict[str, float]] = {}
    rounds: Dict[int, ev.RoundEvent] = {}
    device_cmp: List[float] = []
    device_com: List[float] = []
    faults: Dict[int, List[ev.FaultEvent]] = {}
    fault_totals: Dict[str, List[int]] = {}
    gap_by_round: Dict[int, float] = {}
    meta: Dict[str, Any] = {}
    for r in records:
        if r.get("ev") == "header":
            meta = r.get("meta", {})
            continue
        e = ev.parse_record(r)
        if isinstance(e, ev.StageEvent) and e.round is not None:
            per = stages.setdefault(e.round, {})
            per[e.stage] = per.get(e.stage, 0.0) + e.dur_s
        elif isinstance(e, ev.RoundEvent):
            rounds[e.round] = e
        elif isinstance(e, ev.DeviceEvent):
            k = len(e.energy_cmp_j)
            if len(device_cmp) < k:
                device_cmp.extend([0.0] * (k - len(device_cmp)))
                device_com.extend([0.0] * (k - len(device_com)))
            for i in range(k):
                device_cmp[i] += e.energy_cmp_j[i]
                device_com[i] += e.energy_com_j[i]
        elif isinstance(e, ev.FaultEvent):
            if e.round is not None:
                faults.setdefault(e.round, []).append(e)
            tot = fault_totals.setdefault(e.kind, [0, 0])
            tot[0] += 1
            tot[1] += int(bool(e.injected))
        elif isinstance(e, ev.MetricsEvent) and e.round is not None:
            for fam in e.families:
                if fam.get("name") == "feel_monitor_bound_gap_ratio":
                    for s in fam.get("samples", []):
                        gap_by_round[e.round] = float(s["value"])
    return {"stages": stages, "rounds": rounds,
            "device_cmp": device_cmp, "device_com": device_com,
            "faults": faults, "fault_totals": fault_totals,
            "gap": gap_by_round, "meta": meta}


# ---------------------------------------------------------------------
# SVG builders
# ---------------------------------------------------------------------

def _stacked_rounds_svg(stages: Dict[int, Dict[str, float]],
                        faults: Dict[int, List[ev.FaultEvent]],
                        order: List[str]) -> str:
    rounds = sorted(stages)
    if not rounds:
        return "<p class='note'>no stage events in this trace</p>"
    w, h, left, bottom, top = 720, 220, 46, 24, 14
    plot_w, plot_h = w - left - 10, h - bottom - top
    max_s = max(sum(stages[r].values()) for r in rounds) or 1.0
    bar_w = min(40.0, plot_w / max(len(rounds), 1) * 0.72)
    step = plot_w / max(len(rounds), 1)
    parts = [f"<svg viewBox='0 0 {w} {h}' role='img' "
             f"aria-label='stacked stage seconds per round'>"]
    # y grid: 4 recessive lines + labels
    for i in range(5):
        y = top + plot_h * (1 - i / 4)
        val = max_s * i / 4
        parts.append(f"<line x1='{left}' y1='{y:.1f}' x2='{w - 10}' "
                     f"y2='{y:.1f}' stroke='var(--grid)' "
                     f"stroke-width='1'/>")
        parts.append(f"<text x='{left - 6}' y='{y + 4:.1f}' "
                     f"text-anchor='end'>{_fmt(val)}s</text>")
    fold = [s for s in order[len(_SERIES_LIGHT):]]
    for idx, rnd in enumerate(rounds):
        x = left + idx * step + (step - bar_w) / 2
        y = top + plot_h
        per = stages[rnd]
        segs: List[Tuple[str, float, str]] = []
        for i, name in enumerate(order[:len(_SERIES_LIGHT)]):
            if per.get(name):
                segs.append((name, per[name], _series_css(i)))
        other = sum(per.get(n, 0.0) for n in fold)
        if other > 0:
            segs.append(("other", other, _OTHER))
        for name, dur, color in segs:
            seg_h = dur / max_s * plot_h
            y -= seg_h
            title = html.escape(f"round {rnd} · {name}: {dur * 1e3:.2f}ms")
            parts.append(
                f"<rect x='{x:.1f}' y='{y:.1f}' width='{bar_w:.1f}' "
                f"height='{max(seg_h - 1, 0.5):.1f}' rx='1.5' "
                f"fill='{color}' stroke='var(--surface-1)' "
                f"stroke-width='1'><title>{title}</title></rect>")
        if rnd in faults:
            kinds = sorted({f.kind for f in faults[rnd]})
            title = html.escape(
                f"round {rnd} faults: "
                + ", ".join(f"{k}×{sum(1 for f in faults[rnd] if f.kind == k)}"
                            for k in kinds))
            cx = x + bar_w / 2
            parts.append(
                f"<path d='M {cx - 4:.1f} {y - 6:.1f} l 4 -7 l 4 7 z' "
                f"fill='{_FAULT}'><title>{title}</title></path>")
        if len(rounds) <= 30 or idx % max(len(rounds) // 15, 1) == 0:
            parts.append(f"<text x='{x + bar_w / 2:.1f}' y='{h - 8}' "
                         f"text-anchor='middle'>{rnd}</text>")
    parts.append(f"<line x1='{left}' y1='{top + plot_h}' x2='{w - 10}' "
                 f"y2='{top + plot_h}' stroke='var(--text-secondary)' "
                 f"stroke-width='1'/>")
    parts.append("</svg>")
    return "".join(parts)


def _device_energy_svg(cmp_j: List[float], com_j: List[float]) -> str:
    if not cmp_j:
        return "<p class='note'>no device events in this trace</p>"
    K = len(cmp_j)
    w, h, left, bottom, top = 720, 200, 56, 24, 10
    plot_w, plot_h = w - left - 10, h - bottom - top
    max_j = max(a + b for a, b in zip(cmp_j, com_j)) or 1.0
    step = plot_w / K
    bar_w = min(44.0, step * 0.72)
    parts = [f"<svg viewBox='0 0 {w} {h}' role='img' "
             f"aria-label='per-device energy'>"]
    for i in range(5):
        y = top + plot_h * (1 - i / 4)
        parts.append(f"<line x1='{left}' y1='{y:.1f}' x2='{w - 10}' "
                     f"y2='{y:.1f}' stroke='var(--grid)'/>")
        parts.append(f"<text x='{left - 6}' y='{y + 4:.1f}' "
                     f"text-anchor='end'>{_fmt(max_j * i / 4)}J</text>")
    for k in range(K):
        x = left + k * step + (step - bar_w) / 2
        y = top + plot_h
        for label, val, color in (("E^cmp (eq. 9)", cmp_j[k],
                                   _series_css(0)),
                                  ("E^com (eq. 16)", com_j[k],
                                   _series_css(1))):
            if val <= 0:
                continue
            seg_h = val / max_j * plot_h
            y -= seg_h
            title = html.escape(f"device {k} · {label}: {val:.3e} J")
            parts.append(
                f"<rect x='{x:.1f}' y='{y:.1f}' width='{bar_w:.1f}' "
                f"height='{max(seg_h - 1, 0.5):.1f}' rx='1.5' "
                f"fill='{color}' stroke='var(--surface-1)' "
                f"stroke-width='1'><title>{title}</title></rect>")
        parts.append(f"<text x='{x + bar_w / 2:.1f}' y='{h - 8}' "
                     f"text-anchor='middle'>{k}</text>")
    parts.append(f"<line x1='{left}' y1='{top + plot_h}' x2='{w - 10}' "
                 f"y2='{top + plot_h}' stroke='var(--text-secondary)'/>")
    parts.append("</svg>")
    return "".join(parts)


def _gap_svg(gap: Dict[int, float]) -> str:
    if not gap:
        return ("<p class='note'>no metrics snapshots with "
                "feel_monitor_bound_gap_ratio — run with a "
                "ConvergenceMonitor and a metrics registry to "
                "populate this chart</p>")
    rounds = sorted(gap)
    w, h, left, bottom, top = 720, 180, 46, 24, 10
    plot_w, plot_h = w - left - 10, h - bottom - top
    max_v = max(max(gap.values()), 1.25)
    step = plot_w / max(len(rounds) - 1, 1)
    parts = [f"<svg viewBox='0 0 {w} {h}' role='img' "
             f"aria-label='convergence bound gap ratio per round'>"]
    for i in range(5):
        y = top + plot_h * (1 - i / 4)
        parts.append(f"<line x1='{left}' y1='{y:.1f}' x2='{w - 10}' "
                     f"y2='{y:.1f}' stroke='var(--grid)'/>")
        parts.append(f"<text x='{left - 6}' y='{y + 4:.1f}' "
                     f"text-anchor='end'>{_fmt(max_v * i / 4)}</text>")
    # reference line at ratio 1.0 (Lemma-2 bound exactly tight)
    y1 = top + plot_h * (1 - 1.0 / max_v)
    parts.append(f"<line x1='{left}' y1='{y1:.1f}' x2='{w - 10}' "
                 f"y2='{y1:.1f}' stroke='var(--muted)' "
                 f"stroke-dasharray='4 3'/>")
    parts.append(f"<text x='{w - 12}' y='{y1 - 4:.1f}' "
                 f"text-anchor='end'>bound = 1</text>")
    pts = []
    for i, rnd in enumerate(rounds):
        x = left + i * step
        y = top + plot_h * (1 - gap[rnd] / max_v)
        pts.append(f"{x:.1f},{y:.1f}")
    parts.append(f"<polyline points='{' '.join(pts)}' fill='none' "
                 f"stroke='{_series_css(0)}' stroke-width='2'/>")
    for i, rnd in enumerate(rounds):
        x = left + i * step
        y = top + plot_h * (1 - gap[rnd] / max_v)
        title = html.escape(f"round {rnd}: gap ratio {gap[rnd]:.3f}")
        parts.append(f"<circle cx='{x:.1f}' cy='{y:.1f}' r='4' "
                     f"fill='{_series_css(0)}' "
                     f"stroke='var(--surface-1)' stroke-width='2'>"
                     f"<title>{title}</title></circle>")
        if len(rounds) <= 30 or i % max(len(rounds) // 15, 1) == 0:
            parts.append(f"<text x='{x:.1f}' y='{h - 8}' "
                         f"text-anchor='middle'>{rnd}</text>")
    parts.append("</svg>")
    return "".join(parts)


def _legend(entries: List[Tuple[str, str]]) -> str:
    return ("<div class='legend'>"
            + "".join(f"<span><i class='sw' style='background:{c}'></i>"
                      f"{html.escape(n)}</span>" for n, c in entries)
            + "</div>")


# ---------------------------------------------------------------------
# page assembly
# ---------------------------------------------------------------------

def render_dashboard(trace: Iterable[Any]) -> str:
    """Trace records (raw dicts or events) -> one HTML page string."""
    data = _collect(_records(trace))
    stages, rounds = data["stages"], data["rounds"]
    totals: Dict[str, float] = {}
    for per in stages.values():
        for name, dur in per.items():
            totals[name] = totals.get(name, 0.0) + dur
    canon = [s for s in ev.CANONICAL_STAGES if s in totals]
    extra = sorted((s for s in totals if s not in ev.CANONICAL_STAGES),
                   key=lambda s: -totals[s])
    order = canon + extra

    n_rounds = len(rounds)
    wall = sum(r.wall_s for r in rounds.values())
    cum_cost = sum(r.net_cost for r in rounds.values())
    n_faults = sum(v[0] for v in data["fault_totals"].values())
    n_fallbacks = data["fault_totals"].get("fallback", [0, 0])[0]
    accs = [r.test_acc for r in sorted(rounds)
            for r in [rounds[r]] if r.test_acc is not None]
    final_acc = accs[-1] if accs else None

    meta = data["meta"]
    source = html.escape(str(meta.get("source", "unknown source")))

    tiles = [("rounds", str(n_rounds)),
             ("wall-clock", f"{wall:.2f}s"),
             ("cum. net cost", _fmt(cum_cost)),
             ("faults", str(n_faults)),
             ("fallbacks", str(n_fallbacks))]
    if final_acc is not None:
        tiles.append(("final acc", f"{final_acc:.3f}"))
    tiles_html = "".join(
        f"<div class='tile'><div class='v'>{html.escape(v)}</div>"
        f"<div class='l'>{html.escape(l)}</div></div>"
        for l, v in tiles)

    stage_legend = _legend(
        [(n, _series_css(i))
         for i, n in enumerate(order[:len(_SERIES_LIGHT)])]
        + ([("other", _OTHER)] if len(order) > len(_SERIES_LIGHT) else [])
        + ([("fault", _FAULT)] if data["faults"] else []))

    fault_rows = "".join(
        f"<tr><td>{html.escape(kind)}</td><td>{tot}</td>"
        f"<td>{inj}</td><td>{tot - inj}</td></tr>"
        for kind, (tot, inj) in sorted(data["fault_totals"].items(),
                                       key=lambda kv: -kv[1][0]))
    fault_table = (
        "<table><tr><th>kind</th><th>count</th><th>injected</th>"
        "<th>observed</th></tr>" + fault_rows + "</table>"
        if fault_rows else "<p class='note'>no fault events — a clean "
        "run, or the resilience layer was off</p>")

    return f"""<!doctype html>
<html lang="en"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>FEEL round report — {source}</title>
<style>{_CSS}{_series_vars()}</style></head>
<body>
<h1>FEEL round report</h1>
<p class="sub">source: {source} · schema v{ev.SCHEMA_VERSION} reader ·
 generated by <code>python -m repro_torch.obs dash</code></p>
<div class="tiles">{tiles_html}</div>

<h2>Round timeline — stacked stage seconds</h2>
<p class="sub">Where each round's wall-clock went (eq. 8/16 latency
 terms as measured). Red markers flag rounds with fault or fallback
 activity; hover any segment for exact timings.</p>
{stage_legend}
{_stacked_rounds_svg(stages, data["faults"], order)}

<h2>Per-device energy (eqs. 9 + 16)</h2>
<p class="sub">E^cmp + E^com summed over the trace — the per-device
 side of the eq. 17/18 cost the server is billed.</p>
{_legend([("E^cmp compute", _series_css(0)),
          ("E^com upload", _series_css(1))])}
{_device_energy_svg(data["device_cmp"], data["device_com"])}

<h2>Convergence-bound gap ratio</h2>
<p class="sub">Observed optimality-gap proxy / Lemma-2 predicted bound
 per round (&le; 1 means the run obeys the theory; see
 docs/telemetry.md).</p>
{_gap_svg(data["gap"])}

<h2>Faults and policy reactions</h2>
{fault_table}
</body></html>
"""


def write_dashboard(trace_path: str, out_path: str) -> str:
    from . import summary as summary_mod

    page = render_dashboard(summary_mod.load_trace(trace_path))
    with open(out_path, "w", encoding="utf-8") as f:
        f.write(page)
    return out_path


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs dash",
        description="render a JSONL trace as a self-contained HTML "
                    "round dashboard (inline SVG, no external assets)")
    ap.add_argument("trace", help="JSONL trace file")
    ap.add_argument("-o", "--out", default="report.html",
                    help="output HTML path (default report.html)")
    args = ap.parse_args(argv)
    out = write_dashboard(args.trace, args.out)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
