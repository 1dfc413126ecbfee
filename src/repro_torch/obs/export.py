"""Export a telemetry trace as Chrome trace-event JSON.

    PYTHONPATH=src python -m repro_torch.obs export trace.jsonl -o trace.json

The output loads in Perfetto (https://ui.perfetto.dev) or
chrome://tracing and shows each round as a nested timeline:

* every span/stage becomes a complete event (``"ph": "X"``) with its
  recorded monotonic start/duration (microseconds, as the format
  requires);
* spans carrying a ``device`` attribute land on that device's own
  track (``device 3``), everything else on the ``rounds`` track, so
  per-device work reads as parallel lanes under the round span;
* fault events (dropout, straggler, fallback, quarantine, ...) become
  instant markers (``"ph": "i"``) at their recorded ``t_s`` — pre-v4
  traces carry no fault timestamps, so there they are placed at the
  end of their round's span when one exists and skipped otherwise;
* per-round counters (net cost, selected/uploaded samples) become
  counter events (``"ph": "C"``) anchored at the round span's end,
  rendered by Perfetto as step charts above the timeline.

The exporter consumes raw records or live event objects and never
needs more than the standard library.

Counterpart of ``repro/obs/export.py``, copied.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional

from . import events as ev
from . import spans as spans_mod

#: synthetic process id for the single-process trace.
PID = 1
#: tid of the main (round-loop) track; device k maps to DEVICE_TID0+k.
MAIN_TID = 0
DEVICE_TID0 = 100


def _us(seconds: float) -> float:
    return seconds * 1e6


def _tid(node: spans_mod.SpanNode) -> int:
    dev = node.attrs.get("device")
    return MAIN_TID if dev is None else DEVICE_TID0 + int(dev)


def to_chrome_trace(trace: Iterable[Any],
                    meta: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
    """Build the Chrome trace-event JSON object for a trace."""
    records = [r.to_record() if hasattr(r, "to_record") else r
               for r in trace]
    roots, orphans = spans_mod.build_tree(records)
    events: List[Dict[str, Any]] = []
    tids = {MAIN_TID}

    # -- spans: complete events ----------------------------------------
    round_spans: Dict[int, spans_mod.SpanNode] = {}
    for root in roots + orphans:
        for node in root.walk():
            if node.name == "round" and node.round is not None:
                round_spans.setdefault(node.round, node)
            tid = _tid(node)
            tids.add(tid)
            args: Dict[str, Any] = dict(node.attrs)
            if node.round is not None:
                args.setdefault("round", node.round)
            events.append({"name": node.name, "cat": node.kind,
                           "ph": "X", "ts": _us(node.t0_s),
                           "dur": _us(node.dur_s), "pid": PID,
                           "tid": tid, "args": args})

    # -- faults: instant markers; rounds: counter series ---------------
    for r in records:
        e = ev.parse_record(r)
        if isinstance(e, ev.FaultEvent):
            t_s = e.t_s
            if t_s is None:  # pre-v4 record: anchor to the round span
                rs = round_spans.get(e.round) if e.round is not None \
                    else None
                if rs is None:
                    continue
                t_s = rs.end_s
            tid = (MAIN_TID if e.device is None
                   else DEVICE_TID0 + int(e.device))
            tids.add(tid)
            args = {"injected": e.injected, **(e.detail or {})}
            if e.round is not None:
                args["round"] = e.round
            events.append({"name": f"fault:{e.kind}", "cat": "fault",
                           "ph": "i", "ts": _us(t_s), "pid": PID,
                           "tid": tid, "s": "t", "args": args})
        elif isinstance(e, ev.RoundEvent):
            rs = round_spans.get(e.round)
            if rs is None:
                continue
            ts = _us(rs.end_s)
            for name, value in (("net_cost", e.net_cost),
                                ("n_selected", e.n_selected),
                                ("n_uploaded", e.n_uploaded)):
                events.append({"name": name, "cat": "round", "ph": "C",
                               "ts": ts, "pid": PID, "tid": MAIN_TID,
                               "args": {"value": value}})

    # -- track naming metadata -----------------------------------------
    events.append({"name": "process_name", "ph": "M", "pid": PID,
                   "args": {"name": "FEEL round loop"}})
    for tid in sorted(tids):
        label = ("rounds" if tid == MAIN_TID
                 else f"device {tid - DEVICE_TID0}")
        events.append({"name": "thread_name", "ph": "M", "pid": PID,
                       "tid": tid, "args": {"name": label}})
        events.append({"name": "thread_sort_index", "ph": "M", "pid": PID,
                       "tid": tid, "args": {"sort_index": tid}})

    header = next((r for r in records if r.get("ev") == "header"), None)
    other = dict(meta or {})
    if header is not None:
        other.setdefault("trace_meta", header.get("meta", {}))
        other.setdefault("schema_version", header.get("v"))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": other}


def export_file(trace_path: str, out_path: str) -> Dict[str, Any]:
    """Load a JSONL trace, convert, write ``out_path``; returns the
    trace object (handy for tests and callers wanting stats)."""
    from . import summary as summary_mod

    obj = to_chrome_trace(summary_mod.load_trace(trace_path))
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(obj, f)
    return obj


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs export",
        description="export a JSONL trace as Chrome trace-event JSON "
                    "(viewable in Perfetto / chrome://tracing)")
    ap.add_argument("trace", help="JSONL trace file")
    ap.add_argument("-o", "--out", default=None,
                    help="output path (default: <trace>.json)")
    args = ap.parse_args(argv)
    out = args.out or (args.trace.rsplit(".", 1)[0] + ".json")
    obj = export_file(args.trace, out)
    n_spans = sum(1 for e in obj["traceEvents"] if e.get("ph") == "X")
    n_faults = sum(1 for e in obj["traceEvents"] if e.get("ph") == "i")
    print(f"wrote {out}: {n_spans} spans, {n_faults} fault markers "
          f"({len(obj['traceEvents'])} events) — open in "
          f"https://ui.perfetto.dev or chrome://tracing")


if __name__ == "__main__":
    main()
