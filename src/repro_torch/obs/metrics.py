"""Process-wide metrics registry (counters, gauges, histograms).

Pure Python, no dependencies: a ``Registry`` holds metric *families*
(one per name); each family holds one value per label combination.
Three instrument types exist, mirroring the Prometheus data model:

* ``Counter`` — monotonically increasing float (``inc``);
* ``Gauge`` — last-write-wins float (``set``);
* ``Histogram`` — fixed upper-bound buckets plus ``sum``/``count``
  (``observe``).  Buckets are chosen at creation and never resized,
  so two snapshots of the same registry are always comparable.

The registry follows the same null-object pattern as the telemetry
sinks (``repro_torch.obs.trace``): the process default is a ``NullRegistry``
whose instruments are shared no-ops, so instrumented solver code costs
a dict lookup *only when a real registry is installed* and nothing
perturbs numerics either way.  Install one with::

    from repro_torch.obs import metrics

    reg = metrics.Registry()
    metrics.set_default(reg)
    ...run rounds...
    print(reg.render())           # Prometheus text exposition

Snapshots (``Registry.snapshot()``) are plain JSON and flow through
``Telemetry.emit`` as ``MetricsEvent`` records (schema v2), so a JSONL
trace doubles as a metrics archive::

    python -m repro_torch.obs.metrics trace.jsonl   # exposition of the last
                                              # snapshot in the trace

Counters are cumulative, so the last snapshot carries the whole run.

Counterpart of ``repro/obs/metrics.py``, copied.
"""
from __future__ import annotations

import re
from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from . import events as ev

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")

#: default histogram buckets, in seconds (Prometheus' defaults minus
#: the sub-millisecond tail the round loop never hits).
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> _LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _escape(value: str) -> str:
    return (value.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt_labels(key: _LabelKey, extra: Sequence[Tuple[str, str]] = ()
                ) -> str:
    pairs = list(key) + list(extra)
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in pairs)
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class _NullInstrument:
    """Shared no-op counter/gauge/histogram."""

    __slots__ = ()

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        pass

    def set(self, value: float, **labels: Any) -> None:
        pass

    def observe(self, value: float, **labels: Any) -> None:
        pass


_NULL_INSTRUMENT = _NullInstrument()


class Counter:
    """Monotonic counter family; one value per label combination."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._values: Dict[_LabelKey, float] = OrderedDict()

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = _label_key(labels)
        self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: Any) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def samples(self) -> List[Dict[str, Any]]:
        return [{"labels": dict(k), "value": v}
                for k, v in self._values.items()]

    def render_into(self, lines: List[str]) -> None:
        for key, v in self._values.items():
            lines.append(f"{self.name}{_fmt_labels(key)} {_fmt_value(v)}")


class Gauge(Counter):
    """Last-write-wins gauge family."""

    kind = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        self._values[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        key = _label_key(labels)
        self._values[key] = self._values.get(key, 0.0) + amount


class Histogram:
    """Fixed-bucket histogram family (cumulative ``le`` exposition)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError("histogram buckets must be sorted, non-empty")
        self.name = name
        self.help = help
        self.buckets = tuple(float(b) for b in buckets)
        # per label-key: [per-bucket counts + overflow], sum, count
        self._counts: Dict[_LabelKey, List[int]] = OrderedDict()
        self._sums: Dict[_LabelKey, float] = {}
        self._totals: Dict[_LabelKey, int] = {}

    def observe(self, value: float, **labels: Any) -> None:
        key = _label_key(labels)
        counts = self._counts.get(key)
        if counts is None:
            counts = self._counts[key] = [0] * (len(self.buckets) + 1)
            self._sums[key] = 0.0
            self._totals[key] = 0
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                counts[i] += 1
                break
        else:
            counts[-1] += 1
        self._sums[key] += float(value)
        self._totals[key] += 1

    def count(self, **labels: Any) -> int:
        return self._totals.get(_label_key(labels), 0)

    def sum(self, **labels: Any) -> float:
        return self._sums.get(_label_key(labels), 0.0)

    def quantile(self, q: float, **labels: Any) -> float:
        """Bucket-resolution quantile estimate (upper bound of the
        bucket containing the q-th observation; +Inf bucket returns the
        largest finite bound)."""
        key = _label_key(labels)
        counts = self._counts.get(key)
        total = self._totals.get(key, 0)
        if not counts or total == 0:
            return 0.0
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= rank and c:
                return (self.buckets[i] if i < len(self.buckets)
                        else self.buckets[-1])
        return self.buckets[-1]

    def samples(self) -> List[Dict[str, Any]]:
        return [{"labels": dict(k), "buckets": list(self._counts[k]),
                 "sum": self._sums[k], "count": self._totals[k]}
                for k in self._counts]

    def render_into(self, lines: List[str]) -> None:
        for key in self._counts:
            cum = 0
            for i, ub in enumerate(self.buckets):
                cum += self._counts[key][i]
                lines.append(f"{self.name}_bucket"
                             f"{_fmt_labels(key, [('le', repr(ub))])} "
                             f"{cum}")
            cum += self._counts[key][-1]
            lines.append(f"{self.name}_bucket"
                         f"{_fmt_labels(key, [('le', '+Inf')])} {cum}")
            lines.append(f"{self.name}_sum{_fmt_labels(key)} "
                         f"{_fmt_value(self._sums[key])}")
            lines.append(f"{self.name}_count{_fmt_labels(key)} "
                         f"{self._totals[key]}")


class NullRegistry:
    """Do-nothing registry; the interface contract for ``Registry``."""

    enabled: bool = False

    def counter(self, name: str, help: str = "") -> _NullInstrument:
        return _NULL_INSTRUMENT

    def gauge(self, name: str, help: str = "") -> _NullInstrument:
        return _NULL_INSTRUMENT

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS
                  ) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def snapshot(self) -> List[Dict[str, Any]]:
        return []

    def snapshot_event(self, round: Optional[int] = None) -> ev.MetricsEvent:
        return ev.MetricsEvent(families=[], round=round)

    def render(self) -> str:
        return ""

    def reset(self) -> None:
        pass


#: shared no-op registry (the process default until one is installed).
NULL = NullRegistry()


class Registry(NullRegistry):
    """Recording registry: get-or-create metric families by name."""

    enabled = True

    def __init__(self):
        self._families: "OrderedDict[str, Any]" = OrderedDict()

    # -- instruments ---------------------------------------------------
    def _get(self, name: str, help: str, cls, **kw):
        fam = self._families.get(name)
        if fam is None:
            if not _NAME_RE.match(name):
                raise ValueError(f"invalid metric name: {name!r}")
            fam = self._families[name] = cls(name, help, **kw)
        elif not isinstance(fam, cls) or fam.kind != cls.kind:
            raise ValueError(f"metric {name!r} already registered as "
                             f"{fam.kind}")
        return fam

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, help, Counter)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, help, Gauge)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(name, help, Histogram, buckets=buckets)

    # -- output --------------------------------------------------------
    def snapshot(self) -> List[Dict[str, Any]]:
        """JSON-safe dump: one dict per family, counters cumulative."""
        out = []
        for fam in self._families.values():
            rec: Dict[str, Any] = {"name": fam.name, "type": fam.kind,
                                   "help": fam.help,
                                   "samples": fam.samples()}
            if fam.kind == "histogram":
                rec["bucket_bounds"] = list(fam.buckets)
            out.append(rec)
        return out

    def snapshot_event(self, round: Optional[int] = None) -> ev.MetricsEvent:
        return ev.MetricsEvent(families=self.snapshot(), round=round)

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        for fam in self._families.values():
            if fam.help:
                lines.append(f"# HELP {fam.name} {_escape(fam.help)}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            fam.render_into(lines)
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        self._families.clear()


def render_snapshot(families: Iterable[Dict[str, Any]]) -> str:
    """Rebuild a registry from ``Registry.snapshot()`` dicts (e.g. a
    trace's ``MetricsEvent.families``) and render its exposition."""
    reg = Registry()
    for fam in families:
        kind, name, help = fam["type"], fam["name"], fam.get("help", "")
        if kind == "counter":
            c = reg.counter(name, help)
            for s in fam["samples"]:
                c.inc(s["value"], **s.get("labels", {}))
        elif kind == "gauge":
            g = reg.gauge(name, help)
            for s in fam["samples"]:
                g.set(s["value"], **s.get("labels", {}))
        elif kind == "histogram":
            h = reg.histogram(name, help, buckets=fam["bucket_bounds"])
            for s in fam["samples"]:
                key = _label_key(s.get("labels", {}))
                h._counts[key] = list(s["buckets"])
                h._sums[key] = float(s["sum"])
                h._totals[key] = int(s["count"])
        else:
            raise ValueError(f"unknown metric type {kind!r} for {name!r}")
    return reg.render()


# ---------------------------------------------------------------------
# process-wide default registry (mirrors repro_torch.obs.trace)
# ---------------------------------------------------------------------

_default: NullRegistry = NULL


def set_default(reg: Optional[NullRegistry]) -> None:
    """Install ``reg`` as the process default (``None`` resets)."""
    global _default
    _default = reg if reg is not None else NULL


def get_default() -> NullRegistry:
    return _default


def resolve(registry: Optional[NullRegistry]) -> NullRegistry:
    """``None`` -> the process default; anything else passes through."""
    return _default if registry is None else registry


def main(argv: Optional[List[str]] = None) -> None:
    """``python -m repro_torch.obs.metrics trace.jsonl`` — render the last
    metrics snapshot in a trace as a Prometheus text exposition."""
    import argparse

    from . import summary as summary_mod

    ap = argparse.ArgumentParser(
        description="render a trace's metrics as Prometheus text")
    ap.add_argument("trace", help="JSONL trace file with metrics events")
    args = ap.parse_args(argv)
    last = None
    for rec in summary_mod.load_trace(args.trace):
        if rec.get("ev") == "metrics":
            last = rec
    if last is None:
        raise SystemExit(f"no metrics events in {args.trace}")
    print(render_snapshot(last["families"]), end="")


if __name__ == "__main__":
    main()
