"""Span-tree model over a telemetry trace (schema v4).

A v4 trace carries two record kinds with span identity: ``span``
records (``Telemetry.span(name, **attrs)``) and ``stage`` records
(``Telemetry.stage`` — a span that serializes in the legacy shape).
Both carry ``span_id``/``parent_id``; this module normalizes them into
one ``SpanNode`` shape and reconstructs the per-round call tree:

    round
    ├── data / sigma / matching / power / selection / ...   (stages)
    │     ├── matching.sweep(sweep=1)                       (spans)
    │     └── power.ccp_iter(iter=0..V)
    ├── local_grads / aggregate
    │     └── device.upload(device=k)
    └── eval

Spans are emitted at *exit*, so a JSONL trace lists children before
their parents; ``build_tree`` buffers the whole record list and links
in a second pass.  Pre-v4 traces have no span ids — ``iter_spans``
returns their stages as parentless nodes, so every consumer
(export/diff/dash) degrades gracefully on old traces.

Counterpart of ``repro/obs/spans.py``, copied.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Tuple

from . import events as ev


@dataclasses.dataclass
class SpanNode:
    """One node of the reconstructed span tree."""

    name: str
    t0_s: float
    dur_s: float
    span_id: Optional[int] = None
    parent_id: Optional[int] = None
    round: Optional[int] = None
    #: "stage" for legacy-shaped stage records, "span" otherwise.
    kind: str = "span"
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    children: List["SpanNode"] = dataclasses.field(default_factory=list)
    parent: Optional["SpanNode"] = dataclasses.field(
        default=None, repr=False)

    @property
    def end_s(self) -> float:
        return self.t0_s + self.dur_s

    def self_s(self) -> float:
        """Duration not covered by child spans (the node's own time)."""
        return max(self.dur_s - sum(c.dur_s for c in self.children), 0.0)

    def path(self) -> str:
        """Root-to-node name path, e.g. ``round/power/power.ccp_iter``."""
        parts = [self.name]
        node = self.parent
        while node is not None:
            parts.append(node.name)
            node = node.parent
        return "/".join(reversed(parts))

    def walk(self) -> Iterable["SpanNode"]:
        yield self
        for c in self.children:
            yield from c.walk()


def _records(trace: Iterable[Any]) -> List[Dict[str, Any]]:
    return [r.to_record() if hasattr(r, "to_record") else r for r in trace]


def iter_spans(trace: Iterable[Any]) -> List[SpanNode]:
    """All span-shaped records of a trace as flat (unlinked) nodes.

    Accepts raw record dicts or live event objects.  Stage records
    without span ids (pre-v4 traces, hand-built events) become
    parentless nodes so old traces keep working.
    """
    out: List[SpanNode] = []
    for r in _records(trace):
        e = ev.parse_record(r)
        if isinstance(e, ev.SpanEvent):
            out.append(SpanNode(name=e.name, t0_s=e.t0_s, dur_s=e.dur_s,
                                span_id=e.span_id, parent_id=e.parent_id,
                                round=e.round, kind="span",
                                attrs=dict(e.attrs or {})))
        elif isinstance(e, ev.StageEvent):
            out.append(SpanNode(name=e.stage, t0_s=e.t0_s, dur_s=e.dur_s,
                                span_id=e.span_id, parent_id=e.parent_id,
                                round=e.round, kind="stage"))
    return out


def build_tree(trace: Iterable[Any],
               strict: bool = False
               ) -> Tuple[List[SpanNode], List[SpanNode]]:
    """Link a trace's spans into trees; returns ``(roots, orphans)``.

    ``roots`` are spans without a parent id (per-round ``round`` spans,
    pre-v4 stages); ``orphans`` are spans whose ``parent_id`` does not
    resolve — expected only as crash debris (a parent that never
    exited).  ``strict=True`` raises on orphans instead, which is what
    the test suite uses to assert tree validity.  Children are sorted
    by start time.
    """
    nodes = iter_spans(trace)
    by_id = {n.span_id: n for n in nodes if n.span_id is not None}
    roots: List[SpanNode] = []
    orphans: List[SpanNode] = []
    for n in nodes:
        if n.parent_id is None:
            roots.append(n)
        elif n.parent_id in by_id:
            parent = by_id[n.parent_id]
            n.parent = parent
            parent.children.append(n)
        else:
            orphans.append(n)
    if strict and orphans:
        names = sorted({o.name for o in orphans})
        raise ValueError(f"{len(orphans)} orphan span(s) with unresolved "
                         f"parent_id: {names}")
    for n in nodes:
        n.children.sort(key=lambda c: c.t0_s)
    roots.sort(key=lambda n: n.t0_s)
    return roots, orphans


def self_seconds_by_path(trace: Iterable[Any]) -> Dict[str, float]:
    """Aggregate *self* time (span duration minus child durations) by
    root-to-node name path — the attribution map ``repro_torch.obs.diff``
    ranks: deltas land on the deepest span responsible, not on every
    enclosing parent."""
    roots, orphans = build_tree(trace)
    out: Dict[str, float] = {}
    for root in roots + orphans:
        for node in root.walk():
            out[node.path()] = out.get(node.path(), 0.0) + node.self_s()
    return out
