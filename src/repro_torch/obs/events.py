"""Versioned event schema for the round-level telemetry trace.

Counterpart of ``repro/obs/events.py``, copied: the port writes the
same schema v4 (docs/telemetry.md is its definition), so a trace from
either package reads with either package's tools.

A trace is a JSONL file: one JSON object per line, each carrying an
``"ev"`` discriminator and a ``"v"`` schema version.  Ten event kinds
exist (see docs/telemetry.md for the field-by-field reference):

``header``   trace metadata, written once at the top of the file;
``stage``    one timed section of a round (the ``stage(...)`` context
             manager) — canonical names: ``data``, ``sigma``,
             ``matching``, ``power``, ``selection``, ``objective``,
             ``local_grads``, ``aggregate``, ``eval``;
``solver``   counters from one solver invocation (swap count, sweeps,
             CCP iterations, GP steps, feasibility);
``devices``  per-device arrays for one round: energy terms of
             eqs. (16)-(18), selected/uploaded counts, mislabel
             fraction among the selected samples;
``round``    the round roll-up: wall-clock, net cost (eq. 18),
             Delta_hat (eq. 26), feasibility.

Schema v2 adds (all three optional — v1 traces remain readable):

``metrics``  a snapshot of the process metrics registry
             (``repro_torch.obs.metrics``): counters, gauges, histograms;
``monitor``  one structured warning from the convergence monitor
             (``repro_torch.obs.monitor``): Lemma-2 bound violation, gap
             divergence, or straggler round/stage;
``profile``  per-function roofline numbers recorded once per input
             shapes (``repro_torch.obs.profile``): FLOPs, bytes
             accessed, estimated peak FLOP/s.

Schema v3 adds (optional — v1/v2 traces remain readable):

``fault``    one fault-tolerance event (the fault plan and the
             resilience policies of the round loop): an injected
             or observed fault (dropout, straggler, NaN upload, solver
             failure) or the policy reaction to one (retry, fallback,
             quarantine, skipped update, checkpoint, resume).

Schema v4 adds hierarchical *span* tracing (v1-v3 traces remain
readable):

``span``     one timed section in the round's span tree
             (``Telemetry.span(name, **attrs)``): ``span_id`` /
             ``parent_id`` link spans into a tree rooted at the round
             span, ``attrs`` carries JSON-scalar context (device
             index, CCP iteration, sweep number, ...);
``stage``    records gain optional ``span_id``/``parent_id`` fields —
             a timed stage *is* a span (``stage()`` is an alias of
             ``span()``), so stages nest into the same tree while
             every v1-v3 consumer keeps reading them unchanged;
``fault``    records gain an optional ``t_s`` timestamp (seconds since
             trace creation, same clock as ``t0_s``) so faults can be
             placed as instant markers on an exported timeline.

Events deliberately serialize to *flat* dicts of JSON scalars/lists so
a trace can be consumed with nothing but ``json.loads`` per line.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

SCHEMA_VERSION = 4

#: canonical stage names instrumented by the FEEL round loop; sinks
#: accept any string so callers may add their own sections.
CANONICAL_STAGES = ("data", "sigma", "matching", "power", "selection",
                    "objective", "local_grads", "aggregate", "eval")

#: the six stages every instrumented ``FEELTrainer.run_round`` emits.
REQUIRED_STAGES = ("sigma", "matching", "power", "selection",
                   "local_grads", "aggregate")


@dataclasses.dataclass
class StageEvent:
    """One timed section: ``dur_s`` seconds starting ``t0_s`` after
    trace creation (monotonic clock).

    Since schema v4 a stage is also a node in the span tree:
    ``span_id``/``parent_id`` (both None on pre-v4 records and on
    hand-built events) link it to its enclosing span.
    """

    stage: str
    t0_s: float
    dur_s: float
    round: Optional[int] = None
    span_id: Optional[int] = None
    parent_id: Optional[int] = None

    def to_record(self) -> Dict[str, Any]:
        rec = {"ev": "stage", "v": SCHEMA_VERSION, "round": self.round,
               "stage": self.stage, "t0_s": self.t0_s,
               "dur_s": self.dur_s}
        if self.span_id is not None:
            rec["span_id"] = self.span_id
            rec["parent_id"] = self.parent_id
        return rec


@dataclasses.dataclass
class SpanEvent:
    """One node of the hierarchical span tree (new in schema v4).

    ``span_id`` is unique within a trace; ``parent_id`` is the id of
    the enclosing span (None for a root span, e.g. the per-round
    ``round`` span).  ``attrs`` holds JSON scalars recorded at span
    entry (device index, CCP iteration, sweep number, solver method).
    Emitted at span *exit*, so a trace lists children before parents;
    ``repro_torch.obs.spans.build_tree`` reconstructs the tree either way.
    """

    name: str
    span_id: int
    t0_s: float
    dur_s: float
    parent_id: Optional[int] = None
    round: Optional[int] = None
    attrs: Optional[Dict[str, Any]] = None

    def to_record(self) -> Dict[str, Any]:
        return {"ev": "span", "v": SCHEMA_VERSION, "round": self.round,
                "name": self.name, "span_id": self.span_id,
                "parent_id": self.parent_id, "t0_s": self.t0_s,
                "dur_s": self.dur_s, "attrs": dict(self.attrs or {})}


@dataclasses.dataclass
class SolverEvent:
    """Counters from one solver call.

    ``solver`` is ``matching`` (Alg. 2), ``power`` (Alg. 3 / closed
    form) or ``selection`` (Algs. 4-5 / exact oracle); ``counters``
    holds JSON scalars (ints, floats, bools, short strings).
    """

    solver: str
    counters: Dict[str, Any]
    round: Optional[int] = None

    def to_record(self) -> Dict[str, Any]:
        return {"ev": "solver", "v": SCHEMA_VERSION, "round": self.round,
                "solver": self.solver, "counters": dict(self.counters)}


@dataclasses.dataclass
class DeviceEvent:
    """Per-device accounting for one round; every list has length K.

    ``energy_cmp_j`` is E^cmp_k (eq. 9), ``energy_com_j`` is E^com_k
    (below eq. 16), ``cost`` is c_k (E^cmp_k + E^com_k) (eqs. 10+17),
    ``reward`` is q_k |M_k| (eq. 7) — net cost (eq. 18) is
    sum(cost) - sum(reward).
    """

    round: int
    energy_cmp_j: List[float]
    energy_com_j: List[float]
    cost: List[float]
    reward: List[float]
    selected: List[int]
    uploaded: List[int]
    mislabel_frac: List[float]

    def to_record(self) -> Dict[str, Any]:
        return {"ev": "devices", "v": SCHEMA_VERSION, "round": self.round,
                "energy_cmp_j": self.energy_cmp_j,
                "energy_com_j": self.energy_com_j,
                "cost": self.cost, "reward": self.reward,
                "selected": self.selected, "uploaded": self.uploaded,
                "mislabel_frac": self.mislabel_frac}


@dataclasses.dataclass
class RoundEvent:
    """Round roll-up; ``wall_s`` covers the whole ``run_round`` call."""

    round: int
    wall_s: float
    net_cost: float
    delta_obj: float
    n_selected: int
    n_uploaded: int
    feasible: bool
    test_acc: Optional[float] = None

    def to_record(self) -> Dict[str, Any]:
        return {"ev": "round", "v": SCHEMA_VERSION, "round": self.round,
                "wall_s": self.wall_s, "net_cost": self.net_cost,
                "delta_obj": self.delta_obj,
                "n_selected": self.n_selected,
                "n_uploaded": self.n_uploaded, "feasible": self.feasible,
                "test_acc": self.test_acc}


@dataclasses.dataclass
class MetricsEvent:
    """Snapshot of a metrics registry (new in schema v2).

    ``families`` is the list produced by ``Registry.snapshot()``: one
    dict per metric family with ``name``, ``type``, ``help`` and
    ``samples`` (plus ``bucket_bounds`` for histograms).  Counters are
    cumulative, so the *last* metrics event in a trace carries the
    whole run's totals.
    """

    families: List[Dict[str, Any]]
    round: Optional[int] = None

    def to_record(self) -> Dict[str, Any]:
        return {"ev": "metrics", "v": SCHEMA_VERSION, "round": self.round,
                "families": list(self.families)}


@dataclasses.dataclass
class MonitorEvent:
    """One structured convergence-monitor warning (new in schema v2).

    ``kind`` is ``bound_violation`` (observed gap exceeded the Lemma-2
    one-round bound), ``gap_divergence`` (gap increased monotonically
    over the monitor's window) or ``straggler`` (round or stage wall
    time exceeded k x the running median).  ``value`` is the observed
    quantity, ``threshold`` what it was checked against.
    """

    kind: str
    value: float
    threshold: float
    round: Optional[int] = None
    detail: Optional[Dict[str, Any]] = None

    def to_record(self) -> Dict[str, Any]:
        return {"ev": "monitor", "v": SCHEMA_VERSION, "round": self.round,
                "kind": self.kind, "value": self.value,
                "threshold": self.threshold,
                "detail": dict(self.detail or {})}


@dataclasses.dataclass
class ProfileEvent:
    """Roofline numbers for one profiled function (new in schema v2).

    Recorded once per (function, input shapes).  ``flops`` and
    ``bytes_accessed`` come from ``repro_torch.obs.profile.cost_of``;
    ``peak_flops`` is the backend peak estimated *at trace time* so a
    trace stays interpretable on another machine.  ``stage`` links the
    profile to the stage events that time this function's executions.
    """

    name: str
    stage: Optional[str]
    flops: float
    bytes_accessed: float
    peak_flops: float
    compile_s: float = 0.0
    round: Optional[int] = None

    def to_record(self) -> Dict[str, Any]:
        return {"ev": "profile", "v": SCHEMA_VERSION, "round": self.round,
                "name": self.name, "stage": self.stage,
                "flops": self.flops,
                "bytes_accessed": self.bytes_accessed,
                "peak_flops": self.peak_flops,
                "compile_s": self.compile_s}


#: valid ``FaultEvent.kind`` values (see docs/robustness.md).
FAULT_KINDS = ("dropout", "straggler", "nan_upload", "solver_fail",
               "retry", "fallback", "quarantine", "skip_update",
               "partial_matching", "checkpoint", "resume")


@dataclasses.dataclass
class FaultEvent:
    """One fault or fault-tolerance reaction (new in schema v3).

    ``kind`` is one of ``FAULT_KINDS``; ``injected`` is True when the
    event originates from a fault plan (chaos
    testing) and False when it was observed/defensive (a naturally
    infeasible solve, a real NaN, a policy reaction).  ``device`` is
    the device index for per-device faults, None for round/solver-level
    events.  ``detail`` holds JSON scalars (solver names, delays,
    attempt counts, strike counts, checkpoint paths).  ``t_s`` (new in
    schema v4, None on older records) is the emission time in seconds
    since trace creation — the same clock as ``StageEvent.t0_s`` — so
    exporters can place the fault as an instant marker on a timeline.
    """

    kind: str
    injected: bool
    round: Optional[int] = None
    device: Optional[int] = None
    detail: Optional[Dict[str, Any]] = None
    t_s: Optional[float] = None

    def to_record(self) -> Dict[str, Any]:
        rec = {"ev": "fault", "v": SCHEMA_VERSION, "round": self.round,
               "kind": self.kind, "injected": self.injected,
               "device": self.device, "detail": dict(self.detail or {})}
        if self.t_s is not None:
            rec["t_s"] = self.t_s
        return rec


def header_record(meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    return {"ev": "header", "v": SCHEMA_VERSION, "meta": dict(meta or {})}


_KINDS = {
    "stage": lambda r: StageEvent(stage=r["stage"], t0_s=r["t0_s"],
                                  dur_s=r["dur_s"], round=r.get("round"),
                                  span_id=r.get("span_id"),
                                  parent_id=r.get("parent_id")),
    "span": lambda r: SpanEvent(
        name=r["name"], span_id=r["span_id"],
        parent_id=r.get("parent_id"), t0_s=r["t0_s"], dur_s=r["dur_s"],
        round=r.get("round"), attrs=r.get("attrs")),
    "solver": lambda r: SolverEvent(solver=r["solver"],
                                    counters=r["counters"],
                                    round=r.get("round")),
    "devices": lambda r: DeviceEvent(
        round=r["round"], energy_cmp_j=r["energy_cmp_j"],
        energy_com_j=r["energy_com_j"], cost=r["cost"],
        reward=r["reward"], selected=r["selected"],
        uploaded=r["uploaded"], mislabel_frac=r["mislabel_frac"]),
    "round": lambda r: RoundEvent(
        round=r["round"], wall_s=r["wall_s"], net_cost=r["net_cost"],
        delta_obj=r["delta_obj"], n_selected=r["n_selected"],
        n_uploaded=r["n_uploaded"], feasible=r["feasible"],
        test_acc=r.get("test_acc")),
    "metrics": lambda r: MetricsEvent(families=r["families"],
                                      round=r.get("round")),
    "monitor": lambda r: MonitorEvent(
        kind=r["kind"], value=r["value"], threshold=r["threshold"],
        round=r.get("round"), detail=r.get("detail")),
    "profile": lambda r: ProfileEvent(
        name=r["name"], stage=r.get("stage"), flops=r["flops"],
        bytes_accessed=r["bytes_accessed"],
        peak_flops=r.get("peak_flops", 0.0),
        compile_s=r.get("compile_s", 0.0), round=r.get("round")),
    "fault": lambda r: FaultEvent(
        kind=r["kind"], injected=r["injected"], round=r.get("round"),
        device=r.get("device"), detail=r.get("detail"),
        t_s=r.get("t_s")),
}


def parse_record(record: Dict[str, Any]):
    """Dict (one JSONL line) -> typed event; header/unknown -> None.

    Raises ``ValueError`` when the record's schema version is *newer*
    than this reader so we fail loudly instead of mis-aggregating a
    future trace format.  Older versions parse fine: v2 added the
    ``metrics``/``monitor``/``profile`` kinds, v3 added ``fault``, and
    v4 added ``span`` plus *optional* fields on ``stage``
    (``span_id``/``parent_id``) and ``fault`` (``t_s``) — no existing
    field changed meaning, so every v1-v3 record is also a valid v4
    record.
    """
    v = record.get("v", SCHEMA_VERSION)
    if v > SCHEMA_VERSION:
        raise ValueError(f"trace schema v{v} > reader v{SCHEMA_VERSION}")
    make = _KINDS.get(record.get("ev"))
    return make(record) if make else None
