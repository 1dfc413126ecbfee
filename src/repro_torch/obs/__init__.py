"""Round-level observability for the port's FEEL trainer.

Counterpart of ``repro/obs``: the same schema-v4 JSONL trace
(docs/telemetry.md), so ``repro.obs``' tools read the port's traces and
this package's tools read the reference's.  Four layers:

* ``events``/``trace`` — a versioned JSONL trace and a sink with a
  zero-overhead no-op default;
* ``metrics`` — a process-wide counter/gauge/histogram registry with a
  Prometheus text exposition (``python -m repro_torch.obs metrics``);
* ``monitor`` — a ``ConvergenceMonitor`` checking observed optimality
  gaps against the paper's Lemma 2/3 bounds (``core/convergence.py``)
  and flagging divergence and straggler rounds;
* ``profile`` — per-function FLOPs/bytes (roofline) recorded once per
  input shapes, joined against stage wall-clock by ``summary``;
* ``spans``/``export``/``diff``/``dash`` — the span tree over a trace
  plus its three consumers: Chrome/Perfetto trace-event export,
  base-vs-head delta attribution, and a self-contained HTML round
  dashboard (``python -m repro_torch.obs export|diff|dash``).

Typical use::

    from repro_torch import obs

    tele = obs.Telemetry(path="trace.jsonl")
    trainer = FEELTrainer(sys_, data, model, cfg, telemetry=tele)
    trainer.run(100)
    tele.close()
    obs.emit_summary(obs.summarize(tele.events))
"""
from . import (dash, diff, events, export, metrics,  # noqa: F401
               monitor, profile, spans, summary, trace)
from .dash import render_dashboard, write_dashboard  # noqa: F401
from .diff import TraceDiff, diff_traces  # noqa: F401
from .events import (CANONICAL_STAGES, FAULT_KINDS,  # noqa: F401
                     REQUIRED_STAGES, SCHEMA_VERSION, DeviceEvent,
                     FaultEvent, MetricsEvent, MonitorEvent, ProfileEvent,
                     RoundEvent, SolverEvent, SpanEvent, StageEvent,
                     parse_record)
from .export import export_file, to_chrome_trace  # noqa: F401
from .metrics import (NullRegistry, Registry,  # noqa: F401
                      render_snapshot)
from .monitor import (ConvergenceMonitor, MonitorConfig,  # noqa: F401
                      Violation)
from .profile import (KernelProfile, cost_of, peak_flops,  # noqa: F401
                      profile_fn)
from .spans import (SpanNode, build_tree, iter_spans,  # noqa: F401
                    self_seconds_by_path)
from .summary import load_trace, rows, summarize  # noqa: F401
from .summary import emit as emit_summary  # noqa: F401
from .trace import (NULL, NullTelemetry, Telemetry, annotate_fn,  # noqa: F401
                    get_default, resolve, set_default)

__all__ = [
    "SCHEMA_VERSION", "CANONICAL_STAGES", "REQUIRED_STAGES",
    "FAULT_KINDS", "StageEvent", "SolverEvent", "DeviceEvent",
    "RoundEvent", "MetricsEvent", "MonitorEvent", "ProfileEvent",
    "FaultEvent", "SpanEvent",
    "parse_record", "NullTelemetry", "Telemetry", "NULL",
    "set_default", "get_default", "resolve", "annotate_fn",
    "NullRegistry", "Registry", "render_snapshot",
    "ConvergenceMonitor", "MonitorConfig", "Violation",
    "KernelProfile", "cost_of", "peak_flops", "profile_fn",
    "load_trace", "summarize", "rows", "emit_summary",
    "SpanNode", "build_tree", "iter_spans", "self_seconds_by_path",
    "to_chrome_trace", "export_file", "TraceDiff", "diff_traces",
    "render_dashboard", "write_dashboard",
]
