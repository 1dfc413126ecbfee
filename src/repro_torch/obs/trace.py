"""Telemetry sinks.

Counterpart of ``repro/obs/trace.py``.  Two things differ: ``block``
waits for the CUDA devices its argument's tensors live on (the
reference calls ``jax.block_until_ready``), and ``annotate_fn`` names a
function in ``torch.profiler`` traces (the reference uses
``jax.profiler``).

Two sinks share one interface:

* ``NullTelemetry`` — the process-wide default.  Every method is a
  cheap no-op (``stage`` hands back one shared, reusable null context
  manager), so instrumented code paths cost a single attribute lookup
  when telemetry is off and numerics are bit-for-bit unchanged.
* ``Telemetry`` — records events in memory and, when given a ``path``,
  streams them to a JSONL file line-by-line (partial traces survive a
  crash).  ``stage(name)`` times a ``with`` block on the monotonic
  clock; ``span(name, **attrs)`` (schema v4) does the same but nests —
  spans opened inside another span/stage record it as their parent, so
  the trace carries the round's full call tree (see
  ``repro_torch.obs.spans``).  ``stage`` is the span variant that serializes
  as the legacy ``stage`` record and feeds ``feel_stage_seconds``.
  ``block`` synchronizes the CUDA devices its argument's tensors are
  on, so device work is attributed to the stage that launched it
  rather than to whichever later stage happens to synchronize.

Sink resolution: instrumented entry points take ``telemetry=None`` and
call ``resolve`` — ``None`` means "use the process default" (set with
``set_default``, a ``NullTelemetry`` unless a caller installed a real
sink).  Inner helpers that would flood the
trace (the swap-matching scorer's per-candidate power solves) pass the
``NULL`` sentinel explicitly to opt out.
"""
from __future__ import annotations

import atexit
import functools
import json
import time
import warnings
from typing import Any, Dict, IO, Optional

import torch

from . import events as ev
from . import metrics as metrics_mod


class _NullStage:
    """Shared reusable no-op context manager."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_STAGE = _NullStage()


class NullTelemetry:
    """Do-nothing sink; the interface contract for ``Telemetry``."""

    enabled: bool = False
    annotate: bool = False
    profile: bool = False

    def stage(self, name: str):
        return _NULL_STAGE

    def span(self, name: str, **attrs: Any):
        return _NULL_STAGE

    def block(self, x):
        return x

    def begin_round(self, i: int) -> None:
        pass

    def solver(self, solver: str, **counters: Any) -> None:
        pass

    def devices(self, **fields: Any) -> None:
        pass

    def round_end(self, **fields: Any) -> None:
        pass

    def fault(self, kind: str, injected: bool = False,
              device: Optional[int] = None, **detail: Any) -> None:
        pass

    def emit(self, event) -> None:
        pass

    def close(self) -> None:
        pass


#: explicit opt-out sentinel (see module docstring).
NULL = NullTelemetry()


class _Span:
    """Timed span context: allocates an id on entry, pushes itself on
    the sink's span stack (so nested spans know their parent), and
    emits one event on exit.  ``_TimedStage`` specializes the emitted
    event kind; everything else is shared."""

    __slots__ = ("_tele", "_name", "_attrs", "_t0", "span_id",
                 "parent_id")

    def __init__(self, tele: "Telemetry", name: str,
                 attrs: Optional[Dict[str, Any]] = None):
        self._tele = tele
        self._name = name
        self._attrs = attrs

    def __enter__(self):
        tele = self._tele
        self.span_id = tele._next_span_id()
        stack = tele._span_stack
        self.parent_id = stack[-1] if stack else None
        stack.append(self.span_id)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        tele = self._tele
        stack = tele._span_stack
        # tolerate out-of-order exits (crash paths): pop down to self
        while stack and stack[-1] != self.span_id:
            stack.pop()
        if stack:
            stack.pop()
        self._emit(tele, self._t0 - tele.created_s, t1 - self._t0)
        return False

    def _emit(self, tele: "Telemetry", t0_s: float, dur: float) -> None:
        tele.emit(ev.SpanEvent(name=self._name, span_id=self.span_id,
                               parent_id=self.parent_id, t0_s=t0_s,
                               dur_s=dur, round=tele.current_round,
                               attrs=self._attrs))


class _TimedStage(_Span):
    """A stage is a span that serializes as the legacy ``stage`` record
    (plus the v4 span-id fields) and mirrors its duration into the
    ``feel_stage_seconds`` histogram — every v1-v3 consumer keeps
    working unchanged."""

    __slots__ = ()

    def _emit(self, tele: "Telemetry", t0_s: float, dur: float) -> None:
        tele.emit(ev.StageEvent(stage=self._name, t0_s=t0_s, dur_s=dur,
                                round=tele.current_round,
                                span_id=self.span_id,
                                parent_id=self.parent_id))
        reg = metrics_mod.get_default()
        if reg.enabled:
            reg.histogram("feel_stage_seconds",
                          "wall-clock per timed stage").observe(
                              dur, stage=self._name)


class Telemetry(NullTelemetry):
    """Recording sink (in-memory list + optional JSONL stream).

    Parameters
    ----------
    path:
        JSONL output file; ``None`` keeps events in memory only.
    annotate:
        ask ``FEELTrainer`` to wrap its round functions in
        ``torch.profiler.record_function`` ranges, so they show up
        named in a ``torch.profiler`` trace (off by default).
    profile:
        ask instrumented trainers to record one ``ProfileEvent``
        (FLOPs / bytes, ``repro_torch.obs.profile``) per function and
        input-shape combination — costs one extra counted call per
        combination, so off by default.
    meta:
        free-form dict stored in the trace header.

    A file-backed sink registers an ``atexit`` close so traces survive
    un-context-managed use on exception paths; ``close()`` is
    idempotent and unregisters the hook.
    """

    enabled = True

    def __init__(self, path: Optional[str] = None, annotate: bool = False,
                 profile: bool = False,
                 meta: Optional[Dict[str, Any]] = None):
        self.annotate = annotate
        self.profile = profile
        self.created_s = time.perf_counter()
        self.current_round: Optional[int] = None
        self.events: list = []
        self.dropped_writes = 0
        self._span_stack: list = []
        self._span_seq = 0
        self._file: Optional[IO[str]] = None
        if path is not None:
            self._file = open(path, "w", encoding="utf-8")
            self._write(ev.header_record(meta))
            atexit.register(self.close)

    # -- recording -----------------------------------------------------
    def stage(self, name: str):
        return _TimedStage(self, name)

    def span(self, name: str, **attrs: Any):
        """Open a nested timed span; exits emit one ``SpanEvent``
        linked to the enclosing span (stage or span) via parent id."""
        return _Span(self, name, attrs or None)

    def _next_span_id(self) -> int:
        self._span_seq += 1
        return self._span_seq

    def block(self, x):
        """Wait for the CUDA devices ``x`` holds tensors on (``x`` may be
        a tensor or dicts, lists and tuples of them) and return ``x``;
        CPU tensors and other values need no wait."""
        for dev in cuda_devices(x, set()):
            torch.cuda.synchronize(dev)
        return x

    def begin_round(self, i: int) -> None:
        self.current_round = i

    def solver(self, solver: str, **counters: Any) -> None:
        self.emit(ev.SolverEvent(solver=solver, counters=counters,
                                 round=self.current_round))

    def devices(self, **fields: Any) -> None:
        self.emit(ev.DeviceEvent(round=self.current_round, **fields))

    def round_end(self, **fields: Any) -> None:
        self.emit(ev.RoundEvent(round=self.current_round, **fields))

    def fault(self, kind: str, injected: bool = False,
              device: Optional[int] = None, **detail: Any) -> None:
        self.emit(ev.FaultEvent(kind=kind, injected=injected,
                                device=device, detail=detail,
                                round=self.current_round,
                                t_s=time.perf_counter() - self.created_s))

    def emit(self, event) -> None:
        self.events.append(event)
        if self._file is not None:
            self._write(event.to_record())

    # -- IO ------------------------------------------------------------
    def _write(self, record: Dict[str, Any]) -> None:
        """Append one JSONL record.  A closed or failing file must
        never crash training mid-round: the write is dropped, counted
        in ``dropped_writes``, and the sink keeps recording in memory
        (the first failure warns once and detaches the file)."""
        try:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        except (OSError, ValueError) as e:  # closed file raises ValueError
            self.dropped_writes += 1
            self._file = None
            warnings.warn(f"telemetry trace write failed "
                          f"({type(e).__name__}: {e}); further events "
                          f"stay in memory only")

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
            try:
                atexit.unregister(self.close)
            except Exception:  # pragma: no cover - interpreter teardown
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ---------------------------------------------------------------------
# process-wide default sink
# ---------------------------------------------------------------------

_default: NullTelemetry = NULL


def set_default(tele: Optional[NullTelemetry]) -> None:
    """Install ``tele`` as the process default (``None`` resets)."""
    global _default
    _default = tele if tele is not None else NULL


def get_default() -> NullTelemetry:
    return _default


def resolve(telemetry: Optional[NullTelemetry]) -> NullTelemetry:
    """``None`` -> the process default; anything else passes through."""
    return _default if telemetry is None else telemetry


def cuda_devices(x, found: set) -> set:
    """The CUDA devices of the tensors in ``x`` (nested dicts, lists and
    tuples are walked)."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            found.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            cuda_devices(v, found)
    elif isinstance(x, (list, tuple)):
        for v in x:
            cuda_devices(v, found)
    return found


def annotate_fn(fn, name: str):
    """Wrap ``fn`` so each call runs inside a
    ``torch.profiler.record_function(name)`` range."""
    @functools.wraps(fn)
    def annotated(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    return annotated
