"""Unified telemetry substrate: metrics registry, JSONL events, tracing.

Pure-Python copies of the reference package's registry, event log, tracer and
Chrome-trace exporter, shared by the serving stack (``serve.frontend`` /
``serve.resilience`` staged latency histograms, ``serve.engine`` dispatch
counters), and the profiling hooks (:mod:`repro_torch.obs.profiling`: the
named-scope vocabulary, the kernels' build/load watcher, the comp/comm
split and the analytic halo traffic).

Entry points:

* :class:`MetricsRegistry` — counters / gauges / log-bucket histograms with
  percentile export and ONE injectable clock;
* :class:`EventLog` / :func:`validate_events` — JSONL event sink with a
  per-run manifest and a strict schema;
* :class:`Tracer` / :class:`Span` — span-based causal tracing with
  trace_id propagation, exported to Chrome-trace/Perfetto timelines via
  :mod:`repro_torch.obs.trace_export`;
* :mod:`repro_torch.obs.trajectory` — append-only bench history + the
  drift-robust perf regression gate;
* :class:`Obs` — the bundle the subsystems actually accept: a registry plus
  an optional event log and an optional tracer sharing its clock.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

from repro_torch.obs import profiling, trajectory
from repro_torch.obs.events import (EVENT_KINDS, EventLog, ObsSchemaError,
                                    SCHEMA_VERSION, check_fields, read_events,
                                    validate_events)
from repro_torch.obs.registry import (Counter, CounterGroup, Gauge, Histogram,
                                      MetricsRegistry)
from repro_torch.obs.trace_export import (ChromeTraceError,
                                          export_chrome_trace,
                                          halo_flow_events, to_chrome,
                                          training_timeline,
                                          validate_chrome_trace)
from repro_torch.obs.profiling import (SCOPES, CompileWatcher,
                                       comp_comm_split, compile_counts,
                                       halo_traffic, scope)
from repro_torch.obs.tracing import Span, Tracer


@dataclass
class Obs:
    """Registry + optional event sink + optional tracer, one clock.

    Subsystems take ``obs: Obs | None``; ``None`` means "keep your own
    private registry", and a None ``tracer`` keeps tracing out of every code
    path.  Build with :func:`make_obs` so the event log and tracer inherit
    the registry clock.
    """

    registry: MetricsRegistry
    events: EventLog | None = None
    tracer: Tracer | None = None

    @property
    def clock(self):
        return self.registry.clock

    def emit(self, kind: str, **fields) -> None:
        """Emit an event iff a sink is attached (metrics-only Obs is legal)."""
        if self.events is not None:
            self.events.emit(kind, **fields)

    def close(self) -> None:
        if self.events is not None:
            self.events.close()


def make_obs(jsonl_path: str | None = None, clock=time.perf_counter,
             run_id: str | None = None, config: dict | None = None,
             trace: bool = False, trace_sample: float = 1.0,
             trace_capacity: int = 8192) -> Obs:
    """One-call setup: registry (+ JSONL event log when a path is given,
    + tracer when ``trace``), all sharing ``clock``."""
    reg = MetricsRegistry(clock=clock)
    ev = (EventLog(jsonl_path, clock=clock, run_id=run_id, config=config)
          if jsonl_path else None)
    tr = (Tracer(clock=clock, sample_rate=trace_sample,
                 capacity=trace_capacity) if trace else None)
    return Obs(registry=reg, events=ev, tracer=tr)


__all__ = [
    "Counter", "CounterGroup", "Gauge", "Histogram", "MetricsRegistry",
    "EventLog", "ObsSchemaError", "check_fields", "read_events",
    "validate_events", "EVENT_KINDS", "SCHEMA_VERSION",
    "Span", "Tracer",
    "ChromeTraceError", "export_chrome_trace", "halo_flow_events",
    "to_chrome", "training_timeline", "validate_chrome_trace",
    "Obs", "make_obs",
    "profiling", "SCOPES", "scope", "CompileWatcher", "compile_counts",
    "comp_comm_split", "halo_traffic", "trajectory",
]
