"""Span-based causal tracing: WHERE time goes in a request/chunk lifecycle.

PR 8's registry answers "how much" (histograms, counters); this module answers
"where in the lifecycle": every serve request and every training chunk gets a
**trace** — a tree of timestamped **spans** (admission -> queue -> microbatch
pack -> dispatch -> engine eval; supervisor chunk -> run_chunk dispatch ->
rollback/recovery) sharing one ``trace_id`` that travels with the work across
subsystem boundaries (it surfaces on ``ServeResult.trace_id`` and in the
supervisor's JSONL events).  The span buffer feeds the Chrome-trace/Perfetto
exporter (:mod:`repro_torch.obs.trace_export`) so a run drops an openable timeline.

Design constraints, in order:

* **off-mode is free** — every integration point takes ``tracer=None`` and
  guards with one ``is None`` check; no span objects, no clock reads, no
  change to compiled programs (host-side only; asserted bitwise + trace/HLO
  parity in tests/test_tracing.py);
* **on-mode is bounded** — completed spans live in a RING buffer
  (``capacity`` spans; the newest span evicts the oldest, eviction counted)
  and head **sampling** (``sample_rate``, decided once per trace by a
  deterministic systematic sampler) lets a production server keep trace_id
  propagation on every request while recording only a fraction.  Unsampled
  traces still get real trace_ids — causality survives, recording cost
  doesn't.  Measured overhead is enforced <= 2% in
  ``benchmarks/obs_telemetry.py``;
* **one clock** — the tracer takes the same injectable clock as the registry
  (:func:`repro_torch.obs.make_obs` wires them together), so span timestamps,
  metric timers, and event ``t`` fields share a timebase and tests stub time
  instead of sleeping.

Span lifecycle: :meth:`Tracer.start_trace` opens a root, :meth:`Span.child` /
:meth:`Tracer.span` open children (``Tracer.span`` parents to the innermost
ACTIVE span — the with-statement stack — which is how the engine's span lands
under the frontend's dispatch span without either knowing the other),
:meth:`Span.event` records an instant marker, :meth:`Span.end` completes and
commits to the ring.  :meth:`Tracer.record` commits a retrospective span from
already-measured ``(t0, t1)`` — the natural fit for stage durations the serve
path measures anyway (queue wait, microbatch dispatch).
"""
from __future__ import annotations

import time
from collections import deque


class Span:
    """One timed node of a trace tree (also the handle while open).

    ``lane`` is the timeline row the exporter puts the span on (e.g.
    ``serve``, ``train``, ``sub3``); children inherit the parent's lane
    unless overridden.  ``attrs`` is free-form (JSON-able values only —
    enforced at export, not here, to keep the hot path cheap).
    """

    __slots__ = ("tracer", "trace_id", "span_id", "parent_id", "name",
                 "lane", "t0", "t1", "attrs", "sampled", "_ended")

    def __init__(self, tracer: "Tracer", trace_id: str, span_id: int,
                 parent_id: int | None, name: str, lane: str | None,
                 t0: float, attrs: dict, sampled: bool):
        self.tracer, self.trace_id, self.span_id = tracer, trace_id, span_id
        self.parent_id, self.name, self.lane = parent_id, name, lane
        self.t0, self.t1 = t0, None
        self.attrs, self.sampled = attrs, sampled
        self._ended = False

    # ------------------------------------------------------------- tree ops
    def child(self, name: str, lane: str | None = None, **attrs) -> "Span":
        """Open a child span (inherits trace_id, sampling, and lane)."""
        return self.tracer._open(name, self, lane, attrs)

    def event(self, name: str, **attrs) -> None:
        """Instant marker: a zero-duration child committed immediately."""
        if not self.sampled:
            self.tracer.spans_dropped_sampling += 1
            return
        t = self.tracer.clock()
        ev = Span(self.tracer, self.trace_id, self.tracer._next_span_id(),
                  self.span_id, name, self.lane, t, {**attrs, "instant": True},
                  True)
        ev.t1 = t
        ev._ended = True
        self.tracer._commit(ev)

    def annotate(self, **attrs) -> None:
        self.attrs.update(attrs)

    def end(self, **attrs) -> None:
        """Complete the span (idempotent) and commit it to the ring buffer."""
        if self._ended:
            return
        self._ended = True
        if attrs:
            self.attrs.update(attrs)
        self.t1 = self.tracer.clock()
        self.tracer._commit(self)      # counts the drop when unsampled

    # ------------------------------------------------- active-span stacking
    def __enter__(self) -> "Span":
        self.tracer._stack.append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        st = self.tracer._stack
        if st and st[-1] is self:
            st.pop()
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self.end()
        return False

    def __repr__(self) -> str:  # debugging/tests
        dur = None if self.t1 is None else round(self.t1 - self.t0, 6)
        return (f"Span({self.name!r} id={self.span_id} parent={self.parent_id}"
                f" trace={self.trace_id} lane={self.lane} dur={dur})")


class Tracer:
    """Bounded, samplable span recorder with one injectable clock.

    ``sample_rate`` in [0, 1] is applied per TRACE by a deterministic
    systematic sampler (every 1/rate-th trace records; no RNG, so tests and
    repeated runs see identical decisions).  ``capacity`` bounds the
    completed-span ring; older spans are evicted first and counted in
    :meth:`stats` — a serving process can trace forever in O(capacity)
    memory.
    """

    def __init__(self, clock=time.perf_counter, sample_rate: float = 1.0,
                 capacity: int = 8192):
        assert 0.0 <= sample_rate <= 1.0 and capacity > 0
        self.clock = clock
        self.sample_rate = float(sample_rate)
        self.capacity = int(capacity)
        self._ring: deque[Span] = deque(maxlen=self.capacity)
        self._stack: list[Span] = []          # active (with-statement) spans
        self._acc = 0.0                        # systematic sampler state
        self._trace_seq = 0
        self._span_seq = 0
        self.traces_started = 0
        self.traces_sampled = 0
        self.spans_recorded = 0
        self.spans_dropped_sampling = 0        # spans of unsampled traces
        self.spans_evicted = 0                 # ring-buffer overwrites
        self.watermark = 0                     # max ring fill ever seen

    # -------------------------------------------------------------- opening
    def _next_span_id(self) -> int:
        self._span_seq += 1
        return self._span_seq

    def _sample(self) -> bool:
        self._acc += self.sample_rate
        if self._acc >= 1.0 - 1e-12:
            self._acc -= 1.0
            return True
        return False

    def start_trace(self, name: str, lane: str | None = None,
                    **attrs) -> Span:
        """Open a new root span (new trace_id; sampling decided here)."""
        self.traces_started += 1
        self._trace_seq += 1
        sampled = self._sample()
        if sampled:
            self.traces_sampled += 1
        trace_id = f"t{self._trace_seq:08x}"
        return Span(self, trace_id, self._next_span_id(), None, name, lane,
                    self.clock(), dict(attrs), sampled)

    def _open(self, name: str, parent: Span | None, lane: str | None,
              attrs: dict) -> Span:
        if parent is None:
            return self.start_trace(name, lane, **attrs)
        return Span(self, parent.trace_id, self._next_span_id(),
                    parent.span_id, name, lane or parent.lane,
                    self.clock(), dict(attrs), parent.sampled)

    def span(self, name: str, parent: Span | None = None,
             lane: str | None = None, **attrs) -> Span:
        """Open a span under ``parent``, or under the innermost ACTIVE span
        when ``parent`` is omitted (a new root if none is active).  Use as a
        context manager to make it the active span for nested calls."""
        if parent is None and self._stack:
            parent = self._stack[-1]
        return self._open(name, parent, lane, attrs)

    def record(self, name: str, t0: float, t1: float,
               parent: Span | None = None, lane: str | None = None,
               **attrs) -> Span | None:
        """Commit a retrospective span from already-measured times (tracer
        clock timebase).  Returns the span, or None if its trace (or the
        whole tracer, for parentless records) is unsampled."""
        if parent is not None:
            sampled, trace_id, parent_id = (parent.sampled, parent.trace_id,
                                            parent.span_id)
            lane = lane or parent.lane
            if not sampled:
                self.spans_dropped_sampling += 1
                return None
        else:
            root = self.start_trace(name, lane, **attrs)
            if not root.sampled:
                return None
            trace_id, parent_id = root.trace_id, None
        sp = Span(self, trace_id, (root.span_id if parent is None
                                   else self._next_span_id()),
                  parent_id, name, lane, float(t0), dict(attrs), True)
        sp.t1 = float(t1)
        sp._ended = True
        self._commit(sp)
        return sp

    # ------------------------------------------------------------ recording
    def _commit(self, span: Span) -> None:
        if not span.sampled:
            self.spans_dropped_sampling += 1
            return
        if len(self._ring) == self.capacity:
            self.spans_evicted += 1
        self._ring.append(span)
        self.spans_recorded += 1
        self.watermark = max(self.watermark, len(self._ring))

    # -------------------------------------------------------------- reading
    def spans(self, trace_id: str | None = None) -> list[Span]:
        """Completed spans currently in the ring (oldest first)."""
        out = list(self._ring)
        if trace_id is not None:
            out = [s for s in out if s.trace_id == trace_id]
        return out

    def trace_ids(self) -> list[str]:
        seen: dict[str, None] = {}
        for s in self._ring:
            seen.setdefault(s.trace_id, None)
        return list(seen)

    def tree(self, trace_id: str) -> dict | None:
        """Nested {span, children: [...]} view of one trace (roots with a
        missing parent — e.g. evicted — are grafted to the synthetic top)."""
        spans = self.spans(trace_id)
        if not spans:
            return None
        nodes = {s.span_id: {"span": s, "children": []} for s in spans}
        roots = []
        for s in spans:
            node = nodes[s.span_id]
            if s.parent_id in nodes:
                nodes[s.parent_id]["children"].append(node)
            else:
                roots.append(node)
        if len(roots) == 1:
            return roots[0]
        return {"span": None, "children": roots}

    def stats(self) -> dict:
        """Sampling + buffer accounting (serve_field publishes this in its
        heartbeat/status file)."""
        return {
            "sample_rate": self.sample_rate,
            "traces": self.traces_started,
            "traces_sampled": self.traces_sampled,
            "spans_recorded": self.spans_recorded,
            "spans_dropped_sampling": self.spans_dropped_sampling,
            "spans_evicted": self.spans_evicted,
            "buffer": len(self._ring),
            "capacity": self.capacity,
            "watermark": self.watermark,
        }

    def clear(self) -> None:
        self._ring.clear()
