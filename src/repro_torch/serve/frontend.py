"""Dependency-free batching/caching frontend over a :class:`FieldEngine`.

Serving traffic is bursty and repetitive: dashboards re-request the same
dense grids, and many small concurrent requests waste dispatches.  The
frontend fixes both without threads or external deps:

* **microbatching** — queued requests are aggregated (concatenated) into
  engine calls of up to ``max_batch`` points; the engine math is
  row-independent, so each request's slice of the batched result equals its
  standalone evaluation;
* **LRU result cache** — keyed on the query-cloud signature (bytes + shape +
  order); a repeated grid is answered from memory with the BITWISE-identical
  arrays of the first evaluation, no device dispatch;
* **deadline flush** — with ``max_queue_age`` set, the oldest queued request is
  never left waiting for batch-mates beyond the deadline: ``submit``/``poll``/
  ``result`` flush the queue once its head ages out (clock injectable for
  tests), so a lone query is served within one deadline of any frontend
  activity;
* **failure isolation** — a failing microbatch is bisected so one poisoned
  cloud is quarantined (requeued at the tail) while its healthy batch-mates
  are served from the same flush;
* **counters + staged latency** — requests / points / hit rate / dispatches /
  evaluation seconds live in a :class:`~repro_torch.obs.MetricsRegistry` under
  ``serve.frontend/*`` (``self.counters`` is a dict-shaped view, so the
  legacy ``stats()`` shape is unchanged); per-request **queue wait** (enqueue
  -> dispatch) and per-microbatch **dispatch** (engine evaluation) durations
  feed ``serve.frontend/{queue_wait_s,dispatch_s}`` histograms, and each
  ticket's stage times are stashed for the resilience layer's end-to-end
  breakdown.  Pass ``obs`` to share a registry (and its clock's event log)
  across subsystems; omit it for a private registry (legacy behavior);
* **causal tracing** — when ``obs`` carries a :class:`~repro_torch.obs.Tracer`,
  each request gets a span tree: queue wait and dispatch land as
  retrospective child spans under the request's span (either a root the
  frontend opens itself, or the ``parent`` span :meth:`submit` was handed —
  how the resilience layer threads ONE trace_id through every hop), and the
  microbatch dispatch is a live span so the engine's own span nests under
  it.  A ``tracer=None`` obs keeps every trace branch untaken.

Admission control, deadlines, degraded modes, and retry policy live one layer
up in :mod:`repro_torch.serve.resilience`.

Usage: ``submit() ... flush() ... result()`` for explicit microbatching, or
``query()`` as the one-shot convenience (submit + flush + result).  Serving
loops with ``max_queue_age`` should call ``poll()`` on their idle path.
"""
from __future__ import annotations

import hashlib
import time
from collections import OrderedDict

import numpy as np

from repro_torch.obs import MetricsRegistry, Obs
from repro_torch.serve.engine import FieldEngine


class UnknownTicketError(KeyError):
    """The ticket was never issued by this frontend, or its result was
    already retrieved (``result`` hands each ticket's arrays out once)."""


def _signature(pts: np.ndarray, order: int) -> tuple:
    return (pts.shape, order,
            hashlib.sha1(np.ascontiguousarray(pts).tobytes()).hexdigest())


class ServeFrontend:
    def __init__(self, engine: FieldEngine, order: int = 2,
                 max_batch: int = 16384, cache_size: int = 64,
                 cache_points: int | None = 1 << 22,
                 max_queue_age: float | None = None,
                 clock=time.monotonic, obs: Obs | None = None):
        self.engine = engine
        self.order = order
        self.max_batch = max_batch
        self.cache_size = cache_size
        self.cache_points = cache_points
        self.max_queue_age = max_queue_age
        self._clock = clock
        self._cache: OrderedDict[tuple, dict] = OrderedDict()
        self._cache_pts = 0
        # pending entry: (ticket, pts, key, enqueue_time)
        self._pending: list[tuple[int, np.ndarray, tuple, float]] = []
        self._results: dict[int, dict] = {}
        self._next_ticket = 0
        self.obs = obs
        reg = obs.registry if obs is not None else MetricsRegistry(clock=clock)
        self.registry = reg
        self.counters = reg.group(
            "serve.frontend",
            ("requests", "points", "cache_hits", "cache_misses", "dispatches",
             "dispatched_points", "eval_seconds", "deadline_flushes",
             "quarantined"))
        self._h_queue_wait = reg.histogram("serve.frontend/queue_wait_s")
        self._h_dispatch = reg.histogram("serve.frontend/dispatch_s")
        # ticket -> {"queue_wait_s", "dispatch_s"}; recorded when the answer
        # lands, popped with result() — the resilience layer reads it for the
        # end-to-end latency breakdown
        self.stage_times: dict[int, dict] = {}
        self.last_stage: dict | None = None
        self.tracer = obs.tracer if obs is not None else None
        # ticket -> (request span, owned: bool, enqueue on the TRACER clock);
        # owned=False means a layer above opened the span and will close it
        self._req_spans: dict[int, tuple] = {}

    # ------------------------------------------------------------- caching
    def _cache_get(self, key: tuple) -> dict | None:
        out = self._cache.get(key)
        if out is not None:
            self._cache.move_to_end(key)
        return out

    def _cache_put(self, key: tuple, result: dict) -> None:
        n = key[0][0]  # points in the cloud (signature leads with pts.shape)
        if self.cache_points is not None and n > self.cache_points:
            return  # one giant grid must not monopolize (then thrash) the cache
        if key not in self._cache:
            self._cache_pts += n
        self._cache[key] = result
        self._cache.move_to_end(key)
        # evict by BOTH entry count and total cached points: the entry bound
        # alone lets cache_size huge grids pin gigabytes of result arrays
        while (len(self._cache) > self.cache_size
               or (self.cache_points is not None
                   and self._cache_pts > self.cache_points)):
            old, _ = self._cache.popitem(last=False)
            self._cache_pts -= old[0][0]

    def invalidate_cache(self) -> None:
        """Drop every cached result — REQUIRED after the engine's bundle is
        hot-swapped (cached arrays answer for the OLD field otherwise)."""
        self._cache.clear()
        self._cache_pts = 0

    # ------------------------------------------------------------- requests
    def submit(self, pts, parent=None) -> int:
        """Queue a request; returns a ticket for :meth:`result`.

        ``parent``: an open tracer span to hang this request's stage spans
        under (the resilience layer passes its root so the whole lifecycle
        shares one trace_id); without it, a tracer-on frontend opens its own
        root per request."""
        from repro_torch.serve.routing import _as_cloud

        pts = _as_cloud(pts, self.engine.bundle.decomp.dim)
        ticket = self._next_ticket
        self._next_ticket += 1
        self.counters["requests"] += 1
        self.counters["points"] += len(pts)
        tr = self.tracer
        if tr is not None:
            span = parent if parent is not None else tr.start_trace(
                "serve.request", lane="serve", points=len(pts))
            self._req_spans[ticket] = (span, parent is None, tr.clock())
        key = _signature(pts, self.order)
        cached = self._cache_get(key)
        if cached is not None:
            self.counters["cache_hits"] += 1
            self._results[ticket] = cached
            self.stage_times[ticket] = {"queue_wait_s": 0.0, "dispatch_s": 0.0}
            if tr is not None:
                span.event("serve.cache_hit")
        else:
            self.counters["cache_misses"] += 1
            self._pending.append((ticket, pts, key, self._clock()))
        self.poll()
        return ticket

    # ------------------------------------------------------------- deadline
    def _deadline_due(self) -> bool:
        # clock >= enqueue + age (NOT clock - enqueue >= age): keeps the fire
        # condition bitwise-consistent with schedulers that precompute the due
        # time as enqueue + age — the subtraction form can round one ulp short
        return (self.max_queue_age is not None and bool(self._pending)
                and self._clock() >= self._pending[0][3] + self.max_queue_age)

    def poll(self) -> bool:
        """Flush iff the OLDEST queued request has waited ``max_queue_age`` —
        the anti-starvation path: a lone query with no batch-mates is served at
        the next frontend activity (submit/result/poll) past its deadline
        instead of waiting for the queue to fill.  Returns True if it flushed."""
        if not self._deadline_due():
            return False
        self.counters["deadline_flushes"] += 1
        self.flush()
        return True

    def flush(self) -> None:
        """Evaluate queued requests in microbatches of <= ``max_batch`` points.

        Duplicate clouds inside one flush are evaluated once and shared; each
        microbatch is ONE engine dispatch regardless of how many requests it
        aggregates.  A failing microbatch is BISECTED: healthy batch-mates are
        served, only the poisoned cloud(s) are quarantined — re-queued at the
        queue TAIL (original arrival times kept) — and the first failure is
        re-raised once everything servable has been served.  One poisoned
        query therefore never wedges the queue: the old behavior (re-queue the
        whole batch at the head) replayed the same failing microbatch forever.
        """
        pending, self._pending = self._pending, []
        by_key: OrderedDict[tuple, list] = OrderedDict()
        for ticket, pts, key, enq in pending:
            ent = by_key.setdefault(key, [pts, []])
            ent[1].append((ticket, enq))
        unique = [(key, pts, toks) for key, (pts, toks) in by_key.items()]
        failures: list = []
        i = 0
        while i < len(unique):
            # greedy microbatch: at least one request, then pack until full
            batch = [unique[i]]
            total = len(unique[i][1])
            i += 1
            while i < len(unique) and total + len(unique[i][1]) <= self.max_batch:
                batch.append(unique[i])
                total += len(unique[i][1])
                i += 1
            self._eval_batch(batch, failures)
        if failures:
            for key, pts, toks, _exc in failures:
                self._pending.extend((t, pts, key, enq) for t, enq in toks)
            raise failures[0][3]

    def _eval_batch(self, batch: list, failures: list) -> None:
        """One microbatch dispatch; on failure, bisect to isolate the poison."""
        cloud = np.concatenate([pts for _, pts, _ in batch], axis=0)
        tr, mb = self.tracer, None
        if tr is not None:
            # the microbatch span hangs off the first traced request in the
            # batch (its "leader"); the engine's own span nests under it via
            # the active-span stack, so at least one request's tree reaches
            # engine depth — and a bisect-isolated retry batch of one always
            # does
            lead = next((self._req_spans[t][0] for _k, _p, toks in batch
                         for t, _e in toks if t in self._req_spans), None)
            mb = tr.span("serve.microbatch", parent=lead, clouds=len(batch),
                         points=len(cloud))
        try:
            t0 = self._clock()
            if mb is not None:
                with mb:
                    out = self.engine.evaluate(cloud, order=self.order)
            else:
                out = self.engine.evaluate(cloud, order=self.order)
            dt = self._clock() - t0
            self.counters["eval_seconds"] += dt
        except Exception as exc:
            if len(batch) == 1:   # isolated: this cloud is the poison
                self.counters["quarantined"] += 1
                if tr is not None:
                    for t, _enq in batch[0][2]:
                        ent = self._req_spans.get(t)
                        if ent is not None:
                            ent[0].event("serve.quarantine",
                                         error=type(exc).__name__)
                failures.append(batch[0] + (exc,))
                return
            mid = len(batch) // 2
            self._eval_batch(batch[:mid], failures)
            self._eval_batch(batch[mid:], failures)
            return
        self.counters["dispatches"] += 1
        self.counters["dispatched_points"] += len(cloud)
        self._h_dispatch.record(dt)
        ofs = 0
        for key, pts, toks in batch:
            n = len(pts)
            # detach from the full-microbatch arrays (a view would pin the
            # whole batch in memory for the cache's lifetime) and freeze:
            # cache hits hand out the SAME arrays, so caller mutation
            # would otherwise silently poison later hits
            res = {}
            for k, v in out.items():
                arr = v[ofs:ofs + n].copy()
                arr.flags.writeable = False
                res[k] = arr
            ofs += n
            self._cache_put(key, res)
            for t, enq in toks:
                self._results[t] = res
                wait = max(0.0, t0 - enq)
                self._h_queue_wait.record(wait)
                self.stage_times[t] = {"queue_wait_s": wait, "dispatch_s": dt}
                if mb is not None:
                    ent = self._req_spans.get(t)
                    if ent is not None:
                        span, _owned, enq_t = ent
                        tr.record("serve.queue_wait", enq_t,
                                  max(enq_t, mb.t0), parent=span)
                        tr.record("serve.dispatch", mb.t0, mb.t1, parent=span,
                                  clouds=len(batch))

    # ------------------------------------------------------------- results
    def ready(self, ticket: int) -> bool:
        return ticket in self._results

    def pending_tickets(self) -> list[int]:
        return [t for t, _pts, _key, _enq in self._pending]

    def withdraw(self, ticket: int):
        """Remove a still-pending request (policy layers: deadlines, retry
        caps).  Returns the withdrawn ``(pts, key)`` or None if not pending."""
        for i, (t, pts, key, _enq) in enumerate(self._pending):
            if t == ticket:
                del self._pending[i]
                ent = self._req_spans.pop(t, None)
                if ent is not None and ent[1]:
                    ent[0].end(status="withdrawn")
                return pts, key
        return None

    def result(self, ticket: int) -> dict:
        """Pop a ticket's result.  A still-pending ticket auto-flushes the
        queue (it used to ``KeyError`` opaquely); an unknown or already-popped
        ticket raises :class:`UnknownTicketError`.  The ticket's stage times
        (queue wait / dispatch seconds) move to ``self.last_stage`` for the
        resilience layer's latency breakdown."""
        self.poll()
        if ticket not in self._results:
            if any(t == ticket for t, _p, _k, _e in self._pending):
                self.flush()
            else:
                raise UnknownTicketError(
                    f"ticket {ticket}: never issued or already retrieved "
                    f"(results are handed out once)")
        self.last_stage = self.stage_times.pop(ticket, None)
        ent = self._req_spans.pop(ticket, None)
        if ent is not None and ent[1]:
            ent[0].end(status="served")
        return self._results.pop(ticket)

    def query(self, pts) -> dict:
        """One-shot convenience: submit + flush + result."""
        t = self.submit(pts)
        self.flush()
        return self.result(t)

    # ------------------------------------------------------------- metrics
    def stats(self) -> dict:
        c = dict(self.counters)
        c["cache_entries"] = len(self._cache)
        c["cache_points"] = self._cache_pts
        lookups = c["cache_hits"] + c["cache_misses"]
        c["hit_rate"] = c["cache_hits"] / lookups if lookups else 0.0
        # engine throughput counts only points that actually dispatched —
        # dividing cache-served traffic by dispatch time would inflate it
        c["points_per_sec"] = (c["dispatched_points"] / c["eval_seconds"]
                               if c["eval_seconds"] > 0 else float("inf"))
        c["latency"] = {"queue_wait_s": self._h_queue_wait.snapshot(),
                        "dispatch_s": self._h_dispatch.snapshot()}
        return c
