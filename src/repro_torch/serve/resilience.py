"""Resilient serving: admission control, deadlines, degradation, isolation.

:class:`~repro_torch.serve.frontend.ServeFrontend` answers queries; this layer makes
it survivable under production traffic and production failures.  A
:class:`ResilientFrontend` wraps the frontend with four mechanisms:

* **admission control** — the queue is bounded in BOTH requests and total
  queued points; a request that would overflow either bound is answered
  immediately with a typed ``shed`` result instead of growing the queue
  without bound (fast load-shedding: the caller learns in O(1), the queue
  never melts down);
* **deadline propagation** — every request carries an (optional) deadline
  from admission; an expired request is answered ``deadline_exceeded`` and is
  NEVER dispatched — work the caller already gave up on is not worth a device
  dispatch;
* **degraded-mode ladder** — under queue pressure or repeated failure the
  service steps down ``order=2`` (full bundle: u, grad, flux, residual) →
  ``order=1`` (the engine's cheap tier: the second-order tangent stream is
  disabled) → **cache-only** (answer hits from the result cache, shed
  misses).  Degraded answers carry ``degraded=True`` and the order actually
  served, so callers can tell;
* **failure isolation** — the frontend's flush bisects a failing microbatch
  so one poisoned cloud never blocks healthy batch-mates (quarantine); this
  layer adds capped, jittered retry per quarantined cloud, a per-engine
  circuit breaker (open after K consecutive dispatch failures, half-open
  probes after a cooldown), and a NaN/Inf guard that rejects dispatches whose
  *claimed* points come back non-finite (outside-domain NaN stays legal).

The invariant the whole layer maintains: **every admitted ticket is answered
exactly once** — served, degraded, shed, deadline-exceeded, or failed — and
the queue can always make progress no matter what the engine does.

When the shared ``obs`` carries a :class:`~repro_torch.obs.Tracer`, every ticket
ALSO gets exactly one trace: a root span opened at submit (even a request
shed in O(1) gets — and closes — one), hop events for every retry /
quarantine / ladder step-down / cache-only fallback, the inner frontend's
queue-wait + dispatch + engine spans as children via the same trace_id, and
the root closed with the final status in :meth:`_answer` — the one choke
point every answer already passes through.  The trace_id surfaces on
``ServeResult.trace_id`` so callers can join answers to timelines.

Clock, sleep, and jitter RNG are injectable, so every behavior above is
unit-testable without real waiting (and the SLO benchmark can run the whole
stack on a virtual clock).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.obs import MetricsRegistry, Obs
from repro_torch.serve import routing
from repro_torch.serve.frontend import ServeFrontend, UnknownTicketError, _signature


class EngineOutputError(RuntimeError):
    """The engine returned NaN/Inf at points it claims to own."""


# --------------------------------------------------------------- output guard

class GuardedEngine:
    """Engine wrapper: reject evaluations with non-finite CLAIMED outputs.

    Points outside the domain are NaN by contract; a NaN at a claimed point
    is corruption (bad weights, kernel bug, injected fault) and must not be
    cached or handed to a caller as data.  Raising turns the poisoned cloud
    into an ordinary failed microbatch, so the frontend's bisection + the
    resilience retry path handle it like any other engine failure.
    """

    def __init__(self, engine):
        self.engine = engine
        self.trips = 0

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def evaluate(self, pts, order: int = 2) -> dict:
        out = self.engine.evaluate(pts, order=order)
        claims = getattr(self.engine, "last_claims", None)
        if claims is None or len(claims) != len(out["u"]):
            claims = routing.route(self.engine.bundle.decomp, pts).claims
        claimed = np.asarray(claims) > 0
        if claimed.any():
            for k, v in out.items():
                arr = np.asarray(v)[claimed]
                if not np.isfinite(arr).all():
                    self.trips += 1
                    flat = np.isfinite(arr.reshape(arr.shape[0], -1))
                    n = int((~flat.all(axis=1)).sum())
                    raise EngineOutputError(
                        f"non-finite {k!r} at {n} claimed point(s)")
        return out


# ------------------------------------------------------------ circuit breaker

class CircuitBreaker:
    """closed -> (K consecutive failures) -> open -> (cooldown) -> half_open.

    ``allow()`` answers "may we dispatch right now": always in ``closed``,
    never in ``open`` (until the cooldown elapses, which moves the breaker to
    ``half_open``), and in ``half_open`` exactly as a probe — a success closes
    the breaker, a failure re-opens it for another cooldown.
    """

    def __init__(self, threshold: int = 5, cooldown: float = 5.0,
                 clock=time.monotonic):
        self.threshold, self.cooldown = threshold, cooldown
        self._clock = clock
        self.state = "closed"
        self.failures = 0          # consecutive
        self.opened_at: float | None = None
        self.opens = 0

    def allow(self) -> bool:
        if self.state == "open" and \
                self._clock() - self.opened_at >= self.cooldown:
            self.state = "half_open"
        return self.state != "open"

    def record_success(self) -> None:
        self.state, self.failures, self.opened_at = "closed", 0, None

    def record_failure(self) -> None:
        self.failures += 1
        if self.state == "half_open" or self.failures >= self.threshold:
            if self.state != "open":
                self.opens += 1
            self.state, self.opened_at = "open", self._clock()


# ------------------------------------------------------------------- results

RESULT_STATUSES = ("served", "degraded", "shed", "deadline_exceeded", "failed")


@dataclass
class ServeResult:
    """Typed answer envelope: every admitted ticket gets exactly one.

    ``data`` carries the field arrays for ``served``/``degraded`` (and for
    cache-only answers), None otherwise; ``order`` is the tier actually
    evaluated; ``reason`` says WHY for anything that is not a clean serve
    (``overload``, ``draining``, ``cache_only``, ``breaker_open``,
    ``deadline``, or the engine error text).
    """

    status: str
    data: dict | None = None
    order: int | None = None
    degraded: bool = False
    reason: str = ""
    latency: float | None = None      # end-to-end: answer clock - admission clock
    queue_wait: float | None = None   # inner-queue wait (enqueue -> dispatch)
    dispatch: float | None = None     # engine evaluation seconds of the
                                      # microbatch that served this request
    trace_id: str | None = None       # causal trace of this ticket's lifecycle
                                      # (None when tracing is off)

    @property
    def ok(self) -> bool:
        return self.data is not None


@dataclass
class ResilienceConfig:
    max_queue_requests: int = 256      # admission bound, requests
    max_queue_points: int = 1 << 20    # admission bound, total queued points
    default_deadline: float | None = None  # seconds from admission, per request
    max_queue_age: float | None = None     # anti-starvation flush (see poll)
    order: int = 2                     # full-service tier (top of the ladder)
    degrade_at: float = 0.5            # queue pressure >= this -> order=1
    cache_only_at: float = 0.9         # queue pressure >= this -> cache-only
    retry_limit: int = 2               # dispatch attempts per cloud
    retry_backoff: float = 0.05        # base backoff seconds, jittered
    breaker_threshold: int = 5         # consecutive failures -> open
    breaker_cooldown: float = 5.0      # open -> half_open after this


@dataclass(eq=False)                   # identity semantics: entries live in sets
class _Queued:
    ticket: int
    pts: np.ndarray
    admitted: float
    deadline: float | None = None
    inner: int | None = None           # inner frontend ticket while dispatched
    attempts: int = 0
    order: int = 2                     # tier this entry was dispatched at
    key: tuple = field(default=())     # order-free cloud identity
    span: object = None                # open root span of this ticket's trace


# ------------------------------------------------------------------ frontend

class ResilientFrontend:
    """Admission-controlled, deadline-aware, degradable serving frontend.

    Same submit/flush/result/poll/query shape as :class:`ServeFrontend`, but
    ``result`` returns a :class:`ServeResult` envelope and never wedges: shed
    and expired requests are answered instantly, failures are retried with
    jittered backoff up to ``retry_limit`` attempts, then answered ``failed``.
    """

    def __init__(self, engine, config: ResilienceConfig | None = None,
                 clock=time.monotonic, sleep=time.sleep, seed: int = 0,
                 obs: Obs | None = None, **frontend_kwargs):
        self.cfg = config or ResilienceConfig()
        self.guard = GuardedEngine(engine)
        self.engine = engine
        # one registry spans this layer AND the inner frontend, so a single
        # snapshot reads serve.resilience/* next to serve.frontend/*
        self.obs = obs if obs is not None else Obs(
            registry=MetricsRegistry(clock=clock))
        self._fe = ServeFrontend(self.guard, order=self.cfg.order,
                                 clock=clock, obs=self.obs, **frontend_kwargs)
        self._clock, self._sleep = clock, sleep
        self._rng = np.random.default_rng(seed)
        self.breaker = CircuitBreaker(self.cfg.breaker_threshold,
                                      self.cfg.breaker_cooldown, clock)
        self._queue: list[_Queued] = []
        self._queued_points = 0
        self._results: dict[int, ServeResult] = {}
        self._next_ticket = 0
        self._answered = 0             # answers recorded (ever), incl. retrieved
        self.draining = False
        self.level = 0                  # last ladder level used by flush
        reg = self.obs.registry
        self.counters = reg.group("serve.resilience", (
            "admitted", "served", "served_cache", "degraded",
            "shed_overload", "shed_draining", "shed_cache_only",
            "shed_breaker_open", "deadline_exceeded", "failed",
            "retries", "flush_failures",
        ))
        self._h_e2e = reg.histogram("serve.resilience/e2e_s")

    # ----------------------------------------------------------- answering
    def _answer(self, q_or_ticket, res: ServeResult, span=None) -> None:
        if isinstance(q_or_ticket, _Queued):
            ticket, admitted = q_or_ticket.ticket, q_or_ticket.admitted
            span = q_or_ticket.span if span is None else span
        else:
            ticket, admitted = q_or_ticket, self._clock()
        if span is not None:
            # every ticket's root closes HERE — shed and deadline-exceeded
            # included — which is what makes "one trace per ticket, always
            # closed" the same invariant as "every ticket answered once"
            res.trace_id = span.trace_id
            span.end(status=res.status, reason=res.reason)
        if res.latency is None:
            res.latency = max(0.0, self._clock() - admitted)
        self._h_e2e.record(res.latency)
        self._results[ticket] = res
        self._answered += 1
        key = {"served": "served", "degraded": "degraded",
               "deadline_exceeded": "deadline_exceeded",
               "failed": "failed"}.get(res.status)
        if res.status == "shed":
            key = "shed_" + res.reason
            if key not in self.counters:
                key = "shed_overload"
        if key:
            self.counters[key] += 1
        if res.reason == "cache" and res.status == "served":
            self.counters["served_cache"] += 1  # sub-count of "served"

    # ------------------------------------------------------------ admission
    def submit(self, pts, deadline: float | None = None) -> int:
        """Admit (or immediately answer) a request; returns a ticket.

        ``deadline`` is seconds from now; ``cfg.default_deadline`` applies
        when omitted.  Sheds typed-and-fast when draining or when either
        queue bound (requests / total points) would be exceeded.
        """
        pts = routing._as_cloud(pts, self.engine.bundle.decomp.dim)
        ticket = self._next_ticket
        self._next_ticket += 1
        now = self._clock()
        tr = self.obs.tracer
        span = (tr.start_trace("serve.request", lane="serve", ticket=ticket,
                               points=len(pts)) if tr is not None else None)
        if self.draining:
            self._answer(ticket, ServeResult("shed", reason="draining"),
                         span=span)
            return ticket
        cfg = self.cfg
        if (len(self._queue) >= cfg.max_queue_requests
                or self._queued_points + len(pts) > cfg.max_queue_points):
            self._answer(ticket, ServeResult("shed", reason="overload"),
                         span=span)
            return ticket
        self.counters["admitted"] += 1
        if span is not None:
            span.event("serve.admitted")
        # admission-time cache probe: a full-order hit costs no queue slot
        sig = _signature(pts, cfg.order)
        hit = self._fe._cache_get(sig)
        if hit is not None:
            self._fe.counters["cache_hits"] += 1
            if span is not None:
                span.event("serve.cache_hit")
            self._answer(ticket, ServeResult("served", data=hit,
                                             order=cfg.order, reason="cache",
                                             queue_wait=0.0, dispatch=0.0),
                         span=span)
            return ticket
        dl = deadline if deadline is not None else cfg.default_deadline
        self._queue.append(_Queued(
            ticket=ticket, pts=pts, admitted=now,
            deadline=(now + dl) if dl is not None else None,
            key=(sig[0], sig[2]), span=span))
        self._queued_points += len(pts)
        self.poll()
        return ticket

    # ------------------------------------------------------------- deadlines
    def _expire(self, entries: list[_Queued]) -> list[_Queued]:
        """Answer expired entries ``deadline_exceeded``; return the live ones.
        Expired requests are never dispatched — their inner submission (if
        any) is withdrawn from the frontend queue."""
        now, live = self._clock(), []
        for q in entries:
            if q.deadline is not None and now >= q.deadline:
                if q.inner is not None:
                    self._fe.withdraw(q.inner)
                self._answer(q, ServeResult("deadline_exceeded",
                                            reason="deadline"))
            else:
                live.append(q)
        return live

    def next_flush_due(self) -> float | None:
        """Clock time at which :meth:`poll` will flush (queue head admission
        + ``max_queue_age``), or None if nothing is pending / no age bound.
        Lets discrete-event drivers advance a virtual clock to the next
        self-scheduled flush instead of busy-polling."""
        if self.cfg.max_queue_age is None or not self._queue:
            return None
        return self._queue[0].admitted + self.cfg.max_queue_age

    def poll(self) -> bool:
        """Anti-starvation: flush once the queue head ages past
        ``cfg.max_queue_age`` (mirrors :meth:`ServeFrontend.poll`).
        The comparison is ``clock >= admitted + age`` — the SAME expression
        :meth:`next_flush_due` returns — so a driver that advances its clock
        exactly to the due time always fires (``clock - admitted >= age``
        can round one ulp short and livelock such a driver)."""
        if (self.cfg.max_queue_age is not None and self._queue
                and self._clock() >= self._queue[0].admitted
                + self.cfg.max_queue_age):
            self.flush()
            return True
        return False

    # ---------------------------------------------------------------- ladder
    def pressure(self) -> float:
        cfg = self.cfg
        return max(len(self._queue) / cfg.max_queue_requests,
                   self._queued_points / cfg.max_queue_points)

    def _ladder_level(self) -> int:
        """0 = full order, 1 = first-order degraded, 2 = cache-only."""
        p = self.pressure()
        level = 0 if p < self.cfg.degrade_at else \
            1 if p < self.cfg.cache_only_at else 2
        if not self.breaker.allow():
            return 2
        if self.breaker.state == "half_open":
            level = max(level, 1)      # probe at the cheap tier
        return level

    def _cache_only(self, entries: list[_Queued], reason: str) -> None:
        """Bottom rung: answer cache hits (any tier), shed misses."""
        for q in entries:
            if q.span is not None:
                q.span.event("serve.cache_only", reason=reason)
            hit = order = None
            for o in (self.cfg.order, 1):
                hit = self._fe._cache_get(_signature(q.pts, o))
                if hit is not None:
                    order = o
                    break
            if hit is not None:
                self._answer(q, ServeResult(
                    "degraded", data=hit, order=order, degraded=True,
                    reason="cache_only"))
            else:
                self._answer(q, ServeResult("shed", reason=reason))

    # ----------------------------------------------------------------- flush
    def flush(self) -> None:
        """Answer everything currently queued.  Never raises on engine
        failure: quarantined clouds are retried (capped, jittered) and then
        answered ``failed``; breaker-open fast-fails without dispatching."""
        # ladder level reads queue pressure — measure BEFORE dequeuing
        self.level = level = self._ladder_level()
        entries, self._queue = self._queue, []
        self._queued_points = 0
        entries = self._expire(entries)
        if not entries:
            return
        if level == 2:
            reason = ("breaker_open" if self.breaker.state == "open"
                      else "cache_only")
            self._cache_only(entries, reason)
            return
        order = self.cfg.order if level == 0 else min(self.cfg.order, 1)
        self._dispatch(entries, order)

    def _dispatch(self, entries: list[_Queued], order: int) -> None:
        self._fe.order = order
        for q in entries:
            q.inner = self._fe.submit(q.pts, parent=q.span)
            q.order = order
            q.attempts = max(q.attempts, 1)
        alive = {q.inner: q for q in entries}
        d0 = self._fe.counters["dispatches"]
        rounds = 0
        while True:
            try:
                self._fe.flush()
                if self._fe.counters["dispatches"] > d0:
                    self.breaker.record_success()
                break
            except Exception as exc:
                rounds += 1
                self.counters["flush_failures"] += 1
                self.breaker.record_failure()
                # quarantined clouds sit back in the inner queue (healthy
                # batch-mates were served by the bisection); cap retries,
                # expire, and fast-fail the rest if the breaker opened
                still = []
                for t in self._fe.pending_tickets():
                    q = alive[t]
                    q.attempts += 1
                    if q.attempts > self.cfg.retry_limit:
                        self._fe.withdraw(t)
                        del alive[t]
                        self._answer(q, ServeResult(
                            "failed", reason=f"{type(exc).__name__}: {exc}"))
                    else:
                        still.append(q)
                live = self._expire(still)   # answers + withdraws expired
                for q in still:
                    if q not in live:
                        alive.pop(q.inner, None)
                still = live
                if not still:
                    break
                if not self.breaker.allow():
                    for q in still:
                        self._fe.withdraw(q.inner)
                        del alive[q.inner]
                    self._cache_only(still, "breaker_open")
                    break
                self.counters["retries"] += 1
                for q in still:
                    if q.span is not None:
                        q.span.event("serve.retry", attempt=q.attempts,
                                     order=order)
                # jittered capped backoff before re-dispatching quarantine
                self._sleep(self.cfg.retry_backoff *
                            (1.0 + float(self._rng.uniform(0.0, 1.0))))
                # REPEATED failure (2nd retry round on): step the retry down
                # the ladder — a single transient still gets full order
                # (withdraw + resubmit so cache keys match the retried tier)
                if order > 1 and rounds >= 2:
                    order = 1
                    self.level = max(self.level, 1)
                    self._fe.order = order
                    for q in still:
                        if self._fe.withdraw(q.inner) is not None:
                            del alive[q.inner]
                            if q.span is not None:
                                q.span.event("serve.degrade", to_order=order)
                            q.inner = self._fe.submit(q.pts, parent=q.span)
                            q.order = order
                            alive[q.inner] = q
        for q in list(alive.values()):
            if q.inner is not None and self._fe.ready(q.inner):
                data = self._fe.result(q.inner)
                stage = self._fe.last_stage or {}
                degraded = q.order < self.cfg.order
                self._answer(q, ServeResult(
                    "degraded" if degraded else "served", data=data,
                    order=q.order, degraded=degraded,
                    reason="pressure" if degraded else "",
                    queue_wait=stage.get("queue_wait_s"),
                    dispatch=stage.get("dispatch_s")))

    # ---------------------------------------------------------------- results
    def result(self, ticket: int) -> ServeResult:
        self.poll()
        if ticket not in self._results:
            if any(q.ticket == ticket for q in self._queue):
                self.flush()
            else:
                raise UnknownTicketError(
                    f"ticket {ticket}: never issued or already retrieved")
        return self._results.pop(ticket)

    def query(self, pts, deadline: float | None = None) -> ServeResult:
        t = self.submit(pts, deadline=deadline)
        self.flush()
        return self.result(t)

    # ------------------------------------------------------------- lifecycle
    def drain(self) -> dict:
        """Graceful shutdown: stop admitting (new submits shed with reason
        ``draining``), answer everything still queued, report."""
        self.draining = True
        while self._queue:
            self.flush()
        return self.health()

    def health(self) -> dict:
        """Liveness/readiness snapshot for process supervisors."""
        status = ("draining" if self.draining
                  else "breaker_open" if self.breaker.state == "open"
                  else "overloaded" if self.pressure() >= self.cfg.cache_only_at
                  else "degraded" if (self.pressure() >= self.cfg.degrade_at
                                      or self.breaker.state == "half_open")
                  else "ok")
        return {
            "status": status,
            "ready": not self.draining and self.breaker.state != "open",
            "breaker": {"state": self.breaker.state,
                        "consecutive_failures": self.breaker.failures,
                        "opens": self.breaker.opens},
            "queue": {"requests": len(self._queue),
                      "points": self._queued_points,
                      "pressure": round(self.pressure(), 4)},
            "ladder_level": self.level,
            "guard_trips": self.guard.trips,
            # tickets with NO answer recorded yet (retrieved answers count as
            # answered — drain() runs before callers collect their results)
            "unanswered": self._next_ticket - self._answered,
        }

    def stats(self) -> dict:
        c = dict(self.counters)
        c["guard_trips"] = self.guard.trips
        c["breaker_opens"] = self.breaker.opens
        answered = sum(self.counters[k] for k in
                       ("served", "degraded", "shed_overload", "shed_draining",
                        "shed_cache_only", "shed_breaker_open",
                        "deadline_exceeded", "failed"))
        c["answered"] = answered
        c["frontend"] = self._fe.stats()
        # staged latency rollup: e2e here, queue wait + dispatch from the
        # inner frontend's histograms (same registry, one naming scheme)
        c["latency"] = {"e2e_s": self._h_e2e.snapshot(),
                        **c["frontend"]["latency"]}
        return c
